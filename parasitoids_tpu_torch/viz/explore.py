"""Interactive model explorer (L5).

Rebuilds ``Plot_ParasitoidModel.py``: quick visualizations of each analytic
sub-function (g wind logistic, f time-of-day pmf, h take-off probability
over a real wind day, and a single daily kernel) for parameter exploration
in an IPython session or from the CLI.

The port's copy of ``parasitoids_tpu/viz/explore.py``: the analytic
functions are the port's torch ones on host tensors, and
:func:`plot_daily_kernel` builds its kernel with the port's
``build_daily_kernel`` on the caller's device (the card by default,
through the CUDA day kernel).  ``python -m
parasitoids_tpu_torch.viz.explore [--device cpu|cuda]``.
"""

from __future__ import annotations


import numpy as np
import torch

__all__ = ['plot_g_wind_prob', 'plot_f_time_prob', 'plot_h_flight_prob',
           'daily_kernel_field', 'plot_daily_kernel', 'main']


from . import _mpl   # shared headless-backend helper

def plot_g_wind_prob(aw=1.8, bw=6.0, outfile=None, show=False):
    from ..ops.flight import g_wind_prob
    plt = _mpl()
    w = np.linspace(0, 4, 200)
    fig, ax = plt.subplots()
    ax.plot(w, g_wind_prob(torch.as_tensor(w), aw, bw).numpy())
    ax.set_xlabel('wind speed (m/s)')
    ax.set_ylabel('take-off probability factor g')
    ax.set_title('g(wind; aw={}, bw={})'.format(aw, bw))
    return _finish(fig, outfile or 'g_wind_prob.png', show)


def plot_f_time_prob(n=48, a1=7.0, b1=2.0, a2=19.0, b2=2.0, outfile=None,
                     show=False):
    from ..ops.flight import f_time_prob
    plt = _mpl()
    t = np.linspace(0, 24, n, endpoint=False)
    fig, ax = plt.subplots()
    ax.plot(t, f_time_prob(n, a1, b1, a2, b2).numpy())
    ax.set_xlabel('hour of day')
    ax.set_ylabel('take-off pmf f')
    ax.set_title('f(t; {}, {}, {}, {})'.format(a1, b1, a2, b2))
    return _finish(fig, outfile or 'f_time_prob.png', show)


def plot_h_flight_prob(site='data/kalbar', day_index=0, interp=30,
                       start_time='00:00', lam=1.0, aw=1.8, bw=6.0,
                       a1=7.0, b1=2.0, a2=19.0, b2=2.0, outfile=None,
                       show=False):
    from ..io.wind import get_wind_data
    from ..ops.flight import h_flight_prob
    plt = _mpl()
    wind_data, days = get_wind_data(site, interp, start_time)
    w = wind_data[days[day_index]]
    h = h_flight_prob(torch.as_tensor(w[:, 2]), lam, aw, bw, a1, b1, a2,
                      b2).numpy()
    t = np.linspace(0, 24, len(h), endpoint=False)
    fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True)
    ax1.plot(t, w[:, 2])
    ax1.set_ylabel('wind speed (m/s)')
    ax2.plot(t, h)
    ax2.set_ylabel('take-off probability h')
    ax2.set_xlabel('hour of day')
    fig.suptitle('day {} ({})'.format(days[day_index], site))
    return _finish(fig, outfile or 'h_flight_prob.png', show)


def daily_kernel_field(site='data/kalbar', day_index=0, device=None,
                       **param_overrides):
    """One daily dispersal kernel of ``Params`` with ``param_overrides``,
    built by the port's ``build_daily_kernel`` on ``device`` (default the
    card, through the CUDA day kernel; ``'cpu'`` the plain accumulate).
    Returns ``(pmf, loss, days, params)``, the pmf on ``device``."""
    from ..config import Params
    from ..device import pick_device
    from ..io.wind import get_wind_data, pack_wind
    from ..models.forward import (_auto_half_width, _resolve_pallas,
                                  wind_prefix_sum)
    from ..ops.daily_kernel import KernelConfig, build_daily_kernel
    dev = pick_device(device)
    p = Params()
    for k, v in param_overrides.items():
        setattr(p, k, v)
    p.domain_info = getattr(p, 'domain_info', (10000.0, 400))
    wind_data, days = get_wind_data(site, p.interp_num, p.start_time)
    packed = pack_wind(wind_data, days)
    flat_np = np.asarray(packed.reshape(-1, 2), np.float32)
    flat = torch.as_tensor(flat_np).to(dev)
    cs = torch.as_tensor(wind_prefix_sum(flat_np)).to(dev)
    cell = p.domain_info[0] / p.domain_info[1]
    K = (p.kernel_rad if p.kernel_rad is not None
         else _auto_half_width(p.Dparams, cell))
    Kl = (p.kernel_rad_local if p.kernel_rad_local is not None
          else _auto_half_width(p.Dlparams, cell, lo=3))
    kcfg = KernelConfig(rad_res=int(p.domain_info[1]),
                        periods=packed.shape[1], K=int(K),
                        K_local=int(Kl),
                        pallas=_resolve_pallas(None, dev, torch.float32))
    hp = (p.lam, *p.g_params, *p.f_params)
    pmf, loss = build_daily_kernel(flat, cs, day_index, hp, p.Dparams,
                                   p.Dlparams, p.mu_r, p.n_periods,
                                   p.domain_info[0], 0, kcfg)
    return pmf, loss, days, p


def plot_daily_kernel(site='data/kalbar', day_index=0, outfile=None,
                      show=False, device=None, **param_overrides):
    """Build and display one daily dispersal kernel
    (ref Plot_ParasitoidModel.plot_prob_mass), computed on ``device`` by
    :func:`daily_kernel_field`."""
    from .plot_result import alpha_viridis, crop_to_support, _extent_meters
    plt = _mpl()
    pmf, loss, days, p = daily_kernel_field(site, day_index, device,
                                            **param_overrides)
    pmf = pmf.cpu().numpy()
    cell = p.domain_info[0] / p.domain_info[1]
    cropped, window = crop_to_support(pmf)
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(np.ma.masked_less_equal(cropped, 0),
                   cmap=alpha_viridis(),
                   extent=_extent_meters(window, int(p.domain_info[1]),
                                         cell))
    ax.set_title('daily kernel, day {} (loss={:.2e})'.format(
        days[day_index], float(loss)))
    fig.colorbar(im, ax=ax)
    return _finish(fig, outfile or 'daily_kernel.png', show)


def _finish(fig, outfile, show):
    plt = _mpl()
    if show:
        plt.show()
        plt.close(fig)
        return None          # nothing was written; don't return a path
    fig.savefig(outfile, dpi=130, bbox_inches='tight')
    plt.close(fig)
    return outfile


def main(argv=None):
    """The four figures with their defaults; ``--device cpu|cuda``
    (default cuda) is where the daily kernel is built."""
    import sys
    from ..cli import split_device
    from ..device import pick_device
    device, _ = split_device(sys.argv[1:] if argv is None else argv)
    device = pick_device(device)
    print(plot_g_wind_prob())
    print(plot_f_time_prob())
    print(plot_h_flight_prob())
    print(plot_daily_kernel(device=device))


if __name__ == '__main__':
    main()
