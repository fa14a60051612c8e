"""The minute-sharded value+gradient of the log posterior against the
unsharded one, the JAX package beside the port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/check_torch_shard_grad.py [--shards 4]
        [--small]

At the Bayes default (Kalbar population model, 801² at 25 m, 18 days,
T = 1440, K = 44, Kl = 20; ``--small`` takes the small MAP configuration
of the tests instead) each package evaluates the negative log posterior
of ``map_fit._make_objective`` (no pre-spread day) and its gradient at
map_fit's start, once unsharded and once with ``with_forward_mesh`` over
a minute mesh of ``--shards`` devices: JAX's on as many virtual CPU
devices (``--xla_force_host_platform_device_count``), the port's on the
CPU named that many times.  Both run in f32 on their plain paths (JAX's
XLA accumulate, the port's ``accumulate_day_plain``).  Prints, for each
package, the value's relative change and every gradient component's
relative change ``|g_sharded - g| / |g|`` beside ``|g| / max |g|``, and
the components past rtol 5e-4 (the limit of ``tests/test_domain.py`` and
``tests/test_torch_domain.py``).  Takes a few minutes and a few GiB at
the Bayes default.
"""

import argparse
import os
import sys
import time

# the virtual device count must reach XLA before jax is imported
_N_DEV = 4
for i, a in enumerate(sys.argv):
    if a == '--shards' and i + 1 < len(sys.argv):
        _N_DEV = int(sys.argv[i + 1])
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                           ' --xla_force_host_platform_device_count={}'
                           .format(_N_DEV)).strip()
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from parasitoids_tpu.bayes import map_fit as jmap  # noqa: E402
from parasitoids_tpu.bayes import run as jrun  # noqa: E402
from parasitoids_tpu.bayes.priors import (  # noqa: E402
    initial_model_params, initial_obs_params)
from parasitoids_tpu.parallel import domain as jdom  # noqa: E402
from parasitoids_tpu_torch.bayes import map_fit as tmap  # noqa: E402
from parasitoids_tpu_torch.bayes import run as trun  # noqa: E402
from parasitoids_tpu_torch.parallel import domain as tdom  # noqa: E402

SMALL = ('ndays=3', 'domain_info=(10000.0,50)', 'interp_num=2',
         'kernel_rad=6', 'kernel_rad_local=3')
RTOL = 5e-4


def jax_value_and_grad(setup):
    neg, _, unconstrain = jmap._make_objective(setup, False)
    o0 = initial_obs_params(
        [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
        setup.cell_res ** 2, getattr(setup, 'obs_model', 'poisson'))
    z0 = unconstrain(jnp.asarray(initial_model_params(), jnp.float32),
                     jnp.asarray(o0, jnp.float32), jnp.float32(0.3))
    v, g = jax.jit(jax.value_and_grad(neg))(z0)
    return float(v), np.asarray(g, np.float64)


def port_value_and_grad(setup):
    neg, _, _ = tmap._make_objective(setup, False)
    z = tmap.initial_z(setup, False).clone().requires_grad_()
    v = neg(z)
    v.backward()
    return float(v.detach()), z.grad.numpy().astype(np.float64)


def report(name, v, g, v_sh, g_sh, sec):
    rel = np.abs(g_sh - g) / np.maximum(np.abs(g), 1e-30)
    scale = np.abs(g) / np.abs(g).max()
    print('{}: value sharded {!r} unsharded {!r} (rel {:.3e}); gradient '
          'relative L2 {:.3e}; {:.0f} s'.format(
              name, v_sh, v, abs(v_sh - v) / abs(v),
              np.linalg.norm(g_sh - g) / np.linalg.norm(g), sec))
    print('  per component |dg|/|g|:   ' + np.array2string(
        rel, precision=2, max_line_width=200))
    print('  per component |g|/max|g|: ' + np.array2string(
        scale, precision=2, max_line_width=200))
    past = [(i, rel[i], scale[i]) for i in np.flatnonzero(rel > RTOL)]
    print('  past rtol {:.0e}: {}'.format(RTOL, ', '.join(
        'z[{}] {:.3e} (|g| {:.2e} of the largest)'.format(*p)
        for p in past) or 'none'))
    return rel


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--shards', type=int, default=4)
    ap.add_argument('--small', action='store_true',
                    help='the small MAP configuration, not the Bayes default')
    args = ap.parse_args()
    over = SMALL if args.small else ()
    print('{} minute shards; {}'.format(
        args.shards, 'small MAP configuration' if args.small else
        'Bayes default (801^2, 18 days, T = 1440, K = 44, Kl = 20)'))

    tic = time.perf_counter()
    js = jrun.build_setup(over)
    v, g = jax_value_and_grad(js)
    v_sh, g_sh = jax_value_and_grad(js.with_forward_mesh(
        jdom.minute_mesh(n_devices=args.shards)))
    report('jax', v, g, v_sh, g_sh, time.perf_counter() - tic)

    tic = time.perf_counter()
    ts = trun.build_setup(over, device='cpu')
    v, g = port_value_and_grad(ts)
    v_sh, g_sh = port_value_and_grad(ts.with_forward_mesh(
        tdom.minute_mesh(devices=['cpu'] * args.shards)))
    report('port', v, g, v_sh, g_sh, time.perf_counter() - tic)


if __name__ == '__main__':
    main()
