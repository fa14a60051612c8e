"""SHA-256 of every output of the day kernels on fixed inputs, to show that
two trees' kernels give the same bits; and, with ``--time``, their passes'
device times side by side.  Needs a CUDA device; imports no JAX.

    python scripts/hash_day_kernel.py --against DIR [--time]
    python scripts/hash_day_kernel.py --root DIR [--time]

``--root DIR`` imports ``parasitoids_tpu_torch`` from the tree at DIR (the
checkout by default), builds its kernels there, and prints one line
``HASHES {json}``: the hash of each output, and with ``--time`` the
median device milliseconds of each pass.  ``--against DIR`` runs that for
DIR and for this checkout in turn, DIR, this, this, DIR, each in a
process of its own, then prints every output whose hashes differ (exit 1
if any does) and the passes' times of both trees.

The inputs (all f32, Kalbar wind, the headline shapes 801², T = 1440,
K = 44, buffer 977²): the forward K1/K2 (buffer, block sums, loss) on
days 0, 9, 17 at ρ = 0.253, 0.93, -0.93, 0.99, -0.99 (smoke [3]); the
particle-batched launch (buffers, block sums, losses) on days 0, 9, 17
for 8 particles of the Bayes default's prior (seed 18) with ρ set to
0.253, 0.9, 0.93, -0.99, 0.0, -0.5, 0.92, -0.93, straddling the select
rule's 0.925 (smoke [18]); the backward K3/K4 (dh, dμ, dclip, dD, dcell)
on days 0, 9, 17 at ρ = 0.253, 0.5, 0.8, 0.93, -0.93, 0.99, -0.99 and at
K = 88 (12.5 m cells) on day 9, against a seeded white-noise cotangent
(smoke [6]).  Times (``--time``): day 9, K1 at ρ = 0.253, K2 at 0.99, the
batched launch for the 8 prior particles, K3 and K4 likewise, 20 reps.
A tree whose day loop packs the kernels' constants once
(``day_kernel.pack_constants``) launches with the row packed that way,
and its backward writes the loss cotangent into a copy of it.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_RHOS = (0.253, 0.93, -0.93, 0.99, -0.99)
BWD_RHOS = (0.253, 0.5, 0.8, 0.93, -0.93, 0.99, -0.99)
BATCH_RHOS = (0.253, 0.9, 0.93, -0.99, 0.0, -0.5, 0.92, -0.93)


def sha(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def kalbar_setup(rad_res, torch):
    from parasitoids_tpu_torch.config import Params
    from parasitoids_tpu_torch.models.forward import (prior_coverage_windows,
                                                      setup_forward)
    p = Params()
    p.cmd_line_chg(['--kalbar', '--pop'])
    p.PLOT = p.OUTPUT = False
    p.domain_info = (p.domain_info[0], rad_res)
    cell = p.domain_info[0] / rad_res
    p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
    return p, cell, setup_forward(p, device='cuda')


def day_args(p, s, day):
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    h, mu, idx, clip, _ = day_scatter_inputs(
        s.wind_flat, s.wind_cumsum, day, (p.lam, *p.g_params, *p.f_params),
        p.mu_r, p.n_periods, 0, s.kcfg, s.rad_dist)
    return h, mu, idx, clip


def forward_outputs(lib, day_kernel, h, mu, idx, clip, Dp, cell, K, buf_len,
                    torch):
    """Buffer, block sums and loss of one launch (batched inputs lead with
    the particle axis) through the library's C entry point."""
    batched = h.ndim == 2
    out, args = day_kernel._forward_args(
        h, mu, idx, Dp, cell, K, buf_len, day_kernel._CHUNK, select=batched,
        **packed_once(day_kernel, Dp, cell, h.device, select=batched))
    day_kernel._cuda_call(lib, 'parasitoids_day_accumulate',
                          lib.parasitoids_day_smem_bytes(K), K, h.device,
                          *args)
    loss = torch.sum(clip * h * (1.0 - out['bsum']), dim=-1)
    return out['buf'], out['bsum'], loss


def packed_once(day_kernel, Dp, cell, device, select=False):
    """``{'consts': row}`` packed as the tree's day loop packs it once,
    or ``{}`` for a tree that packs at every launch."""
    if not hasattr(day_kernel, 'pack_constants'):
        return {}
    return {'consts': day_kernel.pack_constants(Dp, cell, device,
                                                select=select)}


def batched_inputs(setup, day, torch):
    """Day ``day``'s accumulate inputs for the 8 prior particles (seed 18)
    of the Bayes default ``setup``, as its batched forward builds them."""
    from parasitoids_tpu_torch.bayes.model import _as_model
    from parasitoids_tpu_torch.bayes.priors import sample_prior_model
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    s = setup.setup
    m = _as_model(sample_prior_model(torch.Generator().manual_seed(18),
                                     8).to('cuda'))
    n_per = torch.round(m.n_periods).to(torch.int64)
    h, mu, idx, clip, _ = day_scatter_inputs(
        s.wind_flat, s.wind_cumsum, day,
        tuple(v.reshape(-1, 1) for v in m.hparams()), m.mu_r.reshape(-1, 1),
        n_per.reshape(-1, 1), s.start_idx if day == 0 else 0, s.kcfg,
        s.rad_dist)
    Dp = torch.stack(m.Dparams(), dim=-1).contiguous()
    return (h, mu, idx, clip, Dp, s.rad_dist / s.kcfg.rad_res, s.kcfg.K,
            s.scfg.dom_len + 4 * s.kcfg.K)


def run_tree(root, timing):
    sys.path.insert(0, root)
    import torch
    from parasitoids_tpu_torch.ops import _build, day_kernel
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(day_kernel.__file__))))
    assert pkg_root == os.path.abspath(root), day_kernel.__file__
    lib = _build.load('day_kernel')
    hashes, times = {}, {}
    p, cell, s = kalbar_setup(400, torch)
    K, buf_len = s.kcfg.K, s.scfg.dom_len + 4 * s.kcfg.K
    for day in (0, 9, 17):
        h, mu, idx, clip = day_args(p, s, day)
        for rho in FWD_RHOS:
            Dp = (p.Dparams[0], p.Dparams[1], rho)
            outs = forward_outputs(lib, day_kernel, h, mu, idx, clip, Dp,
                                   cell, K, buf_len, torch)
            for name, t in zip(('buf', 'bsum', 'loss'), outs):
                hashes['K{} day {} rho {:+.3f} {}'.format(
                    2 if abs(rho) >= 0.925 else 1, day, rho, name)] = sha(t)
            if timing and day == 9 and rho in (0.253, 0.99):
                times['K{} (rho {:+.3f})'.format(
                    2 if rho > 0.9 else 1, rho)] = np.median(
                    day_kernel.pass_ms(h, mu, idx, clip, Dp, cell, K,
                                       buf_len, reps=20), axis=0).tolist()
    from parasitoids_tpu_torch.bayes import run as bayes_run
    setup = bayes_run.build_setup(device='cuda')
    for day in (0, 9, 17):
        h, mu, idx, clip, Dp, bcell, bK, blen = batched_inputs(setup, day,
                                                               torch)
        if timing and day == 9:
            times['batched, 8 prior particles'] = np.median(
                day_kernel.pass_ms(h, mu, idx, clip, Dp, bcell, bK, blen,
                                   reps=20), axis=0).tolist()
        Dp = Dp.clone()
        Dp[:, 2] = torch.tensor(BATCH_RHOS, device=Dp.device)
        outs = forward_outputs(lib, day_kernel, h, mu, idx, clip, Dp, bcell,
                               bK, blen, torch)
        for name, t in zip(('buf', 'bsum', 'loss'), outs):
            hashes['batched day {} {}'.format(day, name)] = sha(t)
    gen = torch.Generator(device='cuda').manual_seed(0)
    for rad_res, days, rhos in ((400, (0, 9, 17), BWD_RHOS),
                                (800, (9,), (0.253,))):
        p, cell, s = kalbar_setup(rad_res, torch)
        K, buf_len = s.kcfg.K, s.scfg.dom_len + 4 * s.kcfg.K
        ct_buf = torch.randn((buf_len, buf_len), generator=gen, device='cuda')
        ct_loss = torch.randn((), generator=gen, device='cuda')
        for day in days:
            h, mu, idx, clip = day_args(p, s, day)
            for rho in rhos:
                a = (ct_buf, ct_loss, h, mu, idx, clip,
                     (p.Dparams[0], p.Dparams[1], rho), cell, K, buf_len)
                outs = day_kernel.accumulate_day_bwd(
                    *a, **packed_once(day_kernel, a[6], cell, h.device))
                tag = 'K{} K={} day {} rho {:+.3f}'.format(
                    4 if abs(rho) >= 0.925 else 3, K, day, rho)
                for name, t in zip(('dh', 'dmu', 'dclip', 'dD', 'dcell'),
                                   outs):
                    hashes[tag + ' ' + name] = sha(t)
                if timing and K == 44 and day == 9 and rho in (0.253, 0.99):
                    times['K{} (rho {:+.3f})'.format(
                        4 if rho > 0.9 else 3, rho)] = np.median(
                        day_kernel.pass_ms_bwd(*a, reps=20), axis=0).tolist()
    torch.cuda.synchronize()
    print('HASHES ' + json.dumps(dict(root=os.path.abspath(root),
                                      hashes=hashes, times=times)))


def against(parent, timing):
    runs = []
    for root in (parent, HERE, HERE, parent):
        cmd = [sys.executable, os.path.abspath(__file__), '--root', root] + \
            (['--time'] if timing else [])
        out = subprocess.run(cmd, capture_output=True, text=True)
        line = [x for x in out.stdout.splitlines() if x.startswith('HASHES ')]
        if out.returncode or not line:
            sys.exit('{} failed:\n{}{}'.format(root, out.stdout, out.stderr))
        runs.append(json.loads(line[0][len('HASHES '):]))
        print('{}: {} outputs hashed'.format(root, len(runs[-1]['hashes'])))
    a, b = runs[0]['hashes'], runs[1]['hashes']
    same = [runs[0]['hashes'] == runs[3]['hashes'],
            runs[1]['hashes'] == runs[2]['hashes']]
    differ = sorted(k for k in a if a[k] != b.get(k))
    print('each tree repeats its bits: parent {}, change {}'.format(*same))
    print('{} of {} outputs differ between the trees{}'.format(
        len(differ), len(a), ''.join('\n  ' + k for k in differ)))
    digest = lambda h: hashlib.sha256(json.dumps(h, sort_keys=True).encode()
                                      ).hexdigest()
    print('sha256 of all output hashes: parent {} change {}'.format(
        digest(a), digest(b)))
    for name in runs[0]['times']:
        ms = [np.asarray(r['times'][name]) for r in runs]
        print('{}: parent {} ms, change {} ms (each pass, mean of two '
              'runs of 20-rep medians)'.format(
                  name, np.round((ms[0] + ms[3]) / 2, 4).tolist(),
                  np.round((ms[1] + ms[2]) / 2, 4).tolist()))
    return 0 if not differ and all(same) and set(a) == set(b) else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=None)
    ap.add_argument('--against', default=None)
    ap.add_argument('--time', action='store_true')
    args = ap.parse_args()
    if args.against:
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout.strip()
        print('card: ' + smi)
        sys.exit(against(args.against, args.time))
    run_tree(args.root or HERE, args.time)


if __name__ == '__main__':
    main()
