"""The log posterior's value and gradient at the 801² Bayes default
(map_fit's start, the pre-spread day; ``chip_smoke.py`` [7]'s point)
through the CUDA kernels, for two trees, to show how far a change moves
them; and the sha256 of the no-gradient forward's projections there.
Needs a CUDA device; imports no JAX.

    python scripts/compare_torch_gradient.py --against DIR

runs DIR and this checkout in turn (DIR, this, this, DIR), each in a
process of its own, and prints whether each tree repeats its own bits,
whether the projections and the value are equal, and each gradient
component's difference relative to itself and to the largest component.
``--root DIR`` prints one tree's line ``GRADIENT {json}``.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tree(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)                     # data/ is addressed repo-relative
    import torch
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import (BayesSetup, _as_model,
                                                   _kalbar_default_params)
    setup = BayesSetup(_kalbar_default_params(), device='cuda')
    neg, constrain, _ = map_fit._make_objective(setup, True)
    z0 = map_fit.initial_z(setup, True)
    with torch.no_grad():
        m, _, sprd = constrain(z0)
        proj = setup.forward_projections(_as_model(m), sprd)
    flat = torch.cat([p.reshape(-1) for p in (*proj[0], *proj[1], proj[2])])
    z = z0.clone().requires_grad_()
    v = neg(z)
    v.backward()
    torch.cuda.synchronize()
    print('GRADIENT ' + json.dumps(dict(
        root=os.path.abspath(root),
        proj=hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest(),
        value=float(v.detach()), grad=z.grad.double().cpu().tolist())))


def against(other):
    runs = []
    for root in (other, HERE, HERE, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--root', root], capture_output=True, text=True)
        line = [x for x in out.stdout.splitlines()
                if x.startswith('GRADIENT ')]
        if out.returncode or not line:
            sys.exit('{} failed:\n{}{}'.format(root, out.stdout, out.stderr))
        runs.append(json.loads(line[0][len('GRADIENT '):]))
    same = [runs[0] == runs[3], runs[1] == runs[2]]
    a, b = runs[0], runs[1]
    ga, gb = np.asarray(a['grad']), np.asarray(b['grad'])
    d = np.abs(gb - ga)
    rel = d / np.maximum(np.abs(ga), 1e-30)
    print('each tree repeats its bits: other {}, this {}'.format(*same))
    print('projections equal: {}; value other {!r} this {!r} (equal: {})'
          .format(a['proj'] == b['proj'], a['value'], b['value'],
                  a['value'] == b['value']))
    print('gradient components that differ: {} of {}'.format(
        int(np.count_nonzero(d)), d.size))
    for i in np.flatnonzero(d):
        print('  z[{}]: other {!r} this {!r}: |dg| {:.3e}, {:.3e} of '
              'itself, {:.3e} of the largest'.format(
                  i, ga[i], gb[i], d[i], rel[i], d[i] / np.abs(ga).max()))
    print('largest: {:.3e} of a component itself, {:.3e} of the largest '
          'component; relative L2 {:.3e}'.format(
              float(rel.max()), float(d.max() / np.abs(ga).max()),
              float(np.linalg.norm(d) / np.linalg.norm(ga))))
    return 0 if all(same) else 1


def main():
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument('--against', metavar='DIR')
    g.add_argument('--root', metavar='DIR')
    args = ap.parse_args()
    if args.root:
        run_tree(args.root)
        return 0
    return against(args.against)


if __name__ == '__main__':
    sys.exit(main())
