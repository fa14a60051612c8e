"""Write the JAX golden that the PyTorch port's gradient is held against on
the card: the value and gradient of the MAP objective (the negative log
posterior over the unconstrained vector z) at the MAP CLI's starting point.

    JAX_PLATFORMS=cpu python scripts/make_torch_grad_golden.py

Configuration: the MAP CLI's default (``parasitoids_tpu.bayes.map_fit
--MAP``): Kalbar population model, 401² cells of 50 m, 18 wind days of
1,440 minutes, prior-coverage windows K = 22 and Kl = 10, the pre-spread
factor fitted, f32, JAX's XLA accumulate.  Writes
``tests/torch_golden/map_grad_401.npz`` (z0, value, grad and the
configuration); ``chip_smoke.py`` reads it.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'tests', 'torch_golden', 'map_grad_401.npz')


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-o', '--out', default=OUT)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)                       # data/ is addressed repo-relative
    import jax
    import jax.numpy as jnp

    from parasitoids_tpu.bayes import map_fit as jm
    from parasitoids_tpu.bayes.model import BayesSetup
    from parasitoids_tpu.config import Params

    p = Params()
    p.cmd_line_chg(['--kalbar'])
    p.PLOT = p.OUTPUT = False
    p.PROB_MODEL = False
    p.domain_info = (10000.0, 200)       # map_fit.main's domain
    setup = BayesSetup(p)
    kcfg = setup.setup.kcfg
    use_sprd = jm.default_use_sprd(p)
    neg, _, unconstrain = jm._make_objective(setup, use_sprd)
    o0 = jm.initial_obs_params(
        [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
        setup.cell_res ** 2)
    z0 = unconstrain(jnp.asarray(jm.initial_model_params(), jnp.float32),
                     jnp.asarray(o0, jnp.float32), jnp.float32(0.3))
    tic = time.time()
    value, grad = jax.jit(jax.value_and_grad(neg))(z0)
    value, grad = float(value), np.asarray(grad)
    print('value {!r}, |grad| {!r} ({:.1f} s, jax {}, {})'.format(
        value, float(np.linalg.norm(grad)), time.time() - tic,
        jax.__version__, jax.default_backend()))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez(args.out, z0=np.asarray(z0), value=np.float64(value),
             grad=grad, domain_info=np.asarray(p.domain_info),
             ndays=setup.ndays, periods=kcfg.periods, K=kcfg.K,
             K_local=kcfg.K_local, use_sprd=use_sprd,
             jax_version=jax.__version__,
             backend=jax.default_backend())
    print('wrote', args.out)


if __name__ == '__main__':
    main()
