"""dρ of one day's accumulate near |ρ| = 1 in f32, the JAX package against
the port, each held against f64, on the CPU.

    JAX_PLATFORMS=cpu python scripts/check_torch_drho_f32.py [--rho -0.99]

The inputs are the ``corners`` case of ``tests/test_torch_cuda.py`` (every
minute's block at one of the buffer's four corners, K = 44, T = 1440,
977² buffer, 25 m cells, seeded with numpy) with a white-noise and a
smooth cotangent.  JAX's f32 backward is the ``jax.vjp`` of its XLA
accumulate (``parasitoids_tpu/ops/daily_kernel.xla_accumulate_day``, the
oracle its Pallas backward is tested against), the port's is
``accumulate_day_bwd_plain``; each runs in f32 and in f64 on the same f32
inputs.  Prints each package's f32 dρ, its f64 dρ and the f32 distance from
f64 over |dρ|, the scale the card tests use.  The f64 reference is the
port's plain backward in f64 (the reference of the card tests); JAX runs
in f32 only, since its BVN blocks follow the default float type.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from parasitoids_tpu.ops.daily_kernel import xla_accumulate_day  # noqa: E402
from parasitoids_tpu_torch.ops.day_kernel import (  # noqa: E402
    accumulate_day_bwd_plain)

K, T, BUF = 44, 1440, 977
SIG = (171.82, 144.58)
CELL = 25.0


def corners_inputs():
    """The ``corners`` case of tests/test_torch_cuda.py, in numpy."""
    n = 2 * K + 1
    last = BUF - n
    rng = np.random.default_rng(7)
    corners = np.array([[0, 0], [0, last], [last, 0], [last, last]])
    idx = corners[np.arange(T) % 4]
    h = rng.random(T) * (0.2 / 1440)
    h[1::3] = 0.0
    mu = rng.uniform(-12.5, 12.5, size=(T, 2))
    clip = ((idx < 2 * K) | (idx + n > BUF - 2 * K)).any(axis=1)
    return (h.astype(np.float32), mu.astype(np.float32),
            idx.astype(np.int32), clip.astype(np.float32))


def cotangent(seed, smooth):
    rng = np.random.default_rng(seed)
    if not smooth:
        return (rng.standard_normal((BUF, BUF)).astype(np.float32),
                np.float32(rng.standard_normal()))
    coarse = torch.from_numpy(rng.standard_normal((1, 1, 24, 24)))
    fine = torch.nn.functional.interpolate(coarse, size=(BUF, BUF),
                                           mode='bicubic', align_corners=True)
    return (fine[0, 0].numpy().astype(np.float32),
            np.float32(rng.standard_normal()))


def jax_drho(inputs, ct, rho, dtype):
    h, mu, idx, clip = inputs
    ct_buf, ct_loss = ct
    cast = lambda a: jnp.asarray(a, dtype)

    def f(r):
        return xla_accumulate_day(cast(h), cast(mu), jnp.asarray(idx),
                                  cast(clip), (cast(SIG[0]), cast(SIG[1]), r),
                                  cast(CELL), K, 20, BUF, chunk=240)

    _, vjp = jax.vjp(f, cast(rho))
    return float(vjp((cast(ct_buf), cast(ct_loss)))[0])


def torch_drho(inputs, ct, rho, dtype):
    h, mu, idx, clip = inputs
    ct_buf, ct_loss = ct
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dtype)
    out = accumulate_day_bwd_plain(
        t(ct_buf), t(ct_loss), t(h), t(mu), torch.from_numpy(idx), t(clip),
        (t(SIG[0]), t(SIG[1]), t(rho)), t(CELL), K, BUF)
    return float(out[3][2])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--rho', type=float, default=-0.99)
    args = ap.parse_args()
    inputs = corners_inputs()
    for smooth in (False, True):
        ct = cotangent(2, smooth)
        ref = torch_drho(inputs, ct, args.rho, torch.float64)
        print('corners, rho {:+.3f}, {} cotangent: f64 drho {!r}'.format(
            args.rho, 'smooth' if smooth else 'white', ref))
        for name, d32 in (('jax', jax_drho(inputs, ct, args.rho,
                                           jnp.float32)),
                          ('port', torch_drho(inputs, ct, args.rho,
                                              torch.float32))):
            print('  {} f32: drho {!r}; |f32 - f64| / |drho| = {:.3e}'
                  .format(name, d32, abs(d32 - ref) / abs(ref)))


if __name__ == '__main__':
    main()
