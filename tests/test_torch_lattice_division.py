"""The day kernel's lattice division on the CPU: the packed constants the
CUDA kernel (csrc/day_kernel.cu) divides by and their reciprocals, the
layout it reads them with, and the arithmetic of its ``div_exact``.

The kernel replaces each division by a per-node or per-ρ constant d with
``q0 = a·r``, ``e = −(q0·d − a)``, ``q = e·r + q0`` (two FMAs), r the packed
f32 reciprocal of d.  That is the IEEE quotient, bit for bit, only if r is
the correctly rounded 1/d of d's f32 value and the operands stay within
the range the kernel's comments state.  Those three facts are held here
with exact arithmetic; ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
hold the compiled kernel to them on the card (``lattice_probe``)."""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from parasitoids_tpu_torch.ops import day_kernel

SRC = Path(day_kernel.__file__).resolve().parent.parent / 'csrc' / \
    'day_kernel.cu'
F32 = np.float32
RHOS = [0.0, 0.253, -0.253, 0.5, -0.9, 0.925, 0.93, -0.99, 1 - 1e-6, -1.5]


def _cu_constants():
    """The namespace-level ``constexpr int`` constants of the CUDA source,
    evaluated in order."""
    env = {}
    for stmt in re.findall(r'^constexpr int (k[^;]*);', SRC.read_text(),
                           flags=re.M):
        for part in re.sub(r'//[^\n]*', '', stmt).split(','):
            name, expr = (x.strip() for x in part.split('=', 1))
            env[name] = eval(expr.replace('/', '//'), {}, dict(env))
    return env


def test_layout_matches_the_cuda_source():
    # every slot the port packs or reads by name sits where the kernel
    # reads it, and the row lengths add up to kConsts
    cu = _cu_constants()
    for name, at in day_kernel.LAYOUT.items():
        assert cu[name] == at, name
    assert cu['kConsts'] == 290 and cu['kNodeRows'] == 38 + 2 * 20


def _bits(x):
    return np.asarray(x, F32).view(np.uint32)


@pytest.mark.parametrize('select', [False, True])
@pytest.mark.parametrize('rho', RHOS)
def test_packed_reciprocals_are_f32_quotients(rho, select):
    # each reciprocal row is 1 / (its divisor's f32 value) in f32, bit for
    # bit; and every divisor lies in div_exact's range [2^-40, 2^26].
    # ``select`` is accepted and packs the same row either way
    L = day_kernel.LAYOUT
    cpu = torch.device('cpu')
    q = day_kernel.pack_constants((171.82, 144.58, rho), 25.0, cpu,
                                  select=select).numpy()
    np.testing.assert_array_equal(_bits(q), _bits(day_kernel.pack_constants(
        (171.82, 144.58, rho), 25.0, cpu, select=not select).numpy()))
    lo, hi = 38, 20

    def row(name, n):
        return q[L[name]:L[name] + n]

    rs = row('kHiRs', hi)
    pairs = [(row('kLoDen', lo), row('kLoInvDen', lo)),
             (row('kHiXs', hi), row('kHiInvXs', hi)),
             (F32(2) * (F32(1) + rs), row('kHiInvEp', hi)),
             (rs, row('kHiInvRs', hi)),
             (q[L['kA']:L['kA'] + 1], q[L['kInvA']:L['kInvA'] + 1]),
             (q[L['kASq']:L['kASq'] + 1], q[L['kInvASq']:L['kInvASq'] + 1])]
    for d, r in pairs:
        np.testing.assert_array_equal(_bits(F32(1) / d), _bits(r))
        assert np.all(d >= 2.0 ** -40) and np.all(d <= 2.0 ** 26)
    # the same rows, one per particle, for a batch
    Dp = torch.tensor([[171.82, 144.58, rho], [90.0, 120.0, -0.3]])
    qb = day_kernel.pack_constants(Dp, 25.0, cpu, select=select).numpy()
    np.testing.assert_array_equal(_bits(qb[0]), _bits(q))


def _rn32(x):
    """The f32 nearest the exact rational x, ties to even."""
    f = F32(float(x))
    best = None
    for c in (np.nextafter(f, F32(-np.inf)), f, np.nextafter(f, F32(np.inf))):
        if not np.isfinite(c):
            continue
        err = abs(Fraction(float(c)) - x)
        key = (err, int(_bits(c)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return best[1]


def _fma32(x, y, z):
    """f32 fma(x, y, z): the exact x·y + z rounded once, with IEEE's signs
    of an exact zero (the sign both terms share, else +0)."""
    exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    if exact:
        return _rn32(exact)
    neg_xy = np.signbit(x) != np.signbit(y)
    if (x == 0 or y == 0) and z == 0 and neg_xy and np.signbit(z):
        return F32(-0.0)
    return F32(0.0)


def _div_exact(a, d, r):
    """The kernel's div_exact, each FMA rounded once from the exact value."""
    q0 = F32(a * r)                       # a·r rounded once, as __fmul_rn
    e = -_fma32(q0, d, -a)
    return _fma32(e, r, q0)


def _divisors(kind, rng, n):
    if kind == 'den':                     # 1 - sn^2, |sn| <= 0.925
        sn = rng.uniform(-0.925, 0.925, n).astype(F32)
        return F32(1) - sn * sn
    if kind == 'xs':                      # down to 2.4e-11
        return F32(2.0) ** rng.uniform(-35.3, -2.8, n).astype(F32)
    if kind == 'ep':                      # 2 (1 + rs), rs in [0.925, 1]
        return F32(2) * (F32(1) + rng.uniform(0.925, 1.0, n).astype(F32))
    if kind == 'all_ones':                # mantissas of all ones
        e = rng.integers(-36, 2, n)
        return (np.ldexp(2.0 - 2.0 ** -23, e)).astype(F32)
    return F32(2.0) ** rng.uniform(-36, 2, n).astype(F32)


@pytest.mark.parametrize('kind', ['den', 'xs', 'ep', 'all_ones', 'any'])
def test_div_exact_is_the_ieee_quotient(kind):
    # over divisors of each kind and dividends of either sign across
    # [2^-96, 2^64] (and both zeros), the kernel's corrected product gives
    # the IEEE quotient's bits, signed zeros included; the plain product
    # a·r does not (it differs in a share of the cases)
    rng = np.random.default_rng(11)
    n = 600
    d = _divisors(kind, rng, n)
    a = (rng.choice([-1.0, 1.0], n) *
         2.0 ** rng.uniform(-96, 64, n)).astype(F32)
    a[:2] = [F32(0.0), F32(-0.0)]
    plain = 0
    for ai, di in zip(a, d):
        r = F32(1) / di
        want = ai / di
        got = _div_exact(ai, di, r)
        assert _bits(got) == _bits(want), (ai, di)
        plain += _bits(F32(ai * r)) != _bits(want)
    assert plain > 0
