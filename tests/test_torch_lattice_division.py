"""The day kernel's lattice arithmetic on the CPU: the packed constants the
CUDA kernel (csrc/day_kernel.cu) divides and scales by, the layout it reads
them with, the arithmetic of its ``div_exact`` and the error of its
low-|ρ| node terms.

On the high-|ρ| series the kernel replaces each division by a per-node or
per-ρ constant d with ``q0 = a·r``, ``e = −(q0·d − a)``, ``q = e·r + q0``
(two FMAs), r the packed f32 reciprocal of d.  That is the IEEE quotient,
bit for bit, only if r is the correctly rounded 1/d of d's f32 value and
the operands stay within the range the kernel's comments state.  Those
three facts are held here with exact arithmetic.

On the low-|ρ| branches a node term exp((sn·hk − hs)/(1 − sn²)) is
``2^(a·L)``: a = fma(hk, sn, −hs), L = log2(e)/(1 − sn²) packed, and the
MUFU's ex2.  The packed scales and the term's error bound are held here,
with a correctly rounded exp2 standing in for the MUFU;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the compiled kernel
to the same bound plus ex2's 2 ulp on the card (``lattice_probe``)."""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import F32_EPS, corner_hk_hs, f32_fma, low_corner_gap
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
    # each reciprocal row of the series is 1 / (its divisor's f32 value) in
    # f32, bit for bit; and every divisor lies in div_exact's range
    # [2^-40, 2^26].
    # ``select`` is accepted and packs the same row either way
    L = day_kernel.LAYOUT
    cpu = torch.device('cpu')
    q = day_kernel.pack_constants((171.82, 144.58, rho), 25.0, cpu,
                                  select=select).numpy()
    np.testing.assert_array_equal(_bits(q), _bits(day_kernel.pack_constants(
        (171.82, 144.58, rho), 25.0, cpu, select=not select).numpy()))
    hi = 20

    def row(name, n):
        return q[L[name]:L[name] + n]

    rs = row('kHiRs', hi)
    pairs = [(row('kHiXs', hi), row('kHiInvXs', hi)),
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


@pytest.mark.parametrize('select', [False, True])
@pytest.mark.parametrize('rho', RHOS)
def test_packed_exponent_scales_are_f64_quotients(rho, select):
    # the low branches' exponent scales log2(e) / (1 - sn^2) and closing
    # factor asr / (4 pi) are the f32 roundings of the f64 quotients of
    # their f32 operands (the packed 1 - sn^2, itself 1 - sn*sn in f32 from
    # the packed sn, and the packed asin(rho)), bit for bit, at the slots
    # the kernel reads; the same row for a particle of a batch
    L = day_kernel.LAYOUT
    cpu = torch.device('cpu')
    q = day_kernel.pack_constants((171.82, 144.58, rho), 25.0, cpu,
                                  select=select).numpy()
    lo = 38

    def row(name):
        return q[L[name]:L[name] + lo]
    sn, den = row('kLoSn'), row('kLoDen')
    np.testing.assert_array_equal(_bits(F32(1) - sn * sn), _bits(den))
    np.testing.assert_array_equal(
        _bits(np.float64(np.log2(np.e)) / den.astype(np.float64)),
        _bits(row('kLoL2Den')))
    asr = np.float64(q[L['kAsr']])
    assert _bits(asr / (4 * np.pi)) == _bits(q[L['kAsr4Pi']])
    want = np.float32(np.arcsin(np.clip(np.float32(rho), -1 + 1e-6,
                                        1 - 1e-6)))
    assert abs(q[L['kAsr']] - want) <= 2 * abs(np.spacing(want)) + 1e-45
    Dp = torch.tensor([[171.82, 144.58, rho], [90.0, 120.0, -0.3]])
    qb = day_kernel.pack_constants(Dp, 25.0, cpu, select=select).numpy()
    np.testing.assert_array_equal(_bits(qb[0]), _bits(q))


# a Kalbar-sized corner lattice: K = 44, 25 m cells, the flight diffusion
# over the prior's range (sig_x ~ Gamma(26, 0.15), sig_y ~ Gamma(15, 0.15),
# each from about its 1st to its 99th percentile, and the narrowest the
# probe takes) and mean offsets from the centre to 0.9 of the window's
# reach; rho in the tier of each node rule, both signs
LAT_K, LAT_CELL = 44, 25.0
LAT_SIGMAS = ((100.0, 50.0), (171.82, 144.58), (270.0, 180.0), (21.1, 10.6))
LAT_MUS = ((0.0, 0.0), (12.5, -7.3), (0.9 * LAT_K * LAT_CELL,
                                      -0.6 * LAT_K * LAT_CELL))
TIER_RHOS = {6: (0.253, -0.1), 12: (0.5, -0.7), 20: (0.9, -0.92)}
LOG2E = np.log2(np.e)


def _lattice(sx, sy, mux, muy):
    """The corner edges xe (columns) and ye (rows) of one minute, f32."""
    i = np.arange(2 * LAT_K + 2, dtype=F32)
    c = F32(LAT_K + 0.5)
    xe = ((i - c) * F32(LAT_CELL) - F32(mux)) / F32(sx)
    ye = ((c - i) * F32(LAT_CELL) - F32(muy)) / F32(sy)
    return xe[None, :], ye[:, None]


def _ex2_stand_in(x):
    """2^x correctly rounded to f32, with ex2.approx.ftz's flush of results
    below 2^-126."""
    y = np.exp2(x.astype(np.float64)).astype(F32)
    return np.where(y < F32(2.0 ** -126), F32(0), y)


@pytest.mark.parametrize('G', [6, 12, 20])
def test_ex2_node_terms_hold_their_bound(G):
    # every node term of every corner: the kernel's f32 form exp2(f32(a L)),
    # a = fma(hk, sn, -hs) in f32 and exp2 correctly rounded (the MUFU's
    # stand-in), against float64 exp((sn hk - hs) / (1 - sn^2)) of the
    # same f32 hk, hs, sn and 1 - sn^2.  The bound, relative: |x2| 2^-23 +
    # 4 ulp (an ulp at most 2^-23 of the value), x2 = a L the base-2
    # exponent.  The three roundings (a, L, a L) move x2 by at most 3
    # 2^-24 of itself, the term by ln(2) 3 2^-24 |x2| < 1.04 |x2| 2^-23,
    # and exp2 rounds by half an ulp: the 4 ulp hold the rest unless all
    # three roundings take nearly their worst at once past |x2| = 87.
    # Below 2^-126 the term flushes to 0.  The exponent is never positive.
    off = {6: 0, 12: 6, 20: 18}[G]
    L = day_kernel.LAYOUT
    cpu = torch.device('cpu')
    checked = 0
    for rho in TIER_RHOS[G]:
        for sx, sy in LAT_SIGMAS:
            q = day_kernel.pack_constants((sx, sy, rho), LAT_CELL,
                                          cpu).numpy()

            def row(name):
                return q[L[name] + off:L[name] + off + G]
            sn, den, scale = row('kLoSn'), row('kLoDen'), row('kLoL2Den')
            for mux, muy in LAT_MUS:
                hk, hs = corner_hk_hs(*_lattice(sx, sy, mux, muy))
                a = f32_fma(hk[..., None], sn, -hs[..., None])
                x2 = a * scale                          # f32 product
                assert (a <= 0).all() and (x2 <= 0).all()
                got = _ex2_stand_in(x2)
                xe = (sn.astype(np.float64) * hk.astype(np.float64)[..., None]
                      - hs.astype(np.float64)[..., None]) / den
                want = np.exp(xe)
                x2e = xe * LOG2E
                live = x2e >= -125.0
                rel = np.abs(got[live] - want[live]) / want[live]
                assert (rel <= (np.abs(x2e[live]) + 4) * F32_EPS).all(), \
                    float((rel / ((np.abs(x2e[live]) + 4) * F32_EPS)).max())
                assert (got[~live] <= F32(2.0 ** -124)).all()
                checked += int(live.sum())
    assert checked > 0.5 * len(TIER_RHOS[G]) * len(LAT_SIGMAS) * \
        len(LAT_MUS) * (2 * LAT_K + 2) ** 2 * G


def _emulated_corners(edges, q, G, ex2_ulps=0):
    """block_build's corners of one low-branch minute emulated in f32 on the
    CPU, the MUFU's ex2 taken as exp2 correctly rounded, or that times
    1 + ``ex2_ulps`` 2^-23 (a planted fault)."""
    off = {6: 0, 12: 6, 20: 18}[G]
    L = day_kernel.LAYOUT
    xe, ye, px, py = edges
    hk, hs = corner_hk_hs(xe[None, :], ye[:, None])
    total = np.zeros_like(hk)
    for g in range(G):
        sn, w, scale = (q[L[n] + off + g] for n in ('kLoSn', 'kLoW',
                                                   'kLoL2Den'))
        e = _ex2_stand_in(f32_fma(hk, sn, -hs) * scale) * \
            F32(1 + ex2_ulps * F32_EPS)
        total = f32_fma(w, e, total)
    t = total * q[L['kAsr4Pi']]
    return px[None, :] * py[:, None] + t


@pytest.mark.parametrize('G', [6, 12, 20])
def test_low_corner_bound_holds_for_the_emulated_kernel(G):
    # the card test's bound (chip_smoke.low_corner_gap) on the CPU: the
    # kernel's corners emulated in f32, edges as the kernel computes them
    # (Phi of the edges in f32), lie within the bound of their float64
    # twin at every corner; the bound stays under 5e-7, a quarter of the
    # 2e-6 the card holds the day buffer to against the plain twin; and an
    # exp 32 ulp off its value fails it
    cpu = torch.device('cpu')
    caught = 0
    for rho in TIER_RHOS[G]:
        for sx, sy in LAT_SIGMAS:
            q = day_kernel.pack_constants((sx, sy, rho), LAT_CELL,
                                          cpu).numpy()
            for mux, muy in LAT_MUS:
                xe, ye = _lattice(sx, sy, mux, muy)
                xe, ye = xe[0], ye[:, 0]
                ph = torch.special.ndtr(torch.from_numpy(-xe)).numpy()
                pk = torch.special.ndtr(torch.from_numpy(-ye)).numpy()
                edges = np.stack([xe, ye, ph, pk]).astype(F32)
                lat = _emulated_corners(edges, q, G)
                gap, bound = low_corner_gap(lat, edges, q, G)
                assert (gap <= bound).all(), float((gap / bound).max())
                assert bound.max() < 5e-7
                bad, _ = low_corner_gap(_emulated_corners(edges, q, G, 32),
                                        edges, q, G)
                caught += (bad > bound).any()
    assert caught == len(TIER_RHOS[G]) * len(LAT_SIGMAS) * len(LAT_MUS)


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
