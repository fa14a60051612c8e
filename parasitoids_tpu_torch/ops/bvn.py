"""Bivariate-normal cell masses, PyTorch port of
``parasitoids_tpu/ops/bvn.py::bvn_cell_masses`` (:66-309).

The upper-orthant probability ``L(h, k) = P(X > h, Y > k)`` is evaluated
on the ``(2K+2)²`` lattice of cell corners with the Drezner–Wesolowsky /
Genz algorithm, and cell masses are the four-corner differences, clamped
at 0.  The node count follows Genz's |ρ| thresholds (6/12/20 nodes below
0.3/0.75/0.925, the asymptotic series beyond) as the JAX
``bvn_upper_grid`` does.  The JAX op takes the branch with a
``lax.switch`` on the traced ρ; here it is picked on the host: from a
Python number for free, from a ``branch`` the caller read once (the log
posterior reads every ρ once per evaluation), or else by reading ρ, which
for a ρ on a CUDA device waits on the card.

The gradient is the JAX op's closed-form rule, not autograd through the
quadrature: :class:`_CellMasses` saves the inputs and the clamped output,
and its backward (:func:`cell_masses_vjp`) contracts the cotangent with
the closed-form CDF derivative lattices.  That backward is written in
differentiable torch ops, so autograd differentiates it once more: the
second derivative is the derivative of the closed-form rule, as JAX takes
it through the op's ``custom_jvp`` (the Laplace Hessian, reverse over
reverse).  The plain day-accumulate backward (``ops/day_kernel.py``)
shares that rule.

Everything is batched over leading dimensions of ``mu``: ``(2,)`` gives
one ``(n, n)`` block, ``(C, 2)`` gives ``(C, n, n)``.  The
ensemble-batched variant (:func:`bvn_cell_masses_batched`, the JAX
``bvn_cell_masses_batched``) also takes one σx, σy and ρ per particle on a
leading axis and replaces the four-way node rule by the two-branch
select of :func:`bvn_upper_grid_select`, which needs no host read of any
ρ.  :func:`bvn_cell_masses_quad` is the JAX package's conditional-
decomposition cross-check.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..device import scalar

__all__ = ['SELECT', 'bvn_cell_masses', 'bvn_cell_masses_batched',
           'bvn_cell_masses_quad', 'bvn_upper_grid', 'bvn_upper_grid_select',
           'cell_masses_vjp', 'corner_rect', 'gauss_legendre', 'genz_branch',
           'gl_nodes']

_TWO_PI = 2.0 * np.pi
_SQRT_2PI = float(np.sqrt(2.0 * np.pi))
# the ``branch`` that asks for the two-branch select node rule
SELECT = 'select'
_SELECT_RHO = 0.925       # the select's low branch holds |ρ| <= this


@lru_cache(maxsize=None)
def gauss_legendre(n: int):
    """Gauss–Legendre nodes and weights on [-1, 1] (host numpy)."""
    return np.polynomial.legendre.leggauss(n)


@lru_cache(maxsize=None)
def gl_nodes(G: int, dtype: torch.dtype, device: torch.device):
    """Gauss–Legendre nodes and weights as tensors on ``device``, made once:
    a host-to-card copy inside the day loop would wait for the card."""
    x, w = gauss_legendre(G)
    return (torch.as_tensor(x, dtype=dtype).to(device),
            torch.as_tensor(w, dtype=dtype).to(device))


def _upper_lowcorr(h, k, rho, G, phi_prod):
    """P(X > h, Y > k) for |ρ| < 0.925: G-node Gauss–Legendre quadrature of
    the correlation integral.  The exponent is ≤ 0 for every node.  ``rho``
    is 0-d, or broadcasts against ``h`` (one ρ per particle)."""
    x, w = gl_nodes(G, h.dtype, h.device)
    hk = h * k
    hs = 0.5 * (h * h + k * k)
    asr = torch.asin(rho)
    total = torch.zeros_like(hk)
    for g in range(G):
        sn = torch.sin(asr * 0.5 * (1.0 + x[g]))
        total = total + w[g] * torch.exp((sn * hk - hs) / (1.0 - sn * sn))
    return total * asr / (2.0 * _TWO_PI) + phi_prod


def _upper_highcorr(h, k, rho, G=20):
    """|ρ| ≥ 0.925: Genz 2004 BVND complementary asymptotic series plus
    tail quadrature.  Exponents are clipped and masked as in the JAX op."""
    x, w = gl_nodes(G, h.dtype, h.device)
    ndtr = torch.special.ndtr
    sgn = torch.sign(rho)
    k = k * sgn                                   # ρ < 0: flip k
    hk = h * k
    a_sq = torch.clamp((1.0 - rho) * (1.0 + rho), min=1e-30)
    a = torch.sqrt(a_sq)
    bs = (h - k) ** 2
    c = (4.0 - hk) / 8.0
    d = (12.0 - hk) / 16.0
    asr = -(bs / a_sq + hk) / 2.0
    zero = torch.zeros_like(hk)
    bvn = torch.where(asr > -80.0,
                      a * torch.exp(torch.clamp(asr, -80.0, 0.0)) *
                      (1.0 - c * (bs - a_sq) * (1.0 - d * bs / 5.0) / 3.0 +
                       c * d * a_sq * a_sq / 5.0), zero)
    b = torch.sqrt(torch.where(bs > 1e-30, bs, torch.full_like(bs, 1e-30)))
    term = (torch.exp(torch.clamp(-hk / 2.0, -80.0, 80.0)) * _SQRT_2PI *
            ndtr(-b / a) * b * (1.0 - c * bs * (1.0 - d * bs / 5.0) / 3.0))
    bvn = bvn - torch.where(-hk < 80.0, term, zero)
    a_half = a / 2.0
    for g in range(G):
        xs = (a_half * (1.0 + x[g])) ** 2
        rs = torch.sqrt(1.0 - xs)
        asr1 = -(bs / xs + hk) / 2.0
        sp = 1.0 + c * xs * (1.0 + d * xs)
        ep = torch.exp(-hk * (1.0 - rs) / (2.0 * (1.0 + rs))) / rs
        bvn = bvn + torch.where(
            asr1 > -80.0,
            a_half * w[g] * torch.exp(torch.clamp(asr1, -80.0, 0.0)) *
            (ep - sp), zero)
    bvn = -bvn / _TWO_PI
    pos = bvn + ndtr(-torch.maximum(h, k))
    neg = -bvn + torch.where(k > h, ndtr(k) - ndtr(h), zero)
    return torch.where(sgn > 0, pos, neg)


def genz_branch(abs_rho: float) -> int:
    """Genz's rule for a host |ρ|: 0, 1, 2 for the 6-, 12- and 20-node
    quadrature (|ρ| below 0.3, 0.75, 0.925), 3 for the high-|ρ| series."""
    return (abs_rho >= 0.3) + (abs_rho >= 0.75) + (abs_rho >= 0.925)


def bvn_upper_grid_select(h, k, rho, phi_prod):
    """The two-branch form of :func:`bvn_upper_grid` (JAX
    ``bvn_upper_grid_select``): the 20-node quadrature where |ρ| ≤ 0.925
    and the high-|ρ| series elsewhere, chosen elementwise, so a ρ per
    particle needs no host read.  Both branches are finite over the
    clamped ρ range, so the unselected one never poisons the select."""
    low = _upper_lowcorr(h, k, rho, 20, phi_prod)
    high = _upper_highcorr(h, k, rho)
    return torch.where(rho.abs() <= _SELECT_RHO, low, high)


def bvn_upper_grid(h, k, rho, phi_prod, branch=None):
    """Upper-orthant probabilities on a grid (``rho`` a sanitized 0-d
    tensor, or one ρ per particle with ``branch=SELECT``).  The node count
    follows Genz's thresholds on |ρ|: ``branch`` (from :func:`genz_branch`)
    when the caller knows |ρ| on the host, else read from ρ here (a host
    read, which waits for a ρ on the card); :data:`SELECT` takes
    :func:`bvn_upper_grid_select`."""
    if branch == SELECT:
        return bvn_upper_grid_select(h, k, rho, phi_prod)
    if branch is None:
        branch = genz_branch(abs(float(rho.detach())))
    if branch == 3:
        return _upper_highcorr(h, k, rho)
    return _upper_lowcorr(h, k, rho, (6, 12, 20)[branch], phi_prod)


def _lead(v, nd):
    """A parameter with one value per particle, ``(N,)``, shaped to
    broadcast against a tensor with ``nd`` more trailing dimensions; a 0-d
    parameter as it is."""
    return v.reshape(v.shape + (1,) * nd) if v.ndim else v


def _corner_edges(mu, sig_x, sig_y, cell, K):
    """Standardized corner coordinates ``(xe, ye)``, each ``(..., 2K+2)``:
    x ascends with the column, y descends with the row."""
    n = 2 * K + 1
    ar = torch.arange(n + 1, dtype=mu.dtype, device=mu.device)
    nd = mu.ndim - 1
    xe = ((ar - K - 0.5) * cell - mu[..., 0:1]) / _lead(sig_x, nd)
    ye = ((K + 0.5 - ar) * cell - mu[..., 1:2]) / _lead(sig_y, nd)
    return xe, ye


def corner_rect(mu, sig_x, sig_y, rho, cell, K, branch=None):
    """Unclamped four-corner differences ``(..., 2K+1, 2K+1)`` of the
    upper-orthant lattice on sanitized parameters: the cell masses before
    the clamp at 0 (whose mask the backward needs).  ``branch``: see
    :func:`bvn_upper_grid`."""
    xe, ye = _corner_edges(mu, sig_x, sig_y, cell, K)
    h = xe[..., None, :]                                      # [row, col]
    k = ye[..., :, None]
    ndtr = torch.special.ndtr
    phi_prod = ndtr(-xe)[..., None, :] * ndtr(-ye)[..., :, None]
    U = bvn_upper_grid(h, k, _lead(rho, mu.ndim), phi_prod,
                       branch)                         # [y_edge, x_edge]
    # cell (row r, col c): x in [xe[c], xe[c+1]], y in [ye[r+1], ye[r]]
    return ((U[..., 1:, :-1] - U[..., 1:, 1:]) -
            (U[..., :-1, :-1] - U[..., :-1, 1:]))


def cell_masses_vjp(ctb, mu, sig_x, sig_y, rho, cell, K):
    """Reverse-mode rule of the cell masses, from the closed-form BVN CDF
    derivatives (the transpose of ``_cell_masses_tangent``,
    ``parasitoids_tpu/ops/bvn.py:224-266``).  With L(h, k; ρ) =
    P(X > h, Y > k):

        ∂L/∂h = −φ(h) Φ(−(k − ρh)/√(1−ρ²))
        ∂L/∂k = −φ(k) Φ(−(h − ρk)/√(1−ρ²))
        ∂L/∂ρ = φ₂(h, k; ρ)

    Args:
        ctb: ``(..., n, n)`` cotangent on the cell masses, already zero
            where the primal was clamped.
        mu, sig_x, sig_y, rho, cell: the sanitized primal inputs.

    Returns:
        ``(dmu (..., 2), dsig_x, dsig_y, drho, dcell)``; the four scalars
        are summed over the leading dimensions, or over all but the
        particle axis where σx, σy and ρ have one (then each is ``(N,)``;
        ``dcell`` too).
    """
    n = 2 * K + 1
    dtype, device = mu.dtype, mu.device
    per = sig_x.ndim > 0
    xe, ye = _corner_edges(mu, sig_x, sig_y, cell, K)

    def total(t):
        return t.reshape(t.shape[0], -1).sum(1) if per else t.sum()
    # adjoint of the four-corner difference, [y_edge, x_edge]:
    # ctU[i, j] = ctb[i-1, j] - ctb[i-1, j-1] - ctb[i, j] + ctb[i, j-1]
    t1 = F.pad(ctb, (0, 1, 1, 0))
    t2 = F.pad(ctb, (1, 0, 1, 0))
    t3 = F.pad(ctb, (0, 1, 0, 1))
    t4 = F.pad(ctb, (1, 0, 0, 1))
    ctU = ((t1 - t2) - t3) + t4
    rho_l = _lead(rho, mu.ndim)
    s2 = torch.clamp(1.0 - rho_l * rho_l, min=1e-12)
    s = torch.sqrt(s2)
    H = xe[..., None, :]
    Kg = ye[..., :, None]
    ndtr = torch.special.ndtr
    pdf_x = torch.exp(-0.5 * xe * xe) / _SQRT_2PI            # φ(h)
    pdf_y = torch.exp(-0.5 * ye * ye) / _SQRT_2PI            # φ(k)
    Lh = -pdf_x[..., None, :] * ndtr(-(Kg - rho_l * H) / s)  # ∂L/∂h
    Lk = -pdf_y[..., :, None] * ndtr(-(H - rho_l * Kg) / s)  # ∂L/∂k
    # the exponent is <= 0 (a positive-definite form): exp only underflows
    Q = (H * H - 2.0 * rho_l * H * Kg + Kg * Kg) / s2
    Lrho = torch.exp(-0.5 * Q) / (_TWO_PI * s)
    dxe = (ctU * Lh).sum(dim=-2)                              # (..., n+1)
    dye = (ctU * Lk).sum(dim=-1)                              # (..., n+1)
    ar = torch.arange(n + 1, dtype=dtype, device=device)
    jcol = ar - K - 0.5                                       # x multipliers
    irow = K + 0.5 - ar                                       # y multipliers
    nd = mu.ndim - 2
    dmu = torch.stack([-dxe.sum(dim=-1) / _lead(sig_x, nd),
                       -dye.sum(dim=-1) / _lead(sig_y, nd)], dim=-1)
    dsig_x = -total(dxe * xe) / sig_x
    dsig_y = -total(dye * ye) / sig_y
    drho = total(ctU * Lrho)
    dcell = total(dxe * jcol) / sig_x + total(dye * irow) / sig_y
    return dmu, dsig_x, dsig_y, drho, dcell


class _CellMasses(torch.autograd.Function):
    """Corner-CDF cell masses on sanitized inputs, with the closed-form
    backward (the JAX op's ``custom_jvp``): the quadrature evaluates only
    the value, and the graph keeps the inputs and the clamped output, not
    the per-node lattices.  The backward is twice differentiable: under
    ``create_graph`` autograd records it against the saved inputs."""

    @staticmethod
    def forward(ctx, mu, sig_x, sig_y, rho, cell, K, branch):
        out = torch.clamp(corner_rect(mu, sig_x, sig_y, rho, cell, K,
                                      branch), min=0.0)
        ctx.K = K
        ctx.save_for_backward(mu, sig_x, sig_y, rho, cell, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        mu, sig_x, sig_y, rho, cell, out = ctx.saved_tensors
        # the primal clamps tail differencing noise at 0: no cotangent there
        ctb = torch.where(out > 0, grad, torch.zeros_like(grad))
        dmu, dsx, dsy, drho, dcell = cell_masses_vjp(ctb, mu, sig_x, sig_y,
                                                     rho, cell, ctx.K)
        if dcell.ndim > cell.ndim:          # one cell side for every particle
            dcell = dcell.sum()
        return dmu, dsx, dsy, drho, dcell, None, None


def bvn_cell_masses(mu, sig_x, sig_y, rho, cell, K, branch=None):
    """Integrate N(mu, S) over every cell of a (2K+1)×(2K+1) window.

    Args:
        mu: (..., 2) tensor of means (x, y) in meters, relative to the
            center cell's center; its dtype and device set the output's.
        sig_x, sig_y, rho, cell: Python numbers or 0-d tensors.
        K: window half-width in cells.  The node count follows |ρ|.
        branch: ``genz_branch(|ρ|)`` when the caller has read ρ; else it
            is taken from a Python ρ, or read from a tensor ρ.

    Returns:
        (..., 2K+1, 2K+1) cell probabilities, row 0 at +y, column 0 at −x,
        the center cell at [K, K].  Differentiable in every tensor input
        through the closed-form backward; the clamps of σ and ρ below pass
        no gradient outside their active range, as in the JAX op.
    """
    dtype, device = mu.dtype, mu.device
    if branch is None and not torch.is_tensor(rho):
        branch = genz_branch(abs(rho))
    sig_x = torch.clamp(scalar(sig_x, dtype, device), min=1e-8)
    sig_y = torch.clamp(scalar(sig_y, dtype, device), min=1e-8)
    rho = torch.clamp(scalar(rho, dtype, device), -1 + 1e-6, 1 - 1e-6)
    cell = scalar(cell, dtype, device)
    return _CellMasses.apply(mu, sig_x, sig_y, rho, cell, K, branch)


def bvn_cell_masses_batched(mu, sig_x, sig_y, rho, cell, K):
    """The ensemble-batched variant of :func:`bvn_cell_masses` (JAX
    ``bvn_cell_masses_batched``): the same contract and closed-form
    backward, with the two-branch select node rule
    (:func:`bvn_upper_grid_select`: 20 nodes where |ρ| ≤ 0.925, the series
    elsewhere), which reads no ρ on the host.

    ``sig_x``, ``sig_y`` and ``rho`` are numbers, 0-d tensors, or ``(N,)``
    tensors with one value per particle; then ``mu`` is ``(N, ..., 2)``
    and the result ``(N, ..., 2K+1, 2K+1)``.
    """
    dtype, device = mu.dtype, mu.device
    sig_x = torch.clamp(scalar(sig_x, dtype, device), min=1e-8)
    sig_y = torch.clamp(scalar(sig_y, dtype, device), min=1e-8)
    rho = torch.clamp(scalar(rho, dtype, device), -1 + 1e-6, 1 - 1e-6)
    cell = scalar(cell, dtype, device)
    return _CellMasses.apply(mu, sig_x, sig_y, rho, cell, K, SELECT)


def bvn_cell_masses_quad(mu, sig_x, sig_y, rho, cell, K, G=16):
    """Conditional-decomposition scheme (JAX ``bvn_cell_masses_quad``, the
    form the Pallas kernel's design started from, kept as an independent
    cross-check):

        mass(i, j) = ∫_{x in col_j} φ_{μx,σx}(x) ·
                     [Φ((y_hi(i) − m(x))/s) − Φ((y_lo(i) − m(x))/s)] dx

    with ``m(x) = μy + ρ σy (x − μx)/σx`` and ``s = σy sqrt(1 − ρ²)``, the
    outer integral in probability space ``u = Φ((x − μx)/σx)`` under
    G-node Gauss–Legendre.  ``mu`` is ``(2,)``; the parameters are numbers
    or 0-d tensors.  Returns the ``(2K+1, 2K+1)`` block, not clamped."""
    dtype, device = mu.dtype, mu.device
    ndtr, ndtri = torch.special.ndtr, torch.special.ndtri
    sig_x = torch.clamp(scalar(sig_x, dtype, device), min=1e-8)
    sig_y = torch.clamp(scalar(sig_y, dtype, device), min=1e-8)
    rho = torch.clamp(scalar(rho, dtype, device), -1 + 1e-7, 1 - 1e-7)
    cell = scalar(cell, dtype, device)
    n = 2 * K + 1
    t, w = gl_nodes(G, dtype, device)
    ar = torch.arange(n + 1, dtype=dtype, device=device)
    # x edges ascending with the column: col j spans [(j-K-.5)c, (j-K+.5)c]
    xe = (ar - K - 0.5) * cell
    u_edges = ndtr((xe - mu[0]) / sig_x)
    lo, hi = u_edges[:-1], u_edges[1:]
    half = 0.5 * (hi - lo)                                    # (n,)
    mid = 0.5 * (hi + lo)
    # saturated nodes (u at 0 or 1) get a harmless midpoint before ndtri
    # and a large constant after, as in the JAX op
    tiny = torch.finfo(dtype).tiny
    uu0 = mid[:, None] + half[:, None] * t[None, :]           # (n, G)
    in_range = (uu0 > tiny) & (uu0 < 1.0 - torch.finfo(dtype).eps)
    z_safe = ndtri(torch.where(in_range, uu0, torch.full_like(uu0, 0.5)))
    z = torch.where(in_range, z_safe,
                    torch.where(uu0 <= tiny, torch.full_like(uu0, -38.0),
                                torch.full_like(uu0, 38.0)))
    m_cond = mu[1] + rho * sig_y * z                          # (n, G)
    s_cond = torch.clamp(sig_y * torch.sqrt(1.0 - rho * rho), min=1e-12)
    # y edges descending with the row: row i spans [(K-i-.5)c, (K-i+.5)c]
    ye = (K + 0.5 - ar) * cell
    cdf = ndtr((ye[None, None, :] - m_cond[:, :, None]) / s_cond)
    d_phi = cdf[..., :-1] - cdf[..., 1:]                      # (n, G, n)
    return torch.einsum('j,jgi,g->ij', half, d_phi, w)
