"""One day's accumulate: every flight minute's BVN block, scaled by its
take-off probability, summed into the ``(buf_len, buf_len)`` padded day
buffer, plus the clipped-block truncation loss
``Σ_t clip_t · h_t · (1 − Σ block_t)`` — and its backward.

Two implementations of one contract, forward and backward:

* :func:`accumulate_day` — the wrapper, a ``torch.autograd.Function`` (the
  JAX ``custom_vjp`` ``pallas_accumulate_day``).  On CUDA tensors its
  forward launches the hand-written Hopper kernel ``csrc/day_kernel.cu``,
  which replaces ``parasitoids_tpu/ops/pallas_kernel.py::_day_kernel`` (K1
  low-|ρ| and K2 high-|ρ|; the branch and Genz's 6/12/20 node count are
  read from ρ on the device), and its backward launches the kernel's
  backward in the same source, which replaces ``_day_bwd_kernel`` (K3 and
  K4).  The forward is bound by exp (MUFU) throughput, (2K+2)²·G exps per
  minute; it builds blocks into a ``(T, n, n)`` scratch, gathers them per
  (buffer tile, chunk of ``_CHUNK`` minutes) into partial tiles and sums a
  tile's partials in chunk order, so its output is bitwise reproducible.
  The backward rebuilds each minute's block a few lattice rows at a time
  and adds every corner's closed-form derivative terms (two Φ and one exp
  per corner) into per-thread sums as it goes, so it costs the forward's
  exps plus those, keeps a ring of rows in shared memory whatever K is,
  and runs wherever the forward runs; its per-minute partial sums are
  reduced in minute order, so it is bitwise reproducible too.  On CPU
  tensors the wrapper calls the plain versions.  It never falls back from
  CUDA to a plain version.
* :func:`accumulate_day_plain` and :func:`accumulate_day_bwd_plain` — the
  plain PyTorch twins: chunked block builds with
  :func:`..ops.bvn.corner_rect` (6/12/20 nodes by |ρ|), an ``index_add_``
  into the buffer, and the closed-form backward of
  :func:`..ops.bvn.cell_masses_vjp`.  The forward is the twin of
  ``parasitoids_tpu/ops/daily_kernel.py::xla_accumulate_day``; autograd
  through it (the ``pallas=False`` path) is that XLA path's gradient.

The particle-batched forward, :func:`accumulate_day_batched`, takes N
parameter sets' minutes at once (the ensemble's select node rule: 20
nodes where |ρ| ≤ 0.925, the series elsewhere, read per particle on the
device): the same three passes with the particle on the grid, one launch
a day for the whole population; :func:`accumulate_day_batched_plain` is
its plain twin.  It takes no gradient (SMC's moves take none).

Every scatter start ``idx`` must lie in ``[0, buf_len − (2K+1)]`` (true
by construction in ``day_scatter_inputs``), so no block is ever clamped.
"""

from __future__ import annotations

import ctypes
import threading
from itertools import accumulate

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..device import scalar
from .bvn import (SELECT, bvn_cell_masses, cell_masses_vjp, corner_rect,
                  genz_branch, gl_nodes)

__all__ = ['LAUNCHES', 'LAUNCHES_BATCHED', 'LAUNCHES_BWD', 'LAYOUT',
           'accumulate_day', 'accumulate_day_batched',
           'accumulate_day_batched_plain', 'accumulate_day_bwd',
           'accumulate_day_bwd_plain', 'accumulate_day_plain',
           'lattice_probe', 'pack_constants', 'pass_ms', 'pass_ms_bwd']

# kernel launches so far (one per day accumulated on the card, one per
# day's backward, and one per day of a particle-batched population); a run
# reads them to show that its main path went through the kernels
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_BATCHED = 0
# the autograd engine runs each card's backward on a thread of its own, so
# the counts are added under a lock
_COUNT_LOCK = threading.Lock()


def _count(name, n=1):
    with _COUNT_LOCK:
        globals()[name] += n

_G_NODES = 20
_CHUNK = 64                          # minutes per gather chunk (C)
_TILE = 32                           # csrc/day_kernel.cu kTile
_MAX_CHUNK = 256                     # kGatherThreads: one minute a thread
_MAX_CHUNKS = 1024                   # kMaxChunks: a tile's chunks
# csrc/day_kernel.cu's kConst* layout of the packed constants: scalar
# slots, then rows of the 6-, 12- and 20-node low-|ρ| rules back to back
# and rows of the 20-node high-|ρ| series
_N_SCALARS = 18                      # kScalars
_LO_NODES, _HI_NODES = 6 + 12 + 20, 20
_ROWS = (('kLoSn', _LO_NODES), ('kLoW', _LO_NODES), ('kLoDen', _LO_NODES),
         ('kLoInvDen', _LO_NODES), ('kHiXs', _HI_NODES),
         ('kHiRs', _HI_NODES), ('kHiW', _HI_NODES), ('kHiInvXs', _HI_NODES),
         ('kHiInvEp', _HI_NODES), ('kHiInvRs', _HI_NODES))
LAYOUT = dict(kA=5, kASq=6, kCtLoss=14, kInvA=16, kInvASq=17,
              kScalars=_N_SCALARS,
              **dict(zip([name for name, _ in _ROWS] + ['kConsts'],
                         accumulate([_N_SCALARS] + [n for _, n in _ROWS]))))
_SMEM_LIMIT = 232448                 # dynamic shared memory per CTA, H100
_BWD_MAX_RING = 64                   # most rows of block_bwd's lattice ring
_BWD_CTAS = 4                        # block_bwd CTAs an SM holds (registers)
_RHO_MAX = 1 - 1e-6                  # the |ρ| clamp of the BVN op


def _block_offsets(idx, K, buf_len):
    """Flat buffer index of every cell of every minute's block, (T, n²)."""
    n = 2 * K + 1
    ar = torch.arange(n, device=idx.device)
    offs = (ar[:, None] * buf_len + ar[None, :]).reshape(-1)
    start = idx[:, 0].long() * buf_len + idx[:, 1].long()
    return start[:, None] + offs[None, :]


def _read_branch(rho):
    """Genz branch of a number or tensor ρ, read on the host once."""
    if torch.is_tensor(rho):
        rho = float(rho.detach())
    return genz_branch(abs(rho))


def accumulate_day_plain(h_scat, cdf_mu, idx, clipped, Dparams, cell, K,
                         buf_len, chunk=240, branch=None, ref_trunc=False):
    """Plain PyTorch accumulate (the kernel's reference and the CPU path).
    Differentiable: autograd through it uses the BVN op's closed-form
    backward.

    Args:
        h_scat: (T,) take-off probability per minute (0 for blocks wholly
            off the domain).
        cdf_mu: (T, 2) sub-cell mean offsets (m).
        idx: (T, 2) int32 scatter start (row, col) in the padded buffer.
        clipped: (T,) 1.0 where the block straddles the domain boundary.
        Dparams: (sig_x, sig_y, rho) flight diffusion: numbers, 0-d
            tensors or a (3,) tensor.
        cell: cell side (m).  K: window half-width.  buf_len: buffer side.
        chunk: minutes per block build; bounds the corner lattice's memory.
        branch: ``genz_branch(|ρ|)`` when the caller has read ρ, else ρ is
            read here once; ``ops.bvn.SELECT`` takes the select node rule.
        ref_trunc: truncate every block by ``daily_kernel.ring_truncate``
            (the reference's stopping rule) before it is scattered.

    Returns:
        (buf, loss): the (buf_len, buf_len) buffer and the scalar loss.
    """
    T = h_scat.shape[0]
    sig_x, sig_y, rho = Dparams
    if branch is None:
        branch = _read_branch(rho)
    dev, dtype = h_scat.device, h_scat.dtype
    buf = torch.zeros((buf_len, buf_len), dtype=dtype, device=dev)
    flat_idx = _block_offsets(idx, K, buf_len)
    loss = torch.zeros((), dtype=dtype, device=dev)
    C = min(chunk, T)
    for s in range(0, T, C):
        e = min(s + C, T)
        blocks = bvn_cell_masses(cdf_mu[s:e], sig_x, sig_y, rho, cell, K,
                                 branch)
        if ref_trunc:
            from .daily_kernel import ring_truncate
            blocks = ring_truncate(blocks, K)
        b_total = blocks.sum(dim=(1, 2))
        h_c = h_scat[s:e]
        buf.view(-1).index_add_(0, flat_idx[s:e].reshape(-1),
                                (blocks * h_c[:, None, None]).reshape(-1))
        loss = loss + torch.sum(clipped[s:e] * h_c * (1.0 - b_total))
    return buf, loss


def accumulate_day_batched_plain(h_scat, cdf_mu, idx, clipped, Dparams, cell,
                                 K, buf_len, chunk=240):
    """Plain twin of :func:`accumulate_day_batched`: N particles' days,
    each by :func:`accumulate_day_plain` with the select node rule.

    Args:
        h_scat (N, T), cdf_mu (N, T, 2), idx (N, T, 2) int32,
        clipped (N, T): each particle's minutes.
        Dparams: (N, 3) tensor, each particle's (σx, σy, ρ).
        cell, K, buf_len, chunk: as :func:`accumulate_day_plain`.

    Returns:
        (buf (N, buf_len, buf_len), loss (N,)).
    """
    outs = [accumulate_day_plain(h_scat[i], cdf_mu[i], idx[i], clipped[i],
                                 tuple(Dparams[i]), cell, K, buf_len, chunk,
                                 branch=SELECT)
            for i in range(h_scat.shape[0])]
    return (torch.stack([b for b, _ in outs]),
            torch.stack([loss for _, loss in outs]))


def _sanitize(Dparams, dtype, device):
    """Raw (3,) diffusion tensor and the BVN op's clamped σx, σy, ρ; an
    ``(N, 3)`` tensor gives a ``(3, N)`` raw tensor and ``(N,)`` each."""
    if torch.is_tensor(Dparams) and Dparams.ndim == 2:
        raw = Dparams.to(device=device, dtype=dtype).T
    else:
        raw = torch.stack([scalar(v, dtype, device) for v in Dparams])
    return (raw, torch.clamp(raw[0], min=1e-8),
            torch.clamp(raw[1], min=1e-8),
            torch.clamp(raw[2], -_RHO_MAX, _RHO_MAX))


def accumulate_day_bwd_plain(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped,
                             Dparams, cell, K, buf_len, chunk=240):
    """Plain backward of :func:`accumulate_day_plain` (the kernel's
    reference and the CPU backward): per minute, gather the cotangent
    window, rebuild the block and contract against the closed-form BVN
    derivative lattices (``parasitoids_tpu/ops/pallas_kernel.py``
    ``_day_bwd_kernel``, with the node count of the forward by |ρ|).

    Args:
        ct_buf: (buf_len, buf_len) cotangent on the buffer.
        ct_loss: cotangent on the loss (number or 0-d tensor).
        The rest: the forward's inputs.

    Returns:
        ``(dh (T,), dmu (T, 2), dclip (T,), dDparams (3,), dcell ())``;
        the σ and ρ components pass through the clamps' VJPs (zero where
        the raw value lies outside the clamp's active range).
    """
    T = h_scat.shape[0]
    n = 2 * K + 1
    dev, dtype = h_scat.device, h_scat.dtype
    branch = _read_branch(Dparams[2])
    raw, sig_x, sig_y, rho = _sanitize(Dparams, dtype, dev)
    cell = scalar(cell, dtype, dev)
    ct_loss = scalar(ct_loss, dtype, dev)
    ct_flat = ct_buf.reshape(-1)
    flat_idx = _block_offsets(idx, K, buf_len)
    dh = torch.empty(T, dtype=dtype, device=dev)
    dclip = torch.empty(T, dtype=dtype, device=dev)
    dmu = torch.empty((T, 2), dtype=dtype, device=dev)
    dscal = torch.zeros(4, dtype=dtype, device=dev)
    C = min(chunk, T)
    for s in range(0, T, C):
        e = min(s + C, T)
        rect = corner_rect(cdf_mu[s:e], sig_x, sig_y, rho, cell, K, branch)
        block = torch.clamp(rect, min=0.0)
        bsum = block.sum(dim=(1, 2))
        ct_win = ct_flat[flat_idx[s:e]].view(e - s, n, n)
        h_c, cl_c = h_scat[s:e], clipped[s:e]
        dh[s:e] = ((ct_win * block).sum(dim=(1, 2)) +
                   ct_loss * cl_c * (1.0 - bsum))
        dclip[s:e] = ct_loss * h_c * (1.0 - bsum)
        # cotangent on the block: the buffer's h·block plus the loss's
        # −ct_loss·clip·h·bsum, masked by the clamp at 0
        ctb = torch.where(rect > 0,
                          h_c[:, None, None] * ct_win -
                          (ct_loss * cl_c * h_c)[:, None, None],
                          torch.zeros_like(rect))
        dmu_c, dsx, dsy, drho, dcell = cell_masses_vjp(
            ctb, cdf_mu[s:e], sig_x, sig_y, rho, cell, K)
        dmu[s:e] = dmu_c
        dscal = dscal + torch.stack([dsx, dsy, drho, dcell])
    zero = torch.zeros((), dtype=dtype, device=dev)
    dD = torch.stack([torch.where(raw[0] > 1e-8, dscal[0], zero),
                      torch.where(raw[1] > 1e-8, dscal[1], zero),
                      torch.where(raw[2].abs() < _RHO_MAX, dscal[2], zero)])
    return dh, dmu, dclip, dD, dscal[3]


def _pack_constants(Dparams, cell, device, ct_loss=None, select=False):
    """Kernel constants (csrc/day_kernel.cu kConst layout, :data:`LAYOUT`),
    computed on the device from the diffusion parameters with the plain
    twin's expressions (ops/bvn.py): the scalars, the ρ-only rows of the 6-,
    12- and 20-node low-|ρ| rules, and those of the high-|ρ| series, each
    divisor of the lattice beside its reciprocal (1/(1 − sn²), 1/a, 1/a²,
    1/xs, 1/(2(1 + rs)), 1/rs, each the f32 IEEE quotient of 1 by the
    divisor's f32 value: the kernel's division needs exactly that).  Every
    branch is packed, so no host read of ρ is needed.  The backward also
    reads the raw parameters (for the clamps' VJPs), 1/s and 1/s² with
    s² = max(1 − ρ², 1e-12), and the loss cotangent ``ct_loss``.
    ``select``: the kernel takes the select node rule (kSelect = 1).  A
    ``(N, 3)`` tensor of diffusion parameters gives ``(N, kConsts)``, one
    row per particle."""
    f32 = torch.float32
    raw, sig_x, sig_y, rho = _sanitize(Dparams, f32, device)
    asr = torch.asin(rho)[..., None]             # nodes on the last axis
    sn, w, den = [], [], []
    for G in (6, 12, 20):
        x, wg = gl_nodes(G, f32, device)
        s = torch.sin(asr * 0.5 * (1.0 + x))
        sn.append(s)
        w.append(wg.expand(s.shape))
        den.append(1.0 - s * s)
    a_sq = torch.clamp((1.0 - rho) * (1.0 + rho), min=1e-30)
    a = torch.sqrt(a_sq)
    a_half = a / 2.0
    x, wg = gl_nodes(_G_NODES, f32, device)
    xs = (a_half[..., None] * (1.0 + x)) ** 2
    rs = torch.sqrt(1.0 - xs)
    s2 = torch.clamp(1.0 - rho * rho, min=1e-12)
    ctl = torch.zeros_like(rho) if ct_loss is None else \
        scalar(ct_loss, f32, device).expand(rho.shape)
    inv = torch.reciprocal
    scal = torch.stack([sig_x, sig_y, scalar(cell, f32, device).expand(
        rho.shape), rho, torch.sign(rho), a, a_sq, a_half, asr[..., 0],
        raw[0], raw[1], raw[2], 1.0 / torch.sqrt(s2), 1.0 / s2, ctl,
        torch.full_like(ctl, float(select)), inv(a), inv(a_sq)], dim=-1)
    assert scal.shape[-1] == _N_SCALARS
    out = torch.cat([scal, *sn, *w, *den, *map(inv, den), xs, rs,
                     wg.expand(xs.shape), inv(xs), inv(2.0 * (1.0 + rs)),
                     inv(rs)], dim=-1).contiguous()
    assert out.shape[-1] == LAYOUT['kConsts']
    return out


def pack_constants(Dparams, cell, device, select=False):
    """The kernels' day-invariant constants (:func:`_pack_constants` with
    no loss cotangent) for a caller to pack once per evaluation and pass
    to every day's :func:`accumulate_day` (or
    :func:`accumulate_day_batched`) as ``consts=``; the backward writes
    its loss cotangent into a copy of the row (:func:`_with_ct_loss`).
    Packed without autograd: the kernels' backward gives dσ, dρ and
    dcell itself."""
    with torch.no_grad():
        return _pack_constants(Dparams, cell, device, select=select)


def _with_ct_loss(consts, ct_loss):
    """A copy of a forward row of :func:`pack_constants` with the loss
    cotangent in its ``kCtLoss`` slot: one copy kernel, the bits of
    ``_pack_constants(..., ct_loss)``."""
    at = LAYOUT['kCtLoss']
    ctl = scalar(ct_loss, torch.float32, consts.device).reshape(1)
    return torch.cat([consts[:at], ctl, consts[at + 1:]])


def _cuda_call(lib, fn, smem, K, dev, *args):
    """Launch ``fn`` of the kernel library, whose CTAs need ``smem`` bytes
    of shared memory at half-width ``K``, on ``dev``'s current stream.
    The C entry point launches in the current CUDA context, so the call
    runs under ``torch.cuda.device(dev)`` (the autograd engine runs a
    backward on a thread of its own)."""
    if smem > _SMEM_LIMIT:
        raise ValueError('K = {} needs {} B of shared memory per CTA; a CTA '
                         'has {} B'.format(K, smem, _SMEM_LIMIT))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError('{} failed: cudaError {}'.format(fn, err))


def _forward_args(h_scat, cdf_mu, idx, Dparams, cell, K, buf_len, chunk,
                  select=False, consts=None):
    """Packed constants (``consts`` when the caller packed them once, see
    :func:`pack_constants`), scratch and outputs of one forward launch,
    and the C arguments up to the stream (see
    ``parasitoids_day_accumulate``).  All come from the caching
    allocator, so a day loop reuses the same memory every day; the
    partials are sized from the shapes alone (tiles ×
    ⌈T / chunk⌉ × 32², about 90 MB at the headline shapes), of which the
    kernel writes and reads only those of the tiles in each chunk's box
    that its blocks meet.  Inputs with a leading particle axis, ``(N, T)``
    and so on, give every buffer that axis (N = 1 otherwise)."""
    dev = h_scat.device
    T = h_scat.shape[-1]
    lead = tuple(h_scat.shape[:-1])
    N = h_scat.shape[0] if lead else 1
    n = 2 * K + 1
    nchunks = -(-T // chunk)
    tiles = (-(-buf_len // _TILE)) ** 2
    if not 1 <= chunk <= _MAX_CHUNK or nchunks > _MAX_CHUNKS:
        raise ValueError('chunk {} out of range for T = {}'.format(chunk, T))
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(
        consts=(_pack_constants(Dparams, cell, dev, select=select)
                if consts is None else consts),
        scratch=torch.empty(lead + (T, n, n), **f32),
        bsum=torch.empty(lead + (T,), **f32),
        partial=torch.empty(lead + (tiles, nchunks, _TILE, _TILE), **f32),
        flags=torch.empty(lead + (tiles, nchunks), dtype=torch.int32,
                          device=dev),
        boxes=torch.empty(lead + (nchunks, 4), dtype=torch.int32, device=dev),
        buf=torch.empty(lead + (buf_len, buf_len), **f32))
    args = (out['consts'].data_ptr(), h_scat.data_ptr(), cdf_mu.data_ptr(),
            idx.data_ptr(), N, T, K, buf_len, chunk,
            *(out[k].data_ptr() for k in ('scratch', 'bsum', 'partial',
                                          'flags', 'boxes', 'buf')))
    return out, args


def _launch(h_scat, cdf_mu, idx, clipped, Dparams, cell, K, buf_len,
            consts=None):
    from ._build import load
    lib = load('day_kernel')
    out, args = _forward_args(h_scat, cdf_mu, idx, Dparams, cell, K, buf_len,
                              _CHUNK, consts=consts)
    _cuda_call(lib, 'parasitoids_day_accumulate',
               lib.parasitoids_day_smem_bytes(K), K, h_scat.device, *args)
    _count('LAUNCHES')
    loss = torch.sum(clipped * h_scat * (1.0 - out['bsum']))
    return out['buf'], loss


def accumulate_day_batched(h_scat, cdf_mu, idx, clipped, Dparams, cell, K,
                           buf_len, consts=None):
    """N particles' day accumulates at once (the contract of
    :func:`accumulate_day_batched_plain`) with the select node rule, read
    per particle on the device: on CUDA tensors one launch of the CUDA
    kernel for the whole population (the particle on its grid, no host
    read), on CPU tensors the plain twin.  f32 only; no gradient (an input
    that requires one raises).  ``consts``: the ``(N, kConsts)`` rows of
    ``pack_constants(Dparams, cell, device, select=True)`` when the caller
    packed them once, else they are packed here."""
    if h_scat.ndim != 2:
        raise ValueError('h_scat must be (N, T), got {}'.format(
            tuple(h_scat.shape)))
    N = h_scat.shape[0]
    _check(h_scat, cdf_mu, idx, clipped, K, buf_len)
    if not (torch.is_tensor(Dparams) and Dparams.shape == (N, 3)):
        raise ValueError('Dparams must be an (N, 3) tensor, N = {}'.format(N))
    if any(torch.is_tensor(t) and t.requires_grad
           for t in (h_scat, cdf_mu, clipped, Dparams, cell)):
        raise ValueError('accumulate_day_batched takes no gradient: give it '
                         'inputs that do not require one')
    if h_scat.device.type == 'cpu':
        return accumulate_day_batched_plain(h_scat, cdf_mu, idx, clipped,
                                            Dparams, cell, K, buf_len)
    from ._build import load
    lib = load('day_kernel')
    out, args = _forward_args(h_scat, cdf_mu, idx, Dparams, cell, K, buf_len,
                              _CHUNK, select=True, consts=consts)
    _cuda_call(lib, 'parasitoids_day_accumulate',
               lib.parasitoids_day_smem_bytes(K), K, h_scat.device, *args)
    _count('LAUNCHES_BATCHED')
    loss = torch.sum(clipped * h_scat * (1.0 - out['bsum']), dim=-1)
    return out['buf'], loss


def pass_ms(h_scat, cdf_mu, idx, clipped, Dparams, cell, K, buf_len,
            reps=20, chunk=_CHUNK):
    """Device milliseconds of the forward kernel's three passes,
    ``(reps, 3)`` numpy (block_build, gather, reduce), from CUDA events
    recorded around the kernels alone, every rep queued before the first
    is waited on: the wrapper's checks and packing are outside them.  Takes
    :func:`accumulate_day`'s inputs, or :func:`accumulate_day_batched`'s
    (then the select node rule and ``(N, 3)`` ``Dparams``), on the card;
    each rep counts as one launch of its kind."""
    from ._build import load
    _check(h_scat, cdf_mu, idx, clipped, K, buf_len)
    batched = h_scat.ndim == 2
    if h_scat.device.type != 'cuda':
        raise ValueError('pass_ms times the CUDA kernel: give it CUDA tensors')
    if reps < 1:
        raise ValueError('reps must be at least 1, got {}'.format(reps))
    lib = load('day_kernel')
    bufs, args = _forward_args(h_scat, cdf_mu, idx, Dparams, cell, K,
                               buf_len, chunk, select=batched)
    ms = (ctypes.c_float * (3 * reps))()
    _cuda_call(lib, 'parasitoids_day_accumulate_timed',
               lib.parasitoids_day_smem_bytes(K), K, h_scat.device, *args,
               reps, ctypes.addressof(ms))
    if batched:
        _count('LAUNCHES_BATCHED', reps)
    else:
        _count('LAUNCHES', reps)
    del bufs                 # the call waited for the card: safe to free
    return np.frombuffer(ms, dtype=np.float32).reshape(reps, 3).copy()


def lattice_probe(Dparams, mu, cell, K, select=False):
    """The kernel's check that its lattice division changes no bit (a test
    of the card, on no path of the port): for each of P cases, one
    minute's corner lattice at half-width ``K`` (at most 118) for the
    diffusion ``Dparams[i]`` and mean offset ``mu[i]`` (m), every corner
    as ``block_build`` and as ``block_bwd`` compute it against the same
    corner with IEEE division at every node.  ``Dparams`` is ``(P, 3)``,
    ``mu`` ``(P, 2)``, f32 on the card; ``select`` takes the batched
    launch's node rule.  Returns ``dict(differ=, corners=, ieee=,
    bwd_vs_fwd=)``: the words that differ from their IEEE twins (both
    modes), the corners compared, the corners whose run took the IEEE
    division (out of the exact division's range), and the corners where
    the backward's value differs from the forward's."""
    from ._build import load
    dev = mu.device
    if dev.type != 'cuda':
        raise ValueError('lattice_probe checks the CUDA kernel: give it '
                         'CUDA tensors')
    if not (torch.is_tensor(Dparams) and Dparams.ndim == 2 and
            Dparams.shape[1] == 3 and mu.shape == (Dparams.shape[0], 2)):
        raise ValueError('Dparams must be (P, 3) and mu (P, 2)')
    lib = load('day_kernel')
    consts = _pack_constants(Dparams, cell, dev, select=select)
    mu = mu.to(torch.float32).contiguous()
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    _cuda_call(lib, 'parasitoids_lattice_probe', 0, K, dev,
               consts.data_ptr(), mu.data_ptr(), mu.shape[0], K,
               counts.data_ptr())
    return dict(zip(('differ', 'corners', 'ieee', 'bwd_vs_fwd'),
                    (int(v) for v in counts.cpu())))


def _backward_args(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped, Dparams,
                   cell, K, buf_len, ring, consts=None):
    """Packed constants (``consts``, the forward's row of
    :func:`pack_constants`, with the loss cotangent written into a copy),
    scratch and outputs of one backward launch, and the C arguments up to
    the stream (see ``parasitoids_day_accumulate_bwd``)."""
    dev = h_scat.device
    T = h_scat.shape[0]
    if ct_buf.shape != (buf_len, buf_len) or ct_buf.dtype != torch.float32 \
            or ct_buf.device != dev or not ct_buf.is_contiguous():
        raise ValueError('ct_buf must be a contiguous f32 ({0}, {0}) tensor '
                         'on {1}'.format(buf_len, dev))
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(
        consts=(_pack_constants(Dparams, cell, dev, ct_loss)
                if consts is None else _with_ct_loss(consts, ct_loss)),
        dh=torch.empty(T, **f32), dmu=torch.empty((T, 2), **f32),
        dclip=torch.empty(T, **f32),
        part=torch.empty((T, 4), **f32),  # per-minute dσx, dσy, dρ, dcell
        dD=torch.empty(3, **f32), dcell=torch.empty((), **f32))
    args = (out['consts'].data_ptr(), h_scat.data_ptr(), cdf_mu.data_ptr(),
            idx.data_ptr(), clipped.data_ptr(), ct_buf.data_ptr(), T, K,
            buf_len, ring,
            *(out[k].data_ptr() for k in ('dh', 'dmu', 'dclip', 'part', 'dD',
                                          'dcell')))
    return out, args


def _bwd_ring(lib, K):
    """Rows of block_bwd's lattice ring at half-width ``K``: the largest
    power of two up to ``_BWD_MAX_RING`` that leaves room for
    ``_BWD_CTAS`` CTAs in an SM's shared memory (each CTA also takes 1 KB
    of it), so that the registers and not K set the occupancy; 2 at
    least.  The ring shrinks as K grows, so no K is too wide.  Any height
    from 2 up gives the same gradient but for the order of its sums."""
    ring = _BWD_MAX_RING
    room = (_SMEM_LIMIT + 1024) // _BWD_CTAS - 1024
    while ring > 2 and lib.parasitoids_day_bwd_smem_bytes(K, ring) > room:
        ring //= 2
    return ring


def _launch_bwd(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped, Dparams,
                cell, K, buf_len, consts=None):
    from ._build import load
    lib = load('day_kernel')
    ring = _bwd_ring(lib, K)
    out, args = _backward_args(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped,
                               Dparams, cell, K, buf_len, ring, consts)
    _cuda_call(lib, 'parasitoids_day_accumulate_bwd',
               lib.parasitoids_day_bwd_smem_bytes(K, ring), K,
               h_scat.device, *args)
    _count('LAUNCHES_BWD')
    return out['dh'], out['dmu'], out['dclip'], out['dD'], out['dcell']


def pass_ms_bwd(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped, Dparams, cell,
                K, buf_len, reps=20):
    """Device milliseconds of the backward kernel's two launches,
    ``(reps, 2)`` numpy (block_bwd, bwd_reduce), from CUDA events recorded
    around the kernels alone, every rep queued before the first is waited
    on: the wrapper's checks and packing are outside them.  Takes
    :func:`accumulate_day_bwd`'s inputs, on the card, and launches what
    it launches; each rep counts as one launch."""
    from ._build import load
    _check(h_scat, cdf_mu, idx, clipped, K, buf_len)
    if reps < 1:
        raise ValueError('reps must be at least 1, got {}'.format(reps))
    if h_scat.device.type != 'cuda':
        raise ValueError('pass_ms_bwd times the CUDA kernel: give it CUDA '
                         'tensors')
    lib = load('day_kernel')
    ring = _bwd_ring(lib, K)
    out, args = _backward_args(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped,
                               Dparams, cell, K, buf_len, ring)
    ms = (ctypes.c_float * (2 * reps))()
    _cuda_call(lib, 'parasitoids_day_accumulate_bwd_timed',
               lib.parasitoids_day_bwd_smem_bytes(K, ring), K,
               h_scat.device, *args, reps, ctypes.addressof(ms))
    _count('LAUNCHES_BWD', reps)
    del out                  # the call waited for the card: safe to free
    return np.frombuffer(ms, dtype=np.float32).reshape(reps, 2).copy()


def _check(h_scat, cdf_mu, idx, clipped, K, buf_len):
    """The wrapper's checks of one day's inputs: ``(T,)``, ``(T, 2)``,
    ``(T, 2)``, ``(T,)``, or the same with one leading particle axis."""
    T = h_scat.shape[-1]
    lead = tuple(h_scat.shape[:-1])
    n = 2 * K + 1
    dev = h_scat.device
    for name, t in (('h_scat', h_scat), ('cdf_mu', cdf_mu), ('idx', idx),
                    ('clipped', clipped)):
        if t.device != dev:
            raise ValueError('{} is on {}, h_scat on {}'.format(
                name, t.device, dev))
        if not t.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError('accumulate_day runs on CPU or CUDA tensors, not '
                         '{}'.format(dev))
    if h_scat.dtype != torch.float32 or cdf_mu.dtype != torch.float32 or \
            clipped.dtype != torch.float32:
        raise TypeError('the day kernel is f32-only (f64 takes the plain '
                        'accumulate)')
    if idx.dtype != torch.int32:
        raise TypeError('idx must be int32, got {}'.format(idx.dtype))
    if len(lead) > 1 or clipped.shape != lead + (T,) or \
            cdf_mu.shape != lead + (T, 2) or idx.shape != lead + (T, 2):
        raise ValueError('shapes: h_scat {}, cdf_mu {}, idx {}, clipped {}; '
                         'want (T,), (T, 2), (T, 2), (T,), or each with a '
                         'leading particle axis'.format(
                             tuple(h_scat.shape), tuple(cdf_mu.shape),
                             tuple(idx.shape), tuple(clipped.shape)))
    if buf_len < n:
        raise ValueError('buf_len {} < block side {}'.format(buf_len, n))
    # the idx range contract, checked on the device without a host wait:
    # a violation fails the next synchronizing call
    torch._assert_async(((idx >= 0) & (idx <= buf_len - n)).all())


class _AccumulateDay(torch.autograd.Function):
    """The JAX ``custom_vjp`` ``pallas_accumulate_day``: the CUDA kernels
    (K1/K2 forward, K3/K4 backward) for CUDA tensors, the plain twins for
    CPU tensors.  Differentiable in h, μ, clip, the (3,) diffusion tensor
    and the cell side; ``idx`` is an integer input and gets no gradient.
    The graph keeps only the per-minute inputs (6 floats a minute) and the
    packed constants, which carry no gradient."""

    @staticmethod
    def forward(ctx, h_scat, cdf_mu, idx, clipped, dp, cell, consts, K,
                buf_len):
        ctx.save_for_backward(h_scat, cdf_mu, idx, clipped, dp, cell, consts)
        ctx.K, ctx.buf_len = K, buf_len
        if h_scat.device.type == 'cpu':
            return accumulate_day_plain(h_scat, cdf_mu, idx, clipped, dp,
                                        cell, K, buf_len)
        return _launch(h_scat, cdf_mu, idx, clipped, dp, cell, K, buf_len,
                       consts)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_buf, ct_loss):
        h_scat, cdf_mu, idx, clipped, dp, cell, consts = ctx.saved_tensors
        dh, dmu, dclip, dD, dcell = _backward(
            ct_buf.contiguous(), ct_loss, h_scat, cdf_mu, idx, clipped, dp,
            cell, ctx.K, ctx.buf_len, consts)
        return dh, dmu, None, dclip, dD, dcell, None, None, None


def accumulate_day_bwd(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped,
                       Dparams, cell, K, buf_len, consts=None):
    """The backward of :func:`accumulate_day` (the contract of
    :func:`accumulate_day_bwd_plain`), called directly: the inputs are
    checked as the forward checks them, then the CUDA kernel K3/K4 runs
    for CUDA tensors and the plain version for CPU tensors.  ``consts``:
    the forward's row of :func:`pack_constants`, else packed here."""
    _check(h_scat, cdf_mu, idx, clipped, K, buf_len)
    return _backward(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped, Dparams,
                     cell, K, buf_len, consts)


def _backward(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped, Dparams, cell,
              K, buf_len, consts=None):
    if h_scat.device.type == 'cpu':
        return accumulate_day_bwd_plain(ct_buf, ct_loss, h_scat, cdf_mu, idx,
                                        clipped, Dparams, cell, K, buf_len)
    return _launch_bwd(ct_buf, ct_loss, h_scat, cdf_mu, idx, clipped,
                       Dparams, cell, K, buf_len, consts)


def accumulate_day(h_scat, cdf_mu, idx, clipped, Dparams, cell, K, buf_len,
                   consts=None):
    """Accumulate one day's minutes (the contract of
    :func:`accumulate_day_plain`): the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors.  f32 only.  ``Dparams`` (numbers, 0-d
    tensors or a (3,) tensor) is stacked into one (3,) tensor and ``cell``
    made a 0-d tensor, so gradients reach σx, σy, ρ and the cell side.
    ``consts``: the row of ``pack_constants(Dparams, cell, device)`` when
    the caller packed it once for all its days; else the forward and the
    backward each pack their own.  The CPU path takes no constants."""
    _check(h_scat, cdf_mu, idx, clipped, K, buf_len)
    dev = h_scat.device
    dp = torch.stack([scalar(v, torch.float32, dev) for v in Dparams])
    return _AccumulateDay.apply(h_scat, cdf_mu, idx, clipped, dp,
                                scalar(cell, torch.float32, dev), consts, K,
                                buf_len)
