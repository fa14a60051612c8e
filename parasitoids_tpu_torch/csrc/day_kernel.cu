// Day-accumulate kernels for Hopper (sm_90a): per flight minute, the
// bivariate-normal (BVN) cell-mass block of the flight kernel, scaled by the
// minute's take-off probability and summed into the day's padded buffer
// (the forward), and the gradient of that accumulate (the backward, at the
// end of this file).
//
// The forward replaces parasitoids_tpu/ops/pallas_kernel.py::_day_kernel,
// both variants:
//   K1 (|rho| < 0.925): Drezner-Wesolowsky correlation-integral quadrature
//       (_corner_upper_low);
//   K2 (|rho| >= 0.925): Genz BVND asymptotic series plus tail quadrature
//       (_corner_upper_high).
// The branch is read from rho on the device, inside the kernel, so a caller
// never waits on the card to choose it.  Unlike the Pallas kernel, which
// fixes 20 nodes, K1 takes Genz's node count by |rho| (6 / 12 / 20 below
// 0.3 / 0.75 / 0.925), as the JAX XLA path and the plain twin do, and both
// branches follow the plain twin's operation order: far-tail cells near
// the 1e-8 sparsity threshold then agree to f32 roundoff instead of
// flipping across it (a 20-node tail differs from a 6-node one by ~10%).
//
// Design (three launches, deterministic, no atomics):
//   1. block_build: one CTA per minute.  The upper-orthant probabilities on
//      the (2K+2)^2 corner lattice live in shared memory; the CTA differences
//      them into the (2K+1)^2 block, clamps at 0, writes h_t * block into a
//      (T, n, n) scratch and the block's sum into bsum[t].  The sum is a
//      fixed-order tree, so bsum is bitwise reproducible.
//   2. gather_chunk: split-minute.  The day's minutes are cut into chunks
//      of C consecutive minutes; the grid, sized from T, K and C alone, is
//      (chunk, span^2) with span^2 the most 32x32 buffer tiles one block
//      can meet (16 at K = 44).  The CTAs of a chunk find the box of tiles
//      its blocks can meet and share its tiles out; for each, a CTA lists
//      the chunk's minutes whose block meets the tile and sums those
//      blocks, in minute order, into one partial tile, flagged as written,
//      with kBatch minutes' loads in flight at a time.
//   3. reduce_tiles: one CTA per tile sums its flagged partials in chunk
//      order and writes the tile (zeros where no minute meets it).
//   Every cell's sum has a fixed order (minutes ascending within a chunk,
//   chunks ascending), so the buffer is bitwise the same every launch.
//
// What bounds it: block_build issues (2K+2)^2 * G exps per minute (MUFU
// throughput; G = 6 at prior-typical rho, 70 M exps a day at K = 44,
// T = 1440, about 17 us on an H100; about 2 exps per node on the high
// branch).  The gather was latency-bound: the wind keeps a day's blocks
// within about a hundred of the 961 tiles, and the busiest tile meets
// ~1,000 of the 1,440 minutes.  A tile-stationary gather walks those
// minutes in one CTA, one dependent read per minute (~0.45 ms a day on
// an H100, about one SM per busy tile).  Splitting the minutes spreads
// the busiest tile over ~23 CTAs on as many SMs; sharing a chunk's box
// among span^2 CTAs keeps the grid to a few hundred CTAs, nearly all busy
// (one CTA per (tile, chunk) was 22,000 CTAs, most of which found nothing
// and still cost a launch and an idx read).  What is left is the scratch
// round trip: 46 MB written by block_build and read back, ~15 us at
// 3.35 TB/s, plus about 5 us a launch.  Register batches of kBatch
// minutes measured faster than a cp.async ring of 2 to 8 stages on an
// H100 (see PERF.md).  The
// partials are allocated densely, tiles x ceil(T / C) x 4 KB (90 MB at
// C = 64), but only those of the tiles a chunk's blocks meet are written
// and read.  A fused build-and-gather that keeps blocks on chip is later
// work.
//
// The backward replaces pallas_kernel.py::_day_bwd_kernel, K3 (|rho| <
// 0.925) and K4 (the high-|rho| rebuild), with the same node rule as the
// forward here (not the Pallas kernel's fixed 20), so its clamp mask and
// block sums are those of the forward the port ran.  Two launches, no
// atomics, bitwise reproducible:
//   1. block_bwd: one CTA per minute.  It rebuilds the corner lattice U in
//      shared memory, gathers the (n, n) cotangent window at idx_t, forms
//      dh_t and dclip_t from two fixed-order tree sums, and the masked block
//      cotangent ctb = [rect > 0] (h_t ct - ct_loss clip_t h_t), kept in
//      shared memory.  Each lattice corner then forms the adjoint of the
//      four-corner difference (ctU) and the closed-form derivative lattices
//          dL/dh = -phi(h) Phi(-(k - rho h)/s), dL/dk likewise,
//          dL/drho = phi2(h, k; rho),     s = sqrt(max(1 - rho^2, 1e-12)),
//      and stores ctU dL/dh and ctU dL/dk; column and row sums (one thread
//      per column or row, in index order) give dxe and dye, and tree sums
//      give dmu_t and the minute's partials of dsig_x, dsig_y, drho, dcell.
//   2. bwd_reduce: one CTA sums the (T, 4) partials in minute order and
//      applies the VJPs of the sigma and rho clamps.
// What bounds it: the lattice rebuild (the forward's exps), plus two
// normcdf and one exp per corner; shared memory 2 (2K+2)^2 + (2K+1)^2
// floats (96.5 KB at K = 44), so two CTAs per SM.
//
// Parameters are packed by parasitoids_tpu_torch/ops/day_kernel.py
// (_pack_constants) into one float vector; the layout is kConst* below.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// scalar slots; the backward also reads the raw (unclamped) parameters,
// 1/s, 1/s^2 and the loss cotangent
constexpr int kSigX = 0, kSigY = 1, kCell = 2, kRho = 3, kSgn = 4, kA = 5,
              kASq = 6, kAHalf = 7, kAsr = 8, kRawSigX = 9, kRawSigY = 10,
              kRawRho = 11, kInvS = 12, kInvS2 = 13, kCtLoss = 14;
constexpr int kScalars = 16;
// low-|rho| rows (sn, w, 1 - sn^2), each holding the 6-, 12- and 20-node
// rules back to back; then high-|rho| rows (xs, rs, w) of the 20-node rule
constexpr int kLoNodes = 6 + 12 + 20;
constexpr int kHiNodes = 20;
constexpr int kLoSn = kScalars, kLoW = kLoSn + kLoNodes,
              kLoDen = kLoW + kLoNodes, kHiXs = kLoDen + kLoNodes,
              kHiRs = kHiXs + kHiNodes, kHiW = kHiRs + kHiNodes;
constexpr int kConsts = kHiW + kHiNodes;   // 190 floats

constexpr int kBuildThreads = 256;
constexpr int kTile = 32;                 // buffer tile side
constexpr int kTileCells = kTile * kTile;
constexpr int kGatherRows = 8;            // thread rows of a gather CTA
constexpr int kGatherThreads = kTile * kGatherRows;
constexpr int kPer = kTile / kGatherRows; // cells per gather thread
constexpr int kBatch = 8;                 // gather loads in flight, minutes
constexpr int kUnroll = 4;                // partials in flight in the reduce
constexpr int kMaxChunks = 1024;          // chunks per tile the reduce takes

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kFourPi = 12.566370614359172f;
constexpr float kSqrt2Pi = 2.5066282746310002f;
constexpr float kRhoMax = 1.0f - 1e-6f;   // the |rho| clamp of the BVN op

// P(X > h, Y > k) for |rho| < 0.925: G-node Gauss-Legendre quadrature of the
// correlation integral (nodes at offset `o` of the low rows), plus the
// independence term phi = Phi(-h) Phi(-k).  The operations and their order
// are those of the plain twin (ops/bvn.py _upper_lowcorr).
template <int G>
__device__ __forceinline__ float upper_low(float h, float k, float phi,
                                           const float* q, int o) {
  const float hk = h * k;
  const float hs = 0.5f * (h * h + k * k);
  float total = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    total += q[kLoW + o + g] *
             expf((q[kLoSn + o + g] * hk - hs) / q[kLoDen + o + g]);
  }
  return total * q[kAsr] / kFourPi + phi;
}

// P(X > h, Y > k) for |rho| >= 0.925: Genz BVND asymptotic series plus tail
// quadrature, in the operation order of ops/bvn.py _upper_highcorr.
__device__ __forceinline__ float upper_high(float h, float y,
                                            const float* q) {
  const float sgn = q[kSgn], a = q[kA], a_sq = q[kASq];
  const float k = y * sgn;                 // rho < 0: flip k
  const float hk = h * k;
  const float bs = (h - k) * (h - k);
  const float c = (4.0f - hk) / 8.0f;
  const float d = (12.0f - hk) / 16.0f;
  const float asr = -(bs / a_sq + hk) / 2.0f;
  float bvn = 0.f;
  if (asr > -80.0f) {
    bvn = a * expf(fminf(asr, 0.0f)) *
          (1.0f - c * (bs - a_sq) * (1.0f - d * bs / 5.0f) / 3.0f +
           c * d * a_sq * a_sq / 5.0f);
  }
  if (-hk < 80.0f) {
    const float b = sqrtf(bs > 1e-30f ? bs : 1e-30f);
    bvn = bvn - expf(fminf(fmaxf(-hk / 2.0f, -80.0f), 80.0f)) * kSqrt2Pi *
                    normcdff(-b / a) * b *
                    (1.0f - c * bs * (1.0f - d * bs / 5.0f) / 3.0f);
  }
  const float a_half = q[kAHalf];
#pragma unroll 4
  for (int g = 0; g < kHiNodes; ++g) {
    const float xs = q[kHiXs + g], rs = q[kHiRs + g];
    const float asr1 = -(bs / xs + hk) / 2.0f;
    if (asr1 > -80.0f) {
      const float sp = 1.0f + c * xs * (1.0f + d * xs);
      const float ep = expf(-hk * (1.0f - rs) / (2.0f * (1.0f + rs))) / rs;
      bvn = bvn + a_half * q[kHiW + g] * expf(fminf(asr1, 0.0f)) * (ep - sp);
    }
  }
  bvn = -bvn / kTwoPi;
  if (sgn > 0.f) return bvn + normcdff(-fmaxf(h, k));
  return -bvn + (k > h ? normcdff(k) - normcdff(h) : 0.0f);
}

// Genz's node count by |rho| (6 / 12 / 20 nodes, the series from 0.925),
// taken on the device: K1/K3 are the low branches, K2/K4 the high one
__device__ __forceinline__ int rho_branch(const float* q) {
  const float ar = fabsf(q[kRho]);
  return (ar >= 0.3f) + (ar >= 0.75f) + (ar >= 0.925f);
}

// The corner lattice U[row][col] = P(X > xe[col], Y > ye[row]) of one
// minute, m x m, with px = Phi(-xe), py = Phi(-ye).
__device__ __forceinline__ void build_lattice(float* U, const float* xe,
                                              const float* ye,
                                              const float* px,
                                              const float* py,
                                              const float* q, int m) {
  const int branch = rho_branch(q);
  for (int p = threadIdx.x; p < m * m; p += blockDim.x) {
    const int r = p / m, c = p - r * m;
    const float phi = px[c] * py[r];
    float u;
    switch (branch) {
      case 0: u = upper_low<6>(xe[c], ye[r], phi, q, 0); break;
      case 1: u = upper_low<12>(xe[c], ye[r], phi, q, 6); break;
      case 2: u = upper_low<20>(xe[c], ye[r], phi, q, 18); break;
      default: u = upper_high(xe[c], ye[r], q); break;
    }
    U[p] = u;
  }
}

// The standardized corner coordinates of minute t's block (x ascending
// with the column, y descending with the row) and Phi of their negatives.
__device__ __forceinline__ void corner_edges(float* xe, float* ye, float* px,
                                             float* py, const float* q,
                                             float mux, float muy, int K) {
  const int m = 2 * K + 2;
  const float sig_x = q[kSigX], sig_y = q[kSigY], cell = q[kCell];
  const float centre = (float)K + 0.5f;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float fi = (float)i;
    const float x = ((fi - centre) * cell - mux) / sig_x;
    const float y = ((centre - fi) * cell - muy) / sig_y;
    xe[i] = x;
    ye[i] = y;
    px[i] = normcdff(-x);
    py[i] = normcdff(-y);
  }
}

// Fixed-order sum over the CTA of NV values per thread (warp trees, then
// warp 0 over the warp sums); the totals are valid in thread 0 only.
// `red` holds NV * (warps) floats; the call synchronizes the CTA once.
template <int NV>
__device__ __forceinline__ void cta_sum(float (&v)[NV], float* red) {
  const int tid = threadIdx.x, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) red[(tid >> 5) * NV + k] = v[k];
  }
  __syncthreads();
  if (tid < 32) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float s = tid < nw ? red[tid * NV + k] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      v[k] = s;
    }
  }
}

__host__ __device__ constexpr size_t build_smem_floats(int K) {
  // lattice + 4 edge vectors + constants + one partial sum per warp
  return (size_t)(2 * K + 2) * (2 * K + 2) + 4 * (size_t)(2 * K + 2) +
         kConsts + kBuildThreads / 32;
}

__global__ void __launch_bounds__(kBuildThreads)
block_build_kernel(const float* __restrict__ consts,
                   const float* __restrict__ h,
                   const float* __restrict__ mu,     // (T, 2): mu_x, mu_y
                   int K, float* __restrict__ scratch,  // (T, n, n)
                   float* __restrict__ bsum) {        // (T,)
  extern __shared__ float smem[];
  const int n = 2 * K + 1;
  const int m = n + 1;
  float* U = smem;               // [row][col], m * m
  float* xe = U + m * m;         // x edge, ascending with column
  float* ye = xe + m;            // y edge, descending with row
  float* px = ye + m;            // Phi(-xe)
  float* py = px + m;            // Phi(-ye)
  float* q = py + m;             // constants
  float* warp_sum = q + kConsts;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < kConsts; i += blockDim.x) q[i] = consts[i];
  __syncthreads();

  corner_edges(xe, ye, px, py, q, mu[2 * t], mu[2 * t + 1], K);
  __syncthreads();
  build_lattice(U, xe, ye, px, py, q, m);
  __syncthreads();

  // four-corner differences -> cell masses [row, col]; y descends with the
  // row index, so a cell's low-y corner is on row r + 1
  const float ht = h[t];
  float* out = scratch + (size_t)t * n * n;
  float part[1] = {0.f};
  for (int p = tid; p < n * n; p += blockDim.x) {
    const int r = p / n, c = p - r * n;
    const float* u0 = U + r * m + c;
    const float rect = (u0[m] - u0[m + 1]) - (u0[0] - u0[1]);
    const float b = fmaxf(rect, 0.0f);
    part[0] += b;
    out[p] = ht * b;
  }
  cta_sum(part, warp_sum);
  if (tid == 0) bsum[t] = part[0];
}

// Appends, in index order, the `item` of every thread whose `pred` holds
// to list[cnt...] and returns the new count, the same in every thread.
// Every thread of the CTA calls it; `warp_cnt` holds one int per warp.
__device__ __forceinline__ int compact_append(bool pred, int item, int* list,
                                              int cnt, int* warp_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) warp_cnt[warp] = __popc(ballot);
  __syncthreads();
  int off = cnt, total = cnt;
  for (int w = 0; w < nw; ++w) {
    off += w < warp ? warp_cnt[w] : 0;
    total += warp_cnt[w];
  }
  if (pred) list[off + __popc(ballot & ((1u << lane) - 1u))] = item;
  __syncthreads();               // list complete; warp_cnt free again
  return total;
}

// The tile box of a chunk's blocks: rows box.x..box.y and columns
// box.z..box.w of 32x32 tiles, from the block start (r0, c0) of every
// thread where `valid` holds; empty (y < x) when it holds nowhere.
// Synchronizes the CTA once.
__device__ __forceinline__ int4 chunk_box(int r0, int c0, bool valid, int n,
                                          int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int v[4] = {valid ? r0 : INT_MAX, valid ? -r0 : INT_MAX,
              valid ? c0 : INT_MAX, valid ? -c0 : INT_MAX};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = __reduce_min_sync(0xffffffffu, v[k]);
    if (lane == 0) red[warp * 4 + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = INT_MAX;
    for (int w = 0; w < nw; ++w) v[k] = min(v[k], red[w * 4 + k]);
  }
  if (v[0] == INT_MAX) return make_int4(0, -1, 0, -1);   // no valid start
  return make_int4(v[0] / kTile, (n - 1 - v[1]) / kTile, v[2] / kTile,
                   (n - 1 - v[3]) / kTile);
}

// Split-minute gather, pass 1: the span^2 CTAs of a chunk of consecutive
// minutes share out the tiles of the chunk's box (the tiles its blocks can
// meet), and for each sum, in minute order, the chunk's blocks that meet
// the tile into one partial tile; a flag says whether there was one.  CTA
// 0 of the chunk writes the box, which tells the reduce which flags were
// written.  Each thread owns the four cells (ty + 8k, tx) of the tile and
// loads its cells of kBatch hit minutes (0 off the block) into registers
// before it adds them, so kBatch minutes' reads are in flight at once.
__global__ void __launch_bounds__(kGatherThreads)
gather_chunk_kernel(const float* __restrict__ scratch,   // (T, n, n)
                    const float* __restrict__ h,         // (T,)
                    const int32_t* __restrict__ idx,     // (T, 2): row, col
                    int T, int n, int buf_len, int chunk,
                    float* __restrict__ partial,    // (tiles, nchunks, 32^2)
                    int32_t* __restrict__ flags,    // (tiles, nchunks)
                    int4* __restrict__ boxes) {     // (nchunks,)
  __shared__ int s_r[kGatherThreads], s_c[kGatherThreads];
  __shared__ int s_hit[kGatherThreads];
  __shared__ int red[4 * (kGatherThreads / 32)];
  __shared__ int warp_cnt[kGatherThreads / 32];
  const int tiles_x = (buf_len + kTile - 1) / kTile;
  const int ch = blockIdx.x, nchunks = gridDim.x;
  const int t0 = ch * chunk, cnt_t = min(chunk, T - t0);
  const int tid = threadIdx.x, tx = tid & (kTile - 1), ty = tid / kTile;

  // a minute with h = 0 (no take-off yet, or a block wholly off the
  // domain, parked at the buffer's centre) adds only zeros: it joins
  // neither the box nor a tile's list
  int r0 = 0, c0 = 0;
  const bool live = tid < cnt_t && h[t0 + tid] != 0.f;
  if (live) {
    r0 = idx[2 * (t0 + tid)];
    c0 = idx[2 * (t0 + tid) + 1];
    s_r[tid] = r0;
    s_c[tid] = c0;
  }
  const int4 box = chunk_box(r0, c0, live, n, red);  // syncs s_r, s_c
  if (blockIdx.y == 0 && tid == 0) boxes[ch] = box;
  const int box_w = box.w - box.z + 1;
  const int box_tiles = (box.y - box.x + 1) * box_w;

  for (int j = blockIdx.y; j < box_tiles; j += gridDim.y) {
    const int R = (box.x + j / box_w) * kTile, C = (box.z + j % box_w) * kTile;
    const size_t slot = (size_t)(R / kTile * tiles_x + C / kTile) * nchunks +
                        ch;
    const bool hit = live && r0 < R + kTile && r0 + n > R &&
                     c0 < C + kTile && c0 + n > C;
    const int cnt = compact_append(hit, tid, s_hit, 0, warp_cnt);
    if (cnt == 0) {              // the box's corner tiles often meet none
      if (tid == 0) flags[slot] = 0;
      continue;
    }
    // kBatch hit minutes' loads are issued before any of them is added
    float acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
    for (int i0 = 0; i0 < cnt; i0 += kBatch) {
      float v[kBatch][kPer];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u;
        const int m = s_hit[i < cnt ? i : i0];
        const int bc = C + tx - s_c[m];
        const float* blk = scratch + (size_t)(t0 + m) * n * n;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int br = R + ty + k * kGatherRows - s_r[m];
          const bool in = i < cnt && (unsigned)br < (unsigned)n &&
                          (unsigned)bc < (unsigned)n;
          v[u][k] = in ? __ldg(blk + br * n + bc) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) acc[k] += v[u][k];
      }
    }
    float* out = partial + slot * kTileCells + tid;
#pragma unroll
    for (int k = 0; k < kPer; ++k) out[k * kGatherThreads] = acc[k];
    if (tid == 0) flags[slot] = 1;
  }
}

// Split-minute gather, pass 2: one CTA per tile sums its partials in
// chunk order (a chunk has one when the tile lies in its box and the flag
// is set; kUnroll chunks' loads in flight at a time) and writes the tile,
// zeros where no minute meets it.  Every buffer cell is written once,
// with no atomics, so the buffer is bitwise the same every launch.
__global__ void __launch_bounds__(kGatherThreads)
reduce_tiles_kernel(const float* __restrict__ partial,
                    const int32_t* __restrict__ flags,
                    const int4* __restrict__ boxes, int nchunks,
                    int buf_len, float* __restrict__ buf) {
  __shared__ int s_list[kMaxChunks];
  __shared__ int warp_cnt[kGatherThreads / 32];
  const int tiles_x = (buf_len + kTile - 1) / kTile;
  const int tile = blockIdx.x, tr = tile / tiles_x, tc = tile % tiles_x;
  const int R = tr * kTile, C = tc * kTile;
  const int tid = threadIdx.x, tx = tid & (kTile - 1), ty = tid / kTile;
  const int32_t* f = flags + (size_t)tile * nchunks;
  int cnt = 0;
  for (int base = 0; base < nchunks; base += kGatherThreads) {
    const int c = base + tid;
    bool has = false;
    if (c < nchunks) {
      const int4 b = boxes[c];
      has = b.x <= tr && tr <= b.y && b.z <= tc && tc <= b.w && f[c] != 0;
    }
    cnt = compact_append(has, c, s_list, cnt, warp_cnt);
  }
  const float* p = partial + (size_t)tile * nchunks * kTileCells + tid;
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
  int i = 0;
  for (; i + kUnroll <= cnt; i += kUnroll) {
    float v[kUnroll][kPer];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* q = p + (size_t)s_list[i + u] * kTileCells;
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[u][k] = q[k * kGatherThreads];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] += v[u][k];
    }
  }
  for (; i < cnt; ++i) {
    const float* q = p + (size_t)s_list[i] * kTileCells;
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] += q[k * kGatherThreads];
  }
  const int col = C + tx;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int row = R + ty + k * kGatherRows;
    if (row < buf_len && col < buf_len)
      buf[(size_t)row * buf_len + col] = acc[k];
  }
}

__host__ __device__ constexpr size_t bwd_smem_floats(int K) {
  // lattice (then ctU dL/dh) + ctU dL/dk + ctb + 6 edge vectors + constants
  // + reduction scratch (7 values per warp)
  return 2 * (size_t)(2 * K + 2) * (2 * K + 2) +
         (size_t)(2 * K + 1) * (2 * K + 1) + 6 * (size_t)(2 * K + 2) +
         kConsts + 7 * (kBuildThreads / 32);
}

__global__ void __launch_bounds__(kBuildThreads)
block_bwd_kernel(const float* __restrict__ consts,
                 const float* __restrict__ h,       // (T,)
                 const float* __restrict__ mu,      // (T, 2)
                 const int32_t* __restrict__ idx,   // (T, 2): row, col
                 const float* __restrict__ clip,    // (T,)
                 const float* __restrict__ ct_buf,  // (buf_len, buf_len)
                 int K, int buf_len,
                 float* __restrict__ dh,            // (T,)
                 float* __restrict__ dmu,           // (T, 2)
                 float* __restrict__ dclip,         // (T,)
                 float* __restrict__ part) {        // (T, 4)
  extern __shared__ float smem[];
  const int n = 2 * K + 1;
  const int m = n + 1;
  float* U = smem;               // lattice [row][col]; then ctU dL/dh
  float* Y = U + m * m;          // ctU dL/dk
  float* ctb = Y + m * m;        // masked block cotangent, n * n
  float* xe = ctb + n * n;
  float* ye = xe + m;
  float* px = ye + m;            // Phi(-xe); then dxe
  float* py = px + m;            // Phi(-ye); then dye
  float* fx = py + m;            // phi(xe)
  float* fy = fx + m;            // phi(ye)
  float* q = fy + m;             // constants
  float* red = q + kConsts;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < kConsts; i += blockDim.x) q[i] = consts[i];
  __syncthreads();

  corner_edges(xe, ye, px, py, q, mu[2 * t], mu[2 * t + 1], K);
  __syncthreads();
  for (int i = tid; i < m; i += blockDim.x) {
    fx[i] = expf(-0.5f * xe[i] * xe[i]) / kSqrt2Pi;
    fy[i] = expf(-0.5f * ye[i] * ye[i]) / kSqrt2Pi;
  }
  build_lattice(U, xe, ye, px, py, q, m);
  __syncthreads();

  // the block as the forward built it, the cotangent window at idx_t, and
  // the masked block cotangent (the buffer's h block plus the loss's
  // -ct_loss clip h sum(block))
  const float ht = h[t], clt = clip[t], ctl = q[kCtLoss];
  const float cl_h = ctl * clt * ht;
  const float* ctw = ct_buf + (size_t)idx[2 * t] * buf_len + idx[2 * t + 1];
  float s2[2] = {0.f, 0.f};      // sum ct block, sum block
  for (int p = tid; p < n * n; p += blockDim.x) {
    const int r = p / n, c = p - r * n;
    const float* u0 = U + r * m + c;
    const float rect = (u0[m] - u0[m + 1]) - (u0[0] - u0[1]);
    const float b = fmaxf(rect, 0.0f);
    const float ct = ctw[(size_t)r * buf_len + c];
    s2[0] += ct * b;
    s2[1] += b;
    ctb[p] = rect > 0.0f ? ht * ct - cl_h : 0.0f;
  }
  cta_sum(s2, red);              // synchronizes: ctb is complete, U free
  if (tid == 0) {
    dh[t] = s2[0] + ctl * clt * (1.0f - s2[1]);
    dclip[t] = ctl * ht * (1.0f - s2[1]);
  }

  // adjoint of the four-corner difference at each corner,
  // ctU[i][j] = ctb[i-1][j] - ctb[i-1][j-1] - ctb[i][j] + ctb[i][j-1],
  // against the closed-form derivative lattices
  const float rho = q[kRho], inv_s = q[kInvS], inv_s2 = q[kInvS2];
  const float lr_scale = inv_s / kTwoPi;
  float s_rho[1] = {0.f};
  for (int p = tid; p < m * m; p += blockDim.x) {
    const int i = p / m, j = p - i * m;
    const bool up = i > 0, dn = i < n, lf = j > 0, rt = j < n;
    const float a = (up && rt) ? ctb[(i - 1) * n + j] : 0.0f;
    const float b = (up && lf) ? ctb[(i - 1) * n + j - 1] : 0.0f;
    const float c = (dn && rt) ? ctb[i * n + j] : 0.0f;
    const float d = (dn && lf) ? ctb[i * n + j - 1] : 0.0f;
    const float cu = ((a - b) - c) + d;
    const float x = xe[j], y = ye[i];
    const float lx = -fx[j] * normcdff(-(y - rho * x) * inv_s);
    const float ly = -fy[i] * normcdff(-(x - rho * y) * inv_s);
    const float qf = (x * x - 2.0f * rho * (x * y) + y * y) * inv_s2;
    U[p] = cu * lx;
    Y[p] = cu * ly;
    s_rho[0] += cu * (expf(-0.5f * qf) * lr_scale);
  }
  __syncthreads();
  // dxe[j] = sum_i ctU dL/dh (columns), dye[i] = sum_j ctU dL/dk (rows),
  // each summed in index order by one thread
  for (int k = tid; k < 2 * m; k += blockDim.x) {
    float acc = 0.f;
    if (k < m) {
      for (int i = 0; i < m; ++i) acc += U[i * m + k];
      px[k] = acc;
    } else {
      const float* row = Y + (size_t)(k - m) * m;
      for (int j = 0; j < m; ++j) acc += row[j];
      py[k - m] = acc;
    }
  }
  __syncthreads();
  // chain through the standardization xe = (jcol cell - mu_x) / sig_x,
  // ye = (irow cell - mu_y) / sig_y
  const float centre = (float)K + 0.5f;
  float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, s_rho[0]};
  for (int i = tid; i < m; i += blockDim.x) {
    const float fi = (float)i;
    v[0] += px[i];                          // sum dxe
    v[1] += px[i] * xe[i];                  // sum dxe xe
    v[2] += px[i] * (fi - centre);          // sum dxe jcol
    v[3] += py[i];                          // sum dye
    v[4] += py[i] * ye[i];                  // sum dye ye
    v[5] += py[i] * (centre - fi);          // sum dye irow
  }
  cta_sum(v, red);
  if (tid == 0) {
    const float sig_x = q[kSigX], sig_y = q[kSigY];
    dmu[2 * t] = -v[0] / sig_x;
    dmu[2 * t + 1] = -v[3] / sig_y;
    float* pt = part + 4 * (size_t)t;
    pt[0] = -v[1] / sig_x;                  // dsig_x
    pt[1] = -v[4] / sig_y;                  // dsig_y
    pt[2] = v[6];                           // drho
    pt[3] = v[2] / sig_x + v[5] / sig_y;    // dcell
  }
}

// Sums the (T, 4) per-minute partials in minute order (warp k for column
// k: lane l takes minutes l, l + 32, ..., then a fixed warp tree) and
// applies the VJPs of the sanitizing clamps: sigma passes no gradient at
// or below 1e-8, rho none at |rho| >= 1 - 1e-6.
__global__ void __launch_bounds__(128)
bwd_reduce_kernel(const float* __restrict__ consts,
                  const float* __restrict__ part, int T,
                  float* __restrict__ dD,           // (3,): sig_x, sig_y, rho
                  float* __restrict__ dcell) {      // ()
  __shared__ float tot[4];
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s = 0.f;
  for (int t = lane; t < T; t += 32) s += part[4 * (size_t)t + k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) tot[k] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    dD[0] = consts[kRawSigX] > 1e-8f ? tot[0] : 0.0f;
    dD[1] = consts[kRawSigY] > 1e-8f ? tot[1] : 0.0f;
    dD[2] = fabsf(consts[kRawRho]) < kRhoMax ? tot[2] : 0.0f;
    dcell[0] = tot[3];
  }
}

// The three launches of one day's accumulate on `s`; when `ev` is not
// null, ev[0..3] are recorded before block_build, between the passes and
// after the reduce.
cudaError_t launch_day(const float* consts, const float* h, const float* mu,
                       const int32_t* idx, int T, int K, int buf_len,
                       int chunk, float* scratch, float* bsum, float* partial,
                       int32_t* flags, int4* boxes, float* buf,
                       cudaStream_t s, cudaEvent_t* ev) {
  const size_t smem = build_smem_floats(K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n = 2 * K + 1;
  const int tiles_x = (buf_len + kTile - 1) / kTile;
  const int nchunks = (T + chunk - 1) / chunk;
  if (ev) cudaEventRecord(ev[0], s);
  block_build_kernel<<<T, kBuildThreads, smem, s>>>(consts, h, mu, K,
                                                    scratch, bsum);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ev) cudaEventRecord(ev[1], s);
  // a block meets at most span^2 tiles, so a chunk whose blocks barely
  // move has about one tile per CTA
  const int span = (n - 1 + kTile - 1) / kTile + 1;
  gather_chunk_kernel<<<dim3(nchunks, span * span), kGatherThreads, 0, s>>>(
      scratch, h, idx, T, n, buf_len, chunk, partial, flags, boxes);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ev) cudaEventRecord(ev[2], s);
  reduce_tiles_kernel<<<tiles_x * tiles_x, kGatherThreads, 0, s>>>(
      partial, flags, boxes, nchunks, buf_len, buf);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ev) cudaEventRecord(ev[3], s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory that block_build needs at half-width K (bytes).
int parasitoids_day_smem_bytes(int K) {
  return (int)(build_smem_floats(K) * sizeof(float));
}

// One day's accumulate on `stream`: block_build over T minutes, the
// split-minute gather over (tile, chunk of `chunk` minutes), and the
// chunk-order reduce into buf (buf_len x buf_len, fully overwritten).
// Every pointer is device memory: scratch (T, n, n), bsum (T,), partial
// (tiles, nchunks, 32, 32), flags (tiles, nchunks) and boxes (nchunks, 4),
// 16-byte aligned, with tiles = ceil(buf_len / 32)^2 and nchunks =
// ceil(T / chunk), 1 <= chunk <= 256 (one minute per gather thread) and
// nchunks <= kMaxChunks.  idx rows must lie in [0, buf_len - (2K+1)].
// Returns the cudaError_t of the launches (0 on success).
int parasitoids_day_accumulate(const float* consts, const float* h,
                               const float* mu, const int32_t* idx, int T,
                               int K, int buf_len, int chunk, float* scratch,
                               float* bsum, float* partial, int32_t* flags,
                               int32_t* boxes, float* buf, void* stream) {
  return (int)launch_day(consts, h, mu, idx, T, K, buf_len, chunk, scratch,
                         bsum, partial, flags, (int4*)boxes, buf,
                         (cudaStream_t)stream, nullptr);
}

// The same accumulate `reps` times back to back, with CUDA events around
// each pass (all reps are queued before the first is waited on, so no pass
// waits on the host); then waits for the card and writes the device
// milliseconds of block_build, gather and reduce of rep r to
// ms[3 r .. 3 r + 2] (host memory).
int parasitoids_day_accumulate_timed(const float* consts, const float* h,
                                     const float* mu, const int32_t* idx,
                                     int T, int K, int buf_len, int chunk,
                                     float* scratch, float* bsum,
                                     float* partial, int32_t* flags,
                                     int32_t* boxes, float* buf, int reps,
                                     float* ms,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t* ev = new cudaEvent_t[4 * reps];
  int made = 0;
  cudaError_t err = cudaSuccess;
  while (made < 4 * reps && (err = cudaEventCreate(&ev[made])) == cudaSuccess)
    ++made;
  for (int r = 0; r < reps && err == cudaSuccess; ++r)
    err = launch_day(consts, h, mu, idx, T, K, buf_len, chunk, scratch, bsum,
                     partial, flags, (int4*)boxes, buf, s, ev + 4 * r);
  if (err == cudaSuccess) err = cudaEventSynchronize(ev[4 * reps - 1]);
  for (int r = 0; r < reps && err == cudaSuccess; ++r)
    for (int p = 0; p < 3 && err == cudaSuccess; ++p)
      err = cudaEventElapsedTime(&ms[3 * r + p], ev[4 * r + p],
                                 ev[4 * r + p + 1]);
  for (int i = 0; i < made; ++i) cudaEventDestroy(ev[i]);
  delete[] ev;
  return (int)err;
}

// Dynamic shared memory that block_bwd needs at half-width K (bytes).
int parasitoids_day_bwd_smem_bytes(int K) {
  return (int)(bwd_smem_floats(K) * sizeof(float));
}

// One day's backward on `stream`: block_bwd over T minutes, then the
// minute-order reduction of the shared partials.  Every pointer is device
// memory; `part` is (T, 4) scratch.  Returns the cudaError_t of the
// launches (0 on success).
int parasitoids_day_accumulate_bwd(const float* consts, const float* h,
                                   const float* mu, const int32_t* idx,
                                   const float* clip, const float* ct_buf,
                                   int T, int K, int buf_len, float* dh,
                                   float* dmu, float* dclip, float* part,
                                   float* dD, float* dcell, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = bwd_smem_floats(K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_bwd_kernel<<<T, kBuildThreads, smem, s>>>(
      consts, h, mu, idx, clip, ct_buf, K, buf_len, dh, dmu, dclip, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_reduce_kernel<<<1, 128, 0, s>>>(consts, part, T, dD, dcell);
  return (int)cudaGetLastError();
}

}  // extern "C"
