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
// The same three launches take a particle axis (grid y of block_build and
// reduce_tiles, grid z of gather_chunk; every array leads with it): one
// launch a day advances a whole SMC population, each particle with its
// own constants row.  The ensemble takes the node rule of the JAX
// package's batched scheme (parasitoids_tpu/ops/bvn.py
// bvn_upper_grid_select, the Pallas kernel's own rule: 20 nodes where
// |rho| <= 0.925, the series elsewhere), read per particle from kSelect
// and rho on the device: JAX runs that scheme on XLA, since a vmap of
// the Pallas kernel's lax.cond would pay both branches, where a CTA here
// reads only its own particle's.  The batched launch costs N times one
// particle's work and scratch (46 MB and 90 MB of partials a particle at
// K = 44), and its sums keep the single launch's order, so it is bitwise
// reproducible too.
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
//   1. block_bwd: one CTA per minute, one streamed pass.  The corner
//      lattice U is rebuilt ring - 1 rows at a time into a ring of rows in
//      shared memory.  Once rows r and r + 1 exist, cell row r follows:
//      the block (for dh_t, dclip_t and the clamp mask) and the masked
//      block cotangent
//          ctb = [rect > 0] (h_t ct - ct_loss clip_t h_t),
//      its cotangent window read straight from ct_buf (L2-resident), kept
//      in a second ring.  Corner row r then needs nothing else: every
//      output is a plain sum over corners of ctU times a closed-form
//      derivative of L (see corner_rows), so each thread adds its corners
//      into seven registers while the next rows are built, and one
//      fixed-order tree sum at the end of the minute gives dh_t, dclip_t,
//      dmu_t and the minute's partials of dsig_x, dsig_y, drho, dcell.  No
//      derivative lattice is stored.  Threads walk each range of rows
//      flat, consecutive threads on consecutive elements (see Walk): no
//      index is divided in a loop, every lane works whatever 2K + 2 is,
//      and shared-memory accesses run along rows.
//   2. bwd_reduce: one CTA sums the (T, 4) partials in minute order and
//      applies the VJPs of the sigma and rho clamps.
// What bounds it: instruction throughput, not memory or occupancy.  A
// corner costs the forward's rebuild (G exps and G IEEE divisions, about
// 170 instructions at G = 6) plus two normcdf and one exp; on an H100 the
// rebuild and the cell rows alone take about 0.14 ms a day at K = 44,
// T = 1440, the derivatives 0.06 ms more, and 3, 4 or 5 CTAs an SM differ
// by 3%.  Shared memory is O(ring K), 50 KB at K = 44 with a ring of 64
// rows, so it bounds neither the occupancy (registers do: 60, four CTAs
// of 256 threads an SM) nor K: the wrapper halves the ring as K grows,
// and the backward runs wherever block_build's K^2 lattice fits, and
// beyond.  What is left is the lattice's own arithmetic, shared with the
// forward: its divisions are by the per-node 1 - sn^2, warp-uniform
// constants whose reciprocals every thread recomputes.
//
// Parameters are packed by parasitoids_tpu_torch/ops/day_kernel.py
// (_pack_constants) into one float vector; the layout is kConst* below.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// scalar slots; the backward also reads the raw (unclamped) parameters,
// 1/s, 1/s^2 and the loss cotangent; kSelect picks the node rule
constexpr int kSigX = 0, kSigY = 1, kCell = 2, kRho = 3, kSgn = 4, kA = 5,
              kASq = 6, kAHalf = 7, kAsr = 8, kRawSigX = 9, kRawSigY = 10,
              kRawRho = 11, kInvS = 12, kInvS2 = 13, kCtLoss = 14,
              kSelect = 15;
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
// taken on the device: K1/K3 are the low branches, K2/K4 the high one.
// With kSelect set (the particle-batched ensemble, ops/bvn.py
// bvn_upper_grid_select) the two-branch rule instead: 20 nodes where
// |rho| <= 0.925, the series elsewhere.
__device__ __forceinline__ int rho_branch(const float* q) {
  const float ar = fabsf(q[kRho]);
  if (q[kSelect] != 0.f) return ar <= 0.925f ? 2 : 3;
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

// One CTA per (minute, particle): blockIdx.x is the minute t of T =
// gridDim.x, blockIdx.y the particle, whose constants, inputs and outputs
// lie at its offset of each array.
__global__ void __launch_bounds__(kBuildThreads)
block_build_kernel(const float* __restrict__ consts,  // (N, kConsts)
                   const float* __restrict__ h,       // (N, T)
                   const float* __restrict__ mu,      // (N, T, 2): mu_x, mu_y
                   int K, float* __restrict__ scratch,  // (N, T, n, n)
                   float* __restrict__ bsum) {        // (N, T)
  extern __shared__ float smem[];
  const int n = 2 * K + 1;
  const int m = n + 1;
  const size_t p = blockIdx.y, T = gridDim.x;
  consts += p * kConsts;
  h += p * T;
  mu += 2 * p * T;
  scratch += p * T * n * n;
  bsum += p * T;
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
  {
    const size_t p = blockIdx.z, slots = (size_t)tiles_x * tiles_x * nchunks;
    scratch += p * T * n * n;
    h += p * T;
    idx += 2 * p * T;
    partial += p * slots * kTileCells;
    flags += p * slots;
    boxes += p * nchunks;
  }

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
// blockIdx.y is the particle.
__global__ void __launch_bounds__(kGatherThreads)
reduce_tiles_kernel(const float* __restrict__ partial,
                    const int32_t* __restrict__ flags,
                    const int4* __restrict__ boxes, int nchunks,
                    int buf_len, float* __restrict__ buf) {
  __shared__ int s_list[kMaxChunks];
  __shared__ int warp_cnt[kGatherThreads / 32];
  const int tiles_x = (buf_len + kTile - 1) / kTile;
  {
    const size_t p = blockIdx.y, slots = (size_t)tiles_x * tiles_x * nchunks;
    partial += p * slots * kTileCells;
    flags += p * slots;
    boxes += p * nchunks;
    buf += p * buf_len * buf_len;
  }
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

constexpr int kBwdThreads = 256;          // threads of a block_bwd CTA
constexpr int kBwdMinCtas = 4;            // CTAs an SM must hold: 64 registers
constexpr int kBwdSums = 9;               // CTA-wide sums of one minute

// Floats of dynamic shared memory of block_bwd at half-width K with rings
// of `ring` rows: the lattice ring and the padded block cotangent ring, a
// row of zeros, 6 edge vectors, the constants and the reduction scratch.
__host__ __device__ constexpr size_t bwd_smem_floats(int K, int ring) {
  const size_t m = 2 * (size_t)K + 2;
  return ring * m + ring * (m + 1) + (m + 1) + 6 * m + kConsts +
         kBwdSums * (kBwdThreads / 32);
}

// The ring block_bwd uses when asked for `ring` rows: a power of two (a
// row's slot is row & (ring - 1)), at least 2, and no more than the whole
// lattice of 2K + 2 rows and the carried row need.
__host__ __device__ constexpr int bwd_ring(int K, int ring) {
  int r = 2;
  while (r < ring && r < 2 * K + 3) r *= 2;
  return r;
}

// A thread's walk over a row-major range of rows of `w` elements, one
// element a step and kBwdThreads elements between steps, with no division
// in the loop: the thread starts at (row q, column r) = (tid / w, tid % w)
// of the range and a step adds (dq, dr) = (kBwdThreads / w, kBwdThreads %
// w), with a carry.  Consecutive threads take consecutive elements, so
// every lane works whatever w is, and shared-memory accesses run along
// rows.
struct Walk {
  int w, q, r, dq, dr;
  __device__ Walk(int width)
      : w(width), q(threadIdx.x / width), r(threadIdx.x % width),
        dq(kBwdThreads / width), dr(kBwdThreads % width) {}
  __device__ __forceinline__ void step(int& row, int& col) const {
    col += dr;
    row += dq;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
};

// One corner of the lattice by Genz branch BR (see rho_branch).
template <int BR>
__device__ __forceinline__ float corner_upper(float x, float y, float phi,
                                              const float* q) {
  if constexpr (BR == 0) return upper_low<6>(x, y, phi, q, 0);
  if constexpr (BR == 1) return upper_low<12>(x, y, phi, q, 6);
  if constexpr (BR == 2) return upper_low<20>(x, y, phi, q, 18);
  return upper_high(x, y, q);
}

// Rows [lo, hi) of the corner lattice into a ring of rows of m (row r
// lives in slot r & mask).  The values are those of build_lattice, bit
// for bit.
template <int BR>
__device__ __forceinline__ void lattice_rows(float* U, int mask, int lo,
                                             int hi, const Walk& wm,
                                             const float* xe, const float* ye,
                                             const float* px, const float* py,
                                             const float* q) {
  const int m = wm.w;
  for (int r = lo + wm.q, c = wm.r; r < hi; wm.step(r, c)) {
    const float phi = px[c] * py[r];
    U[(r & mask) * m + c] = corner_upper<BR>(xe[c], ye[r], phi, q);
  }
}

// Corner rows [lo, hi) of one minute's backward: at corner (i, j) the
// adjoint of the four-corner difference,
//   ctU[i][j] = ctb[i-1][j] - ctb[i-1][j-1] - ctb[i][j] + ctb[i][j-1],
// against the closed-form derivatives
//   dL/dh = -phi(h) Phi(-(k - rho h)/s), dL/dk likewise,
//   dL/drho = phi2(h, k; rho),           s = sqrt(max(1 - rho^2, 1e-12)),
// added to the thread's seven sums v[2..8] (sum dxe, dxe xe, dxe jcol,
// sum dye, dye ye, dye irow, sum ctU dL/drho).  ctb rows are padded by a
// zero column on each side (row stride m + 1) and live in a ring; rows
// -1 and n read the row of zeros.  A corner whose ctU is 0 (masked cells,
// a minute with h = 0) adds exact zeros and is skipped.
__device__ __forceinline__ void corner_rows(
    float (&v)[kBwdSums], int lo, int hi, const Walk& wm, const float* ctb,
    const float* zrow, int mask, const float* xe, const float* ye,
    const float* fx, const float* fy, const float* q, int K) {
  const int m = wm.w, n = m - 1, cw = m + 1;
  const float rho = q[kRho], inv_s = q[kInvS], inv_s2 = q[kInvS2];
  const float lr_scale = inv_s / kTwoPi;
  const float centre = (float)K + 0.5f;
  for (int i = lo + wm.q, j = wm.r; i < hi; wm.step(i, j)) {
    const float* up = i > 0 ? ctb + ((i - 1) & mask) * cw : zrow;
    const float* dn = i < n ? ctb + (i & mask) * cw : zrow;
    const float cu = ((up[j + 1] - up[j]) - dn[j + 1]) + dn[j];
    if (cu == 0.0f) continue;
    const float x = xe[j], y = ye[i];
    const float lx = -fx[j] * normcdff(-(y - rho * x) * inv_s);
    const float ly = -fy[i] * normcdff(-(x - rho * y) * inv_s);
    const float qf = (x * x - 2.0f * rho * (x * y) + y * y) * inv_s2;
    const float gx = cu * lx, gy = cu * ly;
    v[2] += gx;
    v[3] += gx * x;
    v[4] += gx * ((float)j - centre);
    v[5] += gy;
    v[6] += gy * y;
    v[7] += gy * (centre - (float)i);
    v[8] += cu * (expf(-0.5f * qf) * lr_scale);
  }
}

// The backward of one day's accumulate, a CTA per minute.  The lattice is
// built ring - 1 rows at a time; as soon as rows r and r + 1 exist, cell
// row r of the block (for dh, dclip and the clamp mask) and of the masked
// block cotangent ctb = [rect > 0] (h_t ct - ct_loss clip_t h_t) follow,
// the cotangent window read straight from ct_buf, and then corner row r's
// sums, in the same phase that builds the next strip.  Nothing of size
// K^2 is kept unless the ring is asked to hold the whole lattice.
__global__ void __launch_bounds__(kBwdThreads, kBwdMinCtas)
block_bwd_kernel(const float* __restrict__ consts,
                 const float* __restrict__ h,       // (T,)
                 const float* __restrict__ mu,      // (T, 2)
                 const int32_t* __restrict__ idx,   // (T, 2): row, col
                 const float* __restrict__ clip,    // (T,)
                 const float* __restrict__ ct_buf,  // (buf_len, buf_len)
                 int K, int buf_len, int ring,
                 float* __restrict__ dh,            // (T,)
                 float* __restrict__ dmu,           // (T, 2)
                 float* __restrict__ dclip,         // (T,)
                 float* __restrict__ part) {        // (T, 4)
  extern __shared__ float smem[];
  const int n = 2 * K + 1;
  const int m = n + 1, cw = m + 1, mask = ring - 1, strip = ring - 1;
  float* U = smem;               // lattice ring [slot][col], ring * m
  float* ctb = U + ring * m;     // cotangent ring [slot][1 + col], ring * cw
  float* zrow = ctb + ring * cw; // cw zeros
  float* xe = zrow + cw;
  float* ye = xe + m;
  float* px = ye + m;            // Phi(-xe)
  float* py = px + m;            // Phi(-ye)
  float* fx = py + m;            // phi(xe)
  float* fy = fx + m;            // phi(ye)
  float* q = fy + m;             // constants
  float* red = q + kConsts;

  const int tid = threadIdx.x;
  const Walk wm(m), wn(n);       // over lattice rows and over cell rows
  for (int i = tid; i < kConsts; i += kBwdThreads) q[i] = consts[i];
  for (int i = tid; i < cw; i += kBwdThreads) zrow[i] = 0.0f;
  for (int i = tid; i < ring; i += kBwdThreads)
    ctb[i * cw] = ctb[i * cw + n + 1] = 0.0f;
  __syncthreads();
  const int branch = rho_branch(q);
  const float ctl = q[kCtLoss];
  const int nstrips = (m + strip - 1) / strip;

  const int t = blockIdx.x;
  corner_edges(xe, ye, px, py, q, mu[2 * t], mu[2 * t + 1], K);
  __syncthreads();
  for (int i = tid; i < m; i += kBwdThreads) {
    fx[i] = expf(-0.5f * xe[i] * xe[i]) / kSqrt2Pi;
    fy[i] = expf(-0.5f * ye[i] * ye[i]) / kSqrt2Pi;
  }
  const float ht = h[t], clt = clip[t];
  const float cl_h = ctl * clt * ht;
  const float* ctw = ct_buf + (size_t)idx[2 * t] * buf_len + idx[2 * t + 1];
  // v[0] = sum ct block, v[1] = sum block, v[2..8]: see corner_rows
  float v[kBwdSums];
#pragma unroll
  for (int k = 0; k < kBwdSums; ++k) v[k] = 0.0f;
  int c_lo = 0, c_hi = 0;        // corner rows whose ctb rows are complete
  for (int s = 0; s < nstrips; ++s) {
    const int u_lo = s * strip, u_hi = min(u_lo + strip, m);
    switch (branch) {
      case 0: lattice_rows<0>(U, mask, u_lo, u_hi, wm, xe, ye, px, py, q);
        break;
      case 1: lattice_rows<1>(U, mask, u_lo, u_hi, wm, xe, ye, px, py, q);
        break;
      case 2: lattice_rows<2>(U, mask, u_lo, u_hi, wm, xe, ye, px, py, q);
        break;
      default: lattice_rows<3>(U, mask, u_lo, u_hi, wm, xe, ye, px, py, q);
        break;
    }
    corner_rows(v, c_lo, c_hi, wm, ctb, zrow, mask, xe, ye, fx, fy, q, K);
    __syncthreads();             // lattice rows < u_hi are complete
    // cell rows whose two lattice rows exist; y descends with the row
    // index, so a cell's low-y corners are on lattice row r + 1
    c_lo = max(u_lo - 1, 0);
    const int r_hi = u_hi - 1;
    for (int r = c_lo + wn.q, c = wn.r; r < r_hi; wn.step(r, c)) {
      const float* u0 = U + (r & mask) * m + c;
      const float* u1 = U + ((r + 1) & mask) * m + c;
      const float rect = (u1[0] - u1[1]) - (u0[0] - u0[1]);
      const float b = fmaxf(rect, 0.0f);
      const float ct = ctw[(size_t)r * buf_len + c];
      v[0] += ct * b;
      v[1] += b;
      ctb[(r & mask) * cw + 1 + c] = rect > 0.0f ? ht * ct - cl_h : 0.0f;
    }
    __syncthreads();             // ctb rows < r_hi are complete
    c_hi = s == nstrips - 1 ? m : r_hi;
  }
  corner_rows(v, c_lo, c_hi, wm, ctb, zrow, mask, xe, ye, fx, fy, q, K);
  cta_sum(v, red);
  if (tid == 0) {
    const float sig_x = q[kSigX], sig_y = q[kSigY];
    dh[t] = v[0] + ctl * clt * (1.0f - v[1]);
    dclip[t] = ctl * ht * (1.0f - v[1]);
    // chain through the standardization xe = (jcol cell - mu_x) / sig_x,
    // ye = (irow cell - mu_y) / sig_y
    dmu[2 * t] = -v[2] / sig_x;
    dmu[2 * t + 1] = -v[5] / sig_y;
    float* pt = part + 4 * (size_t)t;
    pt[0] = -v[3] / sig_x;                  // dsig_x
    pt[1] = -v[6] / sig_y;                  // dsig_y
    pt[2] = v[8];                           // drho
    pt[3] = v[4] / sig_x + v[7] / sig_y;    // dcell
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

// The three launches of one day's accumulate for N particles on `s` (the
// particle on each grid's last axis); when `ev` is not null, ev[0..3] are
// recorded before block_build, between the passes and after the reduce.
cudaError_t launch_day(const float* consts, const float* h, const float* mu,
                       const int32_t* idx, int N, int T, int K, int buf_len,
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
  block_build_kernel<<<dim3(T, N), kBuildThreads, smem, s>>>(consts, h, mu,
                                                            K, scratch, bsum);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ev) cudaEventRecord(ev[1], s);
  // a block meets at most span^2 tiles, so a chunk whose blocks barely
  // move has about one tile per CTA
  const int span = (n - 1 + kTile - 1) / kTile + 1;
  gather_chunk_kernel<<<dim3(nchunks, span * span, N), kGatherThreads, 0,
                        s>>>(scratch, h, idx, T, n, buf_len, chunk, partial,
                             flags, boxes);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ev) cudaEventRecord(ev[2], s);
  reduce_tiles_kernel<<<dim3(tiles_x * tiles_x, N), kGatherThreads, 0, s>>>(
      partial, flags, boxes, nchunks, buf_len, buf);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ev) cudaEventRecord(ev[3], s);
  return cudaGetLastError();
}

// The two launches of one day's backward on `s`, block_bwd with rings of
// bwd_ring(K, ring) rows; when `ev` is not null, ev[0..2] are recorded
// before block_bwd, between the launches and after bwd_reduce.
cudaError_t launch_day_bwd(const float* consts, const float* h,
                           const float* mu, const int32_t* idx,
                           const float* clip, const float* ct_buf, int T,
                           int K, int buf_len, int ring, float* dh, float* dmu, float* dclip, float* part,
                           float* dD, float* dcell, cudaStream_t s,
                           cudaEvent_t* ev) {
  ring = bwd_ring(K, ring);
  const size_t smem = bwd_smem_floats(K, ring) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (ev) cudaEventRecord(ev[0], s);
  block_bwd_kernel<<<T, kBwdThreads, smem, s>>>(consts, h, mu, idx, clip, ct_buf,
                                            K, buf_len, ring, dh, dmu, dclip,
                                            part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ev) cudaEventRecord(ev[1], s);
  bwd_reduce_kernel<<<1, 128, 0, s>>>(consts, part, T, dD, dcell);
  if (ev) cudaEventRecord(ev[2], s);
  return cudaGetLastError();
}

// Runs launch(ev) `reps` times back to back, each recording its `passes`
// + 1 events; every rep is queued before the first is waited on, so no
// pass waits on the host.  Then waits for the card and writes the device
// milliseconds of rep r's passes to ms[passes r .. passes r + passes - 1]
// (host memory).
template <class Launch>
cudaError_t time_passes(int reps, int passes, float* ms, Launch launch) {
  if (reps < 1) return cudaErrorInvalidValue;
  const int per = passes + 1;
  cudaEvent_t* ev = new cudaEvent_t[per * reps];
  int made = 0;
  cudaError_t err = cudaSuccess;
  while (made < per * reps &&
         (err = cudaEventCreate(&ev[made])) == cudaSuccess)
    ++made;
  for (int r = 0; r < reps && err == cudaSuccess; ++r)
    err = launch(ev + per * r);
  if (err == cudaSuccess) err = cudaEventSynchronize(ev[per * reps - 1]);
  for (int r = 0; r < reps && err == cudaSuccess; ++r)
    for (int p = 0; p < passes && err == cudaSuccess; ++p)
      err = cudaEventElapsedTime(&ms[passes * r + p], ev[per * r + p],
                                 ev[per * r + p + 1]);
  for (int i = 0; i < made; ++i) cudaEventDestroy(ev[i]);
  delete[] ev;
  return err;
}

}  // namespace

extern "C" {

// Dynamic shared memory that block_build needs at half-width K (bytes).
int parasitoids_day_smem_bytes(int K) {
  return (int)(build_smem_floats(K) * sizeof(float));
}

// One day's accumulate for N particles (N = 1: one parameter set) on
// `stream`: block_build over T minutes, the split-minute gather over
// (tile, chunk of `chunk` minutes), and the chunk-order reduce into buf
// (buf_len x buf_len a particle, fully overwritten).  Every pointer is
// device memory, each array with a leading particle axis: consts (N,
// kConsts), h (N, T), mu and idx (N, T, 2), scratch (N, T, n, n), bsum
// (N, T), partial (N, tiles, nchunks, 32, 32), flags (N, tiles, nchunks)
// and boxes (N, nchunks, 4), 16-byte aligned, with tiles = ceil(buf_len /
// 32)^2 and nchunks = ceil(T / chunk), 1 <= chunk <= 256 (one minute per
// gather thread) and nchunks <= kMaxChunks.  idx rows must lie in [0,
// buf_len - (2K+1)].  Returns the cudaError_t of the launches (0 on
// success).
int parasitoids_day_accumulate(const float* consts, const float* h,
                               const float* mu, const int32_t* idx, int N,
                               int T, int K, int buf_len, int chunk,
                               float* scratch, float* bsum, float* partial,
                               int32_t* flags, int32_t* boxes, float* buf,
                               void* stream) {
  return (int)launch_day(consts, h, mu, idx, N, T, K, buf_len, chunk, scratch,
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
                                     int N, int T, int K, int buf_len,
                                     int chunk,
                                     float* scratch, float* bsum,
                                     float* partial, int32_t* flags,
                                     int32_t* boxes, float* buf, int reps,
                                     float* ms,
                                     void* stream) {
  return (int)time_passes(reps, 3, ms, [&](cudaEvent_t* ev) {
    return launch_day(consts, h, mu, idx, N, T, K, buf_len, chunk, scratch,
                      bsum, partial, flags, (int4*)boxes, buf,
                      (cudaStream_t)stream, ev);
  });
}

// Dynamic shared memory that block_bwd needs at half-width K when asked
// for rings of `ring` rows (bytes).
int parasitoids_day_bwd_smem_bytes(int K, int ring) {
  return (int)(bwd_smem_floats(K, bwd_ring(K, ring)) * sizeof(float));
}

// One day's backward on `stream`: block_bwd over T minutes (rings of
// `ring` rows, rounded up to a power of two), then
// the minute-order reduction of the shared partials.  Every pointer is
// device memory; `part` is (T, 4) scratch.  Returns the cudaError_t of the
// launches (0 on success).
int parasitoids_day_accumulate_bwd(const float* consts, const float* h,
                                   const float* mu, const int32_t* idx,
                                   const float* clip, const float* ct_buf,
                                   int T, int K, int buf_len, int ring,
                                   float* dh, float* dmu, float* dclip,
                                   float* part, float* dD, float* dcell,
                                   void* stream) {
  return (int)launch_day_bwd(consts, h, mu, idx, clip, ct_buf, T, K, buf_len,
                             ring, dh, dmu, dclip, part, dD, dcell,
                             (cudaStream_t)stream, nullptr);
}

// The same backward `reps` times back to back with CUDA events around
// each launch (see time_passes): the device milliseconds of block_bwd and
// bwd_reduce of rep r go to ms[2 r] and ms[2 r + 1] (host memory).
int parasitoids_day_accumulate_bwd_timed(const float* consts, const float* h,
                                         const float* mu, const int32_t* idx,
                                         const float* clip,
                                         const float* ct_buf, int T, int K,
                                         int buf_len, int ring, float* dh, float* dmu, float* dclip,
                                         float* part, float* dD, float* dcell,
                                         int reps, float* ms, void* stream) {
  return (int)time_passes(reps, 2, ms, [&](cudaEvent_t* ev) {
    return launch_day_bwd(consts, h, mu, idx, clip, ct_buf, T, K, buf_len,
                          ring, dh, dmu, dclip, part, dD, dcell,
                          (cudaStream_t)stream, ev);
  });
}

}  // extern "C"
