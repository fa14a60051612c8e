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
// Design (two passes, deterministic, no atomics):
//   1. block_build: one CTA per minute.  The upper-orthant probabilities on
//      the (2K+2)^2 corner lattice live in shared memory; the CTA differences
//      them into the (2K+1)^2 block, clamps at 0, writes h_t * block into a
//      (T, n, n) scratch and the block's sum into bsum[t].  The sum is a
//      fixed-order tree, so bsum is bitwise reproducible.
//   2. gather: output-tile-stationary.  Each CTA owns a 32x32 tile of the
//      (buf_len, buf_len) buffer, walks the minutes in order, skips those whose
//      block misses the tile and adds the overlap.  Each cell's sum runs over
//      t ascending in one thread, so the buffer is bitwise reproducible.
//
// What bounds it: block_build issues (2K+2)^2 * G exps per minute (MUFU
// throughput; G = 6 at prior-typical rho, 70 M exps a day at K = 44,
// T = 1440; about 2 exps per node on the high branch); the gather reads the
// scratch, about n^2 * T * 4 bytes (46 MB a day at K = 44) plus its partial
// tiles.  A fused variant that keeps blocks on chip and drops the scratch
// round-trip is later work.
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
constexpr int kTile = 32;
constexpr int kGatherRows = 8;            // threads per tile column
constexpr int kIdxChunk = 512;

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

__global__ void __launch_bounds__(kTile * kGatherRows)
gather_kernel(const float* __restrict__ scratch,   // (T, n, n)
              const int32_t* __restrict__ idx,     // (T, 2): row, col
              int T, int n, int buf_len, float* __restrict__ buf) {
  __shared__ int s_r[kIdxChunk];
  __shared__ int s_c[kIdxChunk];
  constexpr int kPer = kTile / kGatherRows;
  const int R = blockIdx.y * kTile;
  const int C = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int col = C + tx;
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;

  for (int t0 = 0; t0 < T; t0 += kIdxChunk) {
    const int cnt = min(kIdxChunk, T - t0);
    __syncthreads();
    for (int i = tid; i < cnt; i += kTile * kGatherRows) {
      s_r[i] = idx[2 * (t0 + i)];
      s_c[i] = idx[2 * (t0 + i) + 1];
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const int r0 = s_r[i], c0 = s_c[i];
      if (r0 >= R + kTile || r0 + n <= R || c0 >= C + kTile || c0 + n <= C)
        continue;   // uniform across the CTA
      const int bc = col - c0;
      if (bc < 0 || bc >= n) continue;
      const float* blk = scratch + (size_t)(t0 + i) * n * n + bc;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int br = R + ty + k * kGatherRows - r0;
        if (br >= 0 && br < n) acc[k] += blk[(size_t)br * n];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int row = R + ty + k * kGatherRows;
    if (row < buf_len && col < buf_len) buf[(size_t)row * buf_len + col] = acc[k];
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

}  // namespace

extern "C" {

// Dynamic shared memory that block_build needs at half-width K (bytes).
int parasitoids_day_smem_bytes(int K) {
  return (int)(build_smem_floats(K) * sizeof(float));
}

// One day's accumulate on `stream`: block_build over T minutes, then the
// tile gather into buf (buf_len x buf_len, fully overwritten).  Every
// pointer is device memory; idx rows must lie in [0, buf_len - (2K+1)].
// Returns the cudaError_t of the launches (0 on success).
int parasitoids_day_accumulate(const float* consts, const float* h,
                               const float* mu, const int32_t* idx, int T,
                               int K, int buf_len, float* scratch,
                               float* bsum, float* buf, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = build_smem_floats(K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_build_kernel<<<T, kBuildThreads, smem, s>>>(consts, h, mu, K,
                                                    scratch, bsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (buf_len + kTile - 1) / kTile;
  gather_kernel<<<dim3(tiles, tiles), dim3(kTile, kGatherRows), 0, s>>>(
      scratch, idx, T, 2 * K + 1, buf_len, buf);
  return (int)cudaGetLastError();
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
