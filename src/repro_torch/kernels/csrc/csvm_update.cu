// CSVM update kernels for Hopper (sm_90a): the deCSVM ADMM update (7a'),
// its dense W@B neighbour sums, the dual update (7b) and the KKT stop
// statistic.  Plain C interface, bound with ctypes by
// src/repro_torch/kernels/ops.py; built by src/repro_torch/kernels/build.py.
//
// What each kernel replaces (the Pallas TPU kernels of the JAX package):
//   csvm_local_update  <- repro/kernels/csvm_update.py:csvm_local_update
//                         (_margin_weights_kernel + _grad_update_kernel)
//   csvm_block_update  <- repro/kernels/csvm_update.py:csvm_block_update
//                         (_block_update_kernel)
//   csvm_round_block   <- repro/kernels/csvm_update.py:csvm_round_block
//                         (_round_megakernel)
//
// What bounds them on an H100: the chain margin -> weight -> X^T w -> prox
// does 4 flops per element of X per round (2 for the margin dot, 2 for
// X^T w): ~1 flop per byte of fp32 X and ~2 of bf16, far below the card's
// ~20 (fp32) and ~295 (bf16 tensor) flops/byte ridges.  Each node's work is
// two matrix-vector products, so tensor cores buy nothing: the kernels are
// bound by the bytes of X read from device memory.  At the main path's size
// X is 256 MiB fp32 (128 MiB bf16), more than the 50 MB L2 and the ~113 MB
// of all on-chip storage, so every round must read X from device memory at
// least once: that floor, not the guide's one read per launch, is the one
// a round kernel can reach.
//
// The two-launch update (csvm_block_update, csvm_local_update) is one
// round of that chain with the neighbour term as an operand: its floor is
// one read of X an update (at X (16, 1024, 4096) fp32, 256 MiB: 0.080 ms
// at 3.35 TB/s).  ops.two_pass_instance picks one of two instances from
// the shapes and X's base:
//
//   update_stream_kernel + update_reduce_kernel ("stream", p <= 8192 and
//     X's base 16-byte aligned): one read of X.  Launch 1 is one X pass of
//     the round kernel's stream instance (below) on an ordinary grid, one
//     block per SM (512 threads, ~195 KB of ring): whole-row tiles through
//     the TMA ring, the margins, w and acc += w x from the same tile, one
//     partial X^T w row per node segment of the block's range into scratch
//     (at most grid + m - 1 rows, which stay in L2).  Launch 2, one thread
//     per (node, column), sums the node's partial rows in block order and
//     applies z and the prox.  No grid barrier, so no co-resident grid is
//     needed; no atomics.
//   margins_kernel + update_kernel ("direct", any p and base): one thread
//     block = 256 threads (8 warps).  Margins are one warp per row of X (a
//     warp reduction over p); X^T w and the prox are one thread per (node,
//     column), looping over the node's rows (coalesced across the warp's
//     neighbouring columns), so X is read twice, the second time as a
//     chain of n strided loads a thread (bound by latency as well as
//     bytes).
//
// The ragged edges of n, p and m are masked, never padded.  bf16 mode (X
// stored bf16): B (or beta_bar) and w are rounded to bf16 before each dot,
// exactly where the JAX kernels cast with .astype(cd); every product and
// sum is fp32.
//
// csvm_round_block has two instances, both persistent cooperative kernels
// (the grid is co-resident and runs every round of the launch, with
// cooperative_groups grid.sync() between phases).  ops.round_block_instance
// picks one from the shapes alone:
//
//   round_stream_kernel ("stream", p <= kStreamConsumers * kMaxCols = 8192):
//     one read of X a round.  The m*n rows of X, flattened, are split into
//     one contiguous range per block (the partition comes from the wrapper;
//     a range may cross a node boundary).  Tiles of whole rows of one node
//     (one contiguous span each, ~64 KB) stream into a three-stage ring of
//     shared memory by 1-D TMA bulk copies (cp.async.bulk) that complete on
//     mbarriers.  The block's 512 threads own 16 columns each, holding the
//     node's rounded b and an fp32 X^T w accumulator for them in registers.
//     Per tile: partial row dots from shared memory (4 rows interleaved),
//     a block reduction in a fixed order, w = L_h'(y m) y / n, and
//     acc += round(w) x from the SAME tile; at a node boundary and at the
//     end of its range a block writes its partial X^T w row to scratch (at
//     most grid + m rows, which stay in L2).  One thread issues the copies:
//     the block barrier inside each tile shows that every thread is done
//     with the previous tile, so its stage takes the tile kStages - 1
//     ahead (no producer warp: a 17th warp would cap the block at 96
//     registers a thread, and the consumers spilled).  Phase B, one thread
//     per (node, column): the node's partial rows summed in block order,
//     W@B once, the previous round's dual update folded in (P_r = P_{r-1}
//     + tau (deg B_r - W B_r)), the prox into the other B buffer and
//     max|dB|.  Two grid barriers and one W@B a round; the next pass's
//     first tiles are issued before the barriers and land during them.
//     The KKT epilogue reads X once (an X pass at beta_bar, scale 1).
//   round_block_kernel ("direct", any p): three phases a round (margins;
//     X^T w + W@B + prox into the second B buffer; W@B+ + dual + max|dB|)
//     with plain loads, so X is read from device memory twice a round and
//     twice more by the KKT epilogue.  It takes the p the stream instance's
//     registers cannot hold.
//
// In both, held rounds (index >= *nact, read from the device) change
// nothing; the only atomic is atomicMax on the bits of a non-negative float
// (max is order independent), and every sum runs in a fixed order, so the
// results are the same from run to run.  No mbarrier wait can hang: a wait
// traps after 2^26 polls, which fails the launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Smoothing kernels, in the order of repro_torch.core.losses.KERNELS.
enum SmoothingKernel {
  kLaplacian = 0,
  kLogistic = 1,
  kGaussian = 2,
  kUniform = 3,
  kEpanechnikov = 4,
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An fp32 dot operand rounded to the compute type (the JAX kernels'
// .astype(cd)); round to nearest even, as XLA's convert does.
template <typename T>
__device__ __forceinline__ float round_cd(float x);
template <>
__device__ __forceinline__ float round_cd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_cd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// L_h'(v) = -F_K((1 - v) / h) for the five smoothing kernels
// (repro_torch/core/losses.py holds the same closed forms).
__device__ __forceinline__ float dloss(int kernel, float v, float h) {
  const float z = (1.0f - v) / h;
  switch (kernel) {
    case kLaplacian:
      return -(z < 0.0f ? 0.5f * expf(z) : 1.0f - 0.5f * expf(-z));
    case kLogistic:
      return -1.0f / (1.0f + expf(-z));
    case kGaussian:
      return -normcdff(z);
    case kUniform: {
      const float c = fminf(fmaxf(z, -1.0f), 1.0f);
      return -0.5f * (c + 1.0f);
    }
    default: {  // kEpanechnikov
      const float c = fminf(fmaxf(z, -1.0f), 1.0f);
      return -((2.0f + 3.0f * c) - c * c * c) / 4.0f;
    }
  }
}

// max that propagates NaN, like jnp.max.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// S_t(v) = sign(v) * max(|v| - t, 0), NaN-propagating like jnp.maximum.
__device__ __forceinline__ float soft_threshold(float v, float t) {
  const float d = fabsf(v) - t;
  const float a = (d > 0.0f || d != d) ? d : 0.0f;
  return v > 0.0f ? a : (v < 0.0f ? -a : v * a);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max over the block of non-negative values, then one atomicMax into *slot.
// Every thread of the block (kNumWarps warps) must call it.  Non-negative
// floats order like their int bits (a positive NaN sorts above +inf and so
// propagates).
template <int kNumWarps = kWarps>
__device__ void block_max_to(float v, float* slot) {
  __shared__ float part[kNumWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < kNumWarps ? part[lane] : 0.0f);
    if (lane == 0) atomicMax(reinterpret_cast<int*>(slot), __float_as_int(v));
  }
  __syncthreads();
}

// Row dot x . round(b) over p, by one warp; every lane gets the sum.
template <typename T>
__device__ __forceinline__ float row_dot(const T* __restrict__ x,
                                         const float* __restrict__ b, int p,
                                         int lane) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int j = lane;
  for (; j + 96 < p; j += 128) {
    a0 = fmaf(to_f32(x[j]), round_cd<T>(b[j]), a0);
    a1 = fmaf(to_f32(x[j + 32]), round_cd<T>(b[j + 32]), a1);
    a2 = fmaf(to_f32(x[j + 64]), round_cd<T>(b[j + 64]), a2);
    a3 = fmaf(to_f32(x[j + 96]), round_cd<T>(b[j + 96]), a3);
  }
  for (; j < p; j += 32) a0 = fmaf(to_f32(x[j]), round_cd<T>(b[j]), a0);
  return warp_sum((a0 + a1) + (a2 + a3));
}

// Column dot sum_i x[i * stride] * round(w[i]) over n rows, by one thread.
template <typename T>
__device__ __forceinline__ float col_dot(const T* __restrict__ x,
                                         size_t stride,
                                         const float* __restrict__ w, int n) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    a0 = fmaf(to_f32(x[(size_t)i * stride]), round_cd<T>(w[i]), a0);
    a1 = fmaf(to_f32(x[(size_t)(i + 1) * stride]), round_cd<T>(w[i + 1]), a1);
    a2 = fmaf(to_f32(x[(size_t)(i + 2) * stride]), round_cd<T>(w[i + 2]), a2);
    a3 = fmaf(to_f32(x[(size_t)(i + 3) * stride]), round_cd<T>(w[i + 3]), a3);
  }
  for (; i < n; ++i)
    a0 = fmaf(to_f32(x[(size_t)i * stride]), round_cd<T>(w[i]), a0);
  return (a0 + a1) + (a2 + a3);
}

template <typename T>
struct Args {
  const T* X;           // (m, n, p)
  const float* y;       // (m, n)
  const float* B0;      // (m, p) iterate in
  const float* P0;      // (m, p) duals in
  const float* neigh;   // (m, p) neighbour term (block/local update only)
  const float* W;       // (m, m) adjacency (round kernel only)
  const float* deg;     // (m,)
  const float* rho;     // (m,)
  const float* omega;   // (m,)
  const float* lam;     // (p,)
  const int* nact;      // active round count (round kernel only)
  float* Bout;          // (m, p)
  float* Pout;          // (m, p) (round kernel only)
  float* stat;          // (1,)   (round kernel only)
  float* w;             // (m, n) scratch: margin weights
  float* B2;            // (m, p) scratch: second B buffer, then KKT grads
  float* bbar;          // (p,)   scratch: beta_bar
  float* slots;         // (num_rounds + 2,) scratch: max|dB| per round,
                        //        then the KKT stationarity and consensus
  // stream instance only
  const int* plan;      // rows (grid + 1), seg0 (grid), node_seg (m + 1)
  float* part;          // (nseg, p) scratch: partial X^T w rows
  int tile_rows, stage_bytes;
  int m, n, p, num_rounds, want_kkt, kernel;
  float tau, lam0, h, inv_n, inv_m, kkt_scale;
};

// w[l, i] = L_h'(y m) y * scale with m = x_li . round(b_l); one warp.
template <typename T>
__device__ __forceinline__ void margin_row(const Args<T>& a, long row,
                                           const float* __restrict__ b,
                                           float scale, int lane) {
  const float acc = row_dot<T>(a.X + (size_t)row * a.p, b, a.p, lane);
  if (lane == 0) {
    const float yy = a.y[row];
    a.w[row] = dloss(a.kernel, yy * acc, a.h) * yy * scale;
  }
}

// B+[l, j] = S_{lam_j omega_l}(omega_l (rho_l b - (X^T w)_j - p + neigh)).
template <typename T>
__device__ __forceinline__ float prox_update(const Args<T>& a, int l, int j,
                                             float b, float pd, float nb) {
  const float g = col_dot<T>(a.X + (size_t)l * a.n * a.p + j, (size_t)a.p,
                             a.w + (size_t)l * a.n, a.n);
  const float z = a.rho[l] * b - g - pd + nb;
  return soft_threshold(a.omega[l] * z, a.lam[j] * a.omega[l]);
}

// (W B)[l, j] over the m nodes, in a fixed order.
__device__ __forceinline__ float neighbour_sum(const float* __restrict__ W,
                                               const float* __restrict__ B,
                                               int m, int p, int l, int j) {
  float s = 0.0f;
  for (int k = 0; k < m; ++k) s = fmaf(W[(size_t)l * m + k], B[(size_t)k * p + j], s);
  return s;
}

// The same with four partial sums over k mod 4, so that the loads of B's
// column overlap: for the stream instance's phase B, one element a thread.
// (In the direct instance, whose threads loop over several elements, it
// made the launch slower on an H100, so that one keeps the plain sum.)
__device__ __forceinline__ float neighbour_sum4(const float* __restrict__ W,
                                                const float* __restrict__ B,
                                                int m, int p, int l, int j) {
  const float* w = W + (size_t)l * m;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int k = 0;
  for (; k + 4 <= m; k += 4) {
    s0 = fmaf(w[k], B[(size_t)k * p + j], s0);
    s1 = fmaf(w[k + 1], B[(size_t)(k + 1) * p + j], s1);
    s2 = fmaf(w[k + 2], B[(size_t)(k + 2) * p + j], s2);
    s3 = fmaf(w[k + 3], B[(size_t)(k + 3) * p + j], s3);
  }
  for (; k < m; ++k) s0 = fmaf(w[k], B[(size_t)k * p + j], s0);
  return (s0 + s1) + (s2 + s3);
}

// ---------------------------------------------------------------------------
// Two-launch update (csvm_block_update, csvm_local_update), direct instance
// ---------------------------------------------------------------------------

// Grid (ceil(n / 8), m): one warp per row of node blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads) margins_kernel(Args<T> a) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= a.n) return;  // warp-uniform
  margin_row<T>(a, (long)l * a.n + i, a.B0 + (size_t)l * a.p, a.inv_n,
                threadIdx.x & 31);
}

// Grid (ceil(p / 256), m): one thread per column of node blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads) update_kernel(Args<T> a) {
  const int l = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.p) return;
  const size_t e = (size_t)l * a.p + j;
  a.Bout[e] = prox_update<T>(a, l, j, a.B0[e], a.P0[e], a.neigh[e]);
}

template <typename T>
cudaError_t launch_two_pass(const Args<T>& a, cudaStream_t stream) {
  if (a.m < 1 || a.n < 1 || a.p < 1 || a.m > 65535) return cudaErrorInvalidValue;
  const dim3 g1((a.n + kWarps - 1) / kWarps, a.m);
  const dim3 g2((a.p + kThreads - 1) / kThreads, a.m);
  margins_kernel<T><<<g1, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  update_kernel<T><<<g2, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Round kernel (csvm_round_block): persistent, cooperative
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) round_block_kernel(Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  const long tid = (long)blockIdx.x * kThreads + threadIdx.x;
  const long nthreads = (long)gridDim.x * kThreads;
  const long warp_id = tid >> 5;
  const long nwarps = nthreads >> 5;
  const int lane = threadIdx.x & 31;
  const long mn = (long)a.m * a.n;
  const long mp = (long)a.m * a.p;
  const int nact = min(max(*a.nact, 0), a.num_rounds);  // grid-uniform

  for (long e = tid; e < mp; e += nthreads) {
    a.Bout[e] = a.B0[e];
    a.Pout[e] = a.P0[e];
  }
  for (long e = tid; e < a.num_rounds + 2; e += nthreads) a.slots[e] = 0.0f;
  grid.sync();

  for (int r = 0; r < a.num_rounds; ++r) {
    // Double buffer by round parity: round r reads Bc and writes Bn.
    const bool active = r < nact;
    const float* Bc = (r & 1) ? a.B2 : a.Bout;
    float* Bn = (r & 1) ? a.Bout : a.B2;
    // Phase 1: margins and weights, one warp per (node, row).
    if (active)
      for (long row = warp_id; row < mn; row += nwarps)
        margin_row<T>(a, row, Bc + (size_t)(row / a.n) * a.p, a.inv_n, lane);
    grid.sync();
    // Phase 2: X^T w, W@B, z and the prox into the other buffer.
    if (active)
      for (long e = tid; e < mp; e += nthreads) {
        const int l = (int)(e / a.p), j = (int)(e % a.p);
        const float b = Bc[e];
        const float wb = neighbour_sum(a.W, Bc, a.m, a.p, l, j);
        Bn[e] = prox_update<T>(a, l, j, b, a.Pout[e],
                               a.tau * (a.deg[l] * b + wb));
      }
    grid.sync();
    // Phase 3: W@B+, the dual update and max|B+ - B|.
    if (active) {
      float d = 0.0f;
      for (long e = tid; e < mp; e += nthreads) {
        const int l = (int)(e / a.p), j = (int)(e % a.p);
        const float bn = Bn[e];
        const float wbn = neighbour_sum(a.W, Bn, a.m, a.p, l, j);
        a.Pout[e] = a.Pout[e] + a.tau * (a.deg[l] * bn - wbn);
        d = nan_max(d, fabsf(bn - Bc[e]));
      }
      block_max_to(d, a.slots + r);
    }
    grid.sync();
  }
  // After nact active rounds the iterate sits in buffer nact & 1.
  if (nact & 1) {
    for (long e = tid; e < mp; e += nthreads) a.Bout[e] = a.B2[e];
    grid.sync();
  }

  if (!a.want_kkt) {
    if (tid == 0) *a.stat = nact > 0 ? a.slots[nact - 1] : INFINITY;
    return;
  }
  // KKT epilogue at beta_bar (solver.kkt_residual): column means and the
  // consensus max; margins at beta_bar; per-node X^T w into B2; then the
  // network gradient, the prox and the stationarity max.
  float* stat_slot = a.slots + a.num_rounds;
  float* cons_slot = stat_slot + 1;
  {
    float c = 0.0f;
    for (long j = tid; j < a.p; j += nthreads) {
      float s = 0.0f;
      for (int l = 0; l < a.m; ++l) s += a.Bout[(size_t)l * a.p + j];
      const float bb = s * a.inv_m;
      a.bbar[j] = bb;
      for (int l = 0; l < a.m; ++l)
        c = nan_max(c, fabsf(a.Bout[(size_t)l * a.p + j] - bb));
    }
    block_max_to(c, cons_slot);
  }
  grid.sync();
  for (long row = warp_id; row < mn; row += nwarps)
    margin_row<T>(a, row, a.bbar, 1.0f, lane);
  grid.sync();
  for (long e = tid; e < mp; e += nthreads) {
    const int l = (int)(e / a.p), j = (int)(e % a.p);
    a.B2[e] = col_dot<T>(a.X + (size_t)l * a.n * a.p + j, (size_t)a.p,
                         a.w + (size_t)l * a.n, a.n);
  }
  grid.sync();
  {
    float s_max = 0.0f;
    for (long j = tid; j < a.p; j += nthreads) {
      float g = 0.0f;
      for (int l = 0; l < a.m; ++l) g += a.B2[(size_t)l * a.p + j];
      g = g * a.kkt_scale;
      const float bb = a.bbar[j];
      g = g + a.lam0 * bb;
      const float prox = soft_threshold(bb - g, a.lam[j]);
      s_max = nan_max(s_max, fabsf(bb - prox));
    }
    block_max_to(s_max, stat_slot);
  }
  grid.sync();
  if (tid == 0) *a.stat = nan_max(*stat_slot, *cons_slot);
}

template <typename T>
cudaError_t round_block_occupancy(int* blocks_per_sm, int* num_sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!coop) {
    *blocks_per_sm = 0;
    return cudaSuccess;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, round_block_kernel<T>, kThreads, 0);
}

template <typename T>
cudaError_t launch_round_block(const Args<T>& a, cudaStream_t stream) {
  if (a.m < 1 || a.n < 1 || a.p < 1 || a.num_rounds < 1)
    return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = round_block_occupancy<T>(&per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long mn = (long)a.m * a.n, mp = (long)a.m * a.p;
  long work = (mn + kWarps - 1) / kWarps;
  work = work > (mp + kThreads - 1) / kThreads ? work : (mp + kThreads - 1) / kThreads;
  const long cap = (long)per_sm * sms;
  const int grid = (int)(work < cap ? work : cap);
  Args<T> copy = a;
  void* params[] = {&copy};
  return cudaLaunchCooperativeKernel((const void*)round_block_kernel<T>,
                                     dim3(grid), dim3(kThreads), params, 0,
                                     stream);
}

// ---------------------------------------------------------------------------
// Round kernel, stream instance: one read of X a round
// ---------------------------------------------------------------------------

constexpr int kStreamConsumers = 512;  // 16 warps, all consumers
constexpr int kConsumerWarps = kStreamConsumers / 32;
constexpr int kStreamThreads = kStreamConsumers;
constexpr int kStreamWarps = kStreamThreads / 32;
// The thread that issues the bulk copies: in the last warp, so that it
// works beside the threads of warp 0 that compute a tile's weights.
constexpr int kIssuer = kStreamThreads - 1;
constexpr int kStages = 3;                             // the ring of X tiles
constexpr int kMaxTileRows = 32;
constexpr int kMaxCols = 16;         // columns a consumer thread holds
constexpr int kRowChunk = 4;         // rows whose dots run interleaved
// Shared memory after the ring (ops.py _STREAM_FIXED_BYTES): the 2 kStages
// mbarriers, the per-warp row sums, the row weights and 128 bytes of slack
// to align the ring.
constexpr int kBarBytes = 128;
constexpr int kStreamFixedBytes =
    kBarBytes + kMaxTileRows * kConsumerWarps * 4 + kMaxTileRows * 4 + 128;
static_assert(2 * kStages * 8 <= kBarBytes, "mbarriers");

// Elements of T in one 16-byte shared-memory load.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.  A
// wait that lasts seconds means an arrival was lost: the kernel traps (the
// launch fails with an error) instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// One contiguous span of device memory into shared memory by the TMA (a
// 1-D bulk copy; both addresses and the size multiples of 16 bytes);
// completion, in bytes, is reported to `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// kN consecutive elements of a tile at element offset `off`: one 16-byte
// load where rows are 16-byte aligned (p a multiple of kN), else kN scalar
// loads of which the first `valid` are real (the ragged end of p).
__device__ __forceinline__ void load_group(const float* s, int off,
                                           bool aligned, int valid,
                                           float (&x)[4]) {
  if (aligned) {
    const float4 v = *reinterpret_cast<const float4*>(s + off);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
    return;
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) x[v] = v < valid ? s[off + v] : 0.0f;
}

__device__ __forceinline__ void load_group(const __nv_bfloat16* s, int off,
                                           bool aligned, int valid,
                                           float (&x)[8]) {
  if (aligned) {
    // a bf16 widens exactly to the fp32 with its bits on top
    const uint4 u = *reinterpret_cast<const uint4*>(s + off);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int v = 0; v < 8; ++v)
    x[v] = v < valid ? __bfloat162float(s[off + v]) : 0.0f;
}

struct StreamSmem {
  unsigned char* ring;  // kStages stages of stage_bytes
  uint32_t ring_addr;
  uint32_t full;         // kStages mbarriers, 8 bytes apart
  float* red;            // [kMaxTileRows][kConsumerWarps] row-dot parts
  float* wrow;           // [kMaxTileRows] the tile's rounded weights
};

// End of the tile that starts at `row`: at most tile_rows rows, all of one
// node, inside the block's range.
__device__ __forceinline__ int tile_end(int row, int row_end, int n,
                                        int tile_rows) {
  return min(min(row + tile_rows, row_end), (row / n + 1) * n);
}

// The issuer thread issues the block's tiles in order, wrapping from the
// end of its range to the start (the next X pass), until `issued` reaches
// `target`.
// The caller guarantees that every thread is done with the tile that last
// used each stage it refills.
template <typename T>
__device__ __forceinline__ void stream_issue(const Args<T>& a,
                                             const StreamSmem& sm,
                                             int row_begin, int row_end,
                                             uint32_t target,
                                             uint32_t& issued, int& cursor) {
  const unsigned char* xg = reinterpret_cast<const unsigned char*>(a.X);
  const size_t row_bytes = (size_t)a.p * sizeof(T);
  const size_t total16 = ((size_t)a.m * a.n * row_bytes) & ~(size_t)15;
  while (issued < target) {
    const int row = cursor;
    const int end = tile_end(row, row_end, a.n, a.tile_rows);
    cursor = end == row_end ? row_begin : end;
    const int slot = issued % kStages;
    // the span [a0, a1) holds the tile, from the 16-byte boundary at or
    // below its start; bytes past X's last 16-byte boundary (only at the
    // end of X) are copied by hand and made visible by the arrive
    const size_t sb = (size_t)row * row_bytes, eb = (size_t)end * row_bytes;
    const size_t a0 = sb & ~(size_t)15;
    const size_t up = (eb + 15) & ~(size_t)15;
    const size_t a1 = up < total16 ? up : total16;
    unsigned char* dst = sm.ring + (size_t)slot * a.stage_bytes;
    for (size_t o = sb > total16 ? sb : total16; o < eb; ++o)
      dst[o - a0] = xg[o];
    const uint32_t bytes = a1 > a0 ? (uint32_t)(a1 - a0) : 0u;
    const uint32_t full = sm.full + 8 * slot;
    mbar_expect_tx(full, bytes);
    if (bytes)
      bulk_load(sm.ring_addr + (uint32_t)slot * a.stage_bytes, xg + a0, bytes,
                full);
    ++issued;
  }
}

// The block's 512 threads: one X pass over the block's rows with b_l =
// round(bsrc[l * bstride, :]).  Thread t owns the column groups t + 512 g
// (kN columns each); per tile the row dots go through shared memory in a
// fixed order, w = round(L_h'(y m) y scale), and acc += w x from the same
// tile.  Each node segment of the range ends with its partial X^T w row in
// a.part[seg], seg counting up from the block's first segment.
template <typename T>
__device__ __forceinline__ void stream_consume(const Args<T>& a,
                                               const StreamSmem& sm,
                                               int row_begin, int row_end,
                                               int seg,
                                               const float* __restrict__ bsrc,
                                               size_t bstride, float scale,
                                               uint32_t& consumed,
                                               uint32_t total,
                                               uint32_t& issued,
                                               int& cursor) {
  constexpr int V = Vec<T>::kN;
  constexpr int NG = kMaxCols / V;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int p = a.p;
  const int ngroups = (p + V - 1) / V;
  const bool aligned = p % V == 0;
  const size_t row_bytes = (size_t)p * sizeof(T);
  float bv[NG][V], acc[NG][V];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[g][v] = bv[g][v] = 0.0f;
  int node = -1;
  for (int row = row_begin; row < row_end;) {
    const int l = row / a.n;
    const int end = tile_end(row, row_end, a.n, a.tile_rows);
    const int nr = end - row;
    if (l != node) {
      node = l;
      const float* b = bsrc + (size_t)l * bstride;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c0 = (t + kStreamConsumers * g) * V;
#pragma unroll
        for (int v = 0; v < V; ++v)
          bv[g][v] = c0 + v < p ? round_cd<T>(b[c0 + v]) : 0.0f;
      }
    }
    // the row labels, loaded before the tile's sums need them
    const float yv = t < nr ? a.y[row + t] : 0.0f;
    const int slot = consumed % kStages;
    mbar_wait(sm.full + 8 * slot, (consumed / kStages) & 1);
    const T* xs = reinterpret_cast<const T*>(sm.ring +
                                             (size_t)slot * a.stage_bytes);
    const int lead = (int)((((size_t)row * row_bytes) & 15) / sizeof(T));
    // margins, kRowChunk rows at a time (independent chains): this
    // thread's share of each row dot, the warp's sum, then (below) the 16
    // warps' sums in order
    for (int r0 = 0; r0 < nr; r0 += kRowChunk) {
      float s[kRowChunk];
#pragma unroll
      for (int k = 0; k < kRowChunk; ++k) s[k] = 0.0f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int q = t + kStreamConsumers * g;
        if (q < ngroups) {
#pragma unroll
          for (int k = 0; k < kRowChunk; ++k) {
            if (r0 + k < nr) {
              float x[V];
              load_group(xs, lead + (r0 + k) * p + q * V, aligned, p - q * V,
                         x);
#pragma unroll
              for (int v = 0; v < V; ++v) s[k] = fmaf(x[v], bv[g][v], s[k]);
            }
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < kRowChunk; ++k)
          s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
      if (lane == 0)
#pragma unroll
        for (int k = 0; k < kRowChunk; ++k)
          if (r0 + k < nr) sm.red[(r0 + k) * kConsumerWarps + warp] = s[k];
    }
    __syncthreads();
    // every thread is done with the previous tile: its stage takes the tile
    // kStages - 1 ahead of this one
    if (t == kIssuer)
      stream_issue<T>(a, sm, row_begin, row_end,
                      min(consumed + kStages, total), issued, cursor);
    if (t < nr) {
      float mg = 0.0f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w)
        mg += sm.red[t * kConsumerWarps + w];
      sm.wrow[t] = round_cd<T>(dloss(a.kernel, yv * mg, a.h) * yv * scale);
    }
    __syncthreads();
    // X^T w from the same tile
    for (int r0 = 0; r0 < nr; r0 += kRowChunk) {
#pragma unroll
      for (int k = 0; k < kRowChunk; ++k) {
        if (r0 + k < nr) {
          const float wr = sm.wrow[r0 + k];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int q = t + kStreamConsumers * g;
            if (q < ngroups) {
              float x[V];
              load_group(xs, lead + (r0 + k) * p + q * V, aligned, p - q * V,
                         x);
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[g][v] = fmaf(x[v], wr, acc[g][v]);
            }
          }
        }
      }
    }
    ++consumed;
    row = end;
    if (row == row_end || row == (l + 1) * a.n) {
      float* dst = a.part + (size_t)seg * p;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c0 = (t + kStreamConsumers * g) * V;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (c0 + v < p) dst[c0 + v] = acc[g][v];
          acc[g][v] = 0.0f;
        }
      }
      ++seg;
    }
  }
}

// The stream instances' dynamic shared memory: the ring from the first
// 128-byte boundary, then its mbarriers, the row sums and the row weights.
__device__ __forceinline__ StreamSmem stream_layout(unsigned char* base,
                                                    int stage_bytes) {
  StreamSmem sm;
  const uint32_t raw = smem_u32(base);
  const uint32_t pad = (128u - (raw & 127u)) & 127u;
  const uint32_t ring_bytes = kStages * (uint32_t)stage_bytes;
  sm.ring = base + pad;
  sm.ring_addr = raw + pad;
  sm.full = sm.ring_addr + ring_bytes;
  sm.red = reinterpret_cast<float*>(sm.ring + ring_bytes + kBarBytes);
  sm.wrow = sm.red + kMaxTileRows * kConsumerWarps;
  return sm;
}

// The issuer thread's start of a launch: the ring's mbarriers, the count of
// the block's tiles over `passes` X passes (returned), and the first
// kStages of them issued.
template <typename T>
__device__ __forceinline__ uint32_t stream_start(const Args<T>& a,
                                                 const StreamSmem& sm,
                                                 int row_begin, int row_end,
                                                 uint32_t passes,
                                                 uint32_t& issued,
                                                 int& cursor) {
  for (int st = 0; st < kStages; ++st) mbar_init(sm.full + 8 * st, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  uint32_t total = 0;
  for (int row = row_begin; row < row_end;
       row = tile_end(row, row_end, a.n, a.tile_rows))
    ++total;
  total *= passes;
  stream_issue<T>(a, sm, row_begin, row_end, min((uint32_t)kStages, total),
                  issued, cursor);
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kStreamThreads, 1)
    round_stream_kernel(Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char stream_smem[];
  const StreamSmem sm = stream_layout(stream_smem, a.stage_bytes);
  const long tid = (long)blockIdx.x * kStreamThreads + threadIdx.x;
  const long nthreads = (long)gridDim.x * kStreamThreads;
  const long mp = (long)a.m * a.p;
  const int nact = min(max(*a.nact, 0), a.num_rounds);  // grid-uniform
  const int* rows = a.plan;
  const int* seg0 = rows + gridDim.x + 1;
  const int* node_seg = seg0 + gridDim.x;
  const int row_begin = rows[blockIdx.x], row_end = rows[blockIdx.x + 1];
  // X passes of the launch: one per active round, then the KKT pass; the
  // block's tiles in them (the issuer issues them all, in order)
  const uint32_t passes = nact + (a.want_kkt ? 1 : 0);
  uint32_t total = 0, issued = 0, consumed = 0;
  int cursor = row_begin;
  if (threadIdx.x == kIssuer)
    total = stream_start<T>(a, sm, row_begin, row_end, passes, issued,
                            cursor);
  __syncthreads();

  for (long e = tid; e < mp; e += nthreads) {
    a.Bout[e] = a.B0[e];
    a.Pout[e] = a.P0[e];
  }
  for (long e = tid; e < a.num_rounds + 2; e += nthreads) a.slots[e] = 0.0f;
  grid.sync();

  // One X pass; then the next pass's first kStages tiles are issued, to
  // land while the grid syncs and runs phase B.
  auto x_pass = [&](const float* bsrc, size_t bstride, float scale) {
    stream_consume<T>(a, sm, row_begin, row_end, seg0[blockIdx.x], bsrc,
                      bstride, scale, consumed, total, issued, cursor);
    __syncthreads();
    if (threadIdx.x == kIssuer)
      stream_issue<T>(a, sm, row_begin, row_end,
                      min(consumed + kStages, total), issued, cursor);
    grid.sync();
  };

  for (int r = 0; r < nact; ++r) {
    // Double buffer by round parity: round r reads Bc and writes Bn.
    const float* Bc = (r & 1) ? a.B2 : a.Bout;
    float* Bn = (r & 1) ? a.Bout : a.B2;
    // Phase A: margins and partial X^T w rows from one read of X.
    x_pass(Bc, a.p, a.inv_n);
    // Phase B: the previous round's dual update, z, the prox, max|dB|.
    float d = 0.0f;
    for (long e = tid; e < mp; e += nthreads) {
      const int l = (int)(e / a.p), j = (int)(e % a.p);
      const float b = Bc[e];
      const float wb = neighbour_sum4(a.W, Bc, a.m, a.p, l, j);
      float pd = a.Pout[e];
      if (r > 0) {
        pd = pd + a.tau * (a.deg[l] * b - wb);
        a.Pout[e] = pd;
      }
      float g = 0.0f;
#pragma unroll 4
      for (int sg = node_seg[l]; sg < node_seg[l + 1]; ++sg)
        g += a.part[(size_t)sg * a.p + j];
      const float z = a.rho[l] * b - g - pd + a.tau * (a.deg[l] * b + wb);
      const float bn = soft_threshold(a.omega[l] * z, a.lam[j] * a.omega[l]);
      Bn[e] = bn;
      d = nan_max(d, fabsf(bn - b));
    }
    block_max_to<kStreamWarps>(d, a.slots + r);
    grid.sync();
  }
  // The last active round's dual update; the iterate into Bout.
  if (nact > 0) {
    const float* Bf = (nact & 1) ? a.B2 : a.Bout;
    for (long e = tid; e < mp; e += nthreads) {
      const int l = (int)(e / a.p), j = (int)(e % a.p);
      const float b = Bf[e];
      const float wb = neighbour_sum4(a.W, Bf, a.m, a.p, l, j);
      a.Pout[e] = a.Pout[e] + a.tau * (a.deg[l] * b - wb);
      if (nact & 1) a.Bout[e] = b;
    }
    grid.sync();
  }

  if (!a.want_kkt) {
    if (tid == 0) *a.stat = nact > 0 ? a.slots[nact - 1] : INFINITY;
    return;
  }
  // KKT epilogue at beta_bar (solver.kkt_residual): column means and the
  // consensus max; one X pass at beta_bar (scale 1); then the network
  // gradient, the prox and the stationarity max.
  float* stat_slot = a.slots + a.num_rounds;
  float* cons_slot = stat_slot + 1;
  {
    float c = 0.0f;
    for (long j = tid; j < a.p; j += nthreads) {
      float s = 0.0f;
      for (int l = 0; l < a.m; ++l) s += a.Bout[(size_t)l * a.p + j];
      const float bb = s * a.inv_m;
      a.bbar[j] = bb;
      for (int l = 0; l < a.m; ++l)
        c = nan_max(c, fabsf(a.Bout[(size_t)l * a.p + j] - bb));
    }
    block_max_to<kStreamWarps>(c, cons_slot);
  }
  grid.sync();
  x_pass(a.bbar, 0, 1.0f);
  {
    const int nseg = node_seg[a.m];
    float s_max = 0.0f;
    for (long j = tid; j < a.p; j += nthreads) {
      float g = 0.0f;
#pragma unroll 8
      for (int sg = 0; sg < nseg; ++sg) g += a.part[(size_t)sg * a.p + j];
      g = g * a.kkt_scale;
      const float bb = a.bbar[j];
      g = g + a.lam0 * bb;
      const float prox = soft_threshold(bb - g, a.lam[j]);
      s_max = nan_max(s_max, fabsf(bb - prox));
    }
    block_max_to<kStreamWarps>(s_max, stat_slot);
  }
  grid.sync();
  if (tid == 0) *a.stat = nan_max(*stat_slot, *cons_slot);
}

template <typename T>
cudaError_t stream_occupancy(int smem_bytes, int* blocks_per_sm,
                             int* num_sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!coop) {
    *blocks_per_sm = 0;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute((const void*)round_stream_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, round_stream_kernel<T>, kStreamThreads, smem_bytes);
}

// The wrapper's plan and layout are checked against the kernel's limits;
// the grid must be co-resident.
// The wrapper's plan and ring layout against a stream kernel's limits.
template <typename T>
bool stream_layout_ok(const Args<T>& a, int grid, int smem_bytes) {
  const size_t row_bytes = (size_t)a.p * sizeof(T);
  return a.m >= 1 && a.n >= 1 && a.p >= 1 && grid >= 1 &&
         (long)a.m * a.n <= INT_MAX && grid <= (long)a.m * a.n &&
         a.p <= kStreamConsumers * kMaxCols && a.tile_rows >= 1 &&
         a.tile_rows <= kMaxTileRows && a.stage_bytes % 128 == 0 &&
         (size_t)a.stage_bytes >= a.tile_rows * row_bytes + 32 &&
         smem_bytes >= kStages * a.stage_bytes + kStreamFixedBytes &&
         reinterpret_cast<uintptr_t>(a.X) % 16 == 0;
}

template <typename T>
cudaError_t launch_round_stream(const Args<T>& a, int grid, int smem_bytes,
                                cudaStream_t stream) {
  if (a.num_rounds < 1 || !stream_layout_ok(a, grid, smem_bytes))
    return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = stream_occupancy<T>(smem_bytes, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || grid > per_sm * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  Args<T> copy = a;
  void* params[] = {&copy};
  return cudaLaunchCooperativeKernel((const void*)round_stream_kernel<T>,
                                     dim3(grid), dim3(kStreamThreads), params,
                                     smem_bytes, stream);
}

// ---------------------------------------------------------------------------
// Two-launch update, stream instance: one read of X an update
// ---------------------------------------------------------------------------

// Launch 1: one X pass over the block's rows of the wrapper's plan at
// b_l = round(B[l]) and scale 1/n, as a round of round_stream_kernel runs
// it; each node segment of the range leaves its partial X^T w row in
// a.part.  Not cooperative: there is no grid barrier.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads, 1)
    update_stream_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char stream_smem[];
  const StreamSmem sm = stream_layout(stream_smem, a.stage_bytes);
  const int* rows = a.plan;
  const int* seg0 = rows + gridDim.x + 1;
  const int row_begin = rows[blockIdx.x], row_end = rows[blockIdx.x + 1];
  uint32_t total = 0, issued = 0, consumed = 0;
  int cursor = row_begin;
  if (threadIdx.x == kIssuer)
    total = stream_start<T>(a, sm, row_begin, row_end, 1, issued, cursor);
  __syncthreads();
  stream_consume<T>(a, sm, row_begin, row_end, seg0[blockIdx.x], a.B0, a.p,
                    a.inv_n, consumed, total, issued, cursor);
}

// Launch 2, one thread per (node, column): the node's partial rows summed
// in block order (as round_stream_kernel's phase B sums them), then z and
// the prox of prox_update with the caller's P and neighbour term.
__global__ void __launch_bounds__(kThreads)
    update_reduce_kernel(const float* __restrict__ part,
                         const int* __restrict__ node_seg,
                         const float* __restrict__ B,
                         const float* __restrict__ P,
                         const float* __restrict__ neigh,
                         const float* __restrict__ rho,
                         const float* __restrict__ omega,
                         const float* __restrict__ lam,
                         float* __restrict__ out, int m, int p) {
  const long e = (long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long)m * p) return;
  const int l = (int)(e / p), j = (int)(e % p);
  float g = 0.0f;
#pragma unroll 4
  for (int sg = node_seg[l]; sg < node_seg[l + 1]; ++sg)
    g += part[(size_t)sg * p + j];
  const float z = rho[l] * B[e] - g - P[e] + neigh[e];
  out[e] = soft_threshold(omega[l] * z, lam[j] * omega[l]);
}

// update_stream_kernel<T>'s dynamic shared memory limit, raised to the
// largest a stream block may ask for once per device (the attribute is per
// device), so that a launch sets no attribute.
constexpr int kStreamSmemMax = 232448 - 1024;
constexpr int kMaxDevices = 64;

template <typename T>
cudaError_t allow_update_smem() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute((const void*)update_stream_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStreamSmemMax);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T>
cudaError_t update_stream_occupancy(int smem_bytes, int* blocks_per_sm,
                                    int* num_sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = allow_update_smem<T>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, update_stream_kernel<T>, kStreamThreads, smem_bytes);
}

// a.part holds node_seg[m] rows of p floats; the plan is int32 rows
// (grid + 1), seg0 (grid), node_seg (m + 1).
template <typename T>
cudaError_t launch_two_pass_stream(const Args<T>& a, int grid, int smem_bytes,
                                   cudaStream_t stream) {
  if (!stream_layout_ok(a, grid, smem_bytes) || smem_bytes > kStreamSmemMax)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_update_smem<T>();
  if (err != cudaSuccess) return err;
  update_stream_kernel<T><<<grid, kStreamThreads, smem_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long mp = (long)a.m * a.p;
  update_reduce_kernel<<<(unsigned)((mp + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(a.part, a.plan + 2 * grid + 1, a.B0,
                                      a.P0, a.neigh, a.rho, a.omega, a.lam,
                                      a.Bout, a.m, a.p);
  return cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* X, const void* y, const void* B, const void* P,
                  int m, int n, int p, float h, int kernel, float inv_n) {
  Args<T> a = {};
  a.X = static_cast<const T*>(X);
  a.y = static_cast<const float*>(y);
  a.B0 = static_cast<const float*>(B);
  a.P0 = static_cast<const float*>(P);
  a.m = m;
  a.n = n;
  a.p = p;
  a.h = h;
  a.kernel = kernel;
  a.inv_n = inv_n;
  return a;
}

template <typename T>
int two_pass(const void* X, const void* y, const void* B, const void* P,
             const void* neigh, const void* rho, const void* omega,
             const void* lam, void* w, void* out, int m, int n, int p,
             float h, int kernel, float inv_n, void* stream) {
  Args<T> a = make_args<T>(X, y, B, P, m, n, p, h, kernel, inv_n);
  a.neigh = static_cast<const float*>(neigh);
  a.rho = static_cast<const float*>(rho);
  a.omega = static_cast<const float*>(omega);
  a.lam = static_cast<const float*>(lam);
  a.w = static_cast<float*>(w);
  a.Bout = static_cast<float*>(out);
  return (int)launch_two_pass<T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` and returns the cudaError_t of
// the launch (0 on success); none synchronizes or allocates.

// B+ for a stacked (m, n, p) block, X fp32 (x_bf16 = 0) or bf16.  w is an
// (m, n) fp32 scratch buffer; out is (m, p) fp32.
int csvm_block_update(const void* X, int x_bf16, const void* y, const void* B,
                      const void* P, const void* neigh, const void* rho,
                      const void* omega, const void* lam, void* w, void* out,
                      int m, int n, int p, float h, int kernel, float inv_n,
                      void* stream) {
  if (x_bf16)
    return two_pass<__nv_bfloat16>(X, y, B, P, neigh, rho, omega, lam, w, out,
                                   m, n, p, h, kernel, inv_n, stream);
  return two_pass<float>(X, y, B, P, neigh, rho, omega, lam, w, out, m, n, p,
                         h, kernel, inv_n, stream);
}

// The per-node update of the "pallas" backend, nodes as a grid axis; X is
// fp32.  Same kernels as csvm_block_update, its own entry point.
int csvm_local_update(const void* X, const void* y, const void* B,
                      const void* P, const void* neigh, const void* rho,
                      const void* omega, const void* lam, void* w, void* out,
                      int m, int n, int p, float h, int kernel, float inv_n,
                      void* stream) {
  return two_pass<float>(X, y, B, P, neigh, rho, omega, lam, w, out, m, n, p,
                         h, kernel, inv_n, stream);
}

// The stream instance of both two-pass updates (one read of X): the same
// operands, plus part (node_seg[m] * p floats of scratch, the partial X^T w
// rows), the wrapper's plan (as for csvm_round_stream), the grid, the tile
// rows, the stage size and the dynamic shared memory.  Two launches, no
// cooperative grid.
int csvm_two_pass_stream(const void* X, int x_bf16, const void* y,
                         const void* B, const void* P, const void* neigh,
                         const void* rho, const void* omega, const void* lam,
                         void* part, const void* plan, void* out, int m,
                         int n, int p, int grid, int tile_rows,
                         int stage_bytes, int smem_bytes, float h, int kernel,
                         float inv_n, void* stream) {
#define CSVM_FILL_UPDATE(a)                           \
  (a).neigh = static_cast<const float*>(neigh);       \
  (a).rho = static_cast<const float*>(rho);           \
  (a).omega = static_cast<const float*>(omega);       \
  (a).lam = static_cast<const float*>(lam);           \
  (a).Bout = static_cast<float*>(out);                \
  (a).part = static_cast<float*>(part);               \
  (a).plan = static_cast<const int*>(plan);           \
  (a).tile_rows = tile_rows;                          \
  (a).stage_bytes = stage_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    Args<__nv_bfloat16> a =
        make_args<__nv_bfloat16>(X, y, B, P, m, n, p, h, kernel, inv_n);
    CSVM_FILL_UPDATE(a)
    return (int)launch_two_pass_stream(a, grid, smem_bytes, st);
  }
  Args<float> a = make_args<float>(X, y, B, P, m, n, p, h, kernel, inv_n);
  CSVM_FILL_UPDATE(a)
#undef CSVM_FILL_UPDATE
  return (int)launch_two_pass_stream(a, grid, smem_bytes, st);
}

// Resident blocks per SM of the two-pass stream kernel at `smem_bytes` of
// dynamic shared memory (an ordinary launch), and the SM count.
int csvm_two_pass_stream_occupancy(int x_bf16, int smem_bytes,
                                   int* blocks_per_sm, int* num_sms) {
  if (x_bf16)
    return (int)update_stream_occupancy<__nv_bfloat16>(smem_bytes,
                                                       blocks_per_sm, num_sms);
  return (int)update_stream_occupancy<float>(smem_bytes, blocks_per_sm,
                                             num_sms);
}

// num_rounds rounds of the whole network in one cooperative launch.
// scratch holds m*n + m*p + p + num_rounds + 2 floats (w, B2, bbar, slots).
int csvm_round_block(const void* X, int x_bf16, const void* y, const void* B0,
                     const void* P0, const void* W, const void* deg,
                     const void* rho, const void* omega, const void* lam,
                     const void* nact, void* Bout, void* Pout, void* stat,
                     void* scratch, int m, int n, int p, int num_rounds,
                     int want_kkt, float tau, float lam0, float h, int kernel,
                     float inv_n, float inv_m, float kkt_scale, void* stream) {
  float* s = static_cast<float*>(scratch);
  const size_t mn = (size_t)m * n, mp = (size_t)m * p;
#define CSVM_FILL(a)                                  \
  (a).W = static_cast<const float*>(W);               \
  (a).deg = static_cast<const float*>(deg);           \
  (a).rho = static_cast<const float*>(rho);           \
  (a).omega = static_cast<const float*>(omega);       \
  (a).lam = static_cast<const float*>(lam);           \
  (a).nact = static_cast<const int*>(nact);           \
  (a).Bout = static_cast<float*>(Bout);               \
  (a).Pout = static_cast<float*>(Pout);               \
  (a).stat = static_cast<float*>(stat);               \
  (a).w = s;                                          \
  (a).B2 = s + mn;                                    \
  (a).bbar = s + mn + mp;                             \
  (a).slots = s + mn + mp + p;                        \
  (a).num_rounds = num_rounds;                        \
  (a).want_kkt = want_kkt;                            \
  (a).tau = tau;                                      \
  (a).lam0 = lam0;                                    \
  (a).inv_m = inv_m;                                  \
  (a).kkt_scale = kkt_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    Args<__nv_bfloat16> a =
        make_args<__nv_bfloat16>(X, y, B0, P0, m, n, p, h, kernel, inv_n);
    CSVM_FILL(a)
    return (int)launch_round_block(a, st);
  }
  Args<float> a = make_args<float>(X, y, B0, P0, m, n, p, h, kernel, inv_n);
  CSVM_FILL(a)
#undef CSVM_FILL
  return (int)launch_round_block(a, st);
}

// The stream instance of csvm_round_block (one read of X a round): the same
// operands, plus the wrapper's plan (int32: row ranges (grid + 1), each
// block's first segment (grid), each node's segment range (m + 1)), the
// grid, the tile rows, the stage size and the dynamic shared memory.
// scratch holds m*p + p + num_rounds + 2 + nseg*p floats (B2, bbar, slots,
// the partial X^T w rows).
int csvm_round_stream(const void* X, int x_bf16, const void* y, const void* B0,
                      const void* P0, const void* W, const void* deg,
                      const void* rho, const void* omega, const void* lam,
                      const void* nact, void* Bout, void* Pout, void* stat,
                      void* scratch, const void* plan, int m, int n, int p,
                      int num_rounds, int want_kkt, int grid, int tile_rows,
                      int stage_bytes, int smem_bytes, float tau, float lam0,
                      float h, int kernel, float inv_n, float inv_m,
                      float kkt_scale, void* stream) {
  float* s = static_cast<float*>(scratch);
  const size_t mp = (size_t)m * p;
#define CSVM_FILL_STREAM(a)                           \
  (a).W = static_cast<const float*>(W);               \
  (a).deg = static_cast<const float*>(deg);           \
  (a).rho = static_cast<const float*>(rho);           \
  (a).omega = static_cast<const float*>(omega);       \
  (a).lam = static_cast<const float*>(lam);           \
  (a).nact = static_cast<const int*>(nact);           \
  (a).Bout = static_cast<float*>(Bout);               \
  (a).Pout = static_cast<float*>(Pout);               \
  (a).stat = static_cast<float*>(stat);               \
  (a).B2 = s;                                         \
  (a).bbar = s + mp;                                  \
  (a).slots = s + mp + p;                             \
  (a).part = s + mp + p + num_rounds + 2;             \
  (a).plan = static_cast<const int*>(plan);           \
  (a).tile_rows = tile_rows;                          \
  (a).stage_bytes = stage_bytes;                      \
  (a).num_rounds = num_rounds;                        \
  (a).want_kkt = want_kkt;                            \
  (a).tau = tau;                                      \
  (a).lam0 = lam0;                                    \
  (a).inv_m = inv_m;                                  \
  (a).kkt_scale = kkt_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    Args<__nv_bfloat16> a =
        make_args<__nv_bfloat16>(X, y, B0, P0, m, n, p, h, kernel, inv_n);
    CSVM_FILL_STREAM(a)
    return (int)launch_round_stream(a, grid, smem_bytes, st);
  }
  Args<float> a = make_args<float>(X, y, B0, P0, m, n, p, h, kernel, inv_n);
  CSVM_FILL_STREAM(a)
#undef CSVM_FILL_STREAM
  return (int)launch_round_stream(a, grid, smem_bytes, st);
}

// Co-resident blocks per SM of the stream instance at `smem_bytes` of
// dynamic shared memory (0 without cooperative launch), and the SM count.
int csvm_round_stream_occupancy(int x_bf16, int smem_bytes, int* blocks_per_sm,
                                int* num_sms) {
  if (x_bf16)
    return (int)stream_occupancy<__nv_bfloat16>(smem_bytes, blocks_per_sm,
                                                num_sms);
  return (int)stream_occupancy<float>(smem_bytes, blocks_per_sm, num_sms);
}

// Co-resident blocks of the round kernel per SM (0 when the device has no
// cooperative launch) and the SM count: the residency rule's grid check.
int csvm_round_block_occupancy(int x_bf16, int* blocks_per_sm, int* num_sms) {
  if (x_bf16)
    return (int)round_block_occupancy<__nv_bfloat16>(blocks_per_sm, num_sms);
  return (int)round_block_occupancy<float>(blocks_per_sm, num_sms);
}

const char* csvm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
