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
// X^T w) and reads X twice, so one round is ~1 flop per byte of fp32 X,
// far below the card's ~20 flops/byte fp32 ridge: the kernels are bound by
// the bytes of X read from device memory.  A whole fit's bound counts X
// once (4*m*n*p*rounds flops against the fp32 or bf16 peak, X read once
// against 3.35 TB/s); at the main path's size X is 256 MiB (fp32), more
// than the 50 MB L2, so these simple kernels re-read X from device memory
// twice in every round.  That gap between the kernels and their bound is
// the target of the next kernel PR (keep a node's X tile on chip across
// the margin and X^T w passes, and use the tensor cores in bf16).
//
// Design: one thread block = 256 threads (8 warps).  Margins are one warp
// per row of X (a warp reduction over p); X^T w, the prox and the dual
// update are one thread per (node, column), looping over the node's rows
// (coalesced across the warp's neighbouring columns).  The ragged edges of
// n, p and m are masked, never padded.  bf16 mode (X stored bf16): B (or
// beta_bar) and w are rounded to bf16 before each dot, exactly where the
// JAX kernels cast with .astype(cd); every product and sum is fp32.
//
// csvm_round_block is a persistent cooperative kernel: the grid (occupancy
// x SM count, capped by the work) is co-resident and runs all num_rounds
// rounds in one launch, with cooperative_groups grid.sync() between the
// three phases of a round (margins; X^T w + W@B + prox into the second B
// buffer; W@B+ + dual + max|dB|).  Held rounds (index >= *nact, read from
// the device) skip their work but still reach every grid.sync().  The only
// atomic is atomicMax on the bits of a non-negative float (max is order
// independent), and every sum runs in a fixed order, so the results are
// the same from run to run.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// Every thread of the block must call it.  Non-negative floats order like
// their int bits (a positive NaN sorts above +inf and so propagates).
__device__ void block_max_to(float v, float* slot) {
  __shared__ float part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < kWarps ? part[lane] : 0.0f);
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

// ---------------------------------------------------------------------------
// Two-launch update (csvm_block_update, csvm_local_update)
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
