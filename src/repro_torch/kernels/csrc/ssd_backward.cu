// The VJP of the Mamba-2 SSD chunked scan (ssd_scan.cu) for Hopper
// (sm_90a): dx, ddt, dA, dB, dC, dD from dy and the final state's
// gradient.  Plain C interface, bound with ctypes by
// src/repro_torch/kernels/ops.py; built by src/repro_torch/kernels/build.py.
//
// Replaces no Pallas kernel: the JAX package trains mamba2 by XLA autodiff
// of repro.models.ssm.ssd_chunked (src/repro/models/ssm.py:53-106), and its
// Pallas ssd_scan has no backward.  The port's forward is a hand-written
// kernel whose output carries no autograd graph, so its gradient is a
// hand-written kernel too (ops.SSDScan), as flash_backward.cu is for
// attention.  It computes the closed form of ref.ssd_scan_backward, per
// (b, h) and per chunk c of Q rows, with cum = cumsum(dt A) (in index
// order, as the forward sums it), last = cum[Q-1], xdt = x dt,
// L_ij = exp(cum_i - cum_j) [j <= i], G = C B^T, M = G * L,
// state_in[c] the forward's carried (p, n) state and g[c] the gradient of
// the state leaving chunk c (g[nc-1] = dfinal, or 0):
//   g[c-1]  = exp(last_c) g[c] + sum_i exp(cum_i) dy_i (x) C_i
//   dxdt_j  = sum_{i>=j} M_ij dy_i + exp(last - cum_j) g B_j
//   dx      = D dy + dt dxdt,                 dD = sum dy . x
//   S_ij    = (dy_i . xdt_j) L_ij,            R = S * G
//   dC_i    = sum_h [sum_j S_ij B_j + exp(cum_i) state_in^T dy_i]
//   dB_j    = sum_h [sum_i S_ij C_i + exp(last - cum_j) g^T xdt_j]
//   dcum_t  = sum_j R_tj - sum_i R_it + C_t . (exp(cum_t) state_in^T dy_t)
//             - u_t,  u_j = xdt_j . (exp(last - cum_j) g B_j),
//             and the last row also exp(last) <g, state_in> + sum_j u_j
//   da      = reverse cumsum of dcum,  ddt = x . dxdt + A da,  dA = sum dt da
// Every decay is an exp of a difference of cumulative sums, never a ratio
// of exp(cum).  Rows past s are loaded as dt = 0 and zero x, B, C and dy
// (the forward's fixed point); their gradients are not stored.
//
// What bounds it on an H100: at mamba2-370m's training shape (b 8, s 2048,
// h 32, p 64, n 128, Q 64, bf16) the function moves ~13.6 kB a row (x, dy,
// dx, B, C, dB, dC, dt, ddt; 0.066 ms at 3.35 TB/s) and does ~4.7 MFLOP a
// row (six p x n products a row and head, the Q x Q products within the
// chunk; 0.066 ms at the bf16 tensor peak): the two bounds are about even.
// Two instances, picked by the wrapper from dtype, shape and operands
// (ops.ssd_backward_instance); each is four kernels launched in order on
// the stream, each kernel owning its outputs (no atomics anywhere, every
// sum in a fixed order, so two launches on the same inputs give the same
// bits), and both take the same fp32 scratch from the wrapper: the
// chunk-local states and gradient sums (two (b, nc, h, p·n) arrays, 268
// MB each at the training shape), the chunks' last cum, per-group
// partials of dB and dC and per-(b, chunk, head) partials of dA and dD.
//
// * "wgmma" (namespace tc; bf16, chunk 64, p and n multiples of 16 in [16,
//   256], 16-byte-aligned x, B, C, dy; every mamba2 layer in training):
//   the products on the bf16 tensor cores.  x, dy, B and C go in exactly;
//   every per-row factor (dt, exp(cum), exp(last - cum)) is applied to one
//   side or after the product, and each fp32 operand (the scaled B and C of
//   the chunk pass, S, S^T, M^T, state_in and g) is cut into three bf16
//   terms, each its own wgmma into one fp32 accumulator, lo first
//   (tests/test_torch_ssd_grad_split.py emulates the arithmetic: two terms
//   miss the port's limits).  Blocks are one warpgroup (128 threads) per
//   (b, chunk, group of heads); the gradient pass holds 103,712 bytes of
//   shared memory at mamba2's shape, so two blocks share an SM.
//   (a) bwd_tc_chunk_pass: the B and C tiles once, then per (head, panel
//       of 64 columns of p) the local state (B dt exp(last - cum))^T x and
//       the local sum (C exp(cum))^T dy, the scaled B and C as register A
//       operands, into the (b, nc, h, n, p) scratch (the forward's
//       ssd_chunk_pass, twice);
//   (b) bwd_tc_state_pass, 4 elements of (n, p) a thread: state_in[c] over
//       the local states forward, g[c] over the local sums backward from
//       dfinal, in place;
//   (c) bwd_tc_grad_pass<NP, PP>: per head S = (dy x^T) dt L, S^T and
//       G^T = B C^T built in registers from one-term products, R^T = S^T *
//       G^T's row sums by quad shuffles and its column sums by shuffles
//       and the four warps in order (G is not held across the heads: its
//       32 registers spilled the pass; G^T costs 4 np wgmmas a use), then
//       dC = S B + exp(cum) dy state_in, dB = S^T C + exp(last - cum) dt
//       x^T g and dxdt = M^T dy + exp(last - cum) B g^T.  The three terms
//       of S, S^T and M^T and of each 64 x 64 block of state_in and g (read
//       from the scratch, whose (n, p) rows serve as K-major or MN-major
//       operands without a transpose) sit in shared memory, and S B and
//       S^T C run in passes of their own, so that at most two accumulators
//       are live beside a block's loads (register A operands in three
//       terms spilled every instance);
//   (d) bwd_reduce, shared with "fma".
//   What bounds it: the scratch (each array written by (a), read and
//   rewritten by (b), read by (c): ~2.1 GB a call at the training shape,
//   0.64 ms at 3.35 TB/s, ten times the function's bound), then the three-
//   term products (~150 GFLOP of bf16 wgmma there).
//
// * "fma" (the anonymous namespace; fp32, misaligned bf16, other shapes):
//   every product as fp32 FMAs on the CUDA cores (67 TFLOP/s peak: ~1.2
//   ms at best at the training shape, 5.8 ms measured) plus the same
//   scratch:
//   (a) bwd_chunk_pass, one block per (b, chunk, group of heads): B and C
//       of the chunk in shared memory once; per head, cum, then the
//       chunk-local state sum_j exp(last - cum_j) xdt_j (x) B_j and the
//       chunk-local sum_i exp(cum_i) dy_i (x) C_i (p x n, 4x4 register
//       tiles over Q), into two fp32 scratch arrays (b, nc, h, p, n), and
//       last into a third (recomputed here, so the forward's interface and
//       timings stay as they are);
//   (b) bwd_state_pass, one thread per (b, h, element of p x n): walks the
//       chunks forward, writing state_in[c] over the local states, then
//       backward from dfinal, writing g[c] over the local dy (x) C sums;
//   (c) bwd_grad_pass, one block of 512 threads per (b, chunk, group of
//       heads; its ~200 KB of shared memory leave one block an SM, so it
//       takes twice the other passes' 256 threads): per head,
//       S and M (Q x Q, G recomputed per head in the same tiles), dxdt
//       (from M and g), dx and the row sums x . dxdt and u; the head's dB
//       (from S, C, g and xdt) and, with state_in in the slot g held, its
//       dC (from S, B, state_in and dy) added in place to per-group fp32
//       partials that only this block touches; dcum from the row sums,
//       its reverse cumsum by one thread, ddt, and per-(b, chunk, head)
//       partials of dA and dD (<g, state_in> and dy . x summed by one
//       warp in a fixed order);
//   (d) bwd_reduce, one thread per (b, s, n): dB and dC summed over the
//       groups in order and rounded once; dA and dD over (b, chunk).
//   Every product is a 4x4 register tile over float4 loads from shared
//   memory whose rows are padded by 4 floats.
// x, dy, B and C are read through their strides (unit stride over p and
// n), so the model's column slices of its conv output go in without a
// copy; dx, dB, dC (input dtype) and ddt (fp32) are written dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGradThreads = 512;   // threads of a gradient-pass block
constexpr int kMaxQ = 128;
constexpr int kMaxGroup = 4;
constexpr int kSmemLimit = 232448;
constexpr int kMaxDevices = 64;
constexpr int kAhead = 8;        // chunks the state pass loads ahead

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);   // the one rounding of dx, dB, dC
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// Padded row lengths of the shared-memory tiles (floats): the rows of a
// tile stay 16-byte aligned for float4 loads and start 16 bytes apart in
// the banks.
struct Dims {
  int Q, P, P4, N, QS, PS, NS;
  __host__ __device__ Dims(int q, int p, int n)
      : Q(q), P(p), P4(round4(p)), N(n), QS(q + 4), PS(round4(p) + 4),
        NS(n + 4) {}
};

// Shared memory of pass (a), floats: B and C (Q x NS), the decayed x*dt
// and exp(cum) dy (Q x PS), dt, cum, exp(cum), exp(last - cum) (Q).
__host__ __device__ inline long long chunk_smem_floats(int Q, int P, int N) {
  const Dims d(Q, P, N);
  return 2LL * Q * d.NS + 2LL * Q * d.PS + 4LL * Q;
}

// Shared memory of pass (c), floats: B and C (Q x NS); g, then state_in
// (P4 x NS); S and M (Q x QS); x*dt and dy (Q x PS); dt, cum, exp(cum),
// exp(last - cum), dcum, x . dxdt, u, the block's two sums (Q); the
// tiles' partial row and column sums of R (Q x Q/4 each), of u and
// x . dxdt (Q x P4/4 each) and of C . dC_off (Q x N/4); two
// block-reduction buffers (kGradThreads).
__host__ __device__ inline long long grad_smem_floats(int Q, int P, int N) {
  const Dims d(Q, P, N);
  return 2LL * Q * d.NS + 1LL * d.P4 * d.NS + 2LL * Q * d.QS +
         2LL * Q * d.PS + 8LL * Q + 2LL * Q * (Q / 4) +
         2LL * Q * (d.P4 / 4) + 1LL * Q * (N / 4) + 2LL * kGradThreads;
}

struct Args {
  const void *x, *B, *C, *dy;
  const float *dt, *A, *D, *dfinal;   // dfinal may be null (zeros)
  void *dx, *dB, *dC;
  float *ddt, *dA, *dD;
  float *states, *grads, *cum_last, *partB, *partC, *partA, *partD;
  long long xb, xs, xh, yb, ys, yh, db, ds, dh, Bb, Bs, Cb, Cs;  // elements
  int batch, H, S, P, N, Q, NC, group, groups;
};

// acc[r][c] += sum_{k0 <= k < k1} A(m0 + r, k) Bm(k, n0 + c), k in steps of
// 4 (k0, k1, m0, n0 multiples of 4).  A(m, k) is A[m * lda + k] when AK
// (contiguous along k) else A[k * lda + m]; Bm(k, n) is B[n * ldb + k]
// when BK else B[k * ldb + n].  Every access is a float4.
template <bool AK, bool BK>
__device__ __forceinline__ void mma4(float (&acc)[4][4],
                                     const float* __restrict__ A, int lda,
                                     const float* __restrict__ B, int ldb,
                                     int m0, int n0, int k0, int k1) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float a[4][4], b[4][4];   // a[r][kk], b[kk][c]
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 v = AK ? *reinterpret_cast<const float4*>(
                                A + (m0 + t) * lda + k)
                          : *reinterpret_cast<const float4*>(
                                A + (k + t) * lda + m0);
      if (AK) {
        a[t][0] = v.x; a[t][1] = v.y; a[t][2] = v.z; a[t][3] = v.w;
      } else {
        a[0][t] = v.x; a[1][t] = v.y; a[2][t] = v.z; a[3][t] = v.w;
      }
      const float4 w = BK ? *reinterpret_cast<const float4*>(
                                B + (n0 + t) * ldb + k)
                          : *reinterpret_cast<const float4*>(
                                B + (k + t) * ldb + n0);
      if (BK) {
        b[0][t] = w.x; b[1][t] = w.y; b[2][t] = w.z; b[3][t] = w.w;
      } else {
        b[t][0] = w.x; b[t][1] = w.y; b[t][2] = w.z; b[t][3] = w.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(a[r][kk], b[kk][c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
}

// The block's (b, chunk, group) from blockIdx.x (groups fastest, so the
// blocks of one chunk run together and share B and C in L2).
struct Block {
  int b, c, grp, s0, nv;
  __device__ Block(const Args& a) {
    const int bid = blockIdx.x;
    grp = bid % a.groups;
    c = (bid / a.groups) % a.NC;
    b = bid / (a.groups * a.NC);
    s0 = c * a.Q;
    nv = min(a.Q, a.S - s0);
  }
};

// B and C of the chunk into Bs, Cs (Q x NS), rows >= nv zero.
template <typename T>
__device__ void load_bc(const Args& a, const Block& k, float* Bs,
                        float* Cs, int NS) {
  const T* Bp = static_cast<const T*>(a.B) + k.b * a.Bb;
  const T* Cp = static_cast<const T*>(a.C) + k.b * a.Cb;
  for (int idx = threadIdx.x; idx < a.Q * a.N; idx += blockDim.x) {
    const int i = idx / a.N, n = idx % a.N;
    const bool ok = i < k.nv;
    const long long row = static_cast<long long>(k.s0 + i);
    Bs[i * NS + n] = ok ? widen(Bp[row * a.Bs + n]) : 0.0f;
    Cs[i * NS + n] = ok ? widen(Cp[row * a.Cs + n]) : 0.0f;
  }
}

// cum in index order by one thread (the forward's order, no contraction
// into an FMA), then exp(cum) and exp(last - cum).
__device__ void cumulative(const float* dts, float a, int Q, float* cum,
                           float* ecum, float* dec) {
  if (threadIdx.x == 0) {
    float run = 0.0f;
    for (int i = 0; i < Q; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], a));
      cum[i] = run;
    }
  }
  __syncthreads();
  const float last = cum[Q - 1];
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    ecum[i] = expf(cum[i]);
    dec[i] = expf(last - cum[i]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// (a) the chunk-local states and the chunk-local dy (x) C sums
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_chunk_pass(Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d(a.Q, a.P, a.N);
  const Block k(a);
  const int Q = a.Q;
  float* Bs = sm;
  float* Cs = Bs + Q * d.NS;
  float* xw = Cs + Q * d.NS;       // x dt exp(last - cum), (Q, PS)
  float* dye = xw + Q * d.PS;      // dy exp(cum), (Q, PS)
  float* dts = dye + Q * d.PS;
  float* cum = dts + Q;
  float* ecum = cum + Q;
  float* dec = ecum + Q;
  load_bc<T>(a, k, Bs, Cs, d.NS);
  const T* xp = static_cast<const T*>(a.x) + k.b * a.xb;
  const T* yp = static_cast<const T*>(a.dy) + k.b * a.yb;
  const int ptiles = d.P4 / 4, ntiles = a.N / 4;
  for (int hi = 0; hi < a.group; ++hi) {
    const int h = k.grp * a.group + hi;
    if (h >= a.H) break;
    for (int i = threadIdx.x; i < Q; i += kThreads)
      dts[i] = i < k.nv ? a.dt[k.b * a.db + (k.s0 + i) * a.ds + h * a.dh]
                        : 0.0f;
    for (int idx = threadIdx.x; idx < Q * d.P4; idx += kThreads) {
      const int i = idx / d.P4, p = idx % d.P4;
      const bool ok = i < k.nv && p < a.P;
      const long long row = static_cast<long long>(k.s0 + i);
      xw[i * d.PS + p] = ok ? widen(xp[row * a.xs + h * a.xh + p]) : 0.0f;
      dye[i * d.PS + p] = ok ? widen(yp[row * a.ys + h * a.yh + p]) : 0.0f;
    }
    __syncthreads();
    cumulative(dts, a.A[h], Q, cum, ecum, dec);
    for (int idx = threadIdx.x; idx < Q * d.P4; idx += kThreads) {
      const int i = idx / d.P4, p = idx % d.P4;
      xw[i * d.PS + p] = (xw[i * d.PS + p] * dts[i]) * dec[i];
      dye[i * d.PS + p] = dye[i * d.PS + p] * ecum[i];
    }
    __syncthreads();
    const long long base =
        ((static_cast<long long>(k.b) * a.NC + k.c) * a.H + h) * a.P * a.N;
    for (int t = threadIdx.x; t < ptiles * ntiles; t += kThreads) {
      const int p0 = 4 * (t / ntiles), n0 = 4 * (t % ntiles);
      float st[4][4], gc[4][4];
      zero(st);
      zero(gc);
      mma4<false, false>(st, xw, d.PS, Bs, d.NS, p0, n0, 0, Q);
      mma4<false, false>(gc, dye, d.PS, Cs, d.NS, p0, n0, 0, Q);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (p0 + r >= a.P) break;
        const long long at = base + static_cast<long long>(p0 + r) * a.N + n0;
        *reinterpret_cast<float4*>(a.states + at) =
            make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
        *reinterpret_cast<float4*>(a.grads + at) =
            make_float4(gc[r][0], gc[r][1], gc[r][2], gc[r][3]);
      }
    }
    if (threadIdx.x == 0)
      a.cum_last[(static_cast<long long>(k.b) * a.NC + k.c) * a.H + h] =
          cum[Q - 1];
    __syncthreads();   // xw, dye, dts consumed before the next head
  }
}

// ---------------------------------------------------------------------------
// (b) state_in[c] over the local states, g[c] over the local dy (x) C sums
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) bwd_state_pass(Args a) {
  const long long PN = static_cast<long long>(a.P) * a.N;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(a.batch) * a.H * PN) return;
  const int bh = static_cast<int>(idx / PN);
  const long long e = idx % PN;
  const int b = bh / a.H, h = bh % a.H;
  const long long step = a.H * PN;   // one chunk further
  const long long first =
      (static_cast<long long>(b) * a.NC * a.H + h) * PN + e;
  const float* lastp = a.cum_last + static_cast<long long>(b) * a.NC * a.H + h;
  // kAhead chunks are loaded before any of their slots is written, so the
  // loads are in flight together (a load after a store to the same array
  // would wait for it)
  float run = 0.0f;
  for (int c0 = 0; c0 < a.NC; c0 += kAhead) {
    float local[kAhead], decay[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (c0 + q < a.NC) {
        local[q] = a.states[first + (c0 + q) * step];
        decay[q] = expf(lastp[(c0 + q) * a.H]);
      }
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (c0 + q < a.NC) {
        a.states[first + (c0 + q) * step] = run;
        run = run * decay[q] + local[q];
      }
  }
  run = a.dfinal ? a.dfinal[static_cast<long long>(bh) * PN + e] : 0.0f;
  for (int c0 = a.NC - 1; c0 >= 0; c0 -= kAhead) {
    float local[kAhead], decay[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (c0 - q >= 0) {
        local[q] = a.grads[first + (c0 - q) * step];
        decay[q] = expf(lastp[(c0 - q) * a.H]);
      }
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (c0 - q >= 0) {
        a.grads[first + (c0 - q) * step] = run;
        run = run * decay[q] + local[q];
      }
  }
}

// ---------------------------------------------------------------------------
// (c) dx, ddt and the per-block partials of dB, dC, dA, dD
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kGradThreads) bwd_grad_pass(Args a) {
  extern __shared__ __align__(16) float sm[];
  const Dims d(a.Q, a.P, a.N);
  const Block k(a);
  const int Q = a.Q, QT = Q / 4, PT = d.P4 / 4, NT = a.N / 4;
  const int tid = threadIdx.x;
  float* Bs = sm;
  float* Cs = Bs + Q * d.NS;
  float* SG = Cs + Q * d.NS;       // g, then state_in: (P4, NS)
  float* Sm = SG + d.P4 * d.NS;    // S (Q, QS), zero above the diagonal
  float* Mm = Sm + Q * d.QS;       // M (Q, QS), likewise
  float* xdt = Mm + Q * d.QS;      // (Q, PS)
  float* dys = xdt + Q * d.PS;     // (Q, PS)
  float* dts = dys + Q * d.PS;
  float* cum = dts + Q;
  float* ecum = cum + Q;
  float* dec = ecum + Q;
  float* dcum = dec + Q;
  float* xd = dcum + Q;            // x . dxdt per row
  float* uu = xd + Q;              // u per row
  float* tot = uu + Q;             // <g, state_in>, dD's share (2 of Q)
  float* rrow = tot + Q;           // (Q, QT): R's row sums per tile
  float* rcol = rrow + Q * QT;     // (Q, QT): R's column sums per tile
  float* pu = rcol + Q * QT;       // (Q, PT)
  float* pxd = pu + Q * PT;        // (Q, PT)
  float* pc = pxd + Q * PT;        // (Q, NT)
  float* red = pc + Q * NT;        // (2, kGradThreads)
  load_bc<T>(a, k, Bs, Cs, d.NS);
  const T* xp = static_cast<const T*>(a.x) + k.b * a.xb;
  const T* yp = static_cast<const T*>(a.dy) + k.b * a.yb;
  T* dxp = static_cast<T*>(a.dx);
  const long long prow = (static_cast<long long>(k.grp) * a.batch + k.b) *
                             a.NC * Q + k.s0;   // first partial row
  for (int hi = 0; hi < a.group; ++hi) {
    const int h = k.grp * a.group + hi;
    if (h >= a.H) break;
    const float A = a.A[h], Dh = a.D[h];
    const long long sbase =
        ((static_cast<long long>(k.b) * a.NC + k.c) * a.H + h) * a.P * a.N;
    // 1. loads: dt, x dt, dy, g; dy . x for dD
    float dd = 0.0f;
    for (int i = tid; i < Q; i += kGradThreads)
      dts[i] = i < k.nv ? a.dt[k.b * a.db + (k.s0 + i) * a.ds + h * a.dh]
                        : 0.0f;
    for (int idx = tid; idx < Q * d.P4; idx += kGradThreads) {
      const int i = idx / d.P4, p = idx % d.P4;
      float xv = 0.0f, yv = 0.0f, dtv = 0.0f;
      if (i < k.nv && p < a.P) {
        const long long row = static_cast<long long>(k.s0 + i);
        xv = widen(xp[row * a.xs + h * a.xh + p]);
        yv = widen(yp[row * a.ys + h * a.yh + p]);
        dtv = a.dt[k.b * a.db + row * a.ds + h * a.dh];
      }
      xdt[i * d.PS + p] = xv * dtv;
      dys[i * d.PS + p] = yv;
      dd = fmaf(yv, xv, dd);
    }
    for (int idx = tid; idx < d.P4 * a.N; idx += kGradThreads) {
      const int p = idx / a.N, n = idx % a.N;
      SG[p * d.NS + n] = p < a.P ? a.grads[sbase + p * a.N + n] : 0.0f;
    }
    __syncthreads();
    cumulative(dts, A, Q, cum, ecum, dec);
    // 2. S, M and R's partial row and column sums, lower 4x4 tiles
    for (int t = tid; t < QT * QT; t += kGradThreads) {
      const int ti = t / QT, tj = t % QT, i0 = 4 * ti, j0 = 4 * tj;
      float dyx[4][4], gg[4][4], rs[4], cs[4];
      zero(dyx);
      zero(gg);
      if (tj <= ti) {
        mma4<true, true>(dyx, dys, d.PS, xdt, d.PS, i0, j0, 0, d.P4);
        mma4<true, true>(gg, Cs, d.NS, Bs, d.NS, i0, j0, 0, a.N);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) rs[r] = cs[r] = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        float srow[4], mrow[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c;
          const float l = j <= i ? expf(cum[i] - cum[j]) : 0.0f;
          srow[c] = dyx[r][c] * l;
          mrow[c] = gg[r][c] * l;
          const float rv = srow[c] * gg[r][c];
          rs[r] += rv;
          cs[c] += rv;
        }
        *reinterpret_cast<float4*>(Sm + i * d.QS + j0) =
            make_float4(srow[0], srow[1], srow[2], srow[3]);
        *reinterpret_cast<float4*>(Mm + i * d.QS + j0) =
            make_float4(mrow[0], mrow[1], mrow[2], mrow[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        rrow[(i0 + r) * QT + tj] = rs[r];
        rcol[(j0 + r) * QT + ti] = cs[r];
      }
    }
    __syncthreads();
    // 3. dxdt = M^T dy + exp(last - cum) g B; dx; u and x . dxdt per tile
    for (int t = tid; t < QT * PT; t += kGradThreads) {
      const int tj = t / PT, tp = t % PT, j0 = 4 * tj, p0 = 4 * tp;
      float gb[4][4], md[4][4];
      zero(gb);
      zero(md);
      mma4<true, true>(gb, Bs, d.NS, SG, d.NS, j0, p0, 0, a.N);
      mma4<false, false>(md, Mm, d.QS, dys, d.PS, j0, p0, j0, Q);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + r;
        float u = 0.0f, xdx = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = p0 + c;
          const float stt = dec[j] * gb[r][c];
          const float dxdt = md[r][c] + stt;
          u = fmaf(xdt[j * d.PS + p], stt, u);
          if (j < k.nv && p < a.P) {
            const long long row = static_cast<long long>(k.s0 + j);
            xdx = fmaf(widen(xp[row * a.xs + h * a.xh + p]), dxdt, xdx);
            dxp[((k.b * static_cast<long long>(a.S) + row) * a.H + h) * a.P +
                p] = narrow<T>(fmaf(Dh, dys[j * d.PS + p], dts[j] * dxdt));
          }
        }
        pu[j * PT + tp] = u;
        pxd[j * PT + tp] = xdx;
      }
    }
    // 4. dB = S^T C + exp(last - cum) xdt g, into the group's partial
    for (int t = tid; t < QT * NT; t += kGradThreads) {
      const int tj = t / NT, tn = t % NT, j0 = 4 * tj, n0 = 4 * tn;
      float sc[4][4], xg[4][4];
      zero(sc);
      zero(xg);
      mma4<false, false>(sc, Sm, d.QS, Cs, d.NS, j0, n0, j0, Q);
      mma4<true, false>(xg, xdt, d.PS, SG, d.NS, j0, n0, 0, d.P4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + r;
        float4* out = reinterpret_cast<float4*>(
            a.partB + (prow + j) * a.N + n0);
        float4 v = make_float4(sc[r][0] + dec[j] * xg[r][0],
                               sc[r][1] + dec[j] * xg[r][1],
                               sc[r][2] + dec[j] * xg[r][2],
                               sc[r][3] + dec[j] * xg[r][3]);
        if (hi > 0) {
          const float4 o = *out;
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        *out = v;
      }
    }
    // R's row sums less its column sums
    for (int i = tid; i < Q; i += kGradThreads) {
      float rs = 0.0f, cs = 0.0f;
      for (int q = 0; q < QT; ++q) {
        rs += rrow[i * QT + q];
        cs += rcol[i * QT + q];
      }
      dcum[i] = rs - cs;
    }
    __syncthreads();
    // 5. state_in takes g's slot; <g, state_in>
    float gdot = 0.0f;
    for (int idx = tid; idx < d.P4 * a.N; idx += kGradThreads) {
      const int p = idx / a.N, n = idx % a.N;
      const float st = p < a.P ? a.states[sbase + p * a.N + n] : 0.0f;
      gdot = fmaf(SG[p * d.NS + n], st, gdot);
      SG[p * d.NS + n] = st;
    }
    red[tid] = gdot;
    red[kGradThreads + tid] = dd;
    __syncthreads();
    // 6. dC = S B + exp(cum) dy state_in, into the group's partial; the
    //    carry-in's share of dcum, C . (exp(cum) state_in^T dy), per tile
    for (int t = tid; t < QT * NT; t += kGradThreads) {
      const int ti = t / NT, tn = t % NT, i0 = 4 * ti, n0 = 4 * tn;
      float sb[4][4], off[4][4];
      zero(sb);
      zero(off);
      mma4<true, false>(sb, Sm, d.QS, Bs, d.NS, i0, n0, 0, i0 + 4);
      mma4<true, false>(off, dys, d.PS, SG, d.NS, i0, n0, 0, d.P4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        float cpart = 0.0f;
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o[c] = ecum[i] * off[r][c];
          cpart = fmaf(Cs[i * d.NS + n0 + c], o[c], cpart);
        }
        float4* out = reinterpret_cast<float4*>(
            a.partC + (prow + i) * a.N + n0);
        float4 v = make_float4(sb[r][0] + o[0], sb[r][1] + o[1],
                               sb[r][2] + o[2], sb[r][3] + o[3]);
        if (hi > 0) {
          const float4 w = *out;
          v = make_float4(w.x + v.x, w.y + v.y, w.z + v.z, w.w + v.w);
        }
        *out = v;
        pc[i * NT + tn] = cpart;
      }
    }
    __syncthreads();
    // 7. dcum per row; u and x . dxdt per row
    for (int i = tid; i < Q; i += kGradThreads) {
      float u = 0.0f, xdx = 0.0f, cp = 0.0f;
      for (int q = 0; q < PT; ++q) {
        u += pu[i * PT + q];
        xdx += pxd[i * PT + q];
      }
      for (int q = 0; q < NT; ++q) cp += pc[i * NT + q];
      uu[i] = u;
      xd[i] = xdx;
      dcum[i] = dcum[i] + cp - u;
    }
    if (tid >= kGradThreads - 32) {   // the last warp: the block's two sums
      const int lane = tid & 31;
      float g = 0.0f, s = 0.0f;
      for (int q = 0; q < kGradThreads / 32; ++q) {
        g += red[lane * (kGradThreads / 32) + q];
        s += red[kGradThreads + lane * (kGradThreads / 32) + q];
      }
      for (int off = 16; off > 0; off >>= 1) {
        g += __shfl_xor_sync(0xffffffffu, g, off);
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) {
        tot[0] = g;
        tot[1] = s;
      }
    }
    __syncthreads();
    // 8. the last row's terms, da, ddt and the partials of dA and dD
    if (tid == 0) {
      float usum = 0.0f;
      for (int i = 0; i < Q; ++i) usum += uu[i];
      dcum[Q - 1] += ecum[Q - 1] * tot[0] + usum;
      float run = 0.0f, da_dt = 0.0f;
      for (int i = Q - 1; i >= 0; --i) {
        run += dcum[i];
        da_dt = fmaf(dts[i], run, da_dt);
        if (i < k.nv)
          a.ddt[(k.b * static_cast<long long>(a.S) + k.s0 + i) * a.H + h] =
              fmaf(A, run, xd[i]);
      }
      const long long at =
          (static_cast<long long>(k.b) * a.NC + k.c) * a.H + h;
      a.partA[at] = da_dt;
      a.partD[at] = tot[1];
    }
    __syncthreads();   // every buffer consumed before the next head
  }
}

// ---------------------------------------------------------------------------
// (d) dB and dC over the groups, dA and dD over (b, chunk), in order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_reduce(Args a) {
  const long long SN = static_cast<long long>(a.S) * a.N;
  const long long total = a.batch * SN;
  const long long rows = static_cast<long long>(a.NC) * a.Q;   // per b
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx < total) {
    const long long b = idx / SN, rem = idx % SN;
    const long long s = rem / a.N, n = rem % a.N;
    float sb = 0.0f, sc = 0.0f;
    for (int g = 0; g < a.groups; ++g) {
      const long long at = ((g * a.batch + b) * rows + s) * a.N + n;
      sb += a.partB[at];
      sc += a.partC[at];
    }
    static_cast<T*>(a.dB)[idx] = narrow<T>(sb);
    static_cast<T*>(a.dC)[idx] = narrow<T>(sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < a.H; h += kThreads) {
      float sa = 0.0f, sd = 0.0f;
      for (long long bc = 0; bc < static_cast<long long>(a.batch) * a.NC;
           ++bc) {
        sa += a.partA[bc * a.H + h];
        sd += a.partD[bc * a.H + h];
      }
      a.dA[h] = sa;
      a.dD[h] = sd;
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static bool done_chunk[kMaxDevices], done_grad[kMaxDevices];
  cudaError_t err = allow_smem(bwd_chunk_pass<T>, done_chunk);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_grad_pass<T>, done_grad);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(a.batch) * a.NC * a.groups);
  bwd_chunk_pass<T><<<blocks, kThreads,
                      sizeof(float) * chunk_smem_floats(a.Q, a.P, a.N),
                      stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long elems = static_cast<long long>(a.batch) * a.H * a.P * a.N;
  bwd_state_pass<<<static_cast<unsigned>((elems + kThreads - 1) / kThreads),
                   kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_grad_pass<T><<<blocks, kGradThreads,
                     sizeof(float) * grad_smem_floats(a.Q, a.P, a.N),
                     stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outs = static_cast<long long>(a.batch) * a.S * a.N;
  bwd_reduce<T><<<static_cast<unsigned>((outs + kThreads - 1) / kThreads),
                  kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core instance ("wgmma"): bf16, chunk 64, p and n multiples of
// 16 in [16, 256]; one warpgroup a block, two blocks an SM
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kQ = 64;               // chunk rows: one warpgroup's tile
constexpr int kWarpgroup = 128;      // threads of a chunk or gradient block
constexpr int kPanel = kQ * kRow;    // bytes of one 64 x 64 bf16 panel
constexpr int kStateThreads = 256;   // threads of a state-walk block
constexpr int kLoadBatch = 4;        // float4 loads of a state block issued together

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

#define SSD_OUT32                                                            \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),    \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),           \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),       \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),       \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),       \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),       \
      "=f"(d[31])

// d (64 x 64, fp32) = A (64 x 16) . B, the first product into an
// accumulator: scale-d 0, so d is only written (no zero fill, which the
// compiler hoists into the previous phase and holds there).  A K-major,
// B K-major (kTnspB = 0) or MN-major (1), both in shared memory.
template <int kTnspB>
__device__ __forceinline__ void wgmma_ss_set(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %35, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", %32, %33, p, 1, 1, 0, %34;\n\t}"
      : SSD_OUT32
      : "l"(da), "l"(db), "n"(kTnspB), "n"(0));
}

// Hides two shared-memory addresses from the compiler at this point, so
// that the descriptors formed from them are not hoisted out of the head
// loop and held in registers across it (which spilled the gradient pass).
__device__ __forceinline__ void opaque(uint32_t& a, uint32_t& b) {
  asm volatile("" : "+r"(a), "+r"(b));
}
// The same for a thread's fragment coordinates, at each loop over its
// accumulator: the offsets formed from them are not held across the head.
__device__ __forceinline__ void opaque(int& a, int& b) {
  asm volatile("" : "+r"(a), "+r"(b));
}
__device__ __forceinline__ void opaque(int& a) { asm volatile("" : "+r"(a)); }

// Shared memory of the chunk pass, in bytes: the B and C tiles (np panels
// of 64 rows each), one panel of x and one of dy, then dt, cum and the two
// row factors dt exp(last - cum) and exp(cum) of the group's heads.
struct ChunkLayout {
  int C, B, X, DY, dt, cum, f, e, bytes;
  __host__ __device__ ChunkLayout(int N) {
    C = 0;
    B = C + panels(N) * kPanel;
    X = B + panels(N) * kPanel;
    DY = X + kPanel;
    dt = DY + kPanel;
    cum = dt + 4 * kMaxGroup * kQ;
    f = cum + 4 * kMaxGroup * kQ;
    e = f + 4 * kMaxGroup * kQ;
    bytes = e + 4 * kMaxGroup * kQ + 1024;
  }
};

// Shared memory of the gradient pass, in bytes: the C and B tiles (np
// panels), x and dy (pp panels), the three bf16 terms of one 64 x 64 block
// of state_in or g (T), the three bf16 terms of S, S^T or M^T (SA), then
// dt and cum of the group's heads, five per-row sums (R's rows, R's
// columns, the carry-in's share of dcum, u, x . dxdt), the block's two
// sums and the four warps' column sums of R^T.
struct GradLayout {
  int C = 0, B = 0, X = 0, DY = 0, T = 0, SA = 0, dt = 0, cum = 0, rrow = 0,
      rcol = 0, cpart = 0, uu = 0, xd = 0, red = 0, cols = 0, bytes = 0;
  __host__ __device__ constexpr GradLayout(int N, int P) {
    const int np = panels(N), pp = panels(P);
    C = 0;
    B = C + np * kPanel;
    X = B + np * kPanel;
    DY = X + pp * kPanel;
    T = DY + pp * kPanel;
    SA = T + 3 * kPanel;
    dt = SA + 3 * kPanel;
    cum = dt + 4 * kMaxGroup * kQ;
    rrow = cum + 4 * kMaxGroup * kQ;
    rcol = rrow + 4 * kQ;
    cpart = rcol + 4 * kQ;
    uu = cpart + 4 * kQ;
    xd = uu + 4 * kQ;
    red = xd + 4 * kQ;
    cols = red + 4 * 8;
    bytes = cols + 4 * 4 * kQ + 1024;
  }
};

// dt of the block's heads (rows past s and heads past H as 0) into dts
// (group x Q), then their cumulative sums in index order, one thread per
// head, with no contraction into an FMA: the forward's bits.  The Args
// fields come one by one (see grad_panel).
__device__ __forceinline__ void group_cumsum(
    const float* dt, long long db, long long ds, long long dh,
    const float* Av, int S, int H, int group, int b, int s0, int h0,
    float* dts, float* cum, int tid) {
  const int nv = min(kQ, S - s0);
  for (int idx = tid; idx < group * kQ; idx += kWarpgroup) {
    const int g = idx / kQ, i = idx % kQ;
    const int h = h0 + g;
    dts[idx] = (i < nv && h < H) ? dt[b * db + (s0 + i) * ds + h * dh]
                                 : 0.0f;
  }
  __syncthreads();
  if (tid < group && h0 + tid < H) {
    const float A = Av[h0 + tid];
    float run = 0.0f;
    for (int i = 0; i < kQ; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[tid * kQ + i], A));
      cum[tid * kQ + i] = run;
    }
  }
  __syncthreads();
}

// The sum of v over the block's 128 threads, in a fixed order (shuffles in
// each warp, then the four warps in order); every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  const float total = (red[0] + red[1]) + (red[2] + red[3]);
  __syncthreads();
  return total;
}

// The sum over the four lanes of a quad (the threads that share a row of
// an accumulator), the same bits in each lane.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The column sums of an accumulator (64 x 64, this thread's fragment) over
// its 64 rows into out[0 .. 63], in a fixed order: the thread's two rows,
// then lanes 4, 8 and 16 apart (the same bits in each lane), then the four
// warps in order through `red` (4 x 64 floats).  Ends with a barrier.
__device__ __forceinline__ void column_sums(const float (&v)[32], float* red,
                                            float* out, int tid, int c0) {
  opaque(tid, c0);
  float cs[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    cs[k] = v[4 * (k / 2) + k % 2] + v[4 * (k / 2) + 2 + k % 2];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < 16; ++k)
      cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], off);
  if (tid % 32 < 4)
#pragma unroll
    for (int k = 0; k < 16; ++k)
      red[(tid / 32) * kQ + 8 * (k / 2) + c0 + k % 2] = cs[k];
  __syncthreads();
  if (tid < kQ)
    out[tid] = ((red[tid] + red[kQ + tid]) + red[2 * kQ + tid]) +
               red[3 * kQ + tid];
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
}

// d += A . B over one 64-row K block, A the three register terms (lo
// first, as the forward), B MN-major at `bdesc_row0` (16 rows a k-step).
__device__ __forceinline__ void product_rs3(float (&d)[32],
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&mid)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            uint32_t b0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, lo[kk], mnmajor(b0 + 16 * kk * kRow));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, mid[kk], mnmajor(b0 + 16 * kk * kRow));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, hi[kk], mnmajor(b0 + 16 * kk * kRow));
}

// One 64 x 64 block of a state of the scratch (rows n0 .. of n, columns
// p0 .. of p; element (n, p) = src[n * P + p]) into the three term regions
// at T, kPanel bytes apart, as a 128-byte-swizzled panel (rows n); rows n
// >= N and columns p >= P zero.  The thread's 8 float4 loads are issued
// together before their terms are stored.  With kDot, also the sum of
// other[n * P + p] * src[n * P + p] over the block (this thread's share).
template <bool kDot>
__device__ __forceinline__ float load_terms(unsigned char* T,
                                            const float* src,
                                            const float* other, int N,
                                            int P, int n0, int p0, int tid) {
  constexpr int kLoads = 64 * 16 / kWarpgroup;   // float4 a thread
  opaque(tid);
  float dot = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < kLoads; k0 += kLoadBatch) {
  float4 v[kLoadBatch], w[kLoadBatch];
#pragma unroll
  for (int kb = 0; kb < kLoadBatch; ++kb) {
    const int k = k0 + kb;
    const int idx = tid + k * kWarpgroup;
    const int n = n0 + idx / 16, p = p0 + 4 * (idx % 16);
    const bool ok = n < N && p < P;
    v[kb] = ok ? *reinterpret_cast<const float4*>(src + n * P + p)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kDot)
      w[kb] = ok ? *reinterpret_cast<const float4*>(other + n * P + p)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int kb = 0; kb < kLoadBatch; ++kb) {
    const int k = k0 + kb;
    const int idx = tid + k * kWarpgroup;
    const int r = idx / 16, q4 = idx % 16;
    if (kDot) {
      dot = fmaf(w[kb].x, v[kb].x, dot);
      dot = fmaf(w[kb].y, v[kb].y, dot);
      dot = fmaf(w[kb].z, v[kb].z, dot);
      dot = fmaf(w[kb].w, v[kb].w, dot);
    }
    uint32_t hi0, mid0, lo0, hi1, mid1, lo1;
    split3(v[kb].x, v[kb].y, hi0, mid0, lo0);
    split3(v[kb].z, v[kb].w, hi1, mid1, lo1);
    const int off = r * kRow + (((q4 / 2) ^ (r & 7)) << 4) + 8 * (q4 % 2);
    *reinterpret_cast<uint2*>(T + off) = make_uint2(hi0, hi1);
    *reinterpret_cast<uint2*>(T + kPanel + off) = make_uint2(mid0, mid1);
    *reinterpret_cast<uint2*>(T + 2 * kPanel + off) = make_uint2(lo0, lo1);
  }
  }
  return dot;
}

// An accumulator (64 x 64 fp32, this thread's fragment) into the three
// term regions at SA as a 128-byte-swizzled panel (K-major: the rows of a
// later product's A operand, its columns that product's K).
__device__ __forceinline__ void store_terms(unsigned char* SA,
                                            const float (&v)[32], int r0,
                                            int c0) {
  opaque(r0, c0);
#pragma unroll
  for (int q = 0; q < 32; q += 2) {
    const int at = swz(r0 + 8 * ((q / 2) % 2), 8 * (q / 4) + c0);
    uint32_t hi, mid, lo;
    split3(v[q], v[q + 1], hi, mid, lo);
    *reinterpret_cast<uint32_t*>(SA + at) = hi;
    *reinterpret_cast<uint32_t*>(SA + kPanel + at) = mid;
    *reinterpret_cast<uint32_t*>(SA + 2 * kPanel + at) = lo;
  }
}

// d += A . B over one 64-deep K block with A three bf16 terms in shared
// memory (K-major, kPanel bytes apart; lo first, as the forward) and B a
// bf16 operand in shared memory: K-major rows at `b0` (kTnspB = 0, K at
// 32 bytes a step) or MN-major (kTnspB = 1, K at 16 rows a step).  Each
// operand's descriptor is formed once and stepped by adding the offset to
// its start-address field (16-byte units, within the 256 KB window), so
// that ptxas does not hold a 64-bit descriptor for every wgmma.
template <int kTnspB, bool kSet = true>
__device__ __forceinline__ void product3a(float (&d)[32], uint32_t a0,
                                          uint32_t b0) {
  opaque(a0, b0);
  const uint64_t da = kmajor(a0), db = kTnspB ? mnmajor(b0) : kmajor(b0);
#pragma unroll
  for (int t = 2; t >= 0; --t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = da + (t * kPanel + 32 * kk) / 16;
      const uint64_t b = db + (kTnspB ? 16 * kk * kRow : 32 * kk) / 16;
      if (kSet && t == 2 && kk == 0)
        wgmma_ss_set<kTnspB>(d, a, b);
      else
        wgmma_ss<kTnspB>(d, a, b);
    }
}

// The same with the three terms on the B side (state_in's or g's block
// at b0, kPanel bytes apart) and A a bf16 operand, K-major at a0.
template <int kTnspB, bool kSet = true>
__device__ __forceinline__ void product3b(float (&d)[32], uint32_t a0,
                                          uint32_t b0) {
  opaque(a0, b0);
  const uint64_t da = kmajor(a0), db = kTnspB ? mnmajor(b0) : kmajor(b0);
#pragma unroll
  for (int t = 2; t >= 0; --t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = da + 32 * kk / 16;
      const uint64_t b =
          db + (t * kPanel + (kTnspB ? 16 * kk * kRow : 32 * kk)) / 16;
      if (kSet && t == 2 && kk == 0)
        wgmma_ss_set<kTnspB>(d, a, b);
      else
        wgmma_ss<kTnspB>(d, a, b);
    }
}

// (a) The chunk pass: per head of the block's group and 64-column panel of
// p, the chunk-local state local[n][p] = sum_j B_jn dt_j exp(last - cum_j)
// x_jp and the chunk-local gradient sum back[n][p] = sum_i C_in exp(cum_i)
// dy_ip into the two (b, nc, h, n, p) fp32 scratch arrays, and the chunk's
// last cum.  The scaled B and C are built in registers as the A operands
// (rows n, columns j) in three bf16 terms, x and dy are read MN-major from
// shared memory: the forward's ssd_chunk_pass, twice.
__global__ void __launch_bounds__(kWarpgroup) bwd_tc_chunk_pass(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sb = align1024(smem_raw);
  const uint32_t base = smem_u32(sb);
  const ChunkLayout L(a.N);
  float* dts = reinterpret_cast<float*>(sb + L.dt);
  float* cum = reinterpret_cast<float*>(sb + L.cum);
  float* f = reinterpret_cast<float*>(sb + L.f);
  float* e = reinterpret_cast<float*>(sb + L.e);

  const int grp = blockIdx.x % a.groups, bc = blockIdx.x / a.groups;
  const int c = bc % a.NC, b = bc / a.NC;
  const int s0 = c * kQ, nv = min(kQ, a.S - s0), h0 = grp * a.group;
  const int hg = min(a.group, a.H - h0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int np = panels(a.N), pp = panels(a.P), units = hg * pp;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x) +
                           b * a.xb + s0 * a.xs;
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(a.dy) +
                            b * a.yb + s0 * a.ys;

  load_tile(base + L.C, static_cast<const __nv_bfloat16*>(a.C) + b * a.Cb +
            s0 * a.Cs, a.Cs, kQ, np, nv, a.N, tid, kWarpgroup);
  load_tile(base + L.B, static_cast<const __nv_bfloat16*>(a.B) + b * a.Bb +
            s0 * a.Bs, a.Bs, kQ, np, nv, a.N, tid, kWarpgroup);
  group_cumsum(a.dt, a.db, a.ds, a.dh, a.A, a.S, a.H, a.group, b, s0, h0,
               dts, cum, tid);
  for (int idx = tid; idx < hg * kQ; idx += kWarpgroup) {
    const int g = idx / kQ;
    f[idx] = __fmul_rn(dts[idx], expf(cum[g * kQ + kQ - 1] - cum[idx]));
    e[idx] = expf(cum[idx]);
  }
  if (tid < hg)
    a.cum_last[(static_cast<long long>(b) * a.NC + c) * a.H + h0 + tid] =
        cum[tid * kQ + kQ - 1];

  for (int u = 0; u < units; ++u) {
    const int g = u / pp, pt = u % pp, h = h0 + g;
    load_tile(base + L.X, x + h * a.xh + 64 * pt, a.xs, kQ, 1, nv,
              a.P - 64 * pt, tid, kWarpgroup);
    load_tile(base + L.DY, dy + h * a.yh + 64 * pt, a.ys, kQ, 1, nv,
              a.P - 64 * pt, tid, kWarpgroup);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // x and dy of this unit (and, first, B, C, f, e)
    const float* fg = f + g * kQ;
    const float* eg = e + g * kQ;
    const long long at =
        ((static_cast<long long>(b) * a.NC + c) * a.H + h) * a.N * a.P;
    for (int nt = 0; nt < np; ++nt) {
      const unsigned char* bpanel = sb + L.B + nt * kPanel;
      const unsigned char* cpanel = sb + L.C + nt * kPanel;
      float st[32], gr[32];
      zero(st);
      zero(gr);
      uint32_t bh[4][4], bm[4][4], bl[4][4], ch[4][4], cm[4][4], cl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 16 * kk + 8 * (r / 2) + c0;
          const int n = r0 + 8 * (r % 2);     // within the n tile
          split3(__fmul_rn(bf_at(bpanel + swz(j, n)), fg[j]),
                 __fmul_rn(bf_at(bpanel + swz(j + 1, n)), fg[j + 1]),
                 bh[kk][r], bm[kk][r], bl[kk][r]);
          split3(__fmul_rn(bf_at(cpanel + swz(j, n)), eg[j]),
                 __fmul_rn(bf_at(cpanel + swz(j + 1, n)), eg[j + 1]),
                 ch[kk][r], cm[kk][r], cl[kk][r]);
        }
      wgmma_fence();
      product_rs3(st, bh, bm, bl, base + L.X);
      product_rs3(gr, ch, cm, cl, base + L.DY);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(gr);
#pragma unroll
      for (int q = 0; q < 32; q += 2) {
        const int n = 64 * nt + r0 + 8 * ((q / 2) % 2);
        const int p = 64 * pt + 8 * (q / 4) + c0;
        if (n < a.N && p < a.P) {
          const long long off = at + static_cast<long long>(n) * a.P + p;
          *reinterpret_cast<float2*>(a.states + off) =
              make_float2(st[q], st[q + 1]);
          *reinterpret_cast<float2*>(a.grads + off) =
              make_float2(gr[q], gr[q + 1]);
        }
      }
    }
    __syncthreads();   // x and dy consumed before the next unit's copies
  }
}

// (b) The state walk, 4 consecutive elements of the (n, p) state a thread:
// forward over the chunks, state_in[c] over the local states (state =
// state * exp(last_c) + local[c]); then backward from dfinal (b, h, p, n),
// g[c] over the local gradient sums (g = g * exp(last_c) + back[c]).
__global__ void __launch_bounds__(kStateThreads) bwd_tc_state_pass(Args a) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int e = 4 * (blockIdx.y * kStateThreads + threadIdx.x);
  const int NP = a.N * a.P;
  if (e >= NP) return;
  const long long step = static_cast<long long>(a.H) * NP;
  const long long first = (static_cast<long long>(b) * a.NC * a.H + h) * NP + e;
  const float* cl = a.cum_last + static_cast<long long>(b) * a.NC * a.H + h;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < a.NC; c0 += kAhead) {
    float4 loc[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < a.NC) {
        loc[k] = *reinterpret_cast<const float4*>(a.states + first +
                                                  (c0 + k) * step);
        dec[k] = expf(cl[(c0 + k) * a.H]);
      }
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < a.NC) {
        *reinterpret_cast<float4*>(a.states + first + (c0 + k) * step) = s;
        s.x = __fadd_rn(__fmul_rn(s.x, dec[k]), loc[k].x);
        s.y = __fadd_rn(__fmul_rn(s.y, dec[k]), loc[k].y);
        s.z = __fadd_rn(__fmul_rn(s.z, dec[k]), loc[k].z);
        s.w = __fadd_rn(__fmul_rn(s.w, dec[k]), loc[k].w);
      }
  }
  s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a.dfinal) {
    const int n = e / a.P, p = e % a.P;   // P % 16 == 0: the 4 share n
    const float* df = a.dfinal +
                      (static_cast<long long>(b) * a.H + h) * a.P * a.N + n;
    s = make_float4(df[(p + 0) * a.N], df[(p + 1) * a.N], df[(p + 2) * a.N],
                    df[(p + 3) * a.N]);
  }
  for (int c0 = a.NC - 1; c0 >= 0; c0 -= kAhead) {
    float4 loc[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 - k >= 0) {
        loc[k] = *reinterpret_cast<const float4*>(a.grads + first +
                                                  (c0 - k) * step);
        dec[k] = expf(cl[(c0 - k) * a.H]);
      }
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 - k >= 0) {
        *reinterpret_cast<float4*>(a.grads + first + (c0 - k) * step) = s;
        s.x = __fadd_rn(__fmul_rn(s.x, dec[k]), loc[k].x);
        s.y = __fadd_rn(__fmul_rn(s.y, dec[k]), loc[k].y);
        s.z = __fadd_rn(__fmul_rn(s.z, dec[k]), loc[k].z);
        s.w = __fadd_rn(__fmul_rn(s.w, dec[k]), loc[k].w);
      }
  }
}

// The masked decay of an accumulator entry at (row, col) of the chunk,
// L = exp(cum_i - cum_j) [j <= i] with (i, j) = (row, col) when `lower`
// (S, M: rows i) and (col, row) otherwise (S^T, M^T: rows j); 0 above the
// diagonal, branch-free.
__device__ __forceinline__ float decay(const float* cg, int row, int col,
                                       bool lower) {
  const int i = lower ? row : col, j = lower ? col : row;
  const bool in = j <= i;
  const float l = expf(in ? cg[i] - cg[j] : 0.0f);
  return in ? l : 0.0f;
}

// Adds scale[half] * acc, an accumulator (64 x 64, this thread's fragment:
// rows r0 + 8 half, columns n0 + 8 (q / 4) + c0), into fp32 partial rows at
// `part` (row stride N; only columns < N), over what is there when `add`.
// Four pairs' old values are loaded together before any is stored; the
// two rows' pointers take the columns as immediate offsets.
__device__ __forceinline__ void add_rows(float* part, int N, int r0, int c0,
                                         int n0, bool add,
                                         const float (&acc)[32],
                                         const float (&scale)[2]) {
  opaque(r0, c0);
  float* rows[2] = {part + r0 * N + n0 + c0, part + (r0 + 8) * N + n0 + c0};
  const int cols = N - n0 - c0;   // columns 8 (q / 4) below it are inside
#pragma unroll
  for (int q0 = 0; q0 < 32; q0 += 8) {
    float2 old[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + 2 * k;
      old[k] = (add && 8 * (q / 4) < cols)
                   ? *reinterpret_cast<const float2*>(rows[(q / 2) % 2] +
                                                      8 * (q / 4))
                   : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + 2 * k, half = (q / 2) % 2;
      if (8 * (q / 4) < cols)
        *reinterpret_cast<float2*>(rows[half] + 8 * (q / 4)) =
            make_float2(old[k].x + scale[half] * acc[q],
                        old[k].y + scale[half] * acc[q + 1]);
    }
  }
}

// d = A B^T from two 64-row tiles of NP panels (G = C B^T, rows i, and
// G^T = B C^T, rows j, over n; dy x^T and x dy^T over p): one-term bf16
// wgmma.
template <int NP>
__device__ __forceinline__ void gram(float (&d)[32], uint32_t A, uint32_t B) {
  opaque(A, B);
  const uint64_t da = kmajor(A), db = kmajor(B);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NP; ++kk) {
    const uint32_t off = (kk / 4) * kPanel + 32 * (kk % 4);
    if (kk == 0)
      wgmma_ss_set<0>(d, da + off / 16, db + off / 16);
    else
      wgmma_ss<0>(d, da + off / 16, db + off / 16);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

// What the gradient pass knows of one head.
struct Head {
  const float* cum;    // its cum (Q), shared memory
  const float* dt;     // its dt (Q), shared memory
  float ecum[2], dec[2], dtr[2];   // exp(cum), exp(last - cum), dt: rows
  float D;
  long long sbase;     // its (n, p) state in the scratch
  int h;
  bool written;        // its partials of dB and dC hold an earlier head's
};

// Per-thread sums of the gradient pass over a head's panels of p.
struct Sums {
  float cs[2], cp[2], us[2], xs[2], gdot;
};

// One 64-column panel pp of p of a head's work in the gradient pass; the
// first (kFirst) also forms S and S^T, R's row and column sums, and adds
// S B and S^T C.  Every fp32 operand goes to the tensor cores as three
// bf16 terms in shared memory: S, S^T, M^T (SA) and each 64 x 64 block of
// state_in and g (T), loaded from the scratch one after another.  Each
// product runs in a pass of its own over the blocks, so that one
// accumulator is live in a loop (two at the end: M^T dy and B g^T), and
// the passes whose accumulator does not carry over the blocks stay loops
// (unrolled, ptxas held their offsets for all the blocks at once):
//   dC += [S B] + exp(cum_i) dy state_in
//   dB += [S^T C] + exp(last - cum_j) dt_j x^T g
//   dxdt = M^T dy + exp(last - cum_j) B g^T; dx, u, x . dxdt
// The Args fields it reads are passed one by one: a reference to the
// kernel's parameter struct would copy all of it into registers.
template <int NP, int PP, bool kFirst>
__device__ __forceinline__ void grad_panel(
    const float* states, const float* grads, __nv_bfloat16* dxp, int N,
    int P, int S, int H, unsigned char* sb, uint32_t base, int pp,
    const Head& hd, Sums& sum, float* partB, float* partC, int b, int s0,
    int nv, int tid, int r0, int c0) {
  constexpr GradLayout L(64 * NP, 64 * PP);
  opaque(tid);
  opaque(r0, c0);
  const uint32_t tB = base + L.B, tC = base + L.C, tX = base + L.X,
                 tDY = base + L.DY, tT = base + L.T, tSA = base + L.SA;
  const float one[2] = {1.0f, 1.0f};
  const float w[2] = {hd.dec[0] * hd.dtr[0], hd.dec[1] * hd.dtr[1]};
  if (kFirst) {
    // S = (dy x^T) dt_j L into SA; dC = S B (first written, or added to
    // an earlier head's)
    float S[32];
    gram<PP>(S, tDY, tX);
    int ri = r0, ci = c0;
    opaque(ri, ci);
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int i = ri + 8 * ((q / 2) % 2), j = 8 * (q / 4) + ci + q % 2;
      S[q] = S[q] * hd.dt[j] * decay(hd.cum, i, j, true);
    }
    store_terms(sb + L.SA, S, r0, c0);
    fence_proxy_async();
    __syncthreads();
#pragma unroll 1
    for (int n0 = 0; n0 < NP; ++n0) {
      float sbv[32];
      wgmma_fence();
      product3a<1>(sbv, tSA, tB + n0 * kPanel);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sbv);
      add_rows(partC, N, r0, c0, 64 * n0, hd.written, sbv, one);
    }
  }
  // dC += exp(cum_i) dy state_in, a 64-row block of n at a time; <g,
  // state_in> and the carry-in's share of dcum, C . (exp(cum) state_in^T dy)
#pragma unroll 1
  for (int n0 = 0; n0 < NP; ++n0) {
    sum.gdot += load_terms<true>(sb + L.T, states + hd.sbase,
                                 grads + hd.sbase, N, P, 64 * n0,
                                 64 * pp, tid);
    fence_proxy_async();
    __syncthreads();   // the block's terms ready (S's consumed)
    float off[32];
    wgmma_fence();
    product3b<0>(off, tDY + pp * kPanel, tT);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(off);
    int ri = r0, ci = c0;
    opaque(ri, ci);
#pragma unroll
    for (int q = 0; q < 32; q += 2) {
      const int half = (q / 2) % 2;
      const int i = ri + 8 * half, n = 64 * n0 + 8 * (q / 4) + ci;
      const int at = n0 * kPanel + swz(i, n);
      sum.cp[half] = fmaf(bf_at(sb + L.C + at), hd.ecum[half] * off[q],
                          sum.cp[half]);
      sum.cp[half] = fmaf(bf_at(sb + L.C + at + 2),
                          hd.ecum[half] * off[q + 1], sum.cp[half]);
    }
    add_rows(partC, N, r0, c0, 64 * n0, true, off, hd.ecum);
    __syncthreads();   // the block's terms consumed
  }
  if (kFirst) {
    // S^T = (x dy^T) dt_j L^T into SA; R's column sums (the rows of R^T =
    // S^T * G^T, by quad shuffles) and its row sums (R^T's columns); dB =
    // S^T C
    float ST[32], GT[32];
    gram<PP>(ST, tX, tDY);
    gram<NP>(GT, tB, tC);
    int rj = r0, cj = c0;
    opaque(rj, cj);
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int half = (q / 2) % 2;
      const int j = rj + 8 * half, i = 8 * (q / 4) + cj + q % 2;
      ST[q] = ST[q] * hd.dtr[half] * decay(hd.cum, j, i, false);
      GT[q] *= ST[q];
      sum.cs[half] += GT[q];
    }
    column_sums(GT, reinterpret_cast<float*>(sb + L.cols),
                reinterpret_cast<float*>(sb + L.rrow), tid, c0);
    store_terms(sb + L.SA, ST, r0, c0);
    fence_proxy_async();
    __syncthreads();
#pragma unroll 1
    for (int n0 = 0; n0 < NP; ++n0) {
      float scv[32];
      wgmma_fence();
      product3a<1>(scv, tSA, tC + n0 * kPanel);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(scv);
      add_rows(partB, N, r0, c0, 64 * n0, hd.written, scv, one);
    }
  }
  // dB += exp(last - cum_j) dt_j x^T g, a 64-row block of n at a time
#pragma unroll 1
  for (int n0 = 0; n0 < NP; ++n0) {
    load_terms<false>(sb + L.T, grads + hd.sbase, nullptr, N, P,
                      64 * n0, 64 * pp, tid);
    fence_proxy_async();
    __syncthreads();   // the block's terms ready (S^T's consumed)
    float xg[32];
    wgmma_fence();
    product3b<0>(xg, tX + pp * kPanel, tT);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(xg);
    add_rows(partB, N, r0, c0, 64 * n0, true, xg, w);
    __syncthreads();   // the block's terms consumed
  }
  // gb = B g^T over n, the blocks of g again (from L2), then M^T = G^T
  // L^T into SA
  float gb[32];   // carried over the blocks: the loop stays unrolled
#pragma unroll
  for (int n0 = 0; n0 < NP; ++n0) {
    load_terms<false>(sb + L.T, grads + hd.sbase, nullptr, N, P,
                      64 * n0, 64 * pp, tid);
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
    if (n0 == 0)
      product3b<1>(gb, tB + n0 * kPanel, tT);
    else
      product3b<1, false>(gb, tB + n0 * kPanel, tT);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(gb);
    __syncthreads();   // the block's terms consumed
  }
  {
    float MT[32];
    gram<NP>(MT, tB, tC);
    int rj = r0, cj = c0;
    opaque(rj, cj);
#pragma unroll
    for (int q = 0; q < 32; ++q)
      MT[q] *= decay(hd.cum, rj + 8 * ((q / 2) % 2), 8 * (q / 4) + cj + q % 2,
                     false);
    store_terms(sb + L.SA, MT, r0, c0);
  }
  fence_proxy_async();
  __syncthreads();
  // dxdt = M^T dy + exp(last - cum_j) gb
  float md[32];
  wgmma_fence();
  product3a<1>(md, tSA, tDY + pp * kPanel);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(md);
  int rj = r0, cj = c0;
  opaque(rj, cj);
#pragma unroll
  for (int q = 0; q < 32; q += 2) {
    const int half = (q / 2) % 2;
    const int j = rj + 8 * half, p = 64 * pp + 8 * (q / 4) + cj;
    const int at = pp * kPanel + swz(j, p);
    const __nv_bfloat162 xv =
        *reinterpret_cast<const __nv_bfloat162*>(sb + L.X + at);
    const __nv_bfloat162 yv =
        *reinterpret_cast<const __nv_bfloat162*>(sb + L.DY + at);
    const float x0 = __low2float(xv), x1 = __high2float(xv);
    const float stt0 = hd.dec[half] * gb[q], stt1 = hd.dec[half] * gb[q + 1];
    const float d0 = md[q] + stt0, d1 = md[q + 1] + stt1;
    sum.us[half] = fmaf(x0 * hd.dtr[half], stt0, sum.us[half]);
    sum.us[half] = fmaf(x1 * hd.dtr[half], stt1, sum.us[half]);
    sum.xs[half] = fmaf(x0, d0, sum.xs[half]);
    sum.xs[half] = fmaf(x1, d1, sum.xs[half]);
    if (j < nv && p < P)
      *reinterpret_cast<__nv_bfloat162*>(
          dxp + ((b * static_cast<long long>(S) + s0 + j) * H + hd.h) *
                    P + p) =
          __floats2bfloat162_rn(
              fmaf(hd.D, __low2float(yv), hd.dtr[half] * d0),
              fmaf(hd.D, __high2float(yv), hd.dtr[half] * d1));
  }
  __syncthreads();   // M^T's terms consumed
}

// (c) The gradient pass, one warpgroup per (b, chunk, group of heads): the
// C and B tiles once, then per head ``grad_panel`` over the 64-column
// panels of p: S = (dy x^T) dt_j L, S^T = (x dy^T) dt_j L^T and G^T = B
// C^T from one-term products, scaled in registers, R^T = S^T * G^T's row
// and column sums (R's column and row sums), and dC, dB and dxdt from
// three-term products; dB and dC added in place to per-group fp32
// partials only this block touches; then dcum, its reverse cumsum, ddt and
// the (b, chunk, head) partials of dA and dD as the fp32-FMA pass forms
// them.  G = C B^T is not held across the heads (its 32 registers spilled
// the pass): G^T is formed again where it is used, 4 NP wgmmas.  The fp32
// operands' terms sit in shared memory and at most two accumulators are
// live beside a block's loads, which keeps ptxas from spilling.  NP and
// PP, the 64-row panels of n and of p, are template arguments so that
// every wgmma loop has a fixed trip count; n and p are zero-padded.
template <int NP, int PP>
__global__ void __launch_bounds__(kWarpgroup) bwd_tc_grad_pass(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sb = align1024(smem_raw);
  const uint32_t base = smem_u32(sb);
  constexpr GradLayout L(64 * NP, 64 * PP);   // panels(N) = NP, (P) = PP
  float* dts = reinterpret_cast<float*>(sb + L.dt);
  float* cums = reinterpret_cast<float*>(sb + L.cum);
  float* rrow = reinterpret_cast<float*>(sb + L.rrow);
  float* rcol = reinterpret_cast<float*>(sb + L.rcol);
  float* cpart = reinterpret_cast<float*>(sb + L.cpart);
  float* uu = reinterpret_cast<float*>(sb + L.uu);
  float* xd = reinterpret_cast<float*>(sb + L.xd);
  float* red = reinterpret_cast<float*>(sb + L.red);

  const int grp = blockIdx.x % a.groups, bc = blockIdx.x / a.groups;
  const int c = bc % a.NC, b = bc / a.NC;
  const int s0 = c * kQ, nv = min(kQ, a.S - s0), h0 = grp * a.group;
  const int hg = min(a.group, a.H - h0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x) +
                           b * a.xb + s0 * a.xs;
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(a.dy) +
                            b * a.yb + s0 * a.ys;
  const long long prow = (static_cast<long long>(grp) * a.batch + b) *
                             a.NC * kQ + s0;   // the first partial row
  float* partB = a.partB + prow * a.N;
  float* partC = a.partC + prow * a.N;
  __nv_bfloat16* dxp = static_cast<__nv_bfloat16*>(a.dx);

  load_tile(base + L.C, static_cast<const __nv_bfloat16*>(a.C) + b * a.Cb +
            s0 * a.Cs, a.Cs, kQ, NP, nv, a.N, tid, kWarpgroup);
  load_tile(base + L.B, static_cast<const __nv_bfloat16*>(a.B) + b * a.Bb +
            s0 * a.Bs, a.Bs, kQ, NP, nv, a.N, tid, kWarpgroup);
  group_cumsum(a.dt, a.db, a.ds, a.dh, a.A, a.S, a.H, a.group, b, s0, h0,
               dts, cums, tid);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  for (int hi = 0; hi < hg; ++hi) {
    Head hd;
    hd.h = h0 + hi;
    hd.cum = cums + hi * kQ;
    hd.dt = dts + hi * kQ;
    const float last = hd.cum[kQ - 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + 8 * half;
      hd.ecum[half] = expf(hd.cum[i]);
      hd.dec[half] = expf(last - hd.cum[i]);
      hd.dtr[half] = hd.dt[i];
    }
    hd.D = a.D[hd.h];
    hd.sbase = ((static_cast<long long>(b) * a.NC + c) * a.H + hd.h) * a.N *
               a.P;
    hd.written = hi > 0;
    int t = tid;   // offsets from it are formed here, not held across heads
    opaque(t);
    load_tile(base + L.X, x + hd.h * a.xh, a.xs, kQ, PP, nv, a.P, t,
              kWarpgroup);
    load_tile(base + L.DY, dy + hd.h * a.yh, a.ys, kQ, PP, nv, a.P, t,
              kWarpgroup);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // x and dy of this head

    // dy . x for dD
    float dd = 0.0f;
    opaque(t);
    for (int idx = t; idx < kQ * 64 * PP; idx += kWarpgroup) {
      const int r = idx / (64 * PP), col = idx % (64 * PP);
      const int off = (col / 64) * kPanel + swz(r, col);
      dd = fmaf(bf_at(sb + L.DY + off), bf_at(sb + L.X + off), dd);
    }
    Sums sum = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f},
                0.0f};
    grad_panel<NP, PP, true>(a.states, a.grads, dxp, a.N, a.P, a.S, a.H, sb,
                             base, 0, hd, sum, partB, partC, b, s0, nv, tid,
                             r0, c0);
#pragma unroll 1
    for (int pp = 1; pp < PP; ++pp)
      grad_panel<NP, PP, false>(a.states, a.grads, dxp, a.N, a.P, a.S, a.H,
                                sb, base, pp, hd, sum, partB, partC, b, s0,
                                nv, tid, r0, c0);

    // the per-row sums, each row's by its quad, into shared memory
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float cq = quad_sum(sum.cs[half]);
      const float pq = quad_sum(sum.cp[half]), uq = quad_sum(sum.us[half]);
      const float xq = quad_sum(sum.xs[half]);
      if (lane % 4 == 0) {
        const int i = r0 + 8 * half;
        rcol[i] = cq;
        cpart[i] = pq;
        uu[i] = uq;
        xd[i] = xq;
      }
    }
    const float gsum = block_sum(sum.gdot, red, tid);
    const float dsum = block_sum(dd, red + 4, tid);
    // the last row's terms, da, ddt and the partials of dA and dD
    if (tid == 0) {
      const float A = a.A[hd.h];
      float usum = 0.0f;
      for (int i = 0; i < kQ; ++i) usum += uu[i];
      float run = 0.0f, da_dt = 0.0f;
      for (int i = kQ - 1; i >= 0; --i) {
        float dcum = rrow[i] - rcol[i];
        dcum = dcum + cpart[i] - uu[i];
        if (i == kQ - 1) dcum += expf(hd.cum[kQ - 1]) * gsum + usum;
        run += dcum;
        da_dt = fmaf(hd.dt[i], run, da_dt);
        if (i < nv)
          a.ddt[(b * static_cast<long long>(a.S) + s0 + i) * a.H + hd.h] =
              fmaf(A, run, xd[i]);
      }
      const long long at = (static_cast<long long>(b) * a.NC + c) * a.H +
                           hd.h;
      a.partA[at] = da_dt;
      a.partD[at] = dsum;
    }
    __syncthreads();   // the row sums consumed before the next head
  }
}

template <int NP, int PP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static bool chunk_done[kMaxDevices], grad_done[kMaxDevices];
  cudaError_t err = allow_smem(bwd_tc_chunk_pass, chunk_done);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_tc_grad_pass<NP, PP>, grad_done);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(a.batch) * a.NC * a.groups);
  bwd_tc_chunk_pass<<<blocks, kWarpgroup, ChunkLayout(a.N).bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 sgrid(a.batch * a.H,
                   (a.N * a.P / 4 + kStateThreads - 1) / kStateThreads);
  bwd_tc_state_pass<<<sgrid, kStateThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_tc_grad_pass<NP, PP><<<blocks, kWarpgroup, GradLayout(a.N, a.P).bytes,
                             stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long outs = static_cast<long long>(a.batch) * a.S * a.N;
  bwd_reduce<__nv_bfloat16><<<static_cast<unsigned>(
                                  (outs + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  switch (panels(a.P)) {
    case 1: return launch<NP, 1>(a, stream);
    case 2: return launch<NP, 2>(a, stream);
    case 3: return launch<NP, 3>(a, stream);
    default: return launch<NP, 4>(a, stream);
  }
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  switch (panels(a.N)) {
    case 1: return launch<1>(a, stream);
    case 2: return launch<2>(a, stream);
    case 3: return launch<3>(a, stream);
    default: return launch<4>(a, stream);
  }
}

}  // namespace tc

extern "C" {

// Shared memory of the larger of the two block kernels, in bytes (the
// wrapper checks it against a block's limit).
long long ssd_backward_smem_bytes(int Q, int P, int N) {
  const long long c = chunk_smem_floats(Q, P, N);
  const long long g = grad_smem_floats(Q, P, N);
  return static_cast<long long>(sizeof(float)) * (c > g ? c : g);
}

// dx, ddt, dA, dB, dC, dD of (y, final_state) = ssd_scan(x, dt, A, B, C,
// D) given dy and dfinal, on `stream`.  x, B, C, dy, dx, dB, dC all fp32
// (bf16 = 0) or all bf16; dt, A, D, dfinal, ddt, dA, dD fp32.  x (batch,
// S, H, P) with element strides x_s*, unit stride over P; dy likewise with
// dy_s*; dt (batch, S, H) with dt_s*; B, C (batch, S, N) with *_sb, *_ss
// and unit stride over N; A, D (H,); dfinal (batch, H, P, N) dense, or
// null for zeros.  dx (batch, S, H, P), ddt (batch, S, H), dB, dC (batch,
// S, N) and dA, dD (H,) are written dense.  Q (the chunk) a multiple of 8
// in [8, 128], N a multiple of 4, `group` heads (1 to 4) per block.  The
// fp32 scratch the caller allocates: states and grads (batch, ceil(S/Q),
// H, P, N) each, cum_last, partA, partD (batch, ceil(S/Q), H) each, partB
// and partC (ceil(H/group), batch, ceil(S/Q) Q, N) each.  Returns the
// cudaError_t of the launches (0 on success); does not synchronize or
// allocate.
int ssd_scan_backward(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* D,
                      const void* dy, const void* dfinal, void* dx,
                      void* ddt, void* dA, void* dB, void* dC, void* dD,
                      void* states, void* grads, void* cum_last,
                      void* partB, void* partC, void* partA, void* partD,
                      int bf16, int batch, int S, int H, int P, int N,
                      int Q, int group, long long x_sb, long long x_ss,
                      long long x_sh, long long dy_sb, long long dy_ss,
                      long long dy_sh, long long dt_sb, long long dt_ss,
                      long long dt_sh, long long B_sb, long long B_ss,
                      long long C_sb, long long C_ss, void* stream) {
  const long long nc = (static_cast<long long>(S) + Q - 1) / Q;
  const int groups = group >= 1 ? (H + group - 1) / group : 0;
  if (batch < 1 || S < 1 || H < 1 || P < 1 || N < 4 || N % 4 != 0 ||
      Q < 8 || Q > kMaxQ || Q % 8 != 0 || group < 1 || group > kMaxGroup ||
      batch * nc * groups > 2147483647LL ||
      static_cast<long long>(batch) * H * P * N / kThreads > 2147483647LL ||
      static_cast<long long>(batch) * S * N / kThreads > 2147483647LL ||
      ssd_backward_smem_bytes(Q, P, N) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x; a.B = B; a.C = C; a.dy = dy;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.dfinal = static_cast<const float*>(dfinal);
  a.dx = dx; a.dB = dB; a.dC = dC;
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dD = static_cast<float*>(dD);
  a.states = static_cast<float*>(states);
  a.grads = static_cast<float*>(grads);
  a.cum_last = static_cast<float*>(cum_last);
  a.partB = static_cast<float*>(partB);
  a.partC = static_cast<float*>(partC);
  a.partA = static_cast<float*>(partA);
  a.partD = static_cast<float*>(partD);
  a.xb = x_sb; a.xs = x_ss; a.xh = x_sh;
  a.yb = dy_sb; a.ys = dy_ss; a.yh = dy_sh;
  a.db = dt_sb; a.ds = dt_ss; a.dh = dt_sh;
  a.Bb = B_sb; a.Bs = B_ss; a.Cb = C_sb; a.Cs = C_ss;
  a.batch = batch; a.H = H; a.S = S; a.P = P; a.N = N; a.Q = Q;
  a.NC = static_cast<int>(nc);
  a.group = group;
  a.groups = groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<__nv_bfloat16>(a, s)
                               : launch<float>(a, s);
  return static_cast<int>(err);
}

// Resident blocks per SM of the tensor-core gradient pass at (P, N) on the
// current device (with its dynamic shared memory), or -1 on an error.
int ssd_backward_tc_occupancy(int P, int N) {
  int blocks = -1;
  const size_t smem = tc::GradLayout(N, P).bytes;
  cudaError_t err = cudaErrorInvalidValue;
#define SSD_OCC(np, pp)                                                     \
  if (tc::panels(N) == np && tc::panels(P) == pp) {                        \
    static bool done[kMaxDevices];                                         \
    err = allow_smem(tc::bwd_tc_grad_pass<np, pp>, done);                   \
    if (err == cudaSuccess)                                                \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
          &blocks, tc::bwd_tc_grad_pass<np, pp>, tc::kWarpgroup, smem);    \
  }
  SSD_OCC(1, 1) SSD_OCC(1, 2) SSD_OCC(1, 3) SSD_OCC(1, 4)
  SSD_OCC(2, 1) SSD_OCC(2, 2) SSD_OCC(2, 3) SSD_OCC(2, 4)
  SSD_OCC(3, 1) SSD_OCC(3, 2) SSD_OCC(3, 3) SSD_OCC(3, 4)
  SSD_OCC(4, 1) SSD_OCC(4, 2) SSD_OCC(4, 3) SSD_OCC(4, 4)
#undef SSD_OCC
  return err == cudaSuccess ? blocks : -1;
}

// Shared memory of the larger block kernel of the tensor-core instance, in
// bytes (chunk 64; the wrapper checks it against a block's limit).
long long ssd_backward_tc_smem_bytes(int P, int N) {
  const long long c = tc::ChunkLayout(N).bytes;
  const long long g = tc::GradLayout(N, P).bytes;
  return c > g ? c : g;
}

// The tensor-core instance: x, B, C, dy and dx, dB, dC bf16, the rest as
// ssd_scan_backward, with chunk Q = 64, P and N multiples of 16 in [16,
// 256], `group` heads (1 to 4) per block, 16-byte-aligned x, B, C and dy
// and element strides that are multiples of 8 (16 bytes) over every axis
// of size above 1.  The same scratch as ssd_scan_backward (states and
// grads here (batch, ceil(S/64), H, N, P)).  Same return convention; the
// four kernels are launched in order on `stream`.
int ssd_scan_backward_tc(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, const void* D,
                         const void* dy, const void* dfinal, void* dx,
                         void* ddt, void* dA, void* dB, void* dC, void* dD,
                         void* states, void* grads, void* cum_last,
                         void* partB, void* partC, void* partA, void* partD,
                         int batch, int S, int H, int P, int N, int Q,
                         int group, long long x_sb, long long x_ss,
                         long long x_sh, long long dy_sb, long long dy_ss,
                         long long dy_sh, long long dt_sb, long long dt_ss,
                         long long dt_sh, long long B_sb, long long B_ss,
                         long long C_sb, long long C_ss, void* stream) {
  bool ok = batch >= 1 && S >= 1 && H >= 1 && Q == tc::kQ && P >= 16 &&
            P <= 256 && P % 16 == 0 && N >= 16 && N <= 256 && N % 16 == 0 &&
            group >= 1 && group <= kMaxGroup &&
            ssd_backward_tc_smem_bytes(P, N) <= kSmemLimit;
  const long long nc = (static_cast<long long>(S) + Q - 1) / Q;
  const int groups = group >= 1 ? (H + group - 1) / group : 0;
  ok = ok && batch * nc * groups <= 2147483647LL &&
       static_cast<long long>(batch) * H <= 2147483647LL &&
       static_cast<long long>(batch) * S * N / kThreads <= 2147483647LL;
  const long long strides[10][2] = {
      {x_sb, batch}, {x_ss, S}, {x_sh, H}, {dy_sb, batch}, {dy_ss, S},
      {dy_sh, H}, {B_sb, batch}, {B_ss, S}, {C_sb, batch}, {C_ss, S}};
  for (const auto& st : strides) ok = ok && (st[1] == 1 || st[0] % 8 == 0);
  const void* const bases[4] = {x, B, C, dy};
  for (const void* ptr : bases)
    ok = ok && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x; a.B = B; a.C = C; a.dy = dy;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.dfinal = static_cast<const float*>(dfinal);
  a.dx = dx; a.dB = dB; a.dC = dC;
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dD = static_cast<float*>(dD);
  a.states = static_cast<float*>(states);
  a.grads = static_cast<float*>(grads);
  a.cum_last = static_cast<float*>(cum_last);
  a.partB = static_cast<float*>(partB);
  a.partC = static_cast<float*>(partC);
  a.partA = static_cast<float*>(partA);
  a.partD = static_cast<float*>(partD);
  a.xb = x_sb; a.xs = x_ss; a.xh = x_sh;
  a.yb = dy_sb; a.ys = dy_ss; a.yh = dy_sh;
  a.db = dt_sb; a.ds = dt_ss; a.dh = dt_sh;
  a.Bb = B_sb; a.Bs = B_ss; a.Cb = C_sb; a.Cs = C_ss;
  a.batch = batch; a.H = H; a.S = S; a.P = P; a.N = N; a.Q = Q;
  a.NC = static_cast<int>(nc);
  a.group = group;
  a.groups = groups;
  return static_cast<int>(tc::launch(a, static_cast<cudaStream_t>(stream)));
}

const char* ssd_scan_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
