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
// dx, B, C, dB, dC, dt, ddt; 0.07 ms at 3.35 TB/s) and does ~4.7 MFLOP a
// row (six p x n products a row and head, the Q x Q products within the
// chunk; 0.08 ms at the bf16 tensor peak).  This first kernel does it all
// as fp32 FMAs on the CUDA cores (67 TFLOP/s peak: ~1.2 ms at best) plus
// the fp32 state scratch (4 x 268 MB at that shape), so it sits well
// above that bound; the tensor cores (bf16 wgmma with the fp32 operands
// cut into bf16 terms, as ssd_output_pass does) are the next step.
//
// Four kernels, launched in order on the stream, each owning its outputs
// (no atomics anywhere, every sum in a fixed order, so two launches on the
// same inputs give the same bits):
//   (a) bwd_chunk_pass, one block per (b, chunk, group of heads): B and C
//       of the chunk in shared memory once; per head, cum, then the
//       chunk-local state sum_j exp(last - cum_j) xdt_j (x) B_j and the
//       chunk-local sum_i exp(cum_i) dy_i (x) C_i (p x n, 4x4 register
//       tiles over Q), into two fp32 scratch arrays (b, nc, h, p, n) the
//       wrapper allocates, and last into a third (recomputed here, so the
//       forward's interface and timings stay as they are);
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
// Every product is a 4x4 register tile over float4 loads from shared
// memory whose rows are padded by 4 floats.  x, dy, B and C are read
// through their strides (unit stride over p and n), so the model's column
// slices of its conv output go in without a copy; dx, dB, dC (input dtype)
// and ddt (fp32) are written dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

const char* ssd_scan_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
