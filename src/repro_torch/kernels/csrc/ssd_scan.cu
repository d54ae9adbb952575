// Mamba-2 SSD chunked scan for Hopper (sm_90a), returning the final SSM
// state.  Plain C interface, bound with ctypes by
// src/repro_torch/kernels/ops.py; built by src/repro_torch/kernels/build.py.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   ssd_scan  <- repro/kernels/ssd_scan.py:ssd_scan (_ssd_kernel)
// and computes what it computes, for x (b, s, h, p), dt (b, s, h) fp32,
// A and D (h,) fp32 and B, C (b, s, n) shared by the heads, chunk by chunk
// of Q rows with the (p, n) state carried across the chunks:
//   cum   = cumsum(dt * A)                         (in index order)
//   y     = ((C B^T) * exp(cum_i - cum_j) [j <= i]) @ (x * dt)
//           + exp(cum) * (C @ state^T) + D * x     (fp32, rounded once)
//   state = state * exp(cum[-1]) + (x*dt)^T @ (B * exp(cum[-1] - cum))
// and, unlike the Pallas kernel (which keeps the state in VMEM scratch and
// drops it), it writes the final state (b, h, p, n) in fp32: the model's
// prefill seeds the decode cache with it.  Every decay is an exp of a
// difference of cumulative sums, never a ratio of exp(cum), which
// underflows over a chunk when A*dt is large.  A ragged s is taken here:
// the rows past s are loaded as dt = 0, x = B = C = 0, an exact fixed
// point (decay exp(0) = 1, x*dt = 0), and their y rows are not stored.
//
// What bounds it on an H100: at mamba2-370m's prefill shapes (h 32, p 64,
// n 128, Q 64, bf16 x/B/C) one layer does ~1.8e6 flops per row against
// ~9 kB moved per row (x and y, dt, B, C, the final state once): a bound
// set by the bytes (5.7 us at s = 2048), with the flops at 3.8 us on the
// bf16 tensor cores.  This first kernel does every product as fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak): right and simple first; the tensor
// cores (wgmma on C B^T and the two (p, n) products) are a later kernel PR.
//
// Design: one block of 256 threads per (b*h, 16 columns of p) walks the
// chunks in order (the loop takes the place of the Pallas grid's
// sequential chunk axis); its (n, 16) slice of the state lives in shared
// memory, so the Q x Q tile (C B^T) * L is recomputed by each of the p/16
// blocks of a head — at p = 64 that gives 4 * b * h blocks (128 at b = 1)
// for the card's 132 SMs, where one block per (b, h) would fill 32.  Per
// chunk, with barriers between the phases:
//   (a) dt, x (the block's 16 columns) and B, C (transposed, n-major) are
//       loaded into shared memory, bf16 widened exactly;
//   (b) one thread sums cum in index order (the plain version's order, with
//       no contraction into an FMA); its warp forms exp(cum) and
//       exp(cum[-1] - cum); the others form x*dt;
//   (c) the lower-triangular 4x4 tiles of (C B^T) * L (register tiles over
//       n), B * exp(cum[-1] - cum) row-major (from B^T), and each thread's
//       4 rows x 1 column of y started from the carry-in and the D skip;
//   (d) y += ((C B^T) * L) @ (x*dt) and stored; the state slice decays and
//       takes this chunk's input (4 x 2 register tiles over the rows).
// x, B and C are read through their strides (the model hands in column
// slices of one conv output); p and n have unit stride; y and the final
// state are written dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 16;          // columns of p per block
constexpr int kMaxQ = 128;       // chunk rows: a multiple of 8, at most 128
constexpr int kMaxYTiles = (kMaxQ / 4) * kPT / kThreads;
constexpr int kSmemLimit = 232448;

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
  return __float2bfloat16_rn(x);   // the one rounding of y
}

struct Strides {
  long long xb, xs, xh;   // x (b, s, h, p), elements; p has unit stride
  long long db, ds, dh;   // dt (b, s, h)
  long long Bb, Bs;       // B (b, s, n); n has unit stride
  long long Cb, Cs;       // C (b, s, n)
};

// Row stride of the n-major (transposed) B and C tiles: Q + 8 keeps float4
// rows aligned and makes the (8 rows x 4 n) store pattern of phase (a) hit
// 32 distinct banks.
__host__ __device__ constexpr int qpad(int Q) { return Q + 8; }

// Shared memory of one block, in floats: cum, dt, exp(cum), exp(cum[-1] -
// cum) (Q each); x and x*dt (Q x 16); B^T and C^T (n x (Q+8)); the decayed
// B (Q x (n+4)); (C B^T) * L (Q x (Q+8)); the state slice (n x 16).
__host__ __device__ constexpr long long smem_floats(int Q, int N) {
  return 4LL * Q + 2LL * Q * kPT + 2LL * N * qpad(Q) + 1LL * Q * (N + 4) +
         1LL * Q * qpad(Q) + 1LL * N * kPT;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dv,
           T* __restrict__ y, float* __restrict__ final_state, int H, int S,
           int P, int N, int Q, Strides st_) {
  extern __shared__ __align__(16) float sm[];
  const int QP = qpad(Q), NP = N + 4;
  float* cum = sm;                  // Q
  float* dts = cum + Q;             // Q
  float* ecum = dts + Q;            // Q: exp(cum_i)
  float* dec = ecum + Q;            // Q: exp(cum[-1] - cum_j)
  float* xs = dec + Q;              // Q x kPT
  float* xdt = xs + Q * kPT;        // Q x kPT
  float* Bt = xdt + Q * kPT;        // N x QP
  float* Ct = Bt + N * QP;          // N x QP
  float* Bd = Ct + N * QP;          // Q x NP
  float* Gs = Bd + Q * NP;          // Q x QP
  float* st = Gs + Q * QP;          // N x kPT

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int p0 = blockIdx.y * kPT;
  const int tid = threadIdx.x;
  const float a = A[h], dskip = Dv[h];
  const T* xb = x + b * st_.xb + h * st_.xh + p0;
  const float* dtb = dt + b * st_.db + h * st_.dh;
  const T* Bb = Bm + b * st_.Bb;
  const T* Cb = Cm + b * st_.Cb;

  for (int i = tid; i < N * kPT; i += kThreads) st[i] = 0.0f;

  const int nchunks = (S + Q - 1) / Q;
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * Q;
    const int nv = min(Q, S - s0);   // rows of this chunk inside s

    // (a) loads; the rows past s are zeros (dt = 0: the fixed point)
    if (tid < Q) dts[tid] = tid < nv ? dtb[(s0 + tid) * st_.ds] : 0.0f;
#pragma unroll 4
    for (int idx = tid; idx < Q * kPT; idx += kThreads) {
      const int i = idx / kPT, p = idx % kPT;
      xs[idx] = (i < nv && p0 + p < P) ? widen(xb[(s0 + i) * st_.xs + p])
                                       : 0.0f;
    }
#pragma unroll 8
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      // micro-tiles of 8 rows x 4 n per warp: conflict-free n-major stores
      const int micro = idx / 32, lane = idx % 32;
      const int i = (micro % (Q / 8)) * 8 + lane % 8;
      const int n = (micro / (Q / 8)) * 4 + lane / 8;
      const bool ok = i < nv;
      Bt[n * QP + i] = ok ? widen(Bb[(s0 + i) * st_.Bs + n]) : 0.0f;
      Ct[n * QP + i] = ok ? widen(Cb[(s0 + i) * st_.Cs + n]) : 0.0f;
    }
    __syncthreads();

    // (b) cumulative decays in index order, and x * dt
    if (tid < 32) {
      if (tid == 0) {
        float run = 0.0f;
        for (int i = 0; i < Q; ++i) {
          run = __fadd_rn(run, __fmul_rn(dts[i], a));
          cum[i] = run;
        }
      }
      __syncwarp();
      const float last = cum[Q - 1];
      for (int i = tid; i < Q; i += 32) {
        ecum[i] = expf(cum[i]);
        dec[i] = expf(last - cum[i]);
      }
    }
    for (int idx = tid; idx < Q * kPT; idx += kThreads)
      xdt[idx] = xs[idx] * dts[idx / kPT];
    __syncthreads();

    // (c.1) the lower-triangular 4x4 tiles of (C B^T) * L, row-major
    const int nt = Q / 4;
    for (int t = tid; t < nt * (nt + 1) / 2; t += kThreads) {
      int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      while (ti * (ti + 1) / 2 > t) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      const int tj = t - ti * (ti + 1) / 2;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(Ct + n * QP + 4 * ti);
        const float4 bv = *reinterpret_cast<const float4*>(Bt + n * QP + 4 * tj);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cr[r], bq[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        float out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * tj + q;
          out[q] = j <= i ? acc[r][q] * expf(cum[i] - cum[j]) : 0.0f;
        }
        *reinterpret_cast<float4*>(Gs + i * QP + 4 * tj) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    // (c.2) B * exp(cum[-1] - cum), row-major (row stride n + 4: the
    // 8 rows x 4 n pattern reads B^T and writes here without conflicts)
#pragma unroll 8
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      const int micro = idx / 32, lane = idx % 32;
      const int j = (micro % (Q / 8)) * 8 + lane % 8;
      const int n = (micro / (Q / 8)) * 4 + lane / 8;
      Bd[j * NP + n] = Bt[n * QP + j] * dec[j];
    }
    // (c.3) y starts from the carry-in exp(cum) * (C @ state^T) and D * x;
    // thread tile: 4 rows x 1 column, kept in registers through (d)
    float yacc[kMaxYTiles][4];
#pragma unroll
    for (int k = 0; k < kMaxYTiles; ++k) {
      const int t = tid + k * kThreads;
      if (t >= nt * kPT) break;
      const int p = t % kPT, i0 = 4 * (t / kPT);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(Ct + n * QP + i0);
        const float sv = st[n * kPT + p];
        acc[0] = fmaf(cv.x, sv, acc[0]);
        acc[1] = fmaf(cv.y, sv, acc[1]);
        acc[2] = fmaf(cv.z, sv, acc[2]);
        acc[3] = fmaf(cv.w, sv, acc[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        yacc[k][r] = acc[r] * ecum[i0 + r] + dskip * xs[(i0 + r) * kPT + p];
    }
    __syncthreads();

    // (d.1) y += ((C B^T) * L) @ (x*dt) over the rows j <= i; store
    T* yrow = y + (static_cast<long long>(b) * S + s0) * H * P +
              static_cast<long long>(h) * P + p0;
#pragma unroll
    for (int k = 0; k < kMaxYTiles; ++k) {
      const int t = tid + k * kThreads;
      if (t >= nt * kPT) break;
      const int p = t % kPT, i0 = 4 * (t / kPT);
      for (int j4 = 0; j4 < i0 + 4; j4 += 4) {
        const float xv[4] = {xdt[j4 * kPT + p], xdt[(j4 + 1) * kPT + p],
                             xdt[(j4 + 2) * kPT + p], xdt[(j4 + 3) * kPT + p]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 g =
              *reinterpret_cast<const float4*>(Gs + (i0 + r) * QP + j4);
          float v = yacc[k][r];
          v = fmaf(g.x, xv[0], v);
          v = fmaf(g.y, xv[1], v);
          v = fmaf(g.z, xv[2], v);
          v = fmaf(g.w, xv[3], v);
          yacc[k][r] = v;
        }
      }
      if (p0 + p < P) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (i0 + r < nv)
            yrow[static_cast<long long>(i0 + r) * H * P + p] =
                narrow<T>(yacc[k][r]);
      }
    }
    // (d.2) state = state * exp(cum[-1]) + (x*dt)^T @ (B * decay);
    // thread tile: 4 n x 2 columns
    const float chunk_decay = ecum[Q - 1];
    for (int t = tid; t < (N / 4) * (kPT / 2); t += kThreads) {
      const int p2 = 2 * (t % (kPT / 2)), n0 = 4 * (t / (kPT / 2));
      float s[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[q][0] = st[(n0 + q) * kPT + p2] * chunk_decay;
        s[q][1] = st[(n0 + q) * kPT + p2 + 1] * chunk_decay;
      }
#pragma unroll 4
      for (int j = 0; j < nv; ++j) {
        const float4 bd = *reinterpret_cast<const float4*>(Bd + j * NP + n0);
        const float2 xv = *reinterpret_cast<const float2*>(xdt + j * kPT + p2);
        const float bq[4] = {bd.x, bd.y, bd.z, bd.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[q][0] = fmaf(bq[q], xv.x, s[q][0]);
          s[q][1] = fmaf(bq[q], xv.y, s[q][1]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        st[(n0 + q) * kPT + p2] = s[q][0];
        st[(n0 + q) * kPT + p2 + 1] = s[q][1];
      }
    }
    __syncthreads();   // st, Gs, Bd and xdt consumed before the next chunk
  }

  float* fb = final_state + (static_cast<long long>(b) * H + h) * P * N;
  for (int idx = tid; idx < kPT * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    if (p0 + p < P) fb[static_cast<long long>(p0 + p) * N + n] = st[n * kPT + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* D, void* y,
                   void* final_state, int batch, int S, int H, int P, int N,
                   int Q, Strides st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q, N);
  // on every launch: the attribute is per device, and the call is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * H, (P + kPT - 1) / kPT);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(final_state), H, S, P, N, Q,
      st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes (the wrapper checks it).
long long ssd_scan_smem_bytes(int Q, int N) {
  return static_cast<long long>(sizeof(float)) * smem_floats(Q, N);
}

// y, final_state = ssd_scan(x, dt, A, B, C, D) on `stream`.  x, B, C and y
// all fp32 (bf16 = 0) or all bf16; dt, A, D and final_state fp32.  x is
// (batch, S, H, P) with element strides x_sb, x_ss, x_sh and unit stride
// over P; dt (batch, S, H) with strides dt_sb, dt_ss, dt_sh; B and C
// (batch, S, N) with strides *_sb, *_ss and unit stride over N; A, D (H,)
// and y (batch, S, H, P), final_state (batch, H, P, N) dense.  Q (the
// chunk) a multiple of 8 in [8, 128]; N a multiple of 4.  Returns the
// cudaError_t of the launch (0 on success); does not synchronize or
// allocate.
int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* D, void* y, void* final_state,
             int bf16, int batch, int S, int H, int P, int N, int Q,
             long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
             long long dt_ss, long long dt_sh, long long B_sb,
             long long B_ss, long long C_sb, long long C_ss, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || P < 1 || N < 4 || N % 4 != 0 ||
      Q < 8 || Q > kMaxQ || Q % 8 != 0 ||
      static_cast<long long>(batch) * H > 2147483647LL ||
      (P + kPT - 1) / kPT > 65535 || ssd_scan_smem_bytes(Q, N) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                   B_sb, B_ss, C_sb, C_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, dt, A, B, C, D, y, final_state, batch,
                                   S, H, P, N, Q, st, s)
           : launch<float>(x, dt, A, B, C, D, y, final_state, batch, S, H, P,
                           N, Q, st, s);
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
