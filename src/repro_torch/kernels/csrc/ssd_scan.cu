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
// bf16 tensor cores.
//
// Two instances; the wrapper picks one by dtype and shape alone
// (ops.ssd_instance):
//
// * ssd_scan_tc ("wgmma": bf16, chunk 64 or 128, p and n multiples of 16
//   up to 256 — every model the port serves at full width) is
//   chunk-parallel SSD on the tensor cores, in three kernels launched one
//   after another on the stream:
//   (a) ssd_chunk_pass, one block per (b, chunk, group of 4 heads): each
//       head's chunk-local state (n, p) = (B * dt * exp(cum[-1] - cum))^T
//       @ x on bf16 wgmma (m64n64k16, the decayed B as the A operand in
//       registers, x from shared memory MN-major), written with the
//       chunk's last cum to an fp32 scratch the wrapper allocates
//       ((b, nc, h, n, p): 33.5 MB at s = 2048);
//   (b) ssd_state_pass, elementwise per (b*h, 4 elements of n*p): walks
//       the chunks in order, state_in[c] = state, state = state *
//       exp(cum_last[c]) + local[c], in place over the scratch, and
//       writes the final state;
//   (c) ssd_output_pass, one block per (b, chunk, group of heads): G =
//       C B^T once for the group (K-major bf16 wgmma from shared memory,
//       kept in registers across the heads — 32 times per (b, chunk) at
//       h 32 instead of 128), then per head y = ((G * L) * dt_j) @ x (the
//       scores built in registers from G as the A operand) + exp(cum) *
//       (C @ state_in^T) (state_in MN-major in shared memory) + D * x,
//       rounded once to bf16.
//   The chunks no longer run serially inside a block, so the grid has
//   b * nc * h / 4 blocks (256 at s = 2048) of 128 threads (256 at chunk
//   128: one warpgroup per 64 rows) with no barrier per chunk row.  x, B
//   and C reach shared memory by 16-byte cp.async copies (zero-filled past
//   s and past p or n) into 128-byte-swizzled panels of 64 columns, the
//   layout the wgmma descriptors read; the views' strides are honoured, so
//   the model's column slices of its conv output go in without a copy
//   (bases and row strides must be 16-byte aligned).  x, B and C are bf16
//   and go to the tensor cores exactly; the three fp32 operands (the
//   masked scores, the decayed B, state_in) are each cut into three bf16
//   terms, hi + mid + lo, which hold their 24 bits, and each term is its
//   own wgmma into one fp32 accumulator (lo first): one term misses the
//   port's one-bf16-ulp check of y by ~10^3x, two terms by up to ~20x on
//   standard-normal inputs (tests/test_torch_ssd_split.py emulates it).
//   cum is summed in index order by one thread per head in both passes
//   (the same bits), every sum has a fixed order and no atomics, so two
//   calls give the same bits.
//
// * ssd_scan ("fma": fp32, and bf16 at other shapes) is the port's first
//   kernel: every product as fp32 FMAs on the CUDA cores (67 TFLOP/s
//   peak).  One block of 256 threads per (b*h, 16 columns of p) walks the
//   chunks in order (the loop takes the place of the Pallas grid's
//   sequential chunk axis); its (n, 16) slice of the state lives in shared
//   memory, so the Q x Q tile (C B^T) * L is recomputed by each of the p/16
//   blocks of a head — at p = 64 that gives 4 * b * h blocks (128 at b = 1)
//   for the card's 132 SMs, where one block per (b, h) would fill 32.  Per
//   chunk, with barriers between the phases:
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
//   x, B and C are read through their strides; p and n have unit stride;
//   y and the final state are written dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 16;          // columns of p per block
constexpr int kMaxQ = 128;       // chunk rows: a multiple of 8, at most 128
constexpr int kMaxYTiles = (kMaxQ / 4) * kPT / kThreads;
constexpr int kSmemLimit = 232448;
constexpr int kMaxDevices = 64;

// Raises a kernel's dynamic shared memory limit to a block's maximum, once
// per device (the attribute is per device; a launch uses only its own
// bytes), so that a launch sets no attribute and can be captured in a CUDA
// graph.  Concurrent first calls set the same value twice, harmlessly.
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
  static bool done[kMaxDevices];
  const cudaError_t err = allow_smem(ssd_kernel<T>, done);
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

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16, chunk 64 or 128, p and n multiples of 16 up
// to 256
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kMaxGroup = 4;         // heads per block of passes (a), (c)
constexpr int kStageRows = 128;      // rows of state_in pass (c) prefetches
constexpr int kStateThreads = 256;   // threads per block of pass (b)
constexpr int kAhead = 8;            // chunks pass (b) loads ahead

// Shared memory of pass (a), in bytes: the B tile (n/64 panels of Q rows of
// 128 bytes), two 64-column panels of x (the next head's loads while this
// one's are used), and dt, cum and dt * exp(cum[-1] - cum) of the group's
// heads.  Every panel starts on a 1024-byte boundary (the swizzle atom);
// the base is aligned at run time.
struct ChunkLayout {
  int B, X, dt, cum, f, bytes;
  __host__ __device__ ChunkLayout(int Q, int N) {
    B = 0;
    X = B + panels(N) * Q * kRow;
    dt = X + 2 * Q * kRow;
    cum = dt + 4 * kMaxGroup * Q;
    f = cum + 4 * kMaxGroup * Q;
    bytes = f + 4 * kMaxGroup * Q + 1024;
  }
};

// Shared memory of pass (c): the C tile; a region that holds the B tile
// until G is formed and then the three bf16 terms of one head's state_in
// (n rows, padded with zeros to whole panels, of one 64-column panel of p
// each); one panel of x; the fp32 rows of the next state_in panel,
// prefetched (at most kStageRows rows; the rest are read directly); dt and
// cum of the group's heads.
struct OutLayout {
  int C, R, X, SF, dt, cum, bytes;
  __host__ __device__ OutLayout(int Q, int N) {
    C = 0;
    const int tile = panels(N) * Q * kRow;
    const int terms = 3 * 64 * panels(N) * kRow;
    R = C + tile;
    X = R + (tile > terms ? tile : terms);
    SF = X + Q * kRow;
    dt = SF + (N < kStageRows ? N : kStageRows) * 256;
    cum = dt + 4 * kMaxGroup * Q;
    bytes = cum + 4 * kMaxGroup * Q + 1024;
  }
};

struct Args {
  const __nv_bfloat16 *x, *B, *C;
  const float *dt, *A, *D;
  __nv_bfloat16* y;
  float *states, *cum_last, *final_state;
  long long xb, xs, xh, db, ds, dh, Bb, Bs, Cb, Cs;   // elements
  int H, S, P, N, NC, group, groups;   // heads per block, blocks per chunk
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// dt of the block's heads (rows past s and heads past H as 0) into dts
// (group x Q), then their cumulative sums in index order, one thread per
// head, with no contraction into an FMA: the plain version's order and the
// same bits in passes (a) and (c).
__device__ void group_cumsum(const Args& a, int b, int s0, int h0, int Q,
                             float* dts, float* cum, int tid, int nthreads) {
  const int nv = min(Q, a.S - s0);
  for (int idx = tid; idx < a.group * Q; idx += nthreads) {
    const int i = idx / a.group, g = idx % a.group;
    const int h = h0 + g;
    dts[g * Q + i] = (i < nv && h < a.H)
                         ? a.dt[b * a.db + (s0 + i) * a.ds + h * a.dh]
                         : 0.0f;
  }
  __syncthreads();
  if (tid < a.group && h0 + tid < a.H) {
    const float A = a.A[h0 + tid];
    float run = 0.0f;
    for (int i = 0; i < Q; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[tid * Q + i], A));
      cum[tid * Q + i] = run;
    }
  }
  __syncthreads();
}

// (a) The chunk pass: per head of the block's group, local[n][p] =
// sum_j B[j][n] * dt_j * exp(cum[-1] - cum_j) * x[j][p] into the scratch,
// and the chunk's last cum.  Warpgroup wg takes the 64-row tiles of n
// numbered wg, wg + Q/64, ...; the decayed B is built in registers as the
// A operand (rows n, columns j) straight from the swizzled B tile.  The
// units (head, 64-column panel of p) run in order, each one's x panel
// copied in while the previous unit computes.
template <int Q>
__global__ void __launch_bounds__(128 * (Q / 64))
ssd_chunk_pass(const Args a) {
  constexpr int kWG = Q / 64, kT = 128 * kWG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sb = align1024(smem_raw);
  const uint32_t base = smem_u32(sb);
  const ChunkLayout L(Q, a.N);
  float* dts = reinterpret_cast<float*>(sb + L.dt);
  float* cum = reinterpret_cast<float*>(sb + L.cum);
  float* f = reinterpret_cast<float*>(sb + L.f);

  const int grp = blockIdx.x % a.groups, bc = blockIdx.x / a.groups;
  const int c = bc % a.NC, b = bc / a.NC;
  const int s0 = c * Q, nv = min(Q, a.S - s0), h0 = grp * a.group;
  const int hg = min(a.group, a.H - h0);
  const int tid = threadIdx.x, wg = warpgroup();
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int np = panels(a.N), pp = panels(a.P), units = hg * pp;
  const __nv_bfloat16* xc = a.x + b * a.xb + s0 * a.xs;

  load_tile(base + L.B, a.B + b * a.Bb + s0 * a.Bs, a.Bs, Q, np, nv, a.N,
            tid, kT);
  load_tile(base + L.X, xc + h0 * a.xh, a.xs, Q, 1, nv, a.P, tid, kT);
  group_cumsum(a, b, s0, h0, Q, dts, cum, tid, kT);
  for (int idx = tid; idx < hg * Q; idx += kT) {
    const int g = idx / Q;
    f[idx] = __fmul_rn(dts[idx], expf(cum[g * Q + Q - 1] - cum[idx]));
  }
  if (tid < hg)
    a.cum_last[(static_cast<long long>(b) * a.NC + c) * a.H + h0 + tid] =
        cum[tid * Q + Q - 1];

  for (int u = 0; u < units; ++u) {
    const int g = u / pp, pt = u % pp, h = h0 + g;
    const uint32_t xs = base + L.X + (u & 1) * Q * kRow;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // x of this unit, f (and, first, the B tile) ready
    if (u + 1 < units) {
      const int g1 = (u + 1) / pp, p1 = (u + 1) % pp;
      load_tile(base + L.X + ((u + 1) & 1) * Q * kRow,
                xc + (h0 + g1) * a.xh + 64 * p1, a.xs, Q, 1, nv,
                a.P - 64 * p1, tid, kT);
    }
    const float* fg = f + g * Q;
    float* out = a.states +
                 ((static_cast<long long>(b) * a.NC + c) * a.H + h) * a.N * a.P;
    for (int nt = wg; nt < np; nt += kWG) {
      const unsigned char* bpanel = sb + L.B + nt * Q * kRow;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int kb = 0; kb < Q / 64; ++kb) {
        uint32_t ah[4][4], am[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = 64 * kb + 16 * kk + 8 * (r / 2) + c0;
            const int n = r0 + 8 * (r % 2);     // within the n tile
            split3(__fmul_rn(bf_at(bpanel + swz(j, n)), fg[j]),
                   __fmul_rn(bf_at(bpanel + swz(j + 1, n)), fg[j + 1]),
                   ah[kk][r], am[kk][r], al[kk][r]);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc, al[kk], mnmajor(xs + (64 * kb + 16 * kk) * kRow));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc, am[kk], mnmajor(xs + (64 * kb + 16 * kk) * kRow));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc, ah[kk], mnmajor(xs + (64 * kb + 16 * kk) * kRow));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
#pragma unroll
      for (int x = 0; x < 32; x += 2) {
        const int n = 64 * nt + r0 + 8 * ((x / 2) % 2);
        const int p = 64 * pt + 8 * (x / 4) + c0;
        if (n < a.N && p < a.P)
          *reinterpret_cast<float2*>(out + n * a.P + p) =
              make_float2(acc[x], acc[x + 1]);
      }
    }
  }
}

// (b) The state pass: per (b*h, 4 consecutive elements of the (n, p)
// state), state_in[c] = state and state = state * exp(cum_last[c]) +
// local[c] over the chunks in order, in place; then the final state,
// written (p, n).
__global__ void __launch_bounds__(kStateThreads)
ssd_state_pass(float* states, const float* cum_last, float* final_state,
               int H, int NC, int P, int N) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int e = 4 * (blockIdx.y * kStateThreads + threadIdx.x);
  const int NP = N * P;
  if (e >= NP) return;
  const long long step = static_cast<long long>(H) * NP;
  float* ptr = states + (static_cast<long long>(b) * NC * H + h) * NP + e;
  const float* cl = cum_last + static_cast<long long>(b) * NC * H + h;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < NC; c0 += kAhead) {
    float4 loc[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < NC) {
        loc[k] = *reinterpret_cast<const float4*>(ptr + (c0 + k) * step);
        dec[k] = expf(cl[(c0 + k) * H]);
      }
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < NC) {
        *reinterpret_cast<float4*>(ptr + (c0 + k) * step) = s;
        s.x = __fadd_rn(__fmul_rn(s.x, dec[k]), loc[k].x);
        s.y = __fadd_rn(__fmul_rn(s.y, dec[k]), loc[k].y);
        s.z = __fadd_rn(__fmul_rn(s.z, dec[k]), loc[k].z);
        s.w = __fadd_rn(__fmul_rn(s.w, dec[k]), loc[k].w);
      }
  }
  const int n = e / P, p = e % P;   // P % 16 == 0: the 4 share n
  float* fb = final_state + (static_cast<long long>(b) * H + h) * P * N + n;
  fb[(p + 0) * N] = s.x;
  fb[(p + 1) * N] = s.y;
  fb[(p + 2) * N] = s.z;
  fb[(p + 3) * N] = s.w;
}

// (c) The output pass: G = C B^T for the block's rows (warpgroup wg owns
// rows 64 wg .. 64 wg + 63 and the key blocks at or left of the
// diagonal), then per unit (head, 64-column panel of p):
//   y = ((G * exp(cum_i - cum_j) [j <= i]) * dt_j) @ x
//       + exp(cum_i) * (C @ state_in^T) + D * x,
// summed in that order in fp32 and rounded once to bf16.  The fp32 rows of
// the next unit's state_in are copied in while this unit's products run.
// NP, the 64-row panels of n, is a template argument so that every wgmma
// loop has a fixed trip count: with a loop-carried accumulator in a
// run-time loop ptxas waits for each wgmma before the next; n is
// zero-padded to 64 NP.
template <int Q, int NP>
__global__ void __launch_bounds__(128 * (Q / 64))
ssd_output_pass(const Args a) {
  constexpr int kWG = Q / 64, kT = 128 * kWG, kSteps = 4 * NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sb = align1024(smem_raw);
  const uint32_t base = smem_u32(sb);
  const OutLayout L(Q, a.N);
  float* dts = reinterpret_cast<float*>(sb + L.dt);
  float* cum = reinterpret_cast<float*>(sb + L.cum);

  const int grp = blockIdx.x % a.groups, bc = blockIdx.x / a.groups;
  const int c = bc % a.NC, b = bc / a.NC;
  const int s0 = c * Q, nv = min(Q, a.S - s0), h0 = grp * a.group;
  const int hg = min(a.group, a.H - h0);
  const int tid = threadIdx.x, wg = warpgroup();
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int pp = panels(a.P);
  const int units = hg * pp, staged = min(a.N, kStageRows);
  const __nv_bfloat16* xc = a.x + b * a.xb + s0 * a.xs;
  const float* st0 = a.states +
      ((static_cast<long long>(b) * a.NC + c) * a.H + h0) * a.N * a.P;
  // the first `staged` rows of unit u's state_in panel into SF
  auto stage = [&](int u) {
    const float* src = st0 + static_cast<long long>(u / pp) * a.N * a.P +
                       64 * (u % pp);
    const int cols = a.P - 64 * (u % pp);
    for (int idx = tid; idx < staged * 16; idx += kT) {
      const int r = idx / 16, q = idx % 16;
      const bool ok = 4 * q < cols;
      cp_async16(base + L.SF + r * 256 + q * 16,
                 ok ? src + r * a.P + 4 * q : src, ok ? 16 : 0);
    }
  };

  load_tile(base + L.C, a.C + b * a.Cb + s0 * a.Cs, a.Cs, Q, NP, nv, a.N,
            tid, kT);
  load_tile(base + L.R, a.B + b * a.Bb + s0 * a.Bs, a.Bs, Q, NP, nv, a.N,
            tid, kT);
  stage(0);
  group_cumsum(a, b, s0, h0, Q, dts, cum, tid, kT);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  // G, once for the group: both operands K-major (rows i of C, rows j of B)
  float g[kWG][32];
#pragma unroll
  for (int jt = 0; jt < kWG; ++jt)
#pragma unroll
    for (int i = 0; i < 32; ++i) g[jt][i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int jt = 0; jt < kWG; ++jt) {
    if (jt > wg) continue;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * Q * kRow + 32 * (kk % 4);
      wgmma_ss<0>(g[jt], kmajor(base + L.C + off + 64 * wg * kRow),
                  kmajor(base + L.R + off + 64 * jt * kRow));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int jt = 0; jt < kWG; ++jt) fence_regs(g[jt]);
  __syncthreads();   // the B tile is consumed: R takes the state terms

  const int ia = 64 * wg + r0;         // this thread's rows: ia, ia + 8
  for (int u = 0; u < units; ++u) {
    const int gh = u / pp, pt = u % pp, h = h0 + gh;
    const float* cg = cum + gh * Q;
    const float* dg = dts + gh * Q;
    load_tile(base + L.X, xc + h * a.xh + 64 * pt, a.xs, Q, 1, nv,
              a.P - 64 * pt, tid, kT);
    cp_async_wait_all();
    __syncthreads();   // this unit's staged rows are visible to all
    // state_in (rows n, 64 columns of p) as three MN-major bf16 terms;
    // rows n .. 64 NP are zeros
    const float* st = st0 + static_cast<long long>(gh) * a.N * a.P;
#pragma unroll 4
    for (int idx = tid; idx < 64 * NP * 16; idx += kT) {
      const int r = idx / 16, q4 = idx % 16, p = 64 * pt + 4 * q4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < staged)
        v = *reinterpret_cast<const float4*>(sb + L.SF + r * 256 + q4 * 16);
      else if (r < a.N && p < a.P)
        v = *reinterpret_cast<const float4*>(st + r * a.P + p);
      uint32_t hi0, mid0, lo0, hi1, mid1, lo1;
      split3(v.x, v.y, hi0, mid0, lo0);
      split3(v.z, v.w, hi1, mid1, lo1);
      const int off = r * kRow + (((q4 / 2) ^ (r & 7)) << 4) + 8 * (q4 % 2);
      *reinterpret_cast<uint2*>(sb + L.R + off) = make_uint2(hi0, hi1);
      *reinterpret_cast<uint2*>(sb + L.R + 64 * NP * kRow + off) =
          make_uint2(mid0, mid1);
      *reinterpret_cast<uint2*>(sb + L.R + 128 * NP * kRow + off) =
          make_uint2(lo0, lo1);
    }
    fence_proxy_async();
    __syncthreads();   // x and the terms ready for the tensor cores; SF free
    if (u + 1 < units) stage(u + 1);

    const float ecum[2] = {expf(cg[ia]), expf(cg[ia + 8])};
    float cacc[32], yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      cacc[i] = 0.0f;
      yacc[i] = 0.0f;
    }
    // One pipeline stage per 64-column key block: its masked scores are
    // built in registers first, then the carry-in C @ state_in^T (with the
    // first block) and the intra-chunk product go to the tensor cores
    // together, terms lo, mid, hi, and are waited for before any other
    // instruction touches their accumulators (an instruction in between
    // makes ptxas serialize every wgmma of the kernel, C7514).
#pragma unroll
    for (int jt = 0; jt < kWG; ++jt) {
      if (jt > wg) continue;
      uint32_t ah[4][4], am[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ia + 8 * (r % 2);
          const int j = 64 * jt + 16 * kk + 8 * (r / 2) + c0;
          const int xi = 8 * kk + 2 * r;
          // branch-free: the exponent of a masked pair is 0, its score 0
          const bool in0 = j <= i, in1 = j + 1 <= i;
          const float e0 = expf(in0 ? cg[i] - cg[j] : 0.0f);
          const float e1 = expf(in1 ? cg[i] - cg[j + 1] : 0.0f);
          const float v0 = __fmul_rn(__fmul_rn(g[jt][xi], e0), dg[j]);
          const float v1 = __fmul_rn(__fmul_rn(g[jt][xi + 1], e1), dg[j + 1]);
          split3(in0 ? v0 : 0.0f, in1 ? v1 : 0.0f, ah[kk][r], am[kk][r],
                 al[kk][r]);
        }
      wgmma_fence();
      if (jt == 0) {
#pragma unroll
        for (int t = 2; t >= 0; --t)
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            wgmma_ss<1>(cacc,
                        kmajor(base + L.C + (kk / 4) * Q * kRow +
                               64 * wg * kRow + 32 * (kk % 4)),
                        mnmajor(base + L.R + t * 64 * NP * kRow +
                                16 * kk * kRow));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(yacc, al[kk], mnmajor(base + L.X + (64 * jt + 16 * kk) * kRow));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(yacc, am[kk], mnmajor(base + L.X + (64 * jt + 16 * kk) * kRow));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(yacc, ah[kk], mnmajor(base + L.X + (64 * jt + 16 * kk) * kRow));
      wgmma_commit();
      wgmma_wait_all();   // the A registers are rebuilt for the next block
    }
    fence_regs(cacc);
    fence_regs(yacc);

    // y = intra + exp(cum) * carry + D * x, rounded once; rows past s and
    // columns past p are not stored
    const float dskip = a.D[h];
    __nv_bfloat16* yb = a.y + (static_cast<long long>(b) * a.S + s0) * a.H * a.P +
                        static_cast<long long>(h) * a.P;
#pragma unroll
    for (int x = 0; x < 32; x += 2) {
      const int half = (x / 2) % 2;
      const int i = ia + 8 * half;
      const int p = 64 * pt + 8 * (x / 4) + c0;
      if (i < nv && p < a.P) {
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(sb + L.X + swz(i, p));
        const float v0 = __fadd_rn(
            __fadd_rn(yacc[x], __fmul_rn(cacc[x], ecum[half])),
            __fmul_rn(dskip, __low2float(xv)));
        const float v1 = __fadd_rn(
            __fadd_rn(yacc[x + 1], __fmul_rn(cacc[x + 1], ecum[half])),
            __fmul_rn(dskip, __high2float(xv)));
        *reinterpret_cast<__nv_bfloat162*>(
            yb + static_cast<long long>(i) * a.H * a.P + p) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();   // x and the state terms are consumed
  }
}

template <int Q, int NP>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const ChunkLayout lc(Q, a.N);
  const OutLayout lo(Q, a.N);
  static bool chunk_done[kMaxDevices], out_done[kMaxDevices];
  cudaError_t err = allow_smem(ssd_chunk_pass<Q>, chunk_done);
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_output_pass<Q, NP>, out_done);
  if (err != cudaSuccess) return err;
  const int blocks = batch * a.NC * a.groups;
  ssd_chunk_pass<Q><<<blocks, 128 * (Q / 64), lc.bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 sgrid(batch * a.H,
                   (a.N * a.P / 4 + kStateThreads - 1) / kStateThreads);
  ssd_state_pass<<<sgrid, kStateThreads, 0, stream>>>(
      a.states, a.cum_last, a.final_state, a.H, a.NC, a.P, a.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_output_pass<Q, NP><<<blocks, 128 * (Q / 64), lo.bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  switch (panels(a.N)) {
    case 1: return launch<Q, 1>(a, batch, stream);
    case 2: return launch<Q, 2>(a, batch, stream);
    case 3: return launch<Q, 3>(a, batch, stream);
    default: return launch<Q, 4>(a, batch, stream);
  }
}

}  // namespace tc

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

// The tensor-core instance: x, B, C bf16 and y bf16, dt, A, D and
// final_state fp32, as ssd_scan, with chunk Q 64 or 128, P and N multiples
// of 16 in [16, 256], `group` heads (1 to 4) per block of passes (a) and
// (c), 16-byte-aligned x, B and C and element strides that are multiples
// of 8 (16 bytes) over every axis of size above 1.  states
// (batch, ceil(S/Q), H, N, P) and cum_last (batch, ceil(S/Q), H) are fp32
// scratch the caller allocates.  Same return convention as ssd_scan; the
// three passes are launched in order on `stream`.
int ssd_scan_tc(const void* x, const void* dt, const void* A, const void* B,
                const void* C, const void* D, void* y, void* final_state,
                void* states, void* cum_last, int batch, int S, int H, int P,
                int N, int Q, int group, long long x_sb, long long x_ss,
                long long x_sh,
                long long dt_sb, long long dt_ss, long long dt_sh,
                long long B_sb, long long B_ss, long long C_sb,
                long long C_ss, void* stream) {
  bool ok = batch >= 1 && S >= 1 && H >= 1 && (Q == 64 || Q == 128) &&
            P >= 16 && P <= 256 && P % 16 == 0 && N >= 16 && N <= 256 &&
            N % 16 == 0;
  const long long nc = (static_cast<long long>(S) + Q - 1) / Q;
  ok = ok && group >= 1 && group <= tc::kMaxGroup &&
       batch * nc * ((H + group - 1) / group) <= 2147483647LL &&
       static_cast<long long>(batch) * H <= 2147483647LL;
  const long long strides[7][2] = {{x_sb, batch}, {x_ss, S}, {x_sh, H},
                                   {B_sb, batch}, {B_ss, S}, {C_sb, batch},
                                   {C_ss, S}};
  for (const auto& st : strides) ok = ok && (st[1] == 1 || st[0] % 8 == 0);
  const void* const bases[3] = {x, B, C};
  for (const void* p : bases)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  tc::Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.B = static_cast<const __nv_bfloat16*>(B);
  a.C = static_cast<const __nv_bfloat16*>(C);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.states = static_cast<float*>(states);
  a.cum_last = static_cast<float*>(cum_last);
  a.final_state = static_cast<float*>(final_state);
  a.xb = x_sb; a.xs = x_ss; a.xh = x_sh;
  a.db = dt_sb; a.ds = dt_ss; a.dh = dt_sh;
  a.Bb = B_sb; a.Bs = B_ss; a.Cb = C_sb; a.Cs = C_ss;
  a.H = H; a.S = S; a.P = P; a.N = N;
  a.NC = static_cast<int>(nc);
  a.group = group;
  a.groups = (H + group - 1) / group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = Q == 64 ? tc::launch<64>(a, batch, s)
                                  : tc::launch<128>(a, batch, s);
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
