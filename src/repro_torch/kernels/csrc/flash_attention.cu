// Flash attention for Hopper (sm_90a): grouped-query attention with an
// online softmax, causal and sliding-window masks.  Plain C interface,
// bound with ctypes by src/repro_torch/kernels/ops.py; built by
// src/repro_torch/kernels/build.py.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   flash_attention  <- repro/kernels/flash_attention.py:flash_attention
//                       (_flash_kernel)
// and computes what it computes: for q (B, H, S, D) and k, v (B, KV, S, D)
// in fp32 or bf16, with query head h reading kv head h / (H / KV),
//   s = (q . k^T) * sm_scale                      (fp32)
//   s = -1e30 where k_pos >= S, or (causal) k_pos > q_pos, or
//       (window) k_pos <= q_pos - window
//   online softmax over the key tiles: m, l, acc in fp32
//   o = acc / l, with l == 0 giving zeros, cast once to q's dtype.
//
// What bounds it on an H100: causal attention does 4*D flops per (query,
// visible key) pair, 4*B*H*D*S(S+1)/2 in all, against reading q, k, v and
// writing o once; at S = 2048 and D = 128 that is ~500 flops per byte,
// above the card's ridge, so the bound is the operations.  This first
// kernel does them as fp32 FMAs on the CUDA cores (67 TFLOP/s peak), not
// on the tensor cores the bound assumes (989 TFLOP/s bf16): it is right and
// simple first; wgmma, TMA and warp specialization are a later kernel PR.
//
// Design: one thread block (128 threads, 16 x 8) per (b*h, 64-query tile).
// The q tile is staged once in shared memory as fp32; the key tiles (64
// keys) stream through shared memory in the input dtype (bf16 is widened
// exactly at use, so the bf16 tiles take half the space and two blocks fit
// an SM at D = 128), read through the GQA map h / g from the shared kv head
// (K/V are never copied per query head).  Thread (ty, tx) owns query rows
// 4*ty .. 4*ty+3: it computes their scores against keys tx + 8*j, keeps
// their m and l (the 8 threads of a row group agree through shuffles), and
// accumulates their output columns tx + 8*j of D.  The probabilities go
// through shared memory between the two products.  Under `causal` the key
// tiles wholly above the diagonal are never visited, under `window` those
// wholly left of it; the ragged end of S is masked inside the kernel (rows
// past S are computed on zeros and not stored), so nothing is padded or
// copied.  Query tiles are issued heaviest first (the last tile sees the
// most keys under `causal`).  Arbitrary strides on B, H and S; D has unit
// stride.  Shared memory exceeds the 48 KB default for every D above 32,
// so each instance opts in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kTY = 16;        // thread rows: each owns kRows query rows
constexpr int kTX = 8;         // thread columns: each owns kBK / kTX keys
constexpr int kThreads = kTY * kTX;
constexpr int kRows = kBQ / kTY;
constexpr int kCols = kBK / kTX;
constexpr float kNegInf = -1e30f;  // as the JAX kernel: never -inf

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
  return __float2bfloat16_rn(x);   // the one rounding of the output
}

struct Strides {
  long long b, h, s;   // elements; D has unit stride
};

// Shared memory of one block, in bytes: the fp32 q tile (row stride DP+1),
// the key tile transposed (DP x (kBK+1)) and the value tile (kBK x DP), both
// in T, and the fp32 probabilities (kBQ x (kBK+1)).
template <typename T, int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (DP + 1) + kBQ * (kBK + 1)) +
         sizeof(T) * (DP * (kBK + 1) + kBK * DP);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int group,
             int S, int D, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);         // kBQ x (DP+1)
  float* Ps = Qs + kBQ * (DP + 1);                        // kBQ x (kBK+1)
  T* Kt = reinterpret_cast<T*>(Ps + kBQ * (kBK + 1));     // DP x (kBK+1)
  T* Vs = Kt + DP * (kBK + 1);                            // kBK x DP

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;      // heaviest first
  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int qp = q0 + r;
    Qs[r * (DP + 1) + d] =
        (qp < S && d < D) ? widen(qb[qp * qs.s + d]) : 0.0f;
  }

  // The key tiles this query tile can see.
  const int q_last = min(q0 + kBQ, S) - 1;
  int kt_end = (S + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;    // the first key row q0 may see
    if (lo > 0) kt_begin = lo / kBK;
  }

  float m[kRows], l[kRows], acc[kRows][DP / kTX];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DP / kTX; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int c = idx / DP, d = idx % DP;
      const int kp = k0 + c;
      const bool ok = kp < S && d < D;
      Kt[d * (kBK + 1) + c] = ok ? kb[kp * ks.s + d] : narrow<T>(0.0f);
      Vs[c * DP + d] = ok ? vb[kp * vs.s + d] : narrow<T>(0.0f);
    }
    __syncthreads();

    // s = q . k^T for rows 4*ty + i and keys tx + 8*j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qs[(ty * kRows + i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = widen(Kt[d * (kBK + 1) + tx + kTX * j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + kTX * j;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * kRows + i) * (kBK + 1) + tx + kTX * j] = p;
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DP / kTX; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P . V for rows 4*ty + i and columns tx + 8*j
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty * kRows + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DP / kTX; ++j) {
        const float vv = widen(Vs[c * DP + tx + kTX * j]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= S) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < DP / kTX; ++j) {
      const int d = tx + kTX * j;
      if (d < D) ob[qp * os.s + d] = narrow<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int D, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP>();
  // on every launch: the attribute is per device, and the call is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KV, S, D, qs, ks,
      vs, os, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int S, int D, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale,
                     int causal, int window, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, H, KV, S, D, qs, ks, vs, os, scale,
                         causal, window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KV, S, D, qs, ks, vs, os, scale,
                         causal, window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, H, KV, S, D, qs, ks, vs, os, scale,
                          causal, window, stream);
  return launch<T, 256>(q, k, v, o, B, H, KV, S, D, qs, ks, vs, os, scale,
                        causal, window, stream);
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream`; q, o are (B, H, S, D) and k, v
// (B, KV, S, D), all fp32 (bf16 = 0) or all bf16, each with its own
// element strides over (B, H, S) and a unit stride over D.  window <= 0
// means no window.  Returns the cudaError_t of the launch (0 on success);
// does not synchronize or allocate.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int bf16, int B, int H, int KV, int S, int D,
                    long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long o_sb, long long o_sh, long long o_ss,
                    float scale, int causal, int window, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || D < 1 ||
      D > 256 || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, D, qs, ks, vs,
                                     os, scale, causal, window, st)
           : dispatch<float>(q, k, v, o, B, H, KV, S, D, qs, ks, vs, os,
                             scale, causal, window, st);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
