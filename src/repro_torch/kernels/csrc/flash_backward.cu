// The backward of flash attention for Hopper (sm_90a): dq, dk and dv of
// grouped-query attention with causal and sliding-window masks.  Plain C
// interface, bound with ctypes by src/repro_torch/kernels/ops.py
// (ops.flash_attention_backward); built by src/repro_torch/kernels/build.py.
//
// Replaces no Pallas kernel: the JAX package never runs its Pallas
// flash_attention when it trains.  Its gradient is XLA's autodiff of the
// q-chunked attention repro/models/attention.py:_attend under
// jax.checkpoint.  The port runs its flash kernel inside the forward pass
// (csrc/flash_attention.cu), whose output carries no autograd graph, so the
// port needs this kernel to train through attention on the card.
//
// What it computes, for q, o, do (B, H, S, D) and k, v (B, KV, Sk, D) in
// fp32 or bf16, query head h reading kv head h / (H / KV):
//   s     = (q . k^T) * scale, masked as the forward masks (-1e30)
//   P     = exp(s - m) / l          m, l: the row max and sum of exp(s - m)
//   delta = rowsum(do * o)
//   dv    = P^T do                  summed over the g query heads of a kv head
//   dS    = P * (do . v^T - delta)
//   dq    = scale * dS k
//   dk    = scale * dS^T q          summed over the g query heads
// all in fp32, each result rounded once to the inputs' dtype.  A row that
// sees no key (l == 0, where the forward writes zeros) gets P = 0, so its
// gradients are zero.
//
// Three passes, one launch each, no atomics: every output element is summed
// by one thread in a fixed order, so the results repeat bit for bit.
//   1. stats_kernel, per (b*h, query tile): m and l recomputed from q and k
//      over the key tiles the tile sees (the forward's online max and sum,
//      without P.V), and delta from do and o; written to an fp32 scratch of
//      3 * B * H * S floats.  The forward stays as it is and writes no
//      logsumexp, so its instances keep their measured times and bits.
//   2. dkdv_kernel, per (b*kv head, key tile): K and V stay in shared
//      memory while the g query heads of the group, and for each head the
//      query tiles that see the key tile, stream through in a fixed order;
//      dk and dv accumulate in registers.
//   3. dq_kernel, per (b*h, query tile): the key tiles stream through; dq
//      accumulates in registers.
//
// What bounds it on an H100: 16*D flops per visible (query, key) pair over
// the three passes (2D, 8D, 6D), against reading q, k, v, o, do and writing
// dq, dk, dv once; at qwen3-14b's (2, 40/8, 4096, 128) causal that is 1.37
// TFLOP, operations-bound.  This first design runs them as fp32 FMAs on the
// CUDA cores (67 TFLOP/s peak) with every tile widened to fp32 in shared
// memory: 128 threads (16 x 8) a block; thread (ty, tx) owns query rows
// ty*kR .. ty*kR+kR-1 of a score tile and keys tx + 8*j, and (in pass 2) key
// rows ty*kKR .. and columns tx + 8*j of D.  Tiles shrink with D so that a
// block fits in shared memory: 64 x 64 up to D = 64, 64 queries x 32 keys
// at D = 128, 32 x 16 at D = 256.  The tensor cores (wgmma), TMA and a
// logsumexp written by the forward are later work (ROADMAP Queue 2).
//
// Arbitrary element strides over (B, heads, rows) for every operand and
// result; D has unit stride.  Under `causal` or `window` only the tiles that
// see each other are visited; the ragged ends of S and Sk are masked inside
// the kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTY = 16;        // thread rows
constexpr int kTX = 8;         // thread columns
constexpr int kThreads = kTY * kTX;
constexpr float kNegInf = -1e30f;  // as the forward: never -inf

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
  return __float2bfloat16_rn(x);   // the one rounding of each gradient
}

struct Strides {
  long long b, h, s;   // elements; D has unit stride
};

struct Mask {
  int S, Sk, causal, window;
  __device__ __forceinline__ bool visible(int qp, int kp) const {
    bool ok = qp < S && kp < Sk;
    if (causal) ok = ok && kp <= qp;
    if (window > 0) ok = ok && kp > qp - window;
    return ok;
  }
  // The key tiles of width BK that query rows [q0, q0 + BQ) see.
  __device__ __forceinline__ void key_tiles(int q0, int BQ, int BK,
                                            int& begin, int& end) const {
    const int q_last = min(q0 + BQ, S) - 1;
    end = (Sk + BK - 1) / BK;
    if (causal) end = min(end, q_last / BK + 1);
    begin = 0;
    if (window > 0) {
      const int lo = q0 - window + 1;   // the first key row q0 may see
      if (lo > 0) begin = lo / BK;
    }
  }
  // The query tiles of height BQ that see key rows [k0, k0 + BK).
  __device__ __forceinline__ void query_tiles(int k0, int BQ, int BK,
                                              int& begin, int& end) const {
    const int k_last = min(k0 + BK, Sk) - 1;
    begin = causal ? k0 / BQ : 0;
    end = (S + BQ - 1) / BQ;
    if (window > 0) end = min(end, (k_last + window - 1) / BQ + 1);
  }
};

// Tile sizes by the padded head dim DP: a block's tiles fit in shared memory
// and its accumulators in registers.
template <int DP>
struct Tiles {
  static constexpr int BQ = DP <= 64 ? 64 : (DP <= 128 ? 64 : 32);
  static constexpr int BK = DP <= 64 ? 64 : (DP <= 128 ? 32 : 16);
  static constexpr int kR = BQ / kTY;    // query rows a thread owns
  static constexpr int kC = BK / kTX;    // keys a thread owns
  static constexpr int kKR = BK / kTY;   // key rows a thread owns (pass 2)
  static constexpr int kDC = DP / kTX;   // columns of D a thread owns
  static_assert(BQ % kTY == 0 && BK % kTY == 0 && DP % kTX == 0, "tiles");
};

// rows [row0, row0 + R) of a (rows, D) operand into dst[r * (DP + 1) + d] as
// fp32, zeros past `rows` and past D.
template <typename T, int DP, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int row0,
                                          int rows, int D) {
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int row = row0 + r;
    dst[r * (DP + 1) + d] =
        (row < rows && d < D) ? widen(src[row * stride + d]) : 0.0f;
  }
}

// rows [row0, row0 + R) of a (rows, D) operand transposed into
// dst[d * (R + 1) + r] as fp32, zeros past `rows` and past D.
template <typename T, int DP, int R>
__device__ __forceinline__ void load_cols(float* dst, const T* src,
                                          long long stride, int row0,
                                          int rows, int D) {
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int row = row0 + r;
    dst[d * (R + 1) + r] =
        (row < rows && d < D) ? widen(src[row * stride + d]) : 0.0f;
  }
}

// out[i][j] = sum_d A[(ty*kR + i)][d] * Bt[d][tx + 8*j]: A row-major
// (BQ x (DP+1)), Bt transposed (DP x (BK+1)).
template <int DP, int BQ, int BK>
__device__ __forceinline__ void tile_product(
    const float* A, const float* Bt, float (&out)[BQ / kTY][BK / kTX],
    int ty, int tx) {
  constexpr int kR = BQ / kTY, kC = BK / kTX;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) out[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float a[kR], b[kC];
#pragma unroll
    for (int i = 0; i < kR; ++i) a[i] = A[(ty * kR + i) * (DP + 1) + d];
#pragma unroll
    for (int j = 0; j < kC; ++j) b[j] = Bt[d * (BK + 1) + tx + kTX * j];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// ---------------------------------------------------------------------------
// Pass 1: m, l and delta per query row
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ stats, int H, int group, int D, Mask mk,
             Strides qs, Strides ks, Strides os, Strides dos, float scale) {
  using TL = Tiles<DP>;
  constexpr int BQ = TL::BQ, BK = TL::BK, kR = TL::kR, kC = TL::kC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // BQ x (DP+1)
  float* Kt = Qs + BQ * (DP + 1);                    // DP x (BK+1)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* ob = o + b * os.b + h * os.h;
  const T* dob = dout + b * dos.b + h * dos.h;

  load_rows<T, DP, BQ>(Qs, qb, qs.s, q0, mk.S, D);
  int kt_begin, kt_end;
  mk.key_tiles(q0, BQ, BK, kt_begin, kt_end);

  float m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous key tile is consumed
    load_cols<T, DP, BK>(Kt, kb, ks.s, k0, mk.Sk, D);
    __syncthreads();
    float s[kR][kC];
    tile_product<DP, BQ, BK>(Qs, Kt, s, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qp = q0 + ty * kR + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        s[i][j] = mk.visible(qp, k0 + tx + kTX * j) ? s[i][j] * scale
                                                     : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kC; ++j) rs += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = expf(m[i] - m_new) * l[i] + rs;
      m[i] = m_new;
    }
  }

  // delta = rowsum(do * o), the 8 threads of a row over its D columns
  const long long BHS = static_cast<long long>(gridDim.x) * mk.S;
  const long long base = static_cast<long long>(bh) * mk.S;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qp = q0 + ty * kR + i;
    float dl = 0.0f;
    if (qp < mk.S)
      for (int d = tx; d < D; d += kTX)
        dl = fmaf(widen(dob[qp * dos.s + d]), widen(ob[qp * os.s + d]), dl);
#pragma unroll
    for (int off = 1; off < kTX; off <<= 1)
      dl += __shfl_xor_sync(0xffffffffu, dl, off);
    if (tx == 0 && qp < mk.S) {
      stats[base + qp] = m[i];
      stats[BHS + base + qp] = l[i];
      stats[2 * BHS + base + qp] = dl;
    }
  }
}

// The probabilities and dS of one (query tile, key tile): s and dp are the
// thread's q.k^T and do.v^T entries; rows past S and keys outside the mask
// get P = 0, as do rows with l == 0.
template <int BQ, int BK>
__device__ __forceinline__ void probs_and_ds(
    float (&s)[BQ / kTY][BK / kTX], float (&dp)[BQ / kTY][BK / kTX],
    const float* m, const float* l, const float* delta, const Mask& mk,
    int q0, int k0, int ty, int tx, float scale) {
  constexpr int kR = BQ / kTY, kC = BK / kTX;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
    const int qp = q0 + r;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int kp = k0 + tx + kTX * j;
      const float p = (mk.visible(qp, kp) && l[r] > 0.0f)
                          ? expf(s[i][j] * scale - m[r]) / l[r]
                          : 0.0f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: dk and dv per (b*kv head, key tile)
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ stats, T* __restrict__ dk,
            T* __restrict__ dv, int H, int KV, int group, int D, Mask mk,
            Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
            Strides dvs, float scale) {
  using TL = Tiles<DP>;
  constexpr int BQ = TL::BQ, BK = TL::BK, kR = TL::kR, kC = TL::kC,
                kKR = TL::kKR, kDC = TL::kDC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Kt = reinterpret_cast<float*>(smem_raw);   // DP x (BK+1)
  float* Vt = Kt + DP * (BK + 1);                    // DP x (BK+1)
  float* Qs = Vt + DP * (BK + 1);                    // BQ x (DP+1)
  float* dOs = Qs + BQ * (DP + 1);                   // BQ x (DP+1)
  float* Ps = dOs + BQ * (DP + 1);                   // BQ x (BK+1)
  float* dSs = Ps + BQ * (BK + 1);                   // BQ x (BK+1)
  float* Ms = dSs + BQ * (BK + 1);                   // BQ
  float* Ls = Ms + BQ;                               // BQ
  float* Ds = Ls + BQ;                               // BQ

  const int bkv = blockIdx.x;
  const int b = bkv / KV, kvh = bkv % KV;
  const int k0 = blockIdx.y * BK;   // under `causal` the first tiles see most
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  load_cols<T, DP, BK>(Kt, kb, ks.s, k0, mk.Sk, D);
  load_cols<T, DP, BK>(Vt, vb, vs.s, k0, mk.Sk, D);

  float acc_k[kKR][kDC], acc_v[kKR][kDC];
#pragma unroll
  for (int i = 0; i < kKR; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) {
      acc_k[i][j] = 0.0f;
      acc_v[i][j] = 0.0f;
    }

  int qt_begin, qt_end;
  mk.query_tiles(k0, BQ, BK, qt_begin, qt_end);
  const long long BHS = static_cast<long long>(gridDim.x / KV) * H * mk.S;
  for (int hg = 0; hg < group; ++hg) {   // the group's heads, in order
    const int h = kvh * group + hg;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const long long base = (static_cast<long long>(b) * H + h) * mk.S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's Q, dO, P and dS are consumed
      load_rows<T, DP, BQ>(Qs, qb, qs.s, q0, mk.S, D);
      load_rows<T, DP, BQ>(dOs, dob, dos.s, q0, mk.S, D);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int qp = q0 + r;
        const bool ok = qp < mk.S;
        Ms[r] = ok ? stats[base + qp] : 0.0f;
        Ls[r] = ok ? stats[BHS + base + qp] : 0.0f;
        Ds[r] = ok ? stats[2 * BHS + base + qp] : 0.0f;
      }
      __syncthreads();
      float s[kR][kC], dp[kR][kC];
      tile_product<DP, BQ, BK>(Qs, Kt, s, ty, tx);
      tile_product<DP, BQ, BK>(dOs, Vt, dp, ty, tx);
      probs_and_ds<BQ, BK>(s, dp, Ms, Ls, Ds, mk, q0, k0, ty, tx, scale);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          Ps[(ty * kR + i) * (BK + 1) + tx + kTX * j] = s[i][j];
          dSs[(ty * kR + i) * (BK + 1) + tx + kTX * j] = dp[i][j];
        }
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q for key rows ty*kKR + i, columns tx + 8j
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[kKR], dsv[kKR];
#pragma unroll
        for (int i = 0; i < kKR; ++i) {
          pv[i] = Ps[r * (BK + 1) + ty * kKR + i];
          dsv[i] = dSs[r * (BK + 1) + ty * kKR + i];
        }
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          const float dov = dOs[r * (DP + 1) + tx + kTX * j];
          const float qv = Qs[r * (DP + 1) + tx + kTX * j];
#pragma unroll
          for (int i = 0; i < kKR; ++i) {
            acc_v[i][j] = fmaf(pv[i], dov, acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * dks.b + kvh * dks.h;
  T* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int i = 0; i < kKR; ++i) {
    const int kp = k0 + ty * kKR + i;
    if (kp >= mk.Sk) continue;
#pragma unroll
    for (int j = 0; j < kDC; ++j) {
      const int d = tx + kTX * j;
      if (d < D) {
        dkb[kp * dks.s + d] = narrow<T>(acc_k[i][j] * scale);
        dvb[kp * dvs.s + d] = narrow<T>(acc_v[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3: dq per (b*h, query tile)
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ stats, T* __restrict__ dq, int H,
          int group, int D, Mask mk, Strides qs, Strides ks, Strides vs,
          Strides dos, Strides dqs, float scale) {
  using TL = Tiles<DP>;
  constexpr int BQ = TL::BQ, BK = TL::BK, kR = TL::kR, kC = TL::kC,
                kDC = TL::kDC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // BQ x (DP+1)
  float* dOs = Qs + BQ * (DP + 1);                   // BQ x (DP+1)
  float* Kt = dOs + BQ * (DP + 1);                   // DP x (BK+1)
  float* Vt = Kt + DP * (BK + 1);                    // DP x (BK+1)
  float* dSs = Vt + DP * (BK + 1);                   // BQ x (BK+1)
  float* Ms = dSs + BQ * (BK + 1);                   // BQ
  float* Ls = Ms + BQ;                               // BQ
  float* Ds = Ls + BQ;                               // BQ

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const long long BHS = static_cast<long long>(gridDim.x) * mk.S;
  const long long base = static_cast<long long>(bh) * mk.S;

  load_rows<T, DP, BQ>(Qs, qb, qs.s, q0, mk.S, D);
  load_rows<T, DP, BQ>(dOs, dob, dos.s, q0, mk.S, D);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int qp = q0 + r;
    const bool ok = qp < mk.S;
    Ms[r] = ok ? stats[base + qp] : 0.0f;
    Ls[r] = ok ? stats[BHS + base + qp] : 0.0f;
    Ds[r] = ok ? stats[2 * BHS + base + qp] : 0.0f;
  }
  int kt_begin, kt_end;
  mk.key_tiles(q0, BQ, BK, kt_begin, kt_end);

  float acc[kR][kDC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's K, V and dS are consumed
    load_cols<T, DP, BK>(Kt, kb, ks.s, k0, mk.Sk, D);
    load_cols<T, DP, BK>(Vt, vb, vs.s, k0, mk.Sk, D);
    __syncthreads();
    float s[kR][kC], dp[kR][kC];
    tile_product<DP, BQ, BK>(Qs, Kt, s, ty, tx);
    tile_product<DP, BQ, BK>(dOs, Vt, dp, ty, tx);
    probs_and_ds<BQ, BK>(s, dp, Ms, Ls, Ds, mk, q0, k0, ty, tx, scale);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j)
        dSs[(ty * kR + i) * (BK + 1) + tx + kTX * j] = dp[i][j];
    __syncthreads();
    // dq += dS K for rows ty*kR + i, columns tx + 8j (K read through Kt)
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float dsv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) dsv[i] = dSs[(ty * kR + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const float kv = Kt[(tx + kTX * j) * (BK + 1) + c];
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qp = q0 + ty * kR + i;
    if (qp >= mk.S) continue;
#pragma unroll
    for (int j = 0; j < kDC; ++j) {
      const int d = tx + kTX * j;
      if (d < D) dqb[qp * dqs.s + d] = narrow<T>(acc[i][j] * scale);
    }
  }
}

template <int DP>
constexpr size_t stats_smem() {
  return sizeof(float) * (Tiles<DP>::BQ * (DP + 1) + DP * (Tiles<DP>::BK + 1));
}
template <int DP>
constexpr size_t dkdv_smem() {
  using TL = Tiles<DP>;
  return sizeof(float) * (2 * DP * (TL::BK + 1) + 2 * TL::BQ * (DP + 1) +
                          2 * TL::BQ * (TL::BK + 1) + 3 * TL::BQ);
}
template <int DP>
constexpr size_t dq_smem() {
  using TL = Tiles<DP>;
  return sizeof(float) * (2 * TL::BQ * (DP + 1) + 2 * DP * (TL::BK + 1) +
                          TL::BQ * (TL::BK + 1) + 3 * TL::BQ);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float* stats;
  int B, H, KV, D;
  Mask mk;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DP>
cudaError_t launch(const Args& a) {
  using TL = Tiles<DP>;
  const int group = a.H / a.KV;
  cudaError_t err;
  // on every launch: the attributes are per device, and the calls are cheap
  err = cudaFuncSetAttribute(stats_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(stats_smem<DP>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_smem<DP>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem<DP>()));
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 qgrid(a.B * a.H, (a.mk.S + TL::BQ - 1) / TL::BQ);
  stats_kernel<T, DP><<<qgrid, kThreads, stats_smem<DP>(), a.stream>>>(
      q, k, o, dout, a.stats, a.H, group, a.D, a.mk, a.qs, a.ks, a.os,
      a.dos, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kgrid(a.B * a.KV, (a.mk.Sk + TL::BK - 1) / TL::BK);
  dkdv_kernel<T, DP><<<kgrid, kThreads, dkdv_smem<DP>(), a.stream>>>(
      q, k, v, dout, a.stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.H, a.KV, group, a.D, a.mk, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, DP><<<qgrid, kThreads, dq_smem<DP>(), a.stream>>>(
      q, k, v, dout, a.stats, static_cast<T*>(a.dq), a.H, group, a.D, a.mk,
      a.qs, a.ks, a.vs, a.dos, a.dqs, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  if (a.D <= 32) return launch<T, 32>(a);
  if (a.D <= 64) return launch<T, 64>(a);
  if (a.D <= 128) return launch<T, 128>(a);
  return launch<T, 256>(a);
}

}  // namespace

extern "C" {

// dq, dk, dv of o = attention(q, k, v) given do, on `stream`: q, o, do, dq
// are (B, H, S, D) and k, v, dk, dv (B, KV, Sk, D), all fp32 (bf16 = 0) or
// all bf16, each with its own element strides over (B, heads, rows) and a
// unit stride over D.  `stats` is an fp32 scratch of 3 * B * H * S floats.
// window <= 0 means no window; Sk != S is refused under causal or window.
// Returns the cudaError_t of the launches (0 on success); does not
// synchronize or allocate.
int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, int bf16,
    int B, int H, int KV, int S, int Sk, int D, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dq_sb, long long dq_sh,
    long long dq_ss, long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss, float scale,
    int causal, int window, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || Sk < 1 ||
      D < 1 || D > 256 || (S + 31) / 32 > 65535 || (Sk + 15) / 16 > 65535 ||
      (Sk != S && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.stats = static_cast<float*>(stats);
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.mk = Mask{S, Sk, causal, window > 0 ? window : 0};
  a.qs = Strides{q_sb, q_sh, q_ss};
  a.ks = Strides{k_sb, k_sh, k_ss};
  a.vs = Strides{v_sb, v_sh, v_ss};
  a.os = Strides{o_sb, o_sh, o_ss};
  a.dos = Strides{do_sb, do_sh, do_ss};
  a.dqs = Strides{dq_sb, dq_sh, dq_ss};
  a.dks = Strides{dk_sb, dk_sh, dk_ss};
  a.dvs = Strides{dv_sb, dv_sh, dv_ss};
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(a) : dispatch<float>(a);
  return static_cast<int>(err);
}

const char* flash_attention_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
