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
//   delta = rowsum(do * o), or the caller's delta (B, H, S) fp32
//   dv    = P^T do                  summed over the g query heads of a kv head
//   dS    = P * (do . v^T - delta)
//   dq    = scale * dS k
//   dk    = scale * dS^T q          summed over the g query heads
// in fp32 (the tensor-core instance: fp32 accumulators, see its numerics
// below), each result rounded once to the inputs' dtype.  A row that
// sees no key (l == 0, where the forward writes zeros) gets P = 0, so its
// gradients are zero.
//
// delta stands for rowsum(P * dP) = do . (P v), the softmax's own row sum.
// From the bf16 o it is off by do . (o - P v), up to a rounding of o, and
// that error is common to every key of the row: each dS_ij takes
// -P_ij (delta error), and sum_j dS_ij, exactly 0, is not.  Where the
// layer's key inputs are alike (the decoder of a deep random encoder-
// decoder, whose cross-attention gives every position nearly the same
// output) wk's and wq's gradients are nearly that zero sum, and the error
// is 10x the bf16 floor.  So the training path (ops.FlashAttention) passes
// delta from the forward's unrounded o (csrc/flash_attention.cu's o32);
// a call without it computes delta from o, as here.
//
// What bounds it on an H100: the bound counts 10*D flops per visible
// (query, key) pair (s, dP, dV, dK, dQ: 2D each) at the bf16 tensor-core
// peak, against reading q, k, v, o, do and writing dq, dk, dv once; at
// qwen3-14b's (2, 40/8, 4096, 128) causal that is 0.87 ms, operations-
// bound.  Every instance recomputes P from q and k instead of keeping it
// (an S x S tile per head), and none uses atomics: every output element is
// summed by one thread in a fixed order, so the results repeat bit for bit
// and no partial buffers (dq partials would be ~5 GB at qwen3's shape) are
// needed.  Two instances; the wrapper picks one from dtype, D and the
// operands (ops.flash_backward_instance, the forward's rule):
//
// * flash_attention_backward_tc ("wgmma": bf16, D = 64, 128 or 256,
//   16-byte-aligned bases and strides of q, k, v, o, do) runs every product
//   on the tensor cores (bf16 wgmma, fp32 accumulators) in two kernels.  Tiles
//   arrive by TMA (128-byte swizzle, 64 x 64 boxes of 4-d tensor maps
//   built from the strides, so the model's transposed (B, S, heads, D)
//   buffers go in without a copy) in a two-stage ring guarded by
//   mbarriers.
//   A. dq_tc_kernel, per (b*h, 128-query tile), a block of three
//      warpgroups as the forward's flash_tc_kernel: two consumers of 64
//      rows, and one thread of the third issuing the loads, giving its
//      registers to the consumers (setmaxnreg).  q and do are loaded once;
//      delta = rowsum(do * o) from 16-byte loads of o and do (or the
//      caller's delta); loop 1 over
//      the key tiles the tile sees computes s = q k^T (SS wgmma, both
//      K-major) and the online max and sum, giving lse = m + log2 l per
//      row (log2 units; +inf for rows past S, so that their P is 0), which
//      is written with delta to an fp32 scratch of 2 * B * H * S_pad floats
//      (S_pad: S rounded up to 128) for pass B; loop 2 over the same tiles
//      computes s again and dP = do v^T, P = 2^(s - lse), dS = P (dP -
//      delta) in fp32 registers, and dq += dS k with dS as the register A
//      operand and k MN-major from shared memory (as the forward's P.V
//      reads V).  dq is stored times the scale from registers through its
//      strides.  This folds the stats and dq passes of the fp32 instance
//      into one launch; the forward writes no logsumexp, so serving keeps
//      its launches and bits.  At D = 256 the block is one consumer
//      warpgroup of 64 rows whose thread 0 issues the loads (128 threads,
//      192 KB: two consumers' q and do tiles and the K, V ring would pass
//      227 KB, and 128 registers of dq with s and dP pass the 168 of a
//      384-thread block; 224 used, no spill).
//   B. dkdv_tc_kernel, per (b*kv head, 64-key tile), one warpgroup a block
//      and two blocks an SM: the dk and dv accumulators (128 registers a
//      thread at D = 128) with s^T and dP^T need more than the 168
//      registers a thread of a three-warpgroup block gets (ptxas caps it
//      there whatever setmaxnreg asks, spills, and serializes the wgmmas),
//      so thread 0 issues the loads itself, refilling a stage as soon as
//      the four warps have released it.  K and V stay in shared memory
//      while, for each of the g query heads in order, the 64-row (q, do)
//      tiles that see the key tile stream through with their lse and delta
//      (1-D bulk copies): s^T = k q^T and dP^T = v do^T (SS), P^T and dS^T
//      in registers, then dv += P^T do and dk += dS^T q with do and q
//      MN-major; dk and dv accumulate in registers over the whole GQA
//      group, and one block writes each of their elements.  At D = 256
//      dk and dv of 64 keys would be 256 registers a thread, so two blocks
//      (blockIdx.z) split them into halves of 128 columns of D, each
//      recomputing s^T and dP^T over all of D (26*D flops a pair in all
//      instead of 22*D; 192 KB of shared memory, 255 registers, no
//      spill).  A long chain of wgmma accumulations loses the low bits
//      the bf16 rule's floor needs, so the group may be split: `splits`
//      blocks a (b, kv head), each over group / splits of its query heads
//      (at D = 256 one head a block; at D = 64 and 128 as few splits as
//      keep a block's chain within ops.BACKWARD_CHAIN_B k16 steps), each
//      storing fp32 sums that dkdv_reduce_kernel adds in order, scales
//      and rounds.  (The same one-warpgroup shape for pass A measured
//      slower at qwen3-14b's shape, so pass A keeps the shared key stream
//      of two consumers.)
//   Numerics: the products of bf16 operands are exact in the fp32
//   accumulators; P and dS, fp32 values, go into the tensor cores as the
//   A operand split into two bf16 terms, hi + lo (lo the rounding of what
//   hi leaves: p to ~2^-17), each its own wgmma into one accumulator.  One
//   term breaks the port's bf16 check (one ulp of the plain gradient plus
//   2e-5 of its max) by 16-39x; two hold it, the rest being one-ulp flips
//   of the final rounding (tests/test_torch_flash_grad.py emulates it).
//   So the instance runs 22*D flops a pair on the tensor cores: s three
//   times (pass A twice, pass B), dP twice, dv, dk and dq each 2 x 2D;
//   26*D at D = 256, where pass B's two column blocks each compute s and dP.
//   Ragged ends: TMA zero-fills rows past S and Sk; keys past Sk are masked
//   in pass A (and their dk, dv rows never stored in pass B), rows past S
//   have P = 0 through lse = +inf.  Only tiles that cross a mask edge pay
//   for the mask; tiles outside it are never loaded.
//
// * flash_attention_backward ("fma": fp32, bf16 at other D, and bf16
//   views the tensor maps cannot take) is the port's first design, three
//   passes of fp32 FMAs on the CUDA cores (67 TFLOP/s peak) with every
//   tile widened to fp32 in shared memory:
//   1. stats_kernel, per (b*h, query tile): m and l recomputed from q and
//      k over the key tiles the tile sees, and delta from do and o; written
//      to an fp32 scratch of 3 * B * H * S floats.
//   2. dkdv_kernel, per (b*kv head, key tile): K and V stay in shared
//      memory while the g query heads of the group, and for each head the
//      query tiles that see the key tile, stream through in a fixed order;
//      dk and dv accumulate in registers.
//   3. dq_kernel, per (b*h, query tile): the key tiles stream through; dq
//      accumulates in registers.
//   16*D flops per pair (2D, 8D, 6D); 128 threads (16 x 8) a block;
//   thread (ty, tx) owns query rows ty*kR .. ty*kR+kR-1 of a score tile
//   and keys tx + 8*j, and (in pass 2) key rows ty*kKR .. and columns tx +
//   8*j of D.  Tiles shrink with D so that a block fits in shared memory:
//   64 x 64 up to D = 64, 64 queries x 32 keys at D = 128, 32 x 16 at
//   D = 256.  Arbitrary element strides over (B, heads, rows) for every
//   operand and result; D has unit stride.  Under `causal` or `window`
//   only the tiles that see each other are visited; the ragged ends of S
//   and Sk are masked inside the kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
             const float* __restrict__ delta_in, float* __restrict__ stats,
             int H, int group, int D, Mask mk, Strides qs, Strides ks,
             Strides os, Strides dos, float scale) {
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

  // delta = rowsum(do * o), the 8 threads of a row over its D columns, or
  // the caller's
  const long long BHS = static_cast<long long>(gridDim.x) * mk.S;
  const long long base = static_cast<long long>(bh) * mk.S;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qp = q0 + ty * kR + i;
    float dl = 0.0f;
    if (qp < mk.S && delta_in == nullptr)
      for (int d = tx; d < D; d += kTX)
        dl = fmaf(widen(dob[qp * dos.s + d]), widen(ob[qp * os.s + d]), dl);
#pragma unroll
    for (int off = 1; off < kTX; off <<= 1)
      dl += __shfl_xor_sync(0xffffffffu, dl, off);
    if (delta_in != nullptr && qp < mk.S) dl = delta_in[base + qp];
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
  const float* delta;    // the caller's delta (B, H, S), or null
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
      q, k, o, dout, a.delta, a.stats, a.H, group, a.D, a.mk, a.qs, a.ks,
      a.os, a.dos, a.scale);
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

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16, D in {64, 128, 256}
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBox = 64;          // rows of a TMA box, a panel, a warpgroup's tile
constexpr int kStages = 2;        // depth of the streamed ring
constexpr int kThreads = 128;     // pass B: one warpgroup a block

// Pass A's block.  At D = 64 and 128: two consumer warpgroups of 64 query
// rows and a third whose one thread issues the loads (384 threads).  At
// D = 256 the q and do tiles of two consumers (128 KB) and a two-stage
// ring of 32 KB K and V tiles would pass the 227 KB of shared memory, and
// a consumer's 128 registers of dq with s and dP would pass the 168 a
// thread of a 384-thread block gets: one consumer warpgroup (128 threads,
// 192 KB), whose thread 0 refills a stage once its four warps released it.
template <int D>
struct PassA {
  static constexpr int kConsumers = D == 256 ? 1 : 2;
  static constexpr int kRows = kBox * kConsumers;          // query rows a block
  static constexpr int kThreads = D == 256 ? 128 : 384;
};

// Pass B's output columns a block: dk and dv of 64 keys at D = 256 are 256
// fp32 registers a thread of one warpgroup, so two blocks split D in
// halves of 128 columns, each recomputing s^T and dP^T over the whole D.
template <int D>
constexpr int kColsB = D < 128 ? D : 128;

// Pass B's blocks a (b, kv head), `splits`, the host's choice
// (ops.backward_splits): a block sums dk and dv over group / splits query
// heads in its tensor-core accumulators, one k16 step for every 16 query
// rows.  The tensor cores' fp32 accumulation drops low bits at each step,
// and a chain over recurrentgemma's 10 heads x 2048 queries (~1,300 steps,
// D = 256) carried dk and dv to ~2e-5 of their max from the plain fp32
// sums, the bf16 rule's floor, where one head's chain keeps them near the
// fp32-FMA instance's ~3e-6.  So D = 256 takes one head a block, and D =
// 64 and 128 as many heads as keep the chain within the longest one the
// card has held there (internvl2-1b's 7 heads x 4096 queries, 1,792
// steps).  With splits > 1 each block stores its fp32 partial sums and
// dkdv_reduce_kernel adds them in order.

// rows of the lse | delta scratch a (b, h): S rounded up to 128, whatever
// pass A's tile
__host__ __device__ constexpr int stats_rows(int S) {
  return (S + 127) / 128 * 128;
}

// A panel of 64 rows of a (rows, D) operand in shared memory: D / 64
// "halves" of 64 columns, each 64 rows of 128 bytes, swizzled by TMA in
// 1024-byte atoms of 8 rows.
template <int D>
struct Panel {
  static constexpr int kHalf = kBox * kRowBytes;
  static constexpr int kBytes = (D / 64) * kHalf;
};

// Pass A's shared memory, in bytes: the q and do tiles of the block, a
// 64-row panel for each consumer warpgroup, and a ring of (K, V) tiles of
// 64 keys; every buffer starts on a 1024-byte boundary.
template <int D>
struct LayoutA {
  static constexpr int kPanel = Panel<D>::kBytes;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + PassA<D>::kConsumers * kPanel;
  static constexpr int kK = kDO + PassA<D>::kConsumers * kPanel;
  static constexpr int kV = kK + kStages * kPanel;
  static constexpr int kBar = kV + kStages * kPanel;       // 1 + 2 kStages
  static constexpr int kBytes = kBar + 64 + 1024;           // + alignment slack
};

// Pass B's: the K and V tiles of the block (64 keys each) and a ring of
// (q, do) tiles of 64 rows with their 64 lse and 64 delta values.
template <int D>
struct LayoutB {
  static constexpr int kPanel = Panel<D>::kBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kPanel;
  static constexpr int kQ = kV + kPanel;
  static constexpr int kDO = kQ + kStages * kPanel;
  static constexpr int kStats = kDO + kStages * kPanel;     // lse | delta
  static constexpr int kStatsBytes = 2 * kBox * 4;
  static constexpr int kBar = kStats + kStages * kStatsBytes;
  static constexpr int kBytes = kBar + 64 + 1024;
};

// A contiguous span of device memory into shared memory (a 1-D bulk copy;
// addresses and size multiples of 16 bytes), completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Rows row0 .. row0 + 63 of head h, batch b into a Panel<D> at dst: one
// 64 x 64 box per half.
template <int D>
__device__ __forceinline__ void load_panel(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int row0, int h,
                                           int b) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf)
    tma_load(dst + hf * Panel<D>::kHalf, map, bar, 64 * hf, row0, h, b);
}

// acc (64 x N) += A . B over 64 rows of K: A as four k16 steps of
// registers, B the N / 64 halves of a panel from `panel` on, MN-major (its
// rows are the K dimension, contiguous in D).  Every two 64-column halves
// go in one m64n128k16 product, the second half one half-panel (LBO) past
// the first.
template <int N>
__device__ __forceinline__ void product_rs(float (&acc)[N / 64][32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t panel) {
  constexpr int kHalf = kBox * kRowBytes;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 64) {
      wgmma_rs(acc[0], a[kk],
               sw128_desc(panel + kk * 16 * kRowBytes, 1024, 1024));
    } else {
#pragma unroll
      for (int pr = 0; pr < N / 128; ++pr)
        wgmma_rs128(acc[2 * pr], acc[2 * pr + 1], a[kk],
                    sw128_desc(panel + 2 * pr * kHalf + kk * 16 * kRowBytes,
                               kHalf, 1024));
    }
  }
}

// d (64 x 64) = A . B^T over D, A and B K-major Panel<D>s (rows
// contiguous in D); D / 16 steps of 16 columns, 32 bytes apart inside a
// swizzled row (the hardware applies the swizzle to the address).
template <int D>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a_panel,
                                           uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int at = (kk / 4) * Panel<D>::kHalf + 32 * (kk % 4);
    wgmma_ss(d, sw128_desc(a_panel + at, 16, 1024),
             sw128_desc(b_panel + at, 16, 1024), kk > 0);
  }
}

// Releases the stage of load i (lane 0 of each warp arrives on its empty
// barrier); thread 0 then refills the stage with load i + kStages, if
// there is one of the `loads`, once all four warps have released it.
template <class Issue>
__device__ __forceinline__ void release(int i, int loads, uint32_t empty,
                                        int lane, Issue&& issue) {
  const int st = i % kStages;
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * st);
  if (threadIdx.x == 0 && i + kStages < loads) {
    mbar_wait(empty + 8 * st, (i / kStages) & 1);
    issue(i + kStages);
  }
  __syncwarp();
}

// An accumulator tile (64 x 64 fp32) as the A operand of a product over
// its columns, in two bf16 terms, hi + lo (lo the rounding of what hi
// leaves, an exact subtraction): registers 8 kk + 2 r, + 1 form register r
// of step kk.
__device__ __forceinline__ void split2(const float (&x)[32],
                                       uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&t);
      const __nv_bfloat162 u =
          __floats2bfloat162_rn(a - __low2float(t), b - __high2float(t));
      lo[kk][r] = *reinterpret_cast<const uint32_t*>(&u);
    }
}

__device__ __forceinline__ uint32_t align1024(const unsigned char* raw) {
  const uint32_t at = smem_u32(raw);
  return at + ((1024u - (at & 1023u)) & 1023u);
}

struct Out {
  __nv_bfloat16* p;
  long long sb, sh, ss;   // elements; D has unit stride
};

struct ArgsA {
  const __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  const __nv_bfloat16* dout;
  long long do_sb, do_sh, do_ss;
  const float* delta;    // the caller's delta (B, H, S), or null
  Out dq;
  float* stats;          // lse (log2 units) | delta, each B * H * S_pad
  int H, group, S_pad;
  Mask mk;
  float scale, scale_log2;
};

struct ArgsB {
  const float* stats;
  Out dk, dv;
  float* partials;       // fp32 (2, B * KV * splits, Sk, D) when splits > 1
  int H, KV, group, S_pad, splits;
  Mask mk;
  float scale, scale_log2;
};

// Rows r0 and r0 + 8 of a 64 x N accumulator, times `mul`, rounded once to
// bf16 through `out`'s strides from column 0 of `base`; rows at or past
// `rows` are not stored.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 64][32],
                                           __nv_bfloat16* base, long long ss,
                                           int r0, int rows, int c0,
                                           float mul) {
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int r = r0 + 8 * i2;
    if (r >= rows) continue;
    __nv_bfloat16* row = base + r * ss;
#pragma unroll
    for (int hf = 0; hf < N / 64; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * i2;
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * hf + 8 * j + c0) =
            __floats2bfloat162_rn(acc[hf][x] * mul, acc[hf][x + 1] * mul);
      }
  }
}

// Rows r0 and r0 + 8 of a 64 x N accumulator as fp32 at `base` (row
// stride ld floats, from column 0); rows at or past `rows` are not stored.
template <int N>
__device__ __forceinline__ void store_partial(const float (&acc)[N / 64][32],
                                              float* base, int ld, int r0,
                                              int rows, int c0) {
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int r = r0 + 8 * i2;
    if (r >= rows) continue;
    float* row = base + static_cast<long long>(r) * ld;
#pragma unroll
    for (int hf = 0; hf < N / 64; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * i2;
        *reinterpret_cast<float2*>(row + 64 * hf + 8 * j + c0) =
            make_float2(acc[hf][x], acc[hf][x + 1]);
      }
  }
}

// ---- pass A: lse, delta and dq per (b*h, query tile) ----
// At D = 64 and 128 two consumer warpgroups of 64 rows share the stream of
// key tiles, which one thread of a third warpgroup issues; at D = 256 one
// consumer warpgroup, whose thread 0 issues them (PassA).
template <int D>
__global__ void __launch_bounds__(PassA<D>::kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo, const ArgsA a) {
  using L = LayoutA<D>;
  constexpr int W = PassA<D>::kConsumers;
  constexpr bool kSelf = W == 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = align1024(smem_raw);
  const uint32_t sQ = base + L::kQ, sDO = base + L::kDO;
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full = q_full + 8;                     // kStages barriers
  const uint32_t empty = full + 8 * kStages;            // kStages barriers

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H, kvh = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * PassA<D>::kRows;  // heaviest first
  const int S = a.mk.S;
  const int wg = kSelf ? 0 : warpgroup();

  // the key tiles of the block, streamed twice: K alone for the row
  // statistics, then K and V for dq
  int blk_begin, blk_end;
  a.mk.key_tiles(q0, PassA<D>::kRows, kBox, blk_begin, blk_end);  // q0 < S
  const int n = blk_end - blk_begin;

  // the q and do tiles (a panel a consumer), and load i of the 2 n into
  // stage i % kStages
  auto issue_q = [&]() {
    mbar_expect_tx(q_full, 2 * W * L::kPanel);
    for (int w = 0; w < W; ++w) {
      load_panel<D>(sQ + w * L::kPanel, &tq, q_full, q0 + kBox * w, h, b);
      load_panel<D>(sDO + w * L::kPanel, &tdo, q_full, q0 + kBox * w, h, b);
    }
  };
  auto issue = [&](int i) {
    const int st = i % kStages;
    const bool second = i >= n;
    const int k0 = (blk_begin + (second ? i - n : i)) * kBox;
    mbar_expect_tx(full + 8 * st, (second ? 2 : 1) * L::kPanel);
    load_panel<D>(sK + st * L::kPanel, &tk, full + 8 * st, k0, kvh, b);
    if (second)
      load_panel<D>(sV + st * L::kPanel, &tv, full + 8 * st, k0, kvh, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * W);                 // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if constexpr (kSelf) {
      issue_q();
      for (int i = 0; i < min(2 * n, kStages); ++i) issue(i);
    }
  }
  __syncthreads();

  if (!kSelf && wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 256) {
      issue_q();
      for (int i = 0; i < 2 * n; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * st, ((i / kStages) - 1) & 1);
        issue(i);
      }
    }
  } else {
    if constexpr (!kSelf)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int qa = q0 + 64 * wg;
    // this thread's rows of every accumulator, r0 and r0 + 8, and its
    // columns 8 j + c0 + {0, 1}
    const int r0 = qa + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    int my_begin = 0, my_end = 0;                         // no rows: no tiles
    if (qa < S) a.mk.key_tiles(qa, kBox, kBox, my_begin, my_end);

    // delta = rowsum(do * o): the four threads of a quad share rows r0 and
    // r0 + 8, each summing a quarter of D from 16-byte loads
    float delta[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int qp = r0 + 8 * i2;
      float acc = 0.0f;
      if (qp < S && a.delta == nullptr) {
        const int d0 = (lane % 4) * (D / 4);
        const __nv_bfloat16* orow =
            a.o + b * a.o_sb + h * a.o_sh + qp * a.o_ss + d0;
        const __nv_bfloat16* drow =
            a.dout + b * a.do_sb + h * a.do_sh + qp * a.do_ss + d0;
#pragma unroll
        for (int c = 0; c < D / 4; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc = fmaf(__low2float(d2[e]), __low2float(o2[e]), acc);
            acc = fmaf(__high2float(d2[e]), __high2float(o2[e]), acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (a.delta != nullptr && qp < S)
        acc = a.delta[static_cast<long long>(bh) * S + qp];
      delta[i2] = acc;
    }

    // ---- loop 1: the row max m and sum l of 2^(s - m), s in log2 units ----
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      const int kt = blk_begin + i;
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      if (kt >= my_begin && kt < my_end) {
        const int k0 = kt * kBox;
        float s[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] = 0.0f;
        wgmma_fence();
        product_ss<D>(s, sQ + wg * L::kPanel, sK + st * L::kPanel);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        const bool edge = k0 + kBox > a.mk.Sk ||
                          (a.mk.causal && k0 + kBox - 1 > qa) ||
                          (a.mk.window > 0 && k0 <= qa + 63 - a.mk.window);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i2 = (x / 2) % 2;
          float val = s[x] * a.scale_log2;
          if (edge && !a.mk.visible(r0 + 8 * i2, k0 + 8 * (x / 4) + c0 + x % 2))
            val = kNegInf;
          s[x] = val;
          mx[i2] = fmaxf(mx[i2], val);
        }
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
          mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
          const float m_new = fmaxf(m[i2], mx[i2]);
          l[i2] *= ex2(m[i2] - m_new);
          m[i2] = m_new;
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) l[(x / 2) % 2] += ex2(s[x] - m[(x / 2) % 2]);
      }
      if constexpr (kSelf) {
        release(i, 2 * n, empty, lane, issue);
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
    }

    // lse = m + log2 l per row; rows past S (and a row that sees no key)
    // get +inf, so that their P is 0 in both passes, and delta 0
    float lse[2];
    const long long BHS = static_cast<long long>(gridDim.x) * a.S_pad;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 1);
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 2);
      const int qp = r0 + 8 * i2;
      const bool seen = qp < S && l[i2] > 0.0f;
      lse[i2] = seen ? m[i2] + log2f(l[i2]) : INFINITY;
      if (!seen) delta[i2] = 0.0f;
      if (lane % 4 == 0) {
        a.stats[static_cast<long long>(bh) * a.S_pad + qp] = lse[i2];
        a.stats[BHS + static_cast<long long>(bh) * a.S_pad + qp] = delta[i2];
      }
    }

    // ---- loop 2: P, dP = do v^T, dS = P (dP - delta), dq += dS k ----
    float dq[D / 64][32];   // 128 registers a thread at D = 256
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int x = 0; x < 32; ++x) dq[hf][x] = 0.0f;
    for (int i = n; i < 2 * n; ++i) {
      const int st = i % kStages;
      const int kt = blk_begin + i - n;
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      if (kt >= my_begin && kt < my_end) {
        const int k0 = kt * kBox;
        const uint32_t kbase = sK + st * L::kPanel;
        float s[32], dp[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          s[x] = 0.0f;
          dp[x] = 0.0f;
        }
        wgmma_fence();
        product_ss<D>(s, sQ + wg * L::kPanel, kbase);
        product_ss<D>(dp, sDO + wg * L::kPanel, sV + st * L::kPanel);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        const bool edge = k0 + kBox > a.mk.Sk ||
                          (a.mk.causal && k0 + kBox - 1 > qa) ||
                          (a.mk.window > 0 && k0 <= qa + 63 - a.mk.window);
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i2 = (x / 2) % 2;
          float p = ex2(s[x] * a.scale_log2 - lse[i2]);
          if (edge && !a.mk.visible(r0 + 8 * i2, k0 + 8 * (x / 4) + c0 + x % 2))
            p = 0.0f;
          dp[x] = p * (dp[x] - delta[i2]);                // dS
        }
        uint32_t ds_hi[4][4], ds_lo[4][4];
        split2(dp, ds_hi, ds_lo);
        wgmma_fence();
        product_rs<D>(dq, ds_hi, kbase);
        product_rs<D>(dq, ds_lo, kbase);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) fence_regs(dq[hf]);
      }
      if constexpr (kSelf) {
        release(i, 2 * n, empty, lane, issue);
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
    }
    store_rows<D>(dq, a.dq.p + b * a.dq.sb + h * a.dq.sh, a.dq.ss, r0, S, c0,
                  a.scale);
  }
}

// ---- pass B: dk and dv per (b*kv head, 64-key tile, kColsB columns) ----
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo, const ArgsB a) {
  using L = LayoutB<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = align1024(smem_raw);
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t sQ = base + L::kQ, sDO = base + L::kDO;
  const uint32_t sStats = base + L::kStats;
  const uint32_t kv_full = base + L::kBar;
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * kStages;

  const int bkv = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int heads = a.group / a.splits;   // the block's query heads
  const int k0 = blockIdx.y * kBox;   // under `causal` the first tiles see most
  constexpr int N = kColsB<D>;        // the block's columns of dk and dv
  const int col0 = blockIdx.z * N;
  const uint32_t cols = (col0 / 64) * Panel<D>::kHalf;   // their first half
  const int Sk = a.mk.Sk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the query tiles the block's keys see, for each of its heads in order
  int q_begin, q_end;
  a.mk.query_tiles(k0, kBox, kBox, q_begin, q_end);
  const int per_head = max(q_end - q_begin, 0);
  const int n = heads * per_head;
  const long long BHS =
      static_cast<long long>(gridDim.x / (a.KV * a.splits)) * a.H * a.S_pad;

  // tile i of the block's sequence into its stage (thread 0 only)
  auto issue = [&](int i) {
    const int st = i % kStages;
    const int h = kvh * a.group + split * heads + i / per_head;
    const int q0 = (q_begin + i % per_head) * kBox;
    const uint32_t bar = full + 8 * st;
    mbar_expect_tx(bar, 2 * L::kPanel + L::kStatsBytes);
    load_panel<D>(sQ + st * L::kPanel, &tq, bar, q0, h, b);
    load_panel<D>(sDO + st * L::kPanel, &tdo, bar, q0, h, b);
    const float* row =
        a.stats + (static_cast<long long>(b) * a.H + h) * a.S_pad + q0;
    bulk_load(sStats + st * L::kStatsBytes, row, kBox * 4, bar);
    bulk_load(sStats + st * L::kStatsBytes + kBox * 4, row + BHS, kBox * 4,
              bar);
  };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4);                     // the 4 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(kv_full, 2 * L::kPanel);
    load_panel<D>(sK, &tk, kv_full, k0, kvh, b);
    load_panel<D>(sV, &tv, kv_full, k0, kvh, b);
    for (int i = 0; i < min(n, kStages); ++i) issue(i);
  }
  __syncthreads();

  // this thread's key rows r0 and r0 + 8 and query columns 8 j + c0 + {0, 1}
  const int r0 = k0 + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  float dk[N / 64][32], dv[N / 64][32];
#pragma unroll
  for (int hf = 0; hf < N / 64; ++hf)
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      dk[hf][x] = 0.0f;
      dv[hf][x] = 0.0f;
    }
  mbar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const int q0 = (q_begin + i % per_head) * kBox;
    const uint32_t qbase = sQ + st * L::kPanel;
    const uint32_t dobase = sDO + st * L::kPanel;
    const float* lse_s = reinterpret_cast<const float*>(
        smem_raw + (sStats + st * L::kStatsBytes - smem_u32(smem_raw)));
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    float s[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      s[x] = 0.0f;
      dp[x] = 0.0f;
    }
    // s^T = k q^T and dP^T = v do^T for the block's 64 keys
    wgmma_fence();
    product_ss<D>(s, sK, qbase);
    product_ss<D>(dp, sV, dobase);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    // P^T = 2^(s^T - lse) (0 past S: lse = +inf there) and dS^T =
    // P^T (dP^T - delta), by query column
    const bool edge = (a.mk.causal && q0 < k0 + 63) ||
                      (a.mk.window > 0 && q0 + 63 >= k0 + a.mk.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + c0;
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dl = *reinterpret_cast<const float2*>(lse_s + kBox + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const int kp = r0 + 8 * ((e / 2) % 2);
        const int qp = q0 + col + e % 2;
        float p = ex2(s[x] * a.scale_log2 - (e % 2 ? ls.y : ls.x));
        if (edge && !a.mk.visible(qp, kp)) p = 0.0f;
        s[x] = p;
        dp[x] = p * (dp[x] - (e % 2 ? dl.y : dl.x));
      }
    }
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    split2(s, p_hi, p_lo);
    split2(dp, ds_hi, ds_lo);
    // dv += P^T do and dk += dS^T q over the block's columns, do and q
    // MN-major
    wgmma_fence();
    product_rs<N>(dv, p_hi, dobase + cols);
    product_rs<N>(dv, p_lo, dobase + cols);
    product_rs<N>(dk, ds_hi, qbase + cols);
    product_rs<N>(dk, ds_lo, qbase + cols);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hf = 0; hf < N / 64; ++hf) {
      fence_regs(dk[hf]);
      fence_regs(dv[hf]);
    }
    release(i, n, empty, lane, issue);
  }
  if (a.splits == 1) {
    store_rows<N>(dk, a.dk.p + b * a.dk.sb + kvh * a.dk.sh + col0, a.dk.ss,
                  r0, Sk, c0, a.scale);
    store_rows<N>(dv, a.dv.p + b * a.dv.sb + kvh * a.dv.sh + col0, a.dv.ss,
                  r0, Sk, c0, 1.0f);
  } else {
    // this head's fp32 sums, unscaled, at (b * H + h, key, column)
    const long long slab = static_cast<long long>(Sk) * D;
    float* pk = a.partials + blockIdx.x * slab + col0;
    store_partial<N>(dk, pk, D, r0, Sk, c0);
    store_partial<N>(dv, pk + gridDim.x * slab, D, r0, Sk, c0);
  }
}

// dk and dv from pass B's fp32 partial sums (splits > 1): each element of
// (b * KV + kvh, key, column) the sum over the group's splits in order, dk
// times the scale, rounded once to bf16 through the outputs' strides; two
// columns a thread.
__global__ void __launch_bounds__(256)
dkdv_reduce_kernel(const float* __restrict__ partials, Out dk, Out dv,
                   int KV, int splits, int Sk, int D, long long pairs,
                   float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= pairs) return;
  const int col = static_cast<int>((2 * i) % D);
  const long long rest = (2 * i) / D;
  const int key = static_cast<int>(rest % Sk);
  const int bkv = static_cast<int>(rest / Sk);
  const int b = bkv / KV, kvh = bkv % KV;
  const long long slab = static_cast<long long>(Sk) * D;
  const long long second = 2 * pairs * splits;   // dv's partials
  const float* src = partials + static_cast<long long>(bkv) * splits * slab +
                     static_cast<long long>(key) * D + col;
  float2 sk = make_float2(0.0f, 0.0f), sv = sk;
  for (int sp = 0; sp < splits; ++sp) {
    const float2 pk = *reinterpret_cast<const float2*>(src + sp * slab);
    const float2 pv =
        *reinterpret_cast<const float2*>(src + second + sp * slab);
    sk.x += pk.x;
    sk.y += pk.y;
    sv.x += pv.x;
    sv.y += pv.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk.p + b * dk.sb + kvh * dk.sh +
                                     key * dk.ss + col) =
      __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  *reinterpret_cast<__nv_bfloat162*>(dv.p + b * dv.sb + kvh * dv.sh +
                                     key * dv.ss + col) =
      __floats2bfloat162_rn(sv.x, sv.y);
}

// The operands of one call: pointers, shapes and element strides over (B,
// heads, rows) of q, k, v, o, do, dq, dk, dv, in that order.
struct Call {
  const void *q, *k, *v, *o, *dout;
  const float* delta;
  void *dq, *dk, *dv;
  float *stats, *partials;
  int splits;
  int B, H, KV, S, Sk;
  long long st[8][3];
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <int D>
int launch(const Call& c) {
  CUtensorMap tq, tk, tv, tdo;
  auto map = [&](CUtensorMap* m, const void* p, int rows, int heads, int t) {
    return make_map(m, p, D, rows, heads, c.B, c.st[t][0], c.st[t][1],
                    c.st[t][2], kBox);
  };
  int err = map(&tq, c.q, c.S, c.H, 0);
  if (err == 0) err = map(&tk, c.k, c.Sk, c.KV, 1);
  if (err == 0) err = map(&tv, c.v, c.Sk, c.KV, 2);
  if (err == 0) err = map(&tdo, c.dout, c.S, c.H, 4);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      LayoutA<D>::kBytes);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(dkdv_tc_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                LayoutB<D>::kBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int q_tiles = (c.S + PassA<D>::kRows - 1) / PassA<D>::kRows;
  const Mask mk{c.S, c.Sk, c.causal, c.window > 0 ? c.window : 0};
  const float scale_log2 = c.scale * kLog2e;
  auto out = [&](void* p, int i) {
    return Out{static_cast<__nv_bfloat16*>(p), c.st[i][0], c.st[i][1],
               c.st[i][2]};
  };
  const ArgsA aa{static_cast<const __nv_bfloat16*>(c.o), c.st[3][0],
                 c.st[3][1], c.st[3][2],
                 static_cast<const __nv_bfloat16*>(c.dout), c.st[4][0],
                 c.st[4][1], c.st[4][2], c.delta, out(c.dq, 5), c.stats, c.H,
                 c.H / c.KV, stats_rows(c.S), mk, c.scale, scale_log2};
  dq_tc_kernel<D><<<dim3(c.B * c.H, q_tiles), PassA<D>::kThreads,
                    LayoutA<D>::kBytes, c.stream>>>(tq, tk, tv, tdo, aa);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int splits = c.splits;
  const ArgsB ab{c.stats, out(c.dk, 6), out(c.dv, 7), c.partials, c.H, c.KV,
                 c.H / c.KV, stats_rows(c.S), splits, mk, c.scale,
                 scale_log2};
  dkdv_tc_kernel<D><<<dim3(c.B * c.KV * splits, (c.Sk + kBox - 1) / kBox,
                           D / kColsB<D>),
                      kThreads, LayoutB<D>::kBytes, c.stream>>>(tq, tk, tv,
                                                                 tdo, ab);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess || splits == 1) return static_cast<int>(cerr);
  const long long pairs = static_cast<long long>(c.B) * c.KV * c.Sk * D / 2;
  dkdv_reduce_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0,
                       c.stream>>>(c.partials, out(c.dk, 6), out(c.dv, 7),
                                   c.KV, splits, c.Sk, D, pairs, c.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

extern "C" {

// dq, dk, dv of o = attention(q, k, v) given do, on `stream`: q, o, do, dq
// are (B, H, S, D) and k, v, dk, dv (B, KV, Sk, D), all fp32 (bf16 = 0) or
// all bf16, each with its own element strides over (B, heads, rows) and a
// unit stride over D.  `stats` is an fp32 scratch of 3 * B * H * S floats.
// window <= 0 means no window; Sk != S is refused under causal or window.
// delta, unless null, is fp32 (B, H, S) dense and stands for rowsum(do *
// o).  Returns the cudaError_t of the launches (0 on success); does not
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
    int causal, int window, const void* delta, void* stream) {
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
  a.delta = static_cast<const float*>(delta);
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

// The tensor-core instance: q, o, do, dq (B, H, S, D) and k, v, dk, dv
// (B, KV, Sk, D), all bf16, D = 64, 128 or 256.  q, k, v, o and do need
// 16-byte-aligned bases and element strides over (B, heads, rows) that are
// multiples of 8 (a dimension of size 1 may pass any such stride); dq, dk
// and dv 4-byte-aligned bases and even strides.  `stats` is an fp32
// scratch of 2 * B * H * S_pad floats, S_pad = S rounded up to a multiple
// of 128, 16-byte aligned; `splits` pass B's blocks a (b, kv head), a
// divisor of H / KV; `partials`, where splits > 1, an fp32 scratch of
// 2 * B * KV * splits * Sk * D floats, 16-byte aligned (pass B's sums a
// block; null elsewhere).  delta as flash_attention_backward's, 4-byte
// aligned.  Same return convention as flash_attention_backward, with the
// tensor-map errors of flash_attention_backward_error_string besides.
int flash_attention_backward_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats,
    void* partials, int splits, int B,
    int H, int KV, int S, int Sk, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, long long do_sb, long long do_sh,
    long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
    long long dv_sh, long long dv_ss, float scale, int causal, int window,
    const void* delta, void* stream) {
  tc::Call c{q, k, v, o, dout, static_cast<const float*>(delta), dq, dk, dv,
             static_cast<float*>(stats),
             static_cast<float*>(partials), splits, B, H, KV, S, Sk,
             {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
              {o_sb, o_sh, o_ss}, {do_sb, do_sh, do_ss},
              {dq_sb, dq_sh, dq_ss}, {dk_sb, dk_sh, dk_ss},
              {dv_sb, dv_sh, dv_ss}},
             scale, causal, window, static_cast<cudaStream_t>(stream)};
  bool ok = B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 &&
            Sk >= 1 && (D == 64 || D == 128 || D == 256) &&
            (S + tc::kBox - 1) / tc::kBox <= 65535 &&
            (Sk + tc::kBox - 1) / tc::kBox <= 65535 &&
            (Sk == S || (!causal && window <= 0));
  for (int t = 0; t < 8; ++t)
    for (long long st : c.st[t])
      ok = ok && st > 0 && st % (t < 5 ? 8 : 2) == 0;
  const void* const loaded[5] = {q, k, v, o, dout};
  for (const void* p : loaded)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const void* const stored[3] = {dq, dk, dv};
  for (const void* p : stored)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 4 == 0;
  ok = ok && reinterpret_cast<uintptr_t>(stats) % 16 == 0;
  ok = ok && splits >= 1 && H % KV == 0 && (H / KV) % splits == 0;
  ok = ok && (splits == 1 || (partials != nullptr &&
                              reinterpret_cast<uintptr_t>(partials) % 16 ==
                                  0));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return tc::launch<64>(c);
  if (D == 128) return tc::launch<128>(c);
  return tc::launch<256>(c);
}

const char* flash_attention_backward_error_string(int err) {
  return tc::error_string(err);
}

}  // extern "C"
