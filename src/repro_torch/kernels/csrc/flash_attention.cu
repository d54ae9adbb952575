// Flash attention for Hopper (sm_90a): grouped-query attention with an
// online softmax, causal and sliding-window masks.  Plain C interface,
// bound with ctypes by src/repro_torch/kernels/ops.py; built by
// src/repro_torch/kernels/build.py.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   flash_attention  <- repro/kernels/flash_attention.py:flash_attention
//                       (_flash_kernel)
// and computes what it computes: for q (B, H, S, D) and k, v (B, KV, Sk, D)
// in fp32 or bf16, with query head h reading kv head h / (H / KV),
//   s = (q . k^T) * sm_scale                      (fp32)
//   s = -1e30 where k_pos >= Sk, or (causal) k_pos > q_pos, or
//       (window) k_pos <= q_pos - window
//   online softmax over the key tiles: m, l, acc in fp32
//   o = acc / l, with l == 0 giving zeros, cast once to q's dtype;
//   where the caller passes o32 (training: ops.FlashAttention), the same
//   acc / l also goes out unrounded in fp32, for the backward's
//   delta = rowsum(do * o), which the rounded o would bias (see
//   flash_backward.cu).
// The Pallas kernel takes one length for both (Sk = S: self-attention).
// Here the keys may have their own length Sk, as cross-attention needs
// (queries of the decoder's prompt against the encoder's frames); the
// wrapper allows Sk != S only without the causal and window masks, whose
// positions would otherwise be ambiguous.
//
// What bounds it on an H100: causal attention does 4*D flops per (query,
// visible key) pair, 4*B*H*D*S(S+1)/2 in all, against reading q, k, v and
// writing o once; at S = 2048 and D = 128 that is ~500 flops per byte,
// above the card's ridge, so the bound is the operations.
//
// Two instances; the wrapper picks one by dtype, D and the operands:
//
// * flash_attention_tc (bf16, D = 64, 128 or 256: every model the port
//   serves) runs both products on the tensor cores.  One block per (b*h,
//   128-query tile): warpgroups 0 and 1 each own 64 query rows; at D = 64
//   and 128 one thread of a third warpgroup issues TMA loads of the q tile
//   and of a two-stage ring of (64-key K, V) tiles, guarded by mbarriers,
//   and gives its registers to the consumers (setmaxnreg).  At D = 256 a
//   consumer thread holds 128 fp32 registers of O, 32 of s and 48 of the
//   three-term P, past the 168 that ptxas gives a thread of a 384-thread
//   block whatever setmaxnreg asks: the block is the two consumers alone
//   (256 threads, up to 255 registers a thread; 250 used, no spill), and
//   thread 0 issues the loads, refilling a stage once the eight consumer
//   warps have released it.  Its 64 KB q tile and two stages of 32 KB K and
//   V tiles take 192 KB of shared memory, one block an SM.  The tiles land
//   in shared memory with TMA's 128-byte swizzle, which the wgmma
//   descriptors read back: q . k^T is one bf16 m64n64k16 wgmma per 16
//   columns of D with both operands K-major in shared memory (k rows are
//   keys contiguous in D: no transpose).  The probabilities stay in
//   registers as the A operand of the second product, against V in shared
//   memory as an MN-major B operand (m64n128k16 at D = 128 and 256: two
//   64-column halves of V in one product).  The port's correctness check holds
//   the bf16 output to one bf16 ulp (plus 1e-6) of its fp32-P plain
//   version.  P rounded once to bf16 before P.V breaks it (~12 % of the
//   outputs at S = 2048), and so does P split into two bf16 terms (p to
//   ~2^-17: the small outputs of rows that see few keys, as under a
//   window of 17, miss the 1e-6); so P is split into three bf16 terms,
//   hi + mid + lo, which hold its 24 bits, and all three go through the
//   tensor cores into one fp32 accumulator: 8*D flops per pair instead of
//   4*D.  Each consumer runs a tile's two products and its softmax in turn;
//   the two consumers overlap each other.  The ragged end of Sk is TMA's
//   zero fill plus the k_pos < Sk mask; rows past S are not stored; tiles
//   wholly above the diagonal or left of the window are never loaded, and only
//   the tiles that cross a mask edge pay for the mask.  q, k, v are read
//   through 4-d tensor maps (D, S, heads, B) built from their strides, so
//   the model's transposed (B, S, H, D) buffers go in without a copy; o is
//   stored from registers through its own strides.  The tensor maps are
//   encoded with cuTensorMapEncodeTiled, fetched through
//   cudaGetDriverEntryPoint: the library does not link libcuda.
//
// * flash_attention (fp32, bf16 at other D, and bf16 views the tensor maps
//   cannot take) is the first kernel of the
//   port: fp32 FMAs on the CUDA cores (67 TFLOP/s peak).  One thread block
//   (128 threads, 16 x 8) per (b*h, 64-query tile).  The q tile is staged
//   once in shared memory as fp32; the key tiles (64 keys) stream through
//   shared memory in the input dtype (bf16 is widened exactly at use), read
//   through the GQA map h / g from the shared kv head (K/V are never copied
//   per query head).  Thread (ty, tx) owns query rows 4*ty .. 4*ty+3: it
//   computes their scores against keys tx + 8*j, keeps their m and l (the
//   8 threads of a row group agree through shuffles), and accumulates
//   their output columns tx + 8*j of D.  The probabilities go through
//   shared memory between the two products.  Under `causal` the key tiles
//   wholly above the diagonal are never visited, under `window` those
//   wholly left of it; the ragged end of Sk is masked inside the kernel
//   (rows past S are computed on zeros and not stored).  Query tiles are
//   issued heaviest first (the last tile sees the most keys under
//   `causal`), in both instances.  Arbitrary strides on B, H and S; D has
//   unit stride.  Shared memory exceeds the 48 KB default for every D
//   above 32, so each instance opts in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ o32, int H, int group, int S, int Sk, int D,
             Strides qs, Strides ks, Strides vs, Strides os, float scale,
             int causal, int window) {
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
  int kt_end = (Sk + kBK - 1) / kBK;
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
      const bool ok = kp < Sk && d < D;
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
        bool ok = kp < Sk;
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
  // the unrounded o, (B, H, S, D) dense, where the caller asks for it
  float* o32b = o32 ? o32 + static_cast<long long>(bh) * S * D : nullptr;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= S) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < DP / kTX; ++j) {
      const int d = tx + kTX * j;
      if (d >= D) continue;
      const float x = acc[i][j] / denom;
      ob[qp * os.s + d] = narrow<T>(x);
      if (o32b) o32b[static_cast<long long>(qp) * D + d] = x;
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* o32, int B, int H, int KV, int S, int Sk, int D,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, int window,
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
      static_cast<const T*>(v), static_cast<T*>(o), o32, H, H / KV, S, Sk, D,
      qs, ks, vs, os, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* o32, int B, int H, int KV, int S, int Sk, int D,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, o32, B, H, KV, S, Sk, D, qs, ks, vs,
                         os, scale, causal, window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, o32, B, H, KV, S, Sk, D, qs, ks, vs,
                         os, scale, causal, window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, o32, B, H, KV, S, Sk, D, qs, ks, vs,
                          os, scale, causal, window, stream);
  return launch<T, 256>(q, k, v, o, o32, B, H, KV, S, Sk, D, qs, ks, vs, os,
                        scale, causal, window, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16, D in {64, 128, 256}
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;         // query rows per block (two consumer warpgroups)
constexpr int kBK = 64;          // keys per tile
constexpr int kStages = 2;       // K/V ring depth

// Who issues the loads.  At D = 64 and 128 a third warpgroup does (384
// threads), one of its threads keeping the ring full, and gives its
// registers to the consumers (setmaxnreg).  At D = 256 a consumer thread
// holds 128 fp32 registers of O, 32 of s and 48 of the three-term P, more
// than the 168 a thread of a 384-thread block gets (ptxas caps it there
// whatever setmaxnreg asks), so the block is the two consumer warpgroups
// alone (256 threads, up to 255 registers a thread) and thread 0 refills a
// stage once all eight consumer warps have released it.
template <int D>
struct Loads {
  static constexpr bool kSelf = D == 256;
  static constexpr int kThreads = kSelf ? 256 : 384;
};

// Shared memory of one block, in bytes.  Every tile is stored as D / 64
// "halves" of 64 columns (one TMA box each), rows at 128 bytes, swizzled in
// 1024-byte atoms of 8 rows; every buffer starts on a 1024-byte boundary.
// At D = 256: a 64 KB q tile and two stages of 32 KB K and V tiles, 192 KB.
template <int D>
struct Layout {
  static constexpr int kHalves = D / 64;
  static constexpr int kQHalf = kBQ * kRowBytes;          // 16 KB
  static constexpr int kTileHalf = kBK * kRowBytes;       // 8 KB
  static constexpr int kTile = kHalves * kTileHalf;       // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kHalves * kQHalf;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;       // 1 + 2 * kStages
  static constexpr int kBytes = kBar + 64 + 1024;         // + alignment slack
};

// Two fp32 values as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(first, second);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The key tiles [begin, end) of Sk keys that query rows first .. last can
// see.
__device__ __forceinline__ void key_tiles(int first, int last, int Sk,
                                          int causal, int window, int& begin,
                                          int& end) {
  end = (Sk + kBK - 1) / kBK;
  if (causal) end = min(end, last / kBK + 1);
  begin = 0;
  if (window > 0 && first - window + 1 > 0) begin = (first - window + 1) / kBK;
}

struct OutArgs {
  __nv_bfloat16* o;
  long long sb, sh, ss;   // elements; D has unit stride
  float* o32;             // the unrounded o, (B, H, S, D) dense, or null
};

template <int D>
__global__ void __launch_bounds__(Loads<D>::kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, OutArgs out, int H,
                int group, int S, int Sk, float scale_log2, int causal,
                int window) {
  using L = Layout<D>;
  constexpr bool kSelf = Loads<D>::kSelf;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t kv_full = q_full + 8;                  // kStages barriers
  const uint32_t kv_empty = kv_full + 8 * kStages;      // kStages barriers

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;    // heaviest first
  // the consumers' branches on wg hold wgmmas: at D = 256 wg comes from
  // lane 0, so that ptxas knows it is uniform across the warp
  const int wg = kSelf ? warpgroup() : threadIdx.x / 128;

  // The key tiles of the block: those its first to its last row can see.
  int blk_begin, blk_end;
  key_tiles(q0, min(q0 + kBQ, S) - 1, Sk, causal, window, blk_begin, blk_end);
  const int n_tiles = blk_end - blk_begin;

  // the q tile, and key tile i of the block into stage i % kStages
  auto issue_q = [&]() {
    mbar_expect_tx(q_full, L::kHalves * L::kQHalf);
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf)
      tma_load(sQ + hf * L::kQHalf, &tq, q_full, 64 * hf, q0, h, b);
  };
  auto issue = [&](int i) {
    const int st = i % kStages;
    const uint32_t full = kv_full + 8 * st;
    mbar_expect_tx(full, 2 * L::kTile);
    const int k0 = (blk_begin + i) * kBK;
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf) {
      tma_load(sK + st * L::kTile + hf * L::kTileHalf, &tk, full, 64 * hf,
               k0, kvh, b);
      tma_load(sV + st * L::kTile + hf * L::kTileHalf, &tv, full, 64 * hf,
               k0, kvh, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, 8);                  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if constexpr (kSelf) {
      issue_q();
      for (int i = 0; i < min(n_tiles, kStages); ++i) issue(i);
    }
  }
  __syncthreads();

  if (!kSelf && wg == 2) {
    // ---- producer: one thread keeps the loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 256) {
      issue_q();
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages)                               // stage released?
          mbar_wait(kv_empty + 8 * st, ((i / kStages) - 1) & 1);
        issue(i);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows qa .. qa + 63 ----
    if constexpr (!kSelf)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int qa = q0 + 64 * wg;
    // this thread's two rows of every accumulator: r0 and r0 + 8; its
    // columns 8 j + c0 + {0, 1}
    const int r0 = qa + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    int my_begin = 0, my_end = 0;                       // no rows: no tiles
    if (qa < S)
      key_tiles(qa, min(qa + 64, S) - 1, Sk, causal, window, my_begin,
                my_end);

    float acc[L::kHalves][32];
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[hf][x] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int kt = blk_begin + i;
      mbar_wait(kv_full + 8 * st, (i / kStages) & 1);
      if (kt >= my_begin && kt < my_end) {
        const int k0 = kt * kBK;
        const uint32_t kbase = sK + st * L::kTile;
        const uint32_t vbase = sV + st * L::kTile;

        // s = q . k^T: D / 16 steps of 16 columns, 32 bytes apart inside a
        // swizzled row (the hardware applies the swizzle to the address)
        float s[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int hf = kk / 4, within = 32 * (kk % 4);
          const uint64_t da = sw128_desc(
              sQ + hf * L::kQHalf + wg * 64 * kRowBytes + within, 16, 1024);
          const uint64_t db =
              sw128_desc(kbase + hf * L::kTileHalf + within, 16, 1024);
          wgmma_ss(s, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // mask (only tiles that cross an edge), scale to log2 units, row max
        const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > qa) ||
                          (window > 0 && k0 <= qa + 63 - window);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i2 = (x / 2) % 2;                   // row r0 or r0 + 8
          float val = s[x] * scale_log2;
          if (edge) {
            const int kp = k0 + 8 * (x / 4) + c0 + (x % 2);
            const int qp = r0 + 8 * i2;
            bool ok = kp < Sk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) val = kNegInf;
          }
          s[x] = val;
          mx[i2] = fmaxf(mx[i2], val);
        }
        float alpha[2];
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
          mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
          const float m_new = fmaxf(m[i2], mx[i2]);
          alpha[i2] = ex2(m[i2] - m_new);
          m[i2] = m_new;
          l[i2] *= alpha[i2];                           // this thread's share
        }

        // p = 2^(s - m), split into three bf16 terms, hi + mid + lo, each
        // the rounding of what the earlier ones leave (exact in fp32): the
        // A operands of P . V.  The accumulator's (row, key) layout is the A
        // operand's (row, k) layout: registers 8 kk + 2 r, + 1 form
        // register r of step kk.
        uint32_t p_hi[4][4], p_mid[4][4], p_lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int x = 8 * kk + 2 * r, i2 = r % 2;
            float p0 = ex2(s[x] - m[i2]);
            float p1 = ex2(s[x + 1] - m[i2]);
            l[i2] += p0 + p1;
            __nv_bfloat162 t = __floats2bfloat162_rn(p0, p1);
            p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&t);
            p0 -= __low2float(t);
            p1 -= __high2float(t);
            t = __floats2bfloat162_rn(p0, p1);
            p_mid[kk][r] = *reinterpret_cast<const uint32_t*>(&t);
            p_lo[kk][r] = pack_bf16(p0 - __low2float(t), p1 - __high2float(t));
          }
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf) {
#pragma unroll
          for (int x = 0; x < 32; ++x) acc[hf][x] *= alpha[(x / 2) % 2];
          fence_regs(acc[hf]);
        }

        // acc += p_hi . V + p_mid . V + p_lo . V: 16 keys a step, 2048
        // bytes apart (two 8-row swizzle atoms); at D = 64 one 64-wide
        // product, else one 128-wide product per two 64-column halves of D
        // (the second block of 64 columns lies one half-tile, the LBO, past
        // the first)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (D == 64) {
            const uint64_t dv =
                sw128_desc(vbase + kk * 16 * kRowBytes, 1024, 1024);
            wgmma_rs(acc[0], p_hi[kk], dv);
            wgmma_rs(acc[0], p_mid[kk], dv);
            wgmma_rs(acc[0], p_lo[kk], dv);
          } else {
#pragma unroll
            for (int pr = 0; pr < D / 128; ++pr) {
              const uint64_t dv =
                  sw128_desc(vbase + 2 * pr * L::kTileHalf +
                                 kk * 16 * kRowBytes,
                             L::kTileHalf, 1024);
              wgmma_rs128(acc[2 * pr], acc[2 * pr + 1], p_hi[kk], dv);
              wgmma_rs128(acc[2 * pr], acc[2 * pr + 1], p_mid[kk], dv);
              wgmma_rs128(acc[2 * pr], acc[2 * pr + 1], p_lo[kk], dv);
            }
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf) fence_regs(acc[hf]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * st);    // the stage is free
      if constexpr (kSelf) {
        // thread 0 refills the stage once all eight warps have released it
        if (threadIdx.x == 0 && i + kStages < n_tiles) {
          mbar_wait(kv_empty + 8 * st, (i / kStages) & 1);
          issue(i + kStages);
        }
        __syncwarp();
      }
    }

    // o = acc / l, rounded once; rows past S are not stored
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 1);
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 2);
    }
    __nv_bfloat16* ob = out.o + b * out.sb + h * out.sh;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int qp = r0 + 8 * i2;
      if (qp >= S) continue;
      const float inv = 1.0f / (l[i2] == 0.0f ? 1.0f : l[i2]);
      __nv_bfloat16* row = ob + qp * out.ss;
#pragma unroll
      for (int hf = 0; hf < L::kHalves; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int x = 4 * j + 2 * i2;
          *reinterpret_cast<__nv_bfloat162*>(row + 64 * hf + 8 * j + c0) =
              __floats2bfloat162_rn(acc[hf][x] * inv, acc[hf][x + 1] * inv);
        }
      // the same values unrounded, where the caller asks for them (the
      // backward's delta = rowsum(do * o) in training)
      if (out.o32 != nullptr) {
        float* row32 = out.o32 + (static_cast<long long>(bh) * S + qp) * D;
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int x = 4 * j + 2 * i2;
            *reinterpret_cast<float2*>(row32 + 64 * hf + 8 * j + c0) =
                make_float2(acc[hf][x] * inv, acc[hf][x + 1] * inv);
          }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* o32,
           int B, int H, int KV, int S, int Sk, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, S, H, B, qs.b, qs.h, qs.s, kBQ);
  if (err == 0) err = make_map(&tk, k, D, Sk, KV, B, ks.b, ks.h, ks.s, kBK);
  if (err == 0) err = make_map(&tv, v, D, Sk, KV, B, vs.b, vs.h, vs.s, kBK);
  if (err != 0) return err;
  constexpr int smem = Layout<D>::kBytes;
  const cudaError_t cerr = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  const OutArgs out{static_cast<__nv_bfloat16*>(o), os.b, os.h, os.s, o32};
  flash_tc_kernel<D><<<grid, Loads<D>::kThreads, smem, stream>>>(
      tq, tk, tv, out, H, H / KV, S, Sk, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

extern "C" {

// o = attention(q, k, v) on `stream`; q, o are (B, H, S, D) and k, v
// (B, KV, Sk, D), all fp32 (bf16 = 0) or all bf16, each with its own
// element strides over (B, heads, rows) and a unit stride over D.  window
// <= 0 means no window; Sk != S is refused under causal or window.  o32,
// unless null, also gets o before its rounding to q's dtype, fp32 (B, H,
// S, D) dense.  Returns the cudaError_t of the launch (0 on success); does
// not synchronize or allocate.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int bf16, int B, int H, int KV, int S, int Sk, int D,
                    long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long o_sb, long long o_sh, long long o_ss,
                    float scale, int causal, int window, void* o32,
                    void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || Sk < 1 ||
      D < 1 || D > 256 || (S + kBQ - 1) / kBQ > 65535 ||
      (Sk != S && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(o32),
                                     B, H, KV, S, Sk, D, qs, ks, vs, os,
                                     scale, causal, window, st)
           : dispatch<float>(q, k, v, o, static_cast<float*>(o32), B, H, KV,
                             S, Sk, D, qs, ks, vs, os, scale, causal,
                             window, st);
  return static_cast<int>(err);
}

// The tensor-core instance: q, o are (B, H, S, D) and k, v (B, KV, Sk, D),
// all bf16, D = 64, 128 or 256, with element strides over (B, heads, rows) that are
// multiples of 8 (16 bytes, for the tensor maps; a dimension of size 1 may
// pass any such stride), a unit stride over D and 16-byte-aligned q, k, v.
// o32 as flash_attention's, 8-byte aligned.  Same return convention as
// flash_attention, with the tensor-map errors of
// flash_attention_error_string besides.
int flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int S, int Sk, int D,
                       long long q_sb, long long q_sh, long long q_ss,
                       long long k_sb, long long k_sh, long long k_ss,
                       long long v_sb, long long v_sh, long long v_ss,
                       long long o_sb, long long o_sh, long long o_ss,
                       float scale, int causal, int window, void* o32,
                       void* stream) {
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                v_sb, v_sh, v_ss};
  bool ok = B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 &&
            Sk >= 1 && (D == 64 || D == 128 || D == 256) &&
            (S + tc::kBQ - 1) / tc::kBQ <= 65535 &&
            (Sk == S || (!causal && window <= 0));
  for (long long st : strides) ok = ok && st > 0 && st % 8 == 0;
  const void* const bases[3] = {q, k, v};
  for (const void* p : bases)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  ok = ok && reinterpret_cast<uintptr_t>(o32) % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o32f = static_cast<float*>(o32);
  if (D == 64)
    return tc::launch<64>(q, k, v, o, o32f, B, H, KV, S, Sk, qs, ks, vs, os,
                          scale, causal, window, st);
  if (D == 128)
    return tc::launch<128>(q, k, v, o, o32f, B, H, KV, S, Sk, qs, ks, vs, os,
                           scale, causal, window, st);
  return tc::launch<256>(q, k, v, o, o32f, B, H, KV, S, Sk, qs, ks, vs, os,
                         scale, causal, window, st);
}

const char* flash_attention_error_string(int err) {
  return tc::error_string(err);
}

}  // extern "C"
