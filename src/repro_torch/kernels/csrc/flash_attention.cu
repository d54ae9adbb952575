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
//   o = acc / l, with l == 0 giving zeros, cast once to q's dtype.
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
// Two instances; the wrapper picks one by dtype and D alone:
//
// * flash_attention_tc (bf16, D = 64 or 128: every dense model the port
//   serves) runs both products on the tensor cores.  One block of three
//   warpgroups per (b*h, 128-query tile): warpgroups 0 and 1 each own 64
//   query rows; one thread of warpgroup 2 issues TMA loads of the q tile
//   and of a two-stage ring of (64-key K, V) tiles, guarded by mbarriers,
//   and gives its registers to the consumers (setmaxnreg).  The tiles land
//   in shared memory with TMA's 128-byte swizzle, which the wgmma
//   descriptors read back: q . k^T is one bf16 m64n64k16 wgmma per 16
//   columns of D with both operands K-major in shared memory (k rows are
//   keys contiguous in D: no transpose).  The probabilities stay in
//   registers as the A operand of the second product, against V in shared
//   memory as an MN-major B operand (m64n128k16 at D = 128: both 64-column
//   halves of V in one product).  The port's correctness check holds
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
// * flash_attention (fp32, and bf16 at other D) is the first kernel of the
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
#include <cuda.h>   // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

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
             int S, int Sk, int D, Strides qs, Strides ks, Strides vs,
             Strides os, float scale, int causal, int window) {
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
                   int B, int H, int KV, int S, int Sk, int D, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP>();
  // on every launch: the attribute is per device, and the call is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KV, S, Sk, D, qs,
      ks, vs, os, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int S, int Sk, int D, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale,
                     int causal, int window, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, H, KV, S, Sk, D, qs, ks, vs, os,
                         scale, causal, window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KV, S, Sk, D, qs, ks, vs, os,
                         scale, causal, window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, H, KV, S, Sk, D, qs, ks, vs, os,
                          scale, causal, window, stream);
  return launch<T, 256>(q, k, v, o, B, H, KV, S, Sk, D, qs, ks, vs, os,
                        scale, causal, window, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16, D in {64, 128}
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;         // query rows per block (two consumer warpgroups)
constexpr int kBK = 64;          // keys per tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kThreads = 384;    // warpgroups 0, 1 consume; warpgroup 2 loads
constexpr int kRowBytes = 128;   // one swizzled row: 64 bf16 columns of D
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes.  Every tile is stored as D / 64
// "halves" of 64 columns (one TMA box each), rows at 128 bytes, swizzled in
// 1024-byte atoms of 8 rows; every buffer starts on a 1024-byte boundary.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
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

// One TMA box of a 4-d map (D, S, heads, B) into shared memory; completion
// (in bytes) is reported to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int s0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0),
         "r"(s0), "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, fp32) = [d +] A (64 x 16) . B^T, A and B K-major bf16 in
// shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers) . B, B MN-major bf16
// in shared memory (the transpose bit of a 16-bit B operand).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// The same with N = 128: (a | b) (64 x 128, fp32; a the first 64 columns)
// += A (64 x 16, bf16 in registers) . B, B two MN-major 64-column blocks
// in shared memory, the descriptor's leading byte offset apart.
__device__ __forceinline__ void wgmma_rs128(float (&a)[32], float (&b)[32],
                                            const uint32_t (&x)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3]), "+f"(a[4]),
        "+f"(a[5]), "+f"(a[6]), "+f"(a[7]), "+f"(a[8]), "+f"(a[9]),
        "+f"(a[10]), "+f"(a[11]), "+f"(a[12]), "+f"(a[13]), "+f"(a[14]),
        "+f"(a[15]), "+f"(a[16]), "+f"(a[17]), "+f"(a[18]), "+f"(a[19]),
        "+f"(a[20]), "+f"(a[21]), "+f"(a[22]), "+f"(a[23]), "+f"(a[24]),
        "+f"(a[25]), "+f"(a[26]), "+f"(a[27]), "+f"(a[28]), "+f"(a[29]),
        "+f"(a[30]), "+f"(a[31]), "+f"(b[0]), "+f"(b[1]), "+f"(b[2]),
        "+f"(b[3]), "+f"(b[4]), "+f"(b[5]), "+f"(b[6]), "+f"(b[7]),
        "+f"(b[8]), "+f"(b[9]), "+f"(b[10]), "+f"(b[11]), "+f"(b[12]),
        "+f"(b[13]), "+f"(b[14]), "+f"(b[15]), "+f"(b[16]), "+f"(b[17]),
        "+f"(b[18]), "+f"(b[19]), "+f"(b[20]), "+f"(b[21]), "+f"(b[22]),
        "+f"(b[23]), "+f"(b[24]), "+f"(b[25]), "+f"(b[26]), "+f"(b[27]),
        "+f"(b[28]), "+f"(b[29]), "+f"(b[30]), "+f"(b[31])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, OutArgs out, int H,
                int group, int S, int Sk, float scale_log2, int causal,
                int window) {
  using L = Layout<D>;
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
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, 8);                  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The key tiles of the block: those its first to its last row can see.
  int blk_begin, blk_end;
  key_tiles(q0, min(q0 + kBQ, S) - 1, Sk, causal, window, blk_begin, blk_end);
  const int n_tiles = blk_end - blk_begin;

  if (wg == 2) {
    // ---- producer: one thread keeps the loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::kHalves * L::kQHalf);
#pragma unroll
      for (int hf = 0; hf < L::kHalves; ++hf)
        tma_load(sQ + hf * L::kQHalf, &tq, q_full, 64 * hf, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages)                               // stage released?
          mbar_wait(kv_empty + 8 * st, ((i / kStages) - 1) & 1);
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
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows qa .. qa + 63 ----
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
        // bytes apart (two 8-row swizzle atoms); each 64-column half of D is
        // its own product
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (D == 128) {
            // both halves of D in one 128-wide product: the second block
            // of 64 columns lies one half-tile (LBO) past the first
            const uint64_t dv = sw128_desc(vbase + kk * 16 * kRowBytes,
                                           L::kTileHalf, 1024);
            wgmma_rs128(acc[0], acc[1], p_hi[kk], dv);
            wgmma_rs128(acc[0], acc[1], p_mid[kk], dv);
            wgmma_rs128(acc[0], acc[1], p_lo[kk], dv);
          } else {
            const uint64_t dv =
                sw128_desc(vbase + kk * 16 * kRowBytes, 1024, 1024);
            wgmma_rs(acc[0], p_hi[kk], dv);
            wgmma_rs(acc[0], p_mid[kk], dv);
            wgmma_rs(acc[0], p_lo[kk], dv);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf) fence_regs(acc[hf]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * st);    // the stage is free
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
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's entry-point query, without
// linking libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Errors of this instance beyond cudaError_t: no entry point, or
// cuTensorMapEncodeTiled's CUresult plus kEncodeError.
constexpr int kNoEntryPoint = 99999;
constexpr int kEncodeError = 100000;

// A 4-d tensor map (D, S, heads, B) over a bf16 tensor with element
// strides (sb, sh, ss) and unit stride over D; boxes of 64 x rows.
int make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
             int B, long long sb, long long sh, long long ss, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEntryPoint;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, int Sk, Strides qs, Strides ks, Strides vs,
           Strides os, float scale, int causal, int window,
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
  const OutArgs out{static_cast<__nv_bfloat16*>(o), os.b, os.h, os.s};
  flash_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, out, H, H / KV, S, Sk, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

extern "C" {

// o = attention(q, k, v) on `stream`; q, o are (B, H, S, D) and k, v
// (B, KV, Sk, D), all fp32 (bf16 = 0) or all bf16, each with its own
// element strides over (B, heads, rows) and a unit stride over D.  window
// <= 0 means no window; Sk != S is refused under causal or window.  Returns
// the cudaError_t of the launch (0 on success); does not synchronize or
// allocate.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int bf16, int B, int H, int KV, int S, int Sk, int D,
                    long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long o_sb, long long o_sh, long long o_ss,
                    float scale, int causal, int window, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || Sk < 1 ||
      D < 1 || D > 256 || (S + kBQ - 1) / kBQ > 65535 ||
      (Sk != S && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, Sk, D, qs, ks,
                                     vs, os, scale, causal, window, st)
           : dispatch<float>(q, k, v, o, B, H, KV, S, Sk, D, qs, ks, vs, os,
                             scale, causal, window, st);
  return static_cast<int>(err);
}

// The tensor-core instance: q, o are (B, H, S, D) and k, v (B, KV, Sk, D),
// all bf16, D = 64 or 128, with element strides over (B, heads, rows) that are
// multiples of 8 (16 bytes, for the tensor maps; a dimension of size 1 may
// pass any such stride), a unit stride over D and 16-byte-aligned q, k, v.
// Same return convention as flash_attention, with the tensor-map errors
// of flash_attention_error_string besides.
int flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int S, int Sk, int D,
                       long long q_sb, long long q_sh, long long q_ss,
                       long long k_sb, long long k_sh, long long k_ss,
                       long long v_sb, long long v_sh, long long v_ss,
                       long long o_sb, long long o_sh, long long o_ss,
                       float scale, int causal, int window, void* stream) {
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                v_sb, v_sh, v_ss};
  bool ok = B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 &&
            Sk >= 1 && (D == 64 || D == 128) &&
            (S + tc::kBQ - 1) / tc::kBQ <= 65535 &&
            (Sk == S || (!causal && window <= 0));
  for (long long st : strides) ok = ok && st > 0 && st % 8 == 0;
  const void* const bases[3] = {q, k, v};
  for (const void* p : bases)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? tc::launch<64>(q, k, v, o, B, H, KV, S, Sk, qs, ks, vs, os,
                                  scale, causal, window, st)
                 : tc::launch<128>(q, k, v, o, B, H, KV, S, Sk, qs, ks, vs,
                                   os, scale, causal, window, st);
}

const char* flash_attention_error_string(int err) {
  static thread_local char msg[96];
  if (err == tc::kNoEntryPoint)
    return "cuTensorMapEncodeTiled is not available";
  if (err >= tc::kEncodeError) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - tc::kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
