// Building blocks of the port's Hopper (sm_90a) tensor-core kernels, shared
// by csrc/flash_attention.cu, csrc/flash_backward.cu, csrc/ssd_scan.cu and
// csrc/ssd_backward.cu: mbarriers, TMA loads through 4-d tensor maps,
// 16-byte cp.async copies into 128-byte-swizzled panels, the wgmma
// descriptors of such panels and the bf16 wgmma forms they use, the cut of
// fp32 operands into three bf16 terms, and the tensor-map encoder, fetched
// through cudaGetDriverEntryPoint (the libraries do not link libcuda).
// src/repro_torch/kernels/build.py hashes this header into the name of
// every library, so an edit here rebuilds them all.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace tc {

constexpr int kRowBytes = 128;   // one swizzled row: 64 bf16 columns of D
constexpr int kRow = kRowBytes;   // the same, as the SSD kernels name it
constexpr float kNegInf = -1e30f;  // masked logits, as the JAX kernel: never -inf
constexpr float kLog2e = 1.4426950408889634f;

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

// 16 bytes global -> shared without registers; bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// Makes this thread's shared-memory writes (stores and cp.async) visible
// to the tensor cores' reads (the async proxy); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__host__ __device__ constexpr int panels(int cols) { return (cols + 63) / 64; }

// Byte offset of (row r, column col) in a 128-byte-swizzled panel of 64
// bf16 columns: the 16-byte chunk of the row is XORed with r mod 8.
__device__ __forceinline__ int swz(int r, int col) {
  return r * kRow + ((((col & 63) >> 3) ^ (r & 7)) << 4) + ((col & 7) << 1);
}

// Rows [0, Q) and columns [0, 64 * npanels) of a bf16 matrix (row stride
// ld elements, unit column stride) into npanels swizzled panels of Q rows
// at dst; rows >= rows_ok and columns >= cols_ok are zero-filled.
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int Q, int npanels,
                                          int rows_ok, int cols_ok, int tid,
                                          int nthreads) {
  const int per_panel = Q * 8;
  for (int idx = tid; idx < npanels * per_panel; idx += nthreads) {
    const int panel = idx / per_panel, rem = idx % per_panel;
    const int r = rem / 8, ch = rem % 8;
    const int col = 64 * panel + 8 * ch;
    const bool ok = r < rows_ok && col < cols_ok;
    cp_async16(dst + panel * Q * kRow + r * kRow + ((ch ^ (r & 7)) << 4),
               ok ? src + r * ld + col : src, ok ? 16 : 0);
  }
}

// K-major operand: rows of the M (or N) dimension, K across the panel.
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}
// MN-major operand: rows of the K dimension, 64 columns of N per panel.
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return sw128_desc(addr, 1024, 1024);
}

#define SSD_ACC32                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define SSD_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, fp32) += A (64 x 16) . B; A K-major in shared memory, B
// K-major (tnsp_b = 0) or MN-major (tnsp_b = 1) in shared memory.
template <int kTnspB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %35, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", %32, %33, p, 1, 1, 0, %34;\n\t}"
      : SSD_ACC32
      : "l"(da), "l"(db), "n"(kTnspB), "n"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 t) {
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Two fp32 values as three bf16x2 terms, hi + mid + lo, each the rounding
// of what the earlier ones leave (the subtractions are exact).
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  __nv_bfloat162 t = __floats2bfloat162_rn(v0, v1);
  hi = bits(t);
  v0 -= __low2float(t);
  v1 -= __high2float(t);
  t = __floats2bfloat162_rn(v0, v1);
  mid = bits(t);
  v0 -= __low2float(t);
  v1 -= __high2float(t);
  lo = bits(__floats2bfloat162_rn(v0, v1));
}

__device__ __forceinline__ float bf_at(const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

// The thread's warpgroup, broadcast from lane 0 so that the compiler knows
// it is the same across the warp: a branch on threadIdx.x / 128 itself
// counts as divergent, and a wgmma under a divergent branch makes ptxas
// serialize every wgmma of the kernel (C7520).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cuTensorMapEncodeTiled through the runtime's entry-point query, without
// linking libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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
inline int make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
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

// The message of an error code of the tensor-core launches: a cudaError_t,
// or one of the tensor-map errors above.
inline const char* error_string(int err) {
  static thread_local char msg[96];
  if (err == kNoEntryPoint) return "cuTensorMapEncodeTiled is not available";
  if (err >= kEncodeError) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace tc
