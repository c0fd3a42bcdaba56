// Hopper building blocks shared by the port's warp-specialised attention
// kernels (ttt_attention.cu, dflash_attention.cu, peagle_attention.cu,
// lse_attention.cu).
//
// Replaces no TPU kernel by itself: it holds what the kernels that replace
// the Pallas attention kernels share on this card. Those kernels are bound
// by the tensor cores' bf16 rate (989 TFLOP/s dense on an H100), which only
// `wgmma` reaches; so every tile product here is a warpgroup product with
// B (and A, where it is not in registers) read from shared memory through
// a 128-byte-swizzle descriptor, and every 64-row tile arrives by TMA
// (`cp.async.bulk.tensor` over a tensor map of the strided view, completing
// on an `mbarrier`), issued by a producer warp that gives up its registers
// (`setmaxnreg`) to the consumer warpgroups.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as in the TPU kernel
constexpr float kDeadRowM2 = 1e30f;  // m2 of a row with no allowed key
constexpr int kTileRows = 64;  // rows of every staged tile (wgmma's M)
constexpr int kPanelBytes = kTileRows * 128;  // 64 rows x 64 bf16 columns
constexpr int kHopperThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerRegs = 240;  // setmaxnreg: 2 x 128 x 240 + 128 x 24
constexpr int kProducerRegs = 24;   //   = 64,512 of the SM's 65,536
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// max and sum over the quad of lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// --------------------------------------------------------------------------
// Hopper primitives
// --------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// expect `bytes` more from the asynchronous copies of the phase, without
// arriving (the copies are issued first, then the lanes fill in the rest of
// the stage and arrive)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one 64 x 64 bf16 box of a 4-D tensor map (d, s, head, b) into a
// 128-byte-swizzled panel; completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(d),
         "r"(s), "r"(h), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// named barrier of the two consumer warpgroups (id 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// named barrier of one consumer warpgroup (ids 2 and 3)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across an
// asynchronous wgmma that uses these registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset, stride byte offset 1024 (eight 128-byte rows)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// k16 step `kk` over the rows of a 64-row tile read as an MN-major B operand
// (N = the head dim, contiguous; the next 64 columns one panel further)
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, kPanelBytes);
}

// byte offset of 16-byte chunk `j` (columns 8j..8j+7) of `row` in a
// 64-row tile of 128-byte-swizzled panels, as the tensor map writes it
__device__ __forceinline__ int swz(int row, int j) {
  return (j >> 3) * kPanelBytes + row * 128 + (((j & 7) ^ (row & 7)) << 4);
}


// the first 1024-byte boundary at or after p, a pointer into the dynamic
// shared memory (kept as pointer arithmetic, so the compiler still knows
// the address space and emits shared, not generic, loads and stores)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The flags list[i] (i < n: 0, or 1 plus twice a tile bit of the
// policy's) compacted in place into entries 2 i + bit of the ascending
// indices whose flag is set, by warp 0; their number into *count. Every
// thread of the block calls it, after writing the flags.
__device__ __forceinline__ void compact_list(int* list, int n, int* count) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int c = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const int f = i < n ? list[i] : 0;
      const unsigned mask = __ballot_sync(0xffffffffu, f != 0);
      __syncwarp();
      if (f != 0) {
        list[c + __popc(mask & ((1u << lane) - 1u))] = 2 * i + (f >> 1);
      }
      c += __popc(mask);
      __syncwarp();
    }
    if (lane == 0) *count = c;
  }
  __syncthreads();
}

// 2^x (flushing denormals; 2^-inf = 0): one MUFU instruction. The kernels
// keep m in log2 units, m * log2(e), so p = 2^(s * scale * log2(e) - m2)
// (/ l in the backward), the masked entries as 2^-inf: no branch around
// the exp.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float masked_logit2(bool ok, float s, float scale2,
                                               float m2) {
  return ok ? fmaf(s, scale2, -m2) : __int_as_float(0xff800000);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory,
// both K-major (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A from registers (per warp the
// A fragment layout of mma.m16n8k16), B from shared memory MN-major (its N
// index contiguous; 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A from registers (per warp the
// A fragment layout of mma.m16n8k16), B from shared memory MN-major (its N
// index contiguous; 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// accumulator [64 x D] += A (registers) x B (MN-major, N = D)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint32_t tile,
                                         int kk) {
  // opaque to the compiler: the descriptor is built here, not hoisted out
  // of the caller's loop into registers
  asm volatile("" : "+r"(tile));
  const uint64_t db = mnmajor_desc(tile, kk);
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db, 1);
  } else {
    wgmma_rs_n64(d, a, db, 1);
  }
}

// [64 x 64] = A [64 x D] B^T, both K-major 64-row tiles in shared memory.
// Unrolled (a rolled loop makes ptxas serialize the wgmmas), with each
// step's descriptors pinned between its neighbours: left free, the compiler
// builds all 2 * D / 16 of them up front, and they spill.
template <int D>
__device__ __forceinline__ void wgmma_tile_product(float (&d)[32], uint32_t a,
                                                   uint32_t b) {
  const uint64_t da = sw128_desc(a, 16);
  const uint64_t db = sw128_desc(b, 16);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    // the start address field (bits 0-13, in 16-byte units) moves 32 bytes
    // a step inside a panel and one panel every four
    const uint64_t off = ((ks >> 2) * kPanelBytes + (ks & 3) * 32) >> 4;
    uint64_t xa = da + off;
    uint64_t xb = db + off;
    asm volatile("" : "+l"(xa), "+l"(xb));
    wgmma_ss_n64(d, xa, xb, ks > 0);
  }
}

// This thread's rows (row0 and row0 + 8) of a [64 x D] fp32 accumulator
// (C layout) times mul0 / mul1, as bf16 into a 64-row tile of shared
// memory, swizzled as the tensor maps write (copy_tile_rows reads it back).
template <int D>
__device__ __forceinline__ void stage_tile(unsigned char* tile,
                                           const float (&acc)[D / 2],
                                           float mul0, float mul1, int row0,
                                           int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + swz(row0, j) + 4 * t) =
        pack_bf16(acc[4 * j] * mul0, acc[4 * j + 1] * mul0);
    *reinterpret_cast<uint32_t*>(tile + swz(row0 + 8, j) + 4 * t) =
        pack_bf16(acc[4 * j + 2] * mul1, acc[4 * j + 3] * mul1);
  }
}

// Copy the rows < S of a [64 x D] bf16 tile in shared memory (swizzled as
// the tensor maps write it) to out (rows `ld` elements apart, D contiguous),
// 16 bytes a lane, whole rows a warp.
template <int D>
__device__ __forceinline__ void copy_tile_rows(__nv_bfloat16* out,
                                               long long ld,
                                               const unsigned char* tile,
                                               int S, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kRowsPerPass = 32 / kChunks;
  const int lane = tid % 32;
  const int jc = lane % kChunks;
#pragma unroll 4
  for (int i = 0; i < 16 / kRowsPerPass; ++i) {
    const int row = (tid / 32) * 16 + i * kRowsPerPass + lane / kChunks;
    if (row < S) {
      *reinterpret_cast<uint4*>(out + row * ld + jc * 8) =
          *reinterpret_cast<const uint4*>(tile + swz(row, jc));
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A [B, heads, S, D] bf16 view with element strides (b, h, s), the head dim
// contiguous, as a 4-D map (d, s, head, b) read in 64 x 64 boxes, 128-byte
// swizzled; rows past S read as zeros. TMA needs a 16-byte aligned base and
// strides of multiples of 16 bytes: the wrapper checks both.
bool encode_bhsd(CUtensorMap* map, const void* base, int B, int heads, int S,
                 int D, long long sb, long long sh, long long ss) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, kTileRows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch a warp-specialised kernel of `blocks` blocks of kHopperThreads
// with `smem` bytes of dynamic shared memory → cudaGetLastError().
template <typename Kernel, typename P>
int launch_hopper(Kernel kernel, int smem, const P& p, long long blocks,
                  cudaStream_t st) {
  if (blocks < 1 || blocks > 0x7fffffffLL || smem > 227 * 1024) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kHopperThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
