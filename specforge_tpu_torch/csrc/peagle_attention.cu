// P-EAGLE chain-of-drafts (COD) attention, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of specforge_tpu/ops/peagle_pallas.py
// reached through `cod_flash_attention`: `_fwd_kernel` (forward, through
// `_fwd_pallas`), and the two kernels of `_bwd_pallas`: `_bwd_dq_kernel` (dq)
// and `_bwd_dkv_kernel` (dk, dv).
//
// What it computes. Every sampled token carries four properties, packed as
// one int4 (anchor a, depth d, doc c of its anchor with -1 for padding, valid
// v). Query q may attend key k iff
//   c_q != -1 && c_q == c_k && v_q && v_k &&
//   ((d_k == 0 && a_q >= a_k) || (a_q == a_k && d_q >= d_k)):
// the depth-0 trunk causally, and the query's own rollout depth-ordered. The
// predicate is evaluated in registers from the properties of the tile's rows
// and keys; no [T, T] mask reaches the kernels. A row with no allowed key
// (an invalid slot, padding) comes out exactly 0, with m = -1e30 and l = 0,
// and its gradients are 0. The output goes straight to the [B, T, H*D] layout
// the o_proj reads; the row statistics m and l are saved in fp32 for the
// backward, which recomputes p = exp(s - m) / l, takes delta = rowsum(dO * O)
// as given and forms ds = p * (dO V^T - delta):
//   dq = scale * ds K,  dk = scale * ds^T Q,  dv = p^T dO.
//
// What bounds it on this card. At the P-EAGLE slice (B=2, H=32, KVH=8,
// D=128, S=1024 over 8 depths, so T=3456) a query attends to about 500 keys
// on average: P, the allowed (query, key) pairs over all heads, is about
// 1.1e8, so the forward's two products are about 58 GFLOP (59 us at the bf16
// tensor-core peak) against about 145 MB moved (43 us at 3.35 TB/s): bound
// by operations, as are the backward kernels (3 and 4 products).
// chip_smoke.py recomputes both terms from each run's sample.
//
// What the design does about that. Every product runs on the tensor cores
// through `mma.sync.m16n8k16` (bf16 in, fp32 accumulate); no score tile
// reaches device memory. Whole 64 x 64 tiles with no allowed pair are
// skipped: the caller hands a [B, NT, NT] table (1 where a tile pair holds
// an allowed pair), built once per forward from the model's mask and shared
// by every layer and head; each block lists its live tiles from it first.
// The doc-major order of the sample makes the live tiles few and dense
// (about a third of the grid at the slice, block-diagonal when documents are
// packed). Forward and dq: one block of 4 warps owns a q tile of 64 rows of
// one (batch, head); each warp keeps the Q (and dO) fragments of its 16 rows
// and the properties of its thread's two rows in registers; the live K/V
// tiles and their keys' properties are staged by cp.async in two buffers of
// padded shared memory and reach the tensor cores through ldmatrix. dk/dv:
// one block owns 64 keys of one (batch, kv head), K and V in shared memory,
// dk and dv in fp32 registers, and walks the group's H / KVH query heads over
// the q tiles live for these keys, with Q, dO, the row statistics and the
// rows' properties staged in two buffers. The GQA kv head is read as
// h / (H / KVH), never repeated in memory; there are no atomics, so two runs
// give the same bits. T need not be a multiple of 64: rows and keys past T
// are zero-filled and carry no valid property.
// Not yet used: TMA, wgmma and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per q tile, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // finite, as in the TPU kernel

struct Params {
  const __nv_bfloat16* q;  // [B, H, T, D] strided
  const __nv_bfloat16* k;  // [B, KVH, T, D] strided
  const __nv_bfloat16* v;
  const int4* props;       // [B, T]: (anchor, depth, doc, valid)
  const int* tiles;        // [B, NT, NT]: 1 where a tile pair may attend
  __nv_bfloat16* out;      // [B, T, H*D]
  float* m;                // [B, H, T]
  float* l;                // [B, H, T]
  const __nv_bfloat16* dout;  // [B, T, H*D], contiguous
  const float* delta;         // [B, H, T]
  __nv_bfloat16* dq;          // [B, H, T, D], contiguous
  __nv_bfloat16* dk;          // [B, KVH, T, D], contiguous
  __nv_bfloat16* dv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int B, H, KVH, T, NT;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] * B[16x8], bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. With .trans each matrix arrives transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The COD predicate: x = anchor, y = depth, z = doc of the anchor (-1 for
// padding), w = valid
__device__ __forceinline__ bool cod_allow(const int4 q, const int4 k) {
  return q.z != -1 && q.z == k.z && q.w != 0 && k.w != 0 &&
         ((k.y == 0 && q.x >= k.x) || (q.x == k.x && q.y >= k.y));
}

// The properties of token i of batch b; a slot past T is invalid
__device__ __forceinline__ int4 load_prop(const Params& p, int b, int i) {
  return i < p.T ? p.props[(long long)b * p.T + i] : make_int4(0, 0, -1, 0);
}

// The indices i < n whose flag flags[i * stride] is not 0, ascending, into
// list; returns their number. Every thread of the block calls it.
__device__ __forceinline__ int live_list(const int* flags, long long stride,
                                         int n, int* list, int* sCount) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    list[i] = flags[i * stride] != 0 ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool f = i < n && list[i] != 0;
      const unsigned mask = __ballot_sync(0xffffffffu, f);
      __syncwarp();
      if (f) list[count + __popc(mask & ((1u << lane) - 1u))] = i;
      count += __popc(mask);
      __syncwarp();
    }
    if (lane == 0) *sCount = count;
  }
  __syncthreads();
  return *sCount;
}

// A-operand fragments of a 16-row slab (rows row0 and row0 + 8 of this
// thread) straight from device memory; rows not `in` read as zeros
template <int kSteps>
__device__ __forceinline__ void load_a_frags(uint32_t f[kSteps][4],
                                             const __nv_bfloat16* base,
                                             long long row_stride, int row0,
                                             bool in0, bool in1, int t) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int c = ks * 16 + 2 * t;
    f[ks][0] = in0 ? ld32(base + row0 * row_stride + c) : 0u;
    f[ks][1] = in1 ? ld32(base + (row0 + 8) * row_stride + c) : 0u;
    f[ks][2] = in0 ? ld32(base + row0 * row_stride + c + 8) : 0u;
    f[ks][3] = in1 ? ld32(base + (row0 + 8) * row_stride + c + 8) : 0u;
  }
}

// Stage K/V tile `ktile` of (b, kvh) and its keys' properties; keys past T
// are zero-filled (valid 0)
template <int D>
__device__ __forceinline__ void load_kv_tile(const Params& p, int b, int kvh,
                                             int ktile, __nv_bfloat16* sK,
                                             __nv_bfloat16* sV, int4* sKP) {
  constexpr int kStride = D + 8;
  constexpr int kVecPerRow = D / 8;
  const int key0 = ktile * kBlockN;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    const int key = key0 + r;
    const long long src = key < p.T ? key : 0;
    cp_async16(sK + r * kStride + c, kb + src * p.k_ss + c, key < p.T);
    cp_async16(sV + r * kStride + c, vb + src * p.v_ss + c, key < p.T);
  }
  if (threadIdx.x < kBlockN) {
    const int key = key0 + threadIdx.x;
    const long long src = (long long)b * p.T + (key < p.T ? key : 0);
    cp_async16(sKP + threadIdx.x, p.props + src, key < p.T);
  }
  cp_async_commit();
}

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs 0..3: (row g, cols 2t..2t+1), (row g+8, 2t..), (row g, 2t+8..),
//                (row g+8, 2t+8..)
//   B regs 0..1: (k rows 2t..2t+1, col g), (k rows 2t+8..2t+9, col g)
//   C regs 0..3: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
template <int D>
__global__ void __launch_bounds__(kThreads) cod_fwd_kernel(const Params p) {
  constexpr int kStride = D + 8;  // padded row: conflict-free ldmatrix
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBlockN / 8;
  constexpr int kTile = kBlockN * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sKs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sVs = sKs + 2 * kTile;
  int4* sKPs = reinterpret_cast<int4*>(sVs + 2 * kTile);  // two stages
  int* sList = reinterpret_cast<int*>(sKPs + 2 * kBlockN);  // live k tiles
  __shared__ int sCount;

  const int qtile = blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qtile * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool in0 = row0 < p.T;
  const bool in1 = row1 < p.T;
  const int4 qp0 = load_prop(p, b, row0);
  const int4 qp1 = load_prop(p, b, row1);

  const int n_live = live_list(
      p.tiles + ((long long)b * p.NT + qtile) * p.NT, 1, p.NT, sList, &sCount);

  uint32_t qf[kSteps][4];
  load_a_frags<kSteps>(qf, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, row0, in0,
                       in1, t);

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;  // per-thread partial sums until the quad reduce

  if (n_live > 0) load_kv_tile<D>(p, b, kvh, sList[0], sKs, sVs, sKPs);
  for (int j = 0; j < n_live; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_live) {
      load_kv_tile<D>(p, b, kvh, sList[j + 1], sKs + (buf ^ 1) * kTile,
                      sVs + (buf ^ 1) * kTile, sKPs + (buf ^ 1) * kBlockN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sK = sKs + buf * kTile;
    const __nv_bfloat16* sV = sVs + buf * kTile;
    const int4* sKP = sKPs + buf * kBlockN;

    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kp = sK + (nt * 8 + (lane & 7)) * kStride +
                                (lane >> 3) * 8;
#pragma unroll
      for (int ks = 0; ks < kSteps; ks += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kp + ks * 16);
        mma_bf16(s[nt], qf[ks], kf[0], kf[1]);
        mma_bf16(s[nt], qf[ks + 1], kf[2], kf[3]);
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int4 kp = sKP[nt * 8 + 2 * t + e];
        s[nt][e] = cod_allow(qp0, kp) ? s[nt][e] * p.scale : kNegInf;
        s[nt][2 + e] = cod_allow(qp1, kp) ? s[nt][2 + e] * p.scale : kNegInf;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = __expf(m0 - mx0);
    const float c1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= c0;
      o[dt][1] *= c0;
      o[dt][2] *= c1;
      o[dt][3] *= c1;
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = s[nt][e] == kNegInf ? 0.f : __expf(s[nt][e] - m0);
        const float p1 =
            s[nt][2 + e] == kNegInf ? 0.f : __expf(s[nt][2 + e] - m1);
        s[nt][e] = p0;
        s[nt][2 + e] = p1;
        l0 += p0;
        l1 += p1;
      }
    }

    // O += P V: P from the score registers (C layout -> A layout), V from
    // shared memory as B through a transposing ldmatrix
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp =
          sV + (kk * 16 + (lane & 8) + (lane & 7)) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vp + dt * 8);
        mma_bf16(o[dt], a, vf[0], vf[1]);
        mma_bf16(o[dt + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const long long HD = (long long)p.H * D;
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (in0) {
    __nv_bfloat16* op = p.out + ((long long)b * p.T + row0) * HD + h * D;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    }
  }
  if (in1) {
    __nv_bfloat16* op = p.out + ((long long)b * p.T + row1) * HD + h * D;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
  if (t == 0) {
    const long long base = ((long long)b * p.H + h) * p.T;
    if (in0) {
      p.m[base + row0] = m0;
      p.l[base + row0] = l0;
    }
    if (in1) {
      p.m[base + row1] = m1;
      p.l[base + row1] = l1;
    }
  }
}

// --------------------------------------------------------------------------
// backward: dq
// --------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) cod_bwd_dq_kernel(const Params p) {
  constexpr int kStride = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kTile = kBlockN * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sKs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sVs = sKs + 2 * kTile;
  int4* sKPs = reinterpret_cast<int4*>(sVs + 2 * kTile);
  int* sList = reinterpret_cast<int*>(sKPs + 2 * kBlockN);
  __shared__ int sCount;

  const int H = p.H;
  const int qtile = blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / p.KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qtile * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool in0 = row0 < p.T;
  const bool in1 = row1 < p.T;
  const long long HD = (long long)H * D;
  const int4 qp0 = load_prop(p, b, row0);
  const int4 qp1 = load_prop(p, b, row1);

  const int n_live = live_list(
      p.tiles + ((long long)b * p.NT + qtile) * p.NT, 1, p.NT, sList, &sCount);

  uint32_t qf[kSteps][4], df[kSteps][4];
  load_a_frags<kSteps>(qf, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, row0, in0,
                       in1, t);
  load_a_frags<kSteps>(df, p.dout + (long long)b * p.T * HD + h * D, HD, row0,
                       in0, in1, t);
  const long long sbase = ((long long)b * H + h) * p.T;
  // rows past T get p = 0 (no allowed key, inverse l of 0)
  const float m0 = in0 ? p.m[sbase + row0] : 0.f;
  const float m1 = in1 ? p.m[sbase + row1] : 0.f;
  const float il0 = in0 ? 1.f / fmaxf(p.l[sbase + row0], 1e-30f) : 0.f;
  const float il1 = in1 ? 1.f / fmaxf(p.l[sbase + row1], 1e-30f) : 0.f;
  const float dl0 = in0 ? p.delta[sbase + row0] : 0.f;
  const float dl1 = in1 ? p.delta[sbase + row1] : 0.f;

  float dq[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
  }

  if (n_live > 0) load_kv_tile<D>(p, b, kvh, sList[0], sKs, sVs, sKPs);
  for (int j = 0; j < n_live; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_live) {
      load_kv_tile<D>(p, b, kvh, sList[j + 1], sKs + (buf ^ 1) * kTile,
                      sVs + (buf ^ 1) * kTile, sKPs + (buf ^ 1) * kBlockN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sK = sKs + buf * kTile;
    const __nv_bfloat16* sV = sVs + buf * kTile;
    const int4* sKP = sKPs + buf * kBlockN;

#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      // s = Q K^T and dp = dO V^T for 16 rows x 16 keys
      float s[2][4], dp[2][4];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        s[e2][0] = s[e2][1] = s[e2][2] = s[e2][3] = 0.f;
        dp[e2][0] = dp[e2][1] = dp[e2][2] = dp[e2][3] = 0.f;
        const int nt = 2 * kk + e2;
        const int off = (nt * 8 + (lane & 7)) * kStride + (lane >> 3) * 8;
#pragma unroll
        for (int ks = 0; ks < kSteps; ks += 2) {
          uint32_t f[4];
          ldmatrix_x4(f, sK + off + ks * 16);
          mma_bf16(s[e2], qf[ks], f[0], f[1]);
          mma_bf16(s[e2], qf[ks + 1], f[2], f[3]);
          ldmatrix_x4(f, sV + off + ks * 16);
          mma_bf16(dp[e2], df[ks], f[0], f[1]);
          mma_bf16(dp[e2], df[ks + 1], f[2], f[3]);
        }
      }
      // p recomputed under the predicate, ds = p * (dp - delta)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int4 kp = sKP[(2 * kk + e2) * 8 + 2 * t + e];
          const float p0 = cod_allow(qp0, kp)
                               ? __expf(s[e2][e] * p.scale - m0) * il0
                               : 0.f;
          const float p1 = cod_allow(qp1, kp)
                               ? __expf(s[e2][2 + e] * p.scale - m1) * il1
                               : 0.f;
          s[e2][e] = p0 * (dp[e2][e] - dl0);
          s[e2][2 + e] = p1 * (dp[e2][2 + e] - dl1);
        }
      }
      // dq += ds K: ds from registers (C -> A layout), K as B (k = key,
      // n = head dim) through a transposing ldmatrix
      uint32_t a[4];
      a[0] = pack_bf16(s[0][0], s[0][1]);
      a[1] = pack_bf16(s[0][2], s[0][3]);
      a[2] = pack_bf16(s[1][0], s[1][1]);
      a[3] = pack_bf16(s[1][2], s[1][3]);
      const __nv_bfloat16* kp =
          sK + (kk * 16 + (lane & 8) + (lane & 7)) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, kp + dt * 8);
        mma_bf16(dq[dt], a, f[0], f[1]);
        mma_bf16(dq[dt + 1], a, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  __nv_bfloat16* dqp = p.dq + sbase * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (in0) {
      *reinterpret_cast<uint32_t*>(dqp + row0 * D + c) =
          pack_bf16(dq[dt][0] * p.scale, dq[dt][1] * p.scale);
    }
    if (in1) {
      *reinterpret_cast<uint32_t*>(dqp + row1 * D + c) =
          pack_bf16(dq[dt][2] * p.scale, dq[dt][3] * p.scale);
    }
  }
}

// --------------------------------------------------------------------------
// backward: dk, dv
// --------------------------------------------------------------------------

// One block owns 64 keys of one (batch, kv head), 16 per warp, and walks
// (query head of the group, live q tile) pairs, so the group's heads are
// summed in registers.
template <int D>
__global__ void __launch_bounds__(kThreads) cod_bwd_dkv_kernel(const Params p) {
  constexpr int kStride = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kVecPerRow = D / 8;
  constexpr int kTile = kBlockN * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sQs = sV + kTile;        // two stages
  __nv_bfloat16* sDOs = sQs + 2 * kTile;  // two stages
  int* sList = reinterpret_cast<int*>(sDOs + 2 * kTile);  // live q tiles
  __shared__ float sM[2][kBlockM], sIL[2][kBlockM], sDl[2][kBlockM];
  __shared__ int4 sQP[2][kBlockM];
  __shared__ int sCount;

  const int H = p.H;
  const int G = H / p.KVH;
  const int ktile = blockIdx.x;
  const int b = blockIdx.y / p.KVH;
  const int kvh = blockIdx.y % p.KVH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = ktile * kBlockN;
  const int kr0 = key0 + warp * 16 + g;  // this thread's two keys
  const int kr1 = kr0 + 8;
  const int4 kp0 = load_prop(p, b, kr0);
  const int4 kp1 = load_prop(p, b, kr1);
  const long long HD = (long long)H * D;

  // K and V of this block's keys, once
  {
    const __nv_bfloat16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
    const __nv_bfloat16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;
    for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int key = key0 + r;
      const long long src = key < p.T ? key : 0;
      cp_async16(sK + r * kStride + c, kbase + src * p.k_ss + c, key < p.T);
      cp_async16(sV + r * kStride + c, vbase + src * p.v_ss + c, key < p.T);
    }
    cp_async_commit();
  }

  // the q tiles with an allowed pair in this k tile: column `ktile` of the
  // batch's table
  const int n_useful = live_list(p.tiles + (long long)b * p.NT * p.NT + ktile,
                                 p.NT, p.NT, sList, &sCount);
  const int n_iters = G * n_useful;

  // iteration it covers query head kvh * G + it / n_useful of q tile
  // sList[it % n_useful]
  auto load_q = [&](int it, int buf) {
    const int h = kvh * G + it / n_useful;
    const int q0 = sList[it % n_useful] * kBlockM;
    const __nv_bfloat16* qbase = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dbase = p.dout + (long long)b * p.T * HD + h * D;
    __nv_bfloat16* sQ = sQs + buf * kTile;
    __nv_bfloat16* sDO = sDOs + buf * kTile;
    for (int i = threadIdx.x; i < kBlockM * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int row = q0 + r;
      const long long src = row < p.T ? row : 0;
      cp_async16(sQ + r * kStride + c, qbase + src * p.q_ss + c, row < p.T);
      cp_async16(sDO + r * kStride + c, dbase + src * HD + c, row < p.T);
    }
    const long long sbase = ((long long)b * H + h) * p.T;
    for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
      const int row = q0 + i;
      const bool in = row < p.T;
      sM[buf][i] = in ? p.m[sbase + row] : 0.f;
      sIL[buf][i] = in ? 1.f / fmaxf(p.l[sbase + row], 1e-30f) : 0.f;
      sDl[buf][i] = in ? p.delta[sbase + row] : 0.f;
      sQP[buf][i] = load_prop(p, b, row);
    }
    cp_async_commit();
  };

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  // A-operand (rows = this warp's 16 keys) addresses of K and V
  const int a_off = (warp * 16 + (lane & 15)) * kStride + (lane >> 4) * 8;
  if (n_iters > 0) load_q(0, 0);
  for (int it = 0; it < n_iters; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iters) {
      load_q(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sQ = sQs + buf * kTile;
    const __nv_bfloat16* sDO = sDOs + buf * kTile;

#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      // s^T = K Q^T and dp^T = V dO^T for 16 keys x 16 queries
      float s[2][4], dp[2][4];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        s[e2][0] = s[e2][1] = s[e2][2] = s[e2][3] = 0.f;
        dp[e2][0] = dp[e2][1] = dp[e2][2] = dp[e2][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kSteps; ks += 2) {
        uint32_t ka0[4], ka1[4], va0[4], va1[4];
        ldmatrix_x4(ka0, sK + a_off + ks * 16);
        ldmatrix_x4(ka1, sK + a_off + (ks + 1) * 16);
        ldmatrix_x4(va0, sV + a_off + ks * 16);
        ldmatrix_x4(va1, sV + a_off + (ks + 1) * 16);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int off = ((2 * kk + e2) * 8 + (lane & 7)) * kStride +
                          (lane >> 3) * 8 + ks * 16;
          uint32_t f[4];
          ldmatrix_x4(f, sQ + off);
          mma_bf16(s[e2], ka0, f[0], f[1]);
          mma_bf16(s[e2], ka1, f[2], f[3]);
          ldmatrix_x4(f, sDO + off);
          mma_bf16(dp[e2], va0, f[0], f[1]);
          mma_bf16(dp[e2], va1, f[2], f[3]);
        }
      }
      // p^T under the predicate, ds^T = p^T * (dp^T - delta)
      float pt[2][4];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = kk * 16 + e2 * 8 + 2 * t + (i & 1);
          const bool ok = cod_allow(sQP[buf][qi], i < 2 ? kp0 : kp1);
          const float pv =
              ok ? __expf(s[e2][i] * p.scale - sM[buf][qi]) * sIL[buf][qi]
                 : 0.f;
          pt[e2][i] = pv;
          s[e2][i] = pv * (dp[e2][i] - sDl[buf][qi]);
        }
      }
      // dv += p^T dO and dk += ds^T Q: A from registers (C -> A layout), dO
      // and Q as B (k = query, n = head dim) through transposing ldmatrix
      uint32_t ap[4], as[4];
      ap[0] = pack_bf16(pt[0][0], pt[0][1]);
      ap[1] = pack_bf16(pt[0][2], pt[0][3]);
      ap[2] = pack_bf16(pt[1][0], pt[1][1]);
      ap[3] = pack_bf16(pt[1][2], pt[1][3]);
      as[0] = pack_bf16(s[0][0], s[0][1]);
      as[1] = pack_bf16(s[0][2], s[0][3]);
      as[2] = pack_bf16(s[1][0], s[1][1]);
      as[3] = pack_bf16(s[1][2], s[1][3]);
      const int toff =
          (kk * 16 + (lane & 8) + (lane & 7)) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, sDO + toff + dt * 8);
        mma_bf16(dv[dt], ap, f[0], f[1]);
        mma_bf16(dv[dt + 1], ap, f[2], f[3]);
        ldmatrix_x4_trans(f, sQ + toff + dt * 8);
        mma_bf16(dk[dt], as, f[0], f[1]);
        mma_bf16(dk[dt + 1], as, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }
  cp_async_wait<0>();  // the K/V copy, when no q tile reached these keys

  const long long obase = ((long long)b * p.KVH + kvh) * p.T * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (kr0 < p.T) {
      *reinterpret_cast<uint32_t*>(p.dk + obase + kr0 * D + c) =
          pack_bf16(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + obase + kr0 * D + c) =
          pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (kr1 < p.T) {
      *reinterpret_cast<uint32_t*>(p.dk + obase + kr1 * D + c) =
          pack_bf16(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + obase + kr1 * D + c) =
          pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, int smem, const Params& p,
                  cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K, V and key properties in two stages, then the live-tile list
int smem_q_side(int D, int nt) {
  return 4 * kBlockN * (D + 8) * 2 + 2 * kBlockN * 16 + nt * 4;
}
int smem_dkv(int D, int nt) { return 6 * kBlockN * (D + 8) * 2 + nt * 4; }

// tensors: q, k, v; strides: their element strides over (b, head, row), 9
// values in that order; the head dim is contiguous
int fill_params(Params& p, const void* const* tensors,
                const long long* strides, const void* props, const int* tiles,
                int B, int H, int KVH, int T, int D) {
  if (B < 1 || KVH < 1 || H % KVH != 0 || (long long)B * H > 65535 ||
      T < 1 || (D != 64 && D != 128)) {
    return cudaErrorInvalidValue;
  }
  p.q = static_cast<const __nv_bfloat16*>(tensors[0]);
  p.k = static_cast<const __nv_bfloat16*>(tensors[1]);
  p.v = static_cast<const __nv_bfloat16*>(tensors[2]);
  p.props = static_cast<const int4*>(props);
  p.tiles = tiles;
  p.out = p.dq = p.dk = p.dv = nullptr;
  p.m = p.l = nullptr;
  p.dout = nullptr;
  p.delta = nullptr;
  long long* dst[9] = {&p.q_sb, &p.q_sh, &p.q_ss, &p.k_sb, &p.k_sh,
                       &p.k_ss, &p.v_sb, &p.v_sh, &p.v_ss};
  for (int i = 0; i < 9; ++i) *dst[i] = strides[i];
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.T = T;
  p.NT = (T + kBlockN - 1) / kBlockN;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  if (smem_dkv(D, p.NT) > 227 * 1024) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// Forward: out [B, T, H*D] bf16, m and l [B, H, T] fp32 (all contiguous).
// props: [B, T] int4 (anchor, depth, doc, valid) contiguous; tiles: [B, NT,
// NT] int32 contiguous, NT = ceil(T / 64). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int cod_attention_fwd(const void* const* tensors,
                                 const long long* strides, const void* props,
                                 const int* tiles, void* out, float* m,
                                 float* l, int B, int H, int KVH, int T, int D,
                                 void* stream) {
  Params p;
  const int e = fill_params(p, tensors, strides, props, tiles, B, H, KVH, T, D);
  if (e != cudaSuccess) return e;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = m;
  p.l = l;
  const dim3 grid(p.NT, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = smem_q_side(D, p.NT);
  return D == 128 ? launch_kernel(cod_fwd_kernel<128>, grid, smem, p, st)
                  : launch_kernel(cod_fwd_kernel<64>, grid, smem, p, st);
}

// Backward, dq [B, H, T, D] (contiguous bf16). dout [B, T, H*D] is
// contiguous; m, l, delta are [B, H, T] fp32. The other arguments are those
// of the forward.
extern "C" int cod_attention_bwd_dq(const void* const* tensors,
                                    const long long* strides,
                                    const void* props, const int* tiles,
                                    const void* dout, const float* m,
                                    const float* l, const float* delta,
                                    void* dq, int B, int H, int KVH, int T,
                                    int D, void* stream) {
  Params p;
  const int e = fill_params(p, tensors, strides, props, tiles, B, H, KVH, T, D);
  if (e != cudaSuccess) return e;
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.m = const_cast<float*>(m);
  p.l = const_cast<float*>(l);
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  const dim3 grid(p.NT, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = smem_q_side(D, p.NT);
  return D == 128 ? launch_kernel(cod_bwd_dq_kernel<128>, grid, smem, p, st)
                  : launch_kernel(cod_bwd_dq_kernel<64>, grid, smem, p, st);
}

// Backward, dk and dv [B, KVH, T, D] (contiguous bf16), summed over the
// query heads of each group. Arguments as the dq kernel.
extern "C" int cod_attention_bwd_dkv(const void* const* tensors,
                                     const long long* strides,
                                     const void* props, const int* tiles,
                                     const void* dout, const float* m,
                                     const float* l, const float* delta,
                                     void* dk, void* dv, int B, int H,
                                     int KVH, int T, int D, void* stream) {
  Params p;
  const int e = fill_params(p, tensors, strides, props, tiles, B, H, KVH, T, D);
  if (e != cudaSuccess) return e;
  if ((long long)B * KVH > 65535) return cudaErrorInvalidValue;
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.m = const_cast<float*>(m);
  p.l = const_cast<float*>(l);
  p.delta = delta;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const dim3 grid(p.NT, B * KVH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = smem_dkv(D, p.NT);
  return D == 128 ? launch_kernel(cod_bwd_dkv_kernel<128>, grid, smem, p, st)
                  : launch_kernel(cod_bwd_dkv_kernel<64>, grid, smem, p, st);
}
