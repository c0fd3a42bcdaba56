// DFlash block attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of specforge_tpu/ops/dflash_pallas.py
// reached through `dflash_flash_attention`: `_fwd_kernel` (forward, through
// `_fwd_pallas`), and the two kernels of `_bwd_pallas`: `_bwd_dq_kernel` (dq
// plus the draft keys' dk/dv) and `_bwd_dkv_kernel` (the context keys'
// dk/dv).
//
// What it computes. Query row r lies in anchor block n = r / bs at offset
// o = r % bs, with anchor a_n. It attends, under one softmax, to the context
// keys j < a_n (and, under a sliding window w, j >= a_n + o - (w - 1)) and to
// its own block's bs draft keys (under a sliding window only offsets <= o).
// A block that is not kept attends to nothing: its rows come out exactly 0,
// with m = -1e30 and l = 0. Each row's allowed keys are two intervals, the
// context keys [lo, hi) and the draft keys [dlo, dhi), computed in the kernel
// from the anchors and keep flags [B, N]. The output goes straight to the
// [B, Q, H*D] layout the o_proj reads; the row statistics m and l are saved
// in fp32 for the backward, which recomputes p = exp(s - m) / l, takes
// delta = rowsum(dO * O) as given, and forms ds = p * (dO V^T - delta):
//   dq = scale * ds K,  dk = scale * ds^T Q,  dv = p^T dO.
//
// What bounds it on this card. At the Domino slice (B=2, H=32, KVH=8,
// D=128, S=768, 256 anchors of 16, so Q=4096) a row attends to about
// S/2 + 16 keys: the forward's two products are about 54 GFLOP (54 us at the
// bf16 tensor-core peak) against about 176 MB moved (53 us at 3.35 TB/s), so
// it sits at the ridge; kernel A (3 products) and kernel B (4 products over
// the context keys) are bound by operations. chip_smoke.py recomputes both
// terms from each run's anchors.
//
// What the design does about that. Every product runs on the tensor cores
// (bf16 in, fp32 accumulate); no score tile reaches device memory; nothing
// is padded or copied (the ragged ends of the context and of the draft rows
// are zero-filled and masked). The forward, on `mma.sync.m16n8k16`: one
// block of 4 warps owns a q tile of 64 rows of one (batch, head), a whole
// number of anchor blocks; each warp keeps the Q fragments of its 16 rows
// in registers. The anchors are sorted, so the tile's context loop runs
// only over the K tiles between the smallest lower bound and the largest
// anchor of its kept rows; then the tile's own 64 draft rows are folded in
// as one more tile under the block-diagonal mask (each warp skips the 8-key
// groups outside its own blocks). K/V tiles of 64 keys are staged by
// cp.async in two buffers of padded shared memory and reach the tensor
// cores through ldmatrix. It does not use TMA, wgmma or warp
// specialisation yet.
// Kernel A, dq and the draft keys' dk/dv, is bound by its three products
// per (query head, key tile) item: at the Domino slice about 7 key tiles
// per q tile. The first design (mma.sync from 4 warps, a block per query
// head, two cp.async stages, the span test on every score, the draft dk/dv
// written per query head and summed by the wrapper) reached about 10% of
// its bound. It now follows ttt_bwd_dq_kernel (dq_stream.cuh): a block of
// 384 threads owns a q tile of one (batch, kv head) and the group's query
// heads, four resident (a group of more runs in chunks), so each K/V tile
// is staged once for them by TMA; two consumer warpgroups run the three
// products on `wgmma` with dq in fp32 registers. A context tile inside
// every kept row's span skips the mask (at the Domino slice most of a q
// tile's context tiles lie below its smallest anchor). The draft keys
// follow as one more stage of the ring; their p and ds live only on the
// bs x bs diagonal blocks, which are staged compactly, and the block sums
// the draft dk/dv over its group's heads in fp32 in a fixed order and
// writes them once per kv head.
// Kernel B, the context keys' dk/dv, is bound by its four products per
// (query head, q tile) item that reaches a key tile: at the Domino slice
// 27,936 items over 192 blocks, the heaviest (key tile 0, every q tile of
// the four heads) 256 items. The first design ran them on mma.sync from 4
// warps with two cp.async stages and the mask per element, at about 7% of
// the tensor rate on that block. It now follows ttt_bwd_dkv_kernel
// (dkv_stream.cuh): a block of 384 threads owns 64 context keys of one
// (batch, kv head), K and V by TMA once, and first lists the q tiles whose
// kept anchors reach its keys; two consumer warpgroups split the group's
// (head, q tile) stream, each fed a ring of Q/dO stages by two producer
// warps, and run all four products on `wgmma` with dk, dv in fp32
// registers. Each row's context span [lo, hi) travels with its stage; a
// tile whose rows all reach every key of the block skips the mask (at the
// Domino slice most do: the key tile lies below the q tile's smallest
// anchor). The key tile is the grid's slow index, so without a window the
// heaviest blocks start first. The kernels share the Hopper helpers of
// hopper.cuh.

#include <limits.h>

#include "dkv_stream.cuh"
#include "dq_stream.cuh"

namespace {

constexpr int kBlockM = 64;  // query rows per q tile, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Params {
  const __nv_bfloat16* q;   // [B, H, Q, D] strided
  const __nv_bfloat16* kc;  // [B, KVH, S, D] strided: context keys
  const __nv_bfloat16* vc;
  const __nv_bfloat16* kd;  // [B, KVH, Q, D] strided: draft keys
  const __nv_bfloat16* vd;
  const int* anchors;       // [B, N]
  const int* keep;          // [B, N], 0 = block not kept
  __nv_bfloat16* out;       // [B, Q, H*D]
  float* m;                 // [B, H, Q]
  float* l;                 // [B, H, Q]
  long long q_sb, q_sh, q_ss;
  long long kc_sb, kc_sh, kc_ss;
  long long vc_sb, vc_sh, vc_ss;
  long long kd_sb, kd_sh, kd_ss;
  long long vd_sb, vd_sh, vd_ss;
  int B, H, KVH, S, Q, N, bs, window;  // window 0: no sliding window
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// The allowed keys of query row r of batch b: context keys [x, y), draft
// keys [z, w). Both are empty for a row past Q or of a block not kept. P is
// the forward's Params or the dq kernel's DFlashDqParams (the anchors,
// keep, N, S, Q, bs and window of both).
template <class P>
__device__ __forceinline__ int4 row_span(const P& p, int b, int r) {
  int lo = 0, hi = 0, dlo = 0, dhi = 0;
  if (r < p.Q) {
    const int n = r / p.bs;
    const long long i = (long long)b * p.N + n;
    if (p.keep[i] != 0) {
      const int a = p.anchors[i];
      hi = min(max(a, 0), p.S);
      if (p.window > 0) lo = min(max(a + r % p.bs - (p.window - 1), 0), hi);
      dlo = n * p.bs;
      dhi = p.window > 0 ? r + 1 : dlo + p.bs;
    }
  }
  return make_int4(lo, hi, dlo, dhi);
}

// Every row's spans of the q tile at q0 into sSpan, and into sBounds the
// context keys any kept row of the tile may attend: [min lo, max hi).
__device__ __forceinline__ void tile_spans(const Params& p, int b, int q0,
                                           int4* sSpan, int* sBounds) {
  if (threadIdx.x < kBlockM) sSpan[threadIdx.x] = row_span(p, b, q0 + threadIdx.x);
  __syncthreads();
  if (threadIdx.x < 32) {
    int lo = INT_MAX, hi = 0;
    for (int i = threadIdx.x; i < kBlockM; i += 32) {
      const int4 s = sSpan[i];
      if (s.y > s.x) {
        lo = min(lo, s.x);
        hi = max(hi, s.y);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (threadIdx.x == 0) {
      sBounds[0] = lo;
      sBounds[1] = hi;
    }
  }
  __syncthreads();
}

// The draft keys (local to the q tile) that warp `warp`'s 16 rows can reach:
// the anchor blocks those rows lie in.
__device__ __forceinline__ void warp_draft_range(int warp, int bs, int& lo,
                                                 int& hi) {
  lo = (warp * 16 / bs) * bs;
  hi = min(((warp * 16 + 15) / bs + 1) * bs, kBlockM);
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

// Stage tile j of a q tile's key sequence into sK/sV: the context tiles
// t_lo, t_lo + 1, ... (j < n_ctx), then the q tile's own draft rows
// (j == n_ctx). Rows past S (or Q) are zero-filled.
template <int D>
__device__ __forceinline__ void load_kv_tile(const Params& p, int b, int kvh,
                                             int q0, int t_lo, int n_ctx,
                                             int j, __nv_bfloat16* sK,
                                             __nv_bfloat16* sV) {
  constexpr int kStride = D + 8;
  constexpr int kVecPerRow = D / 8;
  const bool draft = j == n_ctx;
  const int key0 = draft ? q0 : (t_lo + j) * kBlockN;
  const int limit = draft ? p.Q : p.S;
  const __nv_bfloat16* kb =
      draft ? p.kd + b * p.kd_sb + kvh * p.kd_sh : p.kc + b * p.kc_sb + kvh * p.kc_sh;
  const __nv_bfloat16* vb =
      draft ? p.vd + b * p.vd_sb + kvh * p.vd_sh : p.vc + b * p.vc_sb + kvh * p.vc_sh;
  const long long kss = draft ? p.kd_ss : p.kc_ss;
  const long long vss = draft ? p.vd_ss : p.vc_ss;
  for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    const int key = key0 + r;
    const long long src = key < limit ? key : 0;
    cp_async16(sK + r * kStride + c, kb + src * kss + c, key < limit);
    cp_async16(sV + r * kStride + c, vb + src * vss + c, key < limit);
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
__global__ void __launch_bounds__(kThreads) dflash_fwd_kernel(const Params p) {
  constexpr int kStride = D + 8;  // padded row: conflict-free ldmatrix
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBlockN / 8;
  constexpr int kTile = kBlockN * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sKs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sVs = sKs + 2 * kTile;
  __shared__ int4 sSpan[kBlockM];
  __shared__ int sBounds[2];

  const int n_qtiles = (p.Q + kBlockM - 1) / kBlockM;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // later anchors (more keys) first
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qtile * kBlockM;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool in0 = row0 < p.Q;
  const bool in1 = row1 < p.Q;

  tile_spans(p, b, q0, sSpan, sBounds);
  const int4 sp0 = sSpan[warp * 16 + g];
  const int4 sp1 = sSpan[warp * 16 + g + 8];
  const bool any_ctx = sBounds[1] > sBounds[0];
  const int t_lo = any_ctx ? sBounds[0] / kBlockN : 0;
  const int n_ctx = any_ctx ? (sBounds[1] + kBlockN - 1) / kBlockN - t_lo : 0;
  int wlo, whi;
  warp_draft_range(warp, p.bs, wlo, whi);

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

  const int n_tiles = n_ctx + 1;
  load_kv_tile<D>(p, b, kvh, q0, t_lo, n_ctx, 0, sKs, sVs);
  for (int j = 0; j < n_tiles; ++j) {
    const bool draft = j == n_ctx;
    const int key0 = draft ? q0 : (t_lo + j) * kBlockN;
    const int lo0 = draft ? sp0.z : sp0.x, hi0 = draft ? sp0.w : sp0.y;
    const int lo1 = draft ? sp1.z : sp1.x, hi1 = draft ? sp1.w : sp1.y;
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_kv_tile<D>(p, b, kvh, q0, t_lo, n_ctx, j + 1,
                      sKs + (buf ^ 1) * kTile, sVs + (buf ^ 1) * kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sK = sKs + buf * kTile;
    const __nv_bfloat16* sV = sVs + buf * kTile;

    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      // draft keys outside this warp's blocks are masked: skip their product
      if (draft && (nt * 8 >= whi || nt * 8 + 8 <= wlo)) continue;
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
        const int col = key0 + nt * 8 + 2 * t + e;
        s[nt][e] = (col >= lo0 && col < hi0) ? s[nt][e] * p.scale : kNegInf;
        s[nt][2 + e] =
            (col >= lo1 && col < hi1) ? s[nt][2 + e] * p.scale : kNegInf;
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
      if (draft && (kk * 16 >= whi || kk * 16 + 16 <= wlo)) continue;
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
    __nv_bfloat16* op = p.out + ((long long)b * p.Q + row0) * HD + h * D;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    }
  }
  if (in1) {
    __nv_bfloat16* op = p.out + ((long long)b * p.Q + row1) * HD + h * D;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
  if (t == 0) {
    const long long base = ((long long)b * p.H + h) * p.Q;
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
// backward, kernel A: dq, and the draft keys' dk/dv summed over the group
// --------------------------------------------------------------------------

struct DFlashDqParams {
  DqStream s;           // rows = Q; tm_k[0], tm_v[0]: the context (S keys),
                        // tm_k[1], tm_v[1]: the draft keys (Q)
  const int* anchors;   // [B, N]
  const int* keep;      // [B, N], 0 = block not kept
  __nv_bfloat16* dkd;   // [B, KVH, Q, D]: the draft keys' dk, group-summed
  __nv_bfloat16* dvd;   // [B, KVH, Q, D]
  float* ws;            // [2, B, KVH, Q, D] fp32 when the group spans chunks
  int S, Q, N, bs, window;
  int band_shift;       // log2 of the draft band's width, max(bs, 16)
  int band_off;         // byte offset of the draft staging in shared memory
};

// The DFlash policy of the dq stream. A block lists the context tiles that
// its kept rows reach, then its own 64 draft keys (the second key source,
// the block's last tile). Each row's spans (lo, hi, dlo, dhi) are the rows'
// mask data; a context tile needs no mask when every kept row reaches all
// of its keys (rows not kept have no allowed key, so their p is 0
// unmasked), its list bit. The draft tile is always masked
// (block-diagonal, and by offset under a window); each head's p and ds
// there live only on its bs x bs diagonal blocks, which a band of width W =
// max(bs, 16) along the diagonal holds: they are staged in bf16, [64
// rows][W] per head, and after the chunk's last tile warpgroup 0 sums dk_d
// = scale * sum_h ds_h^T Q_h and warpgroup 1 dv_d = sum_h p_h^T dO_h over
// the chunk's heads in head order on mma.sync (under 5% of the block's
// products), in fp32, through the workspace past one chunk, and writes
// them once as [B, KVH, Q, D].
template <int D>
struct DFlashDq {
  static constexpr bool kSecondSource = true;  // the draft keys, last
  static constexpr bool kRowSlots = false;      // the slots are heads
  static constexpr bool kLogSumExp = false;     // m and l
  const DFlashDqParams& p;

  __device__ __forceinline__ void stage_key(unsigned char*, const DqBlock&,
                                            int, int, int) const {}

  // key key0 + 8 jj + 2 t + (e & 1) against row r0 (e < 2) or r0 + 8
  __device__ __forceinline__ uint32_t tile_bits(const unsigned char* rows,
                                                const unsigned char*,
                                                int key0, bool draft, int r0,
                                                int t) const {
    const int4 a = *reinterpret_cast<const int4*>(rows + r0 * 16);
    const int4 c = *reinterpret_cast<const int4*>(rows + (r0 + 8) * 16);
    const int lo[2] = {draft ? a.z : a.x, draft ? c.z : c.x};
    const int n[2] = {(draft ? a.w : a.y) - lo[0], (draft ? c.w : c.y) - lo[1]};
    uint32_t bits = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int e = (i >> 1) & 1;
      bits |= static_cast<uint32_t>(
                  static_cast<unsigned>(key - lo[e]) <
                  static_cast<unsigned>(n[e])) << i;
    }
    return bits;
  }

  // the draft tile's p and ds of head lh, this thread's band entries
  __device__ __forceinline__ void tile_done(unsigned char* smem, int lh,
                                            const float (&pr)[32],
                                            const uint32_t (&da)[4][4],
                                            int r0, int t) const {
    const int w = 1 << p.band_shift;
    const int band0 = (r0 >> p.band_shift) << p.band_shift;
    unsigned char* pb = smem + p.band_off + lh * 2 * kTileRows * w * 2;
    unsigned char* db = pb + kTileRows * w * 2;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (8 * jj < band0 || 8 * jj >= band0 + w) continue;
      const int o0 = (r0 * w + 8 * jj + 2 * t - band0) * 2;
      const int o1 = o0 + 8 * w * 2;  // row r0 + 8
      *reinterpret_cast<uint32_t*>(pb + o0) =
          pack_bf16(pr[4 * jj], pr[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(pb + o1) =
          pack_bf16(pr[4 * jj + 2], pr[4 * jj + 3]);
      *reinterpret_cast<uint32_t*>(db + o0) = da[jj / 2][(jj % 2) * 2];
      *reinterpret_cast<uint32_t*>(db + o1) = da[jj / 2][(jj % 2) * 2 + 1];
    }
  }

  // The chunk's group sums of the draft keys: warp w of warpgroup 0 (dk,
  // A = ds^T, B = Q) or 1 (dv, A = p^T, B = dO) owns draft keys 16 w ..
  // 16 w + 15 of the tile, which only the rows of their band reach; a
  // half of D at a time.
  __device__ __forceinline__ void chunk_done(unsigned char* smem,
                                             const DqBlock& blk, int c,
                                             bool last, int nh, int wg,
                                             int tid) const {
    using L = DqStreamSmem<D>;
    consumers_sync();  // every head's draft p and ds are staged
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int w = 1 << p.band_shift;
    const int k0 = warp * 16;
    const int band0 = (k0 >> p.band_shift) << p.band_shift;
    // ds (warpgroup 0) or p (warpgroup 1) of head 0; a head is 2 bands on
    const unsigned char* band =
        smem + p.band_off + (wg == 0 ? kTileRows * w * 2 : 0);
    const unsigned char* xs = smem + (wg == 0 ? L::kQ : L::kDO);
    const long long at =
        (((long long)blk.b * p.s.KVH + blk.kvh) * p.s.rows + blk.q0) * D;
    __nv_bfloat16* out = (wg == 0 ? p.dkd : p.dvd) + at;
    float* ws = c == 0 && last ? nullptr
                              : p.ws + (wg == 0 ? 0
                                                : (long long)p.s.B * p.s.KVH *
                                                      p.s.rows * D) + at;
    const float mul = wg == 0 ? p.s.scale : 1.f;
    const int a_row = (lane & 7) + ((lane >> 4) << 3);  // queries of the band
    const int a_col = k0 - band0 + ((lane >> 3) & 1) * 8;  // its keys
#pragma unroll
    for (int half = 0; half < D / 64; ++half) {
      float acc[8][4];
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int key = k0 + g + 8 * hr;
          float2 v = make_float2(0.f, 0.f);
          if (c > 0 && blk.q0 + key < p.s.rows) {
            v = *reinterpret_cast<const float2*>(
                ws + (long long)key * D + half * 64 + dt * 8 + 2 * t);
          }
          acc[dt][2 * hr] = v.x;
          acc[dt][2 * hr + 1] = v.y;
        }
      }
      for (int lh = 0; lh < nh; ++lh) {
        for (int ks = 0; ks < (w >> 4); ++ks) {
          const int row = band0 + ks * 16;
          uint32_t a[4];
          ldmatrix_x4_trans(a, band + (lh * 2 * kTileRows * w +
                                       (row + a_row) * w + a_col) * 2);
#pragma unroll
          for (int dt = 0; dt < 8; dt += 2) {
            uint32_t f[4];
            ldmatrix_x4_trans(f, xs + lh * L::kTile +
                                     swz(row + (lane & 15),
                                         half * 8 + dt + (lane >> 4)));
            mma_bf16(acc[dt], a, f[0], f[1]);
            mma_bf16(acc[dt + 1], a, f[2], f[3]);
          }
        }
      }
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int key = k0 + g + 8 * hr;
          if (blk.q0 + key >= p.s.rows) continue;
          const long long o = (long long)key * D + half * 64 + dt * 8 + 2 * t;
          if (!last) {
            *reinterpret_cast<float2*>(ws + o) =
                make_float2(acc[dt][2 * hr], acc[dt][2 * hr + 1]);
          } else {
            *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(
                acc[dt][2 * hr] * mul, acc[dt][2 * hr + 1] * mul);
          }
        }
      }
    }
    consumers_sync();  // the Q and dO tiles are read: the next chunk may come
  }
};

// One block owns one q tile (64 rows) of one (batch, kv head) and the
// group's query heads (dq_stream.cuh); the q tile is the grid's slow index,
// later tiles (later anchors, more context keys) first. The block writes
// its rows' spans, reduces them over its kept rows and lists its tiles.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    dflash_bwd_dq_kernel(const __grid_constant__ DFlashDqParams p) {
  using L = DqStreamSmem<D>;
  extern __shared__ unsigned char dq_smem[];
  unsigned char* smem = align1024(dq_smem);
  DqBlock* info = dq_block_info<D>(smem);
  int* setup = dq_setup<D>(smem);
  int* list = reinterpret_cast<int*>(smem + L::kExtra);
  const int BK = p.s.B * p.s.KVH;
  const int n_qtiles = (p.s.rows + kTileRows - 1) / kTileRows;
  const int q0 = (n_qtiles - 1 - blockIdx.x / BK) * kTileRows;
  const int b = blockIdx.x % BK / p.s.KVH;
  dq_init_block<D>(smem, b, blockIdx.x % p.s.KVH, q0);
  int4* spans = reinterpret_cast<int4*>(smem + L::kRowData);
  if (threadIdx.x < kTileRows) {
    spans[threadIdx.x] = row_span(p, b, q0 + threadIdx.x);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // over the kept rows (a draft span): the context keys any of them
    // attends, [lo, hi), and the largest lo and smallest hi
    int lo = INT_MAX, hi = 0, max_lo = 0, min_hi = INT_MAX;
    for (int i = threadIdx.x; i < kTileRows; i += 32) {
      const int4 s = spans[i];
      if (s.w > s.z) {
        max_lo = max(max_lo, s.x);
        min_hi = min(min_hi, s.y);
        if (s.y > s.x) {
          lo = min(lo, s.x);
          hi = max(hi, s.y);
        }
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    max_lo = __reduce_max_sync(0xffffffffu, max_lo);
    min_hi = __reduce_min_sync(0xffffffffu, min_hi);
    if (threadIdx.x == 0) {
      const bool any = hi > lo;
      setup[0] = any ? lo / kTileRows : 0;  // the first context tile
      setup[1] = max_lo;
      setup[2] = min_hi;
      info->n_tiles = any ? (hi + kTileRows - 1) / kTileRows - setup[0] + 1
                          : 1;  // and the draft tile
    }
  }
  __syncthreads();
  // the context tiles, each with its "needs no mask" bit, then the draft
  // keys (the q tile's own rows of the second source)
  const int n_tiles = info->n_tiles;
  for (int j = threadIdx.x; j < n_tiles; j += blockDim.x) {
    const int tile = setup[0] + j;
    const int key0 = tile * kTileRows;
    list[j] = j + 1 == n_tiles
                  ? 2 * (q0 / kTileRows)
                  : 2 * tile + (setup[1] <= key0 &&
                                key0 + kTileRows <= setup[2]);
  }
  __syncthreads();
  dq_stream_block<D>(p.s, DFlashDq<D>{p}, smem);
}

// --------------------------------------------------------------------------
// backward, kernel B: the context keys' dk/dv
// --------------------------------------------------------------------------

struct DkvParams {
  DkvStream s;         // rows = Q, keys = S
  const int* anchors;  // [B, N]
  const int* keep;     // [B, N], 0 = block not kept
  int N, bs_shift, window;  // block_size = 1 << bs_shift (it divides 64)
};

// The DFlash mask of the dk/dv stream: a row's allowed context keys are one
// interval [lo, hi) (the x, y of row_span), staged with its q tile as 16
// bytes a row; a stage needs no mask when every row of the tile reaches
// every key of the block's tile (kept, lo <= key0, hi >= key0 + 64).
struct DFlashRows {
  static constexpr bool kLogSumExp = false;  // m and l
  const DkvParams& p;

  using Keys = int2;  // this thread's two keys
  using Row = int2;   // a row's context span [lo, hi)

  __device__ __forceinline__ Keys keys(const unsigned char*,
                                       const DkvBlock& blk, int kr0) const {
    return make_int2(blk.key0 + kr0, blk.key0 + kr0 + 8);
  }

  __device__ __forceinline__ Row row(const unsigned char* mask, int r) const {
    return *reinterpret_cast<const int2*>(mask + r * 16);
  }

  __device__ __forceinline__ bool allow(const Keys& k, int kx, Row r) const {
    const int key = kx ? k.y : k.x;
    return key >= r.x && key < r.y;
  }

  // row q0 + r's span; whether it reaches every key of the block's tile
  __device__ __forceinline__ bool stage_row(unsigned char* mask,
                                            const DkvBlock& blk, int q0,
                                            int r) const {
    const int row = q0 + r;
    int lo = 0, hi = 0;
    if (row < p.s.rows) {
      const long long i = (long long)blk.b * p.N + (row >> p.bs_shift);
      if (p.keep[i] != 0) {
        const int a = p.anchors[i];
        hi = min(max(a, 0), p.s.keys);
        if (p.window > 0) {
          const int o = row & ((1 << p.bs_shift) - 1);
          lo = min(max(a + o - (p.window - 1), 0), hi);
        }
      }
    }
    *reinterpret_cast<int2*>(mask + r * 16) = make_int2(lo, hi);
    return lo <= blk.key0 && hi >= blk.key0 + kTileRows;
  }

  // the tile needs no mask when every row reaches every key
  __device__ __forceinline__ bool tile_free(int, bool rows_free) const {
    return rows_free;
  }
};

// One block owns 64 context keys of one (batch, kv head) (blockIdx: key
// tile, the slow index, then batch, kv head): without a window the early
// key tiles are reached by the most q tiles, so the heaviest blocks start
// first. The block first lists the q tiles whose kept anchors reach its
// keys (a row of block n reaches at most [a_n - (w - 1), a_n); all of
// [0, a_n) without a window), then streams the group's query heads over
// them (dkv_stream.cuh).
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    dflash_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  using L = DkvStreamSmem<D>;
  extern __shared__ unsigned char dkv_smem[];
  unsigned char* smem = align1024(dkv_smem);
  int* list = reinterpret_cast<int*>(smem + L::kList);
  const int BK = p.s.B * p.s.KVH;
  const int b = blockIdx.x % BK / p.s.KVH;
  const int key0 = blockIdx.x / BK * kTileRows;
  dkv_init_block<D>(smem, b, blockIdx.x % p.s.KVH, key0);

  const int n_qtiles = (p.s.rows + kBlockM - 1) / kBlockM;
  const int blocks_per_tile = kBlockM >> p.bs_shift;
  for (int i = threadIdx.x; i < n_qtiles; i += blockDim.x) {
    int lo = INT_MAX, hi = 0;
    const int n_end = min((i + 1) * blocks_per_tile, p.N);
    for (int n = i * blocks_per_tile; n < n_end; ++n) {
      const long long idx = (long long)b * p.N + n;
      if (p.keep[idx] == 0) continue;
      const int a = p.anchors[idx];
      const int bh = min(max(a, 0), p.s.keys);
      const int bl = p.window > 0 ? min(max(a - (p.window - 1), 0), bh) : 0;
      if (bh > bl) {
        lo = min(lo, bl);
        hi = max(hi, bh);
      }
    }
    list[i] = (hi > lo && lo < key0 + kTileRows && hi > key0) ? 1 : 0;
  }
  compact_list(list, n_qtiles, &block_info<D>(smem)->n_list);
  dkv_stream_block<D>(p.s, DFlashRows{p}, smem);
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

int smem_fwd(int D) { return 4 * kBlockN * (D + 8) * 2; }

// tensors: q, k_ctx, v_ctx, k_drf, v_drf; strides: their element strides
// over (b, head, row), 15 values in that order; the head dim is contiguous
int fill_params(Params& p, const void* const* tensors,
                const long long* strides, const int* anchors, const int* keep,
                int B, int H, int KVH, int S, int N, int bs, int window,
                int D) {
  if (B < 1 || KVH < 1 || H % KVH != 0 || (long long)B * H > 65535 ||
      S < 1 || N < 1 || bs < 1 || kBlockM % bs != 0 || window < 0 ||
      (D != 64 && D != 128) || (long long)N * bs > INT_MAX / 2) {
    return cudaErrorInvalidValue;
  }
  p.q = static_cast<const __nv_bfloat16*>(tensors[0]);
  p.kc = static_cast<const __nv_bfloat16*>(tensors[1]);
  p.vc = static_cast<const __nv_bfloat16*>(tensors[2]);
  p.kd = static_cast<const __nv_bfloat16*>(tensors[3]);
  p.vd = static_cast<const __nv_bfloat16*>(tensors[4]);
  p.anchors = anchors;
  p.keep = keep;
  p.out = nullptr;
  p.m = p.l = nullptr;
  long long* dst[15] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.kc_sb, &p.kc_sh,
                        &p.kc_ss, &p.vc_sb, &p.vc_sh, &p.vc_ss, &p.kd_sb,
                        &p.kd_sh, &p.kd_ss, &p.vd_sb, &p.vd_sh, &p.vd_ss};
  for (int i = 0; i < 15; ++i) *dst[i] = strides[i];
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.N = N;
  p.bs = bs;
  p.Q = N * bs;
  p.window = window;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  return cudaSuccess;
}

}  // namespace

// Forward: out [B, Q, H*D] bf16, m and l [B, H, Q] fp32 (all contiguous).
// anchors, keep: [B, N] int32 contiguous; window 0 = no sliding window.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dflash_attention_fwd(const void* const* tensors,
                                    const long long* strides,
                                    const int* anchors, const int* keep,
                                    void* out, float* m, float* l, int B,
                                    int H, int KVH, int S, int N, int bs,
                                    int window, int D, void* stream) {
  Params p;
  const int e = fill_params(p, tensors, strides, anchors, keep, B, H, KVH, S,
                            N, bs, window, D);
  if (e != cudaSuccess) return e;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = m;
  p.l = l;
  const dim3 grid((p.Q + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_kernel(dflash_fwd_kernel<128>, grid, smem_fwd(128), p, st)
                  : launch_kernel(dflash_fwd_kernel<64>, grid, smem_fwd(64), p, st);
}

// Backward kernel A: dq [B, H, Q, D] and the draft keys' dk, dv summed
// over each group's query heads [B, KVH, Q, D] (all contiguous bf16). dout
// [B, Q, H*D] is contiguous; m, l, delta are [B, H, Q] fp32. `heads` is the
// number of query heads a block keeps resident: 4, or 2 where the draft
// staging (64 x max(bs, 16) bf16 of p and of ds a head) does not fit beside
// four at D = 128; ws is an fp32 workspace [2, B, KVH, Q, D] when H / KVH >
// heads (else unused). The other arguments are those of the forward; the
// strides of all five operands must be multiples of 8 elements and their
// bases 16-byte aligned (the tensor maps').
extern "C" int dflash_attention_bwd_dq(
    const void* const* tensors, const long long* strides, const int* anchors,
    const int* keep, const void* dout, const float* m, const float* l,
    const float* delta, void* dq, void* dkd, void* dvd, float* ws, int heads,
    int B, int H, int KVH, int S, int N, int bs, int window, int D,
    void* stream) {
  Params p;
  const int e = fill_params(p, tensors, strides, anchors, keep, B, H, KVH, S,
                            N, bs, window, D);
  if (e != cudaSuccess) return e;
  DFlashDqParams d;
  if (!fill_dq_stream(d.s, tensors[0], strides, tensors[1], strides + 3,
                      tensors[2], strides + 6, S, tensors[3], strides + 9,
                      tensors[4], strides + 12, p.Q, dout, m, l, delta, dq,
                      B, H, KVH, p.Q, D, heads) ||
      (H / KVH > heads && ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
  d.anchors = anchors;
  d.keep = keep;
  d.dkd = static_cast<__nv_bfloat16*>(dkd);
  d.dvd = static_cast<__nv_bfloat16*>(dvd);
  d.ws = ws;
  d.S = S;
  d.Q = p.Q;
  d.N = N;
  d.bs = bs;
  d.window = window;
  d.band_shift = 4;
  while ((1 << d.band_shift) < bs) ++d.band_shift;
  // the tile list (the context tiles and the draft tile), then the draft
  // staging, unless that fits in the Q tiles' unused slots
  const int list = ((S + kTileRows - 1) / kTileRows + 1 + 3) / 4 * 16;
  const int band = heads * 2 * kTileRows * (1 << d.band_shift) * 2;
  const int tile = kTileRows * D * 2;
  const bool in_q = band <= (kDqHeads - heads) * tile;
  d.band_off = in_q ? heads * tile
                    : list + (D == 128 ? DqStreamSmem<128>::kExtra
                                       : DqStreamSmem<64>::kExtra);
  const int smem = dq_smem_bytes(D, list + (in_q ? 0 : band));
  const long long blocks =
      (long long)((p.Q + kTileRows - 1) / kTileRows) * B * KVH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128
             ? launch_hopper(dflash_bwd_dq_kernel<128>, smem, d, blocks, st)
             : launch_hopper(dflash_bwd_dq_kernel<64>, smem, d, blocks, st);
}

// Backward kernel B: the context keys' dk, dv [B, KVH, S, D] (contiguous
// bf16), summed over the query heads of each group. Arguments as kernel A;
// the strides of q and of the context keys and values must be multiples of
// 8 elements and their bases 16-byte aligned (the tensor maps').
extern "C" int dflash_attention_bwd_dkv(
    const void* const* tensors, const long long* strides, const int* anchors,
    const int* keep, const void* dout, const float* m, const float* l,
    const float* delta, void* dkc, void* dvc, int B, int H, int KVH, int S,
    int N, int bs, int window, int D, void* stream) {
  Params p;
  const int e = fill_params(p, tensors, strides, anchors, keep, B, H, KVH, S,
                            N, bs, window, D);
  if (e != cudaSuccess) return e;
  DkvParams d;
  if (!fill_stream(d.s, tensors[0], strides, tensors[1], strides + 3,
                   tensors[2], strides + 6, dout, m, l, delta, dkc, dvc, B,
                   H, KVH, p.Q, S, D)) {
    return cudaErrorInvalidValue;
  }
  d.anchors = anchors;
  d.keep = keep;
  d.N = N;
  d.bs_shift = 0;
  while ((1 << d.bs_shift) < bs) ++d.bs_shift;
  d.window = window;
  const long long blocks = (long long)((S + kBlockN - 1) / kBlockN) * B * KVH;
  const int smem = dkv_smem_bytes(D, (p.Q + kBlockM - 1) / kBlockM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_hopper(dflash_bwd_dkv_kernel<128>, smem, d,
                                  blocks, st)
                  : launch_hopper(dflash_bwd_dkv_kernel<64>, smem, d, blocks,
                                  st);
}
