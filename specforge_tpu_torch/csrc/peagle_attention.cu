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
// (bf16 in, fp32 accumulate); no score tile reaches device memory. Whole
// 64 x 64 tiles with no allowed pair are skipped: the caller hands a
// [B, NT, NT] table (1 where a tile pair holds an allowed pair), built once
// per forward from the model's mask and shared by every layer and head;
// each block lists its live tiles from it first. The doc-major order of
// the sample makes the live tiles few and dense (about a quarter of the
// grid at the slice, block-diagonal when documents are packed). The
// forward, on `mma.sync.m16n8k16`: one block of 4 warps owns a q tile of
// 64 rows of one (batch, head); each warp keeps the Q fragments of its 16
// rows and the properties of its thread's two rows in registers; the live
// K/V tiles and their keys' properties are staged by cp.async in two
// buffers of padded shared memory and reach the tensor cores through
// ldmatrix; it does not use TMA, wgmma or warp specialisation yet. The GQA
// kv head is read as h / (H / KVH), never repeated in memory; there are no
// atomics, so two runs give the same bits. T need not be a multiple of 64:
// rows and keys past T are zero-filled and carry no valid property.
// dq is bound by its three products per live (query head, key tile) item:
// at the slice about 13 live key tiles per q tile. The first design
// (mma.sync from 4 warps, a block per query head, two cp.async stages, the
// predicate on every pair, blocks in doc-major order) reached about 8% of
// its bound. It now follows ttt_bwd_dq_kernel (dq_stream.cuh): a block of
// 384 threads owns a q tile of one (batch, kv head) and the group's query
// heads, four resident, so each live K/V tile is staged once for them by
// TMA; two consumer warpgroups run the three products on `wgmma` with dq
// in fp32 registers. The rows' folded properties are staged once a block,
// a stage's keys' with the stage, and the predicate runs once a stage for
// both of a warpgroup's heads, only where the caller's full-tile flag
// (carried in the block's tile list) is not set. The blocks are issued
// longest first, in an order of (batch, q tile) pairs the caller sorts by
// their live key tiles on the card.
// dk/dv is bound by its four products per live (query head, q tile) item:
// at the slice 45,632 items over 864 blocks, at most 180 in one block; the
// first design (mma.sync from 4 warps, two cp.async stages, the predicate
// on every pair) reached about 10% of the tensor rate on the critical path,
// and its grid order (key tiles doc-major, not by load) left SMs idle at
// the end. It now follows ttt_bwd_dkv_kernel (dkv_stream.cuh): a block of
// 384 threads owns 64 keys of one (batch, kv head), K and V by TMA once;
// two consumer warpgroups split the group's (head, live q tile) stream,
// each fed a ring of Q/dO stages by two producer warps, and run all four
// products on `wgmma` with dk, dv in fp32 registers. The rows' properties
// travel with their stage, the keys' are staged once in shared memory
// and read per item only where the predicate runs, so they hold no
// consumer registers across the stream (dk and dv take 128); tile pairs
// whose every pair is allowed (a second [B, NT, NT] array from the caller,
// carried as a bit of the block's item list: 46% of the live pairs at the
// slice) skip the predicate. The blocks are issued longest first, in an
// order of (batch, key tile) pairs the caller sorts by their live q tiles
// on the card, once per forward. The kernels share the Hopper helpers of
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
  const __nv_bfloat16* q;  // [B, H, T, D] strided
  const __nv_bfloat16* k;  // [B, KVH, T, D] strided
  const __nv_bfloat16* v;
  const int4* props;       // [B, T]: (anchor, depth, doc, valid)
  const int* tiles;        // [B, NT, NT]: 1 where a tile pair may attend
  __nv_bfloat16* out;      // [B, T, H*D]
  float* m;                // [B, H, T]
  float* l;                // [B, H, T]
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int B, H, KVH, T, NT;
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

// The pair test on folded properties: a row's doc is INT_MIN + 1 when the
// row is invalid or padding, a key's INT_MIN when it is invalid, so that a
// pair is allowed iff the docs match and the trunk or the rollout rule
// holds, as cod_allow
__device__ __forceinline__ bool cod_folded_allow(int4 q, int ka, int kd,
                                                 int kc) {
  return q.z == kc && ((kd == 0 && q.x >= ka) || (q.x == ka && q.y >= kd));
}

// token i's properties with its own conditions folded into the doc: as a
// row (`row`: invalid or padding gets INT_MIN + 1) or as a key (invalid
// gets INT_MIN); a token past T is invalid
__device__ __forceinline__ int4 cod_folded(const int4* props, int T, int b,
                                           int i, bool row) {
  const int4 x =
      i < T ? props[(long long)b * T + i] : make_int4(0, 0, -1, 0);
  const bool ok = x.w != 0 && (!row || x.z != -1);
  return make_int4(x.x, x.y, ok ? x.z : (row ? INT_MIN + 1 : INT_MIN), 0);
}

struct CodDqParams {
  DqStream s;          // rows = keys = T
  const int4* props;   // [B, T]
  const int* tiles;    // [B, NT, NT]: 1 where a tile pair may attend
  const int* full;     // [B, NT, NT]: 1 where every pair of it is allowed
  const int* order;    // [B * NT]: (batch, q tile) pairs, longest first
  int NT;
};

// The COD policy of the dq stream. A block streams the live key tiles of
// its q tile (row `qtile` of the batch's table), listed first with each
// tile's full-tile flag as the entry's bit. The rows' folded properties are
// the rows' mask data; a stage that is not full carries its keys' folded
// properties, written by the producer lanes, and the consumers test the
// pairs once a stage; a full stage needs neither.
struct CodDq {
  static constexpr bool kSecondSource = false;
  static constexpr bool kRowSlots = false;   // the slots are heads
  static constexpr bool kLogSumExp = false;  // m and l
  const CodDqParams& p;

  // a stage that is not full carries its keys' folded properties
  __device__ __forceinline__ void stage_key(unsigned char* key_data,
                                            const DqBlock& blk, int entry,
                                            int key0, int r) const {
    if ((entry & 1) != 0) return;
    *reinterpret_cast<int4*>(key_data + r * 16) =
        cod_folded(p.props, p.s.rows, blk.b, key0 + r, false);
  }

  // key 8 jj + 2 t + (e & 1) of the tile against row r0 (e < 2) or r0 + 8
  __device__ __forceinline__ uint32_t tile_bits(const unsigned char* rows,
                                                const unsigned char* keys,
                                                int, bool, int r0,
                                                int t) const {
    const int4 q0 = *reinterpret_cast<const int4*>(rows + r0 * 16);
    const int4 q1 = *reinterpret_cast<const int4*>(rows + (r0 + 8) * 16);
    uint32_t bits = 0u;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int4 k =
            *reinterpret_cast<const int4*>(keys + (8 * jj + 2 * t + c) * 16);
        bits |= static_cast<uint32_t>(cod_folded_allow(q0, k.x, k.y, k.z))
                << (4 * jj + c);
        bits |= static_cast<uint32_t>(cod_folded_allow(q1, k.x, k.y, k.z))
                << (4 * jj + 2 + c);
      }
    }
    return bits;
  }

  __device__ __forceinline__ void chunk_done(unsigned char*, const DqBlock&,
                                             int, bool, int, int, int) const {}
};

// One block owns one q tile of one (batch, kv head) and the group's query
// heads (dq_stream.cuh): blockIdx / KVH picks the (batch, q tile) pair from
// `order` (the caller sorts the pairs by their live key tiles, descending,
// so the heaviest blocks start first), blockIdx % KVH the kv head. The
// block writes its rows' folded properties and lists the live key tiles of
// its q tile (row `qtile` of the batch's table).
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    cod_bwd_dq_kernel(const __grid_constant__ CodDqParams p) {
  using L = DqStreamSmem<D>;
  extern __shared__ unsigned char dq_smem[];
  unsigned char* smem = align1024(dq_smem);
  int* list = reinterpret_cast<int*>(smem + L::kExtra);
  const int NT = p.NT;
  const int pair = p.order[blockIdx.x / p.s.KVH];
  const int b = pair / NT;
  const int q0 = pair % NT * kTileRows;
  dq_init_block<D>(smem, b, blockIdx.x % p.s.KVH, q0);
  if (threadIdx.x < kTileRows) {
    reinterpret_cast<int4*>(smem + L::kRowData)[threadIdx.x] =
        cod_folded(p.props, p.s.rows, b, q0 + threadIdx.x, true);
  }
  // the live key tiles of the q tile, each with its full-tile flag as the
  // tile bit
  const long long row = (long long)pair * NT;
  for (int i = threadIdx.x; i < NT; i += blockDim.x) {
    list[i] = p.tiles[row + i] != 0 ? 1 + 2 * (p.full[row + i] != 0) : 0;
  }
  compact_list(list, NT, &dq_block_info<D>(smem)->n_tiles);
  dq_stream_block<D>(p.s, CodDq{p}, smem);
}

// --------------------------------------------------------------------------
// backward: dk, dv
// --------------------------------------------------------------------------

struct CodDkvParams {
  DkvStream s;         // rows = keys = T
  const int4* props;   // [B, T]
  const int* tiles;    // [B, NT, NT]: 1 where a tile pair may attend
  const int* full;     // [B, NT, NT]: 1 where every pair of it is allowed
  const int* order;    // [B * NT]: (batch, key tile) pairs, longest first
  int NT;
};

// The COD mask of the dk/dv stream. Each row's properties travel with its
// q tile (16 bytes a row) with the row's own conditions folded into the
// doc: a row that is invalid or padding gets a doc no key has (INT_MIN + 1);
// an invalid key gets INT_MIN, which no row has. Then a pair is allowed iff
// the docs match and the trunk or the rollout rule holds, as cod_allow. The
// block's 64 keys' properties are staged once, and a thread reads its two
// keys' for each item that needs the mask. A stage needs no mask when the
// caller's full-tile flag (carried in the item list) says every pair of the
// tile pair is allowed.
struct CodRows {
  static constexpr bool kLogSumExp = false;  // m and l
  const CodDkvParams& p;

  struct Keys {
    int a0, d0, c0, a1, d1, c1;  // anchor, depth, doc of the two keys
  };
  using Row = int4;  // anchor, depth, doc of a row

  __device__ __forceinline__ int4 prop(int b, int i) const {
    return i < p.s.rows ? p.props[(long long)b * p.s.rows + i]
                        : make_int4(0, 0, -1, 0);
  }

  // key data: key key0 + r's (anchor, depth, doc) at 16 r, by thread r < 64
  __device__ __forceinline__ void stage_key(unsigned char* key_data, int b,
                                            int key0, int r) const {
    const int4 x = prop(b, key0 + r);
    *reinterpret_cast<int4*>(key_data + r * 16) =
        make_int4(x.x, x.y, x.w != 0 ? x.z : INT_MIN, 0);
  }

  __device__ __forceinline__ Keys keys(const unsigned char* key_data,
                                       const DkvBlock&, int kr0) const {
    const int4 x = *reinterpret_cast<const int4*>(key_data + kr0 * 16);
    const int4 y = *reinterpret_cast<const int4*>(key_data + kr0 * 16 + 128);
    return {x.x, x.y, x.z, y.x, y.y, y.z};
  }

  __device__ __forceinline__ Row row(const unsigned char* mask, int r) const {
    return *reinterpret_cast<const int4*>(mask + r * 16);
  }

  __device__ __forceinline__ bool allow(const Keys& k, int kx, Row q) const {
    const int ka = kx ? k.a1 : k.a0;
    const int kd = kx ? k.d1 : k.d0;
    const int kc = kx ? k.c1 : k.c0;
    return q.z == kc && ((kd == 0 && q.x >= ka) || (q.x == ka && q.y >= kd));
  }

  // row q0 + r's properties, the row's own conditions folded into the doc
  __device__ __forceinline__ bool stage_row(unsigned char* mask,
                                            const DkvBlock& blk, int q0,
                                            int r) const {
    int4 x = prop(blk.b, q0 + r);
    x.z = x.w != 0 && x.z != -1 ? x.z : INT_MIN + 1;
    *reinterpret_cast<int4*>(mask + r * 16) = x;
    return true;
  }

  // the caller's full-tile flag of (q tile, the block's key tile), the
  // list entry's tile bit
  __device__ __forceinline__ bool tile_free(int tile_bit, bool) const {
    return tile_bit != 0;
  }
};

// One block owns 64 keys of one (batch, kv head): blockIdx / KVH picks the
// (batch, key tile) pair from `order` (the caller sorts the pairs by their
// live q tiles, descending, so the heaviest blocks start first), blockIdx %
// KVH the kv head. The block stages its keys' properties, lists the live q
// tiles of its key tile (column `ktile` of the batch's table) and streams
// the group's query heads over them (dkv_stream.cuh).
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    cod_bwd_dkv_kernel(const __grid_constant__ CodDkvParams p) {
  using L = DkvStreamSmem<D>;
  extern __shared__ unsigned char dkv_smem[];
  unsigned char* smem = align1024(dkv_smem);
  int* list = reinterpret_cast<int*>(smem + L::kList);
  const int NT = p.NT;
  const int pair = p.order[blockIdx.x / p.s.KVH];
  const int b = pair / NT;
  const int ktile = pair % NT;
  dkv_init_block<D>(smem, b, blockIdx.x % p.s.KVH, ktile * kTileRows);

  const CodRows pol{p};
  if (threadIdx.x < kTileRows) {
    pol.stage_key(smem + L::kKeys, b, ktile * kTileRows, threadIdx.x);
  }
  // the live q tiles of the key tile, each with its full-tile flag as the
  // tile bit
  const long long column = (long long)b * NT * NT + ktile;
  for (int i = threadIdx.x; i < NT; i += blockDim.x) {
    const long long at = column + (long long)i * NT;
    list[i] = p.tiles[at] != 0 ? 1 + 2 * (p.full[at] != 0) : 0;
  }
  compact_list(list, NT, &block_info<D>(smem)->n_list);
  dkv_stream_block<D>(p.s, pol, smem);
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
  p.out = nullptr;
  p.m = p.l = nullptr;
  long long* dst[9] = {&p.q_sb, &p.q_sh, &p.q_ss, &p.k_sb, &p.k_sh,
                       &p.k_ss, &p.v_sb, &p.v_sh, &p.v_ss};
  for (int i = 0; i < 9; ++i) *dst[i] = strides[i];
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.T = T;
  p.NT = (T + kBlockN - 1) / kBlockN;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  // the backward kernels' shared memory grows with the tile list
  if (dkv_smem_bytes(D, p.NT) > 227 * 1024 ||
      dq_smem_bytes(D, p.NT * 4) > 227 * 1024) {
    return cudaErrorInvalidValue;
  }
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
// contiguous; m, l, delta are [B, H, T] fp32; full: [B, NT, NT] int32, 1
// where every pair of the tile pair is allowed; order: [B * NT] int32, the
// (batch, q tile) pairs b * NT + qtile in launch order. The other
// arguments are those of the forward; the strides of q, k and v must be
// multiples of 8 elements and their bases 16-byte aligned (the tensor
// maps').
extern "C" int cod_attention_bwd_dq(const void* const* tensors,
                                    const long long* strides,
                                    const void* props, const int* tiles,
                                    const int* full, const int* order,
                                    const void* dout, const float* m,
                                    const float* l, const float* delta,
                                    void* dq, int B, int H, int KVH, int T,
                                    int D, void* stream) {
  Params p;
  const int e = fill_params(p, tensors, strides, props, tiles, B, H, KVH, T, D);
  if (e != cudaSuccess) return e;
  CodDqParams d;
  if (!fill_dq_stream(d.s, tensors[0], strides, tensors[1], strides + 3,
                      tensors[2], strides + 6, T, nullptr, nullptr, nullptr,
                      nullptr, 0, dout, m, l, delta, dq, B, H, KVH, T, D,
                      kDqHeads)) {
    return cudaErrorInvalidValue;
  }
  d.props = static_cast<const int4*>(props);
  d.tiles = tiles;
  d.full = full;
  d.order = order;
  d.NT = p.NT;
  const long long blocks = (long long)B * p.NT * KVH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = dq_smem_bytes(D, p.NT * 4);
  return D == 128 ? launch_hopper(cod_bwd_dq_kernel<128>, smem, d, blocks, st)
                  : launch_hopper(cod_bwd_dq_kernel<64>, smem, d, blocks, st);
}

// Backward, dk and dv [B, KVH, T, D] (contiguous bf16), summed over the
// query heads of each group. full: [B, NT, NT] int32, 1 where every pair
// of the tile pair is allowed (whole tiles inside T); order: [B * NT] int32,
// the (batch, key tile) pairs b * NT + ktile in launch order. The other
// arguments are those of the dq kernel; the strides of q, k and v must be
// multiples of 8 elements and their bases 16-byte aligned (the tensor
// maps').
extern "C" int cod_attention_bwd_dkv(const void* const* tensors,
                                     const long long* strides,
                                     const void* props, const int* tiles,
                                     const int* full, const int* order,
                                     const void* dout, const float* m,
                                     const float* l, const float* delta,
                                     void* dk, void* dv, int B, int H,
                                     int KVH, int T, int D, void* stream) {
  Params p;
  const int e = fill_params(p, tensors, strides, props, tiles, B, H, KVH, T, D);
  if (e != cudaSuccess) return e;
  CodDkvParams d;
  if (!fill_stream(d.s, tensors[0], strides, tensors[1], strides + 3,
                   tensors[2], strides + 6, dout, m, l, delta, dk, dv, B, H,
                   KVH, T, T, D)) {
    return cudaErrorInvalidValue;
  }
  d.props = static_cast<const int4*>(props);
  d.tiles = tiles;
  d.full = full;
  d.order = order;
  d.NT = p.NT;
  const long long blocks = (long long)B * p.NT * KVH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = dkv_smem_bytes(D, p.NT);
  return D == 128 ? launch_hopper(cod_bwd_dkv_kernel<128>, smem, d, blocks, st)
                  : launch_hopper(cod_bwd_dkv_kernel<64>, smem, d, blocks, st);
}
