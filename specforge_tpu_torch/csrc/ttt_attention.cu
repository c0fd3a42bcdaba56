// TTT branch flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of specforge_tpu/ops/attention_pallas.py
// reached through `ttt_flash_attention` and `ttt_flash_attention_flat`:
// `_fwd_kernel` / `_fwd_pallas` (forward), and the two kernels of
// `_bwd_pallas`: `_bwd_dq_kernel` (dq plus the branch dk/dv) and
// `_bwd_dkv_kernel` (the causal block's dk/dv).
//
// What it computes. Step t of the EAGLE3 TTT unroll attends, under ONE joint
// softmax, (a) causally to the step-0 keys/values, masked by `key_valid`, and
// (b) to one query-aligned diagonal key per earlier branch. The diagonal
// branch logits are NOT masked by `key_valid`, as in the TPU kernel. The
// output goes straight to the [B, S, H*D] layout the o_proj reads; the row
// statistics m (max) and l (sum of exp) are saved in fp32, natural-log
// units, for the backward. A row with no allowed key gets out = 0,
// m = -1e30 (finite, as in the TPU kernel) and l = 0.
// The backward recomputes p = exp(s - m) / l from them, with
// delta = rowsum(dO * O) given, and forms ds = p * (dO V^T - delta):
//   dq = scale * (ds K + sum_b ds_b k_b),  dk = scale * ds^T Q,
//   dv = p^T dO,  dk_b = scale * ds_b q,  dv_b = p_b dO,
// dk_b and dv_b summed over the H / KVH query heads of each kv head.
//
// What bounds it on this card. Per launch the causal block of the forward
// costs 2*B*H*S^2*D FLOP (68.7 GFLOP at B=2, H=32, S=2048, D=128: 69 us at
// the bf16 tensor-core peak) and moves 84-185 MB over 0..6 branches (q, out,
// every key and value once: 25-55 us at 3.35 TB/s), so it is bound by
// tensor-core operations. The backward's dq kernel does three such causal
// products (s, dp, dq), the dk/dv kernel four (s, dp, dv, dk): 0.1092 and
// 0.1375 ms at the EAGLE3 shape, averaged over the main path's 0..6
// branches, against about 0.2 GB moved for the pair (60 us): both are bound
// by operations too.
//
// All three kernels share one shape. Every tile product is a warpgroup
// product, `wgmma.mma_async` (bf16 in, fp32 accumulate), from two consumer
// warpgroups; B always comes from shared memory through a 128-byte-swizzle
// descriptor, A from shared memory or, for p and ds, straight from the
// registers the previous product left them in. A producer warpgroup gives
// up its registers (`setmaxnreg`: 24 for it, 240 for each consumer) and one
// of its warps keeps a ring of tile stages in flight: each 64-row tile of
// q, dO, k or v is a TMA copy (`cp.async.bulk.tensor`, 64 x 64 boxes of a
// 4-D tensor map over the strided view, swizzled as the descriptors read
// it, rows past S zero-filled) that completes on the stage's `mbarrier`.
// The copies are issued first; then the producer's lanes write what travels
// with the tile (key_valid bits and an "all valid" flag, row statistics)
// into the same stage and arrive on it, so those global loads overlap the
// copies and never stall the consumers, which read them only after waiting
// on the stage. Consumers release a stage on a second barrier. m travels in
// log2 units, m * log2(e): p = 2^(s * scale * log2(e) - m2) is one FMA and
// one MUFU a score, the mask a select to -inf, and tiles that need no mask
// (off the diagonal, every key valid) skip it. No atomics: every sum is
// taken in a fixed order, and two runs give the same bits. ptxas reports no
// wgmma serialization for these kernels; keeping it so bounds the registers
// live beside the accumulators (k-steps unrolled, descriptors pinned).
//
// The forward: a block owns one q tile (64 rows) of one (batch, kv head)
// and up to four query heads of its group (packed GQA: two per consumer
// warpgroup, O of each in fp32 registers; a group of eight is two chunks of
// four in two blocks, since no sum crosses heads), so each K/V tile is
// staged once for all of them, in a ring of four 32 KB stages (D = 128)
// beside the 64 KB of Q tiles, which come in once, a barrier each. Per K/V
// tile a warpgroup issues S = Q K^T of both its heads at once; head a's
// softmax runs while the tensor cores form head b's S, and head b's while
// they form head a's O += P V (P from registers, V through the MN-major
// descriptor); both P V products retire inside the tile, which then
// releases its stage (an accumulator kept in flight across the loop makes
// ptxas serialize every wgmma). The branches' k_b / v_b rows of the q tile
// follow the causal tiles through the same ring, once per kv head: q.k_b is
// the diagonal of a 64 x 64 tile product on the tensor cores (idle by
// then), folded into (m, l, O) in fp32 with each v_b entry read once for
// both heads of a warpgroup. O / l leaves as bf16 through shared memory in
// whole rows of [B, S, H*D]. Blocks are issued longest rows first (the q
// tile is the grid's slow index).
// dk/dv: a block owns 64 keys of one (batch, kv head) and walks the G * nq
// (query head, q tile) items of its group, from the diagonal down;
// warpgroup 0 takes the first half of the items and warpgroup 1 the second
// (at G = 4 two heads each, with their own rings), each accumulating dk and
// dv in fp32 registers; the two partials are added through shared memory
// at the end. Blocks are issued with the key tile as the slow index, so
// the heaviest start first: at the EAGLE3 shape 512 blocks, one per SM at a
// time, from 128 items (64 a warpgroup) for the first key tile down to 4.
// The stream is split inside the block, never across blocks, so no
// partial sums leave it. Inside a warpgroup the products come in groups, so
// the exp of p runs while the tensor cores form dp, and dv += p^T dO while
// ds is formed.
// dq: a block owns one q tile of one (batch, kv head) and the group's query
// heads (packed GQA: four resident at a time, two per consumer warpgroup,
// dq in fp32 registers), so each K/V tile is staged once for all of them;
// each head's Q/dO tiles have their own barrier, and a warpgroup's second
// head follows the first K/V tile, so the products start after 64 KB. The
// branches' k_b / v_b rows follow the causal tiles through the ring,
// ds_b k_b is added to dq in fp32 from the staged k_b, and the group sums of
// dk_b / dv_b are taken in the block over the heads in order, in fp32, and
// written once as [NB, B, KVH, S, D] (past four heads a group is summed
// chunk by chunk through an fp32 workspace). dq leaves through shared
// memory in whole rows.

#include <limits.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxKeys = 8;  // the step-0 block plus up to 7 branches
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kStages = 2;     // tile stages of each backward ring
constexpr int kFwdStages = 4;  // K/V stages of the forward's ring
constexpr int kHeadsPerBlock = 4;   // query heads resident at once (a chunk)
constexpr int kSlots = kHeadsPerBlock / 2;  // heads a consumer warpgroup owns

// sum of the 8 products of two 16-byte bf16 chunks in shared memory
__device__ __forceinline__ float dot8(const unsigned char* a,
                                      const unsigned char* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = unpack_bf16(xs[e]);
    const float2 v = unpack_bf16(ys[e]);
    acc += u.x * v.x + u.y * v.y;
  }
  return acc;
}

// The operands of the three kernels: tensor maps over the strided views and
// plain pointers for what is not a tile.
struct Params {
  CUtensorMap tm_q;             // q [B, H, S, D] view
  CUtensorMap tm_do;            // backward: dout [B, S, H*D] as [B, H, S, D]
  CUtensorMap tm_k[kMaxKeys];   // keys [B, KVH, S, D], step-0 block first
  CUtensorMap tm_v[kMaxKeys];   // values
  const int* valid;             // [B, S], 1 = attendable key of the causal block
  __nv_bfloat16* out;           // forward: [B, S, H*D]
  float* m_out;                 // forward: [B, H, S], natural-log units
  float* l_out;                 // forward: [B, H, S]
  const float* m;               // backward: [B, H, S]
  const float* l;               // backward: [B, H, S]
  const float* delta;           // backward: [B, H, S], rowsum(dO * O)
  __nv_bfloat16* dq;            // [B, H, S, D], contiguous
  __nv_bfloat16* dkb;           // [NB, B, KVH, S, D]: branch dk, group-summed
  __nv_bfloat16* dvb;           // [NB, B, KVH, S, D]
  float* ws;                    // [2, NB, B, KVH, S, D] fp32, when H/KVH > 4
  __nv_bfloat16* dk;            // [B, KVH, S, D], contiguous
  __nv_bfloat16* dv;            // [B, KVH, S, D], contiguous
  int B, H, KVH, S, n_branches;
  float scale;
};

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of the forward kernel, byte offsets from a 1024-aligned base.
template <int D>
struct FwdSmem {
  static constexpr int kTile = kTileRows * D * 2;
  static constexpr int kQ = 0;                          // [4] Q tiles
  static constexpr int kRing = kHeadsPerBlock * kTile;  // [kFwdStages]
  static constexpr int kStage = 2 * kTile;              // K then V
  // [kFwdStages][64] keys' validity, then [kFwdStages] "all valid" flags
  static constexpr int kValid = kRing + kFwdStages * kStage;
  static constexpr int kBars =
      (kValid + kFwdStages * (kTileRows + 1) * 4 + 7) / 8 * 8;
  static constexpr int kBytes =
      kBars + (2 * kFwdStages + kHeadsPerBlock) * 8 + 1024;  // + slack
};

// One head's online-softmax step over a 64 x 64 tile of raw scores q.k
// (this thread's rows r0 / r1 x keys 8j + 2t + {0, 1}): kMasked sets the
// keys that are invalid (`valid`, the stage's bits) or, on the diagonal
// tile, above the row to -inf. The rows' running max m2 (log2 units, never
// below -1e30, so 2^(m2_old - m2_new) never meets inf - inf) and this
// thread's partial sums ls are updated, the accumulator o rescaled, and
// p = 2^(s * scale2 - m2) packed as the A fragments of O += P V.
template <int D, bool kMasked>
__device__ __forceinline__ void fwd_softmax(float (&s)[32], float (&o)[D / 2],
                                            float (&m2)[2], float (&ls)[2],
                                            uint32_t (&pa)[4][4],
                                            const int* valid, float scale2,
                                            int r0, int r1, bool diag, int t) {
  const float minus_inf = __int_as_float(0xff800000);
  float mx0 = minus_inf, mx1 = minus_inf;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if constexpr (kMasked) {
      const int kc = 8 * j + 2 * t;
      const int2 vv = *reinterpret_cast<const int2*>(valid + kc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const bool ok = ((e & 1) ? vv.y : vv.x) != 0 &&
                        (!diag || kc + (e & 1) <= row);
        s[4 * j + e] = ok ? s[4 * j + e] : minus_inf;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float n0 = fmaxf(m2[0], quad_max(mx0) * scale2);
  const float n1 = fmaxf(m2[1], quad_max(mx1) * scale2);
  const float c0 = ex2(m2[0] - n0);
  const float c1 = ex2(m2[1] - n1);
  m2[0] = n0;
  m2[1] = n1;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i] *= c0;
    o[4 * i + 1] *= c0;
    o[4 * i + 2] *= c1;
    o[4 * i + 3] *= c1;
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = ex2(fmaf(s[4 * j], scale2, -n0));
    const float p1 = ex2(fmaf(s[4 * j + 1], scale2, -n0));
    const float p2 = ex2(fmaf(s[4 * j + 2], scale2, -n1));
    const float p3 = ex2(fmaf(s[4 * j + 3], scale2, -n1));
    l0 += p0 + p1;
    l1 += p2 + p3;
    pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  ls[0] = fmaf(ls[0], c0, l0);
  ls[1] = fmaf(ls[1], c1, l1);
}

// A consumer warpgroup of the forward with kN (1 or 2) heads, local heads
// lh0.. of the block's chunk (global heads h0 + lh0..): the causal K/V
// tiles, the branches, and the epilogue. Head a's and head b's S = Q K^T
// are issued together; a's softmax runs while the tensor cores form b's S,
// b's while they form a's O += P V. A stage is released once both P V
// products of its tile are done.
template <int D, int kN>
__device__ __forceinline__ void fwd_consumer(const Params& p,
                                             unsigned char* smem, int lh0,
                                             int h0, int b, int qtile) {
  using L = FwdSmem<D>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kFwdStages;
  uint64_t* q_full = empty + kFwdStages;
  const int* sValid = reinterpret_cast<const int*>(smem + L::kValid);
  const int S = p.S;
  const int q0 = qtile * kTileRows;
  const int n_ktiles = qtile + 1;  // causal: the key tiles up to the diagonal
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's two rows of the q tile
  const int r1 = r0 + 8;
  const float scale2 = p.scale * kLog2e;
  const uint32_t sQa = smem_u32(smem + L::kQ + lh0 * L::kTile);
  const uint32_t sQb = sQa + L::kTile;

  float o[kN][D / 2];
  float m2[kN][2], ls[kN][2];
#pragma unroll
  for (int h = 0; h < kN; ++h) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[h][i] = 0.f;
    m2[h][0] = m2[h][1] = kNegInf;
    ls[h][0] = ls[h][1] = 0.f;
  }
  mbar_wait(&q_full[lh0], 0);
  for (int j = 0; j < n_ktiles; ++j) {
    const int st = j % kFwdStages;
    const uint32_t sK = smem_u32(smem + L::kRing + st * L::kStage);
    const uint32_t sV = sK + L::kTile;
    const int* valid = sValid + st * kTileRows;
    const bool diag = j == qtile;
    mbar_wait(&full[st], (j / kFwdStages) & 1);
    // the flag is read only after the wait: the producer writes it with
    // the stage
    const bool masked = diag || sValid[kFwdStages * kTileRows + st] == 0;
    float sa[32], sb[32];
    uint32_t pa[4][4], pb[4][4];
    wgmma_fence();
    wgmma_tile_product<D>(sa, sQa, sK);
    wgmma_commit();
    if constexpr (kN == 2) {
      if (j == 0) mbar_wait(&q_full[lh0 + 1], 0);
      wgmma_fence();  // after the branch: else ptxas inserts it there (C7520)
      wgmma_tile_product<D>(sb, sQb, sK);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sa);
    if (masked) {
      fwd_softmax<D, true>(sa, o[0], m2[0], ls[0], pa, valid, scale2, r0, r1,
                           diag, t);
    } else {
      fwd_softmax<D, false>(sa, o[0], m2[0], ls[0], pa, valid, scale2, r0,
                            r1, diag, t);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o[0], pa[kk], sV, kk);
    wgmma_commit();
    if constexpr (kN == 2) {
      wgmma_wait<1>();
      fence_regs(sb);
      if (masked) {
        fwd_softmax<D, true>(sb, o[1], m2[1], ls[1], pb, valid, scale2, r0,
                             r1, diag, t);
      } else {
        fwd_softmax<D, false>(sb, o[1], m2[1], ls[1], pb, valid, scale2, r0,
                              r1, diag, t);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o[1], pb[kk], sV, kk);
      wgmma_commit();
    }
    // both P V products retire inside the tile: an accumulator in flight
    // across the loop's back edge makes ptxas serialize every wgmma (C7514)
    wgmma_wait<0>();
    fence_regs(pa);
#pragma unroll
    for (int h = 0; h < kN; ++h) fence_regs(o[h]);
    if constexpr (kN == 2) fence_regs(pb);
    mbar_arrive(&empty[st]);
  }

  // the rows' whole sums, then the diagonal branches: one query-aligned key
  // per earlier TTT step, not masked by key_valid, folded into (m, l, O)
#pragma unroll
  for (int h = 0; h < kN; ++h) {
    ls[h][0] = quad_sum(ls[h][0]);
    ls[h][1] = quad_sum(ls[h][1]);
  }
  for (int br = 0; br < p.n_branches; ++br) {
    const int it = n_ktiles + br;
    const int st = it % kFwdStages;
    const unsigned char* kb = smem + L::kRing + st * L::kStage;
    const unsigned char* vb = kb + L::kTile;
    mbar_wait(&full[st], (it / kFwdStages) & 1);
    // q.k_b of rows r0 and r1 for every head: the diagonal of S = Q k_b^T,
    // a 64 x 64 tile product on the tensor cores (idle here); the lane of
    // the quad that holds a row's diagonal entry passes it to the others
    float w[kN][2];
#pragma unroll
    for (int h = 0; h < kN; ++h) {
      // one head at a time: two 64 x 64 accumulators beside both heads' O
      // spill
      float sx[32];
      wgmma_fence();
      wgmma_tile_product<D>(sx, sQa + h * L::kTile, smem_u32(kb));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sx);
      // row r0's diagonal is column 16 * warp + g: entry 8 * warp + (g & 1)
      // of lane t = g / 2; row r1's entry 8 * warp + 6 + (g & 1)
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int ww = 0; ww < 4; ++ww) {
        if (ww == warp) {
          d0 = (g & 1) ? sx[8 * ww + 1] : sx[8 * ww];
          d1 = (g & 1) ? sx[8 * ww + 7] : sx[8 * ww + 6];
        }
      }
      const int src = (lane & ~3) | (g >> 1);
      w[h][0] = __shfl_sync(0xffffffffu, d0, src);
      w[h][1] = __shfl_sync(0xffffffffu, d1, src);
    }
    float c[kN][2], e[kN][2];
#pragma unroll
    for (int h = 0; h < kN; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x = w[h][r] * scale2;
        const float n = fmaxf(m2[h][r], x);
        c[h][r] = ex2(m2[h][r] - n);
        e[h][r] = ex2(x - n);
        m2[h][r] = n;
        ls[h][r] = fmaf(ls[h][r], c[h][r], e[h][r]);
      }
    }
    // O = O * c + e * v_b, each v_b entry read once for both heads
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const float2 va = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(vb + swz(r0, jj) + 4 * t));
      const float2 vc = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(vb + swz(r1, jj) + 4 * t));
#pragma unroll
      for (int h = 0; h < kN; ++h) {
        o[h][4 * jj] = fmaf(o[h][4 * jj], c[h][0], e[h][0] * va.x);
        o[h][4 * jj + 1] = fmaf(o[h][4 * jj + 1], c[h][0], e[h][0] * va.y);
        o[h][4 * jj + 2] = fmaf(o[h][4 * jj + 2], c[h][1], e[h][1] * vc.x);
        o[h][4 * jj + 3] = fmaf(o[h][4 * jj + 3], c[h][1], e[h][1] * vc.y);
      }
    }
    mbar_arrive(&empty[st]);
  }

  // O / l as bf16, staged in the head's own Q tile (read for the last time
  // above) and written in whole rows of [B, S, H*D]; m back in natural-log
  // units, -1e30 where the row saw no key, and l
  const long long HD = (long long)p.H * D;
#pragma unroll
  for (int h = 0; h < kN; ++h) {
    stage_tile<D>(smem + L::kQ + (lh0 + h) * L::kTile, o[h],
                  1.f / fmaxf(ls[h][0], 1e-30f), 1.f / fmaxf(ls[h][1], 1e-30f),
                  r0, t);
    if (t == 0) {
      const long long base = ((long long)b * p.H + h0 + lh0 + h) * S + q0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = e == 0 ? r0 : r1;
        if (q0 + r < S) {
          p.m_out[base + r] = m2[h][e] <= kNegInf ? kNegInf : m2[h][e] * kLn2;
          p.l_out[base + r] = ls[h][e];
        }
      }
    }
  }
  warpgroup_sync(threadIdx.x / 128);
  for (int h = 0; h < kN; ++h) {
    copy_tile_rows<D>(p.out + ((long long)b * S + q0) * HD +
                          (long long)(h0 + lh0 + h) * D,
                      HD, smem + L::kQ + (lh0 + h) * L::kTile, S - q0, tid);
  }
}

// The forward. A block owns one q tile of one (batch, kv head) and a chunk
// of up to four query heads of its group (blockIdx: q tile, counted from
// the last, slowest; then batch, kv head, chunk). A producer warp stages
// the chunk's Q tiles once (consumer warpgroup 0's first head, then 1's,
// then after the first K/V tile the second heads), then the causal K/V
// tiles with their keys' validity and "all valid" flag, then each
// branch's k_b / v_b rows of the q tile, through a ring of kFwdStages.
// Consumer warpgroup 0 owns the first (nh + 1) / 2 heads, warpgroup 1 the
// rest; a warpgroup with none still releases every stage.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    ttt_fwd_kernel(const __grid_constant__ Params p) {
  using L = FwdSmem<D>;
  constexpr int kPanels = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kFwdStages;
  uint64_t* q_full = empty + kFwdStages;  // [kHeadsPerBlock], one per head
  int* sValid = reinterpret_cast<int*>(smem + L::kValid);

  const int S = p.S;
  const int KVH = p.KVH;
  const int G = p.H / KVH;
  const int n_chunks = (G + kHeadsPerBlock - 1) / kHeadsPerBlock;
  const int per_qtile = p.B * KVH * n_chunks;
  const int n_qtiles = (S + kTileRows - 1) / kTileRows;
  const int qtile = n_qtiles - 1 - blockIdx.x / per_qtile;  // longest first
  const int rest = blockIdx.x % per_qtile;
  const int b = rest / (KVH * n_chunks);
  const int kvh = rest / n_chunks % KVH;
  const int chunk = rest % n_chunks;
  const int h0 = kvh * G + chunk * kHeadsPerBlock;
  const int nh = min(kHeadsPerBlock, G - chunk * kHeadsPerBlock);
  const int n0 = (nh + 1) / 2;  // the heads of consumer warpgroup 0
  const int q0 = qtile * kTileRows;
  const int n_items = qtile + 1 + p.n_branches;  // causal tiles, branches
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kFwdStages; ++i) {
      mbar_init(&full[i], 32);    // the producer warp's lanes
      mbar_init(&empty[i], 256);  // both consumer warpgroups
    }
    for (int i = 0; i < kHeadsPerBlock; ++i) mbar_init(&q_full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x / 32 != 8) return;  // one producer warp
    const int lane = threadIdx.x % 32;
    auto load_q = [&](int lh) {
      if (lane == 0) {
        mbar_expect_tx(&q_full[lh], L::kTile);
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load(smem + L::kQ + lh * L::kTile + pn * kPanelBytes, &p.tm_q,
                   &q_full[lh], pn * 64, q0, h0 + lh, b);
        }
        mbar_arrive(&q_full[lh]);
      }
    };
    load_q(0);
    if (n0 < nh) load_q(n0);
    for (int j = 0; j < n_items; ++j) {
      const int st = j % kFwdStages;
      mbar_wait(&empty[st], ((j / kFwdStages) & 1) ^ 1);
      const bool causal = j <= qtile;
      if (lane == 0) {
        unsigned char* dst = smem + L::kRing + st * L::kStage;
        const int src = causal ? 0 : j - qtile;
        const int row = causal ? j * kTileRows : q0;
        mbar_expect_tx(&full[st], 2 * L::kTile);
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load(dst + pn * kPanelBytes, &p.tm_k[src], &full[st], pn * 64,
                   row, kvh, b);
          tma_load(dst + L::kTile + pn * kPanelBytes, &p.tm_v[src], &full[st],
                   pn * 64, row, kvh, b);
        }
      }
      if (causal) {
        bool all = true;
        for (int r = lane; r < kTileRows; r += 32) {
          const int key = j * kTileRows + r;
          const bool ok = key < S && p.valid[(long long)b * S + key] != 0;
          sValid[st * kTileRows + r] = ok;
          all = all && ok;
        }
        // and whether the tile needs no key mask at all
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) sValid[kFwdStages * kTileRows + st] = all;
      }
      mbar_arrive(&full[st]);
      if (j == 0) {
        for (int lh = 1; lh < nh; ++lh) {
          if (lh != n0) load_q(lh);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int n_own = wg == 0 ? n0 : nh - n0;
    const int lh0 = wg == 0 ? 0 : n0;
    if (n_own == 2) {
      fwd_consumer<D, 2>(p, smem, lh0, h0, b, qtile);
    } else if (n_own == 1) {
      fwd_consumer<D, 1>(p, smem, lh0, h0, b, qtile);
    } else {
      // no head here (a group of one): pass every stage on
      for (int j = 0; j < n_items; ++j) {
        const int st = j % kFwdStages;
        mbar_wait(&full[st], (j / kFwdStages) & 1);
        mbar_arrive(&empty[st]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// backward kernels
// --------------------------------------------------------------------------

// Shared memory of the dk/dv kernel, byte offsets from a 1024-aligned base.
template <int D>
struct DkvSmem {
  static constexpr int kTile = kTileRows * D * 2;  // D / 64 swizzled panels
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kStage = 2 * kTile;         // Q, then dO
  static constexpr int kRing = 2 * kTile;          // [2 rings][kStages]
  static constexpr int kRingBytes = kStages * kStage;
  static constexpr int kStats = kRing + 2 * kRingBytes;  // [2][kStages][3][64]
  static constexpr int kValid = kStats + 2 * kStages * 3 * kTileRows * 4;
  static constexpr int kBars = kValid + kTileRows * 4;
  static constexpr int kBytes = kBars + 9 * 8 + 1024;  // + alignment slack
  // the epilogue hands one fp32 [64 x D] partial across in a ring's memory,
  // and stages a bf16 result behind it
  static_assert(kTileRows * D * 6 <= kRingBytes, "epilogue does not fit");
};

// The row statistics of rows q0 + lane and q0 + lane + 32 of one (batch,
// head), from its offset sb in the [B, H, S] arrays: m in log2 units, 1/l,
// delta; rows past S get 0 (so their p is 0). All loads are issued first.
__device__ __forceinline__ void load_row_stats(float* m2, float* il,
                                               float* dl, const Params& p,
                                               long long sb, int q0, int S,
                                               int lane) {
  float mv[2], lv[2], dv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + lane + 32 * e;
    const bool in = row < S;
    mv[e] = in ? p.m[sb + row] : 0.f;
    lv[e] = in ? p.l[sb + row] : 0.f;
    dv[e] = in ? p.delta[sb + row] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = lane + 32 * e;
    const bool in = q0 + r < S;
    m2[r] = mv[e] * kLog2e;
    il[r] = in ? 1.f / fmaxf(lv[e], 1e-30f) : 0.f;
    dl[r] = dv[e];
  }
}

// p^T = 2^(s^T * scale2 - m2) / l in place, over this thread's 32 entries
// of a dk/dv tile (keys kr0 / kr1 x queries 8j + 2t + {0, 1}), with the
// row statistics `st` (m2, 1/l) of the q tile; kMasked applies the keys'
// validity and the causal diagonal (the plain instance serves the tiles
// that need neither)
template <bool kMasked>
__device__ __forceinline__ void dkv_probs(float (&s)[32], const float* st,
                                          float scale2, int kr0, int kr1,
                                          bool kv0, bool kv1, bool diag,
                                          int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qc = 8 * j + 2 * t;
    const float2 mq = *reinterpret_cast<const float2*>(st + qc);
    const float2 il = *reinterpret_cast<const float2*>(st + kTileRows + qc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m_ = (e & 1) ? mq.y : mq.x;
      const float il_ = (e & 1) ? il.y : il.x;
      bool ok = true;
      if constexpr (kMasked) {
        const int key = e < 2 ? kr0 : kr1;
        ok = (e < 2 ? kv0 : kv1) && (!diag || key <= qc + (e & 1));
      }
      s[4 * j + e] = ex2(masked_logit2(ok, s[4 * j + e], scale2, m_)) * il_;
    }
  }
}

// p = 2^(s * scale2 - m2) / l in place, over this thread's 32 entries of a
// dq tile (rows r0 / r1 x keys 8j + 2t + {0, 1}), with the rows' m2 and
// 1/l; kMasked applies the keys' validity `valid` and the causal diagonal
template <bool kMasked>
__device__ __forceinline__ void dq_probs(float (&s)[32], const int* valid,
                                         float scale2, const float (&m2)[2],
                                         const float (&il)[2], int r0, int r1,
                                         bool diag, int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int kc = 8 * jj + 2 * t;
    int2 vv = make_int2(1, 1);
    if constexpr (kMasked) vv = *reinterpret_cast<const int2*>(valid + kc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool ok = true;
      if constexpr (kMasked) {
        const int row = e < 2 ? r0 : r1;
        ok = ((e & 1) ? vv.y : vv.x) != 0 && (!diag || kc + (e & 1) <= row);
      }
      s[4 * jj + e] =
          ex2(masked_logit2(ok, s[4 * jj + e], scale2, m2[e >> 1])) *
          il[e >> 1];
    }
  }
}

// dk/dv of the causal block. A block owns 64 keys of one (batch, kv head):
// K and V are loaded once. Its work is the stream of (query head of the
// group, q tile from the diagonal down) pairs, G * nq items; consumer
// warpgroup 0 takes the first half of the stream and warpgroup 1 the second
// (at G = 4: two query heads each), each with its own ring of Q / dO tiles
// and their row statistics, fed by one producer warp. Each warpgroup keeps
// dk and dv of the 64 keys in fp32 registers; at the end warpgroup 0 hands
// its dv and warpgroup 1 its dk across through shared memory, and each adds
// the other's partial to its own: dk = dk0 + dk1, dv = dv1 + dv0, a fixed
// order. Blocks are issued with the key tile as the slow index, so the key
// tiles with the most q tiles start first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    ttt_bwd_dkv_kernel(const __grid_constant__ Params p) {
  using L = DkvSmem<D>;
  constexpr int kPanels = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);  // [2][2]
  uint64_t* empty = full + 2 * kStages;                            // [2][2]
  uint64_t* kv_full = empty + 2 * kStages;
  float* stats_all = reinterpret_cast<float*>(smem + L::kStats);
  int* sValid = reinterpret_cast<int*>(smem + L::kValid);

  const int S = p.S;
  const int H = p.H;
  const int KVH = p.KVH;
  const int G = H / KVH;
  const int BK = p.B * KVH;
  const int ktile = blockIdx.x / BK;  // slow index: heaviest blocks first
  const int b = (blockIdx.x % BK) / KVH;
  const int kvh = blockIdx.x % KVH;
  const int key0 = ktile * kTileRows;
  const int nq = (S + kTileRows - 1) / kTileRows - ktile;
  const int n_items = G * nq;
  const int half = (n_items + 1) / 2;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kStages; ++i) {
      mbar_init(&full[i], 32);    // the producer warp's lanes
      mbar_init(&empty[i], 128);  // the consuming warpgroup's threads
    }
    mbar_init(kv_full, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: warp w feeds ring w; warp 0 first stages K, V and the keys'
    // validity
    reg_dealloc<kProducerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    if (warp < 2) {
      if (warp == 0) {
        if (lane == 0) {
          mbar_expect_tx(kv_full, 2 * L::kTile);
          for (int pn = 0; pn < kPanels; ++pn) {
            tma_load(smem + L::kK + pn * kPanelBytes, &p.tm_k[0], kv_full,
                     pn * 64, key0, kvh, b);
            tma_load(smem + L::kV + pn * kPanelBytes, &p.tm_v[0], kv_full,
                     pn * 64, key0, kvh, b);
          }
        }
        for (int r = lane; r < kTileRows; r += 32) {
          const int key = key0 + r;
          sValid[r] = key < S && p.valid[(long long)b * S + key] != 0;
        }
        mbar_arrive(kv_full);
      }
      const int first = warp == 0 ? 0 : half;
      const int count = warp == 0 ? half : n_items - half;
      for (int i = 0; i < count; ++i) {
        const int slot = warp * kStages + i % kStages;
        mbar_wait(&empty[slot], ((i / kStages) & 1) ^ 1);
        const int item = first + i;
        const int h = kvh * G + item / nq;
        const int q0 = (ktile + item % nq) * kTileRows;
        if (lane == 0) {
          unsigned char* dst = smem + L::kRing + slot * L::kStage;
          mbar_expect_tx(&full[slot], 2 * L::kTile);
          for (int pn = 0; pn < kPanels; ++pn) {
            tma_load(dst + pn * kPanelBytes, &p.tm_q, &full[slot], pn * 64,
                     q0, h, b);
            tma_load(dst + L::kTile + pn * kPanelBytes, &p.tm_do, &full[slot],
                     pn * 64, q0, h, b);
          }
        }
        // the row statistics travel with their tile
        float* st = stats_all + slot * 3 * kTileRows;
        load_row_stats(st, st + kTileRows, st + 2 * kTileRows, p,
                       ((long long)b * H + h) * S, q0, S, lane);
        mbar_arrive(&full[slot]);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kr0 = warp * 16 + g;  // this thread's two keys in the tile
    const int kr1 = kr0 + 8;
    const float scale = p.scale;
    const float scale2 = scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    const bool kv0 = sValid[kr0] != 0;
    const bool kv1 = sValid[kr1] != 0;
    // the warp's keys all valid: off the diagonal no mask is needed
    const bool keys_ok = __all_sync(0xffffffffu, kv0 && kv1);
    const uint32_t sK = smem_u32(smem + L::kK);
    const uint32_t sV = smem_u32(smem + L::kV);
    const int first = wg == 0 ? 0 : half;
    const int count = wg == 0 ? half : n_items - half;
    for (int i = 0; i < count; ++i) {
      const int slot = wg * kStages + i % kStages;
      const int item = first + i;
      const bool diag = item % nq == 0;  // the q tile of the block's keys
      const uint32_t sQ = smem_u32(smem + L::kRing + slot * L::kStage);
      const uint32_t sDO = sQ + L::kTile;
      const float* st = stats_all + slot * 3 * kTileRows;
      mbar_wait(&full[slot], (i / kStages) & 1);

      // s^T = K Q^T and dp^T = V dO^T, 64 keys x 64 queries, as two
      // groups: the exp below runs while the tensor cores still form dp
      float s[32], dp[32];
      wgmma_fence();
      wgmma_tile_product<D>(s, sK, sQ);
      wgmma_commit();
      wgmma_tile_product<D>(dp, sV, sDO);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // p^T under the causal/valid mask, kept in s and as the A fragments
      // (keys x 16 queries) of dv += p^T dO (dO read MN-major), which then
      // runs while ds^T = p^T (dp^T - delta) is formed
      if (diag || !keys_ok) {
        dkv_probs<true>(s, st, scale2, kr0, kr1, kv0, kv1, diag, t);
      } else {
        dkv_probs<false>(s, st, scale2, kr0, kr1, kv0, kv1, diag, t);
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pa[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, pa[kk], sDO, kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * t;
        const float2 dl =
            *reinterpret_cast<const float2*>(st + 2 * kTileRows + qc);
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dsv[e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }
        da[j / 2][(j % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
        da[j / 2][(j % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dk += ds^T Q (Q read MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, da[kk], sQ, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(&empty[slot]);
    }

    // the two partials: warpgroup 0 gives its dv and keeps dk, warpgroup 1
    // gives its dk and keeps dv; each hand-over lies in the giver's ring
    float* give = reinterpret_cast<float*>(smem + L::kRing + wg * L::kRingBytes);
    const float* take =
        reinterpret_cast<const float*>(smem + L::kRing + (1 - wg) * L::kRingBytes);
    // the sums leave as bf16 staged behind the other's hand-over, in
    // whole rows
    unsigned char* staged = smem + L::kRing + (1 - wg) * L::kRingBytes +
                            kTileRows * D * 4;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) give[i * 128 + tid] = dv[i];
      consumers_sync();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] += take[i * 128 + tid];
      stage_tile<D>(staged, dk, scale, scale, kr0, t);
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) give[i * 128 + tid] = dk[i];
      consumers_sync();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv[i] += take[i * 128 + tid];
      stage_tile<D>(staged, dv, 1.f, 1.f, kr0, t);
    }
    warpgroup_sync(wg);
    copy_tile_rows<D>((wg == 0 ? p.dk : p.dv) + ((long long)b * KVH + kvh) *
                                                     S * D +
                          (long long)key0 * D,
                      D, staged, S - key0, tid);
  }
}

// Shared memory of the dq kernel, byte offsets from a 1024-aligned base.
template <int D>
struct DqSmem {
  static constexpr int kTile = kTileRows * D * 2;
  static constexpr int kQ = 0;                              // [4] tiles
  static constexpr int kDO = kHeadsPerBlock * kTile;        // [4] tiles
  static constexpr int kRing = 2 * kHeadsPerBlock * kTile;  // [kStages]
  static constexpr int kStage = 2 * kTile;                  // K then V
  // [kStages][64] keys' validity, then [kStages] "all valid" flags
  static constexpr int kValid = kRing + kStages * kStage;
  static constexpr int kStats = kValid + kStages * (kTileRows + 4) * 4;
  static constexpr int kBranch = kStats + 3 * kHeadsPerBlock * kTileRows * 4;
  // p_b and ds_b * scale per (branch, head, row): [2][kMaxKeys - 1][4][64]
  static constexpr int kBars =
      kBranch + 2 * (kMaxKeys - 1) * kHeadsPerBlock * kTileRows * 4;
  static constexpr int kBytes =
      kBars + (2 * kStages + kHeadsPerBlock + 1) * 8 + 1024;  // + slack
};

// One branch's group sum over a chunk's nh heads in head order, in fp32:
// dk_b = sum_h (scale * ds_b,h) q_h (warpgroup 0, xs = Q, coef = scale *
// ds_b) or dv_b = sum_h p_b,h dO_h (warpgroup 1, xs = dO, coef = p_b), rows
// q0.. of out (bf16, [S, D] of this (branch, batch, kv head)). Beyond one
// chunk the partial goes through the fp32 workspace ws, chunk by chunk in
// order. Lane l of warp w sums 16-byte chunk l % (D / 8) of rows
// 16 w + .. , so each warp writes whole rows.
template <int D>
__device__ __forceinline__ void branch_group_sum(
    const unsigned char* xs, int tile_bytes, const float* coef, int nh,
    int q0, int S, __nv_bfloat16* out, float* ws, int c, int n_chunks,
    int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kRowsPerPass = 32 / kChunks;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int jc = lane % kChunks;
#pragma unroll
  for (int i = 0; i < 16 / kRowsPerPass; ++i) {
    const int row = warp * 16 + i * kRowsPerPass + lane / kChunks;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
    for (int lh = 0; lh < kHeadsPerBlock; ++lh) {
      if (lh >= nh) break;
      const float cf = coef[lh * kTileRows + row];
      const uint4 x =
          *reinterpret_cast<const uint4*>(xs + lh * tile_bytes + swz(row, jc));
      const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(xw[e]);
        acc[2 * e] += cf * f.x;
        acc[2 * e + 1] += cf * f.y;
      }
    }
    if (q0 + row >= S) continue;
    const long long o = (long long)(q0 + row) * D + jc * 8;
    if (n_chunks > 1) {
      float4* w = reinterpret_cast<float4*>(ws + o);
      if (c > 0) {
        const float4 a = w[0], b = w[1];
        acc[0] = a.x + acc[0];
        acc[1] = a.y + acc[1];
        acc[2] = a.z + acc[2];
        acc[3] = a.w + acc[3];
        acc[4] = b.x + acc[4];
        acc[5] = b.y + acc[5];
        acc[6] = b.z + acc[6];
        acc[7] = b.w + acc[7];
      }
      if (c + 1 < n_chunks) {
        w[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        w[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
        continue;
      }
    }
    uint4 v;
    v.x = pack_bf16(acc[0], acc[1]);
    v.y = pack_bf16(acc[2], acc[3]);
    v.z = pack_bf16(acc[4], acc[5]);
    v.w = pack_bf16(acc[6], acc[7]);
    *reinterpret_cast<uint4*>(out + o) = v;
  }
}

// dq and the group-summed branch dk/dv. A block owns one q tile (64 rows)
// of one (batch, kv head) and the G query heads of its group, in chunks of
// up to four resident heads (one chunk at G <= 4): each consumer warpgroup
// keeps dq of up to two heads in fp32 registers, and every K/V tile the
// producer stages serves all of the chunk's heads. After the causal tiles
// the producer stages each branch's k_b / v_b rows of the q tile; the
// consumers add ds_b k_b to dq in fp32 and leave p_b and ds_b in shared
// memory, and then warpgroup 0 sums dk_b = scale * sum_h
// ds_b,h q_h and warpgroup 1 dv_b = sum_h p_b,h dO_h over the chunk's heads
// in head order, in fp32 (branch_group_sum), written once per branch as
// [NB, B, KVH, S, D]. Blocks are issued longest rows first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    ttt_bwd_dq_kernel(const __grid_constant__ Params p) {
  using L = DqSmem<D>;
  constexpr int kPanels = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);  // [2]
  uint64_t* empty = full + kStages;                                // [2]
  uint64_t* q_full = empty + kStages;  // [kHeadsPerBlock], one per head
  uint64_t* q_empty = q_full + kHeadsPerBlock;
  int* sValid = reinterpret_cast<int*>(smem + L::kValid);
  float* sM = reinterpret_cast<float*>(smem + L::kStats);
  float* sIL = sM + kHeadsPerBlock * kTileRows;
  float* sDl = sIL + kHeadsPerBlock * kTileRows;
  float* sPb = reinterpret_cast<float*>(smem + L::kBranch);
  float* sDsb = sPb + (kMaxKeys - 1) * kHeadsPerBlock * kTileRows;

  const int S = p.S;
  const int H = p.H;
  const int KVH = p.KVH;
  const int G = H / KVH;
  const int BK = p.B * KVH;
  const int n_qtiles = (S + kTileRows - 1) / kTileRows;
  const int qtile = n_qtiles - 1 - blockIdx.x / BK;  // longest rows first
  const int b = (blockIdx.x % BK) / KVH;
  const int kvh = blockIdx.x % KVH;
  const int q0 = qtile * kTileRows;
  const int n_ktiles = qtile + 1;  // causal: the key tiles up to the diagonal
  const int NB = p.n_branches;
  const int n_chunks = (G + kHeadsPerBlock - 1) / kHeadsPerBlock;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);   // the producer warp's lanes
      mbar_init(&empty[i], 256);  // both consumer warpgroups
    }
    for (int i = 0; i < kHeadsPerBlock; ++i) mbar_init(&q_full[i], 32);
    mbar_init(q_empty, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x / 32 != 8) return;  // one producer warp
    const int lane = threadIdx.x % 32;
    int it = 0;  // ring items so far
    for (int c = 0; c < n_chunks; ++c) {
      const int h0 = kvh * G + c * kHeadsPerBlock;
      const int nh = min(kHeadsPerBlock, G - c * kHeadsPerBlock);
      if (c > 0) mbar_wait(q_empty, (c - 1) & 1);
      // the chunk's Q and dO tiles and their row statistics, head by head:
      // each warpgroup's first head now, its second after the first K/V
      // tile, so that the products start after 64 KB rather than 160
      const int n0 = (nh + 1) / 2;  // the heads of consumer warpgroup 0
      auto load_head = [&](int lh) {
        if (lh >= nh) return;
        if (lane == 0) {
          mbar_expect_tx(&q_full[lh], 2 * L::kTile);
          for (int pn = 0; pn < kPanels; ++pn) {
            tma_load(smem + L::kQ + lh * L::kTile + pn * kPanelBytes, &p.tm_q,
                     &q_full[lh], pn * 64, q0, h0 + lh, b);
            tma_load(smem + L::kDO + lh * L::kTile + pn * kPanelBytes,
                     &p.tm_do, &q_full[lh], pn * 64, q0, h0 + lh, b);
          }
        }
        load_row_stats(sM + lh * kTileRows, sIL + lh * kTileRows,
                       sDl + lh * kTileRows, p,
                       ((long long)b * H + h0 + lh) * S, q0, S, lane);
        mbar_arrive(&q_full[lh]);
      };
      load_head(0);
      if (n0 < nh) load_head(n0);
      // the causal K/V tiles with their keys' validity, then each branch's
      // k_b / v_b rows of this q tile
      for (int j = 0; j < n_ktiles + NB; ++j, ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        const bool causal = j < n_ktiles;
        if (lane == 0) {
          unsigned char* dst = smem + L::kRing + st * L::kStage;
          const int src = causal ? 0 : 1 + j - n_ktiles;
          const int row = causal ? j * kTileRows : q0;
          mbar_expect_tx(&full[st], 2 * L::kTile);
          for (int pn = 0; pn < kPanels; ++pn) {
            tma_load(dst + pn * kPanelBytes, &p.tm_k[src], &full[st], pn * 64,
                     row, kvh, b);
            tma_load(dst + L::kTile + pn * kPanelBytes, &p.tm_v[src],
                     &full[st], pn * 64, row, kvh, b);
          }
        }
        if (causal) {
          bool all = true;
          for (int r = lane; r < kTileRows; r += 32) {
            const int key = j * kTileRows + r;
            const bool ok = key < S && p.valid[(long long)b * S + key] != 0;
            sValid[st * kTileRows + r] = ok;
            all = all && ok;
          }
          // and whether the tile needs no key mask at all
          all = __all_sync(0xffffffffu, all);
          if (lane == 0) sValid[kStages * kTileRows + st] = all;
        }
        mbar_arrive(&full[st]);
        if (j == 0) {
          for (int lh = 1; lh < nh; ++lh) {
            if (lh != n0) load_head(lh);
          }
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = warp * 16 + g;  // this thread's two rows of the q tile
    const int r1 = r0 + 8;
    const float scale = p.scale;
    const float scale2 = scale * kLog2e;
    int it = 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int nh = min(kHeadsPerBlock, G - c * kHeadsPerBlock);
      const int n_own = wg == 0 ? (nh + 1) / 2 : nh / 2;
      const int lh0 = wg == 0 ? 0 : (nh + 1) / 2;  // first local head owned
      float dq[kSlots][D / 2];
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dq[sl][i] = 0.f;
      }

      for (int j = 0; j < n_ktiles; ++j, ++it) {
        const int st = it % kStages;
        const uint32_t sK = smem_u32(smem + L::kRing + st * L::kStage);
        const uint32_t sV = sK + L::kTile;
        const int* valid = sValid + st * kTileRows;
        const bool diag = j == qtile;
        mbar_wait(&full[st], (it / kStages) & 1);
        const bool tile_full = sValid[kStages * kTileRows + st] != 0;
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          if (sl >= n_own) break;
          const int lh = lh0 + sl;
          const uint32_t sQ = smem_u32(smem + L::kQ + lh * L::kTile);
          const uint32_t sDO = smem_u32(smem + L::kDO + lh * L::kTile);
          if (j == 0) mbar_wait(&q_full[lh], c & 1);  // the head's tiles
          // s = Q K^T and dp = dO V^T, 64 queries x 64 keys, as two groups:
          // the exp below runs while the tensor cores still form dp
          float s[32], dp[32];
          wgmma_fence();
          wgmma_tile_product<D>(s, sQ, sK);
          wgmma_commit();
          wgmma_tile_product<D>(dp, sDO, sV);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);
          // the rows' statistics, read from shared memory here, where they
          // are used (held beside two heads' dq they crowd the registers,
          // and ptxas then serializes the wgmmas)
          const float mr[2] = {sM[lh * kTileRows + r0], sM[lh * kTileRows + r1]};
          const float ilr[2] = {sIL[lh * kTileRows + r0],
                                sIL[lh * kTileRows + r1]};
          const float dlr[2] = {sDl[lh * kTileRows + r0],
                                sDl[lh * kTileRows + r1]};
          // p under the causal/valid mask, in place
          if (diag || !tile_full) {
            dq_probs<true>(s, valid, scale2, mr, ilr, r0, r1, diag, t);
          } else {
            dq_probs<false>(s, valid, scale2, mr, ilr, r0, r1, diag, t);
          }
          wgmma_wait<0>();
          fence_regs(dp);
          // ds = p (dp - delta), as the A fragments of dq += ds K (K read
          // MN-major)
          uint32_t da[4][4];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            float dsv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dsv[e] = s[4 * jj + e] * (dp[4 * jj + e] - dlr[e >> 1]);
            }
            da[jj / 2][(jj % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
            da[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq[sl], da[kk], sK, kk);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq[sl]);
          fence_regs(da);
        }
        mbar_arrive(&empty[st]);
      }

      // the group sums read every head's tiles (all arrived by now)
      for (int lh = 0; lh < nh; ++lh) mbar_wait(&q_full[lh], c & 1);
      // the diagonal branches: p_b = exp(q.k_b * scale - m) / l, not masked
      // by key_valid; dq gains ds_b k_b
      for (int br = 0; br < NB; ++br, ++it) {
        const int st = it % kStages;
        const unsigned char* kb = smem + L::kRing + st * L::kStage;
        const unsigned char* vb = kb + L::kTile;
        mbar_wait(&full[st], (it / kStages) & 1);
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          if (sl >= n_own) break;
          const int lh = lh0 + sl;
          const unsigned char* sQ = smem + L::kQ + lh * L::kTile;
          const unsigned char* sDO = smem + L::kDO + lh * L::kTile;
          // q.k_b and dO.v_b of rows r0 and r1: lane t of the quad takes
          // the 16-byte chunks t, t + 4, ... of each row
          float w0 = 0.f, w1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
          for (int jj = t; jj < D / 8; jj += 4) {
            const int o0 = swz(r0, jj), o1 = swz(r1, jj);
            w0 += dot8(sQ + o0, kb + o0);
            w1 += dot8(sQ + o1, kb + o1);
            u0 += dot8(sDO + o0, vb + o0);
            u1 += dot8(sDO + o1, vb + o1);
          }
          const float* mh = sM + lh * kTileRows;
          const float* ilh = sIL + lh * kTileRows;
          const float* dlh = sDl + lh * kTileRows;
          const float pb0 = ex2(fmaf(quad_sum(w0), scale2, -mh[r0])) * ilh[r0];
          const float pb1 = ex2(fmaf(quad_sum(w1), scale2, -mh[r1])) * ilh[r1];
          const float dsb0 = pb0 * (quad_sum(u0) - dlh[r0]);
          const float dsb1 = pb1 * (quad_sum(u1) - dlh[r1]);
          // dq += ds_b k_b in fp32, k_b at this thread's dq entries
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj) {
            const float2 ka = unpack_bf16(
                *reinterpret_cast<const uint32_t*>(kb + swz(r0, jj) + 4 * t));
            const float2 kc = unpack_bf16(
                *reinterpret_cast<const uint32_t*>(kb + swz(r1, jj) + 4 * t));
            dq[sl][4 * jj] += dsb0 * ka.x;
            dq[sl][4 * jj + 1] += dsb0 * ka.y;
            dq[sl][4 * jj + 2] += dsb1 * kc.x;
            dq[sl][4 * jj + 3] += dsb1 * kc.y;
          }
          if (t == 0) {
            const int base = (br * kHeadsPerBlock + lh) * kTileRows;
            sPb[base + r0] = pb0;
            sPb[base + r1] = pb1;
            sDsb[base + r0] = dsb0 * scale;
            sDsb[base + r1] = dsb1 * scale;
          }
        }
        mbar_arrive(&empty[st]);
        // the branch's group sums, while the next tiles stream in
        consumers_sync();  // p_b, ds_b of all the chunk's heads are here
        const long long obase =
            ((long long)br * BK + (long long)b * KVH + kvh) * S * D;
        branch_group_sum<D>(
            smem + (wg == 0 ? L::kQ : L::kDO), L::kTile,
            (wg == 0 ? sDsb : sPb) + br * kHeadsPerBlock * kTileRows, nh, q0,
            S, (wg == 0 ? p.dkb : p.dvb) + obase,
            n_chunks > 1
                ? p.ws + (wg == 0 ? 0 : (long long)NB * BK * S * D) + obase
                : nullptr,
            c, n_chunks, tid);
      }

      // dq of the warpgroup's heads, staged as bf16 in their Q tiles (the
      // last group sums read the Q tiles: wait for them) and written in
      // whole rows
      if (NB > 0) consumers_sync();
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
        if (sl >= n_own) break;
        stage_tile<D>(smem + L::kQ + (lh0 + sl) * L::kTile, dq[sl], scale,
                      scale, r0, t);
      }
      warpgroup_sync(wg);
      for (int sl = 0; sl < n_own; ++sl) {
        const int h = kvh * G + c * kHeadsPerBlock + lh0 + sl;
        copy_tile_rows<D>(p.dq + (((long long)b * H + h) * S + q0) * D, D,
                          smem + L::kQ + (lh0 + sl) * L::kTile, S - q0, tid);
      }

      // this chunk's Q, dO, statistics and branch terms are read
      mbar_arrive(q_empty);
    }
  }
}


template <typename Kernel>
int launch(Kernel kernel, int smem_bytes, const Params& p, long long blocks,
           cudaStream_t st) {
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem_bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor maps and pointers the three kernels share: the map of dout
// only for the backward (dout given), those of the branch keys and values
// only with `branches`.
int fill_params(Params& p, const void* q, const long long* q_strides,
                const void* const* keys, const void* const* values,
                int n_keys, const long long* k_strides,
                const long long* v_strides, const int* valid,
                const void* dout, int B, int H, int KVH, int S, int D,
                bool branches) {
  if (n_keys < 1 || n_keys > kMaxKeys || B < 1 || KVH < 1 || H % KVH != 0 ||
      S < 1 || (D != 64 && D != 128)) {
    return cudaErrorInvalidValue;
  }
  memset(&p, 0, sizeof(p));
  bool ok = encode_bhsd(&p.tm_q, q, B, H, S, D, q_strides[0], q_strides[1],
                        q_strides[2]) &&
            (dout == nullptr ||
             encode_bhsd(&p.tm_do, dout, B, H, S, D, (long long)S * H * D, D,
                         (long long)H * D));
  for (int i = 0; i < (branches ? n_keys : 1); ++i) {
    ok = ok &&
         encode_bhsd(&p.tm_k[i], keys[i], B, KVH, S, D, k_strides[0],
                     k_strides[1], k_strides[2]) &&
         encode_bhsd(&p.tm_v[i], values[i], B, KVH, S, D, v_strides[0],
                     v_strides[1], v_strides[2]);
  }
  if (!ok) return cudaErrorInvalidValue;
  p.valid = valid;
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.n_branches = n_keys - 1;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  return cudaSuccess;
}

// blocks of the q-tile grids: q tiles x batch x kv heads (x head chunks)
long long qtile_blocks(int B, int KVH, int S, int chunks) {
  return (long long)((S + kTileRows - 1) / kTileRows) * B * KVH * chunks;
}

}  // namespace

// keys/values: n_keys device pointers each (the step-0 block first, then
// the branches); *_strides: element strides over (b, h, s); the head dim is
// contiguous, and every base and stride is a multiple of 16 bytes (the
// tensor maps'). out [B, S, H*D] bf16, m and l [B, H, S] fp32, all
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int ttt_attention_fwd(const void* q, const long long* q_strides,
                                 const void* const* keys,
                                 const void* const* values, int n_keys,
                                 const long long* k_strides,
                                 const long long* v_strides, const int* valid,
                                 void* out, float* m, float* l, int B, int H,
                                 int KVH, int S, int D, void* stream) {
  Params p;
  const int e = fill_params(p, q, q_strides, keys, values, n_keys, k_strides,
                            v_strides, valid, nullptr, B, H, KVH, S, D, true);
  if (e != cudaSuccess) return e;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m_out = m;
  p.l_out = l;
  const int chunks = (H / KVH + kHeadsPerBlock - 1) / kHeadsPerBlock;
  const long long blocks = qtile_blocks(B, KVH, S, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128
             ? launch(ttt_fwd_kernel<128>, FwdSmem<128>::kBytes, p, blocks, st)
             : launch(ttt_fwd_kernel<64>, FwdSmem<64>::kBytes, p, blocks, st);
}

// The backward's first kernel: dq [B, H, S, D] and, per branch, dk_b/dv_b
// summed over the query heads of each group [NB, B, KVH, S, D] (all
// contiguous bf16). dout [B, S, H*D] is contiguous; m, l, delta are
// [B, H, S] fp32; ws is an fp32 workspace [2, NB, B, KVH, S, D] when
// H / KVH > 4 (else unused). The other arguments are those of
// ttt_attention_fwd.
extern "C" int ttt_attention_bwd_dq(
    const void* q, const long long* q_strides, const void* const* keys,
    const void* const* values, int n_keys, const long long* k_strides,
    const long long* v_strides, const int* valid, const void* dout,
    const float* m, const float* l, const float* delta, void* dq, void* dkb,
    void* dvb, float* ws, int B, int H, int KVH, int S, int D, void* stream) {
  Params p;
  const int e = fill_params(p, q, q_strides, keys, values, n_keys, k_strides,
                            v_strides, valid, dout, B, H, KVH, S, D, true);
  if (e != cudaSuccess) return e;
  if (n_keys > 1 && H / KVH > kHeadsPerBlock && ws == nullptr) {
    return cudaErrorInvalidValue;
  }
  p.m = m;
  p.l = l;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dkb = static_cast<__nv_bfloat16*>(dkb);
  p.dvb = static_cast<__nv_bfloat16*>(dvb);
  p.ws = ws;
  const long long blocks = qtile_blocks(B, KVH, S, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128
             ? launch(ttt_bwd_dq_kernel<128>, DqSmem<128>::kBytes, p, blocks,
                      st)
             : launch(ttt_bwd_dq_kernel<64>, DqSmem<64>::kBytes, p, blocks,
                      st);
}

// The backward's second kernel: dk, dv [B, KVH, S, D] (contiguous bf16) of
// the causal block, summed over the query heads of each group.
extern "C" int ttt_attention_bwd_dkv(
    const void* q, const long long* q_strides, const void* const* keys,
    const void* const* values, int n_keys, const long long* k_strides,
    const long long* v_strides, const int* valid, const void* dout,
    const float* m, const float* l, const float* delta, void* dk, void* dv,
    int B, int H, int KVH, int S, int D, void* stream) {
  Params p;
  const int e = fill_params(p, q, q_strides, keys, values, n_keys, k_strides,
                            v_strides, valid, dout, B, H, KVH, S, D, false);
  if (e != cudaSuccess) return e;
  p.m = m;
  p.l = l;
  p.delta = delta;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const long long blocks = qtile_blocks(B, KVH, S, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128
             ? launch(ttt_bwd_dkv_kernel<128>, DkvSmem<128>::kBytes, p,
                      blocks, st)
             : launch(ttt_bwd_dkv_kernel<64>, DkvSmem<64>::kBytes, p, blocks,
                      st);
}
