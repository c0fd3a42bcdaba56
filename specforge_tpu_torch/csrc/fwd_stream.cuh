// The forward stream shared by the LSE ring-hop forward (lse_attention.cu),
// the COD attention forward (peagle_attention.cu) and the DFlash block
// attention forward (dflash_attention.cu).
//
// Replaces, with the mask policy of each source, the Pallas kernels
// `_lse_fwd_kernel` of specforge_tpu/ops/attention_pallas.py and
// `_fwd_kernel` of specforge_tpu/ops/peagle_pallas.py and of
// specforge_tpu/ops/dflash_pallas.py: per row, the
// online-softmax forward over the key tiles the policy allows, s = scale *
// q.k, with (m, l, O) carried in fp32 (m in log2 units) and O / l written
// in bf16 beside the row statistics.
//
// What bounds it on this card: two 64 x 64 x D products per (query head,
// key tile) item (S = Q K^T and O += P V; 2.1 MFLOP at D = 128, 0.28 us at
// one SM's share of the bf16 peak) against 32 KB of K/V per key tile, most
// of it from L2 (every q tile of a head reads the same keys): bound by
// operations. Beside the products each item takes 4096 exponentials, one
// MUFU instruction each (about half the products' time at the SM's 16 a
// clock), and the rescale of O: the softmax is the long pole unless it
// runs while the tensor cores work.
//
// What the design does about it: the dq stream's block (dq_stream.cuh)
// with the TTT forward's consumer loop (ttt_fwd_kernel). A block of 384
// threads owns one q tile (64 rows) of one (batch, kv head) and up to four
// query heads of its group, two per consumer warpgroup (a larger group
// runs as chunks of four in blocks of their own: no sum crosses heads in a
// forward), so each K/V tile is staged once for all of them. Each head's Q
// tile lands once by TMA on a barrier of its own. Two producer warps
// (`setmaxnreg` 24; the consumers 240) keep a ring of K/V stages in flight,
// four at D = 128 beside the 64 KB of Q tiles, eight at D = 64: one lane
// issues the stage's TMA copies first, then the lanes, a key each, write
// the policy's key data and arrive on the stage's barrier. Per stage a
// consumer warpgroup issues S of both its heads on `wgmma` (B from the
// swizzled stage); head a's softmax runs while the tensor cores form head
// b's S, and head b's while they form head a's O += P V (A = P from
// registers, V read MN-major); both P V products retire inside the stage,
// which is then released. p = 2^(s * scale2 - m2) is one FMA and one `ex2`
// a score; the mask is a select to -inf by 32 bits a thread that the policy
// computes once a stage for both of a warpgroup's heads, and only on stages
// that need one (the tile list's mask-free bit). A row with no allowed key
// keeps m2 = -1e30 and l = 0, so its p is exactly 0 on every stage and its
// output exactly 0. O / l leaves as bf16 through the head's own Q tile in
// whole rows, in the layout the stream's output strides give, with m (or,
// for a log-sum-exp policy, lse = m + ln l) and l in fp32 [B, H, rows]. No
// atomics: two runs give the same bits; rows and keys past the end are
// zero-filled by TMA and carry no allowed pair.
//
// A policy with row slots (Policy::kRowSlots: the LSE op, a group of one)
// fills the slots with two adjacent q tiles of one head instead, one a
// consumer warpgroup, so both share each K/V stage: the block walks its
// list, the later slot's, and the earlier slot takes the prefix its own
// rows reach (`slot_tiles`) with its own mask-free decision and mask bits
// (`slot_free`, `slot_bits`), and passes the rest on. The policies are the
// dq stream's, so each family's mask is written once for its forward and
// its dq kernel. A policy with a second key source (Policy::kSecondSource:
// DFlash's draft keys) has the list's last tile read from the policy's own
// tensor maps (`second_keys`, `second_values`; FwdStream holds one source,
// so the other clients' parameters stay as they were) and masked by the
// policy's second spans (`tile_bits(..., true, ...)`), as in the dq stream.
#pragma once

#include <string.h>

#include "dq_stream.cuh"

namespace {

constexpr int kFwdThreads = kHopperThreads;
constexpr int kFwdHeads = 4;  // query heads resident at once
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of a forward block, byte offsets from a 1024-aligned base;
// the block's key tile list follows kExtra.
template <int D>
struct FwdStreamSmem {
  static constexpr int kTile = kTileRows * D * 2;  // D / 64 swizzled panels
  // K/V stages of the ring: as many as fit beside the Q tiles in 200 KB
  static constexpr int kStages = D == 128 ? 4 : 8;
  static constexpr int kQ = 0;                     // [kFwdHeads] tiles
  static constexpr int kRing = kFwdHeads * kTile;  // [kStages]
  static constexpr int kStage = 2 * kTile;         // K, then V
  // the rows' mask data, 16 bytes a row (the policy's)
  static constexpr int kRowData = kRing + kStages * kStage;
  // each stage's key data, 16 bytes a key (the policy's)
  static constexpr int kKeyData = kRowData + kTileRows * 16;
  // each consumer thread's mask bits of its current stage
  static constexpr int kBits = kKeyData + kStages * kTileRows * 16;
  static constexpr int kInfo = kBits + 256 * 4;
  // full[kStages], empty[kStages], q_full[kFwdHeads]
  static constexpr int kBars = kInfo + 32;
  // the block's key tile list (one int a tile)
  static constexpr int kExtra = kBars + (2 * kStages + kFwdHeads) * 8;
  static_assert(kRowData % 16 == 0 && kKeyData % 16 == 0 &&
                kExtra % 16 == 0, "misaligned");
};

// What the stream reads and writes: tensor maps over the strided views and
// plain pointers for the rest. `rows` is the query length.
struct FwdStream {
  CUtensorMap tm_q;      // q [B, H, rows, D] view
  CUtensorMap tm_k;      // keys [B, KVH, *, D] view
  CUtensorMap tm_v;      // values
  __nv_bfloat16* out;    // element strides out_s over (b, head, row)
  float* m;              // [B, H, rows]: m in natural-log units, or the lse
  float* l;              // [B, H, rows]; unused by a log-sum-exp policy
  long long out_s[3];
  int B, H, KVH, rows;
  int group;             // H / KVH, the query heads of a kv head
  float scale2;          // scale * log2(e)
};

// The block's coordinates, key tile count and resident slots (heads h0..
// h0 + nh - 1, or with row slots nh q tiles of head h0), written to shared
// memory before the role split and read back by each role after its
// setmaxnreg: a value kept in a register across setmaxnreg is spilled. The
// tiles are the block's list at kExtra, entry j = 2 * key tile + a "needs
// no mask" bit, as in the dq stream.
struct FwdBlock : DqBlock {
  int h0, nh;
};

template <int D>
__device__ __forceinline__ FwdBlock* fwd_block_info(unsigned char* smem) {
  return reinterpret_cast<FwdBlock*>(smem + FwdStreamSmem<D>::kInfo);
}

template <int D>
__device__ __forceinline__ FwdBlock load_fwd_block(unsigned char* smem) {
  const volatile FwdBlock* x = fwd_block_info<D>(smem);
  FwdBlock blk;
  blk.b = x->b;
  blk.kvh = x->kvh;
  blk.q0 = x->q0;
  blk.n_tiles = x->n_tiles;
  blk.h0 = x->h0;
  blk.nh = x->nh;
  return blk;
}

// The barriers and the coordinates of a forward block, by thread 0, before
// the block's first __syncthreads
template <int D>
__device__ __forceinline__ void fwd_init_block(unsigned char* smem, int b,
                                               int kvh, int q0, int h0,
                                               int nh) {
  using L = FwdStreamSmem<D>;
  if (threadIdx.x == 0) {
    FwdBlock* info = fwd_block_info<D>(smem);
    info->b = b;
    info->kvh = kvh;
    info->q0 = q0;
    info->h0 = h0;
    info->nh = nh;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&bars[i], 64);                // full: the producer warps' lanes
      mbar_init(&bars[L::kStages + i], 256);  // empty: both consumer warpgroups
    }
    for (int i = 0; i < kFwdHeads; ++i) mbar_init(&bars[2 * L::kStages + i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// One head's online-softmax step over a 64 x 64 tile of raw scores q.k
// (this thread's entry 4j + e: row r0 for e < 2, else r0 + 8; key 8j + 2t +
// (e & 1)): kMasked sets the entries whose bit is clear to -inf. The rows'
// running max m2 (log2 units, never below -1e30, so 2^(m2_old - m2_new)
// never meets inf - inf) and this thread's partial sums ls are updated, the
// accumulator o rescaled, and p = 2^(s * scale2 - m2) packed as the A
// fragments of O += P V.
template <int D, bool kMasked>
__device__ __forceinline__ void stream_fwd_softmax(float (&s)[32],
                                                   float (&o)[D / 2],
                                                   float (&m2)[2],
                                                   float (&ls)[2],
                                                   uint32_t (&pa)[4][4],
                                                   uint32_t bits,
                                                   float scale2) {
  const float minus_inf = __int_as_float(0xff800000);
  float mx0 = minus_inf, mx1 = minus_inf;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if constexpr (kMasked) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ((bits >> (4 * j + e)) & 1u) != 0 ? s[4 * j + e]
                                                          : minus_inf;
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

// The producer: warps 8 and 9, a key a lane. It loads each slot's Q tile
// (the first of each consumer warpgroup now, the others after the first
// K/V tile), then streams the block's listed key tiles through the ring;
// the policy writes a stage's key data (`stage_key`). A block with no
// listed tile loads nothing: its consumers write empty rows.
template <int D, class Policy>
__device__ __forceinline__ void fwd_produce(const FwdStream& p,
                                            const Policy& pol,
                                            unsigned char* smem) {
  using L = FwdStreamSmem<D>;
  constexpr int kPanels = D / 64;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  const int* list = reinterpret_cast<const int*>(smem + L::kExtra);
  const int r = threadIdx.x - 256;  // this lane's key
  const FwdBlock blk = load_fwd_block<D>(smem);
  if (blk.n_tiles == 0) return;
  const int n0 = (blk.nh + 1) / 2;  // the slots of consumer warpgroup 0
  auto load_q = [&](int lh) {
    // slot lh: head h0 + lh of the block's q tile, or (row slots) q tile lh
    // of the block's rows of head h0
    if (r == 0) {
      const int h = Policy::kRowSlots ? blk.h0 : blk.h0 + lh;
      const int q0 = Policy::kRowSlots ? blk.q0 + lh * kTileRows : blk.q0;
      mbar_expect_tx(&q_full[lh], L::kTile);
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load(smem + L::kQ + lh * L::kTile + pn * kPanelBytes, &p.tm_q,
                 &q_full[lh], pn * 64, q0, h, blk.b);
      }
      mbar_arrive(&q_full[lh]);
    }
  };
  load_q(0);
  if (n0 < blk.nh) load_q(n0);
  for (int j = 0; j < blk.n_tiles; ++j) {
    const int st = j % L::kStages;
    mbar_wait(&empty[st], ((j / L::kStages) & 1) ^ 1);
    const int entry = list[j];
    const int key0 = (entry >> 1) * kTileRows;
    if (r == 0) {
      unsigned char* dst = smem + L::kRing + st * L::kStage;
      const CUtensorMap* km = &p.tm_k;
      const CUtensorMap* vm = &p.tm_v;
      if constexpr (Policy::kSecondSource) {
        // the list's last tile is the second key source's
        if (j + 1 == blk.n_tiles) {
          km = pol.second_keys();
          vm = pol.second_values();
        }
      }
      mbar_expect_tx(&full[st], 2 * L::kTile);
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load(dst + pn * kPanelBytes, km, &full[st], pn * 64, key0,
                 blk.kvh, blk.b);
        tma_load(dst + L::kTile + pn * kPanelBytes, vm, &full[st], pn * 64,
                 key0, blk.kvh, blk.b);
      }
    }
    pol.stage_key(smem + L::kKeyData + st * kTileRows * 16, blk, entry,
                  key0, r);
    mbar_arrive(&full[st]);
    if (j == 0) {
      for (int lh = 1; lh < blk.nh; ++lh) {
        if (lh != n0) load_q(lh);
      }
    }
  }
}

// A consumer warpgroup with kN (1 or 2) slots from local slot lh0 on: the
// listed tiles its rows reach (all of them, or with row slots the slot's
// prefix), then the rest passed on, then the epilogue. Head a's and head
// b's S = Q K^T are issued together; a's softmax runs while the tensor
// cores form b's S, b's while they form a's O += P V. A stage is released
// once both P V products of its tile are done.
template <int D, int kN, class Policy>
__device__ __forceinline__ void fwd_consume(const FwdStream& p,
                                            const Policy& pol,
                                            unsigned char* smem, int lh0) {
  using L = FwdStreamSmem<D>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  const int* list = reinterpret_cast<const int*>(smem + L::kExtra);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L::kBits) + threadIdx.x;
  const FwdBlock blk = load_fwd_block<D>(smem);
  const int tid = threadIdx.x % 128;
  // this thread's rows r0 and r0 + 8 of the tile, and its key pair t
  const int r0 = tid / 32 * 16 + (tid % 32) / 4;
  const int t = tid % 4;
  const uint32_t sQa = smem_u32(smem + L::kQ + lh0 * L::kTile);
  // the listed tiles this warpgroup's rows reach: a prefix of the list
  int n_mine = blk.n_tiles;
  if constexpr (Policy::kRowSlots) {
    n_mine = pol.slot_tiles(smem + L::kRowData, lh0);
  }

  float o[kN][D / 2];
  float m2[kN][2], ls[kN][2];
#pragma unroll
  for (int h = 0; h < kN; ++h) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[h][i] = 0.f;
    m2[h][0] = m2[h][1] = kNegInf;
    ls[h][0] = ls[h][1] = 0.f;
  }
  if (n_mine > 0) mbar_wait(&q_full[lh0], 0);
  int j = 0;
  for (; j < n_mine; ++j) {
    const int st = j % L::kStages;
    const uint32_t sK = smem_u32(smem + L::kRing + st * L::kStage);
    const uint32_t sV = sK + L::kTile;
    mbar_wait(&full[st], (j / L::kStages) & 1);
    // the stage's mask, once for both heads, before their products (beside
    // two heads' S in flight it would spill) and kept in shared memory
    // until the softmax reads it
    const int entry = list[j];
    const unsigned char* keys = smem + L::kKeyData + st * kTileRows * 16;
    bool free;
    if constexpr (Policy::kRowSlots) {
      free = pol.slot_free(smem + L::kRowData, lh0, j, entry);
      if (!free) *bits = pol.slot_bits(smem + L::kRowData, keys, lh0, r0, t);
    } else {
      free = (entry & 1) != 0;
      if (!free) {
        // the second key source's tile (the list's last) has its own spans
        bool second = false;
        if constexpr (Policy::kSecondSource) second = j + 1 == blk.n_tiles;
        *bits = pol.tile_bits(smem + L::kRowData, keys,
                              (entry >> 1) * kTileRows, second, r0, t);
      }
    }
    float sa[32], sb[32];
    uint32_t pa[4][4], pb[4][4];
    wgmma_fence();
    wgmma_tile_product<D>(sa, sQa, sK);
    wgmma_commit();
    if constexpr (kN == 2) {
      if (j == 0) mbar_wait(&q_full[lh0 + 1], 0);
      wgmma_fence();  // after the branch: else ptxas inserts it there (C7520)
      wgmma_tile_product<D>(sb, sQa + L::kTile, sK);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sa);
    if (free) {
      stream_fwd_softmax<D, false>(sa, o[0], m2[0], ls[0], pa, 0u, p.scale2);
    } else {
      stream_fwd_softmax<D, true>(sa, o[0], m2[0], ls[0], pa, *bits,
                                  p.scale2);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o[0], pa[kk], sV, kk);
    wgmma_commit();
    if constexpr (kN == 2) {
      wgmma_wait<1>();
      fence_regs(sb);
      if (free) {
        stream_fwd_softmax<D, false>(sb, o[1], m2[1], ls[1], pb, 0u,
                                     p.scale2);
      } else {
        stream_fwd_softmax<D, true>(sb, o[1], m2[1], ls[1], pb, *bits,
                                    p.scale2);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o[1], pb[kk], sV, kk);
      wgmma_commit();
    }
    // both P V products retire inside the stage: an accumulator in flight
    // across the loop's back edge makes ptxas serialize every wgmma (C7514)
    wgmma_wait<0>();
    fence_regs(pa);
#pragma unroll
    for (int h = 0; h < kN; ++h) fence_regs(o[h]);
    if constexpr (kN == 2) fence_regs(pb);
    mbar_arrive(&empty[st]);
  }
  // the stages past this slot's rows
  for (; j < blk.n_tiles; ++j) {
    const int st = j % L::kStages;
    mbar_wait(&full[st], (j / L::kStages) & 1);
    mbar_arrive(&empty[st]);
  }

  // O / l as bf16, staged in the slot's own Q tile (read for the last time
  // above; a slot that reached no tile waits for its tile's copy first)
  // and written in whole rows; the statistics beside it
  if (n_mine == 0 && blk.n_tiles > 0) mbar_wait(&q_full[lh0], 0);
#pragma unroll
  for (int h = 0; h < kN; ++h) {
    const float l0 = quad_sum(ls[h][0]);
    const float l1 = quad_sum(ls[h][1]);
    stage_tile<D>(smem + L::kQ + (lh0 + h) * L::kTile, o[h],
                  1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f), r0, t);
    if (t == 0) {
      const int hd = Policy::kRowSlots ? blk.h0 : blk.h0 + lh0 + h;
      const int q0 = Policy::kRowSlots ? blk.q0 + lh0 * kTileRows : blk.q0;
      const long long at = ((long long)blk.b * p.H + hd) * p.rows + q0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * e;
        const float lv = e == 0 ? l0 : l1;
        if (q0 + r < p.rows) {
          if constexpr (Policy::kLogSumExp) {
            // lse = m + ln l; a row with no allowed key gets -1e30
            p.m[at + r] =
                lv > 0.f ? m2[h][e] * kLn2 + logf(lv) : kNegInf;
          } else {
            p.m[at + r] = m2[h][e] <= kNegInf ? kNegInf : m2[h][e] * kLn2;
            p.l[at + r] = lv;
          }
        }
      }
    }
  }
  warpgroup_sync(threadIdx.x / 128);
#pragma unroll
  for (int h = 0; h < kN; ++h) {
    const int hd = Policy::kRowSlots ? blk.h0 : blk.h0 + lh0 + h;
    const int q0 = Policy::kRowSlots ? blk.q0 + lh0 * kTileRows : blk.q0;
    copy_tile_rows<D>(p.out + blk.b * p.out_s[0] + hd * p.out_s[1] +
                          q0 * p.out_s[2],
                      p.out_s[2], smem + L::kQ + (lh0 + h) * L::kTile,
                      p.rows - q0, tid);
  }
}

// One forward block, called by every thread after the block info (with its
// key tile count), the tile list and the rows' mask data are written and
// the block has synchronised. Consumer warpgroup 0 owns the first
// (nh + 1) / 2 slots, warpgroup 1 the rest; a warpgroup with none passes
// every stage on.
template <int D, class Policy>
__device__ __forceinline__ void fwd_stream_block(const FwdStream& p,
                                                 const Policy& pol,
                                                 unsigned char* smem) {
  using L = FwdStreamSmem<D>;
  if (threadIdx.x >= 256) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x < 320) fwd_produce<D>(p, pol, smem);
    return;
  }
  reg_alloc<kConsumerRegs>();
  const FwdBlock blk = load_fwd_block<D>(smem);
  const int n0 = (blk.nh + 1) / 2;
  const int wg = threadIdx.x / 128;
  const int n_own = wg == 0 ? n0 : blk.nh - n0;
  const int lh0 = wg == 0 ? 0 : n0;
  if constexpr (!Policy::kRowSlots) {
    if (n_own == 2) {
      fwd_consume<D, 2>(p, pol, smem, lh0);
      return;
    }
  }
  if (n_own == 1) {
    fwd_consume<D, 1>(p, pol, smem, lh0);
    return;
  }
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  for (int j = 0; j < blk.n_tiles; ++j) {
    const int st = j % L::kStages;
    mbar_wait(&full[st], (j / L::kStages) & 1);
    mbar_arrive(&full[L::kStages + st]);  // empty[st]
  }
}

// The tensor maps and pointers of the stream: q, the keys and values with
// their element strides over (b, head, row), out with its strides; the
// head dim contiguous. With `maps` false (no block lists a tile, so none
// reads q, k or v: a later ring hop) the maps stay unmade. False if a map
// cannot be made.
bool fill_fwd_stream(FwdStream& s, const void* q, const long long* q_strides,
                     const void* k, const long long* k_strides, const void* v,
                     const long long* v_strides, int keys, void* out,
                     const long long* out_strides, float* m, float* l, int B,
                     int H, int KVH, int rows, int D, bool maps) {
  memset(&s, 0, sizeof(s));
  const bool ok =
      !maps ||
      (encode_bhsd(&s.tm_q, q, B, H, rows, D, q_strides[0], q_strides[1],
                   q_strides[2]) &&
       encode_bhsd(&s.tm_k, k, B, KVH, keys, D, k_strides[0], k_strides[1],
                   k_strides[2]) &&
       encode_bhsd(&s.tm_v, v, B, KVH, keys, D, v_strides[0], v_strides[1],
                   v_strides[2]));
  s.out = static_cast<__nv_bfloat16*>(out);
  for (int i = 0; i < 3; ++i) s.out_s[i] = out_strides[i];
  s.m = m;
  s.l = l;
  s.B = B;
  s.H = H;
  s.KVH = KVH;
  s.rows = rows;
  s.group = H / KVH;
  s.scale2 = 1.0f / sqrtf(static_cast<float>(D)) * kLog2e;
  return ok;
}

// dynamic shared memory of a forward block with `extra` bytes of tile list
// (+ alignment slack)
int fwd_smem_bytes(int D, int extra) {
  const int fixed = D == 128 ? FwdStreamSmem<128>::kExtra
                             : FwdStreamSmem<64>::kExtra;
  return fixed + extra + 1024;
}

}  // namespace
