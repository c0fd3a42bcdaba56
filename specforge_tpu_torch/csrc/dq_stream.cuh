// The dq stream shared by the DFlash dq kernel (dflash_attention.cu), the
// COD dq kernel (peagle_attention.cu) and the LSE ring-hop dq kernel
// (lse_attention.cu).
//
// Replaces, with the mask policy of each source, the Pallas kernels
// `_bwd_dq_kernel` of specforge_tpu/ops/dflash_pallas.py (dq, and the draft
// keys' dk/dv, which the DFlash policy adds), of
// specforge_tpu/ops/peagle_pallas.py (dq) and `_lse_bwd_dq_kernel` of
// specforge_tpu/ops/attention_pallas.py: dq = scale * ds K over the key
// tiles a q tile reaches, with p = exp(s - m) / l recomputed from the
// forward's row statistics and ds = p * (dO V^T - delta).
//
// What bounds it on this card: three 64 x 64 x D products per (query head,
// key tile) item (s, dp and dq; 3.1 MFLOP at D = 128, 0.42 us at one SM's
// share of the bf16 peak) against 32 KB of K/V per key tile: bound by
// operations, and by the heaviest block's tile count when blocks are
// uneven.
//
// What the design does about it (the shape of ttt_bwd_dq_kernel). A block
// of 384 threads owns one q tile (64 rows) of one (batch, kv head) and the
// query heads of its group, up to four resident at a time (two per
// consumer warpgroup, dq of each in fp32 registers; a larger group runs in
// chunks, the key tiles streamed again for each), so each K/V tile is
// staged once for all of them. Each head's Q and dO tiles land once by TMA
// on a barrier of their own, with the head's row statistics (m in log2
// units, 1/l, delta); a warpgroup's second head follows the first K/V
// tile, so the products start after 64 KB. Two producer warps (`setmaxnreg`
// 24; the consumers 240) keep a ring of K/V stages in flight: one lane
// issues the stage's TMA copies (64 x 64 boxes of 4-D tensor maps over the
// strided views) first, then the lanes, a key each, write the policy's key
// data and arrive on the stage's barrier. Per stage and head a consumer
// warpgroup runs s = Q K^T and dp = dO V^T on `wgmma` (B from the swizzled
// stage), then dq += ds K with A = ds from registers and K read MN-major;
// every product retires inside its stage. p is one FMA and one `ex2` a
// score; the mask is a select to -inf by 32 bits a thread that the policy
// computes once a stage for both of a warpgroup's heads, and only on stages
// that need one. A row with no allowed key (l = 0) gets m2 = +1e30 and 1/l
// = 0, so its p is exactly 0 on every stage, masked or not. dq leaves as
// bf16 through shared memory in whole rows. No atomics: two runs give the
// same bits, and rows and keys past the end are zero-filled by TMA and
// carry no allowed pair.
//
// A policy with row slots (Policy::kRowSlots: the LSE op, whose K/V come
// expanded to every head, a group of one) fills the slots with adjacent q
// tiles of one head instead: the block owns two, one a consumer warpgroup,
// so both warpgroups share each K/V stage. Under causality the later tile
// reaches more key tiles: the block walks its list, the longest slot's,
// and a slot skips the stages past its own count and gets its own "needs
// no mask" decision and mask bits (`slot_tiles`, `slot_free`, `slot_bits`).
// A policy whose m is a log-sum-exp (Policy::kLogSumExp) has l = 1, and a
// row with no allowed key (lse = -1e30) takes the dead-row rule above.
#pragma once

#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kDqThreads = kHopperThreads;
constexpr int kDqStages = 2;            // K/V stages of the ring
constexpr int kDqHeads = 4;             // query heads resident at once
constexpr int kDqSlots = kDqHeads / 2;  // heads a consumer warpgroup owns

// Shared memory of a dq block, byte offsets from a 1024-aligned base; the
// block's key tile list and the policy's own memory (DFlash's draft
// staging) follow kExtra.
template <int D>
struct DqStreamSmem {
  static constexpr int kTile = kTileRows * D * 2;  // D / 64 swizzled panels
  static constexpr int kQ = 0;                     // [kDqHeads] tiles
  static constexpr int kDO = kDqHeads * kTile;     // [kDqHeads] tiles
  static constexpr int kRing = 2 * kDqHeads * kTile;  // [kDqStages]
  static constexpr int kStage = 2 * kTile;            // K, then V
  // m2, 1/l and delta of each resident head's rows: [3][kDqHeads][64] fp32
  static constexpr int kStats = kRing + kDqStages * kStage;
  // the rows' mask data, 16 bytes a row (the policy's)
  static constexpr int kRowData = kStats + 3 * kDqHeads * kTileRows * 4;
  // each stage's key data, 16 bytes a key (the policy's)
  static constexpr int kKeyData = kRowData + kTileRows * 16;
  // each consumer thread's mask bits of its current stage
  static constexpr int kBits = kKeyData + kDqStages * kTileRows * 16;
  static constexpr int kInfo = kBits + 256 * 4;
  // full[kDqStages], empty[kDqStages], q_full[kDqHeads], q_empty (+ pad)
  static constexpr int kBars = kInfo + 32;
  // the block's key tile list (one int a tile), then the policy's memory
  static constexpr int kExtra = kBars + (2 * kDqStages + kDqHeads + 2) * 8;
  static_assert(kRowData % 16 == 0 && kKeyData % 16 == 0 &&
                kExtra % 16 == 0, "misaligned");
};

// What the stream reads and writes: tensor maps over the strided views and
// plain pointers for the rest. `rows` is the query length; tm_k[1] and
// tm_v[1] are a second key source (DFlash's draft keys), unused by COD.
struct DqStream {
  CUtensorMap tm_q;      // q [B, H, rows, D] view
  CUtensorMap tm_do;     // dout [B, rows, H*D] as [B, H, rows, D]
  CUtensorMap tm_k[2];   // keys [B, KVH, *, D] views
  CUtensorMap tm_v[2];   // values
  const float* m;        // [B, H, rows], natural-log units
  const float* l;        // [B, H, rows]
  const float* delta;    // [B, H, rows], rowsum(dO * O)
  __nv_bfloat16* dq;     // [B, H, rows, D], contiguous
  int B, H, KVH, rows;
  int group;             // H / KVH, the query heads of a kv head
  int heads;             // query heads resident at once: 2 or kDqHeads
  float scale;
  float scale2;          // scale * log2(e)
};

// The block's coordinates and key tile count, written to shared memory
// before the role split and read back by each role after its setmaxnreg: a
// value kept in a register across setmaxnreg is spilled. The tiles
// themselves are the block's list at kExtra: entry j is 2 * key tile + a
// "needs no mask" bit; with a policy of two key sources
// (Policy::kSecondSource) the last tile is the second source's. Four more
// ints behind it (dq_setup) are the policy's during the block's setup.
struct DqBlock {
  int b, kvh, q0, n_tiles;
};

template <int D>
__device__ __forceinline__ DqBlock* dq_block_info(unsigned char* smem) {
  return reinterpret_cast<DqBlock*>(smem + DqStreamSmem<D>::kInfo);
}

template <int D>
__device__ __forceinline__ DqBlock load_dq_block(unsigned char* smem) {
  const volatile DqBlock* x = dq_block_info<D>(smem);
  return {x->b, x->kvh, x->q0, x->n_tiles};
}

template <int D>
__device__ __forceinline__ int* dq_setup(unsigned char* smem) {
  return reinterpret_cast<int*>(smem + DqStreamSmem<D>::kInfo + 16);
}

// the slots a consumer warpgroup owns: two heads, or one q tile
template <class Policy>
__host__ __device__ constexpr int dq_slots() {
  return Policy::kRowSlots ? 1 : kDqSlots;
}

// the slots resident in chunk c of a group of G heads: the heads from
// c * heads on, or (row slots, one chunk) the block's q tiles that start
// inside the rows
template <class Policy>
__device__ __forceinline__ int chunk_slots(const DqStream& p,
                                          const DqBlock& blk, int c, int G) {
  if constexpr (Policy::kRowSlots) {
    return min(p.heads, (p.rows - blk.q0 + kTileRows - 1) / kTileRows);
  } else {
    return min(p.heads, G - c * p.heads);
  }
}

// The barriers and the coordinates of a dq block, by thread 0, before the
// block's first __syncthreads
template <int D>
__device__ __forceinline__ void dq_init_block(unsigned char* smem, int b,
                                              int kvh, int q0) {
  if (threadIdx.x == 0) {
    DqBlock* info = dq_block_info<D>(smem);
    info->b = b;
    info->kvh = kvh;
    info->q0 = q0;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + DqStreamSmem<D>::kBars);
    for (int i = 0; i < kDqStages; ++i) {
      mbar_init(&bars[i], 64);              // full: the producer warps' lanes
      mbar_init(&bars[kDqStages + i], 256);  // empty: both consumer warpgroups
    }
    for (int i = 0; i < kDqHeads; ++i) mbar_init(&bars[2 * kDqStages + i], 64);
    mbar_init(&bars[2 * kDqStages + kDqHeads], 256);  // q_empty
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// p = 2^(s * scale2 - m2) / l in place, over this thread's 32 entries of a
// tile (entry 4j + e: row r0 for e < 2, else r1; key 8j + 2t + (e & 1)),
// from its rows' m2 and 1/l; kMasked keeps the entries whose bit is set
template <bool kMasked>
__device__ __forceinline__ void stream_dq_probs(float (&s)[32], uint32_t bits,
                                                float scale2,
                                                const float (&m2)[2],
                                                const float (&il)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool ok = !kMasked || ((bits >> i) & 1u) != 0;
    s[i] = ex2(masked_logit2(ok, s[i], scale2, m2[(i >> 1) & 1])) *
           il[(i >> 1) & 1];
  }
}

// The producer: warps 8 and 9, a row (and a key) a lane. Per chunk of the
// group's heads (or the block's q tiles) it loads each slot's Q and dO
// tiles and row statistics, then streams the block's listed key tiles
// through the ring; the policy writes a stage's key data (`stage_key`).
template <int D, class Policy>
__device__ __forceinline__ void dq_produce(const DqStream& p,
                                           const Policy& pol,
                                           unsigned char* smem) {
  using L = DqStreamSmem<D>;
  constexpr int kPanels = D / 64;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kDqStages;
  uint64_t* q_full = empty + kDqStages;
  uint64_t* q_empty = q_full + kDqHeads;
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  const int* list = reinterpret_cast<const int*>(smem + L::kExtra);
  const int r = threadIdx.x - 256;  // this lane's row and key
  const DqBlock blk = load_dq_block<D>(smem);
  const int G = p.group;
  int it = 0;  // ring items so far
  for (int c = 0; c * p.heads < G; ++c) {
    const int h0 = blk.kvh * G + c * p.heads;
    const int nh = chunk_slots<Policy>(p, blk, c, G);
    const int n0 = (nh + 1) / 2;  // the slots of consumer warpgroup 0
    if (c > 0) mbar_wait(q_empty, (c - 1) & 1);
    auto load_head = [&](int lh) {
      // slot lh: head h0 + lh of the block's q tile, or (row slots) q tile
      // lh of the block's rows of head h0
      const int hl = Policy::kRowSlots ? 0 : lh;
      const int q0 = Policy::kRowSlots ? blk.q0 + lh * kTileRows : blk.q0;
      if (r == 0) {
        mbar_expect_tx(&q_full[lh], 2 * L::kTile);
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load(smem + L::kQ + lh * L::kTile + pn * kPanelBytes, &p.tm_q,
                   &q_full[lh], pn * 64, q0, h0 + hl, blk.b);
          tma_load(smem + L::kDO + lh * L::kTile + pn * kPanelBytes,
                   &p.tm_do, &q_full[lh], pn * 64, q0, h0 + hl, blk.b);
        }
      }
      // rows past the end and rows with no allowed key (l = 0; with a
      // log-sum-exp for m, lse = -1e30 and l = 1 otherwise) get p = 0
      const int row = q0 + r;
      const bool in = row < p.rows;
      const long long at = ((long long)blk.b * p.H + h0 + hl) * p.rows + row;
      float lv = 0.f;
      if constexpr (!Policy::kLogSumExp) lv = in ? p.l[at] : 0.f;
      const float mv = in ? p.m[at] : 0.f;
      const float dl = in ? p.delta[at] : 0.f;
      if constexpr (Policy::kLogSumExp) {
        lv = in && mv > 0.5f * kNegInf ? 1.f : 0.f;
      }
      stats[lh * kTileRows + r] = lv > 0.f ? mv * kLog2e : kDeadRowM2;
      stats[(kDqHeads + lh) * kTileRows + r] = lv > 0.f ? 1.f / lv : 0.f;
      stats[(2 * kDqHeads + lh) * kTileRows + r] = dl;
      mbar_arrive(&q_full[lh]);
    };
    // each warpgroup's first head now, the others after the first K/V tile
    auto load_rest = [&]() {
      for (int lh = 1; lh < nh; ++lh) {
        if (lh != n0) load_head(lh);
      }
    };
    load_head(0);
    if (n0 < nh) load_head(n0);
    for (int j = 0; j < blk.n_tiles; ++j, ++it) {
      const int st = it % kDqStages;
      mbar_wait(&empty[st], ((it / kDqStages) & 1) ^ 1);
      const int entry = list[j];
      const int key0 = (entry >> 1) * kTileRows;
      const int src = Policy::kSecondSource && j + 1 == blk.n_tiles ? 1 : 0;
      if (r == 0) {
        unsigned char* dst = smem + L::kRing + st * L::kStage;
        mbar_expect_tx(&full[st], 2 * L::kTile);
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load(dst + pn * kPanelBytes, &p.tm_k[src], &full[st], pn * 64,
                   key0, blk.kvh, blk.b);
          tma_load(dst + L::kTile + pn * kPanelBytes, &p.tm_v[src],
                   &full[st], pn * 64, key0, blk.kvh, blk.b);
        }
      }
      pol.stage_key(smem + L::kKeyData + st * kTileRows * 16, blk, entry,
                    key0, r);
      mbar_arrive(&full[st]);
      if (j == 0) load_rest();
    }
    // the consumers wait for every head before the epilogue
    if (blk.n_tiles == 0) load_rest();
  }
}

// One stage of a consumer warpgroup: tile j of the block's list (item it
// of the ring) against the warpgroup's n_own heads from local head lh0 on,
// dq of each in fp32 registers. kSecond marks the block's last tile when it
// comes from the second key source; only that instance hands a head's p
// and ds to the policy (`tile_done`), so the context tiles' loop carries
// none of that code. With row slots a slot past its own tile count skips
// the stage, and the policy decides each slot's mask.
template <bool kSecond, int D, class Policy>
__device__ __forceinline__ void dq_stage(
    const DqStream& p, const Policy& pol, unsigned char* smem,
    float (&dq)[dq_slots<Policy>()][D / 2], int c, int j, int it, int n_own,
    int lh0) {
  using L = DqStreamSmem<D>;
  // this thread's rows r0 and r0 + 8 and its key pair t, from the thread
  // index read here (values kept across the stages crowd the registers)
  unsigned tx;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tx));
  const int r0 = (tx % 128) / 32 * 16 + (tx % 32) / 4;
  const int t = tx % 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = full + 2 * kDqStages;
  const float* sM = reinterpret_cast<const float*>(smem + L::kStats);
  const float* sIL = sM + kDqHeads * kTileRows;
  const float* sDl = sIL + kDqHeads * kTileRows;
  const int st = it % kDqStages;
  const uint32_t sK = smem_u32(smem + L::kRing + st * L::kStage);
  const uint32_t sV = sK + L::kTile;
  mbar_wait(&full[st], (it / kDqStages) & 1);
  // the stage's mask, once for both heads, before their products, and
  // kept in shared memory while they run: a register beside their
  // accumulators and two heads' dq would be spilled
  const int entry = reinterpret_cast<const int*>(smem + L::kExtra)[j];
  const bool tile_free = (entry & 1) != 0;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L::kBits) + threadIdx.x;
  if constexpr (!Policy::kRowSlots) {
    if (!tile_free && n_own != 0) {
      *bits = pol.tile_bits(smem + L::kRowData,
                            smem + L::kKeyData + st * kTileRows * 16,
                            (entry >> 1) * kTileRows, kSecond, r0, t);
    }
  }
#pragma unroll
  for (int sl = 0; sl < dq_slots<Policy>(); ++sl) {
    if (sl >= n_own) break;
    const int lh = lh0 + sl;
    bool free = tile_free;
    if constexpr (Policy::kRowSlots) {
      if (j >= pol.slot_tiles(smem + L::kRowData, lh)) continue;
      free = pol.slot_free(smem + L::kRowData, lh, j, entry);
      if (!free) {
        *bits = pol.slot_bits(smem + L::kRowData,
                              smem + L::kKeyData + st * kTileRows * 16, lh,
                              r0, t);
      }
    }
    const int r1 = r0 + 8;
    const uint32_t sQ = smem_u32(smem + L::kQ + lh * L::kTile);
    const uint32_t sDO = smem_u32(smem + L::kDO + lh * L::kTile);
    if (j == 0) mbar_wait(&q_full[lh], c & 1);  // the head's tiles
    // s = Q K^T and dp = dO V^T, 64 rows x 64 keys, as two groups: the exp
    // below runs while the tensor cores form dp
    float s[32], dp[32];
    wgmma_fence();
    wgmma_tile_product<D>(s, sQ, sK);
    wgmma_commit();
    wgmma_tile_product<D>(dp, sDO, sV);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    // the rows' statistics, read here where they are used (held beside two
    // heads' dq they would crowd the registers)
    const float mr[2] = {sM[lh * kTileRows + r0], sM[lh * kTileRows + r1]};
    const float ilr[2] = {sIL[lh * kTileRows + r0], sIL[lh * kTileRows + r1]};
    if (free) {
      stream_dq_probs<false>(s, 0u, p.scale2, mr, ilr);
    } else {
      stream_dq_probs<true>(s, *bits, p.scale2, mr, ilr);
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // ds = p (dp - delta), as the A fragments of dq += ds K (K read
    // MN-major)
    const float dlr[2] = {sDl[lh * kTileRows + r0], sDl[lh * kTileRows + r1]};
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
    if constexpr (kSecond) pol.tile_done(smem, lh, s, da, r0, t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq[sl], da[kk], sK, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq[sl]);
    fence_regs(da);
  }
  mbar_arrive(&full[kDqStages + st]);  // empty[st]
}

// The consumers: warpgroup 0 owns the first (nh + 1) / 2 slots of each
// chunk, warpgroup 1 the rest. The policy gives a thread's 32 mask bits of
// a stage that needs a mask (`tile_bits`), takes a head's p and ds of the
// second source's tile (`tile_done`) and closes a chunk (`chunk_done`,
// told whether it is the last) before its dq leaves.
template <int D, class Policy>
__device__ __forceinline__ void dq_consume(const DqStream& p,
                                           const Policy& pol,
                                           unsigned char* smem) {
  using L = DqStreamSmem<D>;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars) +
                     2 * kDqStages;
  uint64_t* q_empty = q_full + kDqHeads;
  const DqBlock blk = load_dq_block<D>(smem);
  const int wg = threadIdx.x / 128;
  const int G = p.group;
  // the listed tiles before the second source's
  const int n_first = blk.n_tiles - (Policy::kSecondSource ? 1 : 0);
  for (int c = 0; c * p.heads < G; ++c) {
    int nh = chunk_slots<Policy>(p, blk, c, G);
    const int n_own = wg == 0 ? (nh + 1) / 2 : nh / 2;
    const int lh0 = wg == 0 ? 0 : (nh + 1) / 2;  // first local slot owned
    float dq[dq_slots<Policy>()][D / 2];
#pragma unroll
    for (int sl = 0; sl < dq_slots<Policy>(); ++sl) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[sl][i] = 0.f;
    }
    for (int j = 0; j < n_first; ++j) {
      dq_stage<false, D>(p, pol, smem, dq, c, j, c * blk.n_tiles + j, n_own,
                         lh0);
    }
    if constexpr (Policy::kSecondSource) {
      dq_stage<true, D>(p, pol, smem, dq, c, n_first,
                        c * blk.n_tiles + n_first, n_own, lh0);
    }

    // dq of the warpgroup's heads leaves first, staged as bf16 in the ring
    // (idle now: the producer streams the next chunk's tiles only after
    // q_empty) and written in whole rows, so the policy's chunk_done runs
    // without two heads' dq in registers. The rest rereads what it needs
    // (the thread index, the block from shared memory, nh from an opaque
    // copy of c): values held across the tile loop crowd the registers
    // beside dq.
    consumers_sync();  // both warpgroups are done with the ring's stages
    unsigned tx;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tx));
    const int tid = tx % 128;
#pragma unroll
    for (int sl = 0; sl < dq_slots<Policy>(); ++sl) {
      if (sl >= n_own) break;
      stage_tile<D>(smem + L::kRing + (lh0 + sl) * L::kTile, dq[sl], p.scale,
                    p.scale, tid / 32 * 16 + (tid % 32) / 4, tid % 4);
    }
    warpgroup_sync(wg);
    const DqBlock bk = load_dq_block<D>(smem);
    int cc = c;
    asm volatile("" : "+r"(cc));
    for (int sl = 0; sl < n_own; ++sl) {
      const int h = Policy::kRowSlots ? bk.kvh * G
                                      : bk.kvh * G + cc * p.heads + lh0 + sl;
      const int q0 =
          Policy::kRowSlots ? bk.q0 + (lh0 + sl) * kTileRows : bk.q0;
      copy_tile_rows<D>(
          p.dq + (((long long)bk.b * p.H + h) * p.rows + q0) * D, D,
          smem + L::kRing + (lh0 + sl) * L::kTile, p.rows - q0, tid);
    }
    nh = chunk_slots<Policy>(p, bk, cc, G);
    // every head of the chunk has landed (a block with no key tile never
    // waited for them, and the policy's chunk_done may read them all)
    for (int lh = 0; lh < nh; ++lh) mbar_wait(&q_full[lh], cc & 1);
    pol.chunk_done(smem, bk, cc, (cc + 1) * p.heads >= G, nh, tx / 128,
                   tid);
    // this chunk's tiles are read; the next chunk's copies may refill them
    // (ordered after the generic stores of the staged dq)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(q_empty);
  }
}

// One dq block, called by every thread after the block info (with its key
// tile count), the tile list, the rows' mask data and the policy's memory
// are written and the block has synchronised.
template <int D, class Policy>
__device__ __forceinline__ void dq_stream_block(const DqStream& p,
                                                const Policy& pol,
                                                unsigned char* smem) {
  if (threadIdx.x >= 256) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x < 320) dq_produce<D>(p, pol, smem);
    return;
  }
  reg_alloc<kConsumerRegs>();
  dq_consume<D>(p, pol, smem);
}

// The tensor maps and pointers of the stream: q and the keys and values
// with their element strides over (b, head, row), dout contiguous [B, rows,
// H*D]; k2/v2 (a second key source of keys2 rows) may be null. False if a
// map cannot be made.
bool fill_dq_stream(DqStream& s, const void* q, const long long* q_strides,
                    const void* k, const long long* k_strides, const void* v,
                    const long long* v_strides, int keys, const void* k2,
                    const long long* k2_strides, const void* v2,
                    const long long* v2_strides, int keys2, const void* dout,
                    const float* m, const float* l, const float* delta,
                    void* dq, int B, int H, int KVH, int rows, int D,
                    int heads) {
  memset(&s, 0, sizeof(s));
  bool ok =
      encode_bhsd(&s.tm_q, q, B, H, rows, D, q_strides[0], q_strides[1],
                  q_strides[2]) &&
      encode_bhsd(&s.tm_do, dout, B, H, rows, D, (long long)rows * H * D, D,
                  (long long)H * D) &&
      encode_bhsd(&s.tm_k[0], k, B, KVH, keys, D, k_strides[0], k_strides[1],
                  k_strides[2]) &&
      encode_bhsd(&s.tm_v[0], v, B, KVH, keys, D, v_strides[0], v_strides[1],
                  v_strides[2]);
  if (k2 != nullptr) {
    ok = ok &&
         encode_bhsd(&s.tm_k[1], k2, B, KVH, keys2, D, k2_strides[0],
                     k2_strides[1], k2_strides[2]) &&
         encode_bhsd(&s.tm_v[1], v2, B, KVH, keys2, D, v2_strides[0],
                     v2_strides[1], v2_strides[2]);
  }
  s.m = m;
  s.l = l;
  s.delta = delta;
  s.dq = static_cast<__nv_bfloat16*>(dq);
  s.B = B;
  s.H = H;
  s.KVH = KVH;
  s.rows = rows;
  s.group = H / KVH;
  s.heads = heads;
  s.scale = 1.0f / sqrtf(static_cast<float>(D));
  s.scale2 = s.scale * kLog2e;
  return ok && (heads == 2 || heads == kDqHeads);
}

// dynamic shared memory of a dq block with `extra` bytes of the policy's
// (+ alignment slack)
int dq_smem_bytes(int D, int extra) {
  const int fixed = D == 128 ? DqStreamSmem<128>::kExtra
                             : DqStreamSmem<64>::kExtra;
  return fixed + extra + 1024;
}

}  // namespace
