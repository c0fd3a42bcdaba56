// The dk/dv stream shared by the DFlash context-key kernel
// (dflash_attention.cu), the COD kernel (peagle_attention.cu) and the LSE
// ring-hop kernel (lse_attention.cu).
//
// Replaces, with the mask policy of each source, the Pallas kernels
// `_bwd_dkv_kernel` of specforge_tpu/ops/dflash_pallas.py and of
// specforge_tpu/ops/peagle_pallas.py, and `_lse_bwd_dkv_kernel` of
// specforge_tpu/ops/attention_pallas.py: dk = scale * ds^T Q and dv = p^T dO
// of a 64-key tile, summed over the query heads of its GQA group, with
// p = exp(s - m) / l recomputed from the forward's row statistics and
// ds = p * (dO V^T - delta).
//
// What bounds it on this card: four 64 x 64 x D products per (query head,
// q tile) item that reaches the keys, on the tensor cores (4.19 MFLOP at
// D = 128, 0.56 us at one SM's share of the bf16 peak), against 32 KB of
// Q/dO read per item: bound by operations, and by the heaviest block's
// item count when the blocks are uneven.
//
// What the design does about it (the shape of ttt_bwd_dkv_kernel). A block
// of 384 threads owns 64 keys of one (batch, kv head): K and V land once by
// TMA. Its items are the (query head of the group, q tile) pairs whose
// rows may reach the keys, from a list the block builds first; consumer
// warpgroup 0 takes the first half of the stream, warpgroup 1 the second,
// each with its own ring of Q/dO stages fed by two producer warps
// (`setmaxnreg` 24 for the producers, 240 for the consumers). One producer
// lane issues the stage's TMA copies first; then the two warps' lanes, a
// row each, write what travels with the tile (m in log2 units, 1/l, delta,
// the rows' mask data and "mask-free" flags) and arrive on the stage's
// barrier. Per item a
// warpgroup runs s^T = K Q^T and dp^T = V dO^T (B from the swizzled stage),
// then dv += p^T dO and dk += ds^T Q with A from the registers the first
// products left; p is one FMA and one `ex2`, the mask a select to -inf,
// skipped on mask-free stages. dk and dv stay in fp32 registers; the two
// partials are added through shared memory in a fixed order and leave as
// whole bf16 rows. No atomics: two runs give the same bits, and a block
// no item reaches writes exact zeros. Rows and keys past the end are
// zero-filled by TMA and carry no allowed pair. A policy whose m is a
// log-sum-exp (Policy::kLogSumExp, the LSE op) has l = 1; its rows with no
// allowed key (lse = -1e30) get m2 = +1e30 and 1/l = 0, so their p is 0
// even on a stage without the mask.
#pragma once

#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kDkvThreads = kHopperThreads;
constexpr int kDkvStages = 2;     // Q/dO stages of each warpgroup's ring

// What travels with a stage, byte offsets inside its row block: m in log2
// units, 1/l and delta of the 64 rows (fp32), the rows' mask data (16
// bytes a row, the policy's), the "mask-free" flags of rows 0-31 and 32-63.
constexpr int kRowM2 = 0;
constexpr int kRowIl = kTileRows * 4;
constexpr int kRowDelta = 2 * kTileRows * 4;
constexpr int kRowMask = 3 * kTileRows * 4;
constexpr int kRowFlag = kRowMask + kTileRows * 16;
constexpr int kRowBytes = kRowFlag + 16;

// Shared memory of a dk/dv block, byte offsets from a 1024-aligned base;
// the item list (one int per q tile) follows kList.
template <int D>
struct DkvStreamSmem {
  static constexpr int kTile = kTileRows * D * 2;  // D / 64 swizzled panels
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kStage = 2 * kTile;  // Q, then dO
  static constexpr int kRing = 2 * kTile;   // [2 rings][kDkvStages]
  static constexpr int kRingBytes = kDkvStages * kStage;
  static constexpr int kRows = kRing + 2 * kRingBytes;  // [2][kDkvStages]
  static constexpr int kBars = kRows + 2 * kDkvStages * kRowBytes;
  // 4 * kDkvStages + 1 barriers, padded so the int4 key data align
  static constexpr int kInfo = kBars + (4 * kDkvStages + 2) * 8;  // DkvBlock
  static constexpr int kKeys = kInfo + 16;  // the policy's key data, 16 a key
  static constexpr int kList = kKeys + kTileRows * 16;
  // the epilogue hands one fp32 [64 x D] partial across in a ring's memory,
  // and stages a bf16 result behind it
  static_assert(kTileRows * D * 6 <= kRingBytes, "epilogue does not fit");
  static_assert(kBars % 16 == 0 && kKeys % 16 == 0, "misaligned");
};

// dynamic shared memory of a dk/dv block whose item list holds n q tiles
// (+ alignment slack)
int dkv_smem_bytes(int D, int n) {
  const int fixed = D == 128 ? DkvStreamSmem<128>::kList
                             : DkvStreamSmem<64>::kList;
  return fixed + n * 4 + 1024;
}

// What the stream reads and writes: tensor maps over the strided views and
// plain pointers for the rest. `rows` is the query length (Q or T), `keys`
// the key length (S or T).
struct DkvStream {
  CUtensorMap tm_q;   // q [B, H, rows, D] view
  CUtensorMap tm_do;  // dout [B, rows, H*D] as [B, H, rows, D]
  CUtensorMap tm_k;   // keys [B, KVH, keys, D] view
  CUtensorMap tm_v;   // values
  const float* m;     // [B, H, rows], natural-log units
  const float* l;     // [B, H, rows]
  const float* delta;  // [B, H, rows], rowsum(dO * O)
  __nv_bfloat16* dk;  // [B, KVH, keys, D], contiguous
  __nv_bfloat16* dv;
  int B, H, KVH, rows, keys;
  float scale;
};

// The block's coordinates and item count, written to shared memory before
// the role split and read back by each role after its setmaxnreg: a value
// kept in a register across setmaxnreg is spilled.
struct DkvBlock {
  int b, kvh, key0, n_list;
};

template <int D>
__device__ __forceinline__ DkvBlock* block_info(unsigned char* smem) {
  return reinterpret_cast<DkvBlock*>(smem + DkvStreamSmem<D>::kInfo);
}

template <int D>
__device__ __forceinline__ DkvBlock load_block(unsigned char* smem) {
  const volatile DkvBlock* x = block_info<D>(smem);
  return {x->b, x->kvh, x->key0, x->n_list};
}

// p^T = 2^(s^T * scale2 - m2) / l in place, over this thread's 32 entries
// of the tile (keys kr0 / kr0 + 8 x queries 8j + 2t + {0, 1}), from the
// stage's row block; kMasked applies the policy's mask to each pair, from
// the keys' data it reads for the item (the plain instance serves the
// mask-free stages).
template <bool kMasked, class Policy>
__device__ __forceinline__ void stream_probs(
    float (&s)[32], const unsigned char* rows, const Policy& pol,
    const unsigned char* key_data, const DkvBlock& blk, float scale2,
    int kr0, int t) {
  const float* m2 = reinterpret_cast<const float*>(rows + kRowM2);
  const float* il = reinterpret_cast<const float*>(rows + kRowIl);
  typename Policy::Keys keys{};
  if constexpr (kMasked) keys = pol.keys(key_data, blk, kr0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qc = 8 * j + 2 * t;
    const float2 mq = *reinterpret_cast<const float2*>(m2 + qc);
    const float2 iq = *reinterpret_cast<const float2*>(il + qc);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      typename Policy::Row row{};
      if constexpr (kMasked) row = pol.row(rows + kRowMask, qc + c);
#pragma unroll
      for (int kx = 0; kx < 2; ++kx) {
        const int e = 2 * kx + c;  // key kr0 / kr1, query qc / qc + 1
        bool ok = true;
        if constexpr (kMasked) ok = pol.allow(keys, kx, row);
        s[4 * j + e] = ex2(masked_logit2(ok, s[4 * j + e], scale2,
                                         c ? mq.y : mq.x)) *
                       (c ? iq.y : iq.x);
      }
    }
  }
}

// One dk/dv block: 64 keys [key0, key0 + 64) of (b, kvh) (from the block's
// DkvBlock), over the items it = 0 .. G * n_list - 1, item it being query
// head kvh * G + it / n_list of q tile list[it % n_list] / 2. The policy
// writes each stage's rows' mask data (`stage_row`, by the producer lanes,
// returning whether the row needs no mask), says whether the tile needs
// none (`tile_free`, from the list entry's tile bit and the rows), reads
// the keys' data for an item (`keys`) and tests a (key, row) pair
// (`allow`). Called by every thread of the block, after the block info,
// the key data and the list are written.
template <int D, class Policy>
__device__ __forceinline__ void dkv_stream_block(const DkvStream& p,
                                                 const Policy& pol,
                                                 unsigned char* smem) {
  using L = DkvStreamSmem<D>;
  constexpr int kPanels = D / 64;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);  // [2][2]
  uint64_t* empty = full + 2 * kDkvStages;                         // [2][2]
  uint64_t* kv_full = empty + 2 * kDkvStages;
  const int* list = reinterpret_cast<const int*>(smem + L::kList);
  const int G = p.H / p.KVH;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // producer: warps 2r and 2r + 1 feed ring r, rows 0-31 and 32-63 of
    // each stage (a row a lane: the producer has 24 registers); warp 0
    // first stages K and V
    reg_dealloc<kProducerRegs>();
    const int pw = (threadIdx.x / 32) % 4;
    const int ring = pw >> 1;
    const int r = (pw & 1) * 32 + threadIdx.x % 32;  // this lane's row
    const DkvBlock blk = load_block<D>(smem);
    const int b = blk.b;
    if (r == 0 && ring == 0) {
      mbar_expect_tx(kv_full, 2 * L::kTile);
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load(smem + L::kK + pn * kPanelBytes, &p.tm_k, kv_full, pn * 64,
                 blk.key0, blk.kvh, b);
        tma_load(smem + L::kV + pn * kPanelBytes, &p.tm_v, kv_full, pn * 64,
                 blk.key0, blk.kvh, b);
      }
      mbar_arrive(kv_full);
    }
    const int n_items = G * blk.n_list;
    const int half = (n_items + 1) / 2;
    const int count = ring == 0 ? half : n_items - half;
    // the first item's (head, list entry); then counted up, not divided
    int hi = ring == 0 || count == 0 ? 0 : half / blk.n_list;
    int li = ring == 0 || count == 0 ? 0 : half - hi * blk.n_list;
    for (int i = 0; i < count; ++i) {
      const int slot = ring * kDkvStages + i % kDkvStages;
      mbar_wait(&empty[slot], ((i / kDkvStages) & 1) ^ 1);
      const int h = blk.kvh * G + hi;
      const int entry = list[li];
      const int q0 = (entry >> 1) * kTileRows;
      if (++li == blk.n_list) {
        li = 0;
        ++hi;
      }
      if (r == 0) {
        unsigned char* dst = smem + L::kRing + slot * L::kStage;
        mbar_expect_tx(&full[slot], 2 * L::kTile);
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load(dst + pn * kPanelBytes, &p.tm_q, &full[slot], pn * 64, q0,
                   h, b);
          tma_load(dst + L::kTile + pn * kPanelBytes, &p.tm_do, &full[slot],
                   pn * 64, q0, h, b);
        }
      }
      // the row data travel with their tile: statistics (rows past the end
      // get 0, so their p is 0), the policy's mask data, and a flag of each
      // half of the rows
      unsigned char* rows = smem + L::kRows + slot * kRowBytes;
      const int row = q0 + r;
      const bool in = row < p.rows;
      const long long at = ((long long)b * p.H + h) * p.rows + row;
      const float mv = in ? p.m[at] : 0.f;
      float lv = 0.f;
      if constexpr (!Policy::kLogSumExp) lv = in ? p.l[at] : 0.f;
      const float dl = in ? p.delta[at] : 0.f;
      const bool row_free = pol.stage_row(rows + kRowMask, blk, q0, r);
      if constexpr (Policy::kLogSumExp) {
        const bool live = in && mv > 0.5f * kNegInf;
        reinterpret_cast<float*>(rows + kRowM2)[r] =
            live ? mv * kLog2e : kDeadRowM2;
        reinterpret_cast<float*>(rows + kRowIl)[r] = live ? 1.f : 0.f;
      } else {
        reinterpret_cast<float*>(rows + kRowM2)[r] = mv * kLog2e;
        reinterpret_cast<float*>(rows + kRowIl)[r] =
            in ? 1.f / fmaxf(lv, 1e-30f) : 0.f;
      }
      reinterpret_cast<float*>(rows + kRowDelta)[r] = dl;
      const bool free_half =
          pol.tile_free(entry & 1, __all_sync(0xffffffffu, row_free));
      if (r % 32 == 0) {
        reinterpret_cast<int*>(rows + kRowFlag)[r / 32] = free_half;
      }
      mbar_arrive(&full[slot]);
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const DkvBlock blk = load_block<D>(smem);
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kr0 = warp * 16 + g;  // this thread's two keys in the tile
  const float scale2 = p.scale * kLog2e;
  const unsigned char* key_data = smem + L::kKeys;
  const int n_items = G * blk.n_list;
  const int half = (n_items + 1) / 2;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  const uint32_t sK = smem_u32(smem + L::kK);
  const uint32_t sV = smem_u32(smem + L::kV);
  const int count = wg == 0 ? half : n_items - half;
  for (int i = 0; i < count; ++i) {
    const int slot = wg * kDkvStages + i % kDkvStages;
    const uint32_t sQ = smem_u32(smem + L::kRing + slot * L::kStage);
    const uint32_t sDO = sQ + L::kTile;
    const unsigned char* rows = smem + L::kRows + slot * kRowBytes;
    mbar_wait(&full[slot], (i / kDkvStages) & 1);

    // s^T = K Q^T and dp^T = V dO^T, 64 keys x 64 queries, as two groups:
    // the exp below runs while the tensor cores still form dp
    float s[32], dp[32];
    wgmma_fence();
    wgmma_tile_product<D>(s, sK, sQ);
    wgmma_commit();
    wgmma_tile_product<D>(dp, sV, sDO);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // p^T under the mask (read only after the wait: the producer writes the
    // flag with the stage), kept in s and as the A fragments (keys x 16
    // queries) of dv += p^T dO (dO read MN-major), which then runs while
    // ds^T = p^T (dp^T - delta) is formed
    const int* flags = reinterpret_cast<const int*>(rows + kRowFlag);
    if (flags[0] == 0 || flags[1] == 0) {
      stream_probs<true>(s, rows, pol, key_data, blk, scale2, kr0, t);
    } else {
      stream_probs<false>(s, rows, pol, key_data, blk, scale2, kr0, t);
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
    const float* dls = reinterpret_cast<const float*>(rows + kRowDelta);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
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
  float* give =
      reinterpret_cast<float*>(smem + L::kRing + wg * L::kRingBytes);
  const float* take = reinterpret_cast<const float*>(
      smem + L::kRing + (1 - wg) * L::kRingBytes);
  // the sums leave as bf16 staged behind the other's hand-over, in whole
  // rows
  unsigned char* staged =
      smem + L::kRing + (1 - wg) * L::kRingBytes + kTileRows * D * 4;
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) give[i * 128 + tid] = dv[i];
    consumers_sync();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] += take[i * 128 + tid];
    stage_tile<D>(staged, dk, p.scale, p.scale, kr0, t);
  } else {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) give[i * 128 + tid] = dk[i];
    consumers_sync();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] += take[i * 128 + tid];
    stage_tile<D>(staged, dv, 1.f, 1.f, kr0, t);
  }
  warpgroup_sync(wg);
  copy_tile_rows<D>((wg == 0 ? p.dk : p.dv) +
                        ((long long)blk.b * p.KVH + blk.kvh) * p.keys * D +
                        (long long)blk.key0 * D,
                    D, staged, p.keys - blk.key0, tid);
}

// The barriers and the coordinates of a dk/dv block, by thread 0, before
// the block's first __syncthreads (the list's)
template <int D>
__device__ __forceinline__ void dkv_init_block(unsigned char* smem, int b,
                                               int kvh, int key0) {
  if (threadIdx.x == 0) {
    DkvBlock* info = block_info<D>(smem);
    info->b = b;
    info->kvh = kvh;
    info->key0 = key0;
    uint64_t* full =
        reinterpret_cast<uint64_t*>(smem + DkvStreamSmem<D>::kBars);
    for (int i = 0; i < 2 * kDkvStages; ++i) {
      mbar_init(&full[i], 64);                   // the producer warps' lanes
      mbar_init(&full[2 * kDkvStages + i], 128);  // the consuming warpgroup
    }
    mbar_init(&full[4 * kDkvStages], 1);  // K and V
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The four tensor maps and the pointers of the stream; q and the keys and
// values with their element strides over (b, head, row), dout contiguous
// [B, rows, H*D]. False if a map cannot be made.
bool fill_stream(DkvStream& s, const void* q, const long long* q_strides,
                 const void* k, const long long* k_strides, const void* v,
                 const long long* v_strides, const void* dout, const float* m,
                 const float* l, const float* delta, void* dk, void* dv,
                 int B, int H, int KVH, int rows, int keys, int D) {
  memset(&s, 0, sizeof(s));
  const bool ok =
      encode_bhsd(&s.tm_q, q, B, H, rows, D, q_strides[0], q_strides[1],
                  q_strides[2]) &&
      encode_bhsd(&s.tm_do, dout, B, H, rows, D, (long long)rows * H * D, D,
                  (long long)H * D) &&
      encode_bhsd(&s.tm_k, k, B, KVH, keys, D, k_strides[0], k_strides[1],
                  k_strides[2]) &&
      encode_bhsd(&s.tm_v, v, B, KVH, keys, D, v_strides[0], v_strides[1],
                  v_strides[2]);
  s.m = m;
  s.l = l;
  s.delta = delta;
  s.dk = static_cast<__nv_bfloat16*>(dk);
  s.dv = static_cast<__nv_bfloat16*>(dv);
  s.B = B;
  s.H = H;
  s.KVH = KVH;
  s.rows = rows;
  s.keys = keys;
  s.scale = 1.0f / sqrtf(static_cast<float>(D));
  return ok;
}

}  // namespace
