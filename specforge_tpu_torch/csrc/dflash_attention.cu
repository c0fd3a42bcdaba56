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
// (`wgmma`, bf16 in, fp32 accumulate) from two consumer warpgroups of a
// 384-thread block, fed through a TMA/`mbarrier` ring by two producer warps
// (`setmaxnreg` 24; the consumers 240); no score tile reaches device
// memory; nothing is padded or copied (the ragged ends of the context and
// of the draft rows are zero-filled by TMA and masked); no atomics, so two
// runs give the same bits.
// The forward and kernel A (dq and the draft keys' dk/dv) share one block
// setup (dflash_block_tiles) and one mask policy (DFlashMask): a block owns
// a q tile of 64 rows of one (batch, kv head) and four of the group's query
// heads at a time, two per consumer warpgroup, so each K/V tile is staged
// once for all of them; the q tile is the grid's slow index, later tiles
// first (later anchors reach more context). The block writes its rows'
// spans and lists the context tiles its kept rows reach, each with a
// "needs no mask" bit (every kept row reaches all 64 keys: at the Domino
// slice most of a q tile's context tiles lie below its smallest anchor),
// then its own 64 draft keys as the stream's second key source, a tile
// always masked (block-diagonal, and by offset under a window).
// The forward (fwd_stream.cuh) runs S = Q K^T, the online softmax (m in
// log2 units, one FMA and one `ex2` a score) and O += P V with P from
// registers, one head's softmax while the tensor cores form the other's
// products; a larger group runs as blocks of four heads (D = 64's group of
// 7 as 4 and 3). O / l leaves in bf16 straight into [B, Q, H*D], m (natural
// log units) and l in fp32 beside it. The forward has no dead-row rule on
// an unmasked tile, so a tile is mask-free there only if every row of the
// q tile is kept; a q tile with no kept row lists nothing and writes out 0,
// m = -1e30, l = 0.
// Kernel A (dq_stream.cuh) runs s, dp and dq += ds K on `wgmma` with dq in
// fp32 registers (a group of more than four heads in chunks). The draft
// tile's p and ds live only on the bs x bs diagonal blocks, which are
// staged compactly, and the block sums the draft dk/dv over its group's
// heads in fp32 in a fixed order and writes them once per kv head.
// Kernel B, the context keys' dk/dv, is bound by its four products per
// (query head, q tile) item that reaches a key tile: at the Domino slice
// 27,936 items over 192 blocks, the heaviest (key tile 0, every q tile of
// the four heads) 256 items. It follows ttt_bwd_dkv_kernel
// (dkv_stream.cuh): a block owns 64 context keys of one (batch, kv head),
// K and V by TMA once, and first lists the q tiles whose kept anchors
// reach its keys; two consumer warpgroups split the group's (head, q tile)
// stream, each fed a ring of Q/dO stages by two producer warps, and run
// all four products on `wgmma` with dk, dv in fp32 registers. Each row's
// context span [lo, hi) travels with its stage; a tile whose rows all
// reach every key of the block skips the mask (at the Domino slice most
// do: the key tile lies below the q tile's smallest anchor). The key tile
// is the grid's slow index, so without a window the heaviest blocks start
// first. The kernels share the Hopper helpers of hopper.cuh.
//
// Block sizes. The kernels take any block size bs from 1 to 64 (the TPU
// kernel takes any; DSpark's configs use 7). The q tile, the draft band
// and kernel B's q-tile list all need a block that divides the 64-row
// tile, so the kernels work on a block pitch: each block of bs rows is
// laid out at the smallest power of two >= bs (8 for 7), and rows and
// draft keys at offsets bs..pitch-1 are padding. The wrapper
// (ops/dflash_attention_cuda.py) copies q and the draft keys and values
// into that layout, and dO, m, l and delta in the backward (a padded row
// gets m = -1e30, l = 0, so the dq stream's dead-row rule holds for it),
// and copies out, m, l, dq and the draft dk/dv back; with bs a power of
// two it copies nothing and the layout is the caller's. The kernels are
// templated on kPitched: a padded row is dead (row_span, and kernel B's
// DFlashRows) like a row of a block not kept, and a padded draft key is
// outside every row's draft span [n * pitch, n * pitch + bs); the builds
// with kPitched false are the kernels without padding. What the pitch
// costs: pitch / bs of the rows (8/7 at bs 7) in every product, the copies
// (at the qwen3-4b-dspark shapes, B=2, H=32, N=256, D=128, about 30 MB
// each way for q, a seventh of that for each draft tensor), and the
// forward's and kernel B's mask-free context tiles: the forward's
// unmasked tiles have no dead-row rule, so a q tile is mask-free only
// when every row is kept, and kernel B's stage needs no mask only when
// every row of it reaches every key of the block, which a padded row
// does not; with bs < pitch every 64-row tile holds padded rows, so every
// stage of both is masked (kernel A keeps its mask-free tiles: it decides
// over the kept rows, and its dead-row rule gives the others p = 0).
// chip_smoke.py times the cases f_block7 and g_block7_d64 beside the
// bs-16 ones, and profiles the copies beside the kernels.

#include <limits.h>

#include "dkv_stream.cuh"
#include "fwd_stream.cuh"

namespace {

// D[16x8] += A[16x16] * B[16x8], bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, each transposed; lane l gives
// the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The allowed keys of query row r of batch b: context keys [x, y), draft
// keys [z, w). Both are empty for a row past Q, of a block not kept or
// (kPitched) at a padded offset bs..pitch-1 of its block. P is the
// forward's DFlashFwdParams or the dq kernel's DFlashDqParams (the anchors,
// keep, N, S, Q, pitch, bs and window of both).
template <bool kPitched, class P>
__device__ __forceinline__ int4 row_span(const P& p, int b, int r) {
  int lo = 0, hi = 0, dlo = 0, dhi = 0;
  if (r < p.Q) {
    const int n = r / p.pitch;
    const long long i = (long long)b * p.N + n;
    if (p.keep[i] != 0 && (!kPitched || r % p.pitch < p.bs)) {
      const int a = p.anchors[i];
      hi = min(max(a, 0), p.S);
      if (p.window > 0) {
        lo = min(max(a + r % p.pitch - (p.window - 1), 0), hi);
      }
      dlo = n * p.pitch;
      dhi = p.window > 0 ? r + 1 : dlo + (kPitched ? p.bs : p.pitch);
    }
  }
  return make_int4(lo, hi, dlo, dhi);
}

// --------------------------------------------------------------------------
// forward and backward kernel A: a q tile against its context tiles and
// its own draft keys
// --------------------------------------------------------------------------

struct DFlashFwdParams {
  FwdStream s;          // rows = Q, keys = S (the context); out [B, Q, H*D]
  CUtensorMap tm_kd;    // the draft keys [B, KVH, Q, D] view: the second
  CUtensorMap tm_vd;    // key source, and the draft values
  const int* anchors;   // [B, N]
  const int* keep;      // [B, N], 0 = block not kept
  int S, Q, N, pitch, window;  // Q = N * pitch rows (block_pitch)
  int n_chunks;         // blocks of a (q tile, kv head): ceil(group / 4)
  int bs;               // the real rows of a block: pitch, or fewer
};

struct DFlashDqParams {
  DqStream s;           // rows = Q; tm_k[0], tm_v[0]: the context (S keys),
                        // tm_k[1], tm_v[1]: the draft keys (Q)
  const int* anchors;   // [B, N]
  const int* keep;      // [B, N], 0 = block not kept
  __nv_bfloat16* dkd;   // [B, KVH, Q, D]: the draft keys' dk, group-summed
  __nv_bfloat16* dvd;   // [B, KVH, Q, D]
  float* ws;            // [2, B, KVH, Q, D] fp32 when the group spans chunks
  int S, Q, N, pitch, window;  // Q = N * pitch rows (block_pitch)
  int band_shift;       // log2 of the draft band's width, max(pitch, 16)
  int band_off;         // byte offset of the draft staging in shared memory
  int bs;               // the real rows of a block: pitch, or fewer
};

// The DFlash policy of the forward and dq streams (P: their parameters). A
// block lists the context tiles that its kept rows reach, then its own 64
// draft keys (the second key source, the block's last tile). Each row's
// spans (lo, hi, dlo, dhi) are the rows' mask data; a context tile needs no
// mask when every kept row reaches all of its keys (and, in the forward,
// every row is kept: dflash_block_tiles), its list bit. The draft tile is
// always masked (block-diagonal, and by offset under a window). The
// forward stream reaches the draft keys' maps through the policy
// (`second_keys`, `second_values`); the dq stream holds its own.
template <class P>
struct DFlashMask {
  static constexpr bool kSecondSource = true;  // the draft keys, last
  static constexpr bool kRowSlots = false;      // the slots are heads
  static constexpr bool kLogSumExp = false;     // m and l
  const P& p;

  __device__ __forceinline__ void stage_key(unsigned char*, const DqBlock&,
                                            int, int, int) const {}

  __device__ __forceinline__ const CUtensorMap* second_keys() const {
    return &p.tm_kd;
  }

  __device__ __forceinline__ const CUtensorMap* second_values() const {
    return &p.tm_vd;
  }

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
};

// Kernel A's policy: the DFlash mask, and the draft keys' dk/dv. Each
// head's p and ds on the draft tile live only on its pitch x pitch diagonal
// blocks, which a band of width W = max(pitch, 16) along the diagonal holds:
// they are staged in bf16, [64 rows][W] per head, and after the chunk's
// last tile warpgroup 0 sums dk_d = scale * sum_h ds_h^T Q_h and
// warpgroup 1 dv_d = sum_h p_h^T dO_h over the chunk's heads in head order
// on mma.sync (under 5% of the block's products), in fp32, through the
// workspace past one chunk, and writes them once as [B, KVH, Q, D].
template <int D>
struct DFlashDq : DFlashMask<DFlashDqParams> {
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

// The rows' spans and the tile list of the block of q tile q0 of batch b
// (P: the forward's or the dq stream's parameters): each row's spans into
// `spans`; over the kept rows (a draft span) the first context tile and
// the mask-free range into `setup` (three ints of scratch); the context
// tiles they reach, each with its "needs no mask" bit, then the draft tile
// (the q tile's own rows of the second source) into `list`, with their
// number in *n_tiles. kForward: a row inside Q that is not kept (a padded
// row included) also makes every tile masked (the forward's p on an
// unmasked tile is not 0 for it, the dq stream's is), and a q tile with no
// kept row lists nothing. Every thread calls it.
template <bool kForward, bool kPitched, class P>
__device__ __forceinline__ void dflash_block_tiles(const P& p, int4* spans,
                                                   int* setup, int* list,
                                                   int* n_tiles, int b,
                                                   int q0) {
  if (threadIdx.x < kTileRows) {
    spans[threadIdx.x] = row_span<kPitched>(p, b, q0 + threadIdx.x);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // over the kept rows (a draft span): the context keys any of them
    // attends, [lo, hi), and the largest lo and smallest hi
    int lo = INT_MAX, hi = 0, max_lo = 0, min_hi = INT_MAX;
    [[maybe_unused]] bool kept = false, dead = false;  // the forward's
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
      if constexpr (kForward) {
        kept |= s.w > s.z;
        dead |= s.w <= s.z && q0 + i < p.Q;
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    max_lo = __reduce_max_sync(0xffffffffu, max_lo);
    min_hi = __reduce_min_sync(0xffffffffu, min_hi);
    if constexpr (kForward) {
      if (__any_sync(0xffffffffu, dead)) min_hi = 0;  // no tile mask-free
      kept = __any_sync(0xffffffffu, kept);
    }
    if (threadIdx.x == 0) {
      const bool any = hi > lo;
      setup[0] = any ? lo / kTileRows : 0;  // the first context tile
      setup[1] = max_lo;
      setup[2] = min_hi;
      *n_tiles = any ? (hi + kTileRows - 1) / kTileRows - setup[0] + 1
                     : 1;  // and the draft tile
      if constexpr (kForward) {
        if (!kept) *n_tiles = 0;
      }
    }
  }
  __syncthreads();
  // the context tiles, each with its "needs no mask" bit, then the draft
  // keys (the q tile's own rows of the second source)
  const int n = *n_tiles;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int tile = setup[0] + j;
    const int key0 = tile * kTileRows;
    list[j] = j + 1 == n ? 2 * (q0 / kTileRows)
                         : 2 * tile + (setup[1] <= key0 &&
                                       key0 + kTileRows <= setup[2]);
  }
  __syncthreads();
}

// One forward block owns one q tile of one (batch, kv head) and a chunk of
// up to four query heads of its group (fwd_stream.cuh): the q tile is the
// grid's slow index, later tiles (later anchors, more context keys) first,
// then the batch, the kv head and the chunk. The DFlash policy never
// writes key data, so the block setup's scratch lies there.
template <int D, bool kPitched>
__global__ void __launch_bounds__(kFwdThreads, 1)
    dflash_fwd_kernel(const __grid_constant__ DFlashFwdParams p) {
  using L = FwdStreamSmem<D>;
  extern __shared__ unsigned char fwd_smem[];
  unsigned char* smem = align1024(fwd_smem);
  const int per_tile = p.s.B * p.s.KVH * p.n_chunks;
  const int n_qtiles = (p.Q + kTileRows - 1) / kTileRows;
  const int q0 = (n_qtiles - 1 - blockIdx.x / per_tile) * kTileRows;
  const int i = blockIdx.x % per_tile;
  const int b = i / (p.s.KVH * p.n_chunks);
  const int kvh = i / p.n_chunks % p.s.KVH;
  // the chunk's first head, counted in the group
  const int c0 = i % p.n_chunks * kFwdHeads;
  const int G = p.s.group;
  fwd_init_block<D>(smem, b, kvh, q0, kvh * G + c0, min(kFwdHeads, G - c0));
  dflash_block_tiles<true, kPitched>(
      p, reinterpret_cast<int4*>(smem + L::kRowData),
                           reinterpret_cast<int*>(smem + L::kKeyData),
                           reinterpret_cast<int*>(smem + L::kExtra),
                           &fwd_block_info<D>(smem)->n_tiles, b, q0);
  fwd_stream_block<D>(p.s, DFlashMask<DFlashFwdParams>{p}, smem);
}

// One dq block owns one q tile (64 rows) of one (batch, kv head) and the
// group's query heads (dq_stream.cuh); the q tile is the grid's slow index,
// later tiles first, as the forward's.
template <int D, bool kPitched>
__global__ void __launch_bounds__(kDqThreads, 1)
    dflash_bwd_dq_kernel(const __grid_constant__ DFlashDqParams p) {
  using L = DqStreamSmem<D>;
  extern __shared__ unsigned char dq_smem[];
  unsigned char* smem = align1024(dq_smem);
  const int BK = p.s.B * p.s.KVH;
  const int n_qtiles = (p.s.rows + kTileRows - 1) / kTileRows;
  const int q0 = (n_qtiles - 1 - blockIdx.x / BK) * kTileRows;
  const int b = blockIdx.x % BK / p.s.KVH;
  dq_init_block<D>(smem, b, blockIdx.x % p.s.KVH, q0);
  dflash_block_tiles<false, kPitched>(
      p, reinterpret_cast<int4*>(smem + L::kRowData),
                            dq_setup<D>(smem),
                            reinterpret_cast<int*>(smem + L::kExtra),
                            &dq_block_info<D>(smem)->n_tiles, b, q0);
  dq_stream_block<D>(p.s, DFlashDq<D>{{p}}, smem);
}

// --------------------------------------------------------------------------
// backward, kernel B: the context keys' dk/dv
// --------------------------------------------------------------------------

struct DkvParams {
  DkvStream s;         // rows = Q, keys = S
  const int* anchors;  // [B, N]
  const int* keep;     // [B, N], 0 = block not kept
  int N, bs_shift, window;  // the block pitch = 1 << bs_shift
  int bs;              // the real rows of a block: the pitch, or fewer
};

// The DFlash mask of the dk/dv stream: a row's allowed context keys are one
// interval [lo, hi) (the x, y of row_span), staged with its q tile as 16
// bytes a row; a stage needs no mask when every row of the tile reaches
// every key of the block's tile (kept, lo <= key0, hi >= key0 + 64). A
// padded row (kPitched) reaches none.
template <bool kPitched>
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
      if (p.keep[i] != 0 &&
          (!kPitched || (row & ((1 << p.bs_shift) - 1)) < p.bs)) {
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
template <int D, bool kPitched>
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

  const int n_qtiles = (p.s.rows + kTileRows - 1) / kTileRows;
  const int blocks_per_tile = kTileRows >> p.bs_shift;
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
  dkv_stream_block<D>(p.s, DFlashRows<kPitched>{p}, smem);
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

// The rows a block of bs query rows takes in the kernels' layout: the
// smallest power of two >= bs (so it divides the 64-row q tile)
int block_pitch(int bs) {
  int pitch = 1;
  while (pitch < bs) pitch <<= 1;
  return pitch;
}

// The query rows Q = N * block_pitch(bs) of a shape the kernels take, or 0
int dflash_rows(int B, int H, int KVH, int S, int N, int bs, int window,
                int D) {
  if (B < 1 || KVH < 1 || H % KVH != 0 || S < 1 || N < 1 || bs < 1 ||
      bs > kTileRows || window < 0 || (D != 64 && D != 128) ||
      (long long)N * block_pitch(bs) > INT_MAX / 2) {
    return 0;
  }
  return N * block_pitch(bs);
}

}  // namespace

// Forward: out [B, Q, H*D] bf16, m and l [B, H, Q] fp32 (all contiguous),
// in the pitched layout: Q = N * block_pitch(bs) rows, block n's rows at
// n * pitch .. n * pitch + bs - 1 and padding after them (bs from 1 to 64).
// tensors: q [B, H, Q, D], k_ctx and v_ctx [B, KVH, S, D], k_drf and v_drf
// [B, KVH, Q, D]; strides: their element strides over (b, head, row), 15
// values in that order, multiples of 8 with 16-byte aligned bases and the
// head dim contiguous (the tensor maps'). anchors, keep: [B, N] int32
// contiguous; window 0 = no sliding window. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int dflash_attention_fwd(const void* const* tensors,
                                    const long long* strides,
                                    const int* anchors, const int* keep,
                                    void* out, float* m, float* l, int B,
                                    int H, int KVH, int S, int N, int bs,
                                    int window, int D, void* stream) {
  const int Q = dflash_rows(B, H, KVH, S, N, bs, window, D);
  if (Q == 0) return cudaErrorInvalidValue;
  const long long out_strides[3] = {(long long)Q * H * D, D,
                                    (long long)H * D};
  DFlashFwdParams d;
  if (!fill_fwd_stream(d.s, tensors[0], strides, tensors[1], strides + 3,
                       tensors[2], strides + 6, S, out, out_strides, m, l, B,
                       H, KVH, Q, D, true) ||
      !encode_bhsd(&d.tm_kd, tensors[3], B, KVH, Q, D, strides[9],
                   strides[10], strides[11]) ||
      !encode_bhsd(&d.tm_vd, tensors[4], B, KVH, Q, D, strides[12],
                   strides[13], strides[14])) {
    return cudaErrorInvalidValue;
  }
  d.anchors = anchors;
  d.keep = keep;
  d.S = S;
  d.Q = Q;
  d.N = N;
  d.pitch = Q / N;
  d.bs = bs;
  d.window = window;
  d.n_chunks = (H / KVH + kFwdHeads - 1) / kFwdHeads;
  const long long blocks =
      (long long)((Q + kTileRows - 1) / kTileRows) * B * KVH * d.n_chunks;
  // the tile list: every context tile, then the draft tile
  const int smem =
      fwd_smem_bytes(D, ((S + kTileRows - 1) / kTileRows + 1) * 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return d.pitch != bs
               ? launch_hopper(dflash_fwd_kernel<128, true>, smem, d, blocks,
                               st)
               : launch_hopper(dflash_fwd_kernel<128, false>, smem, d,
                               blocks, st);
  }
  return d.pitch != bs
             ? launch_hopper(dflash_fwd_kernel<64, true>, smem, d, blocks, st)
             : launch_hopper(dflash_fwd_kernel<64, false>, smem, d, blocks,
                             st);
}

// Backward kernel A: dq [B, H, Q, D] and the draft keys' dk, dv summed
// over each group's query heads [B, KVH, Q, D] (all contiguous bf16). dout
// [B, Q, H*D] is contiguous; m, l, delta are [B, H, Q] fp32. `heads` is the
// number of query heads a block keeps resident: 4, or 2 where the draft
// staging (64 x max(pitch, 16) bf16 of p and of ds a head) does not fit
// beside four at D = 128; ws is an fp32 workspace [2, B, KVH, Q, D] when
// H / KVH > heads (else unused). The other arguments are those of the
// forward, in its pitched layout (the padded rows of dout, m, l and delta
// hold 0, -1e30, 0 and 0: dead rows); the strides of all five operands
// must be multiples of 8 elements and their bases 16-byte aligned (the
// tensor maps').
extern "C" int dflash_attention_bwd_dq(
    const void* const* tensors, const long long* strides, const int* anchors,
    const int* keep, const void* dout, const float* m, const float* l,
    const float* delta, void* dq, void* dkd, void* dvd, float* ws, int heads,
    int B, int H, int KVH, int S, int N, int bs, int window, int D,
    void* stream) {
  const int Q = dflash_rows(B, H, KVH, S, N, bs, window, D);
  if (Q == 0) return cudaErrorInvalidValue;
  DFlashDqParams d;
  if (!fill_dq_stream(d.s, tensors[0], strides, tensors[1], strides + 3,
                      tensors[2], strides + 6, S, tensors[3], strides + 9,
                      tensors[4], strides + 12, Q, dout, m, l, delta, dq,
                      B, H, KVH, Q, D, heads) ||
      (H / KVH > heads && ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
  d.anchors = anchors;
  d.keep = keep;
  d.dkd = static_cast<__nv_bfloat16*>(dkd);
  d.dvd = static_cast<__nv_bfloat16*>(dvd);
  d.ws = ws;
  d.S = S;
  d.Q = Q;
  d.N = N;
  d.pitch = Q / N;
  d.bs = bs;
  d.window = window;
  d.band_shift = 4;
  while ((1 << d.band_shift) < d.pitch) ++d.band_shift;
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
      (long long)((Q + kTileRows - 1) / kTileRows) * B * KVH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return d.pitch != bs
               ? launch_hopper(dflash_bwd_dq_kernel<128, true>, smem, d,
                               blocks, st)
               : launch_hopper(dflash_bwd_dq_kernel<128, false>, smem, d,
                               blocks, st);
  }
  return d.pitch != bs
             ? launch_hopper(dflash_bwd_dq_kernel<64, true>, smem, d, blocks,
                             st)
             : launch_hopper(dflash_bwd_dq_kernel<64, false>, smem, d,
                             blocks, st);
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
  const int Q = dflash_rows(B, H, KVH, S, N, bs, window, D);
  if (Q == 0) return cudaErrorInvalidValue;
  DkvParams d;
  if (!fill_stream(d.s, tensors[0], strides, tensors[1], strides + 3,
                   tensors[2], strides + 6, dout, m, l, delta, dkc, dvc, B,
                   H, KVH, Q, S, D)) {
    return cudaErrorInvalidValue;
  }
  d.anchors = anchors;
  d.keep = keep;
  d.N = N;
  d.bs_shift = 0;
  while ((1 << d.bs_shift) < Q / N) ++d.bs_shift;
  d.window = window;
  d.bs = bs;
  const long long blocks =
      (long long)((S + kTileRows - 1) / kTileRows) * B * KVH;
  const int smem = dkv_smem_bytes(D, (Q + kTileRows - 1) / kTileRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pitched = (1 << d.bs_shift) != bs;
  if (D == 128) {
    return pitched ? launch_hopper(dflash_bwd_dkv_kernel<128, true>, smem, d,
                                   blocks, st)
                   : launch_hopper(dflash_bwd_dkv_kernel<128, false>, smem,
                                   d, blocks, st);
  }
  return pitched ? launch_hopper(dflash_bwd_dkv_kernel<64, true>, smem, d,
                                 blocks, st)
                 : launch_hopper(dflash_bwd_dkv_kernel<64, false>, smem, d,
                                 blocks, st);
}
