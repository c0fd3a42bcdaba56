// Offset-causal flash attention with an LSE output (the USP ring hop),
// forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of specforge_tpu/ops/attention_pallas.py
// reached through `flash_attention_lse`: `_lse_fwd_kernel` (forward, via
// `_flash_lse_fwd_impl`), and the two kernels of `_flash_lse_bwd`:
// `_lse_bwd_dq_kernel` (dq) and `_lse_bwd_dkv_kernel` (dk, dv).
//
// What it computes. One ring hop attends the local queries (global rows
// row_off + i) to one K/V chunk (global columns col_off + j) under GLOBAL
// causality: key j is allowed for row i when
//   j + col_off <= i + row_off,  j < Sk,  key_valid[bh, j] != 0.
// That one rule covers the three hops of the ring: an earlier chunk (every
// key allowed), the own chunk (locally causal) and a later chunk (nothing
// allowed). The forward returns the normalised output in q's dtype and the
// row log-sum-exp lse = m + log(l) in fp32; a row with no allowed key gives
// out = 0 and lse = -1e30 (finite, as in the TPU kernel), which is what a
// later-chunk hop writes for every row. The hops and the TTT branch logits
// are merged by log-sum-exp outside. The backward takes, per row,
// dstat = rowsum(dO * O) - dlse (the lse output has a gradient too) and
// recomputes p = exp(s - lse) under the mask:
//   ds = p * (dO V^T - dstat),  dq = scale * ds K,  dk = scale * ds^T Q,
//   dv = p^T dO.
//
// What bounds it on this card. With P allowed (row, key) pairs over all
// BH heads, the forward does two products of 2*D*P FLOP (4*D*P), the dq
// kernel three (s, dp, dq: 6*D*P) and the dk/dv kernel four (s, dp, dv,
// dk: 8*D*P), all on the tensor cores. At the USP slice's own-chunk hop
// (BH = 16, S = 4096, D = 128: P = 1.34e8) that is 68.7, 103 and 137 GFLOP,
// 69, 104 and 139 us at the bf16 peak, against 8.5 MB (forward: q, k, v,
// out, lse), 12.6 MB (dq) and 16.8 MB (dk/dv) moved, 3-5 us at 3.35 TB/s:
// bound by operations; an earlier-chunk hop has twice the pairs. The
// forward also takes one exponential a pair, on the SM's MUFU unit (16 a
// clock): about half the time of its products unless the two overlap. A
// later-chunk hop has no allowed pair: its bound is the bytes of its
// outputs.
//
// What the design does about that. No S x S tile reaches device memory,
// and the offsets are host ints, so each block knows from its tile indices
// which tiles hold an allowed pair and visits only those; a later-chunk
// hop visits none and writes the empty-row values (zero gradients). All
// three kernels run on the Hopper streams the DFlash and COD kernels
// share, with one offset-causal policy: q, k, v and dO [BH, S, D] are read
// as [B = BH, heads = 1, S, D] by 4-D tensor maps; each key's least
// allowed local row (key + col_off - row_off, or INT_MAX for a key that is
// not valid or lies past Sk) is staged with the keys, and a stage needs no
// mask when all 64 keys are valid and every row of the tile reaches the
// last of them: on an earlier-chunk hop every stage, on the own chunk all
// but the diagonal ones; elsewhere the mask is a select to -inf from the
// staged rows. A row group of one leaves no GQA group to pack, so the
// forward and dq blocks own two adjacent q tiles of one head instead (the
// streams' row slots), one a consumer warpgroup, and each K/V stage feeds
// both; the block walks the valid key tiles its last row reaches, the
// earlier tile skips the stages past its own, and the pairs of q tiles run
// latest first.
// The forward (fwd_stream.cuh): 384 threads, two producer warps keeping a
// TMA ring of four K/V stages (eight at D = 64) beside the Q tiles, and per
// stage S = Q K^T, the online softmax (m in log2 units, one FMA and one
// `ex2` a score) and O += P V on `wgmma` with P from registers; one
// warpgroup's softmax runs while the other's products hold the tensor
// cores. O / l leaves as bf16 in whole rows and lse = m + ln l beside it.
// dq (dq_stream.cuh): the same block, with s, dp and dq on `wgmma`; the row
// statistics are the forward's lse (m2 = lse * log2(e), 1/l = 1) and
// dstat; a row with no allowed key (lse = -1e30) gets m2 = +1e30 and 1/l =
// 0, so its p, ds and dq are exactly 0. dk/dv (dkv_stream.cuh): a block
// owns 64 keys of one head, K and V landed once by TMA; its items are the q
// tiles from the one that holds the first row allowed for its first valid
// key to the last; two consumer warpgroups split them, each fed a ring of
// Q/dO stages by two producer warps, and run all four products on `wgmma`
// with dk, dv in fp32 registers. The blocks run key tile first (blockIdx /
// BH), so the tiles that reach the most q tiles start first. Sums run in a
// fixed order with no atomics, so two runs give the same bits; rows and
// keys past the end are zero-filled by TMA and carry no allowed pair.

#include <limits.h>

#include "dkv_stream.cuh"
#include "fwd_stream.cuh"

namespace {

// --------------------------------------------------------------------------
// backward: dk, dv on the dk/dv stream
// --------------------------------------------------------------------------

struct LseDkvParams {
  DkvStream s;       // B = BH, H = KVH = 1, rows = Sq, keys = Sk; m = lse,
                     // delta = dstat (l unused)
  const int* valid;  // [BH, Sk]
  int off;           // col_off - row_off: key j is allowed for local row i
                     // iff j + off <= i (and it is valid)
};

// The offset-causal mask of the dk/dv stream. The block's keys' data is
// each key's least allowed local row (key + off, or INT_MAX for a key that
// is not valid or lies past Sk), an int a key, staged once; a row's data is
// its local index. A stage needs no mask when all 64 keys are valid (the
// list entry's tile bit) and every row of the tile reaches the last key
// (rows past Sq have p = 0 either way).
struct LseRows {
  static constexpr bool kLogSumExp = true;  // m = lse, l = 1
  const LseDkvParams& p;

  using Keys = int2;  // the least rows of this thread's two keys
  using Row = int;    // a row's local index

  __device__ __forceinline__ Keys keys(const unsigned char* key_data,
                                       const DkvBlock&, int kr0) const {
    const int* need = reinterpret_cast<const int*>(key_data);
    return make_int2(need[kr0], need[kr0 + 8]);
  }

  __device__ __forceinline__ Row row(const unsigned char* mask, int r) const {
    return reinterpret_cast<const int*>(mask)[r];
  }

  __device__ __forceinline__ bool allow(const Keys& k, int kx, Row i) const {
    return i >= (kx ? k.y : k.x);
  }

  __device__ __forceinline__ bool stage_row(unsigned char* mask,
                                            const DkvBlock& blk, int q0,
                                            int r) const {
    const int i = q0 + r;
    reinterpret_cast<int*>(mask)[r] = i;
    return i >= p.s.rows || blk.key0 + kTileRows - 1 + p.off <= i;
  }

  __device__ __forceinline__ bool tile_free(int tile_bit,
                                            bool rows_free) const {
    return tile_bit != 0 && rows_free;
  }
};

// One block owns 64 keys of one head (dkv_stream.cuh): blockIdx / BH is
// the key tile, so the tiles that reach the most q tiles (the first, under
// causality) start first, and blockIdx % BH the head. It stages its keys'
// least rows and lists the q tiles from the one that holds the first row
// allowed for its first valid key to the last, each with the "every key
// valid" bit; a block that no row reaches (every block of a later chunk,
// a tile of padding) lists none and writes zeros.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    lse_bwd_dkv_kernel(const __grid_constant__ LseDkvParams p) {
  using L = DkvStreamSmem<D>;
  extern __shared__ unsigned char dkv_smem[];
  unsigned char* smem = align1024(dkv_smem);
  int* list = reinterpret_cast<int*>(smem + L::kList);
  int* need = reinterpret_cast<int*>(smem + L::kKeys);
  const int BH = p.s.B, Sq = p.s.rows, Sk = p.s.keys;
  const int bh = blockIdx.x % BH;
  const int key0 = blockIdx.x / BH * kTileRows;
  dkv_init_block<D>(smem, bh, 0, key0);
  // the keys' least rows, and the valid keys as two 32-bit masks behind
  if (threadIdx.x < kTileRows) {
    const int key = key0 + threadIdx.x;
    const bool ok = key < Sk && p.valid[(long long)bh * Sk + key] != 0;
    need[threadIdx.x] = ok ? key + p.off : INT_MAX;
    const unsigned valid = __ballot_sync(0xffffffffu, ok);
    if (threadIdx.x % 32 == 0) need[kTileRows + threadIdx.x / 32] = valid;
  }
  __syncthreads();
  const unsigned v0 = need[kTileRows], v1 = need[kTileRows + 1];
  const int first = v0 ? __ffs(v0) - 1 : (v1 ? 31 + __ffs(v1) : -1);
  // the first row allowed for the first valid key (Sq: none)
  const int lo = first < 0 ? Sq : max(0, key0 + first + p.off);
  const int qt0 = lo / kTileRows;
  const int n = lo < Sq ? (Sq + kTileRows - 1) / kTileRows - qt0 : 0;
  const int bit = (v0 & v1) == 0xffffffffu;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    list[i] = 2 * (qt0 + i) + bit;
  }
  if (threadIdx.x == 0) block_info<D>(smem)->n_list = n;
  __syncthreads();
  dkv_stream_block<D>(p.s, LseRows{p}, smem);
}

// --------------------------------------------------------------------------
// forward and dq: two q tiles a block (row slots)
// --------------------------------------------------------------------------

struct LseFwdParams {
  FwdStream s;       // B = BH, H = KVH = 1, rows = Sq, two q tiles a block;
                     // m = lse (l unused)
  const int* valid;  // [BH, Sk]
  int Sk;
  int off;           // col_off - row_off, as LseDkvParams::off
  int n_pairs;       // the blocks of a head: ceil(Sq / 128)
};

struct LseDqParams {
  DqStream s;        // B = BH, H = KVH = 1, rows = Sq, two q tiles a block
                     // (heads = 2); m = lse, delta = dstat (l unused)
  const int* valid;  // [BH, Sk]
  int Sk;
  int off;           // col_off - row_off, as LseDkvParams::off
  int n_pairs;       // the blocks of a head: ceil(Sq / 128)
};

// The offset-causal policy of the forward and dq streams (P: their
// parameters), with row slots: slot 0 and 1 are the block's two q tiles.
// The block's list holds the key tiles up to the last one its last row
// reaches that hold a valid key, each with the "every key valid" bit. The
// rows' data holds three ints a slot: the listed tiles its rows reach (a
// prefix of the list), how many of those lie wholly at or before its first
// row's limit (a prefix too), and its first local row. A slot's stage needs
// no mask when it is in both prefixes' overlap and the tile's keys are all
// valid; otherwise its 32 bits a thread come from the stage's key data,
// each key's least allowed local row (INT_MAX: not valid, or past Sk), an
// int a key, written by the producer lanes.
template <class P>
struct LseMask {
  static constexpr bool kSecondSource = false;
  static constexpr bool kRowSlots = true;   // two q tiles of one head
  static constexpr bool kLogSumExp = true;  // m = lse, l = 1
  const P& p;

  __device__ __forceinline__ void stage_key(unsigned char* key_data,
                                            const DqBlock& blk, int,
                                            int key0, int r) const {
    const int key = key0 + r;
    const bool ok = key < p.Sk && p.valid[(long long)blk.b * p.Sk + key] != 0;
    reinterpret_cast<int*>(key_data)[r] = ok ? key + p.off : INT_MAX;
  }

  __device__ __forceinline__ int slot_tiles(const unsigned char* rows,
                                            int lh) const {
    return reinterpret_cast<const int*>(rows)[lh];
  }

  __device__ __forceinline__ bool slot_free(const unsigned char* rows, int lh,
                                            int j, int entry) const {
    return (entry & 1) != 0 && j < reinterpret_cast<const int*>(rows)[2 + lh];
  }

  // key 8 jj + 2 t + (e & 1) of the stage against row r0 (e < 2) or r0 + 8
  // of slot lh
  __device__ __forceinline__ uint32_t slot_bits(const unsigned char* rows,
                                                const unsigned char* keys,
                                                int lh, int r0,
                                                int t) const {
    const int i0 = reinterpret_cast<const int*>(rows)[4 + lh] + r0;
    const int i1 = i0 + 8;
    const int* need = reinterpret_cast<const int*>(keys);
    uint32_t bits = 0u;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int2 n = *reinterpret_cast<const int2*>(need + 8 * jj + 2 * t);
      bits |= (static_cast<uint32_t>(n.x <= i0) |
               static_cast<uint32_t>(n.y <= i0) << 1 |
               static_cast<uint32_t>(n.x <= i1) << 2 |
               static_cast<uint32_t>(n.y <= i1) << 3)
              << (4 * jj);
    }
    return bits;
  }

  __device__ __forceinline__ void chunk_done(unsigned char*, const DqBlock&,
                                             int, bool, int, int, int) const {}
};

// The tile list and the slots' counts of the block of two q tiles from q0
// on of head bh (P: the forward's or the dq stream's parameters): the key
// tiles that hold a valid key up to the one its last row reaches (a warp a
// tile, by ballot), compacted into `list` with their number in *n_tiles,
// and each slot's three ints into `slot` (LseMask). Every thread calls it.
template <class P>
__device__ __forceinline__ void lse_block_tiles(const P& p, int* list,
                                                int* n_tiles, int* slot,
                                                int bh, int q0) {
  const int Sq = p.s.rows, Sk = p.Sk;
  // the last key the block's last row reaches, and the key tiles up to it
  const int reach = min(q0 + 2 * kTileRows, Sq) - 1 - p.off;
  const int n_kt = reach < 0 ? 0
                             : min((Sk + kTileRows - 1) / kTileRows,
                                   reach / kTileRows + 1);
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x / 32; i < n_kt; i += kHopperThreads / 32) {
    const int key = i * kTileRows + lane;
    const long long at = (long long)bh * Sk + key;
    const bool a = key < Sk && p.valid[at] != 0;
    const bool b = key + 32 < Sk && p.valid[at + 32] != 0;
    const unsigned any = __ballot_sync(0xffffffffu, a || b);
    const unsigned all = __ballot_sync(0xffffffffu, a && b);
    if (lane == 0) list[i] = any != 0u ? 1 + 2 * (all == 0xffffffffu) : 0;
  }
  compact_list(list, n_kt, n_tiles);
  if (threadIdx.x < 2) {
    const int lh = threadIdx.x;
    const int r0 = q0 + lh * kTileRows;
    const int n_list = *n_tiles;
    int n = 0, f = 0;
    if (r0 < Sq) {
      const int last = min(r0 + kTileRows, Sq) - 1 - p.off;  // any row's
      const int every = r0 - p.off;  // every row of the slot reaches these
      for (int j = 0; j < n_list; ++j) {
        const int key0 = (list[j] >> 1) * kTileRows;
        n += key0 <= last;
        f += key0 + kTileRows - 1 <= every;
      }
    }
    slot[lh] = n;
    slot[2 + lh] = f;
    slot[4 + lh] = r0;
  }
}

// One forward block owns two adjacent q tiles of one head (fwd_stream.cuh,
// row slots): blockIdx / BH picks the pair, the last first (under
// causality it reaches the most key tiles), blockIdx % BH the head. A
// block whose rows reach no valid key (every block of a later chunk) lists
// none and writes out = 0, lse = -1e30.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    lse_fwd_kernel(const __grid_constant__ LseFwdParams p) {
  using L = FwdStreamSmem<D>;
  extern __shared__ unsigned char fwd_smem[];
  unsigned char* smem = align1024(fwd_smem);
  const int BH = p.s.B, Sq = p.s.rows;
  const int bh = blockIdx.x % BH;
  const int q0 = (p.n_pairs - 1 - blockIdx.x / BH) * 2 * kTileRows;
  fwd_init_block<D>(smem, bh, 0, q0, 0,
                    min(2, (Sq - q0 + kTileRows - 1) / kTileRows));
  lse_block_tiles(p, reinterpret_cast<int*>(smem + L::kExtra),
                  &fwd_block_info<D>(smem)->n_tiles,
                  reinterpret_cast<int*>(smem + L::kRowData), bh, q0);
  __syncthreads();
  fwd_stream_block<D>(p.s, LseMask<LseFwdParams>{p}, smem);
}

// One dq block owns two adjacent q tiles of one head (dq_stream.cuh, row
// slots), picked as the forward's.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    lse_bwd_dq_kernel(const __grid_constant__ LseDqParams p) {
  using L = DqStreamSmem<D>;
  extern __shared__ unsigned char dq_smem[];
  unsigned char* smem = align1024(dq_smem);
  const int BH = p.s.B;
  const int bh = blockIdx.x % BH;
  const int q0 = (p.n_pairs - 1 - blockIdx.x / BH) * 2 * kTileRows;
  dq_init_block<D>(smem, bh, 0, q0);
  lse_block_tiles(p, reinterpret_cast<int*>(smem + L::kExtra),
                  &dq_block_info<D>(smem)->n_tiles,
                  reinterpret_cast<int*>(smem + L::kRowData), bh, q0);
  __syncthreads();
  dq_stream_block<D>(p.s, LseMask<LseDqParams>{p}, smem);
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

bool shape_ok(int BH, int Sq, int Sk, int D) {
  return BH >= 1 && BH <= 65535 && Sq >= 1 && Sk >= 1 && (D == 64 || D == 128);
}

}  // namespace

// q [BH, Sq, D], k and v [BH, Sk, D] (contiguous bf16), valid [BH, Sk]
// int32; out [BH, Sq, D] bf16 and lse [BH, Sq] fp32. row_off/col_off are
// the global positions of the first query row and the first key. q, k, v
// and out must be 16-byte aligned (the tensor maps' and the row stores').
// Launches on `stream` and returns cudaGetLastError().
extern "C" int lse_attention_fwd(const void* q, const void* k, const void* v,
                                 const int* valid, void* out, float* lse,
                                 int BH, int Sq, int Sk, int D, int row_off,
                                 int col_off, void* stream) {
  if (!shape_ok(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  const long long qs[3] = {(long long)Sq * D, (long long)Sq * D, D};
  const long long ks[3] = {(long long)Sk * D, (long long)Sk * D, D};
  LseFwdParams d;
  d.off = col_off - row_off;
  // a later chunk: no row reaches a key, and no block reads q, k or v
  const bool reached = Sq - 1 - d.off >= 0;
  if (!fill_fwd_stream(d.s, q, qs, k, ks, v, ks, Sk, out, qs, lse, nullptr,
                       BH, 1, 1, Sq, D, reached)) {
    return cudaErrorInvalidValue;
  }
  d.valid = valid;
  d.Sk = Sk;
  d.n_pairs = (Sq + 2 * kTileRows - 1) / (2 * kTileRows);
  const long long blocks = (long long)BH * d.n_pairs;
  const int smem = fwd_smem_bytes(D, (Sk + kTileRows - 1) / kTileRows * 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_hopper(lse_fwd_kernel<128>, smem, d, blocks, st)
                  : launch_hopper(lse_fwd_kernel<64>, smem, d, blocks, st);
}

// The backward's first kernel: dq [BH, Sq, D] (contiguous bf16) from dout
// [BH, Sq, D] (contiguous bf16), lse and dstat [BH, Sq] fp32. The other
// arguments are those of lse_attention_fwd; q, k, v, dout and dq must be
// 16-byte aligned (the tensor maps').
extern "C" int lse_attention_bwd_dq(const void* q, const void* k,
                                    const void* v, const int* valid,
                                    const void* dout, const float* lse,
                                    const float* dstat, void* dq, int BH,
                                    int Sq, int Sk, int D, int row_off,
                                    int col_off, void* stream) {
  if (!shape_ok(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  const long long qs[3] = {(long long)Sq * D, (long long)Sq * D, D};
  const long long ks[3] = {(long long)Sk * D, (long long)Sk * D, D};
  LseDqParams d;
  if (!fill_dq_stream(d.s, q, qs, k, ks, v, ks, Sk, nullptr, nullptr,
                      nullptr, nullptr, 0, dout, lse, nullptr, dstat, dq, BH,
                      1, 1, Sq, D, 2)) {
    return cudaErrorInvalidValue;
  }
  d.valid = valid;
  d.Sk = Sk;
  d.off = col_off - row_off;
  d.n_pairs = (Sq + 2 * kTileRows - 1) / (2 * kTileRows);
  const long long blocks = (long long)BH * d.n_pairs;
  const int smem = dq_smem_bytes(D, (Sk + kTileRows - 1) / kTileRows * 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_hopper(lse_bwd_dq_kernel<128>, smem, d, blocks, st)
                  : launch_hopper(lse_bwd_dq_kernel<64>, smem, d, blocks, st);
}

// The backward's second kernel: dk, dv [BH, Sk, D] (contiguous bf16). The
// arguments are those of lse_attention_bwd_dq; dk and dv need no alignment
// beyond their element type.
extern "C" int lse_attention_bwd_dkv(const void* q, const void* k,
                                     const void* v, const int* valid,
                                     const void* dout, const float* lse,
                                     const float* dstat, void* dk, void* dv,
                                     int BH, int Sq, int Sk, int D,
                                     int row_off, int col_off, void* stream) {
  if (!shape_ok(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  const long long qs[3] = {(long long)Sq * D, (long long)Sq * D, D};
  const long long ks[3] = {(long long)Sk * D, (long long)Sk * D, D};
  LseDkvParams d;
  if (!fill_stream(d.s, q, qs, k, ks, v, ks, dout, lse, nullptr, dstat, dk,
                   dv, BH, 1, 1, Sq, Sk, D)) {
    return cudaErrorInvalidValue;
  }
  d.valid = valid;
  d.off = col_off - row_off;
  const long long blocks =
      (long long)BH * ((Sk + kTileRows - 1) / kTileRows);
  const int smem = dkv_smem_bytes(D, (Sq + kTileRows - 1) / kTileRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128
             ? launch_hopper(lse_bwd_dkv_kernel<128>, smem, d, blocks, st)
             : launch_hopper(lse_bwd_dkv_kernel<64>, smem, d, blocks, st);
}
