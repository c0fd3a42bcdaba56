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
// chip_smoke.py recomputes both terms from each run's sample. The forward
// adds an exponential a pair on the SM's MUFU unit, about half its
// products' time unless the two overlap.
//
// What the design does about that. Every product runs on the tensor cores
// (`wgmma`, bf16 in, fp32 accumulate) from two consumer warpgroups of 384
// threads, fed by two producer warps (`setmaxnreg` 24; the consumers 240)
// through a TMA/`mbarrier` ring; no score tile reaches device memory. Whole
// 64 x 64 tiles with no allowed pair are skipped: the caller hands a
// [B, NT, NT] table (1 where a tile pair holds an allowed pair), built once
// per forward from the model's mask and shared by every layer and head;
// each block lists its live tiles from it first. The doc-major order of
// the sample makes the live tiles few and dense (about a quarter of the
// grid at the slice, block-diagonal when documents are packed). A second
// table marks the tile pairs whose every pair is allowed (46% of the live
// pairs at the slice); it travels as a bit of each block's list, and there
// the predicate is skipped. Elsewhere the rows' properties are folded once
// (a row that is invalid or padding gets a doc no key has, an invalid key
// another) and a stage's keys' travel with the stage. The GQA kv head is
// read as h / (H / KVH), never repeated in memory; there are no atomics, so
// two runs give the same bits. T need not be a multiple of 64: rows and
// keys past T are zero-filled by TMA and carry no valid property.
// The forward (fwd_stream.cuh) and dq (dq_stream.cuh): a block owns a q
// tile of one (batch, kv head) and four query heads of the group, two per
// consumer warpgroup (a group of eight: two chunks, in two forward blocks
// or one after the other in a dq block), so each live K/V tile is staged
// once for all of them; the predicate runs once a stage for both of a
// warpgroup's heads. The forward runs S = Q K^T, the online softmax (m in
// log2 units, one FMA and one `ex2` a score) and O += P V with P from
// registers, one head's softmax while the tensor cores form the other's
// products; dq runs s, dp and dq += ds K with dq in fp32 registers. Their
// blocks are issued longest first, in an order of (batch, q tile) pairs
// the caller sorts by their live key tiles on the card, once per forward.
// dk/dv (dkv_stream.cuh): a block owns 64 keys of one (batch, kv head), K
// and V by TMA once; two consumer warpgroups split the group's (head, live
// q tile) stream, each fed a ring of Q/dO stages by two producer warps, and
// run all four products on `wgmma` with dk, dv in fp32 registers. The
// rows' properties travel with their stage, the keys' are staged once in
// shared memory and read per item only where the predicate runs. Its
// blocks are issued in an order of (batch, key tile) pairs the caller
// sorts by their live q tiles. The kernels share the Hopper helpers of
// hopper.cuh.

#include <limits.h>

#include "dkv_stream.cuh"
#include "fwd_stream.cuh"

namespace {

// --------------------------------------------------------------------------
// forward and dq: a q tile against its live key tiles
// --------------------------------------------------------------------------

// The pair test on folded properties: a row's doc is INT_MIN + 1 when the
// row is invalid or padding, a key's INT_MIN when it is invalid, so that a
// pair is allowed iff the docs match and the trunk or the rollout rule
// holds (the predicate above)
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

struct CodFwdParams {
  FwdStream s;         // rows = keys = T; out [B, T, H*D]
  const int4* props;   // [B, T]
  const int* tiles;    // [B, NT, NT]: 1 where a tile pair may attend
  const int* full;     // [B, NT, NT]: 1 where every pair of it is allowed
  const int* order;    // [B * NT]: (batch, q tile) pairs, longest first
  int NT;
  int n_chunks;        // blocks of a (q tile, kv head): ceil(group / 4)
};

struct CodDqParams {
  DqStream s;          // rows = keys = T
  const int4* props;   // [B, T]
  const int* tiles;    // [B, NT, NT]: 1 where a tile pair may attend
  const int* full;     // [B, NT, NT]: 1 where every pair of it is allowed
  const int* order;    // [B * NT]: (batch, q tile) pairs, longest first
  int NT;
};

// The COD policy of the forward and dq streams (P: their parameters). A
// block streams the live key tiles of its q tile (row `qtile` of the
// batch's table), listed first with each tile's full-tile flag as the
// entry's bit. The rows' folded properties are the rows' mask data; a
// stage that is not full carries its keys' folded properties, written by
// the producer lanes, and the consumers test the pairs once a stage; a
// full stage needs neither.
template <class P>
struct CodMask {
  static constexpr bool kSecondSource = false;
  static constexpr bool kRowSlots = false;   // the slots are heads
  static constexpr bool kLogSumExp = false;  // m and l
  const P& p;

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

// The rows' folded properties and the tile list of the block of q tile q0
// of batch b (pair = b * NT + its q tile, NT = p.NT; P: the forward's or
// the dq stream's parameters): the live key tiles of the q tile, each with its
// full-tile flag as the tile bit, compacted into `list` with their number
// in *n_tiles. Every thread calls it.
template <class P>
__device__ __forceinline__ void cod_block_tiles(const P& p,
                                                unsigned char* row_data,
                                                int* list, int* n_tiles,
                                                int NT, int pair, int b,
                                                int q0) {
  if (threadIdx.x < kTileRows) {
    reinterpret_cast<int4*>(row_data)[threadIdx.x] =
        cod_folded(p.props, p.s.rows, b, q0 + threadIdx.x, true);
  }
  const long long row = (long long)pair * NT;
  for (int i = threadIdx.x; i < NT; i += blockDim.x) {
    list[i] = p.tiles[row + i] != 0 ? 1 + 2 * (p.full[row + i] != 0) : 0;
  }
  compact_list(list, NT, n_tiles);
}

// One forward block owns one q tile of one (batch, kv head) and a chunk of
// up to four query heads of its group (fwd_stream.cuh): blockIdx /
// (KVH * n_chunks) picks the (batch, q tile) pair from `order` (the caller
// sorts the pairs by their live key tiles, descending, so the heaviest
// blocks start first), then the kv head and the chunk.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    cod_fwd_kernel(const __grid_constant__ CodFwdParams p) {
  using L = FwdStreamSmem<D>;
  extern __shared__ unsigned char fwd_smem[];
  unsigned char* smem = align1024(fwd_smem);
  const int NT = p.NT;
  const int per_pair = p.s.KVH * p.n_chunks;
  const int pair = p.order[blockIdx.x / per_pair];
  const int b = pair / NT;
  const int q0 = pair % NT * kTileRows;
  const int kvh = blockIdx.x % per_pair / p.n_chunks;
  // the chunk's first head, counted in the group
  const int c0 = blockIdx.x % p.n_chunks * kFwdHeads;
  const int G = p.s.group;
  fwd_init_block<D>(smem, b, kvh, q0, kvh * G + c0, min(kFwdHeads, G - c0));
  cod_block_tiles(p, smem + L::kRowData,
                  reinterpret_cast<int*>(smem + L::kExtra),
                  &fwd_block_info<D>(smem)->n_tiles, NT, pair, b, q0);
  fwd_stream_block<D>(p.s, CodMask<CodFwdParams>{p}, smem);
}

// One dq block owns one q tile of one (batch, kv head) and the group's
// query heads (dq_stream.cuh): blockIdx / KVH picks the (batch, q tile)
// pair from `order`, as the forward's, blockIdx % KVH the kv head.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    cod_bwd_dq_kernel(const __grid_constant__ CodDqParams p) {
  using L = DqStreamSmem<D>;
  extern __shared__ unsigned char dq_smem[];
  unsigned char* smem = align1024(dq_smem);
  const int NT = p.NT;
  const int pair = p.order[blockIdx.x / p.s.KVH];
  const int b = pair / NT;
  const int q0 = pair % NT * kTileRows;
  dq_init_block<D>(smem, b, blockIdx.x % p.s.KVH, q0);
  cod_block_tiles(p, smem + L::kRowData,
                  reinterpret_cast<int*>(smem + L::kExtra),
                  &dq_block_info<D>(smem)->n_tiles, NT, pair, b, q0);
  dq_stream_block<D>(p.s, CodMask<CodDqParams>{p}, smem);
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
// the docs match and the trunk or the rollout rule holds, as
// cod_folded_allow. The block's 64 keys' properties are staged once, and a
// thread reads its two keys' for each item that needs the mask. A stage
// needs no mask when the caller's full-tile flag (carried in the item list)
// says every pair of the tile pair is allowed.
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

// The tile count NT = ceil(T / 64) of a shape the three kernels take, or 0:
// their shared memory grows with the tile list
int cod_tiles_of(int B, int H, int KVH, int T, int D) {
  if (B < 1 || KVH < 1 || H % KVH != 0 || T < 1 || (D != 64 && D != 128)) {
    return 0;
  }
  const int nt = (T + kTileRows - 1) / kTileRows;
  if (fwd_smem_bytes(D, nt * 4) > 227 * 1024 ||
      dkv_smem_bytes(D, nt) > 227 * 1024 ||
      dq_smem_bytes(D, nt * 4) > 227 * 1024) {
    return 0;
  }
  return nt;
}

}  // namespace

// Forward: out [B, T, H*D] bf16, m and l [B, H, T] fp32 (all contiguous).
// tensors: q [B, H, T, D], k and v [B, KVH, T, D]; strides: their element
// strides over (b, head, row), 9 values in that order, multiples of 8 with
// 16-byte aligned bases and the head dim contiguous (the tensor maps').
// props: [B, T] int4 (anchor, depth, doc, valid) contiguous; tiles and
// full: [B, NT, NT] int32 contiguous, NT = ceil(T / 64), 1 where the tile
// pair holds an allowed pair, and where every pair of it is allowed;
// order: [B * NT] int32, the (batch, q tile) pairs b * NT + qtile in launch
// order. Launches on `stream` and returns cudaGetLastError().
extern "C" int cod_attention_fwd(const void* const* tensors,
                                 const long long* strides, const void* props,
                                 const int* tiles, const int* full,
                                 const int* order, void* out, float* m,
                                 float* l, int B, int H, int KVH, int T, int D,
                                 void* stream) {
  const int NT = cod_tiles_of(B, H, KVH, T, D);
  if (NT == 0) return cudaErrorInvalidValue;
  const long long out_strides[3] = {(long long)T * H * D, D,
                                    (long long)H * D};
  CodFwdParams d;
  if (!fill_fwd_stream(d.s, tensors[0], strides, tensors[1], strides + 3,
                       tensors[2], strides + 6, T, out, out_strides, m, l, B,
                       H, KVH, T, D, true)) {
    return cudaErrorInvalidValue;
  }
  d.props = static_cast<const int4*>(props);
  d.tiles = tiles;
  d.full = full;
  d.order = order;
  d.NT = NT;
  d.n_chunks = (H / KVH + kFwdHeads - 1) / kFwdHeads;
  const long long blocks = (long long)B * NT * KVH * d.n_chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = fwd_smem_bytes(D, NT * 4);
  return D == 128 ? launch_hopper(cod_fwd_kernel<128>, smem, d, blocks, st)
                  : launch_hopper(cod_fwd_kernel<64>, smem, d, blocks, st);
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
  const int NT = cod_tiles_of(B, H, KVH, T, D);
  if (NT == 0) return cudaErrorInvalidValue;
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
  d.NT = NT;
  const long long blocks = (long long)B * NT * KVH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = dq_smem_bytes(D, NT * 4);
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
  const int NT = cod_tiles_of(B, H, KVH, T, D);
  if (NT == 0) return cudaErrorInvalidValue;
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
  d.NT = NT;
  const long long blocks = (long long)B * NT * KVH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = dkv_smem_bytes(D, NT);
  return D == 128 ? launch_hopper(cod_bwd_dkv_kernel<128>, smem, d, blocks, st)
                  : launch_hopper(cod_bwd_dkv_kernel<64>, smem, d, blocks, st);
}
