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
// bound by operations; an earlier-chunk hop has twice the pairs. A
// later-chunk hop has no allowed pair: its bound is the bytes of its
// outputs.
//
// What the design does about that. No S x S tile reaches device memory,
// and the offsets are host ints, so each block knows from its tile indices
// which tiles hold an allowed pair and visits only those; a later-chunk
// hop visits none and writes the empty-row values (zero gradients).
// The forward (first design, on `mma.sync.m16n8k16`, bf16 in, fp32
// accumulate): one block of 4 warps owns 64 query rows of one head; each
// warp owns 16 rows and keeps its Q fragments and its O accumulator in
// registers, with the online-softmax recurrence (m, l, o) in fp32. K/V
// tiles of 64 keys are staged by cp.async in two buffers of padded
// (bank-conflict-free) shared memory and reach the tensor cores through
// ldmatrix; a q tile walks the key tiles up to its last row's limit.
// The two backward kernels run on the Hopper streams the DFlash and COD
// backward kernels share, with an offset-causal policy each; q, k, v and
// dO [BH, S, D] are read as [B = BH, heads = 1, S, D] by 4-D tensor maps.
// dk/dv (dkv_stream.cuh): a block of 384 threads owns 64 keys of one head,
// K and V landed once by TMA; its items are the q tiles from the one that
// holds the first row allowed for its first valid key to the last; two
// consumer warpgroups split them, each fed a ring of Q/dO stages by two
// producer warps, and run all four products on `wgmma` with dk, dv in fp32
// registers. The blocks run key tile first (blockIdx / BH), so the tiles
// that reach the most q tiles start first. dq (dq_stream.cuh, row slots):
// a block owns two adjacent q tiles of one head, one a consumer warpgroup,
// so each K/V stage (by TMA, two producer warps) feeds both; the block
// walks the valid key tiles its last row reaches, the earlier tile skips
// the stages past its own, and the pairs of q tiles run latest first. The
// row statistics are the forward's lse (m2 = lse * log2(e), 1/l = 1) and
// dstat; a row with no allowed key (lse = -1e30) gets m2 = +1e30 and 1/l =
// 0, so its p, ds and dq are exactly 0. A stage needs no mask when all 64
// keys are valid and every row of the tile reaches the last of them: on an
// earlier-chunk hop every stage, on the own chunk all but the diagonal
// ones; elsewhere the mask is a select to -inf from each key's least
// allowed row, staged with the keys. Sums run in a fixed order with no
// atomics, so two runs give the same bits; rows and keys past the end are
// zero-filled by TMA and carry no allowed pair.

#include <limits.h>

#include "dkv_stream.cuh"
#include "dq_stream.cuh"

namespace {

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Params {
  const __nv_bfloat16* q;      // [BH, Sq, D], contiguous
  const __nv_bfloat16* k;      // [BH, Sk, D], contiguous
  const __nv_bfloat16* v;      // [BH, Sk, D], contiguous
  const int* valid;            // [BH, Sk], 1 = attendable key
  __nv_bfloat16* out;          // [BH, Sq, D]
  float* lse_out;              // [BH, Sq]
  int Sq, Sk, row_off, col_off;
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

// Key tiles a q tile visits: those up to the last allowed column of its
// last row (col <= row + row_off - col_off), none when that is negative.
__device__ __forceinline__ int key_tiles_for(int qtile, const Params& p) {
  const int last_row = min(qtile * kBlockM + kBlockM, p.Sq) - 1;
  const int lim = last_row + p.row_off - p.col_off;
  if (lim < 0) return 0;
  return min((p.Sk + kBlockN - 1) / kBlockN, lim / kBlockN + 1);
}

// A-operand fragments of a 16-row slab (rows row0 and row0 + 8 of this
// thread) of a contiguous [S, D] matrix; rows past S read as zeros
template <int kSteps>
__device__ __forceinline__ void load_a_frags(uint32_t f[kSteps][4],
                                             const __nv_bfloat16* base,
                                             int D, int row0, bool in0,
                                             bool in1, int t) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int c = ks * 16 + 2 * t;
    f[ks][0] = in0 ? ld32(base + (long long)row0 * D + c) : 0u;
    f[ks][1] = in1 ? ld32(base + (long long)(row0 + 8) * D + c) : 0u;
    f[ks][2] = in0 ? ld32(base + (long long)row0 * D + c + 8) : 0u;
    f[ks][3] = in1 ? ld32(base + (long long)(row0 + 8) * D + c + 8) : 0u;
  }
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs 0..3: (row g, cols 2t..2t+1), (row g+8, 2t..), (row g, 2t+8..),
//                (row g+8, 2t+8..)
//   B regs 0..1: (k rows 2t..2t+1, col g), (k rows 2t+8..2t+9, col g)
//   C regs 0..3: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
// So a thread holds rows g and g+8 of its warp's 16, and head-dim columns
// {8j + 2t, 8j + 2t + 1} of both Q (as A) and O (as C).
template <int D>
__global__ void __launch_bounds__(kThreads) lse_fwd_kernel(const Params p) {
  constexpr int kStride = D + 8;  // padded row: conflict-free ldmatrix
  constexpr int kSteps = D / 16;  // k16 steps over the head dim
  constexpr int kDTiles = D / 8;  // n8 tiles over the head dim
  constexpr int kNTiles = kBlockN / 8;
  constexpr int kVecPerRow = D / 8;  // 16-byte vectors per K/V row
  constexpr int kTile = kBlockN * kStride;
  // two stages of K and V tiles (dynamic: above the 48 KB static limit)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sKs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sVs = sKs + 2 * kTile;
  __shared__ int sValids[2][kBlockN];

  const int Sq = p.Sq, Sk = p.Sk;
  const int n_qtiles = (Sq + kBlockM - 1) / kBlockM;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // longest rows first
  const long long bh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qtile * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool in0 = row0 < Sq;
  const bool in1 = row1 < Sq;
  // global row index shifted into the key chunk's frame: col <= lim
  const int lim0 = row0 + p.row_off - p.col_off;
  const int lim1 = row1 + p.row_off - p.col_off;

  uint32_t qf[kSteps][4];
  load_a_frags<kSteps>(qf, p.q + bh * Sq * D, D, row0, in0, in1, t);

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;  // per-thread partial sums until the quad reduce

  const __nv_bfloat16* kbase = p.k + bh * Sk * D;
  const __nv_bfloat16* vbase = p.v + bh * Sk * D;
  const int* valid = p.valid + bh * Sk;

  // stage k tile j into buffer `buf`: K/V through cp.async (rows past Sk
  // are zero-filled), the validity flags through plain loads
  auto load_tile = [&](int j, int buf) {
    const int key0 = j * kBlockN;
    __nv_bfloat16* sK = sKs + buf * kTile;
    __nv_bfloat16* sV = sVs + buf * kTile;
    for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int key = key0 + r;
      const long long src = key < Sk ? key : 0;
      cp_async16(sK + r * kStride + c, kbase + src * D + c, key < Sk);
      cp_async16(sV + r * kStride + c, vbase + src * D + c, key < Sk);
    }
    for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
      const int key = key0 + i;
      sValids[buf][i] = key < Sk ? valid[key] : 0;
    }
    cp_async_commit();
  };

  const int n_ktiles = key_tiles_for(qtile, p);
  if (n_ktiles > 0) load_tile(0, 0);
  for (int j = 0; j < n_ktiles; ++j) {
    const int key0 = j * kBlockN;
    const int buf = j & 1;
    // the next tile loads while this one is used
    if (j + 1 < n_ktiles) {
      load_tile(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sK = sKs + buf * kTile;
    const __nv_bfloat16* sV = sVs + buf * kTile;
    const int* sValid = sValids[buf];

    // scores for 16 rows x 64 keys of this warp; one ldmatrix.x4 brings
    // the K fragments (keys as n, head dim as k) of two k16 steps
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
        const int kc = nt * 8 + 2 * t + e;
        const int col = key0 + kc;
        const bool ok = sValid[kc] != 0;
        s[nt][e] = (ok && col <= lim0) ? s[nt][e] * p.scale : kNegInf;
        s[nt][2 + e] = (ok && col <= lim1) ? s[nt][2 + e] * p.scale : kNegInf;
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
    // shared memory as B (k = key, n = head dim): one transposing
    // ldmatrix.x4 brings the fragments of two n8 head-dim tiles
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp =
          sV + (kk * 16 + (lane & 8) + (lane & 7)) * kStride +
          (lane >> 4) * 8;
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

  // a row with no allowed key: l = 0, so out = 0 and lse = -1e30
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (in0) {
    __nv_bfloat16* op = p.out + (bh * Sq + row0) * D;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    }
  }
  if (in1) {
    __nv_bfloat16* op = p.out + (bh * Sq + row1) * D;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
  if (t == 0) {
    if (in0) {
      p.lse_out[bh * Sq + row0] =
          l0 > 0.f ? m0 + logf(fmaxf(l0, 1e-30f)) : kNegInf;
    }
    if (in1) {
      p.lse_out[bh * Sq + row1] =
          l1 > 0.f ? m1 + logf(fmaxf(l1, 1e-30f)) : kNegInf;
    }
  }
}

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
// backward: dq on the dq stream
// --------------------------------------------------------------------------

struct LseDqParams {
  DqStream s;        // B = BH, H = KVH = 1, rows = Sq, two q tiles a block
                     // (heads = 2); m = lse, delta = dstat (l unused)
  const int* valid;  // [BH, Sk]
  int Sk;
  int off;           // col_off - row_off, as LseDkvParams::off
  int n_pairs;       // the blocks of a head: ceil(Sq / 128)
};

// The offset-causal policy of the dq stream, with row slots: slot 0 and 1
// are the block's two q tiles. The block's list holds the key tiles up to
// the last one its last row reaches that hold a valid key, each with the
// "every key valid" bit. The rows' data holds three ints a slot: the listed
// tiles its rows reach (a prefix of the list), how many of those lie
// wholly at or before its first row's limit (a prefix too), and its first
// local row. A slot's stage needs no mask when it is in both prefixes'
// overlap and the tile's keys are all valid; otherwise its 32 bits a
// thread come from the stage's key data, each key's least allowed local
// row (INT_MAX: not valid, or past Sk), an int a key, written by the
// producer lanes.
struct LseDq {
  static constexpr bool kSecondSource = false;
  static constexpr bool kRowSlots = true;   // two q tiles of one head
  static constexpr bool kLogSumExp = true;  // m = lse, l = 1
  const LseDqParams& p;

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

// One block owns two adjacent q tiles of one head (dq_stream.cuh, row
// slots): blockIdx / BH picks the pair, the last first (under causality it
// reaches the most key tiles), blockIdx % BH the head. It lists the key
// tiles that hold a valid key up to the one its last row reaches (a warp
// a tile, by ballot) and each slot's counts.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    lse_bwd_dq_kernel(const __grid_constant__ LseDqParams p) {
  using L = DqStreamSmem<D>;
  extern __shared__ unsigned char dq_smem[];
  unsigned char* smem = align1024(dq_smem);
  int* list = reinterpret_cast<int*>(smem + L::kExtra);
  const int BH = p.s.B, Sq = p.s.rows, Sk = p.Sk;
  const int bh = blockIdx.x % BH;
  const int q0 = (p.n_pairs - 1 - blockIdx.x / BH) * 2 * kTileRows;
  dq_init_block<D>(smem, bh, 0, q0);
  // the last key the block's last row reaches, and the key tiles up to it
  const int reach = min(q0 + 2 * kTileRows, Sq) - 1 - p.off;
  const int n_kt = reach < 0 ? 0
                             : min((Sk + kTileRows - 1) / kTileRows,
                                   reach / kTileRows + 1);
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x / 32; i < n_kt; i += kDqThreads / 32) {
    const int key = i * kTileRows + lane;
    const long long at = (long long)bh * Sk + key;
    const bool a = key < Sk && p.valid[at] != 0;
    const bool b = key + 32 < Sk && p.valid[at + 32] != 0;
    const unsigned any = __ballot_sync(0xffffffffu, a || b);
    const unsigned all = __ballot_sync(0xffffffffu, a && b);
    if (lane == 0) list[i] = any != 0u ? 1 + 2 * (all == 0xffffffffu) : 0;
  }
  compact_list(list, n_kt, &dq_block_info<D>(smem)->n_tiles);
  if (threadIdx.x < 2) {
    const int lh = threadIdx.x;
    const int r0 = q0 + lh * kTileRows;
    const int n_list = dq_block_info<D>(smem)->n_tiles;
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
    int* slot = reinterpret_cast<int*>(smem + L::kRowData);
    slot[lh] = n;
    slot[2 + lh] = f;
    slot[4 + lh] = r0;
  }
  __syncthreads();
  dq_stream_block<D>(p.s, LseDq{p}, smem);
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

template <int D>
int launch_fwd(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr int kSmem = 4 * kBlockN * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(
      lse_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lse_fwd_kernel<D><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int BH, int Sq, int Sk, int D) {
  return BH >= 1 && BH <= 65535 && Sq >= 1 && Sk >= 1 && (D == 64 || D == 128);
}

}  // namespace

// q [BH, Sq, D], k and v [BH, Sk, D] (contiguous bf16), valid [BH, Sk]
// int32; out [BH, Sq, D] bf16 and lse [BH, Sq] fp32. row_off/col_off are
// the global positions of the first query row and the first key. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int lse_attention_fwd(const void* q, const void* k, const void* v,
                                 const int* valid, void* out, float* lse,
                                 int BH, int Sq, int Sk, int D, int row_off,
                                 int col_off, void* stream) {
  if (!shape_ok(BH, Sq, Sk, D)) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.valid = valid;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse_out = lse;
  p.Sq = Sq;
  p.Sk = Sk;
  p.row_off = row_off;
  p.col_off = col_off;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_fwd<128>(p, grid, st) : launch_fwd<64>(p, grid, st);
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
