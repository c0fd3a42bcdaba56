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
// What the design does about that. Every product runs on the tensor cores
// through `mma.sync.m16n8k16` (bf16 in, fp32 accumulate); no S x S tile
// reaches device memory. The offsets are host ints, so each block knows
// from its tile indices which tiles hold an allowed pair and visits only
// those: a q tile of the forward and of dq walks the key tiles up to its
// last row's limit, a key tile of dk/dv walks the q tiles from its first
// allowed row; a later-chunk hop visits none and writes the empty-row
// values. The forward: one block of 4 warps owns 64 query rows of one head;
// each warp owns 16 rows and keeps its Q fragments and its O accumulator in
// registers, with the online-softmax recurrence (m, l, o) in fp32. K/V tiles
// of 64 keys are staged by cp.async in two buffers of padded
// (bank-conflict-free) shared memory, so the next tile loads while this one
// is used, and reach the tensor cores through ldmatrix (transposing where
// the key index is the reduction). The dq kernel has the forward's shape,
// with dO fragments and dq in registers. The dk/dv kernel gives one block
// 64 keys of one head, K and V in shared memory, dk and dv in fp32
// registers; it walks the q tiles in order with Q, dO and the row
// statistics staged by cp.async in two buffers, so dk and dv are summed
// without atomics, in a fixed order, and two runs give the same bits.
// Not yet used: TMA, wgmma and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // finite, as in the TPU kernel

struct Params {
  const __nv_bfloat16* q;      // [BH, Sq, D], contiguous
  const __nv_bfloat16* k;      // [BH, Sk, D], contiguous
  const __nv_bfloat16* v;      // [BH, Sk, D], contiguous
  const int* valid;            // [BH, Sk], 1 = attendable key
  const __nv_bfloat16* dout;   // [BH, Sq, D] (backward)
  const float* lse;            // [BH, Sq] (backward)
  const float* dstat;          // [BH, Sq]: rowsum(dO * O) - dlse (backward)
  __nv_bfloat16* out;          // [BH, Sq, D]
  float* lse_out;              // [BH, Sq]
  __nv_bfloat16* dq;           // [BH, Sq, D]
  __nv_bfloat16* dk;           // [BH, Sk, D]
  __nv_bfloat16* dv;           // [BH, Sk, D]
  int Sq, Sk, row_off, col_off;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
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

// dq: one block owns 64 query rows of one head, 16 per warp, and walks the
// key tiles that hold an allowed pair.
template <int D>
__global__ void __launch_bounds__(kThreads) lse_bwd_dq_kernel(const Params p) {
  constexpr int kStride = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kVecPerRow = D / 8;
  constexpr int kTile = kBlockN * kStride;
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
  const int lim0 = row0 + p.row_off - p.col_off;
  const int lim1 = row1 + p.row_off - p.col_off;

  uint32_t qf[kSteps][4], df[kSteps][4];
  load_a_frags<kSteps>(qf, p.q + bh * Sq * D, D, row0, in0, in1, t);
  load_a_frags<kSteps>(df, p.dout + bh * Sq * D, D, row0, in0, in1, t);
  // rows past Sq get p = 0 (their `in` flag is part of the mask)
  const float lse0 = in0 ? p.lse[bh * Sq + row0] : 0.f;
  const float lse1 = in1 ? p.lse[bh * Sq + row1] : 0.f;
  const float ds0 = in0 ? p.dstat[bh * Sq + row0] : 0.f;
  const float ds1 = in1 ? p.dstat[bh * Sq + row1] : 0.f;

  float dq[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
  }

  const __nv_bfloat16* kbase = p.k + bh * Sk * D;
  const __nv_bfloat16* vbase = p.v + bh * Sk * D;
  const int* valid = p.valid + bh * Sk;

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

#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      // s = Q K^T and dp = dO V^T for 16 rows x 16 keys
      float s[2][4], dp[2][4];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int nt = 2 * kk + e2;
        s[e2][0] = s[e2][1] = s[e2][2] = s[e2][3] = 0.f;
        dp[e2][0] = dp[e2][1] = dp[e2][2] = dp[e2][3] = 0.f;
        const int off = (nt * 8 + (lane & 7)) * kStride + (lane >> 3) * 8;
#pragma unroll
        for (int ks = 0; ks < kSteps; ks += 2) {
          uint32_t f[4];
          ldmatrix_x4(f, sK + off + ks * 16);
          mma_bf16(s[e2], qf[ks], f[0], f[1]);
          mma_bf16(s[e2], qf[ks + 1], f[2], f[3]);
          ldmatrix_x4(f, sV + off + ks * 16);
          mma_bf16(dp[e2], df[ks], f[0], f[1]);
          mma_bf16(dp[e2], df[ks + 1], f[2], f[3]);
        }
      }
      // ds = p * (dp - dstat), p recomputed under the offset-causal mask
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = (2 * kk + e2) * 8 + 2 * t + e;
          const int col = key0 + kc;
          const bool ok = sValid[kc] != 0;
          const float p0 = (ok && in0 && col <= lim0)
                               ? __expf(s[e2][e] * p.scale - lse0)
                               : 0.f;
          const float p1 = (ok && in1 && col <= lim1)
                               ? __expf(s[e2][2 + e] * p.scale - lse1)
                               : 0.f;
          s[e2][e] = p0 * (dp[e2][e] - ds0);
          s[e2][2 + e] = p1 * (dp[e2][2 + e] - ds1);
        }
      }
      // dq += ds K: ds from registers (C -> A layout), K as B (k = key,
      // n = head dim) through a transposing ldmatrix
      uint32_t a[4];
      a[0] = pack_bf16(s[0][0], s[0][1]);
      a[1] = pack_bf16(s[0][2], s[0][3]);
      a[2] = pack_bf16(s[1][0], s[1][1]);
      a[3] = pack_bf16(s[1][2], s[1][3]);
      const __nv_bfloat16* kp =
          sK + (kk * 16 + (lane & 8) + (lane & 7)) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, kp + dt * 8);
        mma_bf16(dq[dt], a, f[0], f[1]);
        mma_bf16(dq[dt + 1], a, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  __nv_bfloat16* dqp = p.dq + bh * Sq * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (in0) {
      *reinterpret_cast<uint32_t*>(dqp + (long long)row0 * D + c) =
          pack_bf16(dq[dt][0] * p.scale, dq[dt][1] * p.scale);
    }
    if (in1) {
      *reinterpret_cast<uint32_t*>(dqp + (long long)row1 * D + c) =
          pack_bf16(dq[dt][2] * p.scale, dq[dt][3] * p.scale);
    }
  }
}

// dk/dv: one block owns 64 keys of one head, 16 per warp, and walks the q
// tiles from the first that holds an allowed row to the last, in order.
template <int D>
__global__ void __launch_bounds__(kThreads) lse_bwd_dkv_kernel(const Params p) {
  constexpr int kStride = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kVecPerRow = D / 8;
  constexpr int kTile = kBlockN * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sQs = sV + kTile;        // two stages
  __nv_bfloat16* sDOs = sQs + 2 * kTile;  // two stages
  __shared__ float sLse[2][kBlockN], sDs[2][kBlockN];

  const int Sq = p.Sq, Sk = p.Sk;
  const int n_qtiles = (Sq + kBlockM - 1) / kBlockM;
  const int ktile = blockIdx.x;
  const long long bh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = ktile * kBlockN;
  const int kr0 = key0 + warp * 16 + g;  // this thread's two keys
  const int kr1 = kr0 + 8;
  const int* valid = p.valid + bh * Sk;
  const bool kv0 = kr0 < Sk && valid[kr0] != 0;
  const bool kv1 = kr1 < Sk && valid[kr1] != 0;
  // the least local row each key is allowed for: row >= key + off
  const int off = p.col_off - p.row_off;

  // K and V of this block's keys, once
  {
    const __nv_bfloat16* kbase = p.k + bh * Sk * D;
    const __nv_bfloat16* vbase = p.v + bh * Sk * D;
    for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int key = key0 + r;
      const long long src = key < Sk ? key : 0;
      cp_async16(sK + r * kStride + c, kbase + src * D + c, key < Sk);
      cp_async16(sV + r * kStride + c, vbase + src * D + c, key < Sk);
    }
    cp_async_commit();
  }

  // the q tiles that hold a row allowed for the tile's first key
  const int need = key0 + off;
  const int first = need <= 0 ? 0 : floor_div(need, kBlockM);
  const int n_iters = need <= Sq - 1 ? n_qtiles - first : 0;
  const __nv_bfloat16* qbase = p.q + bh * Sq * D;
  const __nv_bfloat16* dbase = p.dout + bh * Sq * D;
  auto load_q = [&](int it, int buf) {
    const int q0 = (first + it) * kBlockM;
    __nv_bfloat16* sQ = sQs + buf * kTile;
    __nv_bfloat16* sDO = sDOs + buf * kTile;
    for (int i = threadIdx.x; i < kBlockM * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int row = q0 + r;
      const long long src = row < Sq ? row : 0;
      cp_async16(sQ + r * kStride + c, qbase + src * D + c, row < Sq);
      cp_async16(sDO + r * kStride + c, dbase + src * D + c, row < Sq);
    }
    for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
      const int row = q0 + i;
      const bool in = row < Sq;
      sLse[buf][i] = in ? p.lse[bh * Sq + row] : 0.f;
      sDs[buf][i] = in ? p.dstat[bh * Sq + row] : 0.f;
    }
    cp_async_commit();
  };

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  // A-operand (rows = this warp's 16 keys) addresses of K and V
  const int a_off = (warp * 16 + (lane & 15)) * kStride + (lane >> 4) * 8;
  if (n_iters > 0) {
    load_q(0, 0);
  } else {
    cp_async_wait<0>();  // K and V were requested; nothing reads them
  }
  for (int it = 0; it < n_iters; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iters) {
      load_q(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sQ = sQs + buf * kTile;
    const __nv_bfloat16* sDO = sDOs + buf * kTile;
    const int q0 = (first + it) * kBlockM;

#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      // s^T = K Q^T and dp^T = V dO^T for 16 keys x 16 queries
      float s[2][4], dp[2][4];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        s[e2][0] = s[e2][1] = s[e2][2] = s[e2][3] = 0.f;
        dp[e2][0] = dp[e2][1] = dp[e2][2] = dp[e2][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kSteps; ks += 2) {
        uint32_t ka0[4], ka1[4], va0[4], va1[4];
        ldmatrix_x4(ka0, sK + a_off + ks * 16);
        ldmatrix_x4(ka1, sK + a_off + (ks + 1) * 16);
        ldmatrix_x4(va0, sV + a_off + ks * 16);
        ldmatrix_x4(va1, sV + a_off + (ks + 1) * 16);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int off_b = ((2 * kk + e2) * 8 + (lane & 7)) * kStride +
                            (lane >> 3) * 8 + ks * 16;
          uint32_t f[4];
          ldmatrix_x4(f, sQ + off_b);
          mma_bf16(s[e2], ka0, f[0], f[1]);
          mma_bf16(s[e2], ka1, f[2], f[3]);
          ldmatrix_x4(f, sDO + off_b);
          mma_bf16(dp[e2], va0, f[0], f[1]);
          mma_bf16(dp[e2], va1, f[2], f[3]);
        }
      }
      // p^T under the offset-causal/valid mask, ds^T = p^T * (dp^T - dstat)
      float pt[2][4];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = kk * 16 + e2 * 8 + 2 * t + (i & 1);
          const int row = q0 + qi;
          const bool ok = i < 2 ? (kv0 && kr0 + off <= row)
                                : (kv1 && kr1 + off <= row);
          const float pv = (ok && row < Sq)
                               ? __expf(s[e2][i] * p.scale - sLse[buf][qi])
                               : 0.f;
          pt[e2][i] = pv;
          s[e2][i] = pv * (dp[e2][i] - sDs[buf][qi]);
        }
      }
      // dv += p^T dO and dk += ds^T Q: A from registers (C -> A layout), dO
      // and Q as B (k = query, n = head dim) through transposing ldmatrix
      uint32_t ap[4], as[4];
      ap[0] = pack_bf16(pt[0][0], pt[0][1]);
      ap[1] = pack_bf16(pt[0][2], pt[0][3]);
      ap[2] = pack_bf16(pt[1][0], pt[1][1]);
      ap[3] = pack_bf16(pt[1][2], pt[1][3]);
      as[0] = pack_bf16(s[0][0], s[0][1]);
      as[1] = pack_bf16(s[0][2], s[0][3]);
      as[2] = pack_bf16(s[1][0], s[1][1]);
      as[3] = pack_bf16(s[1][2], s[1][3]);
      const int toff =
          (kk * 16 + (lane & 8) + (lane & 7)) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, sDO + toff + dt * 8);
        mma_bf16(dv[dt], ap, f[0], f[1]);
        mma_bf16(dv[dt + 1], ap, f[2], f[3]);
        ldmatrix_x4_trans(f, sQ + toff + dt * 8);
        mma_bf16(dk[dt], as, f[0], f[1]);
        mma_bf16(dk[dt + 1], as, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  const long long obase = bh * Sk * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (kr0 < Sk) {
      *reinterpret_cast<uint32_t*>(p.dk + obase + (long long)kr0 * D + c) =
          pack_bf16(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + obase + (long long)kr0 * D + c) =
          pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (kr1 < Sk) {
      *reinterpret_cast<uint32_t*>(p.dk + obase + (long long)kr1 * D + c) =
          pack_bf16(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + obase + (long long)kr1 * D + c) =
          pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

template <int D>
int launch_fwd(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr int kSmem = 4 * kBlockN * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(
      lse_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lse_fwd_kernel<D><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dq(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr int kSmem = 4 * kBlockN * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(
      lse_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lse_bwd_dq_kernel<D><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dkv(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr int kSmem = 6 * kBlockN * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(
      lse_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lse_bwd_dkv_kernel<D><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int fill_params(Params& p, const void* q, const void* k, const void* v,
                const int* valid, int BH, int Sq, int Sk, int D, int row_off,
                int col_off) {
  if (BH < 1 || BH > 65535 || Sq < 1 || Sk < 1 || (D != 64 && D != 128)) {
    return cudaErrorInvalidValue;
  }
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.valid = valid;
  p.dout = nullptr;
  p.lse = p.dstat = nullptr;
  p.out = p.dq = p.dk = p.dv = nullptr;
  p.lse_out = nullptr;
  p.Sq = Sq;
  p.Sk = Sk;
  p.row_off = row_off;
  p.col_off = col_off;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  return cudaSuccess;
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
  Params p;
  const int e = fill_params(p, q, k, v, valid, BH, Sq, Sk, D, row_off,
                            col_off);
  if (e != cudaSuccess) return e;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse_out = lse;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_fwd<128>(p, grid, st) : launch_fwd<64>(p, grid, st);
}

// The backward's first kernel: dq [BH, Sq, D] (contiguous bf16) from dout
// [BH, Sq, D] (contiguous bf16), lse and dstat [BH, Sq] fp32. The other
// arguments are those of lse_attention_fwd.
extern "C" int lse_attention_bwd_dq(const void* q, const void* k,
                                    const void* v, const int* valid,
                                    const void* dout, const float* lse,
                                    const float* dstat, void* dq, int BH,
                                    int Sq, int Sk, int D, int row_off,
                                    int col_off, void* stream) {
  Params p;
  const int e = fill_params(p, q, k, v, valid, BH, Sq, Sk, D, row_off,
                            col_off);
  if (e != cudaSuccess) return e;
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.dstat = dstat;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_bwd_dq<128>(p, grid, st)
                  : launch_bwd_dq<64>(p, grid, st);
}

// The backward's second kernel: dk, dv [BH, Sk, D] (contiguous bf16).
extern "C" int lse_attention_bwd_dkv(const void* q, const void* k,
                                     const void* v, const int* valid,
                                     const void* dout, const float* lse,
                                     const float* dstat, void* dk, void* dv,
                                     int BH, int Sq, int Sk, int D,
                                     int row_off, int col_off, void* stream) {
  Params p;
  const int e = fill_params(p, q, k, v, valid, BH, Sq, Sk, D, row_off,
                            col_off);
  if (e != cudaSuccess) return e;
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.dstat = dstat;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const dim3 grid((Sk + kBlockN - 1) / kBlockN, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_bwd_dkv<128>(p, grid, st)
                  : launch_bwd_dkv<64>(p, grid, st);
}
