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
// statistics m (max) and l (sum of exp) are saved in fp32 for the backward.
// The backward recomputes p = exp(s - m) / l from them, with
// delta = rowsum(dO * O) given, and forms ds = p * (dO V^T - delta):
//   dq = scale * (ds K + sum_b ds_b k_b),  dk = scale * ds^T Q,
//   dv = p^T dO,  dk_b = scale * ds_b q,  dv_b = p_b dO.
//
// What bounds it on this card. Per launch the causal block of the forward
// costs 2*B*H*S^2*D FLOP (68.7 GFLOP at B=2, H=32, S=2048, D=128: 69 us at
// the bf16 tensor-core peak) and moves 84-185 MB (25-55 us at 3.35 TB/s),
// so it is bound by tensor-core operations. The backward's dq kernel does
// three such causal products (s, dp, dq: 104 us), the dk/dv kernel four
// (s, dp, dv, dk: 139 us), against about 0.2 GB moved for the pair (60 us):
// both are bound by operations too. (A fused backward would need five
// products, 174 us for the pair.)
//
// What the design does about that. Every product runs on the tensor cores
// through `mma.sync.m16n8k16` (bf16 in, fp32 accumulate); no S x S tile
// ever reaches device memory. The forward: one block of 4 warps owns 64
// query rows of one (batch, head); each warp owns 16 rows and keeps its Q
// fragments and its O accumulator in registers, with the online-softmax
// recurrence (m, l, o) in fp32. K/V tiles of 64 keys are staged by cp.async
// in two buffers of padded (bank-conflict-free) shared memory, so the next
// tile loads while this one is used, and reach the tensor cores through
// ldmatrix (transposing where the key index is the reduction). Only the
// tiles up to the diagonal are visited. The GQA kv head is read as
// h / (H / KVH), so keys are never repeated in memory, and the ragged
// sequence edge is masked in the kernel instead of padding S. The diagonal
// branches are folded into (m, l, o) after the causal loop. Blocks are
// issued longest-rows first.
// The dq kernel has the forward's shape: Q and dO fragments of its 16 rows
// in registers, dq accumulated in fp32 registers over the causal K/V tiles,
// then the branch diagonals folded in; it writes the branch dk/dv per query
// head, and the wrapper sums the H / KVH heads of each group.
// The dk/dv kernel gives one block of 4 warps 64 keys of one (batch, kv
// head), K and V in shared memory, dk and dv accumulated in fp32 registers.
// It walks the q tiles from the diagonal down and, for each, the H / KVH
// query heads of the group, with Q, dO and the row statistics staged by
// cp.async in two buffers; so dk and dv come out as [B, KVH, S, D] with no
// atomics, in a fixed order, and two runs give the same bits.
// Not yet used: TMA, wgmma and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxKeys = 8;  // the step-0 block plus up to 7 branches
constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // finite, as in the TPU kernel

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k[kMaxKeys];
  const __nv_bfloat16* v[kMaxKeys];
  const int* valid;     // [B, S], 1 = attendable key of the causal block
  __nv_bfloat16* out;   // [B, S, H*D]
  float* m;             // [B, H, S]
  float* l;             // [B, H, S]
  long long q_sb, q_sh, q_ss;  // element strides of q over (b, h, s)
  long long k_sb, k_sh, k_ss;  // shared by every key tensor
  long long v_sb, v_sh, v_ss;  // shared by every value tensor
  int H, KVH, S, n_branches;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
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

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs 0..3: (row g, cols 2t..2t+1), (row g+8, 2t..), (row g, 2t+8..),
//                (row g+8, 2t+8..)
//   B regs 0..1: (k rows 2t..2t+1, col g), (k rows 2t+8..2t+9, col g)
//   C regs 0..3: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
// So a thread holds rows g and g+8 of its warp's 16, and head-dim columns
// {8j + 2t, 8j + 2t + 1} of both Q (as A) and O (as C).
template <int D>
__global__ void __launch_bounds__(kThreads) ttt_fwd_kernel(const Params p) {
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

  const int S = p.S;
  const int n_qtiles = (S + kBlockM - 1) / kBlockM;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // longest rows first
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qtile * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool in0 = row0 < S;
  const bool in1 = row1 < S;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = in0 ? ld32(qb + row0 * p.q_ss + c) : 0u;
    qf[ks][1] = in1 ? ld32(qb + row1 * p.q_ss + c) : 0u;
    qf[ks][2] = in0 ? ld32(qb + row0 * p.q_ss + c + 8) : 0u;
    qf[ks][3] = in1 ? ld32(qb + row1 * p.q_ss + c + 8) : 0u;
  }

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;  // per-thread partial sums until the quad reduce

  const __nv_bfloat16* kbase = p.k[0] + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase = p.v[0] + b * p.v_sb + kvh * p.v_sh;
  const int* valid = p.valid + (long long)b * S;

  // stage k tile j into buffer `buf`: K/V through cp.async (rows past S
  // are zero-filled), the validity flags through plain loads
  auto load_tile = [&](int j, int buf) {
    const int key0 = j * kBlockN;
    __nv_bfloat16* sK = sKs + buf * kTile;
    __nv_bfloat16* sV = sVs + buf * kTile;
    for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int key = key0 + r;
      const long long src = key < S ? key : 0;
      cp_async16(sK + r * kStride + c, kbase + src * p.k_ss + c, key < S);
      cp_async16(sV + r * kStride + c, vbase + src * p.v_ss + c, key < S);
    }
    for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
      const int key = key0 + i;
      sValids[buf][i] = key < S ? valid[key] : 0;
    }
    cp_async_commit();
  };

  const int last_row = min(qtile * kBlockM + kBlockM, S) - 1;
  const int n_ktiles = last_row / kBlockN + 1;  // causal tile skip
  load_tile(0, 0);
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
        s[nt][e] = (ok && col <= row0) ? s[nt][e] * p.scale : kNegInf;
        s[nt][2 + e] = (ok && col <= row1) ? s[nt][2 + e] * p.scale : kNegInf;
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

  // diagonal branches: one query-aligned key per earlier TTT step, folded
  // into the same (m, l, o) statistics; not masked by key_valid
  for (int br = 0; br < p.n_branches; ++br) {
    const __nv_bfloat16* kb = p.k[1 + br] + b * p.k_sb + kvh * p.k_sh;
    const __nv_bfloat16* vb = p.v[1 + br] + b * p.v_sb + kvh * p.v_sh;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int c = ks * 16 + 2 * t;
      if (in0) {
        const float2 qa = unpack_bf16(qf[ks][0]);
        const float2 qc = unpack_bf16(qf[ks][2]);
        const float2 ka = unpack_bf16(ld32(kb + row0 * p.k_ss + c));
        const float2 kc = unpack_bf16(ld32(kb + row0 * p.k_ss + c + 8));
        d0 += qa.x * ka.x + qa.y * ka.y + qc.x * kc.x + qc.y * kc.y;
      }
      if (in1) {
        const float2 qa = unpack_bf16(qf[ks][1]);
        const float2 qc = unpack_bf16(qf[ks][3]);
        const float2 ka = unpack_bf16(ld32(kb + row1 * p.k_ss + c));
        const float2 kc = unpack_bf16(ld32(kb + row1 * p.k_ss + c + 8));
        d1 += qa.x * ka.x + qa.y * ka.y + qc.x * kc.x + qc.y * kc.y;
      }
    }
    const float w0 = quad_sum(d0) * p.scale;
    const float w1 = quad_sum(d1) * p.scale;
    const float n0 = fmaxf(m0, w0);
    const float n1 = fmaxf(m1, w1);
    const float c0 = __expf(m0 - n0), e0 = __expf(w0 - n0);
    const float c1 = __expf(m1 - n1), e1 = __expf(w1 - n1);
    l0 = l0 * c0 + e0;
    l1 = l1 * c1 + e1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      const int c = dt * 8 + 2 * t;
      const float2 va =
          in0 ? unpack_bf16(ld32(vb + row0 * p.v_ss + c)) : make_float2(0.f, 0.f);
      const float2 vc =
          in1 ? unpack_bf16(ld32(vb + row1 * p.v_ss + c)) : make_float2(0.f, 0.f);
      o[dt][0] = o[dt][0] * c0 + e0 * va.x;
      o[dt][1] = o[dt][1] * c0 + e0 * va.y;
      o[dt][2] = o[dt][2] * c1 + e1 * vc.x;
      o[dt][3] = o[dt][3] * c1 + e1 * vc.y;
    }
  }

  const long long HD = (long long)p.H * D;
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (in0) {
    __nv_bfloat16* op = p.out + ((long long)b * S + row0) * HD + h * D;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    }
  }
  if (in1) {
    __nv_bfloat16* op = p.out + ((long long)b * S + row1) * HD + h * D;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
  if (t == 0) {
    const long long base = ((long long)b * p.H + h) * S;
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

template <int D>
int launch(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr int kSmem = 4 * kBlockN * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(
      ttt_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ttt_fwd_kernel<D><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// backward
// --------------------------------------------------------------------------

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k[kMaxKeys];
  const __nv_bfloat16* v[kMaxKeys];
  const int* valid;            // [B, S]
  const __nv_bfloat16* dout;   // [B, S, H*D], contiguous
  const float* m;              // [B, H, S]
  const float* l;              // [B, H, S]
  const float* delta;          // [B, H, S], rowsum(dO * O)
  __nv_bfloat16* dq;           // [B, H, S, D], contiguous
  __nv_bfloat16* dkb;          // [NB, B, H, S, D]: branch dk per query head
  __nv_bfloat16* dvb;          // [NB, B, H, S, D]
  __nv_bfloat16* dk;           // [B, KVH, S, D], contiguous
  __nv_bfloat16* dv;           // [B, KVH, S, D], contiguous
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int B, H, KVH, S, n_branches;
  float scale;
};

// A-operand fragments of a 16-row slab (rows row0 and row0 + 8 of this
// thread) straight from device memory; rows past S read as zeros
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

// dq, plus the branch dk/dv: one block owns 64 query rows of one
// (batch, head), 16 per warp, and walks the causal K/V tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) ttt_bwd_dq_kernel(const BwdParams p) {
  constexpr int kStride = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kVecPerRow = D / 8;
  constexpr int kTile = kBlockN * kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sKs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sVs = sKs + 2 * kTile;
  __shared__ int sValids[2][kBlockN];

  const int S = p.S;
  const int H = p.H;
  const int n_qtiles = (S + kBlockM - 1) / kBlockM;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // longest rows first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / p.KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qtile * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool in0 = row0 < S;
  const bool in1 = row1 < S;
  const long long HD = (long long)H * D;

  uint32_t qf[kSteps][4], df[kSteps][4];
  load_a_frags<kSteps>(qf, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, row0, in0,
                       in1, t);
  load_a_frags<kSteps>(df, p.dout + (long long)b * S * HD + h * D, HD, row0,
                       in0, in1, t);
  const long long sbase = ((long long)b * H + h) * S;
  // rows past S get p = 0 (inverse l of 0)
  const float m0 = in0 ? p.m[sbase + row0] : 0.f;
  const float m1 = in1 ? p.m[sbase + row1] : 0.f;
  const float il0 = in0 ? 1.f / fmaxf(p.l[sbase + row0], 1e-30f) : 0.f;
  const float il1 = in1 ? 1.f / fmaxf(p.l[sbase + row1], 1e-30f) : 0.f;
  const float dl0 = in0 ? p.delta[sbase + row0] : 0.f;
  const float dl1 = in1 ? p.delta[sbase + row1] : 0.f;

  float dq[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
  }

  const __nv_bfloat16* kbase = p.k[0] + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase = p.v[0] + b * p.v_sb + kvh * p.v_sh;
  const int* valid = p.valid + (long long)b * S;

  auto load_tile = [&](int j, int buf) {
    const int key0 = j * kBlockN;
    __nv_bfloat16* sK = sKs + buf * kTile;
    __nv_bfloat16* sV = sVs + buf * kTile;
    for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int key = key0 + r;
      const long long src = key < S ? key : 0;
      cp_async16(sK + r * kStride + c, kbase + src * p.k_ss + c, key < S);
      cp_async16(sV + r * kStride + c, vbase + src * p.v_ss + c, key < S);
    }
    for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
      const int key = key0 + i;
      sValids[buf][i] = key < S ? valid[key] : 0;
    }
    cp_async_commit();
  };

  const int last_row = min(qtile * kBlockM + kBlockM, S) - 1;
  const int n_ktiles = last_row / kBlockN + 1;  // causal tile skip
  load_tile(0, 0);
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
      // ds = p * (dp - delta), p recomputed under the causal/valid mask
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = (2 * kk + e2) * 8 + 2 * t + e;
          const int col = key0 + kc;
          const bool ok = sValid[kc] != 0;
          const float p0 =
              (ok && col <= row0) ? __expf(s[e2][e] * p.scale - m0) * il0 : 0.f;
          const float p1 = (ok && col <= row1)
                               ? __expf(s[e2][2 + e] * p.scale - m1) * il1
                               : 0.f;
          s[e2][e] = p0 * (dp[e2][e] - dl0);
          s[e2][2 + e] = p1 * (dp[e2][2 + e] - dl1);
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

  // diagonal branches: p_b = exp(q.k_b * scale - m) / l, not masked by
  // key_valid; dq gains ds_b k_b, and k_b / v_b get their grads per head
  const long long bstride = (long long)p.B * H * S * D;
  const long long obase = (((long long)b * H + h) * S) * D;
  for (int br = 0; br < p.n_branches; ++br) {
    const __nv_bfloat16* kb = p.k[1 + br] + b * p.k_sb + kvh * p.k_sh;
    const __nv_bfloat16* vb = p.v[1 + br] + b * p.v_sb + kvh * p.v_sh;
    float w0 = 0.f, w1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int c = ks * 16 + 2 * t;
      if (in0) {
        const float2 qa = unpack_bf16(qf[ks][0]), qc = unpack_bf16(qf[ks][2]);
        const float2 da = unpack_bf16(df[ks][0]), dc = unpack_bf16(df[ks][2]);
        const float2 ka = unpack_bf16(ld32(kb + row0 * p.k_ss + c));
        const float2 kc = unpack_bf16(ld32(kb + row0 * p.k_ss + c + 8));
        const float2 va = unpack_bf16(ld32(vb + row0 * p.v_ss + c));
        const float2 vc = unpack_bf16(ld32(vb + row0 * p.v_ss + c + 8));
        w0 += qa.x * ka.x + qa.y * ka.y + qc.x * kc.x + qc.y * kc.y;
        u0 += da.x * va.x + da.y * va.y + dc.x * vc.x + dc.y * vc.y;
      }
      if (in1) {
        const float2 qa = unpack_bf16(qf[ks][1]), qc = unpack_bf16(qf[ks][3]);
        const float2 da = unpack_bf16(df[ks][1]), dc = unpack_bf16(df[ks][3]);
        const float2 ka = unpack_bf16(ld32(kb + row1 * p.k_ss + c));
        const float2 kc = unpack_bf16(ld32(kb + row1 * p.k_ss + c + 8));
        const float2 va = unpack_bf16(ld32(vb + row1 * p.v_ss + c));
        const float2 vc = unpack_bf16(ld32(vb + row1 * p.v_ss + c + 8));
        w1 += qa.x * ka.x + qa.y * ka.y + qc.x * kc.x + qc.y * kc.y;
        u1 += da.x * va.x + da.y * va.y + dc.x * vc.x + dc.y * vc.y;
      }
    }
    const float pb0 = in0 ? __expf(quad_sum(w0) * p.scale - m0) * il0 : 0.f;
    const float pb1 = in1 ? __expf(quad_sum(w1) * p.scale - m1) * il1 : 0.f;
    const float dsb0 = pb0 * (quad_sum(u0) - dl0);
    const float dsb1 = pb1 * (quad_sum(u1) - dl1);
    __nv_bfloat16* dkb = p.dkb + br * bstride + obase;
    __nv_bfloat16* dvb = p.dvb + br * bstride + obase;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int dt = 2 * ks + half;
        const int c = dt * 8 + 2 * t;
        if (in0) {
          const float2 kv = unpack_bf16(ld32(kb + row0 * p.k_ss + c));
          const float2 qv = unpack_bf16(qf[ks][2 * half]);
          const float2 dv = unpack_bf16(df[ks][2 * half]);
          dq[dt][0] += dsb0 * kv.x;
          dq[dt][1] += dsb0 * kv.y;
          *reinterpret_cast<uint32_t*>(dkb + row0 * D + c) =
              pack_bf16(dsb0 * qv.x * p.scale, dsb0 * qv.y * p.scale);
          *reinterpret_cast<uint32_t*>(dvb + row0 * D + c) =
              pack_bf16(pb0 * dv.x, pb0 * dv.y);
        }
        if (in1) {
          const float2 kv = unpack_bf16(ld32(kb + row1 * p.k_ss + c));
          const float2 qv = unpack_bf16(qf[ks][2 * half + 1]);
          const float2 dv = unpack_bf16(df[ks][2 * half + 1]);
          dq[dt][2] += dsb1 * kv.x;
          dq[dt][3] += dsb1 * kv.y;
          *reinterpret_cast<uint32_t*>(dkb + row1 * D + c) =
              pack_bf16(dsb1 * qv.x * p.scale, dsb1 * qv.y * p.scale);
          *reinterpret_cast<uint32_t*>(dvb + row1 * D + c) =
              pack_bf16(pb1 * dv.x, pb1 * dv.y);
        }
      }
    }
  }

  __nv_bfloat16* dqp = p.dq + obase;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (in0) {
      *reinterpret_cast<uint32_t*>(dqp + row0 * D + c) =
          pack_bf16(dq[dt][0] * p.scale, dq[dt][1] * p.scale);
    }
    if (in1) {
      *reinterpret_cast<uint32_t*>(dqp + row1 * D + c) =
          pack_bf16(dq[dt][2] * p.scale, dq[dt][3] * p.scale);
    }
  }
}

// dk/dv of the causal block: one block owns 64 keys of one (batch, kv
// head), 16 per warp, and walks (query head of the group, q tile) pairs
// from the diagonal down, so the group's heads are summed in registers.
template <int D>
__global__ void __launch_bounds__(kThreads) ttt_bwd_dkv_kernel(const BwdParams p) {
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
  __shared__ float sM[2][kBlockN], sIL[2][kBlockN], sDl[2][kBlockN];

  const int S = p.S;
  const int H = p.H;
  const int G = H / p.KVH;
  const int n_qtiles = (S + kBlockN - 1) / kBlockN;
  const int ktile = blockIdx.x;  // most q tiles first
  const int b = blockIdx.y / p.KVH;
  const int kvh = blockIdx.y % p.KVH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = ktile * kBlockM;
  const int kr0 = key0 + warp * 16 + g;  // this thread's two keys
  const int kr1 = kr0 + 8;
  const int* valid = p.valid + (long long)b * S;
  const bool kv0 = kr0 < S && valid[kr0] != 0;
  const bool kv1 = kr1 < S && valid[kr1] != 0;
  const long long HD = (long long)H * D;

  // K and V of this block's keys, once
  {
    const __nv_bfloat16* kbase = p.k[0] + b * p.k_sb + kvh * p.k_sh;
    const __nv_bfloat16* vbase = p.v[0] + b * p.v_sb + kvh * p.v_sh;
    for (int i = threadIdx.x; i < kBlockM * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int key = key0 + r;
      const long long src = key < S ? key : 0;
      cp_async16(sK + r * kStride + c, kbase + src * p.k_ss + c, key < S);
      cp_async16(sV + r * kStride + c, vbase + src * p.v_ss + c, key < S);
    }
    cp_async_commit();
  }

  // iteration it covers query head kvh * G + it / nq of q tile
  // ktile + it % nq
  const int nq = n_qtiles - ktile;
  const int n_iters = G * nq;
  auto load_q = [&](int it, int buf) {
    const int h = kvh * G + it / nq;
    const int q0 = (ktile + it % nq) * kBlockN;
    const __nv_bfloat16* qbase = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dbase = p.dout + (long long)b * S * HD + h * D;
    __nv_bfloat16* sQ = sQs + buf * kTile;
    __nv_bfloat16* sDO = sDOs + buf * kTile;
    for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int row = q0 + r;
      const long long src = row < S ? row : 0;
      cp_async16(sQ + r * kStride + c, qbase + src * p.q_ss + c, row < S);
      cp_async16(sDO + r * kStride + c, dbase + src * HD + c, row < S);
    }
    const long long sbase = ((long long)b * H + h) * S;
    for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
      const int row = q0 + i;
      const bool in = row < S;
      sM[buf][i] = in ? p.m[sbase + row] : 0.f;
      sIL[buf][i] = in ? 1.f / fmaxf(p.l[sbase + row], 1e-30f) : 0.f;
      sDl[buf][i] = in ? p.delta[sbase + row] : 0.f;
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
  load_q(0, 0);
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
    const int q0 = (ktile + it % nq) * kBlockN;

#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
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
          const int off = ((2 * kk + e2) * 8 + (lane & 7)) * kStride +
                          (lane >> 3) * 8 + ks * 16;
          uint32_t f[4];
          ldmatrix_x4(f, sQ + off);
          mma_bf16(s[e2], ka0, f[0], f[1]);
          mma_bf16(s[e2], ka1, f[2], f[3]);
          ldmatrix_x4(f, sDO + off);
          mma_bf16(dp[e2], va0, f[0], f[1]);
          mma_bf16(dp[e2], va1, f[2], f[3]);
        }
      }
      // p^T under the causal/valid mask, ds^T = p^T * (dp^T - delta)
      float pt[2][4];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = kk * 16 + e2 * 8 + 2 * t + (i & 1);
          const int row = q0 + qi;
          const bool ok = i < 2 ? (kv0 && kr0 <= row) : (kv1 && kr1 <= row);
          const float pv =
              (ok && row < S) ? __expf(s[e2][i] * p.scale - sM[buf][qi]) *
                                    sIL[buf][qi]
                              : 0.f;
          pt[e2][i] = pv;
          s[e2][i] = pv * (dp[e2][i] - sDl[buf][qi]);
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

  const long long obase = ((long long)b * p.KVH + kvh) * S * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (kr0 < S) {
      *reinterpret_cast<uint32_t*>(p.dk + obase + kr0 * D + c) =
          pack_bf16(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + obase + kr0 * D + c) =
          pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (kr1 < S) {
      *reinterpret_cast<uint32_t*>(p.dk + obase + kr1 * D + c) =
          pack_bf16(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + obase + kr1 * D + c) =
          pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

template <int D>
int launch_bwd_dq(const BwdParams& p, dim3 grid, cudaStream_t st) {
  constexpr int kSmem = 4 * kBlockN * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(
      ttt_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ttt_bwd_dq_kernel<D><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dkv(const BwdParams& p, dim3 grid, cudaStream_t st) {
  constexpr int kSmem = 6 * kBlockN * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(
      ttt_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ttt_bwd_dkv_kernel<D><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int fill_bwd_params(BwdParams& p, const void* q, const long long* q_strides,
                    const void* const* keys, const void* const* values,
                    int n_keys, const long long* k_strides,
                    const long long* v_strides, const int* valid,
                    const void* dout, const float* m, const float* l,
                    const float* delta, int B, int H, int KVH, int S, int D) {
  if (n_keys < 1 || n_keys > kMaxKeys || KVH < 1 || H % KVH != 0 ||
      B * H > 65535 || S < 1 || (D != 64 && D != 128)) {
    return cudaErrorInvalidValue;
  }
  p.q = static_cast<const __nv_bfloat16*>(q);
  for (int i = 0; i < kMaxKeys; ++i) {
    p.k[i] = i < n_keys ? static_cast<const __nv_bfloat16*>(keys[i]) : nullptr;
    p.v[i] = i < n_keys ? static_cast<const __nv_bfloat16*>(values[i]) : nullptr;
  }
  p.valid = valid;
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.m = m;
  p.l = l;
  p.delta = delta;
  p.dq = p.dkb = p.dvb = p.dk = p.dv = nullptr;
  p.q_sb = q_strides[0];
  p.q_sh = q_strides[1];
  p.q_ss = q_strides[2];
  p.k_sb = k_strides[0];
  p.k_sh = k_strides[1];
  p.k_ss = k_strides[2];
  p.v_sb = v_strides[0];
  p.v_sh = v_strides[1];
  p.v_ss = v_strides[2];
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.n_branches = n_keys - 1;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  return cudaSuccess;
}

}  // namespace

// keys/values: n_keys device pointers each (the step-0 block first, then
// the branches); *_strides: element strides over (b, h, s); the head dim is
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int ttt_attention_fwd(const void* q, const long long* q_strides,
                                 const void* const* keys,
                                 const void* const* values, int n_keys,
                                 const long long* k_strides,
                                 const long long* v_strides, const int* valid,
                                 void* out, float* m, float* l, int B, int H,
                                 int KVH, int S, int D, void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || KVH < 1 || H % KVH != 0 ||
      B * H > 65535 || S < 1) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  for (int i = 0; i < kMaxKeys; ++i) {
    p.k[i] = i < n_keys ? static_cast<const __nv_bfloat16*>(keys[i]) : nullptr;
    p.v[i] = i < n_keys ? static_cast<const __nv_bfloat16*>(values[i]) : nullptr;
  }
  p.valid = valid;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = m;
  p.l = l;
  p.q_sb = q_strides[0];
  p.q_sh = q_strides[1];
  p.q_ss = q_strides[2];
  p.k_sb = k_strides[0];
  p.k_sh = k_strides[1];
  p.k_ss = k_strides[2];
  p.v_sb = v_strides[0];
  p.v_sh = v_strides[1];
  p.v_ss = v_strides[2];
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.n_branches = n_keys - 1;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(p, grid, st);
  if (D == 64) return launch<64>(p, grid, st);
  return cudaErrorInvalidValue;
}

// The backward's first kernel: dq [B, H, S, D] and, per branch, dk_b/dv_b
// per query head [NB, B, H, S, D] (all contiguous bf16). dout [B, S, H*D]
// is contiguous; m, l, delta are [B, H, S] fp32. The other arguments are
// those of ttt_attention_fwd.
extern "C" int ttt_attention_bwd_dq(
    const void* q, const long long* q_strides, const void* const* keys,
    const void* const* values, int n_keys, const long long* k_strides,
    const long long* v_strides, const int* valid, const void* dout,
    const float* m, const float* l, const float* delta, void* dq, void* dkb,
    void* dvb, int B, int H, int KVH, int S, int D, void* stream) {
  BwdParams p;
  const int e = fill_bwd_params(p, q, q_strides, keys, values, n_keys,
                                k_strides, v_strides, valid, dout, m, l,
                                delta, B, H, KVH, S, D);
  if (e != cudaSuccess) return e;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dkb = static_cast<__nv_bfloat16*>(dkb);
  p.dvb = static_cast<__nv_bfloat16*>(dvb);
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_bwd_dq<128>(p, grid, st)
                  : launch_bwd_dq<64>(p, grid, st);
}

// The backward's second kernel: dk, dv [B, KVH, S, D] (contiguous bf16) of
// the causal block, summed over the query heads of each group.
extern "C" int ttt_attention_bwd_dkv(
    const void* q, const long long* q_strides, const void* const* keys,
    const void* const* values, int n_keys, const long long* k_strides,
    const long long* v_strides, const int* valid, const void* dout,
    const float* m, const float* l, const float* delta, void* dk, void* dv,
    int B, int H, int KVH, int S, int D, void* stream) {
  BwdParams p;
  const int e = fill_bwd_params(p, q, q_strides, keys, values, n_keys,
                                k_strides, v_strides, valid, dout, m, l,
                                delta, B, H, KVH, S, D);
  if (e != cudaSuccess) return e;
  if (B * KVH > 65535) return cudaErrorInvalidValue;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const dim3 grid((S + kBlockN - 1) / kBlockN, B * KVH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_bwd_dkv<128>(p, grid, st)
                  : launch_bwd_dkv<64>(p, grid, st);
}
