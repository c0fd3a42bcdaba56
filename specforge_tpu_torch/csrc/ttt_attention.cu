// TTT branch flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_fwd_pallas` in
// specforge_tpu/ops/attention_pallas.py (reached through
// `ttt_flash_attention` and `ttt_flash_attention_flat`).
//
// What it computes. Step t of the EAGLE3 TTT unroll attends, under ONE joint
// softmax, (a) causally to the step-0 keys/values, masked by `key_valid`, and
// (b) to one query-aligned diagonal key per earlier branch. The diagonal
// branch logits are NOT masked by `key_valid`, as in the TPU kernel. The
// output goes straight to the [B, S, H*D] layout the o_proj reads; the row
// statistics m (max) and l (sum of exp) are saved in fp32 for the backward.
//
// What bounds it on this card. Per launch the causal block costs
// 2*B*H*S^2*D FLOP (68.7 GFLOP at B=2, H=32, S=2048, D=128: 69 us at the
// bf16 tensor-core peak) and moves 84-185 MB (25-55 us at 3.35 TB/s), so it
// is bound by tensor-core operations.
//
// What the design does about that. The QK^T and PV products run on the
// tensor cores through `mma.sync.m16n8k16` (bf16 in, fp32 accumulate); the
// online-softmax recurrence (m, l, o) stays in fp32 registers, so no S x S
// score tile ever reaches device memory. One block of 4 warps owns 64 query
// rows of one (batch, head); each warp owns 16 rows and keeps its Q
// fragments and its O accumulator in registers. K/V tiles of 64 keys are
// staged by cp.async in two buffers of padded (bank-conflict-free) shared
// memory, so the next tile loads while this one is used, and reach the
// tensor cores through ldmatrix (transposing for V). Only the tiles up to
// the diagonal are visited. The GQA kv head is read as h / (H / KVH), so
// keys are never repeated in memory, and the ragged sequence edge is masked
// in the kernel instead of padding S. The diagonal branches are folded into
// (m, l, o) after the causal loop. Blocks are issued longest-rows first.
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
