// Fused draft-vocab cross-entropy, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `loss_forward_pallas` in
// specforge_tpu/ops/loss_pallas.py.
//
// What it computes. For every row r of logits x [R, V] and teacher t [R, V],
// in one streaming pass over the vocab:
//   m = max_v x,  d = sum_v exp(x - m),  ts = sum_v t,  s1 = sum_v t * x,
//   row_loss = -(s1 - ts * (m + log d)) * (mask[r] != 0).
// (m, d, ts) are saved for the backward. The scalar loss, sum(row_loss) / R,
// is left to one reduction over the R row losses in the wrapper.
//
// What bounds it on this card. Each element is read once and used for a
// handful of flops: at R = 4096, V = 32000 the pass reads 786 MB (bf16
// logits + fp32 teacher), 235 us at 3.35 TB/s, against about 10 us of fp32
// arithmetic. It is bound by memory.
//
// What the design does about that. One block of 256 threads per row; each
// thread reads 8 logits and 8 teacher values per step as 16-byte vectors
// (neighbouring threads on neighbouring addresses), keeps the online max and
// sum of exp plus the two teacher sums in fp32 registers, rescaling once per
// 8 elements, and the block merges the per-thread statistics through warp
// shuffles and shared memory. Nothing but the four per-row statistics is
// written, so the fp32 log-probabilities never reach device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // finite, as in the TPU kernel

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float x[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }

// merge the online-softmax state (m, d) with (mo, dn)
__device__ __forceinline__ void merge(float& m, float& d, float mo, float dn) {
  const float mn = fmaxf(m, mo);
  d = d * __expf(m - mn) + dn * __expf(mo - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ce_fwd_kernel(const T* __restrict__ logits,
                        const float* __restrict__ target,
                        const int* __restrict__ mask, float* row_loss,
                        float* m_out, float* d_out, float* ts_out, int V,
                        bool vectorized) {
  const long long row = blockIdx.x;
  const T* x = logits + row * V;
  const float* tp = target + row * V;
  float m = kNegInf, d = 0.f, ts = 0.f, s1 = 0.f;

  int tail = 0;
  if (vectorized) {
    const int nvec = V / 8;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float xv[8], tv[8];
      load8(x + i * 8, xv);
      load8(tp + i * 8, tv);
      float bm = xv[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) bm = fmaxf(bm, xv[k]);
      const float mn = fmaxf(m, bm);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc += __expf(xv[k] - mn);
        ts += tv[k];
        s1 += tv[k] * xv[k];
      }
      d = d * __expf(m - mn) + acc;
      m = mn;
    }
    tail = nvec * 8;
  }
  for (int i = tail + threadIdx.x; i < V; i += kThreads) {
    const float xi = to_float(x[i]);
    const float ti = tp[i];
    merge(m, d, xi, 1.f);
    ts += ti;
    s1 += ti * xi;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float dn = __shfl_xor_sync(0xffffffffu, d, off);
    merge(m, d, mo, dn);
    ts += __shfl_xor_sync(0xffffffffu, ts, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  __shared__ float sm[4][kWarps];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sm[0][warp] = m;
    sm[1][warp] = d;
    sm[2][warp] = ts;
    sm[3][warp] = s1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm[0][0];
    d = sm[1][0];
    ts = sm[2][0];
    s1 = sm[3][0];
    for (int w = 1; w < kWarps; ++w) {
      merge(m, d, sm[0][w], sm[1][w]);
      ts += sm[2][w];
      s1 += sm[3][w];
    }
    const float keep = mask[row] != 0 ? 1.f : 0.f;
    row_loss[row] = -(s1 - ts * (m + logf(d))) * keep;
    m_out[row] = m;
    d_out[row] = d;
    ts_out[row] = ts;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// logits [R, V] (bf16 when logits_bf16 != 0, else fp32), target [R, V] fp32,
// mask [R] int32; outputs row_loss, m, d, ts [R] fp32. All contiguous.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int fused_ce_fwd(const void* logits, int logits_bf16,
                            const float* target, const int* mask,
                            float* row_loss, float* m, float* d, float* ts,
                            int R, int V, void* stream) {
  if (R < 1 || V < 1) return cudaErrorInvalidValue;
  const bool vectorized =
      V % 8 == 0 && aligned16(logits) && aligned16(target);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (logits_bf16) {
    fused_ce_fwd_kernel<__nv_bfloat16><<<R, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), target, mask, row_loss, m,
        d, ts, V, vectorized);
  } else {
    fused_ce_fwd_kernel<float><<<R, kThreads, 0, st>>>(
        static_cast<const float*>(logits), target, mask, row_loss, m, d, ts,
        V, vectorized);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* specforge_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
