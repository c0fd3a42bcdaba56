// Fused draft-vocab cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of specforge_tpu/ops/loss_pallas.py:
// `_fwd_kernel` / `loss_forward_pallas` (forward) and `_bwd_kernel` /
// `loss_backward_pallas` (backward).
//
// What it computes. For every row r of logits x [R, V] and teacher t [R, V],
// the forward makes one streaming pass over the vocab:
//   m = max_v x,  d = sum_v exp(x - m),  ts = sum_v t,  s1 = sum_v t * x,
//   row_loss = -(s1 - ts * (m + log d)) * (mask[r] != 0).
// (m, d, ts) are saved for the backward. The scalar loss, sum(row_loss) / R,
// is left to one reduction over the R row losses in the wrapper. The
// backward is one elementwise pass from the saved statistics:
//   grad = -(t * g - exp(x - m) / d * ts * g) * (mask[r] != 0),  g = dL / R,
// written in the logits' dtype. Rows are [T, V] blocks of B batches: the
// logits are contiguous, the teacher may be a slice of a longer [B, T', V]
// tensor (the TTT step's window of the padded teacher), read through its
// batch stride so no copy of it is made or kept for the backward.
//
// What bounds it on this card. Each element is read once and used for a
// handful of flops: at R = 4096, V = 32000 the forward reads 786 MB (bf16
// logits + fp32 teacher), 235 us at 3.35 TB/s, against about 10 us of fp32
// arithmetic; the backward also writes the bf16 gradient, 1.05 GB moved,
// 313 us. Both are bound by memory.
//
// What the design does about that. One block of 256 threads per row; each
// thread reads 8 logits and 8 teacher values per step as 16-byte vectors
// (neighbouring threads on neighbouring addresses). The forward keeps the
// online max and sum of exp plus the two teacher sums in fp32 registers,
// rescaling once per 8 elements, and the block merges the per-thread
// statistics through warp shuffles and shared memory; nothing but the four
// per-row statistics is written, so the fp32 log-probabilities never reach
// device memory. The backward reads (m, d, ts) once per row and writes the
// gradient as 16-byte vectors; a masked row reads nothing and writes zeros.

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

// row r = b * T_rows + i of the teacher: [B, T', V] rows i < T' of batch b
__device__ __forceinline__ const float* teacher_row(const float* target,
                                                    long long row, int V,
                                                    int T_rows, long long t_sb) {
  return target + (row / T_rows) * t_sb + (row % T_rows) * (long long)V;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float x[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float x[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ce_fwd_kernel(const T* __restrict__ logits,
                        const float* __restrict__ target,
                        const int* __restrict__ mask, float* row_loss,
                        float* m_out, float* d_out, float* ts_out, int V,
                        int T_rows, long long t_sb, bool vectorized) {
  const long long row = blockIdx.x;
  const T* x = logits + row * V;
  const float* tp = teacher_row(target, row, V, T_rows, t_sb);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ce_bwd_kernel(const T* __restrict__ logits,
                        const float* __restrict__ target,
                        const float* __restrict__ m_in,
                        const float* __restrict__ d_in,
                        const float* __restrict__ ts_in,
                        const int* __restrict__ mask,
                        const float* __restrict__ g_in, T* grad, int V,
                        int T_rows, long long t_sb, float inv_rows,
                        bool vectorized) {
  const long long row = blockIdx.x;
  T* out = grad + row * V;
  const int nvec = vectorized ? V / 8 : 0;
  if (mask[row] == 0) {  // masked row: zeros, nothing read
    const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < nvec; i += kThreads) store8(out + i * 8, z);
    for (int i = nvec * 8 + threadIdx.x; i < V; i += kThreads) store1(out + i, 0.f);
    return;
  }
  const T* x = logits + row * V;
  const float* tp = teacher_row(target, row, V, T_rows, t_sb);
  const float g = g_in[0] * inv_rows;
  const float m = m_in[row];
  const float inv_d = 1.f / d_in[row];
  const float tsg = ts_in[row] * g;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float xv[8], tv[8];
    load8(x + i * 8, xv);
    load8(tp + i * 8, tv);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      xv[k] = -(tv[k] * g - __expf(xv[k] - m) * inv_d * tsg);
    }
    store8(out + i * 8, xv);
  }
  for (int i = nvec * 8 + threadIdx.x; i < V; i += kThreads) {
    const float xi = to_float(x[i]);
    store1(out + i, -(tp[i] * g - __expf(xi - m) * inv_d * tsg));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// logits [R, V] contiguous (bf16 when logits_bf16 != 0, else fp32), with
// R = B * T_rows; target: B blocks of [T_rows, V] fp32 rows, block b at
// target + b * t_sb (rows contiguous within a block); mask [R] int32;
// outputs row_loss, m, d, ts [R] fp32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int fused_ce_fwd(const void* logits, int logits_bf16,
                            const float* target, const int* mask,
                            float* row_loss, float* m, float* d, float* ts,
                            int R, int V, int T_rows, long long t_sb,
                            void* stream) {
  if (R < 1 || V < 1 || T_rows < 1 || R % T_rows != 0) {
    return cudaErrorInvalidValue;
  }
  const bool vectorized = V % 8 == 0 && t_sb % 8 == 0 && aligned16(logits) &&
                          aligned16(target);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (logits_bf16) {
    fused_ce_fwd_kernel<__nv_bfloat16><<<R, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), target, mask, row_loss, m,
        d, ts, V, T_rows, t_sb, vectorized);
  } else {
    fused_ce_fwd_kernel<float><<<R, kThreads, 0, st>>>(
        static_cast<const float*>(logits), target, mask, row_loss, m, d, ts,
        V, T_rows, t_sb, vectorized);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradient of the fused CE loss with respect to the logits, from the
// forward's (m, d, ts) and the upstream gradient g [1] (device memory, so
// no host sync): grad [R, V] in the logits' dtype, contiguous. The other
// arguments are those of fused_ce_fwd.
extern "C" int fused_ce_bwd(const void* logits, int logits_bf16,
                            const float* target, const float* m,
                            const float* d, const float* ts, const int* mask,
                            const float* g, void* grad, int R, int V,
                            int T_rows, long long t_sb, void* stream) {
  if (R < 1 || V < 1 || T_rows < 1 || R % T_rows != 0) {
    return cudaErrorInvalidValue;
  }
  const bool vectorized = V % 8 == 0 && t_sb % 8 == 0 && aligned16(logits) &&
                          aligned16(target) && aligned16(grad);
  const float inv_rows = 1.f / static_cast<float>(R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (logits_bf16) {
    fused_ce_bwd_kernel<__nv_bfloat16><<<R, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), target, m, d, ts, mask, g,
        static_cast<__nv_bfloat16*>(grad), V, T_rows, t_sb, inv_rows,
        vectorized);
  } else {
    fused_ce_bwd_kernel<float><<<R, kThreads, 0, st>>>(
        static_cast<const float*>(logits), target, m, d, ts, mask, g,
        static_cast<float*>(grad), V, T_rows, t_sb, inv_rows, vectorized);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* specforge_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
