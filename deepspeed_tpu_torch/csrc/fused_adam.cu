// Fused AdamW and Lion steps over flat buffers, in place, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/adam/fused_adam.py::_adamw_kernel and
// ::_lion_kernel (the Pallas TPU kernels behind fused_adamw_flat and
// fused_lion_flat, via _flat_kernel_call).
//
// AdamW, for every element i (p, m, v fp32; g fp32 or bf16):
//   m = beta1 * m + (1 - beta1) * g
//   v = beta2 * v + (1 - beta2) * g * g
//   p = p - lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * p)
// with bc1 = 1 - beta1^step and bc2 = 1 - beta2^step computed in float32 by
// the caller, as the Pallas kernel receives them.
//
// Lion, for every element i (p, m fp32; g fp32 or bf16):
//   c = beta1 * m + (1 - beta1) * g
//   p = p - lr * (sign(c) + wd * p)        sign(0) = 0
//   m = beta2 * m + (1 - beta2) * g
// with the four scalars float32 and 1 - beta computed in float32, as the
// Pallas body reads them from SMEM.
//
// Every operation is an explicitly rounded IEEE intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so the compiler contracts nothing into a
// fused multiply-add and the result is the plain PyTorch version's, operation
// for operation.
//
// What bounds them on the H100: AdamW reads p, m, v and g once and writes p,
// m, v once (28 bytes an element with an fp32 grad, 26 with bf16); Lion reads
// p, m and g and writes p and m (20 and 18 bytes); each does about a dozen
// operations an element, so device memory (3.35 TB/s) bounds both.  The
// design follows: one grid-stride pass, four elements a thread a step through
// 16-byte loads and stores (8-byte for a bf16 grad), enough blocks to keep
// every SM's memory pipeline full; a scalar tail handles n % 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks on each of the H100's 132 SMs

struct Scalars {
  float lr, beta1, beta2, eps, wd, bc1, bc2, one_minus_beta1, one_minus_beta2;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void adamw(float& p, float& m, float& v, float g, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_minus_beta1, g));
  v = __fadd_rn(__fmul_rn(s.beta2, v), __fmul_rn(__fmul_rn(s.one_minus_beta2, g), g));
  const float m_hat = __fdiv_rn(m, s.bc1);
  const float v_hat = __fdiv_rn(v, s.bc2);
  const float update =
      __fadd_rn(__fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), s.eps)), __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, update));
}

// four grad elements as floats
__device__ __forceinline__ float4 load4(const float* g, int64_t i) {
  return reinterpret_cast<const float4*>(g)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* g, int64_t i) {
  const uint2 raw = reinterpret_cast<const uint2*>(g)[i];
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]), __bfloat162float(e[2]),
                     __bfloat162float(e[3]));
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
             const G* __restrict__ g, int64_t n, Scalars s) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t n4 = n / 4;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    float4 pv = reinterpret_cast<float4*>(p)[i];
    float4 mv = reinterpret_cast<float4*>(m)[i];
    float4 vv = reinterpret_cast<float4*>(v)[i];
    const float4 gv = load4(g, i);
    adamw(pv.x, mv.x, vv.x, gv.x, s);
    adamw(pv.y, mv.y, vv.y, gv.y, s);
    adamw(pv.z, mv.z, vv.z, gv.z, s);
    adamw(pv.w, mv.w, vv.w, gv.w, s);
    reinterpret_cast<float4*>(p)[i] = pv;
    reinterpret_cast<float4*>(m)[i] = mv;
    reinterpret_cast<float4*>(v)[i] = vv;
  }
  // the n % 4 tail, one element a thread
  const int64_t t = n4 * 4 + (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t < n) {
    float pt = p[t], mt = m[t], vt = v[t];
    adamw(pt, mt, vt, to_float(g[t]), s);
    p[t] = pt;
    m[t] = mt;
    v[t] = vt;
  }
}

// blocks for a grid-stride pass over n elements, four a thread a step
int64_t grid_for(int64_t n) {
  int64_t blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

template <typename G>
cudaError_t launch(float* p, float* m, float* v, const void* g, int64_t n, const Scalars& s,
                   cudaStream_t stream) {
  adamw_kernel<G><<<(int)grid_for(n), kThreads, 0, stream>>>(p, m, v, static_cast<const G*>(g),
                                                             n, s);
  return cudaGetLastError();
}

struct LionScalars {
  float lr, beta1, beta2, wd, one_minus_beta1, one_minus_beta2;
};

__device__ __forceinline__ void lion(float& p, float& m, float g, const LionScalars& s) {
  const float c = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_minus_beta1, g));
  const float sign = c > 0.f ? 1.f : (c < 0.f ? -1.f : 0.f);
  p = __fsub_rn(p, __fmul_rn(s.lr, __fadd_rn(sign, __fmul_rn(s.wd, p))));
  m = __fadd_rn(__fmul_rn(s.beta2, m), __fmul_rn(s.one_minus_beta2, g));
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
lion_kernel(float* __restrict__ p, float* __restrict__ m, const G* __restrict__ g, int64_t n,
            LionScalars s) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t n4 = n / 4;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    float4 pv = reinterpret_cast<float4*>(p)[i];
    float4 mv = reinterpret_cast<float4*>(m)[i];
    const float4 gv = load4(g, i);
    lion(pv.x, mv.x, gv.x, s);
    lion(pv.y, mv.y, gv.y, s);
    lion(pv.z, mv.z, gv.z, s);
    lion(pv.w, mv.w, gv.w, s);
    reinterpret_cast<float4*>(p)[i] = pv;
    reinterpret_cast<float4*>(m)[i] = mv;
  }
  // the n % 4 tail, one element a thread
  const int64_t t = n4 * 4 + (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t < n) {
    float pt = p[t], mt = m[t];
    lion(pt, mt, to_float(g[t]), s);
    p[t] = pt;
    m[t] = mt;
  }
}

template <typename G>
cudaError_t launch_lion(float* p, float* m, const void* g, int64_t n, const LionScalars& s,
                        cudaStream_t stream) {
  lion_kernel<G><<<(int)grid_for(n), kThreads, 0, stream>>>(p, m, static_cast<const G*>(g), n, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// grad_dtype: 0 = float32, 1 = bfloat16.  p/m/v float32 [n] and g [n], all
// contiguous on one device and 16-byte aligned; p, m and v are updated in
// place.  bc1/bc2 are the float32 bias corrections.  Returns a cudaError_t
// (0 = launched).
int fused_adamw_launch(int grad_dtype, void* p, void* m, void* v, const void* g, long long n,
                       float lr, float beta1, float beta2, float eps, float weight_decay,
                       float bc1, float bc2, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const Scalars s{lr, beta1, beta2, eps, weight_decay, bc1, bc2, 1.0f - beta1, 1.0f - beta2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  switch (grad_dtype) {
    case 0:
      return launch<float>(pf, mf, vf, g, (int64_t)n, s, st);
    case 1:
      return launch<__nv_bfloat16>(pf, mf, vf, g, (int64_t)n, s, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// grad_dtype: 0 = float32, 1 = bfloat16.  p/m float32 [n] and g [n], all
// contiguous on one device and 16-byte aligned; p and m are updated in place.
// The scalars are float32: lr, beta1, beta2, weight decay and 1 - beta1,
// 1 - beta2.  Returns a cudaError_t (0 = launched).
int fused_lion_launch(int grad_dtype, void* p, void* m, const void* g, long long n, float lr,
                      float beta1, float beta2, float weight_decay, float one_minus_beta1,
                      float one_minus_beta2, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const LionScalars s{lr, beta1, beta2, weight_decay, one_minus_beta1, one_minus_beta2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* mf = static_cast<float*>(m);
  switch (grad_dtype) {
    case 0:
      return launch_lion<float>(pf, mf, g, (int64_t)n, s, st);
    case 1:
      return launch_lion<__nv_bfloat16>(pf, mf, g, (int64_t)n, s, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
