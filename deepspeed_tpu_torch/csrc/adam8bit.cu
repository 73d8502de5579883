// AdamW with blockwise int8 moments, in place, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/adam/adam8bit.py::_adamw8_kernel (the Pallas
// TPU kernel behind fused_adamw8bit_flat).
//
// State, per group of 1024 elements: the first moment m as signed abs-max
// int8 codes with one fp32 scale, the second moment in the sqrt domain
// (u = sqrt(v)) as int8 codes with one fp32 scale.  For every element i of a
// group (p fp32, g fp32 or bf16):
//   m = m8 * sm ; u = v8 * sv
//   m' = beta1 * m + (1 - beta1) * g
//   v' = beta2 * (u * u) + ((1 - beta2) * g) * g
//   p  = p - lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p)
// then, over the group, the abs-max requantisation of m' and of u' = sqrt(v'):
//   scale = absmax / 127 (1 when absmax is 0), code = clip(rint(x / scale), +-127)
// The scalars are float32 as the Pallas body reads them: 1 - beta is a float32
// subtraction and bc1/bc2 come from the caller in float32.  Every operation is
// an explicitly rounded IEEE intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn) in the Pallas body's order, so nothing is contracted into a
// fused multiply-add; rintf rounds half to even as jnp.round and torch.round
// do (roundf would round half away from zero).  The codes and scales then
// equal the plain PyTorch version's bit for bit.
//
// A tail group (n not a multiple of 1024) reads p and g as 0 past n, as the
// Pallas call's zero padding does, and writes p only below n; its int8 codes
// and scale cover the whole group.
//
// What bounds it on the H100: each element reads p (4 B), g (4 or 2 B) and two
// int8 codes and writes p and the two codes: 16 B with an fp32 grad, 14 with
// bf16, plus 16 B of scales a group, for about thirty operations, so it is
// bound by device memory (3.35 TB/s).  The design: one block of 256 threads
// per group, four elements a thread through one 16-byte p load (8-byte for a
// bf16 grad) and one 4-byte load of each code array; the group's two abs-max
// reductions run through warp shuffles and a shared array of eight partial
// maxima, so every value stays in registers between the read and the write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 1024;  // elements per quantisation group (adam8bit.py GROUP)
constexpr int kThreads = 256;
constexpr int kPer = kGroup / kThreads;  // 4 elements a thread
constexpr int kWarps = kThreads / 32;
constexpr float kQmax = 127.0f;

struct Scalars {
  float lr, beta1, beta2, eps, wd, bc1, bc2, one_minus_beta1, one_minus_beta2;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// four grad elements as floats (16- or 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* g, int64_t at) {
  return *reinterpret_cast<const float4*>(g + at);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* g, int64_t at) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g + at);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]), __bfloat162float(e[2]),
                     __bfloat162float(e[3]));
}

// the largest value over the block, every thread gets it
__device__ __forceinline__ float block_max(float v, float* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  float r = part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, part[w]);
  return r;
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -kQmax), kQmax);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw8bit_kernel(float* __restrict__ p, int8_t* __restrict__ m8, int8_t* __restrict__ v8,
                 float* __restrict__ sm, float* __restrict__ sv, const G* __restrict__ g,
                 int64_t n, Scalars s) {
  __shared__ float part_m[kWarps];
  __shared__ float part_u[kWarps];
  const int64_t group = blockIdx.x;
  const int64_t e0 = group * kGroup + (int64_t)threadIdx.x * kPer;  // first element of this thread

  float pv[kPer], gv[kPer];
  if (group * kGroup + kGroup <= n) {
    const float4 p4 = *reinterpret_cast<const float4*>(p + e0);
    const float4 g4 = load4(g, e0);
    pv[0] = p4.x, pv[1] = p4.y, pv[2] = p4.z, pv[3] = p4.w;
    gv[0] = g4.x, gv[1] = g4.y, gv[2] = g4.z, gv[3] = g4.w;
  } else {  // the tail group: zeros past n, as the Pallas call pads
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const bool in = e0 + u < n;
      pv[u] = in ? p[e0 + u] : 0.f;
      gv[u] = in ? to_float(g[e0 + u]) : 0.f;
    }
  }
  const char4 mc = *reinterpret_cast<const char4*>(m8 + e0);
  const char4 vc = *reinterpret_cast<const char4*>(v8 + e0);
  const float mq[kPer] = {(float)mc.x, (float)mc.y, (float)mc.z, (float)mc.w};
  const float uq[kPer] = {(float)vc.x, (float)vc.y, (float)vc.z, (float)vc.w};
  const float scale_m = sm[group], scale_v = sv[group];

  float m_new[kPer], u_new[kPer];
  float m_abs = 0.f, u_abs = 0.f;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const float m = __fmul_rn(mq[u], scale_m);
    const float uu = __fmul_rn(uq[u], scale_v);
    m_new[u] = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_minus_beta1, gv[u]));
    const float v_new = __fadd_rn(__fmul_rn(s.beta2, __fmul_rn(uu, uu)),
                                  __fmul_rn(__fmul_rn(s.one_minus_beta2, gv[u]), gv[u]));
    u_new[u] = __fsqrt_rn(v_new);
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, s.bc2)), s.eps);
    const float update = __fadd_rn(__fdiv_rn(__fdiv_rn(m_new[u], s.bc1), denom),
                                   __fmul_rn(s.wd, pv[u]));
    pv[u] = __fsub_rn(pv[u], __fmul_rn(s.lr, update));
    m_abs = fmaxf(m_abs, fabsf(m_new[u]));
    u_abs = fmaxf(u_abs, fabsf(u_new[u]));
  }
  // every thread has read sm/sv before the barrier inside block_max
  m_abs = block_max(m_abs, part_m);
  u_abs = block_max(u_abs, part_u);
  const float new_sm = m_abs == 0.f ? 1.f : __fdiv_rn(m_abs, kQmax);
  const float new_sv = u_abs == 0.f ? 1.f : __fdiv_rn(u_abs, kQmax);

  char4 mo, vo;
  mo.x = quantize(m_new[0], new_sm), mo.y = quantize(m_new[1], new_sm);
  mo.z = quantize(m_new[2], new_sm), mo.w = quantize(m_new[3], new_sm);
  vo.x = quantize(u_new[0], new_sv), vo.y = quantize(u_new[1], new_sv);
  vo.z = quantize(u_new[2], new_sv), vo.w = quantize(u_new[3], new_sv);
  *reinterpret_cast<char4*>(m8 + e0) = mo;
  *reinterpret_cast<char4*>(v8 + e0) = vo;
  if (group * kGroup + kGroup <= n) {
    *reinterpret_cast<float4*>(p + e0) = make_float4(pv[0], pv[1], pv[2], pv[3]);
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (e0 + u < n) p[e0 + u] = pv[u];
  }
  if (threadIdx.x == 0) {
    sm[group] = new_sm;
    sv[group] = new_sv;
  }
}

}  // namespace

extern "C" {

// grad_dtype: 0 = float32, 1 = bfloat16.  p float32 [n] and g [n]; m8/v8 int8
// [groups, 1024] and sm/sv float32 [groups, 1] with groups = ceil(n / 1024);
// all contiguous on one device and 16-byte aligned.  p, m8, v8, sm and sv are
// updated in place.  The scalars are float32: lr, beta1, beta2, eps, weight
// decay, the bias corrections bc1/bc2 and 1 - beta1, 1 - beta2.  Returns a
// cudaError_t (0 = launched).
int adamw8bit_launch(int grad_dtype, void* p, void* m8, void* v8, void* sm, void* sv,
                     const void* g, long long n, float lr, float beta1, float beta2, float eps,
                     float weight_decay, float bc1, float bc2, float one_minus_beta1,
                     float one_minus_beta2, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const Scalars s{lr, beta1, beta2, eps, weight_decay, bc1, bc2, one_minus_beta1,
                  one_minus_beta2};
  const int64_t groups = (n + kGroup - 1) / kGroup;
  if (groups > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  int8_t* m = static_cast<int8_t*>(m8);
  int8_t* v = static_cast<int8_t*>(v8);
  float* smf = static_cast<float*>(sm);
  float* svf = static_cast<float*>(sv);
  switch (grad_dtype) {
    case 0:
      adamw8bit_kernel<float><<<(unsigned)groups, kThreads, 0, st>>>(
          pf, m, v, smf, svf, static_cast<const float*>(g), (int64_t)n, s);
      break;
    case 1:
      adamw8bit_kernel<__nv_bfloat16><<<(unsigned)groups, kThreads, 0, st>>>(
          pf, m, v, smf, svf, static_cast<const __nv_bfloat16*>(g), (int64_t)n, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
