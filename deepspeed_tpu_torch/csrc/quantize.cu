// Per-group symmetric abs-max int8 quantization, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/quantizer/quantize.py::_quant_kernel (the Pallas
// TPU kernel behind quantize_int8).
//
// What it computes: a flat input x[n] (fp32, bf16 or fp16) is cut into
// G = ceil(n / g) groups of g elements, the last one read as zeros past n (the
// JAX function pads with zeros).  For each group, in fp32:
//   absmax = max |x|
//   scale  = absmax / 127, or 1 when absmax is 0
//   q      = clip(rint(x / scale), -127, 127)
// written as int8 codes q[G, g] and fp32 scales[G] (the caller views them as
// [G, 1]).  Both divisions are true IEEE divisions (__fdiv_rn, never a
// multiply by a reciprocal) and rintf rounds half to even as jnp.round and
// torch.round do (roundf would round half away from zero), so the codes and
// scales equal the plain PyTorch version's bit for bit.
//
// What bounds it on the H100: each element is read once (2 or 4 bytes) and
// its code written once (1 byte), plus 4 bytes of scale a group, for a handful
// of operations: device memory (3.35 TB/s) bounds it.  The design: one block
// per group (grid-stride over groups beyond the grid), each thread taking
// chunks of 16 bytes of input (8 bf16/fp16 or 4 fp32 elements) when the group
// size is a multiple of the chunk, and single elements otherwise.  The group's
// abs-max runs through warp shuffles and one shared partial a warp.  The first
// C chunks of each thread (C = 1, 2 or 4, as many as the group needs) stay in
// registers between the abs-max and the write, so a group of up to 8,192 bf16
// (4,096 fp32) elements is read from device memory once; C is a template
// parameter so that a block caches no more than its group needs and as many
// blocks as possible fit on an SM.  Any group size >= 1 and a tail group past
// n are served without a padded copy of x.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxCache = 4;  // chunks a thread keeps in registers, at most
constexpr float kQmax = 127.0f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -kQmax), kQmax);
  return static_cast<int8_t>(static_cast<int>(q));
}

// V consecutive elements of x starting at element e of the flat input, as
// floats; zeros past n.  A full chunk is one 16-byte load (4-byte for V == 1).
template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, int64_t e, int64_t n,
                                           float (&v)[V]) {
  if constexpr (V > 1) {
    if (e + V <= n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + e);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = to_float(t[i]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = e + i < n ? to_float(x[e + i]) : 0.f;
}

template <int V>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ q, const float (&v)[V],
                                            float scale) {
  if constexpr (V == 8) {
    char4 lo, hi;
    lo.x = quantize(v[0], scale), lo.y = quantize(v[1], scale);
    lo.z = quantize(v[2], scale), lo.w = quantize(v[3], scale);
    hi.x = quantize(v[4], scale), hi.y = quantize(v[5], scale);
    hi.z = quantize(v[6], scale), hi.w = quantize(v[7], scale);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(q) = raw;
  } else if constexpr (V == 4) {
    char4 c;
    c.x = quantize(v[0], scale), c.y = quantize(v[1], scale);
    c.z = quantize(v[2], scale), c.w = quantize(v[3], scale);
    *reinterpret_cast<char4*>(q) = c;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) q[i] = quantize(v[i], scale);
  }
}

// T: input element type; V: elements a chunk (16 / sizeof(T), or 1 when the
// group size is not a multiple of that); C: chunks a thread keeps in
// registers.  Group gi covers flat elements [gi * g, gi * g + g); chunk c of a
// group covers [c * V, c * V + V) of it.
template <typename T, int V, int C>
__global__ void __launch_bounds__(kMaxThreads)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                     int64_t n, int64_t g, int64_t groups) {
  __shared__ float part[kMaxThreads / 32];
  const int warps = blockDim.x / 32;
  const int64_t chunks = g / V;
  for (int64_t gi = blockIdx.x; gi < groups; gi += gridDim.x) {
    const int64_t base = gi * g;
    float cache[C][V];
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int64_t c = threadIdx.x + (int64_t)k * blockDim.x;
      if (c < chunks) {
        load_chunk<T, V>(x, base + c * V, n, cache[k]);
#pragma unroll
        for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(cache[k][i]));
      }
    }
    for (int64_t c = threadIdx.x + (int64_t)C * blockDim.x; c < chunks; c += blockDim.x) {
      float v[V];
      load_chunk<T, V>(x, base + c * V, n, v);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = amax;
    __syncthreads();
    amax = part[0];
    for (int w = 1; w < warps; ++w) amax = fmaxf(amax, part[w]);
    __syncthreads();  // every thread has read part[] before the next group writes it
    const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, kQmax);

#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int64_t c = threadIdx.x + (int64_t)k * blockDim.x;
      if (c < chunks) store_codes<V>(q + base + c * V, cache[k], scale);
    }
    for (int64_t c = threadIdx.x + (int64_t)C * blockDim.x; c < chunks; c += blockDim.x) {
      float v[V];
      load_chunk<T, V>(x, base + c * V, n, v);
      store_codes<V>(q + base + c * V, v, scale);
    }
    if (threadIdx.x == 0) scales[gi] = scale;
  }
}

template <typename T, int V>
void launch_cached(const T* x, int8_t* q, float* scales, int64_t n, int64_t g, int64_t groups,
                   int64_t chunks, int64_t threads, cudaStream_t stream) {
  const int64_t grid = groups < (1 << 30) ? groups : (1 << 30);
  const int64_t per_thread = (chunks + threads - 1) / threads;
  if (per_thread <= 1) {
    quantize_int8_kernel<T, V, 1><<<(unsigned)grid, (unsigned)threads, 0, stream>>>(
        x, q, scales, n, g, groups);
  } else if (per_thread <= 2) {
    quantize_int8_kernel<T, V, 2><<<(unsigned)grid, (unsigned)threads, 0, stream>>>(
        x, q, scales, n, g, groups);
  } else {
    quantize_int8_kernel<T, V, kMaxCache><<<(unsigned)grid, (unsigned)threads, 0, stream>>>(
        x, q, scales, n, g, groups);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* scales, int64_t n, int64_t g,
                   cudaStream_t stream) {
  const int64_t groups = (n + g - 1) / g;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = g % kVec == 0;
  const int64_t chunks = vec ? g / kVec : g;
  int64_t threads = (chunks + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  if (vec) {
    launch_cached<T, kVec>(xt, qt, st, n, g, groups, chunks, threads, stream);
  } else {
    launch_cached<T, 1>(xt, qt, st, n, g, groups, chunks, threads, stream);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  x [n] contiguous and
// 16-byte aligned; q int8 [ceil(n / g), g] and scales float32 [ceil(n / g)],
// contiguous, on the same device.  g >= 1 is the group size (the caller passes
// min(group_size, n)).  Returns a cudaError_t (0 = launched).
int quantize_int8_launch(int dtype, const void* x, void* q, void* scales, long long n,
                         long long g, void* stream) {
  if (n <= 0 || g <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, q, scales, (int64_t)n, (int64_t)g, st);
    case 1:
      return launch<__nv_bfloat16>(x, q, scales, (int64_t)n, (int64_t)g, st);
    case 2:
      return launch<__half>(x, q, scales, (int64_t)n, (int64_t)g, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
