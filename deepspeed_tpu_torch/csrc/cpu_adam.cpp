// Host AdamW for offloaded optimizer states.
//
// A copy of the JAX package's deepspeed_tpu/csrc/cpu_adam/cpu_adam.cpp, with
// the same step function: it steps fp32 master params and Adam moments that
// live in host RAM while the GPU holds only the bf16 compute copy (ZeRO-Offload,
// the reference's DeepSpeedCPUAdam).  OpenMP threads split the elements; the
// inner loop is branch-free so that -O3 -march=native vectorizes it.  Built by
// ops/_build.py with g++ and bound through ctypes by ops/adam/cpu_adam.py.

#include <cmath>
#include <cstddef>

extern "C" {

// p/m/v updated in place; g may alias bf16-widened gradients already converted
// to fp32 by the caller. bias_correction: 1-based step, 0 disables.
void dstpu_adamw_step(float* p, float* m, float* v, const float* g, size_t n,
                      float lr, float beta1, float beta2, float eps,
                      float weight_decay, int step) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (step > 0) {
    bc1 = 1.0f - std::pow(beta1, static_cast<float>(step));
    bc2 = 1.0f - std::pow(beta2, static_cast<float>(step));
  }
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2 = 1.0f / bc2;
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < static_cast<long long>(n); ++i) {
    const float gi = g[i];
    const float mi = beta1 * m[i] + (1.0f - beta1) * gi;
    const float vi = beta2 * v[i] + (1.0f - beta2) * gi * gi;
    m[i] = mi;
    v[i] = vi;
    const float m_hat = mi * inv_bc1;
    const float v_hat = vi * inv_bc2;
    p[i] -= lr * (m_hat / (std::sqrt(v_hat) + eps) + weight_decay * p[i]);
  }
}

}  // extern "C"
