// Flash attention forward and backward (FA2 style), for Hopper (sm_90a).
//
// Replaces, in deepspeed_tpu/ops/attention/flash.py:
//   _fwd_kernel       (forward: online softmax, out + fp32 logsumexp)
//   _bwd_dkdv_kernel  (dK, dV from the saved logsumexp)
//   _bwd_dq_kernel    (dQ from the saved logsumexp)
//
// Layouts are the model's: q/out/dq [B, Sq, H, D], k/v/dk/dv [B, Sk, KV, D],
// lse and delta [B, H, Sq] fp32.  GQA: q head h reads kv head h / (H / KV).
// Causal masking is on absolute positions with the queries at the end of the
// keys: query row r sees keys kpos <= r + (Sk - Sq).  Keys past Sk (the ragged
// last tile) are masked.  All arithmetic is fp32 on CUDA cores, whatever the
// storage type, as the Pallas kernel casts q/k/v to fp32 before its products.
//
//   forward:  s = scale * q.k ; m, l, acc carried over key tiles ; out = acc / l_safe
//             lse = m + log(l_safe), l_safe = (l == 0 ? 1 : l)
//   backward: p = exp(scale * q.k - lse) (0 where masked)
//             dv += p^T do ; dp = do v^T ; ds = p * (dp - delta) * scale
//             dk += ds^T q ; dq += ds k
//
// What bounds it on the H100: at the training shape (S = 2048, D = 128) each
// (query, key) pair costs 4 D operations forward and 8 D (dK/dV) or 6 D (dQ)
// backward against 2-4 bytes per element read once per tile, so the work is
// bound by arithmetic.  This first version keeps that arithmetic in fp32 on
// CUDA cores (67 TFLOP/s peak, against 989 TFLOP/s of bf16 tensor cores):
// tensor-core tiles (mma/wgmma) round P to bf16 and so change the math; they
// are a later redesign.  The design against the CUDA-core limit:
//   - tiles of 64 query rows x 64 keys, 256 threads; each thread owns a 4 x 4
//     block of the score tile (rows ty*4+i, keys tx+16j), so every shared
//     memory value it loads feeds four multiply-adds;
//   - the TPU grid's sequential k axis (scratch carried in VMEM) becomes a
//     loop inside the block; key tiles above the causal diagonal are never
//     visited, and the dK/dV kernel skips query tiles that cannot see its keys;
//   - the dK/dV kernel owns one kv head and walks every q head of its GQA
//     group, so the sum over the group (flash.py:280-281, an fp32 [B, H, Sk, D]
//     intermediate there) happens in registers;
//   - rows of shared tiles are padded to D + 1 floats so the 16 lanes that
//     read 16 different keys hit 16 different banks.
// No TMA, no asynchronous copies, no tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kTX = 16;        // threads across keys (or head-dim columns)
constexpr int kRows = 4;       // query rows (or keys) per thread: kTile / (kThreads / kTX)
constexpr int kKeys = 4;       // keys per thread: kTile / kTX
constexpr int kLdP = kTile + 1;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half(x); }

// max / sum over the 16 lanes that share a row (one half of a warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r][d] (row stride D + 1, fp32) = src row (row0 + r), for r < kTile; rows
// at or past nrows become zeros.  16-byte loads, consecutive threads on
// consecutive addresses of a row.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int nrows,
                                          int64_t stride) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int kLd = D + 1;
  for (int idx = threadIdx.x; idx < kTile * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int d0 = (idx % kVecPerRow) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      raw = __ldg(reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * stride + d0));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) dst[r * kLd + d0 + u] = to_float(e[u]);
  }
}

// lse/delta rows of one query tile into shared memory (0 past Sq)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const float* lse,
                                          const float* delta, int q0, int Sq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool live = q0 + r < Sq;
    lse_s[r] = live ? lse[q0 + r] : 0.f;
    delta_s[r] = live ? delta[q0 + r] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk, int offset,
                                        int causal) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos + offset);
}

// s[i][j] = a_tile[ty*4+i] . b_tile[tx+16j] over D (both row stride D + 1)
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[kRows][kKeys], const float* a,
                                         const float* b, int tx, int ty) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[kRows], bv[kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(ty * kRows + i) * kLd + d];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) bv[j] = b[(tx + kTX * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// ------------------------------------------------------------------ forward
// One block per (query tile, q head, batch).  Shared: q tile, one K-then-V
// tile, the probabilities of the current tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / kTX;  // head-dim columns of the accumulator per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // [kTile][kLd]
  float* kv_s = q_s + kTile * kLd; // [kTile][kLd]: K, then V of the same key tile
  float* p_s = kv_s + kTile * kLd; // [kTile][kLdP]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int offset = Sk - Sq;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  const T* qb = q + ((int64_t)b * Sq * H + h) * D;
  const T* kb = k + ((int64_t)b * Sk * KV + g) * D;
  const T* vb = v + ((int64_t)b * Sk * KV + g) * D;
  load_tile<T, D>(q_s, qb, q0, Sq, (int64_t)H * D);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // key tiles any row of this query tile may see (flash.py:51)
  const int k_end = causal ? min(Sk, q0 + kTile + offset) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers of kv_s / p_s are done
    load_tile<T, D>(kv_s, kb, k0, Sk, (int64_t)KV * D);
    __syncthreads();
    float s[kRows][kKeys];
    tile_dot<D>(s, q_s, kv_s, tx, ty);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const bool ok = visible(qpos, k0 + tx + kTX * j, Sq, Sk, offset, causal);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(rmax));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const bool ok = visible(qpos, k0 + tx + kTX * j, Sq, Sk, offset, causal);
        s[i][j] = ok ? expf(s[i][j] - m_new) : 0.f;
        psum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) p_s[(ty * kRows + i) * kLdP + tx + kTX * j] = s[i][j];
    }
    __syncthreads();  // every thread is done with K; P is complete
    load_tile<T, D>(kv_s, vb, k0, Sk, (int64_t)KV * D);
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty * kRows + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = kv_s[kk * kLd + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* o = out + (((int64_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + kTX * c] = from_float<T>(acc[i][c] / l_safe);
    if (tx == 0) lse[((int64_t)b * H + h) * Sq + row] = m[i] + logf(l_safe);
  }
}

// -------------------------------------------------------------- dK and dV
// One block per (key tile, kv head, batch); it walks the q heads of its group
// and the query tiles that can see its keys.  Thread roles: the score tiles
// as in the forward (rows ty*4+i, keys tx+16j); the dK/dV accumulators over
// keys ty*4+i and head-dim columns tx+16c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                      float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / kTX;
  extern __shared__ float smem[];
  float* k_s = smem;                   // [kTile][kLd]
  float* v_s = k_s + kTile * kLd;      // [kTile][kLd]
  float* q_s = v_s + kTile * kLd;      // [kTile][kLd]
  float* do_s = q_s + kTile * kLd;     // [kTile][kLd]
  float* p_s = do_s + kTile * kLd;     // [kTile][kLdP]
  float* ds_s = p_s + kTile * kLdP;    // [kTile][kLdP]
  float* lse_s = ds_s + kTile * kLdP;  // [kTile]
  float* delta_s = lse_s + kTile;      // [kTile]

  const int k0 = blockIdx.x * kTile;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;
  const int offset = Sk - Sq;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  load_tile<T, D>(k_s, k + ((int64_t)b * Sk * KV + g) * D, k0, Sk, (int64_t)KV * D);
  load_tile<T, D>(v_s, v + ((int64_t)b * Sk * KV + g) * D, k0, Sk, (int64_t)KV * D);

  float dk_acc[kRows][kCols], dv_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int h = g * group; h < (g + 1) * group; ++h) {
    const T* qb = q + ((int64_t)b * Sq * H + h) * D;
    const T* dob = dout + ((int64_t)b * Sq * H + h) * D;
    const float* lse_h = lse + ((int64_t)b * H + h) * Sq;
    const float* delta_h = delta + ((int64_t)b * H + h) * Sq;
    for (int q0 = 0; q0 < Sq; q0 += kTile) {
      if (causal && k0 > q0 + offset + kTile - 1) continue;  // no row sees these keys
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(q_s, qb, q0, Sq, (int64_t)H * D);
      load_tile<T, D>(do_s, dob, q0, Sq, (int64_t)H * D);
      load_rows(lse_s, delta_s, lse_h, delta_h, q0, Sq);
      __syncthreads();
      float s[kRows][kKeys], dp[kRows][kKeys];
      tile_dot<D>(s, q_s, k_s, tx, ty);
      tile_dot<D>(dp, do_s, v_s, tx, ty);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int key = tx + kTX * j;
          const bool ok = visible(q0 + r, k0 + key, Sq, Sk, offset, causal);
          const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          p_s[r * kLdP + key] = p;
          ds_s[r * kLdP + key] = p * (dp[i][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[kRows], dsv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = p_s[qq * kLdP + ty * kRows + i];
          dsv[i] = ds_s[qq * kLdP + ty * kRows + i];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float dov = do_s[qq * kLd + tx + kTX * c];
          const float qv = q_s[qq * kLd + tx + kTX * c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty * kRows + i;
    if (key >= Sk) continue;
    const int64_t at = (((int64_t)b * Sk + key) * KV + g) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[at + tx + kTX * c] = from_float<T>(dk_acc[i][c]);
      dv[at + tx + kTX * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

// --------------------------------------------------------------------- dQ
// One block per (query tile, q head, batch), looping over the key tiles the
// tile may see.  Thread roles as in the forward.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H,
                    int KV, float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / kTX;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kTile][kLd]
  float* do_s = q_s + kTile * kLd;     // [kTile][kLd]
  float* k_s = do_s + kTile * kLd;     // [kTile][kLd]
  float* v_s = k_s + kTile * kLd;      // [kTile][kLd]
  float* ds_s = v_s + kTile * kLd;     // [kTile][kLdP]
  float* lse_s = ds_s + kTile * kLdP;  // [kTile]
  float* delta_s = lse_s + kTile;      // [kTile]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int offset = Sk - Sq;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  load_tile<T, D>(q_s, q + ((int64_t)b * Sq * H + h) * D, q0, Sq, (int64_t)H * D);
  load_tile<T, D>(do_s, dout + ((int64_t)b * Sq * H + h) * D, q0, Sq, (int64_t)H * D);
  load_rows(lse_s, delta_s, lse + ((int64_t)b * H + h) * Sq,
            delta + ((int64_t)b * H + h) * Sq, q0, Sq);
  const T* kb = k + ((int64_t)b * Sk * KV + g) * D;
  const T* vb = v + ((int64_t)b * Sk * KV + g) * D;

  float dq_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq_acc[i][c] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kTile + offset) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(k_s, kb, k0, Sk, (int64_t)KV * D);
    load_tile<T, D>(v_s, vb, k0, Sk, (int64_t)KV * D);
    __syncthreads();
    float s[kRows][kKeys], dp[kRows][kKeys];
    tile_dot<D>(s, q_s, k_s, tx, ty);
    tile_dot<D>(dp, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = tx + kTX * j;
        const bool ok = visible(q0 + r, k0 + key, Sq, Sk, offset, causal);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * kLdP + key] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = ds_s[(ty * kRows + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = k_s[kk * kLd + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) dq_acc[i][c] = fmaf(dsv[i], kv, dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    T* o = dq + (((int64_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + kTX * c] = from_float<T>(dq_acc[i][c]);
  }
}

// ------------------------------------------------------------- launchers
int fwd_smem(int D) { return (2 * kTile * (D + 1) + kTile * kLdP) * (int)sizeof(float); }
int dkdv_smem(int D) {
  return (4 * kTile * (D + 1) + 2 * kTile * kLdP + 2 * kTile) * (int)sizeof(float);
}
int dq_smem(int D) {
  return (4 * kTile * (D + 1) + kTile * kLdP + 2 * kTile) * (int)sizeof(float);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* o0;  // out (forward), dk (dK/dV), dq (dQ)
  void* o1;  // lse (forward), dv (dK/dV)
  int B, Sq, Sk, H, KV;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_fwd(const Args& a) {
  const int smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kTile - 1) / kTile, a.H, a.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.Sq, a.Sk, a.H, a.KV, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const Args& a) {
  const int smem = dkdv_smem(D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + kTile - 1) / kTile, a.KV, a.B);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o0),
      static_cast<T*>(a.o1), a.Sq, a.Sk, a.H, a.KV, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const int smem = dq_smem(D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kTile - 1) / kTile, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o0), a.Sq, a.Sk,
      a.H, a.KV, a.scale, a.causal);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDkdv = 1, kDq = 2 };

template <typename T, int D>
cudaError_t launch_which(int which, const Args& a) {
  switch (which) {
    case kFwd:
      return launch_fwd<T, D>(a);
    case kDkdv:
      return launch_dkdv<T, D>(a);
    case kDq:
      return launch_dq<T, D>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dim(int which, int head_dim, const Args& a) {
  switch (head_dim) {
    case 64:
      return launch_which<T, 64>(which, a);
    case 128:
      return launch_which<T, 128>(which, a);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch(int which, int dtype, int head_dim, const Args& a) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.KV <= 0 || a.H % a.KV != 0)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_dim<float>(which, head_dim, a);
    case 1:
      return launch_dim<__nv_bfloat16>(which, head_dim, a);
    case 2:
      return launch_dim<__half>(which, head_dim, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; head_dim 64 or 128.  All
// tensors contiguous on one device, 16-byte aligned: q/out [B, Sq, H, D],
// k/v [B, Sk, KV, D], lse [B, H, Sq] float32.  Returns a cudaError_t
// (0 = launched).
int flash_fwd_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int Sq, int Sk, int H, int KV, int head_dim,
                     float scale, int causal, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, B, Sq, Sk, H, KV, scale, causal,
         static_cast<cudaStream_t>(stream)};
  return launch(kFwd, dtype, head_dim, a);
}

// dout [B, Sq, H, D] in q's dtype; lse and delta [B, H, Sq] float32;
// dk/dv [B, Sk, KV, D] in k's dtype (every element written).
int flash_bwd_dkdv_launch(int dtype, const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta, void* dk,
                          void* dv, int B, int Sq, int Sk, int H, int KV, int head_dim,
                          float scale, int causal, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dk, dv, B, Sq, Sk, H, KV, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(kDkdv, dtype, head_dim, a);
}

// dq [B, Sq, H, D] in q's dtype (every element written).
int flash_bwd_dq_launch(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta, void* dq, int B,
                        int Sq, int Sk, int H, int KV, int head_dim, float scale, int causal,
                        void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, B, Sq, Sk, H, KV, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(kDq, dtype, head_dim, a);
}

}  // extern "C"
