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
// last tile) are masked.  The Pallas kernel casts q/k/v to fp32 before its
// products; the CUDA-core kernels below do the same, the tensor-core ones
// multiply the stored bf16/fp16 values with fp32 sums.
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
// bound by arithmetic.
//
// Two designs, chosen by the storage type (the wrapper in
// ops/attention/flash.py holds the rule; no fallback between them):
//
// CUDA cores, fp32 inputs (all three kernels).
// fp32 arithmetic throughout (67 TFLOP/s peak), so fp32 results differ from
// the plain versions only by the order of summation:
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
//
// Tensor cores, bf16 and fp16 inputs (all three kernels), fp32 accumulators
// (989 TFLOP/s dense peak for the type).  Scores, softmax statistics and dS
// stay fp32; P (and, backward, dS) is rounded to the input type as the A
// operand of the second product, as FlashAttention does.  Their limit against
// the fp32 plain version is FlashAttention's own test rule taken row by row
// (flash.py::tensor_core_limit): each row of out, dK, dV or dQ within twice the
// error of the plain version that rounds the same operands in that row, plus
// one ulp of the output type x the row's largest |ref| for the store; lse
// within 1e-4.
//   - forward, wgmma: a block of two warpgroups owns 128 query rows, 64 a
//     warpgroup; per 128-key tile S = Q K^T by wgmma.m64n128k16 with Q and K
//     read by descriptor from 128-byte-swizzled shared tiles, the online
//     softmax in registers with exp2 and the scale folded into log2(e), l
//     summing the fp32 P, and O += P V by wgmma.m64n64k16 with P from
//     registers and V read transposed from its shared tile; K/V tiles are
//     double-buffered by cp.async; query tiles are launched heaviest (last)
//     first;
//   - dK/dV, mma.sync.m16n8k16 with operands through ldmatrix: a block of 4
//     warps owns 64 keys, 16 a warp, and walks the q heads of its GQA group
//     and the 64-row query tiles that see its keys, Q/dO/lse/delta
//     double-buffered by cp.async; S^T = K Q^T and dP^T = V dO^T so each
//     warp's accumulators are rows of its keys, and P^T and dS^T feed
//     dV += P^T dO and dK += dS^T Q from registers; key tiles are launched in
//     order of their work, the heaviest (first, under a causal mask) first;
//     shared rows are padded to D + 8 elements so ldmatrix's eight 16-byte
//     rows hit distinct banks;
//   - dQ, mma.sync.m16n8k16 on the same pieces: a block of 4 warps owns 64
//     query rows of one q head, 16 a warp, with their Q and dO fragments in
//     registers, and walks the 64-key tiles those rows see, K/V
//     double-buffered by cp.async; S and dP come from mma, dS is formed in
//     fp32 registers and rounded to T straight into the A fragments of
//     dQ += dS K (no shared round trip); it stays a kernel of its own, as in
//     the JAX package, so dQ needs no atomics and is deterministic; query
//     tiles are launched heaviest (last) first;
//   - masked entries are zeroed explicitly (never by subtracting a -inf), on
//     the tiles that cross the diagonal or a ragged end.
// Still to come: wgmma for dK/dV, TMA loads under mbarriers, and warp
// specialisation.  Overlapping a tile's softmax with the previous tile's
// P V product (FlashAttention-3's order) was measured slower than this
// forward on the H100 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

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

// ------------------------------------------------------- tensor-core pieces
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTcFwdKeys = 128;      // forward: keys a tile
constexpr int kTcKeys = 64;          // dK/dV: keys a block; dQ: keys a tile
constexpr int kTcRows = 128;         // forward: query rows a block, 16 a warp
constexpr int kTcFwdThreads = 256;
constexpr int kTcQRows = 64;         // dK/dV: query rows a tile; dQ: query rows a block
constexpr int kTcBwdThreads = 128;   // dK/dV: 16 keys a warp; dQ: 16 query rows a warp

// rows x D of src (row row0 + r at src + (row0 + r) * stride) into dst (row
// stride D + 8) by cp.async; rows at or past nrows are zero-filled
template <typename T, int D, int kThreadCount>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, int row0, int nrows, int rows,
                                        int64_t stride) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreadCount) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool live = row0 + r < nrows;
    const T* s = live ? src + (int64_t)(row0 + r) * stride + c * 8 : src;
    cp_async16(smem_u32(dst + r * (D + 8) + c * 8), s, live);
  }
}

// ------------------------------------------------- wgmma forward pieces
// 128-byte swizzled tiles for wgmma: a tile of R rows x D columns is stored as
// D / 64 column blocks of R rows x 128 bytes; in a block, row r's 16-byte chunk
// c sits at chunk c ^ (r % 8).  Blocks start on 1024-byte boundaries, so this
// is the hardware's pattern (address bits 4-6 xor bits 7-9).
template <typename T, int D, int kThreadCount>
__device__ __forceinline__ void cp_tile_sw128(uint32_t dst, const T* src, int row0, int nrows,
                                              int rows, int64_t stride) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreadCount) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool live = row0 + r < nrows;
    const T* s = live ? src + (int64_t)(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) * 16), s, live);
  }
}

// shared-memory matrix descriptor, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator across the async product
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Operands of the wgmma asm below: accumulators d[i] .. d[i + 7], read and
// written, and the first 32 or 64 operand numbers, which name them.
#define WG_ACC8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_OPS32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_OPS64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 128 fp32, a warpgroup) = (acc ? d : 0) + A B, A 64 x 16 and B 16 x 128
// from shared memory, both K-major; TY is the PTX type of A and B
#define WG_SS_N128(TY)                                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                     \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"    \
               WG_OPS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                       \
               : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24), WG_ACC8(32), \
                 WG_ACC8(40), WG_ACC8(48), WG_ACC8(56)                          \
               : "l"(a), "l"(b), "r"(acc))

// d += A B, A 64 x 16 from registers (each warp's 16 rows as mma.m16n8k16's A
// fragment), B 16 x 64 from shared memory, MN-major (transposed)
#define WG_RS_N64(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"  \
               WG_OPS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"      \
               : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    WG_SS_N128("bf16");
  else
    WG_SS_N128("f16");
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    WG_RS_N64("bf16");
  else
    WG_RS_N64("f16");
}

// ------------------------------------------------------ tensor-core forward
// One block per (128 query rows, q head, batch): two warpgroups of 64 rows,
// warp w of a warpgroup on its rows 16w..16w+15, with the accumulator layout
// of mma.sync (rows lane/4 and lane/4 + 8, columns 2 (lane % 4) and + 1 of
// every 8).  Per 128-key tile: S = Q K^T by wgmma, Q and K from swizzled
// shared tiles; the online softmax in registers; O += P V by wgmma, P from
// registers, V read transposed from its shared tile.  K/V tiles are
// double-buffered by cp.async: the next tile loads while this one multiplies.
template <typename T, int D>
__global__ void __launch_bounds__(kTcFwdThreads, 1)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                    float scale_log2, int causal) {
  constexpr int kNB = D / 64;  // 64-column blocks of the head dim
  constexpr int kKD = D / 16;  // k16 steps over the head dim
  constexpr int kTileBytes = kTcFwdKeys * D * 2;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t q_s = (smem_u32(tc_smem) + 1023u) & ~1023u;  // kTcRows x D
  const uint32_t k_s = q_s + kTcRows * D * 2;                  // [2] kTcFwdKeys x D
  const uint32_t v_s = k_s + 2 * kTileBytes;                   // [2] kTcFwdKeys x D

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;  // heaviest query tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / KV);
  const int offset = Sk - Sq;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row_g = q0 + wg * 64;  // the warpgroup's first query row
  const int row_w = row_g + warp * 16;
  const int row[2] = {row_w + lane / 4, row_w + lane / 4 + 8};
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const T* qb = q + ((int64_t)b * Sq * H + h) * D;
  const T* kb = k + ((int64_t)b * Sk * KV + g) * D;
  const T* vb = v + ((int64_t)b * Sk * KV + g) * D;

  const int k_end = causal ? min(Sk, q0 + kTcRows + offset) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + kTcFwdKeys - 1) / kTcFwdKeys : 0;

  float o[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    cp_tile_sw128<T, D, kTcFwdThreads>(q_s, qb, q0, Sq, kTcRows, q_stride);
    cp_tile_sw128<T, D, kTcFwdThreads>(k_s, kb, 0, Sk, kTcFwdKeys, kv_stride);
    cp_tile_sw128<T, D, kTcFwdThreads>(v_s, vb, 0, Sk, kTcFwdKeys, kv_stride);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    fence_proxy_async();  // the copies are visible to wgmma's reads
    __syncthreads();      // tile t has landed; every warpgroup is done with tile t - 1
    if (t + 1 < n_tiles) {
      const uint32_t nb = ((t + 1) & 1) * kTileBytes;
      const int k1 = (t + 1) * kTcFwdKeys;
      cp_tile_sw128<T, D, kTcFwdThreads>(k_s + nb, kb, k1, Sk, kTcFwdKeys, kv_stride);
      cp_tile_sw128<T, D, kTcFwdThreads>(v_s + nb, vb, k1, Sk, kTcFwdKeys, kv_stride);
      cp_async_commit();
    }
    const int k0 = t * kTcFwdKeys;
    // no row of the warpgroup sees these keys
    if (row_g >= Sq || (causal && k0 > row_g + 63 + offset)) continue;
    const uint32_t kt = k_s + (t & 1) * kTileBytes;
    const uint32_t vt = v_s + (t & 1) * kTileBytes;

    float s[kTcFwdKeys / 2];
#pragma unroll
    for (int e = 0; e < kTcFwdKeys / 2; ++e) s[e] = 0.f;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      const uint32_t within = (kk % 4) * 32;
      wgmma_ss<T>(s, sw128_desc(q_s + (kk / 4) * kTcRows * 128 + wg * 64 * 128 + within, 16),
                  sw128_desc(kt + (kk / 4) * kTcFwdKeys * 128 + within, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(s);

    const bool edge =
        k0 + kTcFwdKeys > Sk || (causal && k0 + kTcFwdKeys - 1 > row_w + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kTcFwdKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
          if (!(key < Sk && (!causal || key <= row[e / 2] + offset))) x = kNegInf;
        }
        s[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTcFwdKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[4 * j + e] - m[e / 2]);
        if (edge) {  // zero masked entries explicitly: a row with no key yet has m = kNegInf
          const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
          if (!(key < Sk && (!causal || key <= row[e / 2] + offset))) p = 0.f;
        }
        s[4 * j + e] = p;
        psum[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[nb][e] *= corr[(e / 2) & 1];
    // P rounded to T: n8 blocks 2kk and 2kk + 1 make the A fragment of k16 step kk
    uint32_t pa[kTcFwdKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcFwdKeys / 16; ++kk) {
      pa[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_acc(o[nb]);
    wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int kk = 0; kk < kTcFwdKeys / 16; ++kk)
        wgmma_rs<T>(o[nb], pa[kk], sw128_desc(vt + nb * kTcFwdKeys * 128 + kk * 2048, 0));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_acc(o[nb]);
  }

  T* ob = out + ((int64_t)b * Sq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    if (row[i] >= Sq) continue;
    const float l_safe = li == 0.f ? 1.f : li;
    const float inv = 1.f / l_safe;
    T* orow = ob + (int64_t)row[i] * q_stride + (lane % 4) * 2;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + nb * 64 + j * 8) =
            pack2<T>(o[nb][4 * j + 2 * i] * inv, o[nb][4 * j + 2 * i + 1] * inv);
    if (lane % 4 == 0)
      lse[((int64_t)b * H + h) * Sq + row[i]] = li == 0.f ? kNegInf : m[i] * kLn2 + logf(l_safe);
  }
}

// -------------------------------------------------- tensor-core dK and dV
// One block per (64 keys, kv head, batch); warp w owns keys 16w..16w+15, so
// S^T and dP^T (keys x the tile's 64 query rows) and dK, dV (keys x D) are
// accumulated in that warp's registers.  Shared: K and V of the block, two
// Q, dO, lse and delta tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kTcBwdThreads)
flash_bwd_dkdv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                         float scale, float scale_log2, int causal) {
  constexpr int kLd = D + 8;
  constexpr int kKD = D / 16;
  constexpr int kND = D / 8;
  constexpr int kNQ = kTcQRows / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* k_s = reinterpret_cast<T*>(tc_smem);  // [kTcKeys][kLd]
  T* v_s = k_s + kTcKeys * kLd;             // [kTcKeys][kLd]
  T* q_s = v_s + kTcKeys * kLd;             // [2][kTcQRows][kLd]
  T* do_s = q_s + 2 * kTcQRows * kLd;       // [2][kTcQRows][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTcQRows * kLd);  // [2][kTcQRows]
  float* delta_s = lse_s + 2 * kTcQRows;                               // [2][kTcQRows]

  const int k0 = blockIdx.z * kTcKeys;  // key tile 0 is seen by the most query tiles: first
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int group = H / KV;
  const int offset = Sk - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int key_w = k0 + warp * 16;  // the warp's first key
  const int key[2] = {key_w + lane / 4, key_w + lane / 4 + 8};
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;

  // the query tiles that see a key of this block: q0 + kTcQRows - 1 + offset >= k0
  int qt0 = 0;
  if (causal) {
    const int first = k0 - offset - (kTcQRows - 1);
    qt0 = first > 0 ? (first + kTcQRows - 1) / kTcQRows : 0;
  }
  const int per_head = max(0, (Sq + kTcQRows - 1) / kTcQRows - qt0);
  const int n_it = group * per_head;  // (q head, query tile) pairs, head-major

  auto load_rows_tile = [&](int it, int buf) {
    const int h = g * group + it / per_head;
    const int q0 = (qt0 + it % per_head) * kTcQRows;
    const int64_t at = ((int64_t)b * Sq * H + h) * D;
    cp_tile<T, D, kTcBwdThreads>(q_s + buf * kTcQRows * kLd, q + at, q0, Sq, kTcQRows, q_stride);
    cp_tile<T, D, kTcBwdThreads>(do_s + buf * kTcQRows * kLd, dout + at, q0, Sq, kTcQRows,
                                 q_stride);
    const float* lse_h = lse + ((int64_t)b * H + h) * Sq;
    const float* delta_h = delta + ((int64_t)b * H + h) * Sq;
    for (int r = threadIdx.x; r < kTcQRows; r += kTcBwdThreads) {
      const bool live = q0 + r < Sq;
      cp_async4(smem_u32(lse_s + buf * kTcQRows + r), live ? lse_h + q0 + r : lse_h, live);
      cp_async4(smem_u32(delta_s + buf * kTcQRows + r), live ? delta_h + q0 + r : delta_h, live);
    }
  };

  float dk_acc[kND][4], dv_acc[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  if (n_it > 0) {
    cp_tile<T, D, kTcBwdThreads>(k_s, k + ((int64_t)b * Sk * KV + g) * D, k0, Sk, kTcKeys,
                                 kv_stride);
    cp_tile<T, D, kTcBwdThreads>(v_s, v + ((int64_t)b * Sk * KV + g) * D, k0, Sk, kTcKeys,
                                 kv_stride);
    load_rows_tile(0, 0);
    cp_async_commit();
  }
  const uint32_t ka = smem_u32(k_s);
  const uint32_t va = smem_u32(v_s);
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it + 1 < n_it) {
      load_rows_tile(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const int buf = it & 1;
    const int q0 = (qt0 + it % per_head) * kTcQRows;
    if (key_w >= Sk || (causal && key_w > q0 + kTcQRows - 1 + offset)) continue;  // none seen
    const uint32_t qt = smem_u32(q_s + buf * kTcQRows * kLd);
    const uint32_t dot = smem_u32(do_s + buf * kTcQRows * kLd);
    const float* lse_t = lse_s + buf * kTcQRows;
    const float* delta_t = delta_s + buf * kTcQRows;

    float st[kNQ][4], dpt[kNQ][4];  // S^T and dP^T: the warp's keys x the tile's rows
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, ka + a_frag<kLd>(lane, warp * 16, kk * 16));
      ldsm_x4(vf, va + a_frag<kLd>(lane, warp * 16, kk * 16));
#pragma unroll
      for (int np = 0; np < kNQ / 2; ++np) {
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, qt + b_frag<kLd>(lane, np * 16, kk * 16));
        ldsm_x4(bd, dot + b_frag<kLd>(lane, np * 16, kk * 16));
        mma16816<T>(st[2 * np], kf, bq[0], bq[1]);
        mma16816<T>(st[2 * np + 1], kf, bq[2], bq[3]);
        mma16816<T>(dpt[2 * np], vf, bd[0], bd[1]);
        mma16816<T>(dpt[2 * np + 1], vf, bd[2], bd[3]);
      }
    }

    // P^T = exp(scale s - lse), 0 where masked; dS^T = P^T (dP^T - delta) scale
    const bool edge = q0 + kTcQRows > Sq || key_w + 16 > Sk ||
                      (causal && key_w + 15 > q0 + offset);
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j * 8 + (lane % 4) * 2 + (e & 1);  // query row in the tile
        float p = exp2f(st[j][e] * scale_log2 - lse_t[r] * kLog2e);
        if (edge) {
          const int kp = key[e / 2];
          if (!(q0 + r < Sq && kp < Sk && (!causal || kp <= q0 + r + offset))) p = 0.f;
        }
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - delta_t[r]) * scale;
      }
    // dV += P^T dO and dK += dS^T Q over the tile's rows, P and dS rounded to T
#pragma unroll
    for (int kk = 0; kk < kNQ / 2; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a<T>(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a<T>(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < kND / 2; ++np) {
        uint32_t bd[4], bq[4];
        ldsm_x4_trans(bd, dot + bt_frag<kLd>(lane, kk * 16, np * 16));
        ldsm_x4_trans(bq, qt + bt_frag<kLd>(lane, kk * 16, np * 16));
        mma16816<T>(dv_acc[2 * np], pa, bd[0], bd[1]);
        mma16816<T>(dv_acc[2 * np + 1], pa, bd[2], bd[3]);
        mma16816<T>(dk_acc[2 * np], da, bq[0], bq[1]);
        mma16816<T>(dk_acc[2 * np + 1], da, bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Sk) continue;
    const int64_t at = (((int64_t)b * Sk + key[i]) * KV + g) * D + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < kND; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + j * 8) =
          pack2<T>(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + j * 8) =
          pack2<T>(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------ tensor-core dQ
// One block per (64 query rows, q head, batch); warp w owns rows 16w..16w+15,
// so dQ (rows x D) is accumulated in that warp's registers, and the warp's Q
// and dO A-fragments, loaded once, stay in registers with the lse and delta
// of the thread's two rows.  K and V tiles of 64 keys are double-buffered by
// cp.async.  Per tile, in two passes of 32 keys: S = Q K^T and dP = dO V^T
// (K and V as B operands, n-major); P = exp2(S scale log2e - lse log2e), zero
// where masked; dS = P (dP - delta) scale in fp32; dS rounded to T and
// repacked from the accumulator layout into A fragments; dQ += dS K with K
// through ldmatrix.trans.  Query tiles are launched heaviest (last) first.
template <typename T, int D>
__global__ void __launch_bounds__(kTcBwdThreads)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dq, int Sq, int Sk, int H, int KV, float scale,
                       float scale_log2, int causal) {
  constexpr int kLd = D + 8;
  constexpr int kKD = D / 16;
  constexpr int kND = D / 8;
  constexpr int kPass = 32;         // keys of one S / dP pass
  constexpr int kNP = kPass / 8;    // n8 tiles of a pass
  constexpr int kTileElems = kTcKeys * kLd;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* q_s = reinterpret_cast<T*>(tc_smem);  // [kTcQRows][kLd]
  T* do_s = q_s + kTcQRows * kLd;           // [kTcQRows][kLd]
  T* k_s = do_s + kTcQRows * kLd;           // [2][kTcKeys][kLd]
  T* v_s = k_s + 2 * kTileElems;            // [2][kTcKeys][kLd]

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcQRows;  // heaviest query tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / KV);
  const int offset = Sk - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_w = q0 + warp * 16;  // the warp's first query row
  const int row[2] = {row_w + lane / 4, row_w + lane / 4 + 8};
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const int64_t q_at = ((int64_t)b * Sq * H + h) * D;
  const T* kb = k + ((int64_t)b * Sk * KV + g) * D;
  const T* vb = v + ((int64_t)b * Sk * KV + g) * D;

  const int k_end = causal ? min(Sk, q0 + kTcQRows + offset) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + kTcKeys - 1) / kTcKeys : 0;

  float lse2[2], dlt[2];  // the rows' lse (in log2 units) and delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = row[i] < Sq;
    const int64_t at = ((int64_t)b * H + h) * Sq + row[i];
    lse2[i] = live ? lse[at] * kLog2e : 0.f;
    dlt[i] = live ? delta[at] : 0.f;
  }
  float acc[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  uint32_t qf[kKD][4], df[kKD][4];
  if (n_tiles > 0) {
    cp_tile<T, D, kTcBwdThreads>(q_s, q + q_at, q0, Sq, kTcQRows, q_stride);
    cp_tile<T, D, kTcBwdThreads>(do_s, dout + q_at, q0, Sq, kTcQRows, q_stride);
    cp_tile<T, D, kTcBwdThreads>(k_s, kb, 0, Sk, kTcKeys, kv_stride);
    cp_tile<T, D, kTcBwdThreads>(v_s, vb, 0, Sk, kTcKeys, kv_stride);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      ldsm_x4(qf[kk], smem_u32(q_s) + a_frag<kLd>(lane, warp * 16, kk * 16));
      ldsm_x4(df[kk], smem_u32(do_s) + a_frag<kLd>(lane, warp * 16, kk * 16));
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {
      const int nb = ((t + 1) & 1) * kTileElems;
      const int k1 = (t + 1) * kTcKeys;
      cp_tile<T, D, kTcBwdThreads>(k_s + nb, kb, k1, Sk, kTcKeys, kv_stride);
      cp_tile<T, D, kTcBwdThreads>(v_s + nb, vb, k1, Sk, kTcKeys, kv_stride);
      cp_async_commit();
    }
    const int k0 = t * kTcKeys;
    if (row_w >= Sq || (causal && k0 > row_w + 15 + offset)) continue;  // no row sees these keys
    const uint32_t kt = smem_u32(k_s + (t & 1) * kTileElems);
    const uint32_t vt = smem_u32(v_s + (t & 1) * kTileElems);
    const bool edge = k0 + kTcKeys > Sk || (causal && k0 + kTcKeys - 1 > row_w + offset);
#pragma unroll
    for (int pass = 0; pass < kTcKeys / kPass; ++pass) {
      const int n0 = pass * kPass;  // the pass's first key in the tile
      float s[kNP][4], dp[kNP][4];
#pragma unroll
      for (int j = 0; j < kNP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
#pragma unroll
        for (int np = 0; np < kNP / 2; ++np) {
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, kt + b_frag<kLd>(lane, n0 + np * 16, kk * 16));
          ldsm_x4(bv, vt + b_frag<kLd>(lane, n0 + np * 16, kk * 16));
          mma16816<T>(s[2 * np], qf[kk], bk[0], bk[1]);
          mma16816<T>(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          mma16816<T>(dp[2 * np], df[kk], bv[0], bv[1]);
          mma16816<T>(dp[2 * np + 1], df[kk], bv[2], bv[3]);
        }
      // P = exp(scale s - lse), 0 where masked; dS = P (dP - delta) scale, into s
#pragma unroll
      for (int j = 0; j < kNP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[j][e] * scale_log2 - lse2[e / 2]);
          if (edge) {
            const int key = k0 + n0 + j * 8 + (lane % 4) * 2 + (e & 1);
            if (!(key < Sk && (!causal || key <= row[e / 2] + offset))) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dlt[e / 2]) * scale;
        }
      // dQ += dS K over the pass's keys, dS rounded to T
#pragma unroll
      for (int kk = 0; kk < kNP / 2; ++kk) {
        uint32_t da[4];
        acc_to_a<T>(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < kND / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4_trans(bk, kt + bt_frag<kLd>(lane, n0 + kk * 16, np * 16));
          mma16816<T>(acc[2 * np], da, bk[0], bk[1]);
          mma16816<T>(acc[2 * np + 1], da, bk[2], bk[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    T* o = dq + q_at + (int64_t)row[i] * q_stride + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < kND; ++j)
      *reinterpret_cast<uint32_t*>(o + j * 8) = pack2<T>(acc[j][2 * i], acc[j][2 * i + 1]);
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

// tensor cores: the Q tile and two K/V tiles, swizzled, and 1 KB to align
// them (forward); K, V, two Q/dO tiles and two lse/delta rows, rows of D + 8
// (dK/dV); Q, dO and two K/V tiles, rows of D + 8 (dQ); elements of 2 bytes
int fwd_tc_smem(int D) { return 1024 + (kTcRows + 4 * kTcFwdKeys) * D * 2; }
int dkdv_tc_smem(int D) {
  return (2 * kTcKeys + 4 * kTcQRows) * (D + 8) * 2 + 4 * kTcQRows * (int)sizeof(float);
}
int dq_tc_smem(int D) { return (2 * kTcQRows + 4 * kTcKeys) * (D + 8) * 2; }

template <typename T, int D>
cudaError_t launch_fwd_tc(const Args& a) {
  const int smem = fwd_tc_smem(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, a.B, (a.Sq + kTcRows - 1) / kTcRows);
  flash_fwd_tc_kernel<T, D><<<grid, kTcFwdThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.Sq, a.Sk, a.H, a.KV,
      a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv_tc(const Args& a) {
  const int smem = dkdv_tc_smem(D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.KV, a.B, (a.Sk + kTcKeys - 1) / kTcKeys);
  flash_bwd_dkdv_tc_kernel<T, D><<<grid, kTcBwdThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o0),
      static_cast<T*>(a.o1), a.Sq, a.Sk, a.H, a.KV, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_tc(const Args& a) {
  const int smem = dq_tc_smem(D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, a.B, (a.Sq + kTcQRows - 1) / kTcQRows);
  flash_bwd_dq_tc_kernel<T, D><<<grid, kTcBwdThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o0), a.Sq, a.Sk,
      a.H, a.KV, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDkdv = 1, kDq = 2 };

// The kernels by type: fp32 on CUDA cores, bf16 and fp16 on tensor cores.
template <typename T, int D>
cudaError_t launch_which(int which, const Args& a) {
  if (which != kFwd && which != kDkdv && which != kDq) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value)
    return which == kFwd ? launch_fwd<T, D>(a)
                         : which == kDkdv ? launch_dkdv<T, D>(a) : launch_dq<T, D>(a);
  else
    return which == kFwd ? launch_fwd_tc<T, D>(a)
                         : which == kDkdv ? launch_dkdv_tc<T, D>(a) : launch_dq_tc<T, D>(a);
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
// (0 = launched).  float32 runs the CUDA-core kernels, bfloat16 and float16
// the tensor-core ones.
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
