// Block-sparse attention forward and backward (FA2 style), for Hopper (sm_90a).
//
// Replaces, in deepspeed_tpu/ops/sparse_attention/attention.py:
//   _fwd_kernel       (forward over the live key blocks of each query block:
//                      online softmax, out + fp32 logsumexp)
//   _bwd_dkdv_kernel  (dK, dV over the live query blocks of each key block)
//   _bwd_dq_kernel    (dQ over the live key blocks of each query block)
//
// Self-attention only: q/out/dq [B, S, H, D], k/v/dk/dv [B, S, KV, D], lse and
// delta [B, H, S] fp32; GQA: q head h reads kv head h / (H / KV).  The block
// layout is uint8 [H, NB, NB] (query block, key block) with NB * block >= S.
// An element (query qpos, key kpos) is live when its blocks' layout entry is
// set, kpos < S and, with causal, kpos <= qpos: the Pallas kernels' element
// masks (attention.py:99-103).  Masked scores are -1e30, a row with no live
// key has l == 0 -> l_safe = 1 (out 0, lse -1e30), lse = m + log(l_safe).  All
// arithmetic is fp32 on CUDA cores, whatever the storage type, as the Pallas
// kernels cast to fp32 before their products.
//
// The layout block is a unit of the layout, not of the tile: the config takes
// any multiple of 8, and a 64-row tile is the unit that keeps CUDA cores busy.
// So each kernel gathers rows by position lists built once per layout on the
// host (attention.py _Tables):
//   - the "owner" side (queries for the forward and dQ, keys for dK/dV) is cut
//     into tiles of 64 consecutive positions of the owner blocks taken in a
//     host-chosen order (q_order [H, NB], k_order [KV, NB]: blocks whose live
//     sets are alike sit together, so a tile's union stays small);
//   - for each owner tile, the "walked" side is the sorted union of the blocks
//     live for any block of the tile (k_walk [H, T, A] / k_cnt [H, T] for
//     queries, q_walk [H, T, At] / q_cnt [H, T] for keys), walked 64 positions
//     at a time whatever the block size; the layout lookup per element masks
//     the pairs that the union adds.
// Nothing is sized from the data at launch: T = ceil(NB * block / 64) and the
// table widths come with the tables.  With causal, the forward and dQ stop at
// the first key past the tile's last query, and dK/dV skips query chunks that
// end before the tile's first key (the Pallas kernels' block skip, :88-90).
// Query rows past S are masked (the Pallas backward pads lse and delta with 0,
// :275-276, which gives the same zero contributions).
//
// What bounds it on the H100: as flash, arithmetic: 4 D operations per live
// (query, key) pair forward, 8 D for dK/dV, 6 D for dQ, on CUDA cores here
// (67 TFLOP/s fp32 peak; tensor-core tiles round P to bf16, a later redesign).
// The design copies flash_attention.cu's: 256 threads, 4 x 4 score micro-tiles
// a thread, shared rows padded to D + 1 floats; the dK/dV block owns one kv
// head and walks every q head of its GQA group, so the group's sum stays in
// registers (attention.py:318-319 sums an fp32 [B, H, S, D] there).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // positions per tile, on both sides
constexpr int kThreads = 256;
constexpr int kTX = 16;        // threads across keys (or head-dim columns)
constexpr int kRows = 4;       // rows per thread: kTile / (kThreads / kTX)
constexpr int kKeys = 4;       // keys per thread: kTile / kTX
constexpr int kLdP = kTile + 1;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask value

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

// The position of flattened index f of a block list (each block `bs`
// positions long): list[f / bs] * bs + f % bs, or -1 when f is past the list's
// n blocks or the position is past S.
__device__ __forceinline__ int list_pos(const int* list, int n, int bs, int f, int S) {
  if (f >= n * bs) return -1;
  const int pos = list[f / bs] * bs + f % bs;
  return pos < S ? pos : -1;
}

// The same position without the S check (for the causal skips; -1 past the list)
__device__ __forceinline__ int raw_pos(const int* list, int n, int bs, int f) {
  return f < n * bs ? list[f / bs] * bs + f % bs : -1;
}

// Positions (and their blocks) of a 64-position tile of a block list into
// shared memory; threads 0..63 each write one.  Returns this thread's position.
__device__ __forceinline__ int fill_positions(int* pos_s, int* blk_s, const int* list, int n,
                                              int bs, int f0, int S) {
  int p = -1;
  if (threadIdx.x < kTile) {
    p = list_pos(list, n, bs, f0 + threadIdx.x, S);
    pos_s[threadIdx.x] = p;
    blk_s[threadIdx.x] = p >= 0 ? p / bs : 0;
  }
  return p;
}

// dst[r][d] (row stride D + 1, fp32) = src row pos_s[r], zeros where
// pos_s[r] < 0.  16-byte loads, consecutive threads on consecutive addresses
// of a row.
template <typename T, int D>
__device__ __forceinline__ void load_rows_at(float* dst, const T* src, const int* pos_s,
                                             int64_t stride) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int kLd = D + 1;
  for (int idx = threadIdx.x; idx < kTile * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int d0 = (idx % kVecPerRow) * kVec;
    const int pos = pos_s[r];
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (pos >= 0) raw = __ldg(reinterpret_cast<const uint4*>(src + (int64_t)pos * stride + d0));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) dst[r * kLd + d0 + u] = to_float(e[u]);
  }
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

// Bit i*4+j set when score (query row ty*4+i, key column tx+16j) is live: both
// positions valid, the blocks' layout entry set and, with causal, kpos <= qpos.
__device__ __forceinline__ unsigned live_bits(const int* qpos_s, const int* qblk_s,
                                              const int* kpos_s, const int* kblk_s,
                                              const unsigned char* lay, int NB, int causal,
                                              int tx, int ty) {
  unsigned bits = 0u;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    const int qp = qpos_s[r];
    if (qp < 0) continue;
    const unsigned char* row = lay + (int64_t)qblk_s[r] * NB;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int c = tx + kTX * j;
      const int kp = kpos_s[c];
      if (kp >= 0 && (!causal || kp <= qp) && row[kblk_s[c]]) bits |= 1u << (i * kKeys + j);
    }
  }
  return bits;
}

__device__ __forceinline__ bool bit(unsigned bits, int i, int j) {
  return (bits >> (i * kKeys + j)) & 1u;
}

struct Tables {
  const unsigned char* layout;  // [H, NB, NB]
  const int* order;             // [H, NB] query blocks (forward, dQ) or [KV, NB] key blocks (dK/dV)
  const int* walk;              // [H, T, width] sorted union of walked blocks per owner tile
  const int* cnt;               // [H, T]
  int NB, bs, width;
};

// ------------------------------------------------------------------ forward
// One block per (query tile, q head, batch).  Shared: the q tile, one K-then-V
// tile, the probabilities of the current tile, positions and blocks of both.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, float* __restrict__ lse, Tables tb, int S, int H, int KV,
                  float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / kTX;
  extern __shared__ float smem[];
  float* q_s = smem;                         // [kTile][kLd]
  float* kv_s = q_s + kTile * kLd;           // [kTile][kLd]: K, then V of the same keys
  float* p_s = kv_s + kTile * kLd;           // [kTile][kLdP]
  int* qpos_s = reinterpret_cast<int*>(p_s + kTile * kLdP);
  int* qblk_s = qpos_s + kTile;
  int* kpos_s = qblk_s + kTile;
  int* kblk_s = kpos_s + kTile;
  int* qmax_s = kblk_s + kTile;

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = gridDim.x;
  const int g = h / (H / KV);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int NB = tb.NB, bs = tb.bs;
  const int* walk = tb.walk + ((int64_t)h * n_tiles + t) * tb.width;
  const int n_walk = tb.cnt[h * n_tiles + t];
  const unsigned char* lay = tb.layout + (int64_t)h * NB * NB;

  if (threadIdx.x == 0) *qmax_s = -1;
  __syncthreads();
  const int p = fill_positions(qpos_s, qblk_s, tb.order + (int64_t)h * NB, NB, bs,
                               t * kTile, S);
  if (p >= 0) atomicMax(qmax_s, p);
  __syncthreads();
  const int qmax = *qmax_s;

  const T* kb = k + ((int64_t)b * S * KV + g) * D;
  const T* vb = v + ((int64_t)b * S * KV + g) * D;
  load_rows_at<T, D>(q_s, q + ((int64_t)b * S * H + h) * D, qpos_s, (int64_t)H * D);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int total = n_walk * bs;
  for (int f0 = 0; f0 < total; f0 += kTile) {
    // the walk is sorted: past the tile's last query no key is visible
    if (causal && raw_pos(walk, n_walk, bs, f0) > qmax) break;
    __syncthreads();  // the previous chunk's readers of kv_s / p_s / kpos_s are done
    fill_positions(kpos_s, kblk_s, walk, n_walk, bs, f0, S);
    __syncthreads();
    load_rows_at<T, D>(kv_s, kb, kpos_s, (int64_t)KV * D);
    __syncthreads();
    float s[kRows][kKeys];
    tile_dot<D>(s, q_s, kv_s, tx, ty);
    const unsigned bits = live_bits(qpos_s, qblk_s, kpos_s, kblk_s, lay, NB, causal, tx, ty);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = bit(bits, i, j) ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(rmax));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = bit(bits, i, j) ? expf(s[i][j] - m_new) : 0.f;
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
    load_rows_at<T, D>(kv_s, vb, kpos_s, (int64_t)KV * D);
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
    const int row = qpos_s[ty * kRows + i];
    if (row < 0) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* o = out + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + kTX * c] = from_float<T>(acc[i][c] / l_safe);
    if (tx == 0) lse[((int64_t)b * H + h) * S + row] = m[i] + logf(l_safe);
  }
}

// -------------------------------------------------------------- dK and dV
// One block per (key tile, kv head, batch); it walks the q heads of its group
// and, for each, the query positions live for any key block of its tile.
// Thread roles: the score tiles as in the forward (query rows ty*4+i, keys
// tx+16j); the dK/dV accumulators over keys ty*4+i and head-dim columns tx+16c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dk, T* __restrict__ dv, Tables tb, int S, int H, int KV,
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
  int* kpos_s = reinterpret_cast<int*>(delta_s + kTile);
  int* kblk_s = kpos_s + kTile;
  int* qpos_s = kblk_s + kTile;
  int* qblk_s = qpos_s + kTile;
  int* kmin_s = qblk_s + kTile;

  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = gridDim.x;
  const int group = H / KV;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int NB = tb.NB, bs = tb.bs;

  if (threadIdx.x == 0) *kmin_s = INT_MAX;
  __syncthreads();
  const int p = fill_positions(kpos_s, kblk_s, tb.order + (int64_t)g * NB, NB, bs, t * kTile,
                               S);
  if (p >= 0) atomicMin(kmin_s, p);
  __syncthreads();
  const int kmin = *kmin_s;
  load_rows_at<T, D>(k_s, k + ((int64_t)b * S * KV + g) * D, kpos_s, (int64_t)KV * D);
  load_rows_at<T, D>(v_s, v + ((int64_t)b * S * KV + g) * D, kpos_s, (int64_t)KV * D);

  float dk_acc[kRows][kCols], dv_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int h = g * group; h < (g + 1) * group; ++h) {
    const T* qb = q + ((int64_t)b * S * H + h) * D;
    const T* dob = dout + ((int64_t)b * S * H + h) * D;
    const float* lse_h = lse + ((int64_t)b * H + h) * S;
    const float* delta_h = delta + ((int64_t)b * H + h) * S;
    const int* walk = tb.walk + ((int64_t)h * n_tiles + t) * tb.width;
    const int n_walk = tb.cnt[h * n_tiles + t];
    const unsigned char* lay = tb.layout + (int64_t)h * NB * NB;
    const int total = n_walk * bs;
    for (int f0 = 0; f0 < total; f0 += kTile) {
      // the walk is sorted: a chunk that ends before the tile's first key sees none
      if (causal && raw_pos(walk, n_walk, bs, min(f0 + kTile, total) - 1) < kmin) continue;
      __syncthreads();  // the previous chunk's readers are done
      const int qp = fill_positions(qpos_s, qblk_s, walk, n_walk, bs, f0, S);
      if (threadIdx.x < kTile) {
        lse_s[threadIdx.x] = qp >= 0 ? lse_h[qp] : 0.f;
        delta_s[threadIdx.x] = qp >= 0 ? delta_h[qp] : 0.f;
      }
      __syncthreads();
      load_rows_at<T, D>(q_s, qb, qpos_s, (int64_t)H * D);
      load_rows_at<T, D>(do_s, dob, qpos_s, (int64_t)H * D);
      __syncthreads();
      float s[kRows][kKeys], dp[kRows][kKeys];
      tile_dot<D>(s, q_s, k_s, tx, ty);
      tile_dot<D>(dp, do_s, v_s, tx, ty);
      const unsigned bits = live_bits(qpos_s, qblk_s, kpos_s, kblk_s, lay, NB, causal, tx, ty);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int key = tx + kTX * j;
          const float pr = bit(bits, i, j) ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          p_s[r * kLdP + key] = pr;
          ds_s[r * kLdP + key] = pr * (dp[i][j] - delta_s[r]) * scale;
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
    const int key = kpos_s[ty * kRows + i];
    if (key < 0) continue;
    const int64_t at = (((int64_t)b * S + key) * KV + g) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[at + tx + kTX * c] = from_float<T>(dk_acc[i][c]);
      dv[at + tx + kTX * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

// --------------------------------------------------------------------- dQ
// One block per (query tile, q head, batch), walking the keys live for its
// query blocks.  Thread roles as in the forward.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, Tables tb, int S,
                     int H, int KV, float scale, int causal) {
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
  int* qpos_s = reinterpret_cast<int*>(delta_s + kTile);
  int* qblk_s = qpos_s + kTile;
  int* kpos_s = qblk_s + kTile;
  int* kblk_s = kpos_s + kTile;
  int* qmax_s = kblk_s + kTile;

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = gridDim.x;
  const int g = h / (H / KV);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int NB = tb.NB, bs = tb.bs;
  const int* walk = tb.walk + ((int64_t)h * n_tiles + t) * tb.width;
  const int n_walk = tb.cnt[h * n_tiles + t];
  const unsigned char* lay = tb.layout + (int64_t)h * NB * NB;

  if (threadIdx.x == 0) *qmax_s = -1;
  __syncthreads();
  const int p = fill_positions(qpos_s, qblk_s, tb.order + (int64_t)h * NB, NB, bs, t * kTile,
                               S);
  if (threadIdx.x < kTile) {
    lse_s[threadIdx.x] = p >= 0 ? lse[((int64_t)b * H + h) * S + p] : 0.f;
    delta_s[threadIdx.x] = p >= 0 ? delta[((int64_t)b * H + h) * S + p] : 0.f;
  }
  if (p >= 0) atomicMax(qmax_s, p);
  __syncthreads();
  const int qmax = *qmax_s;
  load_rows_at<T, D>(q_s, q + ((int64_t)b * S * H + h) * D, qpos_s, (int64_t)H * D);
  load_rows_at<T, D>(do_s, dout + ((int64_t)b * S * H + h) * D, qpos_s, (int64_t)H * D);
  const T* kb = k + ((int64_t)b * S * KV + g) * D;
  const T* vb = v + ((int64_t)b * S * KV + g) * D;

  float dq_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq_acc[i][c] = 0.f;

  const int total = n_walk * bs;
  for (int f0 = 0; f0 < total; f0 += kTile) {
    if (causal && raw_pos(walk, n_walk, bs, f0) > qmax) break;
    __syncthreads();
    fill_positions(kpos_s, kblk_s, walk, n_walk, bs, f0, S);
    __syncthreads();
    load_rows_at<T, D>(k_s, kb, kpos_s, (int64_t)KV * D);
    load_rows_at<T, D>(v_s, vb, kpos_s, (int64_t)KV * D);
    __syncthreads();
    float s[kRows][kKeys], dp[kRows][kKeys];
    tile_dot<D>(s, q_s, k_s, tx, ty);
    tile_dot<D>(dp, do_s, v_s, tx, ty);
    const unsigned bits = live_bits(qpos_s, qblk_s, kpos_s, kblk_s, lay, NB, causal, tx, ty);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float pr = bit(bits, i, j) ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * kLdP + tx + kTX * j] = pr * (dp[i][j] - delta_s[r]) * scale;
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
    const int row = qpos_s[ty * kRows + i];
    if (row < 0) continue;
    T* o = dq + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + kTX * c] = from_float<T>(dq_acc[i][c]);
  }
}

// ------------------------------------------------------------- launchers
constexpr int kPosInts = 4 * kTile + 1;  // positions and blocks of both sides, one scalar
int fwd_smem(int D) {
  return (2 * kTile * (D + 1) + kTile * kLdP + kPosInts) * (int)sizeof(float);
}
int dkdv_smem(int D) {
  return (4 * kTile * (D + 1) + 2 * kTile * kLdP + 2 * kTile + kPosInts) * (int)sizeof(float);
}
int dq_smem(int D) {
  return (4 * kTile * (D + 1) + kTile * kLdP + 2 * kTile + kPosInts) * (int)sizeof(float);
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
  Tables tb;
  int B, S, H, KV;
  float scale;
  int causal;
  cudaStream_t stream;
};

int n_tiles(const Args& a) { return (a.tb.NB * a.tb.bs + kTile - 1) / kTile; }

template <typename T, int D>
cudaError_t launch_fwd(const Args& a) {
  const int smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(sparse_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles(a), a.H, a.B);
  sparse_fwd_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.tb, a.S, a.H, a.KV, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const Args& a) {
  const int smem = dkdv_smem(D);
  cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dkdv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles(a), a.KV, a.B);
  sparse_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o0),
      static_cast<T*>(a.o1), a.tb, a.S, a.H, a.KV, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const int smem = dq_smem(D);
  cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles(a), a.H, a.B);
  sparse_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o0), a.tb, a.S, a.H,
      a.KV, a.scale, a.causal);
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
  if (a.B <= 0 || a.S <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.tb.NB <= 0 || a.tb.bs <= 0 ||
      a.tb.width <= 0 || (int64_t)a.tb.NB * a.tb.bs < a.S)
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

Tables tables(const void* layout, const void* order, const void* walk, const void* cnt, int NB,
              int block, int width) {
  return Tables{static_cast<const unsigned char*>(layout), static_cast<const int*>(order),
                static_cast<const int*>(walk), static_cast<const int*>(cnt), NB, block, width};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; head_dim 64 or 128.  q/out
// [B, S, H, D], k/v [B, S, KV, D], lse [B, H, S] float32, all contiguous on one
// device and 16-byte aligned.  Tables (int32 unless said): layout uint8
// [H, NB, NB], q_order [H, NB], k_walk [H, T, walk_width], k_cnt [H, T] with
// T = ceil(NB * block / 64).  Returns a cudaError_t (0 = launched).
int sparse_fwd_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                      void* lse, const void* layout, const void* q_order, const void* k_walk,
                      const void* k_cnt, int B, int S, int H, int KV, int head_dim, int NB,
                      int block, int walk_width, float scale, int causal, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, lse,
         tables(layout, q_order, k_walk, k_cnt, NB, block, walk_width),
         B, S, H, KV, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(kFwd, dtype, head_dim, a);
}

// dout [B, S, H, D] in q's dtype; lse and delta [B, H, S] float32; dk/dv
// [B, S, KV, D] in k's dtype (every element written).  Tables: layout,
// k_order [KV, NB], q_walk [H, T, walk_width], q_cnt [H, T].
int sparse_bwd_dkdv_launch(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dk,
                           void* dv, const void* layout, const void* k_order, const void* q_walk,
                           const void* q_cnt, int B, int S, int H, int KV, int head_dim, int NB,
                           int block, int walk_width, float scale, int causal, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dk, dv, tables(layout, k_order, q_walk, q_cnt, NB, block, walk_width),
         B, S, H, KV, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(kDkdv, dtype, head_dim, a);
}

// dq [B, S, H, D] in q's dtype (every element written).  Tables as the forward's.
int sparse_bwd_dq_launch(int dtype, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dq,
                         const void* layout, const void* q_order, const void* k_walk,
                         const void* k_cnt, int B, int S, int H, int KV, int head_dim, int NB,
                         int block, int walk_width, float scale, int causal, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, tables(layout, q_order, k_walk, k_cnt, NB, block, walk_width),
         B, S, H, KV, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(kDq, dtype, head_dim, a);
}

}  // extern "C"
