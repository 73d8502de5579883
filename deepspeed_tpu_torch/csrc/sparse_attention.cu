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
// (query, key) pair forward, 8 D for dK/dV, 6 D for dQ.
//
// Two designs for each of the three, chosen by the storage type (the wrapper
// in ops/sparse_attention/attention.py holds the rule,
// flash.uses_tensor_cores; no fallback between them).
//
// CUDA cores (fp32: the forward, dK/dV and dQ): fp32
// arithmetic (67 TFLOP/s peak), so results differ from the plain versions
// only by the order of summation.  The design copies flash_attention.cu's:
// 256 threads, 4 x 4 score micro-tiles a thread, shared rows padded to D + 1
// floats; the dK/dV block owns one kv head and walks every q head of its GQA
// group, so the group's sum stays in registers (attention.py:318-319 sums an
// fp32 [B, H, S, D] there).
//
// Tensor cores (bf16 and fp16; sparse_fwd_tc_kernel replaces _fwd_kernel,
// sparse_bwd_dkdv_tc_kernel _bwd_dkdv_kernel, sparse_bwd_dq_tc_kernel
// _bwd_dq_kernel): mma.sync.m16n8k16 with fp32 accumulators (989 TFLOP/s
// dense peak for the type), built as flash_attention.cu's tensor-core
// kernels from mma_tiles.cuh.  The 4 D, 8 D and 6 D operations a live pair
// run on the tensor cores; what the design does about the layout:
//   - the same host tables and 64-position tiles as the CUDA-core kernels:
//     rows are gathered by position with cp.async, 16 bytes a lane, into
//     shared tiles of the storage type (rows of D + 8 elements, never widened);
//     a row at position -1 is zero-filled from a valid address;
//   - the walked chunk c + 1 (rows, lse and delta, positions, masks) is
//     copied while chunk c computes: two buffers, about 106 KB at D = 128, so
//     two blocks fit on an SM;
//   - masks per element, the rule of live_bits: with each walked row the
//     loader stores a bit mask over the owner tile's layout blocks (at most
//     kMaxOwn), read from the [NB, NB] layout once a row and chunk; a lane
//     then tests its owner row's bit, the key < S and, with causal, key <=
//     query, and a warp whose 16 x 64 sub-tile is masked whole skips it;
//   - P and dS are rounded to the input type before P V, P^T dO, dS^T Q and
//     dS K, as flash's tensor-core kernels (held to flash.tensor_core_limit);
//   - forward: a block owns a 64-query tile of q_order with its Q fragments
//     in registers, walks the 64-key chunks of k_walk up to the tile's last
//     query with an online softmax in fp32 registers (exp2), P rounded
//     straight into the A fragments of O += P V; lse from the unrounded l;
//   - dK/dV: a block of 4 warps owns a 64-key tile of k_order, 16 keys a
//     warp, walks the q heads of its GQA group (the group's sum stays in
//     registers) and, per head, the chunks of q_walk from the first that
//     reaches the tile's first key (the causal skip); S^T and dP^T stay in
//     registers and feed the second products through acc_to_a;
//   - dQ: a block owns a 64-query tile of q_order with its Q and dO
//     fragments in registers, walks k_walk up to the tile's last query, in
//     two passes of 32 keys a chunk, and feeds dS straight into the A operand
//     of dS K;
//   - longest walks first: the block at blockIdx.z takes tile
//     tile_order[head][blockIdx.z] (the forward and dQ share q_tile_order),
//     a permutation built with the tables that sorts the tiles by walk
//     length, longest first, so the long walks of the global key blocks
//     start in the first wave instead of making a tail.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

constexpr int kTile = 64;      // positions per tile, on both sides
constexpr int kThreads = 256;
constexpr int kTX = 16;        // threads across keys (or head-dim columns)
constexpr int kRows = 4;       // rows per thread: kTile / (kThreads / kTX)
constexpr int kKeys = 4;       // keys per thread: kTile / kTX
constexpr int kLdP = kTile + 1;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask value
constexpr float kLn2 = 0.6931471805599453f;

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

// ------------------------------------------------- tensor-core pieces
constexpr int kTcThreads = 128;          // 4 warps, 16 owner rows each
constexpr int kMaxOwn = kTile / 8 + 1;   // layout blocks a 64-position tile can touch (block >= 8)
constexpr unsigned kNoBit = 31;          // an owner-block index whose mask bit is never set

// cp.async of the 64 gathered rows of two tiles that share positions: row r of
// dst0 / dst1 from src0 / src1 + row_pos(r) * stride, zero-filled (from the
// valid base address) where row_pos(r) < 0.  Rows of D + 8 elements.
template <typename T, int D, typename RowPos>
__device__ __forceinline__ void cp_rows_pair(T* dst0, const T* src0, T* dst1, const T* src1,
                                             int64_t stride, RowPos row_pos) {
  constexpr int kChunks = D / 8;
  static_assert(kTcThreads % kChunks == 0, "a thread copies one column chunk of its rows");
  const int c = threadIdx.x % kChunks;
#pragma unroll
  for (int r = threadIdx.x / kChunks; r < kTile; r += kTcThreads / kChunks) {
    const int pos = row_pos(r);
    const bool live = pos >= 0;
    const int64_t off = live ? (int64_t)pos * stride + c * 8 : 0;
    cp_async16(smem_u32(dst0 + r * (D + 8) + c * 8), src0 + off, live);
    cp_async16(smem_u32(dst1 + r * (D + 8) + c * 8), src1 + off, live);
  }
}

// cp.async of 64 gathered rows of one tile (as cp_rows_pair, one source)
template <typename T, int D, typename RowPos>
__device__ __forceinline__ void cp_rows(T* dst, const T* src, int64_t stride, RowPos row_pos) {
  constexpr int kChunks = D / 8;
  const int c = threadIdx.x % kChunks;
#pragma unroll
  for (int r = threadIdx.x / kChunks; r < kTile; r += kTcThreads / kChunks) {
    const int pos = row_pos(r);
    const bool live = pos >= 0;
    const int64_t off = live ? (int64_t)pos * stride + c * 8 : 0;
    cp_async16(smem_u32(dst + r * (D + 8) + c * 8), src + off, live);
  }
}

// The owner tile's layout blocks (at most kMaxOwn: entries own0.. of the
// owner order) into own_s; the tile's positions into pos_s.  Threads 0..63.
__device__ __forceinline__ int stage_owner(int* pos_s, int* own_s, const int* order, int NB,
                                           int bs, int f_own, int S) {
  const int own0 = f_own / bs;
  if (threadIdx.x < kMaxOwn)
    own_s[threadIdx.x] = own0 + (int)threadIdx.x < NB ? order[own0 + threadIdx.x] : 0;
  int p = -1;
  if (threadIdx.x < kTile) {
    p = list_pos(order, NB, bs, f_own + threadIdx.x, S);
    pos_s[threadIdx.x] = p;
  }
  return p;
}

// ------------------------------------------------------ tensor-core forward
// One block per (64-query tile, q head, batch), the tile taken in launch
// order (q_tile_order, as dQ); warp w owns rows 16w..16w+15 of the tile, so
// O (rows x D) is accumulated in its registers, with the warp's Q
// A-fragments loaded once.  Walked 64-key chunks (K, V, key positions and
// mask bits) are double-buffered by cp.async; with causal the walk stops at
// the first chunk past the tile's last query.  Per chunk: S = Q K^T; the
// element mask (layout bit, key < S, causal); the online softmax in fp32
// with exp2 and the scale folded into log2 e; P rounded to T into A
// fragments for O += P V (V through ldmatrix.trans), l summing the fp32 P.
// Rows with no live key give out 0 and lse -1e30; rows past S are not
// written.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
sparse_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, Tables tb,
                     const int* __restrict__ tile_order, int S, int H, int KV, float scale_log2,
                     int causal) {
  constexpr int kLd = D + 8;
  constexpr int kKD = D / 16;
  constexpr int kND = D / 8;
  constexpr int kNK = kTile / 8;  // n8 tiles of a chunk's 64 keys
  constexpr int kElems = kTile * kLd;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* q_s = reinterpret_cast<T*>(tc_smem);   // [kTile][kLd]
  T* k_s = q_s + kElems;                     // [2][kTile][kLd]
  T* v_s = k_s + 2 * kElems;                 // [2][kTile][kLd]
  int* kpos_s = reinterpret_cast<int*>(v_s + 2 * kElems);        // [2][kTile]
  unsigned* kbits_s = reinterpret_cast<unsigned*>(kpos_s + 2 * kTile);  // [2][kTile]
  int* qpos_s = reinterpret_cast<int*>(kbits_s + 2 * kTile);     // [kTile]
  int* own_s = qpos_s + kTile;                                   // [kMaxOwn]
  int* qmax_s = own_s + kMaxOwn;

  const int n_tiles = gridDim.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t = tile_order[h * n_tiles + blockIdx.z];
  const int g = h / (H / KV);
  const int NB = tb.NB, bs = tb.bs;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f_own = t * kTile;
  const int* walk = tb.walk + ((int64_t)h * n_tiles + t) * tb.width;
  const int n_walk = tb.cnt[h * n_tiles + t];
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const int64_t q_at = ((int64_t)b * S * H + h) * D;
  const T* kb = k + ((int64_t)b * S * KV + g) * D;
  const T* vb = v + ((int64_t)b * S * KV + g) * D;

  if (threadIdx.x == 0) *qmax_s = -1;
  __syncthreads();
  const int p = stage_owner(qpos_s, own_s, tb.order + (int64_t)h * NB, NB, bs, f_own, S);
  if (p >= 0) atomicMax(qmax_s, p);
  __syncthreads();
  const int qmax = *qmax_s;
  if (qmax < 0) return;  // the tile lies past S: no row to write

  // chunks [0, n_chunks) of the walk; under causal the walk is sorted, so it
  // stops at the first chunk that starts past the tile's last query
  int n_chunks = (n_walk * bs + kTile - 1) / kTile;
  if (causal) {
    int upto = 0;  // walked blocks that start at or before qmax
    for (int e0 = 0; e0 < n_walk; e0 += kTcThreads) {
      const int e = e0 + threadIdx.x;
      upto += __syncthreads_count(e < n_walk && walk[e] * bs <= qmax);
    }
    const int seen = upto > 0 ? (upto - 1) * bs + min(bs, qmax - walk[upto - 1] * bs + 1) : 0;
    n_chunks = (seen + kTile - 1) / kTile;
  }

  // the lane's two rows: position and owner-block index (kNoBit past S)
  int qpos[2];
  unsigned qloc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
    qpos[i] = qpos_s[r];
    qloc[i] = qpos[i] >= 0 ? (unsigned)((f_own + r) / bs - f_own / bs) : kNoBit;
  }

  auto load_chunk = [&](int c, int buf) {
    const int f0 = c * kTile;
    cp_rows_pair<T, D>(k_s + buf * kElems, kb, v_s + buf * kElems, vb, kv_stride,
                       [&](int r) { return list_pos(walk, n_walk, bs, f0 + r, S); });
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const int kp = list_pos(walk, n_walk, bs, f0 + r, S);
      unsigned bits = 0u;  // bit l: layout[h][own_s[l]][block of kp]
      if (kp >= 0) {
        const unsigned char* col = tb.layout + (int64_t)h * NB * NB + kp / bs;
#pragma unroll
        for (int l = 0; l < kMaxOwn; ++l) bits |= col[(int64_t)own_s[l] * NB] ? 1u << l : 0u;
      }
      kpos_s[buf * kTile + r] = kp;
      kbits_s[buf * kTile + r] = bits;
    }
  };

  float o[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  uint32_t qf[kKD][4];
  if (n_chunks > 0) {
    cp_rows<T, D>(q_s, q + q_at, q_stride, [&](int r) { return qpos_s[r]; });
    load_chunk(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk)
      ldsm_x4(qf[kk], smem_u32(q_s) + a_frag<kLd>(lane, warp * 16, kk * 16));
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c + 1 < n_chunks) {
      load_chunk(c + 1, buf ^ 1);
      cp_async_commit();
    }
    const int* kp_t = kpos_s + buf * kTile;
    const unsigned* kb_t = kbits_s + buf * kTile;
    // bit j*4 + e: accumulator element e of the chunk's n8 tile j is live
    uint32_t live = 0u;
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = j * 8 + (lane % 4) * 2 + cc;
        const int kp = kp_t[col];
        const unsigned kbits = kb_t[col];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (((kbits >> qloc[i]) & 1u) && (!causal || kp <= qpos[i]))
            live |= 1u << (j * 4 + 2 * i + cc);
      }
    if (!__any_sync(0xffffffffu, live != 0u)) continue;  // masked whole for the warp
    const uint32_t kt = smem_u32(k_s + buf * kElems);
    const uint32_t vt = smem_u32(v_s + buf * kElems);

    float s[kNK][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk)
#pragma unroll
      for (int np = 0; np < kNK / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + b_frag<kLd>(lane, np * 16, kk * 16));
        mma16816<T>(s[2 * np], qf[kk], bk[0], bk[1]);
        mma16816<T>(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (live >> (j * 4 + e)) & 1u ? s[j][e] * scale_log2 : kNegInf;
        s[j][e] = x;
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
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked entries are zeroed explicitly: a row with no key yet has m = kNegInf
        const float pr = (live >> (j * 4 + e)) & 1u ? exp2f(s[j][e] - m[e / 2]) : 0.f;
        s[j][e] = pr;
        psum[e / 2] += pr;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
#pragma unroll
    for (int j = 0; j < kND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e / 2];
    // O += P V, P rounded to T: n8 tiles 2kk and 2kk + 1 make the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < kNK / 2; ++kk) {
      uint32_t pa[4];
      acc_to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < kND / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + bt_frag<kLd>(lane, kk * 16, np * 16));
        mma16816<T>(o[2 * np], pa, bv[0], bv[1]);
        mma16816<T>(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    if (qpos[i] < 0) continue;
    const float inv = li > 0.f ? 1.f / li : 0.f;
    T* orow = out + q_at + (int64_t)qpos[i] * q_stride + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < kND; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) = pack2<T>(o[j][2 * i] * inv,
                                                            o[j][2 * i + 1] * inv);
    if (lane % 4 == 0)
      lse[((int64_t)b * H + h) * S + qpos[i]] = li == 0.f ? kNegInf : m[i] * kLn2 + logf(li);
  }
}

// -------------------------------------------------- tensor-core dK and dV
// One block per (64-key tile, kv head, batch), the tile taken in launch order;
// warp w owns keys 16w..16w+15 of the tile, so S^T and dP^T (keys x the
// chunk's 64 query rows) and dK, dV (keys x D) are accumulated in its
// registers.  Shared: K and V of the tile; two buffers of Q, dO, lse, delta,
// query positions and mask bits of a walked chunk.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
sparse_bwd_dkdv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, Tables tb,
                          const int* __restrict__ tile_order, int S, int H, int KV, float scale,
                          float scale_log2, int causal) {
  constexpr int kLd = D + 8;
  constexpr int kND = D / 8;
  constexpr int kKD = D / 16;
  constexpr int kNQ = kTile / 8;  // n8 tiles of a chunk's 64 query rows
  constexpr int kElems = kTile * kLd;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* k_s = reinterpret_cast<T*>(tc_smem);   // [kTile][kLd]
  T* v_s = k_s + kElems;                     // [kTile][kLd]
  T* q_s = v_s + kElems;                     // [2][kTile][kLd]
  T* do_s = q_s + 2 * kElems;                // [2][kTile][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kElems);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                          // [2][kTile]
  int* qpos_s = reinterpret_cast<int*>(delta_s + 2 * kTile);   // [2][kTile]
  unsigned* qbits_s = reinterpret_cast<unsigned*>(qpos_s + 2 * kTile);  // [2][kTile]
  int* kpos_s = reinterpret_cast<int*>(qbits_s + 2 * kTile);   // [kTile]
  int* own_s = kpos_s + kTile;                                 // [kMaxOwn]
  int* kmin_s = own_s + kMaxOwn;

  const int n_tiles = gridDim.z;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int t = tile_order[g * n_tiles + blockIdx.z];
  const int group = H / KV;
  const int NB = tb.NB, bs = tb.bs;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f_own = t * kTile;
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const int64_t kv_at = ((int64_t)b * S * KV + g) * D;

  if (threadIdx.x == 0) *kmin_s = INT_MAX;
  __syncthreads();
  const int p = stage_owner(kpos_s, own_s, tb.order + (int64_t)g * NB, NB, bs, f_own, S);
  if (p >= 0) atomicMin(kmin_s, p);
  __syncthreads();
  const int kmin = *kmin_s;
  if (kmin == INT_MAX) return;  // the tile lies past S: no key to write

  // the lane's two keys: position and owner-block index (kNoBit past S)
  int kpos[2];
  unsigned kloc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
    kpos[i] = kpos_s[r];
    kloc[i] = kpos[i] >= 0 ? (unsigned)((f_own + r) / bs - f_own / bs) : kNoBit;
  }

  // chunks [c, c_end) of q head hi's walk that reach the tile's first key; the
  // walk is sorted, so under causal the chunks that end before it are a prefix
  auto chunk_range = [&](int hi, int& c, int& c_end) {
    const int h = g * group + hi;
    const int n = tb.cnt[h * n_tiles + t];
    const int* walk = tb.walk + ((int64_t)h * n_tiles + t) * tb.width;
    c_end = (n * bs + kTile - 1) / kTile;
    c = 0;
    if (causal) {
      int before = 0;  // walked blocks that end before kmin
      for (int e0 = 0; e0 < n; e0 += kTcThreads) {
        const int e = e0 + threadIdx.x;
        before += __syncthreads_count(e < n && walk[e] * bs + bs - 1 < kmin);
      }
      c = before < n ? (before * bs + max(0, kmin - walk[before] * bs)) / kTile : c_end;
    }
  };
  // the next (head, chunk) after (hi, c), or false past the group's last head
  auto settle = [&](int& hi, int& c, int& c_end) {
    while (c >= c_end) {
      if (++hi >= group) return false;
      chunk_range(hi, c, c_end);
    }
    return true;
  };
  auto load_chunk = [&](int hi, int c, int buf) {
    const int h = g * group + hi;
    const int n = tb.cnt[h * n_tiles + t];
    const int* walk = tb.walk + ((int64_t)h * n_tiles + t) * tb.width;
    const int f0 = c * kTile;
    const int64_t q_at = ((int64_t)b * S * H + h) * D;
    cp_rows_pair<T, D>(q_s + buf * kElems, q + q_at, do_s + buf * kElems, dout + q_at, q_stride,
                       [&](int r) { return list_pos(walk, n, bs, f0 + r, S); });
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const int qp = list_pos(walk, n, bs, f0 + r, S);
      unsigned bits = 0u;  // bit l: layout[h][block of qp][own_s[l]]
      if (qp >= 0) {
        const unsigned char* row = tb.layout + ((int64_t)h * NB + qp / bs) * NB;
#pragma unroll
        for (int l = 0; l < kMaxOwn; ++l) bits |= row[own_s[l]] ? 1u << l : 0u;
      }
      qpos_s[buf * kTile + r] = qp;
      qbits_s[buf * kTile + r] = bits;
      const float* lse_h = lse + ((int64_t)b * H + h) * S;
      const float* delta_h = delta + ((int64_t)b * H + h) * S;
      cp_async4(smem_u32(lse_s + buf * kTile + r), qp >= 0 ? lse_h + qp : lse_h, qp >= 0);
      cp_async4(smem_u32(delta_s + buf * kTile + r), qp >= 0 ? delta_h + qp : delta_h, qp >= 0);
    }
  };

  float dk_acc[kND][4], dv_acc[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  int hi = 0, c = 0, c_end = 0;
  chunk_range(0, c, c_end);
  bool more = settle(hi, c, c_end);
  if (more) {
    cp_rows_pair<T, D>(k_s, k + kv_at, v_s, v + kv_at, kv_stride,
                       [&](int r) { return kpos_s[r]; });
    load_chunk(hi, c, 0);
    cp_async_commit();
  }
  const uint32_t ka = smem_u32(k_s);
  const uint32_t va = smem_u32(v_s);
  for (int buf = 0; more; buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // chunk `buf` has landed; every warp is done with the other buffer
    int nc = c + 1;
    more = settle(hi, nc, c_end);
    c = nc;
    if (more) {
      load_chunk(hi, c, buf ^ 1);
      cp_async_commit();
    }
    const int* qp_t = qpos_s + buf * kTile;
    const unsigned* qb_t = qbits_s + buf * kTile;
    // bit j*4 + e: accumulator element e of n8 tile j is live
    uint32_t live = 0u;
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int r = j * 8 + (lane % 4) * 2 + cc;
        const int qp = qp_t[r];
        const unsigned qb = qb_t[r];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (((qb >> kloc[i]) & 1u) && (!causal || kpos[i] <= qp))
            live |= 1u << (j * 4 + 2 * i + cc);
      }
    if (!__any_sync(0xffffffffu, live != 0u)) continue;  // the warp's sub-tile is masked whole
    const uint32_t qt = smem_u32(q_s + buf * kElems);
    const uint32_t dot = smem_u32(do_s + buf * kElems);
    const float* lse_t = lse_s + buf * kTile;
    const float* delta_t = delta_s + buf * kTile;

    float st[kNQ][4], dpt[kNQ][4];  // S^T and dP^T: the warp's keys x the chunk's rows
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
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j * 8 + (lane % 4) * 2 + (e & 1);
        const float pr = (live >> (j * 4 + e)) & 1u
                             ? exp2f(st[j][e] * scale_log2 - lse_t[r] * kLog2e) : 0.f;
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] - delta_t[r]) * scale;
      }
    // dV += P^T dO and dK += dS^T Q over the chunk's rows, P and dS rounded to T
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
    if (kpos[i] < 0) continue;
    const int64_t at = (((int64_t)b * S + kpos[i]) * KV + g) * D + (lane % 4) * 2;
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
// One block per (64-query tile, q head, batch), the tile taken in launch
// order; warp w owns rows 16w..16w+15 of the tile, so dQ (rows x D) is
// accumulated in its registers, with the warp's Q and dO A-fragments, loaded
// once, and the lse and delta of the lane's two rows.  Walked 64-key chunks
// (K, V, key positions and mask bits) are double-buffered by cp.async.  Per
// chunk, in two passes of 32 keys: S = Q K^T and dP = dO V^T; P = exp2(S
// scale log2e - lse log2e), zero where masked; dS = P (dP - delta) scale in
// fp32, rounded to T straight into the A fragments of dQ += dS K.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
sparse_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, Tables tb, const int* __restrict__ tile_order, int S,
                        int H, int KV, float scale, float scale_log2, int causal) {
  constexpr int kLd = D + 8;
  constexpr int kKD = D / 16;
  constexpr int kND = D / 8;
  constexpr int kPass = 32;        // keys of one S / dP pass
  constexpr int kNP = kPass / 8;   // n8 tiles of a pass
  constexpr int kElems = kTile * kLd;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* q_s = reinterpret_cast<T*>(tc_smem);   // [kTile][kLd]
  T* do_s = q_s + kElems;                    // [kTile][kLd]
  T* k_s = do_s + kElems;                    // [2][kTile][kLd]
  T* v_s = k_s + 2 * kElems;                 // [2][kTile][kLd]
  int* kpos_s = reinterpret_cast<int*>(v_s + 2 * kElems);        // [2][kTile]
  unsigned* kbits_s = reinterpret_cast<unsigned*>(kpos_s + 2 * kTile);  // [2][kTile]
  int* qpos_s = reinterpret_cast<int*>(kbits_s + 2 * kTile);     // [kTile]
  int* own_s = qpos_s + kTile;                                   // [kMaxOwn]
  int* qmax_s = own_s + kMaxOwn;

  const int n_tiles = gridDim.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t = tile_order[h * n_tiles + blockIdx.z];
  const int g = h / (H / KV);
  const int NB = tb.NB, bs = tb.bs;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f_own = t * kTile;
  const int* walk = tb.walk + ((int64_t)h * n_tiles + t) * tb.width;
  const int n_walk = tb.cnt[h * n_tiles + t];
  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)KV * D;
  const int64_t q_at = ((int64_t)b * S * H + h) * D;
  const T* kb = k + ((int64_t)b * S * KV + g) * D;
  const T* vb = v + ((int64_t)b * S * KV + g) * D;

  if (threadIdx.x == 0) *qmax_s = -1;
  __syncthreads();
  const int p = stage_owner(qpos_s, own_s, tb.order + (int64_t)h * NB, NB, bs, f_own, S);
  if (p >= 0) atomicMax(qmax_s, p);
  __syncthreads();
  const int qmax = *qmax_s;
  if (qmax < 0) return;  // the tile lies past S: no row to write

  // chunks [0, n_chunks) of the walk; under causal the walk is sorted, so it
  // stops at the first chunk that starts past the tile's last query
  int n_chunks = (n_walk * bs + kTile - 1) / kTile;
  if (causal) {
    int upto = 0;  // walked blocks that start at or before qmax
    for (int e0 = 0; e0 < n_walk; e0 += kTcThreads) {
      const int e = e0 + threadIdx.x;
      upto += __syncthreads_count(e < n_walk && walk[e] * bs <= qmax);
    }
    const int seen = upto > 0 ? (upto - 1) * bs + min(bs, qmax - walk[upto - 1] * bs + 1) : 0;
    n_chunks = (seen + kTile - 1) / kTile;
  }

  // the lane's two rows: position, owner-block index (kNoBit past S), lse in
  // log2 units and delta
  int qpos[2];
  unsigned qloc[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
    qpos[i] = qpos_s[r];
    const bool live = qpos[i] >= 0;
    qloc[i] = live ? (unsigned)((f_own + r) / bs - f_own / bs) : kNoBit;
    const int64_t at = ((int64_t)b * H + h) * S + (live ? qpos[i] : 0);
    lse2[i] = live ? lse[at] * kLog2e : 0.f;
    dlt[i] = live ? delta[at] : 0.f;
  }

  auto load_chunk = [&](int c, int buf) {
    const int f0 = c * kTile;
    cp_rows_pair<T, D>(k_s + buf * kElems, kb, v_s + buf * kElems, vb, kv_stride,
                       [&](int r) { return list_pos(walk, n_walk, bs, f0 + r, S); });
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const int kp = list_pos(walk, n_walk, bs, f0 + r, S);
      unsigned bits = 0u;  // bit l: layout[h][own_s[l]][block of kp]
      if (kp >= 0) {
        const unsigned char* col = tb.layout + (int64_t)h * NB * NB + kp / bs;
#pragma unroll
        for (int l = 0; l < kMaxOwn; ++l) bits |= col[(int64_t)own_s[l] * NB] ? 1u << l : 0u;
      }
      kpos_s[buf * kTile + r] = kp;
      kbits_s[buf * kTile + r] = bits;
    }
  };

  float acc[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  uint32_t qf[kKD][4], df[kKD][4];
  if (n_chunks > 0) {
    cp_rows_pair<T, D>(q_s, q + q_at, do_s, dout + q_at, q_stride,
                       [&](int r) { return qpos_s[r]; });
    load_chunk(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      ldsm_x4(qf[kk], smem_u32(q_s) + a_frag<kLd>(lane, warp * 16, kk * 16));
      ldsm_x4(df[kk], smem_u32(do_s) + a_frag<kLd>(lane, warp * 16, kk * 16));
    }
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c + 1 < n_chunks) {
      load_chunk(c + 1, buf ^ 1);
      cp_async_commit();
    }
    const int* kp_t = kpos_s + buf * kTile;
    const unsigned* kb_t = kbits_s + buf * kTile;
    // bit j*4 + e: accumulator element e of the chunk's n8 tile j is live
    uint32_t live = 0u;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = j * 8 + (lane % 4) * 2 + cc;
        const int kp = kp_t[col];
        const unsigned kbits = kb_t[col];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (((kbits >> qloc[i]) & 1u) && (!causal || kp <= qpos[i]))
            live |= 1u << (j * 4 + 2 * i + cc);
      }
    const uint32_t kt = smem_u32(k_s + buf * kElems);
    const uint32_t vt = smem_u32(v_s + buf * kElems);
#pragma unroll
    for (int pass = 0; pass < kTile / kPass; ++pass) {
      const uint32_t pass_live = (live >> (pass * kNP * 4)) & 0xffffu;
      if (!__any_sync(0xffffffffu, pass_live != 0u)) continue;  // masked whole for the warp
      const int n0 = pass * kPass;  // the pass's first key in the chunk
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
          const float pr = (pass_live >> (j * 4 + e)) & 1u
                               ? exp2f(s[j][e] * scale_log2 - lse2[e / 2]) : 0.f;
          s[j][e] = pr * (dp[j][e] - dlt[e / 2]) * scale;
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
    if (qpos[i] < 0) continue;
    T* o = dq + q_at + (int64_t)qpos[i] * q_stride + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < kND; ++j)
      *reinterpret_cast<uint32_t*>(o + j * 8) = pack2<T>(acc[j][2 * i], acc[j][2 * i + 1]);
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

// tensor cores: K, V, two Q/dO tiles (dK/dV) or Q, dO, two K/V tiles (dQ),
// rows of D + 8 two-byte elements; per buffer the rows' positions and mask
// bits (and, dK/dV, lse and delta); the owner tile's positions and blocks
int dkdv_tc_smem(int D) {
  return 6 * kTile * (D + 8) * 2 + (8 * kTile + kTile + kMaxOwn + 1) * 4;
}
int dq_tc_smem(int D) { return 6 * kTile * (D + 8) * 2 + (4 * kTile + kTile + kMaxOwn + 1) * 4; }
// the forward: Q and two K/V tiles, about 86 KB at D = 128, so two blocks fit an SM
int fwd_tc_smem(int D) { return 5 * kTile * (D + 8) * 2 + (4 * kTile + kTile + kMaxOwn + 1) * 4; }

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
  const int* tile_order;  // the owner tiles, longest walk first (tensor-core kernels)
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

// tensor cores: the tile index is the slowest grid axis, so every head's
// longest walks are launched first
template <typename T, int D>
cudaError_t launch_dkdv_tc(const Args& a) {
  const int smem = dkdv_tc_smem(D);
  cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dkdv_tc_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.KV, a.B, n_tiles(a));
  sparse_bwd_dkdv_tc_kernel<T, D><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o0),
      static_cast<T*>(a.o1), a.tb, a.tile_order, a.S, a.H, a.KV, a.scale, a.scale * kLog2e,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd_tc(const Args& a) {
  const int smem = fwd_tc_smem(D);
  cudaError_t err = cudaFuncSetAttribute(sparse_fwd_tc_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, a.B, n_tiles(a));
  sparse_fwd_tc_kernel<T, D><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.tb, a.tile_order, a.S, a.H, a.KV,
      a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_tc(const Args& a) {
  const int smem = dq_tc_smem(D);
  cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dq_tc_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, a.B, n_tiles(a));
  sparse_bwd_dq_tc_kernel<T, D><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o0), a.tb,
      a.tile_order, a.S, a.H, a.KV, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDkdv = 1, kDq = 2 };

// The kernels by type: CUDA cores for fp32, tensor cores for bf16 and fp16.
template <typename T, int D>
cudaError_t launch_which(int which, const Args& a) {
  constexpr bool tc = !std::is_same<T, float>::value;
  switch (which) {
    case kFwd:
      if constexpr (tc) return launch_fwd_tc<T, D>(a);
      else return launch_fwd<T, D>(a);
    case kDkdv:
      if constexpr (tc) return launch_dkdv_tc<T, D>(a);
      else return launch_dkdv<T, D>(a);
    case kDq:
      if constexpr (tc) return launch_dq_tc<T, D>(a);
      else return launch_dq<T, D>(a);
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
  if (dtype != 0 && (a.tile_order == nullptr || a.tb.bs % 8 != 0))
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
// T = ceil(NB * block / 64), and q_tile_order [H, T] (longest walk first;
// read by the tensor-core kernel).  Returns a cudaError_t (0 = launched).
// float32 runs the CUDA-core kernel, bfloat16 and float16 the tensor-core
// one.
int sparse_fwd_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                      void* lse, const void* layout, const void* q_order, const void* k_walk,
                      const void* k_cnt, const void* q_tile_order, int B, int S, int H, int KV,
                      int head_dim, int NB, int block, int walk_width, float scale, int causal,
                      void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, lse,
         tables(layout, q_order, k_walk, k_cnt, NB, block, walk_width),
         static_cast<const int*>(q_tile_order),
         B, S, H, KV, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(kFwd, dtype, head_dim, a);
}

// dout [B, S, H, D] in q's dtype; lse and delta [B, H, S] float32; dk/dv
// [B, S, KV, D] in k's dtype (every element written).  Tables: layout,
// k_order [KV, NB], q_walk [H, T, walk_width], q_cnt [H, T], k_tile_order
// [KV, T] (a permutation of the tiles, longest walk first; read by the
// tensor-core kernel).  float32 runs the CUDA-core kernel, bfloat16 and
// float16 the tensor-core one.
int sparse_bwd_dkdv_launch(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dk,
                           void* dv, const void* layout, const void* k_order, const void* q_walk,
                           const void* q_cnt, const void* k_tile_order, int B, int S, int H,
                           int KV, int head_dim, int NB, int block, int walk_width, float scale,
                           int causal, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dk, dv, tables(layout, k_order, q_walk, q_cnt, NB, block, walk_width),
         static_cast<const int*>(k_tile_order), B, S, H, KV, scale, causal,
         static_cast<cudaStream_t>(stream)};
  return launch(kDkdv, dtype, head_dim, a);
}

// dq [B, S, H, D] in q's dtype (every element written).  Tables as the
// forward's and q_tile_order [H, T] (longest walk first).  Kernels by dtype
// as dK/dV's.
int sparse_bwd_dq_launch(int dtype, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dq,
                         const void* layout, const void* q_order, const void* k_walk,
                         const void* k_cnt, const void* q_tile_order, int B, int S, int H,
                         int KV, int head_dim, int NB, int block, int walk_width, float scale,
                         int causal, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, tables(layout, q_order, k_walk, k_cnt, NB, block, walk_width),
         static_cast<const int*>(q_tile_order), B, S, H, KV, scale, causal,
         static_cast<cudaStream_t>(stream)};
  return launch(kDq, dtype, head_dim, a);
}

}  // extern "C"
