// Ragged paged attention over a block table, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/attention/paged.py::_paged_kernel (the Pallas TPU
// kernel behind paged_attention, shared by chunked prefill and decode).
//
// What it computes, per sequence n, query token t and query head h:
//   out[n, t, h] = softmax_k(scale * q . k + slope_h * kpos) @ v
// over the keys kpos of sequence n, read through its block table
// (pool[tables[n, kpos / bs], h / group, kpos % bs]), masked to
//   kpos <= start_pos[n] + t,  kpos < lengths[n],  t < n_tokens[n]
// and, with a sliding window, kpos > start_pos[n] + t - window.  Rows with
// t >= n_tokens[n] (and whole rows with lengths[n] == 0) come out as exact
// zeros.  Accumulation is fp32 whatever the storage type.
//
// Three routes, chosen by one shape rule in ops/attention/paged.py
// (paged_route; no fallback between them): every chunk of T < 16 tokens
// (decode) goes to the split-K decode kernel and its merge, for every dtype
// and head dim; bf16/fp16 chunks of T >= 16 with head_dim 64 or 128 and a
// GQA group of at most 64 to the tensor-core prefill kernel; the rest (fp32,
// head_dim 32 or 256 at T >= 16) to the CUDA-core kernel.
//
// Split-K decode kernel (paged_decode_kernel + paged_decode_merge_kernel;
// replaces _paged_kernel at decode).  What bounds it on the H100: every live
// K/V byte is read once and used for two multiply-adds an element, so decode
// is bound by device memory (live K/V bytes / 3.35 TB/s); the design aims at
// bytes in flight and at filling 132 SMs, not at tensor cores:
//   - split-K: one block per (split of the key range, kv head, block of
//     rows, sequence), the splits sized on the host from shapes alone
//     (paged.py decode_split: whole 64-key tiles and whole table slots,
//     several waves), so a 4096-key sequence runs in many blocks beside
//     1-key ones; each block writes its partial (m in log2 units, l, acc[D])
//     in fp32, a split past the length or wholly before the window an empty
//     one (l = 0), and the merge kernel combines each row's partials by
//     their weights 2^(m - max m);
//   - rows packed: all q heads of the kv head's GQA group and all tokens of
//     the chunk share the block's K/V tiles (Mistral 4 rows at T = 1, up to
//     min(8, 1024 / D) a block; a kernel sized for 4 rows takes T = 1 with
//     groups of 1-4, so its accumulators leave room for more resident
//     blocks), and the keys of a tile are split across the 4 warps, each
//     with its own (m, l, acc), merged in shared memory at the end, so no
//     warp idles at T = 1;
//   - loads: K/V rows arrive by cp.async, 16 bytes a lane, into
//     double-buffered shared tiles of 16 KB of K (and V) kept in the storage
//     type (tile t + 1 loads while tile t computes), table slots looked up
//     a tile ahead, rows outside the block's keys zero-filled and masked,
//     never read;
//   - fp32 arithmetic with no rounding of P, so the result differs from the
//     plain version only by the order of summation.
//
// CUDA-core kernel (fp32 and head_dim 32/256 chunks of T >= 16).  One block
// per (sequence, group of q heads sharing one kv head, tile of query
// tokens), so the K/V tiles a block stages in shared memory feed every q
// head of its GQA group and every query token of the tile; the TPU kernel's
// sequential grid axis over table slots, which carried the online-softmax
// state in VMEM, becomes a loop inside the block over the live key tiles
// only (from the first inside the window to the last key any row of the
// tile may see, so table slots past lengths[n] are never read); the softmax
// state lives in registers of the warp that owns the row; K/V rows come in
// as 16-byte loads, several in flight per thread.
//
// Tensor-core prefill kernel.  A chunk of T tokens does 4 Dh operations for
// each visible (row, key) pair against Dh elements of K and V a key, so at
// T = 512 it is bound by arithmetic (989 TFLOP/s for bf16/fp16 on
// mma.sync.m16n8k16, fp32 accumulators).  A block of 4 warps owns 64 rows of
// one (sequence, kv head), row r = token t0 + r / group and q head
// g * group + r % group, so every K/V tile it stages feeds all the heads of
// the group (Mistral: 16 tokens x 4 heads; Llama MHA: 64 tokens x 1 head).
// Each (pool block, kv head) slab is bs x Dh contiguous, so a 64-key tile is
// gathered by cp.async 16 bytes at a time through the block table, and
// double-buffered.  P is rounded to the storage type before P V, as
// FlashAttention does; the result is held to flash.tensor_core_limit against
// the plain version that rounds P the same way (paged.py, round_to=).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;  // query rows (q head x token) per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMaxKeysPerLane = 4;  // key tile of at most 128 keys
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr int kLoadBatch = 4;       // 16-byte loads each thread keeps in flight

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory: q tile [kRows][DH], K tile [tile_keys][DH + 1] (padded so the
// lanes of a warp, one key each, hit distinct banks), V tile [tile_keys][DH].
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                       const T* __restrict__ vpool, const int* __restrict__ tables,
                       const int* __restrict__ lengths, const int* __restrict__ start_pos,
                       const int* __restrict__ n_tokens, const float* __restrict__ alibi,
                       T* __restrict__ out, int T_, int H, int KV, int bs, int maxb,
                       int heads_per_block, int q_tile, int tile_keys, float scale,
                       int window) {
  constexpr int kDimPerLane = DH / 32;
  extern __shared__ float smem[];
  __shared__ int blk_s[32];  // pool block of each table slot the current tile spans
  float* q_s = smem;
  float* k_s = q_s + kRows * DH;
  float* v_s = k_s + tile_keys * (DH + 1);

  const int n = blockIdx.z;
  const int h0 = blockIdx.y * heads_per_block;
  const int t0 = blockIdx.x * q_tile;
  const int group = H / KV;
  const int g = h0 / group;
  const int rows = heads_per_block * q_tile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int length = lengths[n];
  const int start = start_pos[n];
  const int ntok = n_tokens[n];
  const int t_hi = min(t0 + q_tile, min(T_, ntok));  // valid tokens of the tile: [t0, t_hi)

  // keys any row of this tile may see: [key_begin, key_end)
  int key_end = 0;
  int key_begin = 0;
  if (t_hi > t0) {
    key_end = min(min(length, start + t_hi), maxb * bs);
    if (window > 0) key_begin = max(0, start + t0 - window + 1);
  }

  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx % DH;
    const int t = t0 + r / heads_per_block;
    const int h = h0 + r % heads_per_block;
    float val = 0.f;
    if (r < rows && t < T_) val = to_float(q[((int64_t)(n * T_ + t) * H + h) * DH + d]);
    q_s[idx] = val;
  }

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDimPerLane; ++dd) acc[i][dd] = 0.f;
  }

  const int keys_per_lane = tile_keys / 32;
  const int tile_blocks = tile_keys / min(bs, tile_keys);  // table slots one tile spans
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte load
  constexpr int kVecPerRow = DH / kVec;
  const int n_vec = tile_keys * kVecPerRow;
  const int64_t pool_head_stride = (int64_t)bs * DH;
  for (int k0 = (key_begin / tile_keys) * tile_keys; k0 < key_end; k0 += tile_keys) {
    __syncthreads();  // the previous tile's readers are done (and q_s is staged)
    if (tid < tile_blocks) {
      const int slot = k0 / bs + tid;
      blk_s[tid] = slot * bs < key_end ? tables[(int64_t)n * maxb + slot] : -1;
    }
    __syncthreads();
    // 16-byte loads of the live K/V rows, kLoadBatch per thread in flight at
    // once; dead rows (past key_end, or table slots never read) become zeros
    for (int base = tid; base < n_vec; base += kThreads * kLoadBatch) {
      uint4 kr[kLoadBatch];
      uint4 vr[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = base + u * kThreads;
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < n_vec) {
          const int j = idx / kVecPerRow;
          const int kpos = k0 + j;
          const int blk = blk_s[j / min(bs, tile_keys)];
          if (kpos < key_end && blk >= 0) {
            const int64_t src = ((int64_t)blk * KV + g) * pool_head_stride +
                                (int64_t)(kpos % bs) * DH + (idx % kVecPerRow) * kVec;
            kr[u] = __ldg(reinterpret_cast<const uint4*>(kpool + src));
            vr[u] = __ldg(reinterpret_cast<const uint4*>(vpool + src));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = base + u * kThreads;
        if (idx < n_vec) {
          const int j = idx / kVecPerRow;
          const int d0 = (idx % kVecPerRow) * kVec;
          const T* ke = reinterpret_cast<const T*>(&kr[u]);
          const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            k_s[j * (DH + 1) + d0 + e] = to_float(ke[e]);
            v_s[j * DH + d0 + e] = to_float(ve[e]);
          }
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= rows) continue;
      const int t = t0 + r / heads_per_block;
      if (t >= T_ || t >= ntok) continue;  // warp-uniform: the row is padding
      const int h = h0 + r % heads_per_block;
      const int qpos = start + t;
      const float slope = alibi != nullptr ? alibi[h] : 0.f;
      const float* qr = q_s + r * DH;

      float s[kMaxKeysPerLane];
      bool ok[kMaxKeysPerLane];
      float smax = kNegInf;
#pragma unroll
      for (int c = 0; c < kMaxKeysPerLane; ++c) {
        s[c] = kNegInf;
        ok[c] = false;
        if (c < keys_per_lane) {
          const int j = lane + 32 * c;
          const int kpos = k0 + j;
          const float* kr = k_s + j * (DH + 1);
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < DH; ++d) dot += qr[d] * kr[d];
          float sc = dot * scale;
          if (alibi != nullptr) sc += slope * (float)kpos;
          ok[c] = kpos < key_end && kpos <= qpos && (window <= 0 || kpos > qpos - window);
          s[c] = ok[c] ? sc : kNegInf;
          smax = fmaxf(smax, s[c]);
        }
      }
      const float m_new = fmaxf(m[i], warp_max(smax));
      float p[kMaxKeysPerLane];
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxKeysPerLane; ++c) {
        p[c] = ok[c] ? expf(s[c] - m_new) : 0.f;
        psum += p[c];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < kDimPerLane; ++dd) acc[i][dd] *= corr;
#pragma unroll
      for (int c = 0; c < kMaxKeysPerLane; ++c) {
        if (c < keys_per_lane) {
          for (int jj = 0; jj < 32; ++jj) {
            const float pj = __shfl_sync(0xffffffffu, p[c], jj);
            const float* vr = v_s + (32 * c + jj) * DH + lane;
#pragma unroll
            for (int dd = 0; dd < kDimPerLane; ++dd) acc[i][dd] += pj * vr[32 * dd];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= rows) continue;
    const int t = t0 + r / heads_per_block;
    if (t >= T_) continue;
    const int h = h0 + r % heads_per_block;
    T* o = out + ((int64_t)(n * T_ + t) * H + h) * DH + lane;
    const bool live = t < ntok;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int dd = 0; dd < kDimPerLane; ++dd)
      o[32 * dd] = from_float<T>(live ? acc[i][dd] / l_safe : 0.f);
  }
}

// ------------------------------------------------- tensor-core chunked prefill
constexpr int kTcRows = 64;      // rows (token x q head of one kv group) a block, 16 a warp
constexpr int kTcKeys = 64;      // keys a tile
constexpr int kTcThreads = 128;

// One block per (64 rows, kv head, sequence): row r is token t0 + r / group,
// q head g * group + r % group, so the K/V tiles a block stages feed every
// head of the GQA group.  Warp w owns rows 16w..16w+15 with the accumulator
// layout of mma.sync; its Q A-fragments, loaded once, stay in registers.  Per
// 64-key tile, gathered through the block table (slots looked up one tile
// ahead into shared memory, each pool row copied by cp.async in 16-byte
// chunks into rows of D + 8, dead chunks zero-filled, K/V double-buffered):
// S = Q K^T by mma.sync; the online softmax in fp32 registers with exp2 and
// the scale folded into log2(e), ALiBi added and the causal, length and
// window masks applied by each row's own token and head; P rounded to T into
// A fragments, l summing the fp32 P; O += P V with V through ldmatrix.trans.
// Rows past n_tokens and rows that see no key are written as exact zeros; a
// block whose tokens all lie past n_tokens reads nothing.  Token tiles are
// launched latest (most keys) first.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
paged_prefill_tc_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool, const int* __restrict__ tables,
                        const int* __restrict__ lengths, const int* __restrict__ start_pos,
                        const int* __restrict__ n_tokens, const float* __restrict__ alibi,
                        T* __restrict__ out, int T_, int H, int KV, int bs, int maxb, int q_tile,
                        float scale_log2, int window) {
  constexpr int kLd = D + 8;
  constexpr int kKD = D / 16;
  constexpr int kND = D / 8;
  constexpr int kNK = kTcKeys / 8;  // n8 tiles of a score tile
  constexpr int kChunks = D / 8;    // 16-byte chunks of a row
  constexpr int kTileElems = kTcKeys * kLd;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int blk_s[2][kTcKeys];  // pool block of each table slot a tile spans, -1 if dead
  T* q_s = reinterpret_cast<T*>(tc_smem);  // [kTcRows][kLd]
  T* k_s = q_s + kTcRows * kLd;             // [2][kTcKeys][kLd]
  T* v_s = k_s + 2 * kTileElems;            // [2][kTcKeys][kLd]

  const int n = blockIdx.z;
  const int g = blockIdx.y;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * q_tile;
  const int group = H / KV;
  const int rows = q_tile * group;  // rows of the block that map to a token (<= kTcRows)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = lengths[n];
  const int start = start_pos[n];
  const int t_hi = min(t0 + q_tile, min(T_, n_tokens[n]));  // live tokens: [t0, t_hi)
  const int key_lim = min(length, maxb * bs);               // keys that exist

  // keys any row of this block may see: [key_begin, key_end)
  int key_begin = 0;
  int key_end = 0;
  if (t_hi > t0) {
    key_end = min(key_lim, start + t_hi);
    if (window > 0) key_begin = max(0, start + t0 - window + 1);
  }
  const int kt0 = (key_begin / kTcKeys) * kTcKeys;
  const int n_tiles = key_end > kt0 ? (key_end - kt0 + kTcKeys - 1) / kTcKeys : 0;

  // the thread's two rows: token, q head, liveness, ALiBi slope in log2 units
  int qpos[2], head[2];
  bool live[2];
  float slope2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
    const int tok = t0 + r / group;
    head[i] = g * group + r % group;
    qpos[i] = start + tok;
    live[i] = r < rows && tok < t_hi;
    slope2[i] = alibi != nullptr ? alibi[head[i]] * kLog2e : 0.f;
  }
  // the warp's live tokens [wt_lo, wt_hi]
  const int wr0 = warp * 16;
  const bool warp_live = wr0 < rows && t0 + wr0 / group < t_hi;
  const int wt_lo = t0 + wr0 / group;
  const int wt_hi = min(t0 + (min(wr0 + 15, rows - 1)) / group, t_hi - 1);
  const bool warp_full = wr0 + 15 < rows && t0 + (wr0 + 15) / group < t_hi;

  const int nslots = bs >= kTcKeys ? 1 : kTcKeys / bs;
  auto lookup = [&](int tile, int buf) {
    const int slot0 = (kt0 + tile * kTcKeys) / bs;
    for (int i = threadIdx.x; i < nslots; i += kTcThreads)
      blk_s[buf][i] = (slot0 + i) * bs < key_end ? tables[(int64_t)n * maxb + slot0 + i] : -1;
  };
  auto issue = [&](int tile, int buf) {
    const int k0 = kt0 + tile * kTcKeys;
    const uint32_t kb = smem_u32(k_s + buf * kTileElems);
    const uint32_t vb = smem_u32(v_s + buf * kTileElems);
    for (int idx = threadIdx.x; idx < kTcKeys * kChunks; idx += kTcThreads) {
      const int j = idx / kChunks;
      const int c = idx % kChunks;
      const int kpos = k0 + j;
      const int blk = blk_s[buf][kpos / bs - k0 / bs];
      const bool ok = kpos < key_end && blk >= 0;
      const int64_t at = ok ? (((int64_t)blk * KV + g) * bs + kpos % bs) * D + c * 8 : 0;
      const uint32_t dst = (j * kLd + c * 8) * (uint32_t)sizeof(T);
      cp_async16(kb + dst, kpool + at, ok);
      cp_async16(vb + dst, vpool + at, ok);
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

  if (n_tiles > 0) {
    lookup(0, 0);
    if (n_tiles > 1) lookup(1, 1);
    for (int idx = threadIdx.x; idx < kTcRows * kChunks; idx += kTcThreads) {
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const int tok = t0 + r / group;
      const bool ok = r < rows && tok < t_hi;
      const T* src =
          ok ? q + (((int64_t)n * T_ + tok) * H + g * group + r % group) * D + c * 8 : q;
      cp_async16(smem_u32(q_s + r * kLd + c * 8), src, ok);
    }
    __syncthreads();  // the slots of tiles 0 and 1 are visible
    issue(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk)
      ldsm_x4(qf[kk], smem_u32(q_s) + a_frag<kLd>(lane, warp * 16, kk * 16));
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; tile t - 1 is read; tile t + 1's slots are visible
    if (t + 1 < n_tiles) {
      issue(t + 1, (t + 1) & 1);
      cp_async_commit();
    }
    if (t + 2 < n_tiles) lookup(t + 2, t & 1);
    const int k0 = kt0 + t * kTcKeys;
    // no row of the warp sees these keys: past every row's query, or before every window
    if (!warp_live || k0 > start + wt_hi ||
        (window > 0 && k0 + kTcKeys - 1 <= start + wt_lo - window))
      continue;
    const uint32_t kt = smem_u32(k_s + (t & 1) * kTileElems);
    const uint32_t vt = smem_u32(v_s + (t & 1) * kTileElems);

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

    // every key of the tile visible to every row of the warp: no mask needed
    const bool edge = !(warp_full && k0 + kTcKeys <= key_lim && k0 + kTcKeys - 1 <= start + wt_lo &&
                        (window <= 0 || k0 > start + wt_hi - window));
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
        float x = fmaf(slope2[i], (float)key, s[j][e] * scale_log2);
        if (edge && !(live[i] && key < key_lim && key <= qpos[i] &&
                      (window <= 0 || key > qpos[i] - window)))
          x = kNegInf;
        s[j][e] = x;
        mx[i] = fmaxf(mx[i], x);
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
        const int i = e / 2;
        float p = exp2f(s[j][e] - m[i]);
        if (edge) {  // zero masked entries explicitly: a row with no key yet has m = kNegInf
          const int key = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
          if (!(live[i] && key < key_lim && key <= qpos[i] &&
                (window <= 0 || key > qpos[i] - window)))
            p = 0.f;
        }
        s[j][e] = p;
        psum[i] += p;
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
    const int r = warp * 16 + lane / 4 + 8 * i;
    const int tok = t0 + r / group;
    if (r >= rows || tok >= T_) continue;
    const float inv = live[i] && li > 0.f ? 1.f / li : 0.f;
    T* orow = out + (((int64_t)n * T_ + tok) * H + head[i]) * D + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < kND; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack2<T>(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

// ------------------------------------------------------------ split-K decode
constexpr int kDecThreads = 128;    // 4 warps, each a quarter of every key tile
constexpr int kDecodeMaxKeys = 64;  // keys a tile at most (paged.py DECODE_TILE)
constexpr int kDecStages = 2;       // K/V tiles in the cp.async ring: kDecStages - 1 in flight
constexpr int kDecTileBytes = 16384;  // bytes of K rows a tile

// rows (token x q head of one kv group) a block: each warp keeps D / 32
// accumulators a lane for every row, 32 at most, and at most 8 rows (16
// rows spilled at D = 64); a (sequence, kv head) of at most kDecSmallRows
// rows (T = 1 with a group of 1-4: MHA, Mistral) takes a kernel sized for
// them (paged.py decode_rows)
constexpr int kDecSmallRows = 4;
template <int D>
__host__ __device__ constexpr int decode_rows() { return 1024 / D < 8 ? 1024 / D : 8; }

// keys a tile: kDecTileBytes of K rows, at most kDecodeMaxKeys
template <typename T, int D>
__host__ __device__ constexpr int decode_keys() {
  return kDecTileBytes / (D * (int)sizeof(T)) < kDecodeMaxKeys
             ? kDecTileBytes / (D * (int)sizeof(T)) : kDecodeMaxKeys;
}

// wait until at most N committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements of T (2 to 32 bytes, aligned to their size) as fp32
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + c * kPer);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_float(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
    out[0] = to_float(p[0]);
  }
}

template <typename T, int D, int R>
__host__ __device__ constexpr int decode_smem() {
  constexpr int kKeys = decode_keys<T, D>();
  constexpr int kParts = 32 / (kKeys / 4);
  return 2 * kDecStages * kKeys * (D + 16 / (int)sizeof(T)) * (int)sizeof(T) +
         R * kParts * (D / kParts + 4) * 4 + (kDecStages * kKeys + 2 * R) * 4;
}

// One block per (split, kv head x row block, sequence).  Row r of the block
// is row r0 + r of the (sequence, kv head): token (r0 + r) / group, q head
// g * group + (r0 + r) % group.  Warp w takes keys w * KW .. w * KW + KW - 1 of
// each tile; lane (j, part) = (lane % KW, lane / KW) computes the part-th
// slice of D of key j's score for every row (the parts summed by shuffles),
// then, for each row, the online softmax over the warp's keys and
// acc += p v with the lane owning D / 32 consecutive columns.  Partials go to
// ml [N, T, H, S, 2] (m in log2 units, l) and acc [N, T, H, S, D].
template <typename T, int D, int R>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ tables,
                    const int* __restrict__ lengths, const int* __restrict__ start_pos,
                    const int* __restrict__ n_tokens, const float* __restrict__ alibi,
                    float* __restrict__ part_ml, float* __restrict__ part_acc, int T_, int H,
                    int KV, int bs_shift, int maxb, int row_blocks, int split_keys,
                    float scale_log2, int window) {
  constexpr int KT = decode_keys<T, D>();
  constexpr int KW = KT / 4;          // keys of a tile a warp takes
  constexpr int kParts = 32 / KW;     // lanes sharing one key's dot product
  constexpr int DP = D / kParts;      // columns of a part
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int VP = DP / E;          // 16-byte vectors of a part
  constexpr int DPL = D / 32;         // accumulator columns a lane
  constexpr int LDK = D + E;          // K/V row stride (elements): 16 bytes of padding
  constexpr int LDQ = DP + 4;         // q part stride (floats): parts on distinct banks
  constexpr int QROW = kParts * LDQ;
  static_assert(DP % E == 0 && KT % 4 == 0 && 32 % KW == 0, "decode tile shape");
  constexpr int S_ = kDecStages;
  static_assert(4 * R * (D + 2) * 4 <= 2 * S_ * KT * LDK * (int)sizeof(T), "merge scratch fits");
  extern __shared__ __align__(16) unsigned char dec_smem[];
  T* k_s = reinterpret_cast<T*>(dec_smem);                     // [S_][KT][LDK]
  T* v_s = k_s + S_ * KT * LDK;                                 // [S_][KT][LDK]
  float* q_s = reinterpret_cast<float*>(v_s + S_ * KT * LDK);  // [R][QROW]
  int* blk_s = reinterpret_cast<int*>(q_s + R * QROW);         // [S_][KT] slots of a tile
  int* rq_s = blk_s + S_ * KT;                                  // [R] query position, -1 if dead
  float* rs_s = reinterpret_cast<float*>(rq_s + R);           // [R] ALiBi slope x log2 e

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int g = blockIdx.y / row_blocks;
  const int r0 = (blockIdx.y % row_blocks) * R;
  const int n = blockIdx.z;
  const int group = H / KV;
  const int rows = min(R, group * T_ - r0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bs = 1 << bs_shift;
  const int length = lengths[n];
  const int start = start_pos[n];
  const int live_tok = min(T_, n_tokens[n]);
  const int t_lo = r0 / group;
  const int t_hi = min((r0 + rows - 1) / group, live_tok - 1);  // the block's last live token

  // keys this block may see: [k_lo, k_hi), inside its split
  int k_lo = split * split_keys;
  int k_hi = 0;
  if (t_hi >= t_lo) {
    k_hi = min(min(length, start + t_hi + 1), min(maxb * bs, k_lo + split_keys));
    if (window > 0) k_lo = max(k_lo, start + t_lo - window + 1);
  }
  const int kt0 = (k_lo / KT) * KT;
  const int n_tiles = k_hi > k_lo ? (k_hi - kt0 + KT - 1) / KT : 0;

  auto row_at = [&](int r) { return ((int64_t)n * T_ + (r0 + r) / group) * H + g * group +
                                    (r0 + r) % group; };
  if (n_tiles == 0) {  // an empty partial: past the length, before the window, or no live row
    for (int idx = threadIdx.x; idx < rows * D; idx += kDecThreads) {
      const int64_t at = row_at(idx / D) * splits + split;
      part_acc[at * D + idx % D] = 0.f;
      if (idx % D == 0) {
        part_ml[at * 2] = kNegInf;
        part_ml[at * 2 + 1] = 0.f;
      }
    }
    return;
  }

  // a tile spans nslots table slots: looked up kDecStages tiles ahead into a ring
  const int nslots = bs >= KT ? 1 : KT / bs;
  auto lookup = [&](int tile) {
    if (tile >= n_tiles) return;
    const int slot0 = (kt0 + tile * KT) >> bs_shift;
    for (int i = threadIdx.x; i < nslots; i += kDecThreads)
      blk_s[(tile % S_) * KT + i] =
          (slot0 + i) * bs < k_hi ? tables[(int64_t)n * maxb + slot0 + i] : -1;
  };
  // tile `tile` into ring buffer tile % S_; one commit group either way
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      const int buf = tile % S_;
      const int k0 = kt0 + tile * KT;
      const uint32_t kb = smem_u32(k_s + buf * KT * LDK);
      const uint32_t vb = smem_u32(v_s + buf * KT * LDK);
      const int* slots = blk_s + buf * KT - (k0 >> bs_shift);
      for (int idx = threadIdx.x; idx < KT * (D / E); idx += kDecThreads) {
        const int j = idx / (D / E);
        const int c = idx % (D / E);
        const int kpos = k0 + j;
        const int blk = slots[kpos >> bs_shift];
        const bool ok = kpos >= k_lo && kpos < k_hi && blk >= 0;
        const int64_t at =
            ok ? ((((int64_t)blk * KV + g) << bs_shift) + (kpos & (bs - 1))) * D + c * E : 0;
        const uint32_t dst = (j * LDK + c * E) * (uint32_t)sizeof(T);
        cp_async16(kb + dst, kpool + at, ok);
        cp_async16(vb + dst, vpool + at, ok);
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < S_; ++t) lookup(t);
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    const int t = (r0 + r) / group;
    rq_s[r] = r < rows && t < live_tok ? start + t : -1;
    rs_s[r] = alibi != nullptr && r < rows ? alibi[g * group + (r0 + r) % group] * kLog2e : 0.f;
  }
  for (int idx = threadIdx.x; idx < R * D; idx += kDecThreads) {
    const int r = idx / D;
    const int d = idx % D;
    q_s[r * QROW + (d / DP) * LDQ + d % DP] = r < rows ? to_float(q[row_at(r) * D + d]) : 0.f;
  }
  __syncthreads();  // the slots of tiles 0 .. S_ - 1 are visible
  for (int t = 0; t < S_ - 1; ++t) issue(t);

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[r][dd] = 0.f;
  }
  const int j = lane % KW;
  const int part = lane / KW;
  for (int t = 0; t < n_tiles; ++t) {
    // groups committed: S_ - 1 + t, the last S_ - 2 of them tiles t + 1 .. t + S_ - 2
    cp_async_wait<S_ - 2>();
    __syncthreads();  // tile t has landed; tile t - 1 is read; tile t + S_ - 1's slots are visible
    issue(t + S_ - 1);  // into the buffer of tile t - 1
    lookup(t + S_);     // into the slots of tile t, issued S_ - 1 iterations ago
    const int kw0 = kt0 + t * KT + warp * KW;  // the warp's first key
    if (kw0 >= k_hi || kw0 + KW <= k_lo) continue;
    const T* kt = k_s + (t % S_) * KT * LDK;
    const T* vt = v_s + (t % S_) * KT * LDK;
    const int kpos = kw0 + j;

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < VP; ++c) {
      float kf[E];
      load_vals<T, E>(kt + (warp * KW + j) * LDK + part * DP + c * E, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const float* qr = q_s + r * QROW + part * LDQ + c * E;
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            s[r] = fmaf(qv.x, kf[e], fmaf(qv.y, kf[e + 1],
                        fmaf(qv.z, kf[e + 2], fmaf(qv.w, kf[e + 3], s[r]))));
          }
        }
      }
    }
    const bool kin = kpos >= k_lo && kpos < k_hi;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;  // block-uniform
      float x = s[r];
#pragma unroll
      for (int o = KW; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      const int qp = rq_s[r];
      const bool ok = kin && qp >= 0 && kpos <= qp && (window <= 0 || kpos > qp - window);
      x = ok ? fmaf(rs_s[r], (float)kpos, x * scale_log2) : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = 1; o < KW; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float p = ok ? exp2f(x - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 1; o < KW; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const float corr = exp2f(m[r] - m_new);
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[r][dd] *= corr;
#pragma unroll
      for (int jj = 0; jj < KW; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        float vf[DPL];
        load_vals<T, DPL>(vt + (warp * KW + jj) * LDK + lane * DPL, vf);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[r][dd] = fmaf(pj, vf[dd], acc[r][dd]);
      }
    }
  }

  // the four warps' (m, l, acc) merged through shared memory (over the tiles)
  cp_async_wait_all();
  __syncthreads();
  float* m_s = reinterpret_cast<float*>(dec_smem);  // [4][R]
  float* l_s = m_s + 4 * R;                          // [4][R]
  float* a_s = l_s + 4 * R;                          // [4][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) continue;
    if (lane == 0) {
      m_s[warp * R + r] = m[r];
      l_s[warp * R + r] = l[r];
    }
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) a_s[(warp * R + r) * D + lane * DPL + dd] = acc[r][dd];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * D; idx += kDecThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, m_s[w * R + r]);
    float a = 0.f, lw = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = exp2f(m_s[w * R + r] - mx);
      a = fmaf(a_s[(w * R + r) * D + d], f, a);
      lw = fmaf(l_s[w * R + r], f, lw);
    }
    const int64_t at = row_at(r) * splits + split;
    part_acc[at * D + d] = a;
    if (d == 0) {
      part_ml[at * 2] = mx;
      part_ml[at * 2 + 1] = lw;
    }
  }
}

// One block per row (sequence, token, q head): out = sum_s acc_s 2^(m_s - M)
// / sum_s l_s 2^(m_s - M), M the row's largest m; a row whose splits are all
// empty (l = 0) and a row at t >= n_tokens are exact zeros.
template <typename T>
__global__ void paged_decode_merge_kernel(const float* __restrict__ part_ml,
                                          const float* __restrict__ part_acc,
                                          const int* __restrict__ n_tokens, T* __restrict__ out,
                                          int T_, int H, int D, int splits) {
  const int64_t row = blockIdx.x;
  const int n = (int)(row / ((int64_t)T_ * H));
  const int t = (int)((row / H) % T_);
  const float* ml = part_ml + row * splits * 2;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float den = 0.f;
  for (int s = 0; s < splits; ++s) den = fmaf(ml[2 * s + 1], exp2f(ml[2 * s] - mx), den);
  const float inv = t < n_tokens[n] && den > 0.f ? 1.f / den : 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < splits; ++s)
      num = fmaf(part_acc[(row * splits + s) * D + d], exp2f(ml[2 * s] - mx), num);
    out[row * D + d] = from_float<T>(num * inv);
  }
}

template <typename T, int D, int R>
cudaError_t launch_decode_rows(const void* q, const void* kpool, const void* vpool,
                               const int* tables, const int* lengths, const int* start_pos,
                               const int* n_tokens, const float* alibi, float* ml, float* acc,
                               int N, int T_, int H, int KV, int bs, int maxb, float scale,
                               int window, int split_keys, int splits, cudaStream_t stream) {
  const int row_blocks = (H / KV * T_ + R - 1) / R;
  if ((int64_t)KV * row_blocks > 65535 || N > 65535) return cudaErrorInvalidValue;
  constexpr int smem = decode_smem<T, D, R>();
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, D, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // all of the SM's shared memory for blocks: as many as fit stay resident
  err = cudaFuncSetAttribute(paged_decode_kernel<T, D, R>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int bs_shift = 0;
  while ((1 << bs_shift) < bs) ++bs_shift;
  dim3 grid(splits, KV * row_blocks, N);
  paged_decode_kernel<T, D, R><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool), static_cast<const T*>(vpool),
      tables, lengths, start_pos, n_tokens, alibi, ml, acc, T_, H, KV, bs_shift, maxb,
      row_blocks, split_keys, scale * kLog2e, window);
  return cudaGetLastError();
}

// a (sequence, kv head) of at most kDecSmallRows rows takes the small kernel
template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* kpool, const void* vpool, const int* tables,
                          const int* lengths, const int* start_pos, const int* n_tokens,
                          const float* alibi, float* ml, float* acc, int N, int T_, int H, int KV,
                          int bs, int maxb, float scale, int window, int split_keys, int splits,
                          cudaStream_t stream) {
  if (H / KV * T_ <= kDecSmallRows)
    return launch_decode_rows<T, D, kDecSmallRows>(q, kpool, vpool, tables, lengths, start_pos,
                                                   n_tokens, alibi, ml, acc, N, T_, H, KV, bs,
                                                   maxb, scale, window, split_keys, splits,
                                                   stream);
  return launch_decode_rows<T, D, decode_rows<D>()>(q, kpool, vpool, tables, lengths, start_pos,
                                                    n_tokens, alibi, ml, acc, N, T_, H, KV, bs,
                                                    maxb, scale, window, split_keys, splits,
                                                    stream);
}

template <typename T>
cudaError_t launch_decode_dtype(int head_dim, const void* q, const void* kpool,
                                const void* vpool, const int* tables, const int* lengths,
                                const int* start_pos, const int* n_tokens, const float* alibi,
                                float* ml, float* acc, int N, int T_, int H, int KV, int bs,
                                int maxb, float scale, int window, int split_keys, int splits,
                                cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_decode<T, 32>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi,
                                  ml, acc, N, T_, H, KV, bs, maxb, scale, window, split_keys,
                                  splits, stream);
    case 64:
      return launch_decode<T, 64>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi,
                                  ml, acc, N, T_, H, KV, bs, maxb, scale, window, split_keys,
                                  splits, stream);
    case 128:
      return launch_decode<T, 128>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi,
                                   ml, acc, N, T_, H, KV, bs, maxb, scale, window, split_keys,
                                   splits, stream);
    case 256:
      return launch_decode<T, 256>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi,
                                   ml, acc, N, T_, H, KV, bs, maxb, scale, window, split_keys,
                                   splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_merge(const float* ml, const float* acc, const int* n_tokens, void* out, int N,
                         int T_, int H, int D, int splits, cudaStream_t stream) {
  const int64_t rows = (int64_t)N * T_ * H;
  if (rows > 0x7fffffff) return cudaErrorInvalidValue;
  paged_decode_merge_kernel<T><<<(unsigned)rows, D < 128 ? D : 128, 0, stream>>>(
      ml, acc, n_tokens, static_cast<T*>(out), T_, H, D, splits);
  return cudaGetLastError();
}

int smem_bytes(int head_dim, int tile_keys) {
  return (kRows * head_dim + tile_keys * (head_dim + 1) + tile_keys * head_dim) * (int)sizeof(float);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* kpool, const void* vpool, const int* tables,
                   const int* lengths, const int* start_pos, const int* n_tokens,
                   const float* alibi, void* out, int N, int T_, int H, int KV, int bs,
                   int maxb, float scale, int window, cudaStream_t stream) {
  const int group = H / KV;
  const int heads_per_block = group < 32 ? group : 32;
  const int q_tile = kRows / heads_per_block > 0 ? kRows / heads_per_block : 1;
  const int tile_keys = bs < 32 ? 32 : bs;
  const int smem = smem_bytes(DH, tile_keys);
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + q_tile - 1) / q_tile, H / heads_per_block, N);
  paged_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool), static_cast<const T*>(vpool),
      tables, lengths, start_pos, n_tokens, alibi, static_cast<T*>(out), T_, H, KV, bs, maxb,
      heads_per_block, q_tile, tile_keys, scale, window);
  return cudaGetLastError();
}

int tc_smem_bytes(int head_dim) { return (kTcRows + 4 * kTcKeys) * (head_dim + 8) * 2; }

template <typename T, int DH>
cudaError_t launch_tc(const void* q, const void* kpool, const void* vpool, const int* tables,
                      const int* lengths, const int* start_pos, const int* n_tokens,
                      const float* alibi, void* out, int N, int T_, int H, int KV, int bs,
                      int maxb, float scale, int window, cudaStream_t stream) {
  const int q_tile = kTcRows / (H / KV);
  const int smem = tc_smem_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(paged_prefill_tc_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + q_tile - 1) / q_tile, KV, N);
  paged_prefill_tc_kernel<T, DH><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool), static_cast<const T*>(vpool),
      tables, lengths, start_pos, n_tokens, alibi, static_cast<T*>(out), T_, H, KV, bs, maxb,
      q_tile, scale * kLog2e, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int head_dim, const void* q, const void* kpool, const void* vpool,
                         const int* tables, const int* lengths, const int* start_pos,
                         const int* n_tokens, const float* alibi, void* out, int N, int T_,
                         int H, int KV, int bs, int maxb, float scale, int window,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi, out, N,
                           T_, H, KV, bs, maxb, scale, window, stream);
    case 64:
      return launch<T, 64>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi, out, N,
                           T_, H, KV, bs, maxb, scale, window, stream);
    case 128:
      return launch<T, 128>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi, out, N,
                            T_, H, KV, bs, maxb, scale, window, stream);
    case 256:
      return launch<T, 256>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi, out, N,
                            T_, H, KV, bs, maxb, scale, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_tc_dtype(int head_dim, const void* q, const void* kpool, const void* vpool,
                            const int* tables, const int* lengths, const int* start_pos,
                            const int* n_tokens, const float* alibi, void* out, int N, int T_,
                            int H, int KV, int bs, int maxb, float scale, int window,
                            cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_tc<T, 64>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi, out,
                              N, T_, H, KV, bs, maxb, scale, window, stream);
    case 128:
      return launch_tc<T, 128>(q, kpool, vpool, tables, lengths, start_pos, n_tokens, alibi, out,
                               N, T_, H, KV, bs, maxb, scale, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs; the wrapper checks it against the
// card's limit before launching.
int paged_attention_smem_bytes(int head_dim, int block_size) {
  return smem_bytes(head_dim, block_size < 32 ? 32 : block_size);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  All tensors contiguous on
// one device: q/out [N, T, H, Dh]; pools [NB, KV, bs, Dh]; tables [N, maxb]
// and lengths/start_pos/n_tokens [N] int32; alibi [H] float32 or null.
// window <= 0 means no sliding window.  Returns a cudaError_t (0 = launched).
int paged_attention_launch(int dtype, const void* q, const void* kpool, const void* vpool,
                           const void* tables, const void* lengths, const void* start_pos,
                           const void* n_tokens, const void* alibi, void* out, int N, int T_,
                           int H, int KV, int head_dim, int block_size, int maxb, float scale,
                           int window, void* stream) {
  if (N <= 0 || T_ <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const int group = H / KV;
  if (group > 32 && group % 32 != 0) return cudaErrorInvalidValue;
  if (block_size <= 0 || block_size > 32 * kMaxKeysPerLane) return cudaErrorInvalidValue;
  if (block_size < 32 ? 32 % block_size != 0 : block_size % 32 != 0) return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* sp = static_cast<const int*>(start_pos);
  const int* nt = static_cast<const int*>(n_tokens);
  const float* al = static_cast<const float*>(alibi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dtype<float>(head_dim, q, kpool, vpool, tb, ln, sp, nt, al, out, N, T_, H, KV,
                                 block_size, maxb, scale, window, s);
    case 1:
      return launch_dtype<__nv_bfloat16>(head_dim, q, kpool, vpool, tb, ln, sp, nt, al, out, N, T_,
                                         H, KV, block_size, maxb, scale, window, s);
    case 2:
      return launch_dtype<__half>(head_dim, q, kpool, vpool, tb, ln, sp, nt, al, out, N, T_, H, KV,
                                  block_size, maxb, scale, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tensor-core chunked-prefill kernel: the same arguments; dtype 1
// (bfloat16) or 2 (float16), head_dim 64 or 128, a GQA group of at most 64
// q heads, block_size a power of two; all tensors 16-byte aligned.
int paged_prefill_tc_launch(int dtype, const void* q, const void* kpool, const void* vpool,
                            const void* tables, const void* lengths, const void* start_pos,
                            const void* n_tokens, const void* alibi, void* out, int N, int T_,
                            int H, int KV, int head_dim, int block_size, int maxb, float scale,
                            int window, void* stream) {
  if (N <= 0 || T_ <= 0 || KV <= 0 || H % KV != 0 || H / KV > kTcRows) return cudaErrorInvalidValue;
  if (block_size <= 0 || (block_size & (block_size - 1)) != 0) return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* sp = static_cast<const int*>(start_pos);
  const int* nt = static_cast<const int*>(n_tokens);
  const float* al = static_cast<const float*>(alibi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_tc_dtype<__nv_bfloat16>(head_dim, q, kpool, vpool, tb, ln, sp, nt, al, out,
                                            N, T_, H, KV, block_size, maxb, scale, window, s);
    case 2:
      return launch_tc_dtype<__half>(head_dim, q, kpool, vpool, tb, ln, sp, nt, al, out, N, T_,
                                     H, KV, block_size, maxb, scale, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The split-K decode kernel: the same inputs as paged_attention_launch (any
// T, but the wrapper sends T < 16); writes the partials ml [N, T, H, splits,
// 2] (m in log2 units, l) and acc [N, T, H, splits, head_dim] float32 for
// paged_decode_merge_launch.  split_keys: keys a split, a multiple of 64 and
// of block_size; splits: at least 1 (keys past splits * split_keys are not
// read).
int paged_decode_launch(int dtype, const void* q, const void* kpool, const void* vpool,
                        const void* tables, const void* lengths, const void* start_pos,
                        const void* n_tokens, const void* alibi, void* ml, void* acc, int N,
                        int T_, int H, int KV, int head_dim, int block_size, int maxb,
                        float scale, int window, int split_keys, int splits, void* stream) {
  if (N <= 0 || T_ <= 0 || KV <= 0 || H % KV != 0 || splits <= 0) return cudaErrorInvalidValue;
  if (block_size <= 0 || (block_size & (block_size - 1)) != 0) return cudaErrorInvalidValue;
  if (split_keys <= 0 || split_keys % kDecodeMaxKeys != 0 || split_keys % block_size != 0)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* sp = static_cast<const int*>(start_pos);
  const int* nt = static_cast<const int*>(n_tokens);
  const float* al = static_cast<const float*>(alibi);
  float* m = static_cast<float*>(ml);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_decode_dtype<float>(head_dim, q, kpool, vpool, tb, ln, sp, nt, al, m, a, N,
                                        T_, H, KV, block_size, maxb, scale, window, split_keys,
                                        splits, s);
    case 1:
      return launch_decode_dtype<__nv_bfloat16>(head_dim, q, kpool, vpool, tb, ln, sp, nt, al, m,
                                                a, N, T_, H, KV, block_size, maxb, scale, window,
                                                split_keys, splits, s);
    case 2:
      return launch_decode_dtype<__half>(head_dim, q, kpool, vpool, tb, ln, sp, nt, al, m, a, N,
                                         T_, H, KV, block_size, maxb, scale, window, split_keys,
                                         splits, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The merge: out [N, T, H, head_dim] in dtype from the decode kernel's
// partials; rows at t >= n_tokens[n] are zeros.
int paged_decode_merge_launch(int dtype, const void* ml, const void* acc, const void* n_tokens,
                              void* out, int N, int T_, int H, int head_dim, int splits,
                              void* stream) {
  if (N <= 0 || T_ <= 0 || H <= 0 || splits <= 0 || head_dim <= 0 || head_dim > 1024)
    return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(ml);
  const float* a = static_cast<const float*>(acc);
  const int* nt = static_cast<const int*>(n_tokens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_merge<float>(m, a, nt, out, N, T_, H, head_dim, splits, s);
    case 1:
      return launch_merge<__nv_bfloat16>(m, a, nt, out, N, T_, H, head_dim, splits, s);
    case 2:
      return launch_merge<__half>(m, a, nt, out, N, T_, H, head_dim, splits, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
