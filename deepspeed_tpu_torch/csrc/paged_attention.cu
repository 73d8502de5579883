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
// Two kernels, chosen by one shape rule in ops/attention/paged.py (no
// fallback between them): bf16/fp16 chunks of T >= 16 tokens with head_dim 64
// or 128 and a GQA group of at most 64 go to the tensor-core prefill kernel,
// everything else (decode, fp32, head_dim 32 or 256) to the CUDA-core kernel.
//
// CUDA-core kernel.  What bounds it on the H100: at decode (T = 1) every live
// K/V byte is read once and used for two multiply-adds per element, so the
// kernel is bound by device memory (live K/V bytes / 3.35 TB/s).  The design
// follows from that:
//   - one block per (sequence, group of q heads sharing one kv head, tile of
//     query tokens), so the K/V tiles a block stages in shared memory feed
//     every q head of its GQA group (Mistral: 4) and every query token of the
//     tile: K/V are read from device memory once per kv head at decode;
//   - the TPU kernel's sequential grid axis over table slots, which carried
//     the online-softmax state in VMEM, becomes a loop inside the block over
//     the live key tiles only: the loop starts at the first tile inside the
//     window and stops at the last key any row of the tile may see, so table
//     slots past lengths[n] (padding that points at the trash block) are
//     never read;
//   - the softmax state (running max, running sum, fp32 output accumulator)
//     lives in registers of the warp that owns the row.
//   - K/V rows come in as 16-byte loads, several in flight per thread, and
//     a tile's table slots are looked up once into shared memory.
// It uses plain CUDA-core arithmetic and no asynchronous copies; split-K
// decode with an lse-weighted merge is left for later work.
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

}  // extern "C"
