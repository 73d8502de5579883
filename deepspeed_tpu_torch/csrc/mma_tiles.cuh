// Tensor-core building blocks shared by the hand-written Hopper kernels
// (flash_attention.cu, paged_attention.cu): cp.async copies with zero-fill,
// ldmatrix fragment loads from shared tiles whose rows are padded to D + 8
// elements (so ldmatrix's eight 16-byte rows hit distinct banks),
// mma.sync.m16n8k16 with fp32 accumulators, and the repacking of an
// accumulator tile into the A operand of the next product.
//
// Fragment layout of mma.m16n8k16 (PTX ISA): lane l holds accumulator
// elements (row l/4, columns 2 (l%4) and + 1) in c0 c1 and row l/4 + 8 in
// c2 c3; the four lanes of a quad (lanes 4i..4i+3) share a row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !live (src must still be valid)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Byte offsets into a shared tile of row stride kLd elements, for the lane's
// ldmatrix address.  a_frag: the A fragment (16 rows x 16 k) at (row0, k0) ->
// r[0..3] = a0a1, a2a3, a4a5, a6a7.  b_frag: B of two n8 tiles stored n-major
// ([n][k], k contiguous) at (n0, k0) -> {r[0], r[1]} for n0, {r[2], r[3]} for
// n0 + 8.  bt_frag: the same stored k-major ([k][n], n contiguous), loaded
// with .trans.
template <int kLd>
__device__ __forceinline__ uint32_t a_frag(int lane, int row0, int k0) {
  return ((row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + k0 + (lane >> 4) * 8) * 2;
}

template <int kLd>
__device__ __forceinline__ uint32_t b_frag(int lane, int n0, int k0) {
  return ((n0 + (lane & 7) + (lane >> 4) * 8) * kLd + k0 + ((lane >> 3) & 1) * 8) * 2;
}

template <int kLd>
__device__ __forceinline__ uint32_t bt_frag(int lane, int k0, int n0) {
  return ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + n0 + (lane >> 4) * 8) * 2;
}

// d += a (16x16, row) * b (16x8, col), fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two fp32 values rounded (to nearest even) into one register of T, lo first
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  } else {
    __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  }
}

// The A fragment of k-step kk from the accumulators of n8 tiles 2kk and 2kk+1:
// a score tile becomes the left operand of the next product without shared
// memory (c0c1 -> a0a1, c2c3 -> a2a3 of tile 2kk, then of tile 2kk + 1).
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// max / sum over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
