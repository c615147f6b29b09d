// Hopper building blocks of a 3xTF32 product on the tensor cores: 16-byte
// (and 4-byte) cp.async copies into a ring of shared-memory stages, the
// shared-memory descriptor of a K-major operand tile in the 128-byte swizzle,
// the split of an f32 value into two TF32 parts, and wgmma.mma_async
// m64nNk8 TF32 (N = 128, 64, 16) with A from registers and f32 accumulators.
// Four products are built from them: the input projection of the recurrent
// kernels (bilstm_layer.cuh::proj_kernel, N = 128), FreqLstm's output
// projection (freq_lstm.cu::out_parts_kernel, N = 128), and the wide step
// loop's h.W_hh (bilstm_layer.cuh::wide_steps_kernel, N = 64) and
// d_pre.W_hh^T (wide_bwd_kernel, N = 16). They are the ones
// csrc/decode_solve.cu's split_product_kernel runs, which keeps its own copy.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared, asynchronously (through L1); src_bytes = 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The shared-memory matrix descriptor of a K-major operand tile in the
// 128-byte swizzle (a row of 32 f32 is one 128-byte swizzle row, chunk c of
// row r at c ^ (r % 8)): start address, (unused) leading offset, 1024 bytes
// from one group of 8 rows to the next, swizzle mode 1. The tile starts on a
// 1024-byte boundary; a k step of 8 f32 is 32 bytes further on, + 2 here.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// x as its TF32 value's bits, rounded to nearest (ties away from zero). The
// tensor cores ignore the 13 low bits of an f32 operand, which truncates it.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}
// The same for a finite x in two integer instructions: add half a TF32 unit to
// the magnitude's bits and clear the 13 low ones (cvt.rna's result for every
// finite x; cvt.rna also guards Inf and NaN, four instructions in all).
__device__ __forceinline__ uint32_t tf32_bits_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// acc (64 x 128 of a warpgroup, f32) += A (64 x 8, this thread's 4 TF32 values
// in registers) . B (128 x 8)^T in TF32. A warpgroup's accumulators: warp w
// holds rows 16 w .. 16 w + 15, lane l rows l / 4 and l / 4 + 8 of them,
// columns 8 j + 2 (l % 4), + 1 for j < 16: acc[4 j], acc[4 j + 1] in the first
// row, acc[4 j + 2], acc[4 j + 3] in the second.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&acc)[64], const uint32_t (&a)[4],
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31]),
        "+f"(acc[32]), "+f"(acc[33]), "+f"(acc[34]), "+f"(acc[35]),
        "+f"(acc[36]), "+f"(acc[37]), "+f"(acc[38]), "+f"(acc[39]),
        "+f"(acc[40]), "+f"(acc[41]), "+f"(acc[42]), "+f"(acc[43]),
        "+f"(acc[44]), "+f"(acc[45]), "+f"(acc[46]), "+f"(acc[47]),
        "+f"(acc[48]), "+f"(acc[49]), "+f"(acc[50]), "+f"(acc[51]),
        "+f"(acc[52]), "+f"(acc[53]), "+f"(acc[54]), "+f"(acc[55]),
        "+f"(acc[56]), "+f"(acc[57]), "+f"(acc[58]), "+f"(acc[59]),
        "+f"(acc[60]), "+f"(acc[61]), "+f"(acc[62]), "+f"(acc[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
// acc (64 x 64, f32) = A (64 x 8) . B (64 x 8)^T in TF32, + acc where
// scale_d != 0. Accumulators as m64n128k8's, j < 8.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&acc)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// acc (64 x 16, f32) = A (64 x 8) . B (16 x 8)^T in TF32, + acc where
// scale_d != 0. Accumulators as m64n128k8's, j < 2.
__device__ __forceinline__ void wgmma_m64n16k8_tf32_rs(float (&acc)[8], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

}  // namespace tf32mma
