// PCA decode + transform build + deformation solve: coefficients (W, Ks),
// (W, Kr) -> free-vertex solution (W, 3, NF), with T = exp(skew(r)) * S built
// from the 9 decoded planes of a triangle. Two bodies, picked by the caller
// from the template's equation table (ops/decode_solve.py::prep_consts):
//
//   delta (identity tables): x[w][d] = x0[d] + sum_c sum_t (T[w][d][c](t) - T0[3d+c](t)) P[c][t]
//   full (any table):        x[w][d] = x0f[d] + sum_c sum_t (T[w][d][c](t) - T0[3d+c](t)) Pt[c][t]
//
// The full body's function is sum_c sum_e T[w][d][c](src(e)) P[c][e], where
// equation e reads triangle src(e), or the identity where src(e) < 0 (a target
// triangle with no source). The solve is linear in T, so the host folds the
// table into the constants once per template, in float64
// (ops/decode_solve.py::prep_full_consts): Pt[c][t] = sum over the equations
// e of triangle t of P[c][e], x_id[d] = sum over the equations with no source
// of P[d][e], and x0f = T0 . Pt + x_id. What runs on the card is then the delta
// body's structure over the triangles: no gather, one decode per triangle.
//
// Replaces sdfa_tpu/ops/pallas_decode_solve.py:_kernel_delta (the delta body,
// sdfa_decode_solve) and :_kernel (the full body, sdfa_decode_solve_full),
// both behind its pallas_call (entry points decode_solve_free /
// decode_solve_fused). The TPU kernel takes identity tables only; on a
// correspondence table the JAX package decodes to planes and takes solve_fn's
// float32 product over the equations, which is the full body's function here.
//
// What bounds it on the H100: the solve is a product of M = 3W rows, N = NF =
// 1261 columns and K = 3T' (T' = 9976 triangles padded to 10112): 2 x 9 x
// 10112 x 1261 = 0.23 GFLOP per window. The decode adds 2 x 1050 FLOP per
// (window, triangle) plus 9 transcendentals. In f32 outside the tensor cores
// (67 TFLOP/s) the product alone is 0.9 ms at 256 windows. The delta form
// exists so that a short mantissa is enough: the TPU kernel multiplies dT by P
// in one bf16 pass with f32 sums. Here the delta product runs on the tensor
// cores in TF32 (495 TFLOP/s), 7 x closer to the f32 result than bf16 on the
// same inputs. The full body is held to the float32 product over the
// equations (the TPU kernel's three bf16 passes): 3xTF32 (hi.hi + hi.lo +
// lo.hi with x = hi + lo, each part a TF32 value, 22 bits together) on the
// same tensor cores, three times the delta product's operations: 0.30 ms at
// 216 windows, bound by operations.
//
// Design, three kernels a body:
//
// 1. decode_delta_kernel decodes each (window, triangle) exactly once, in f32
//    (sinf/cosf/sqrtf, no fast-math), and writes dT (W, 9, T') = T - T0,
//    which viewed as (3W, 3T') is A, row-major with K contiguous: for the
//    delta body each value rounded to TF32 (cvt.rna; the tensor cores would
//    truncate), for the full body in f32.
// 2. The product C = A . B^T on wgmma.mma_async m64n128k8 TF32 with f32
//    accumulators in registers. TF32 wgmma takes both operands K-major only,
//    so the constant P is kept transposed, N padded to 128, rounded or split
//    to TF32 on the host once: p_t (npad, 3T') for the delta body, b_t (2,
//    npad, 3T') = Pt's hi and lo parts for the full body. A block of two
//    warpgroups owns a 128 x 128 tile (64 rows a warpgroup) over one part of
//    K; 16-byte cp.async copies fill a ring of shared-memory stages of 32 k
//    (one 128-byte swizzle row per matrix row, chunk c of row r at c ^ (r %
//    8)). solve_product_kernel (delta) stages A and B and issues from shared
//    memory, two blocks a multiprocessor so that one's barrier and copy
//    requests hide behind the other's wgmma. split_product_kernel (full)
//    stages dT in f32 and Pt's two strips, splits its A fragments in
//    registers and issues the three passes with A from registers: two A and
//    two B strips a k tile, not a [hi | hi | lo] x [hi | lo | hi]
//    concatenation, so that a k tile stages 48 KB for three passes. K is
//    split over gridDim.z so that the blocks fill the card (the caller sizes
//    the split from each kernel's occupancy); blocks that run together walk
//    K together and share their strips through L2. Each block writes its
//    partial tile to scratch.
// 3. solve_sum_kernel adds the K parts in part order, then x0[m % 3] (x0f for
//    the full body) in f32. No atomics: results repeat bit for bit.
//
// Tiling the output over NF in one fused kernel would redo the decode and the
// trig in every NF tile. The scratch dT costs one write and a read through L2
// (364 KB a window), far below the product's time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DT = 128;    // triangles per decode block (one per thread)
#ifndef SDFA_DECODE_WR
#define SDFA_DECODE_WR 4
#endif
constexpr int WR = SDFA_DECODE_WR;  // windows per decode block: one read of the bases serves all
constexpr int KMAX = 256;  // largest PCA coefficient count

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero. The
// tensor cores ignore the 13 low bits of an f32 operand, which truncates it:
// twice the error, and biased. An operand rounded here loses nothing more there.
__device__ __forceinline__ float round_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// The coefficients of windows w0 .. w0 + WR - 1 into shared memory, zero past W.
__device__ __forceinline__ void load_coefs(float (&cs)[WR][KMAX], float (&cr)[WR][KMAX],
                                           const float* __restrict__ coef_s,
                                           const float* __restrict__ coef_r, int w0, int W,
                                           int Ks, int Kr) {
  for (int i = threadIdx.x; i < WR * KMAX; i += DT) {
    const int r = i / KMAX, k = i % KMAX, w = w0 + r;
    cs[r][k] = (w < W && k < Ks) ? coef_s[(size_t)w * Ks + k] : 0.0f;
    cr[r][k] = (w < W && k < Kr) ? coef_r[(size_t)w * Kr + k] : 0.0f;
  }
}

// d[r][k]: the PCA product of plane k of window w0 + r at triangle t (6 scale,
// 3 rotation), without the means
__device__ __forceinline__ void decode_planes(const float (&cs)[WR][KMAX],
                                              const float (&cr)[WR][KMAX],
                                              const float* __restrict__ basis_s,
                                              const float* __restrict__ basis_r, int t, int Tp,
                                              int Ks, int Kr, float (&d)[WR][9]) {
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int k = 0; k < 9; ++k) d[r][k] = 0.0f;
  for (int i = 0; i < Ks; ++i) {
    float b[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = basis_s[((size_t)i * 6 + k) * Tp + t];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const float c = cs[r][i];
#pragma unroll
      for (int k = 0; k < 6; ++k) d[r][k] += c * b[k];
    }
  }
  for (int i = 0; i < Kr; ++i) {
    float b[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) b[k] = basis_r[((size_t)i * 3 + k) * Tp + t];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const float c = cr[r][i];
#pragma unroll
      for (int k = 0; k < 3; ++k) d[r][6 + k] += c * b[k];
    }
  }
}

// m[k]: the mean of plane k at triangle t
__device__ __forceinline__ void load_means(const float* __restrict__ means_s,
                                           const float* __restrict__ means_r, int t, int Tp,
                                           float (&m)[9]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) m[k] = means_s[(size_t)k * Tp + t];
#pragma unroll
  for (int k = 0; k < 3; ++k) m[6 + k] = means_r[(size_t)k * Tp + t];
}

// tv[3 i + k] = T[i][k] of T = exp(skew(r)) * S, from a triangle's 9 planes p
__device__ __forceinline__ void transform_entries(const float (&p)[9], float (&tv)[9]) {
  // symmetric scale S (+I on the diagonal)
  const float s[3][3] = {{p[0] + 1.0f, p[1], p[2]},
                         {p[1], p[3] + 1.0f, p[4]},
                         {p[2], p[4], p[5] + 1.0f}};
  // rotation R = cos(th) I + sin(th) K + (1 - cos(th)) a a^T, w = (-p8, p7, -p6)
  const float w0v = -p[8], w1v = p[7], w2v = -p[6];
  const float theta = sqrtf(w0v * w0v + w1v * w1v + w2v * w2v);
  const bool small = theta < 1e-6f;
  const float inv_t = small ? 0.0f : 1.0f / theta;
  const float a0 = w0v * inv_t, a1 = w1v * inv_t, a2 = w2v * inv_t;
  const float st = sinf(theta), ct = cosf(theta), omc = 1.0f - ct;
  float rot[3][3] = {{ct + omc * a0 * a0, -st * a2 + omc * a0 * a1, st * a1 + omc * a0 * a2},
                     {st * a2 + omc * a1 * a0, ct + omc * a1 * a1, -st * a0 + omc * a1 * a2},
                     {-st * a1 + omc * a2 * a0, st * a0 + omc * a2 * a1, ct + omc * a2 * a2}};
  if (small) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) rot[i][k] = i == k ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      tv[3 * i + k] = rot[i][0] * s[0][k] + rot[i][1] * s[1][k] + rot[i][2] * s[2][k];
}

// dt (W, 9, T') = T - T0 per (window, triangle), the product's A operand: each
// value rounded to TF32 for the delta body (TF32), in f32 for the full body,
// whose product splits it. grid (ceil(W / WR), T' / DT): the windows walk
// fastest, so the blocks that run together read the same triangles' bases and
// each basis value comes from device memory once.
template <bool TF32>
__global__ void __launch_bounds__(DT)
decode_delta_kernel(const float* __restrict__ coef_s, const float* __restrict__ coef_r,
                    const float* __restrict__ basis_s, const float* __restrict__ means_s,
                    const float* __restrict__ basis_r, const float* __restrict__ means_r,
                    const float* __restrict__ t0, float* __restrict__ dt,
                    int W, int Ks, int Kr, int Tp) {
  __shared__ float cs[WR][KMAX];
  __shared__ float cr[WR][KMAX];
  const int w0 = blockIdx.x * WR;
  load_coefs(cs, cr, coef_s, coef_r, w0, W, Ks, Kr);
  __syncthreads();
  const int t = blockIdx.y * DT + threadIdx.x;
  if (t >= Tp) return;
  float d[WR][9];
  decode_planes(cs, cr, basis_s, basis_r, t, Tp, Ks, Kr, d);
  float m[9], t0v[9];
  load_means(means_s, means_r, t, Tp, m);
#pragma unroll
  for (int e = 0; e < 9; ++e) t0v[e] = t0[(size_t)e * Tp + t];
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    const int w = w0 + r;
    if (w >= W) break;
    float p[9], tv[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = d[r][k] + m[k];
    transform_entries(p, tv);
    float* out = dt + (size_t)w * 9 * Tp + t;
#pragma unroll
    for (int e = 0; e < 9; ++e)
      out[(size_t)e * Tp] = TF32 ? round_tf32(tv[e] - t0v[e]) : tv[e] - t0v[e];
  }
}

// --- the product: part[z] (M, npad) = A (M, K-part z) . Bt (npad, K-part z)^T ----

constexpr int BM = 128, BN = 128;   // a block's output tile: 64 rows a warpgroup
constexpr int BK = 32;              // k per stage: 32 f32 = one 128-byte swizzle row
constexpr int GT = 256;             // two warpgroups
#ifndef SDFA_SOLVE_STAGES
#define SDFA_SOLVE_STAGES 3
#endif
#ifndef SDFA_SOLVE_MINB
#define SDFA_SOLVE_MINB 2
#endif
constexpr int STAGES = SDFA_SOLVE_STAGES;  // ring depth; STAGES - 1 copies in flight
constexpr int MINB = SDFA_SOLVE_MINB;      // blocks a multiprocessor should hold
constexpr int ROW_BYTES = BK * 4;
constexpr int A_BYTES = BM * ROW_BYTES, B_BYTES = BN * ROW_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;            // 32 KB
constexpr int SOLVE_SMEM = STAGES * STAGE_BYTES + 1024;   // + room to align the ring to 1024 B
static_assert(ROW_BYTES == 128 && GT / 8 == 32 && BM % 32 == 0 && BN % 32 == 0, "copy layout");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
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
// 128-byte swizzle: start address, (unused) leading offset, 1024 bytes from
// one group of 8 rows to the next, swizzle mode 1. The tile starts on a
// 1024-byte boundary; a k step of 8 f32 is 32 bytes further on, + 2 here.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// acc (64 x 128 of a warpgroup, f32) += A (64 x 8) . B (128 x 8)^T in TF32
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&acc)[64], uint64_t desc_a,
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
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

// grid (npad / BN, ceil(M / BM), parts), SOLVE_SMEM bytes of dynamic shared
// memory. A (M, K) and Bt (npad, K) hold TF32 values; part z covers the k
// tiles z per .. (z + 1) per - 1; rows from M on read as zero.
__global__ void __launch_bounds__(GT, MINB)
solve_product_kernel(const float* __restrict__ A, const float* __restrict__ Bt,
                     float* __restrict__ part, int M, int K, int npad, int per) {
  extern __shared__ uint8_t ring_raw[];
  const uint32_t ring = (smem_u32(ring_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * per;
  const int nk = min(K / BK, kt0 + per) - kt0;  // this part's k tiles

  // The copy: thread (r0, c) moves 16-byte chunk c of rows r0, r0 + 32, ... of
  // both operand tiles; rows 32 apart share r % 8, so its swizzled chunk is one.
  const int c = tid % 8, r0 = tid / 8;
  const uint32_t dst0 = (uint32_t)(r0 * ROW_BYTES + ((c ^ (r0 & 7)) << 4));
  const float* a_src = A + (size_t)(m0 + r0) * K + (size_t)kt0 * BK + c * 4;
  const float* b_src = Bt + (size_t)(n0 + r0) * K + (size_t)kt0 * BK + c * 4;
  auto load = [&](int kt, int slot) {
    const uint32_t sa = ring + slot * STAGE_BYTES + dst0, sb = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < BM / 32; ++i) {
      const bool ok = m0 + r0 + 32 * i < M;
      cp_async16(sa + i * 32 * ROW_BYTES,
                 ok ? a_src + (size_t)i * 32 * K + kt * BK : A, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i)
      cp_async16(sb + i * 32 * ROW_BYTES, b_src + (size_t)i * 32 * K + kt * BK, 16);
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt have landed
    // wgmma reads shared memory through the async proxy: make the copies visible to it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // everyone's have; and everyone is done with tile kt - 1's slot
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load(nxt, nxt % STAGES);
    cp_async_commit();
    const uint32_t stage = ring + (kt % STAGES) * STAGE_BYTES;
    const uint64_t da = smem_desc(stage + wg * 64 * ROW_BYTES), db = smem_desc(stage + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) wgmma_m64n128k8_tf32(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait_all();
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // A warpgroup's accumulators: warp w holds rows 16 w .. 16 w + 15, lane l rows
  // l / 4 and l / 4 + 8 of them, columns 8 j + 2 (l % 4), + 1 for j < 16.
  const int lane = tid % 32, row = m0 + wg * 64 + 16 * ((tid % 128) / 32) + lane / 4;
  float* out = part + ((size_t)blockIdx.z * M + row) * npad + n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (row < M)
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < M)
      *reinterpret_cast<float2*>(out + (size_t)8 * npad + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// --- the full body's product: 3xTF32 over K = 3T' from two A and two B strips ---
//
// part[z] = dT_hi . Pt_hi^T + dT_hi . Pt_lo^T + dT_lo . Pt_hi^T over part z of K,
// where x = hi + lo splits an f32 value into two TF32 values (hi = rna(x), lo =
// rna(x - hi)). A stage holds dT in f32 (A, 16 KB) and Pt's hi and lo strips (B,
// 16 KB each), copied as the delta product copies its two. Each thread reads its
// A fragments of the stage from shared memory, splits them in registers and
// issues the three products a k step with A from registers (wgmma's register
// form), B through descriptors: 48 KB staged for 12 wgmmas a warpgroup, where
// the delta product stages 32 KB for 4.
#ifndef SDFA_FULL_STAGES
#define SDFA_FULL_STAGES 2
#endif
#ifndef SDFA_FULL_MINB
#define SDFA_FULL_MINB 2
#endif
// Every PROMOTE k tiles the accumulators are added into f32 registers (0:
// never). The tensor cores' f32 sums do not round to nearest: over a K of 9E'
// entries of T near the identity (a product over the equations) they drifted
// 2.75e-6 m from float64. The products of dT are small, and never promoting
// keeps the plain float32 product's error; chip_smoke.py --profile measures
// the choices (profile_full_sums).
#ifndef SDFA_FULL_PROMOTE
#define SDFA_FULL_PROMOTE 0
#endif
constexpr int FULL_STAGES = SDFA_FULL_STAGES;  // ring depth; FULL_STAGES - 1 copies in flight
constexpr int FULL_MINB = SDFA_FULL_MINB;      // blocks a multiprocessor should hold
constexpr int FULL_PROMOTE = SDFA_FULL_PROMOTE;
constexpr int FULL_STAGE_BYTES = A_BYTES + 2 * B_BYTES;                // 48 KB
constexpr int FULL_SMEM = FULL_STAGES * FULL_STAGE_BYTES + 1024;

// x as its TF32 value's bits, rounded to nearest (ties away from zero)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

// acc (64 x 128 of a warpgroup, f32) += A (64 x 8, this thread's 4 TF32 values
// in registers) . B (128 x 8)^T in TF32
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

// grid (npad / BN, ceil(M / BM), parts), FULL_SMEM bytes of dynamic shared
// memory. A (M, K) holds f32 values; Bt (2, npad, K) the TF32 parts hi, then lo;
// part z covers the k tiles z per .. (z + 1) per - 1; rows from M on read as zero.
template <int PROMOTE>
__global__ void __launch_bounds__(GT, FULL_MINB)
split_product_kernel(const float* __restrict__ A, const float* __restrict__ Bt,
                     float* __restrict__ part, int M, int K, int npad, int per) {
  extern __shared__ uint8_t ring_raw[];
  const uint32_t ring_off = ((smem_u32(ring_raw) + 1023u) & ~1023u) - smem_u32(ring_raw);
  const uint32_t ring = smem_u32(ring_raw) + ring_off;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * per;
  const int nk = min(K / BK, kt0 + per) - kt0;  // this part's k tiles

  // The copy, as the delta product's, of three strips a stage: A, B hi, B lo.
  const int c = tid % 8, r0 = tid / 8;
  const uint32_t dst0 = (uint32_t)(r0 * ROW_BYTES + ((c ^ (r0 & 7)) << 4));
  const float* a_src = A + (size_t)(m0 + r0) * K + (size_t)kt0 * BK + c * 4;
  const float* bh_src = Bt + (size_t)(n0 + r0) * K + (size_t)kt0 * BK + c * 4;
  const float* bl_src = bh_src + (size_t)npad * K;
  auto load = [&](int kt, int slot) {
    const uint32_t sa = ring + slot * FULL_STAGE_BYTES + dst0, sh = sa + A_BYTES,
                   sl = sh + B_BYTES;
#pragma unroll
    for (int i = 0; i < BM / 32; ++i) {
      const bool ok = m0 + r0 + 32 * i < M;
      cp_async16(sa + i * 32 * ROW_BYTES,
                 ok ? a_src + (size_t)i * 32 * K + kt * BK : A, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      cp_async16(sh + i * 32 * ROW_BYTES, bh_src + (size_t)i * 32 * K + kt * BK, 16);
      cp_async16(sl + i * 32 * ROW_BYTES, bl_src + (size_t)i * 32 * K + kt * BK, 16);
    }
  };

  // This thread's A fragment of a k step (8 columns): a[0] (g, t), a[1] (g + 8,
  // t), a[2] (g, t + 4), a[3] (g + 8, t + 4), rows of its warp's 16 in its
  // warpgroup's 64, g = lane / 4, t = lane % 4. Rows 8 apart share the swizzle
  // (row % 8 = g): column 8 kk + 4 h lies in chunk (2 kk + h) ^ g of its row.
  const int g = lane / 4;
  const uint8_t* frag = ring_raw + ring_off +
                        (wg * 64 + 16 * ((tid % 128) / 32) + g) * ROW_BYTES + (lane % 4) * 4;

  float acc[64], total[PROMOTE ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  if constexpr (PROMOTE > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.0f;
  }

  for (int s = 0; s < FULL_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<FULL_STAGES - 2>();  // this thread's copies of tile kt have landed
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // everyone's have; and everyone is done with tile kt - 1's slot
    const int nxt = kt + FULL_STAGES - 1;
    if (nxt < nk) load(nxt, nxt % FULL_STAGES);
    cp_async_commit();
    const int slot = kt % FULL_STAGES;
    uint32_t hi[BK / 8][4], lo[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = *reinterpret_cast<const float*>(
            frag + slot * FULL_STAGE_BYTES + (i & 1) * 8 * ROW_BYTES +
            (((2 * kk + (i >> 1)) ^ g) << 4));
        hi[kk][i] = tf32_bits(x);
        lo[kk][i] = tf32_bits(x - __uint_as_float(hi[kk][i]));
      }
    const uint32_t stage = ring + slot * FULL_STAGE_BYTES;
    const uint64_t dh = smem_desc(stage + A_BYTES), dl = smem_desc(stage + A_BYTES + B_BYTES);
    wgmma_fence();  // the fragments are written: order them before the products read them
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wgmma_m64n128k8_tf32_rs(acc, hi[kk], dh + 2 * kk);
      wgmma_m64n128k8_tf32_rs(acc, hi[kk], dl + 2 * kk);
      wgmma_m64n128k8_tf32_rs(acc, lo[kk], dh + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    // the products read the fragments until the wait: keep their registers till here
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(hi[kk][i]), "r"(lo[kk][i]));
    if constexpr (PROMOTE > 0) {
      if ((kt + 1) % PROMOTE == 0 || kt + 1 == nk) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          asm volatile("" : "+f"(acc[i])::"memory");  // read after the wait
          total[i] += acc[i];
          acc[i] = 0.0f;
        }
      }
    }
  }
  if constexpr (PROMOTE > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = total[i];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // the accumulators as the delta product's
  const int row = m0 + wg * 64 + 16 * ((tid % 128) / 32) + g;
  float* out = part + ((size_t)blockIdx.z * M + row) * npad + n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (row < M)
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < M)
      *reinterpret_cast<float2*>(out + (size_t)8 * npad + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// out (M, N) = part[0] + part[1] + ... in part order, then + x0[m % 3].
__global__ void __launch_bounds__(256)
solve_sum_kernel(const float* __restrict__ part, const float* __restrict__ x0,
                 float* __restrict__ out, int M, int N, int npad, int parts) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  float sum = part[(size_t)m * npad + n];
  for (int z = 1; z < parts; ++z) sum += part[((size_t)z * M + m) * npad + n];
  out[i] = sum + x0[(size_t)(m % 3) * N + n];
}

cudaError_t product_smem() {
  cudaError_t err = cudaFuncSetAttribute(solve_product_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SOLVE_SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(split_product_kernel<FULL_PROMOTE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, FULL_SMEM);
}

// Both bodies: the decode (dT rounded to TF32 for the delta body, in f32 for
// the full body), the product, the sum of the parts + x0.
template <bool FULL>
int decode_solve(const float* coef_s, const float* coef_r, const float* basis_s,
                 const float* means_s, const float* basis_r, const float* means_r,
                 const float* b_t, const float* t0, const float* x0, float* dt, float* part,
                 float* out, int W, int Ks, int Kr, int Tp, int NF, int npad, int parts,
                 cudaStream_t stream) {
  if (Ks <= 0 || Ks > KMAX || Kr <= 0 || Kr > KMAX || Tp <= 0 || (3 * Tp) % BK ||
      NF <= 0 || npad < NF || npad % BN || parts <= 0)
    return (int)cudaErrorInvalidValue;
  if (W <= 0) return 0;
  decode_delta_kernel<!FULL><<<dim3((W + WR - 1) / WR, (Tp + DT - 1) / DT), DT, 0, stream>>>(
      coef_s, coef_r, basis_s, means_s, basis_r, means_r, t0, dt, W, Ks, Kr, Tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = 3 * W, K = 3 * Tp;
  const int per = (K / BK + parts - 1) / parts;
  err = product_smem();  // on the device that is current, also on a thread that launches first
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(npad / BN, (M + BM - 1) / BM, parts);
  if constexpr (FULL)
    split_product_kernel<FULL_PROMOTE><<<grid, GT, FULL_SMEM, stream>>>(dt, b_t, part, M, K,
                                                                        npad, per);
  else
    solve_product_kernel<<<grid, GT, SOLVE_SMEM, stream>>>(dt, b_t, part, M, K, npad, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  solve_sum_kernel<<<(unsigned)(((size_t)M * NF + 255) / 256), 256, 0, stream>>>(
      part, x0, out, M, NF, npad, parts);
  return (int)cudaGetLastError();
}

}  // namespace

// The delta body. dt: scratch (W, 9, Tp); part: scratch (parts, 3W, npad); out:
// (W, 3, NF).
// p_t (npad, 3 Tp) is P transposed, zero rows from NF on, in TF32 values.
extern "C" int sdfa_decode_solve(const float* coef_s, const float* coef_r,
                                 const float* basis_s, const float* means_s,
                                 const float* basis_r, const float* means_r,
                                 const float* p_t, const float* t0, const float* x0,
                                 float* dt, float* part, float* out, int W, int Ks, int Kr,
                                 int Tp, int NF, int npad, int parts, cudaStream_t stream) {
  return decode_solve<false>(coef_s, coef_r, basis_s, means_s, basis_r, means_r, p_t, t0, x0,
                             dt, part, out, W, Ks, Kr, Tp, NF, npad, parts, stream);
}

// The full body, the same arguments: b_t (2, npad, 3 Tp) is the folded Pt
// transposed and split into TF32 parts hi, lo, zero rows from NF on; x0 the
// fold's x0f; dt holds dT in f32.
extern "C" int sdfa_decode_solve_full(const float* coef_s, const float* coef_r,
                                      const float* basis_s, const float* means_s,
                                      const float* basis_r, const float* means_r,
                                      const float* b_t, const float* t0, const float* x0,
                                      float* dt, float* part, float* out, int W, int Ks,
                                      int Kr, int Tp, int NF, int npad, int parts,
                                      cudaStream_t stream) {
  return decode_solve<true>(coef_s, coef_r, basis_s, means_s, basis_r, means_r, b_t, t0, x0,
                            dt, part, out, W, Ks, Kr, Tp, NF, npad, parts, stream);
}

// n[0]: how many blocks of the delta body's product kernel the card holds at
// once; n[1], n[2], n[3]: the products' tile rows, columns and k per stage;
// n[4]: how many blocks of the full body's product kernel.
extern "C" int sdfa_decode_solve_tiling(int* n) {
  cudaError_t err = product_smem();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, blocks = 0, full_blocks = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, solve_product_kernel, GT,
                                                      SOLVE_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &full_blocks, split_product_kernel<FULL_PROMOTE>, GT, FULL_SMEM);
  n[0] = sms * blocks;
  n[1] = BM;
  n[2] = BN;
  n[3] = BK;
  n[4] = sms * full_blocks;
  return (int)err;
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
