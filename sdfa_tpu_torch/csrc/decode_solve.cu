// PCA decode + transform build + deformation solve: coefficients (W, Ks),
// (W, Kr) -> free-vertex solution (W, 3, NF), with T = exp(skew(r)) * S built
// from the 9 decoded planes of a triangle. Two bodies, picked by the caller
// from the template's equation table (ops/decode_solve.py::prep_consts):
//
//   delta (identity tables): x[w][d] = x0[d] + sum_c sum_t (T[w][d][c](t) - T0[3d+c](t)) P[c][t]
//   full (any table):        x[w][d] = sum_c sum_e T[w][d][c](src(e)) P[c][e]
//
// where equation e reads triangle src(e) = eq_idx[e], or the identity where
// eq_idx[e] < 0 (a target triangle with no source, or the padded tail).
//
// Replaces sdfa_tpu/ops/pallas_decode_solve.py:_kernel_delta (the delta body,
// sdfa_decode_solve) and :_kernel (the full body, sdfa_decode_solve_full),
// both behind its pallas_call (entry points decode_solve_free /
// decode_solve_fused). The TPU kernel takes identity tables only; on a
// correspondence table the JAX package decodes to planes and takes solve_fn's
// float32 product over the equations, which is the full body's function here.
//
// What bounds it on the H100: the solve is a product of M = 3W rows, N = NF =
// 1261 columns and K = 3T' (T' = 9976 triangles padded to 10112) or 3E' (E' =
// n_eqs padded; 13966 -> 14080 for the fan-out table chip_smoke.py drives):
// 2 x 9 x 10112 x 1261 = 0.23 GFLOP per window on the identity table. The
// decode adds 2 x 1050 FLOP per (window, triangle) plus 9 transcendentals.
// In f32 outside the tensor cores (67 TFLOP/s) the product alone is 0.9 ms at
// 256 windows. The delta form exists so that a short mantissa is enough: the
// TPU kernel multiplies dT by P in one bf16 pass with f32 sums. Here the delta
// product runs on the tensor cores in TF32 (495 TFLOP/s), 7 x closer to the f32
// result than bf16 on the same inputs. The full body's T is not small, so it
// needs f32's mantissa, as the TPU kernel's three bf16 passes give: 3xTF32
// (hi.hi + hi.lo + lo.hi with x = hi + lo, each part a TF32 value, 22 bits
// together) on the same tensor cores, three times the delta product's
// operations. What bounds it then is operations: 0.42 ms at 216 windows on
// the fan-out table, against 1.02 ms for one f32 product on the FMA units.
//
// Design, three kernels a body:
//
// 1. The decode writes the product's A operand to scratch, each value
//    rounded to TF32 (cvt.rna; the tensor cores would truncate):
//    decode_delta_kernel decodes each (window, triangle) exactly once, in f32
//    (sinf/cosf/sqrtf, no fast-math), and writes dT (W, 9, T'), which viewed
//    as (3W, 3T') is A, row-major with K contiguous. decode_full_kernel
//    decodes per (window, equation), gathering its triangle's bases, and
//    writes A' (3W, 9E') = [A_hi | A_hi | A_lo].
// 2. solve_product_kernel: C = A . B^T on wgmma.mma_async m64n128k8 TF32 with
//    f32 accumulators in registers. TF32 wgmma takes both operands K-major
//    only, so the constant P is kept transposed, N padded to 128, split or
//    rounded to TF32 on the host once: p_t (npad, 3T') for the delta body,
//    B' (npad, 9E') = [B_hi | B_lo | B_hi] for the full body, so that one
//    product over K' = 9E' is the three products of 3xTF32 with f32 sums and
//    the kernel needs no change. A block of two warpgroups owns a 128 x 128
//    tile (64 rows a warpgroup) over one part of K; 16-byte cp.async copies
//    fill a ring of STAGES shared-memory stages of 32 k (one 128-byte swizzle
//    row per matrix row, chunk c of row r at c ^ (r % 8)), two blocks a
//    multiprocessor so that one's barrier and copy requests hide behind the
//    other's wgmma. K is split over gridDim.z so that the blocks fill the
//    card (the caller sizes the split from the kernel's occupancy); blocks
//    that run together walk K together and share their strips through L2.
//    Each block writes its partial tile to scratch. The full body's
//    instantiation adds its accumulators into f32 registers every 4 k tiles
//    (FULL_PROMOTE): the tensor cores' own f32 sums drift over its long K.
// 3. solve_sum_kernel adds the K parts in part order, then x0[m % 3] in f32
//    (delta body only). No atomics: results repeat bit for bit.
//
// Tiling the output over NF in one fused kernel would redo the decode and the
// trig in every NF tile. The scratch costs one write and a read through L2:
// for the delta body far below the product's time; for the full body A' is
// 3 x the delta's dT over E' (1.5 MB a window), and a product that issued the
// three wgmmas from two A and two B strips would read a third fewer bytes
// (not built: the product is bound by operations).
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

// dt (W, 9, T') = T - T0 per (window, triangle), each value rounded to TF32:
// the delta body's A operand. grid (ceil(W / WR), T' / DT): the windows walk
// fastest, so the blocks that run together read the same triangles' bases and
// each basis value comes from device memory once.
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
    for (int e = 0; e < 9; ++e) out[(size_t)e * Tp] = round_tf32(tv[e] - t0v[e]);
  }
}

// a (3W, 9E'): the full body's A operand. Row 3 w + i holds row i of each
// equation's T for window w, three times along K: [hi | hi | lo], column c E' + e
// of each copy = T_eq[e][i][c], split into TF32 parts hi = rna(x), lo = rna(x - hi).
// Equation e reads triangle eq_idx[e], or the identity where that is negative
// (no source, or the padded tail). grid (ceil(W / WR), E' / DT): the windows
// walk fastest; neighbouring equations mostly read neighbouring triangles, so
// the gathered basis reads stay close to coalesced. A triangle with two
// equations is decoded twice: the decode is 2 x 1050 FLOP a window and
// equation, the product 2 x 9 x 1261 x 3.
__global__ void __launch_bounds__(DT)
decode_full_kernel(const float* __restrict__ coef_s, const float* __restrict__ coef_r,
                   const float* __restrict__ basis_s, const float* __restrict__ means_s,
                   const float* __restrict__ basis_r, const float* __restrict__ means_r,
                   const int* __restrict__ eq_idx, float* __restrict__ a,
                   int W, int Ks, int Kr, int Tp, int Ep) {
  __shared__ float cs[WR][KMAX];
  __shared__ float cr[WR][KMAX];
  const int w0 = blockIdx.x * WR;
  load_coefs(cs, cr, coef_s, coef_r, w0, W, Ks, Kr);
  __syncthreads();
  const int e = blockIdx.y * DT + threadIdx.x;
  if (e >= Ep) return;
  const int src = eq_idx[e];
  float d[WR][9], m[9];
  if (src >= 0) {
    decode_planes(cs, cr, basis_s, basis_r, src, Tp, Ks, Kr, d);
    load_means(means_s, means_r, src, Tp, m);
  }
  const size_t copy = (size_t)3 * Ep;  // one copy's width along K; a row holds three
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    const int w = w0 + r;
    if (w >= W) break;
    float tv[9];
    if (src >= 0) {
      float p[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) p[k] = d[r][k] + m[k];
      transform_entries(p, tv);
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) tv[k] = (k % 4 == 0) ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float* row = a + (size_t)(3 * w + i) * 3 * copy + e;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = tv[3 * i + c], hi = round_tf32(x), lo = round_tf32(x - hi);
        row[(size_t)c * Ep] = hi;
        row[copy + (size_t)c * Ep] = hi;
        row[2 * copy + (size_t)c * Ep] = lo;
      }
    }
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

// The full body's accumulators are added into f32 registers every PROMOTE k
// tiles. The tensor cores' f32 sums do not round to nearest: over the full
// body's long K of operands near the identity their error grows with the
// chain a block sums (at 216 windows on the fan-out table, never promoted:
// 2.75e-6 m from float64 in 4 K parts, 4.5e-6 in one). Adding each 128 k
// into the register sums with the FMA units' rounding brings it to the plain
// float32 product's 6e-8 m, for about 8% of the body's time (every 16 k
// tiles: 1.7e-7 m, no slower than never). The delta body's short products of
// small values keep one accumulator (PROMOTE 0). chip_smoke.py --profile
// times these choices (profile_full_sums).
#ifndef SDFA_FULL_PROMOTE
#define SDFA_FULL_PROMOTE 4
#endif
constexpr int FULL_PROMOTE = SDFA_FULL_PROMOTE;

// grid (npad / BN, ceil(M / BM), parts), SOLVE_SMEM bytes of dynamic shared
// memory. A (M, K) and Bt (npad, K) hold TF32 values; part z covers the k
// tiles z per .. (z + 1) per - 1; rows from M on read as zero.
template <int PROMOTE>
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

  float acc[64], total[PROMOTE ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  if constexpr (PROMOTE > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.0f;
  }

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

// out (M, N) = part[0] + part[1] + ... in part order, then + x0[m % 3] (none
// where x0 is null: the full body).
__global__ void __launch_bounds__(256)
solve_sum_kernel(const float* __restrict__ part, const float* __restrict__ x0,
                 float* __restrict__ out, int M, int N, int npad, int parts) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  float sum = part[(size_t)m * npad + n];
  for (int z = 1; z < parts; ++z) sum += part[((size_t)z * M + m) * npad + n];
  out[i] = x0 ? sum + x0[(size_t)(m % 3) * N + n] : sum;
}

cudaError_t product_smem() {
  cudaError_t err = cudaFuncSetAttribute(solve_product_kernel<0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SOLVE_SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(solve_product_kernel<FULL_PROMOTE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SOLVE_SMEM);
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
  if (Ks <= 0 || Ks > KMAX || Kr <= 0 || Kr > KMAX || Tp <= 0 || (3 * Tp) % BK ||
      NF <= 0 || npad < NF || npad % BN || parts <= 0)
    return (int)cudaErrorInvalidValue;
  if (W <= 0) return 0;
  decode_delta_kernel<<<dim3((W + WR - 1) / WR, (Tp + DT - 1) / DT), DT, 0, stream>>>(
      coef_s, coef_r, basis_s, means_s, basis_r, means_r, t0, dt, W, Ks, Kr, Tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = 3 * W, K = 3 * Tp;
  const int per = (K / BK + parts - 1) / parts;
  err = product_smem();  // on the device that is current, also on a thread that launches first
  if (err != cudaSuccess) return (int)err;
  solve_product_kernel<0><<<dim3(npad / BN, (M + BM - 1) / BM, parts), GT, SOLVE_SMEM, stream>>>(
      dt, p_t, part, M, K, npad, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  solve_sum_kernel<<<(unsigned)(((size_t)M * NF + 255) / 256), 256, 0, stream>>>(
      part, x0, out, M, NF, npad, parts);
  return (int)cudaGetLastError();
}

// The full body. a: scratch (3W, 9 Ep); part: scratch (parts, 3W, npad); out:
// (W, 3, NF). eq_idx (Ep,): an equation's triangle, negative for the identity.
// b_t (npad, 9 Ep) is [B_hi | B_lo | B_hi] of P transposed, zero rows from NF on.
extern "C" int sdfa_decode_solve_full(const float* coef_s, const float* coef_r,
                                      const float* basis_s, const float* means_s,
                                      const float* basis_r, const float* means_r,
                                      const int* eq_idx, const float* b_t, float* a,
                                      float* part, float* out, int W, int Ks, int Kr, int Tp,
                                      int Ep, int NF, int npad, int parts,
                                      cudaStream_t stream) {
  if (Ks <= 0 || Ks > KMAX || Kr <= 0 || Kr > KMAX || Tp <= 0 || Ep <= 0 || (9 * Ep) % BK ||
      NF <= 0 || npad < NF || npad % BN || parts <= 0)
    return (int)cudaErrorInvalidValue;
  if (W <= 0) return 0;
  decode_full_kernel<<<dim3((W + WR - 1) / WR, (Ep + DT - 1) / DT), DT, 0, stream>>>(
      coef_s, coef_r, basis_s, means_s, basis_r, means_r, eq_idx, a, W, Ks, Kr, Tp, Ep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = 3 * W, K = 9 * Ep;
  const int per = (K / BK + parts - 1) / parts;
  err = product_smem();
  if (err != cudaSuccess) return (int)err;
  solve_product_kernel<FULL_PROMOTE>
      <<<dim3(npad / BN, (M + BM - 1) / BM, parts), GT, SOLVE_SMEM, stream>>>(a, b_t, part, M, K,
                                                                             npad, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  solve_sum_kernel<<<(unsigned)(((size_t)M * NF + 255) / 256), 256, 0, stream>>>(
      part, nullptr, out, M, NF, npad, parts);
  return (int)cudaGetLastError();
}

// n[0]: how many blocks of the product kernel the card holds at once (the
// fewer of its two instantiations); n[1], n[2], n[3]: its tile's rows, columns
// and k per stage.
extern "C" int sdfa_decode_solve_tiling(int* n) {
  cudaError_t err = product_smem();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, blocks = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  // both bodies' products: the split of K assumes the fewer of them
  int full_blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, solve_product_kernel<0>, GT,
                                                      SOLVE_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &full_blocks, solve_product_kernel<FULL_PROMOTE>, GT, SOLVE_SMEM);
  n[0] = sms * (blocks < full_blocks ? blocks : full_blocks);
  n[1] = BM;
  n[2] = BN;
  n[3] = BK;
  return (int)err;
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
