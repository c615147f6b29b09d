// PCA decode + transform build + delta-form deformation solve:
// coefficients (W, Ks), (W, Kr) -> free-vertex solution (W, 3, NF),
//   x[w][d] = x0[d] + sum_c sum_t (T[w][d][c](t) - T0[3d+c](t)) * P[c][t]
// with T = exp(skew(r)) * S built from the 9 decoded planes of triangle t.
//
// Replaces sdfa_tpu/ops/pallas_decode_solve.py:_kernel_delta (entry points
// decode_solve_free / decode_solve_fused). Delta form only, f32 P.
//
// What bounds it on the H100: the solve is a GEMM of M = 3W rows, N = NF
// = 1261 columns and K = 3T' (T' = 9976 triangles padded to 10112):
// 2 x 9 x 10112 x 1261 = 0.23 GFLOP per window; the decode adds 2 x 1050
// x T' = 21 MFLOP per window plus 9 transcendentals per triangle. P is
// 3 x 10112 x 1261 f32 = 153 MB, more than the 50 MB L2, so P is streamed
// from HBM once per M tile. At W = 256 windows the GEMM is 60 GFLOP: it
// is bound by f32 FMA throughput (67 TFLOP/s peak without tensor cores),
// not by HBM (12 passes over P = 1.8 GB, ~0.6 ms at 3.35 TB/s).
//
// Design ((b) of two): decode_delta_kernel decodes each (window,
// triangle) exactly once and writes dT (W, 9, T') to a scratch tensor;
// solve_gemm_kernel is a tiled GEMM over it. Tiling the output over NF in
// one fused kernel would redo the decode and the trig in every NF tile
// (20 tiles of 64 columns); a block that owns all 1261 columns would
// re-stream P once per few rows. The scratch costs one write and ~20
// L2-friendly reads of 9 x T' floats per window, far below the GEMM's
// time. dT rows are laid out so that A = dT viewed as (3W, 3T') is
// row-major with K contiguous and B = P viewed as (3T', NF) is row-major:
// the GEMM needs no transpose.
// f32 arithmetic throughout (sinf/cosf/sqrtf, no fast-math).
#include <cuda_runtime.h>

namespace {

constexpr int DT = 128;    // triangles per decode block (one per thread)
constexpr int WR = 4;      // windows per decode block
constexpr int KMAX = 256;  // largest PCA coefficient count

__global__ void __launch_bounds__(DT)
decode_delta_kernel(const float* __restrict__ coef_s, const float* __restrict__ coef_r,
                    const float* __restrict__ basis_s, const float* __restrict__ means_s,
                    const float* __restrict__ basis_r, const float* __restrict__ means_r,
                    const float* __restrict__ t0, float* __restrict__ dt,
                    int W, int Ks, int Kr, int Tp) {
  __shared__ float cs[WR][KMAX];
  __shared__ float cr[WR][KMAX];
  const int w0 = blockIdx.y * WR;
  for (int i = threadIdx.x; i < WR * KMAX; i += DT) {
    const int r = i / KMAX, k = i % KMAX, w = w0 + r;
    cs[r][k] = (w < W && k < Ks) ? coef_s[(size_t)w * Ks + k] : 0.0f;
    cr[r][k] = (w < W && k < Kr) ? coef_r[(size_t)w * Kr + k] : 0.0f;
  }
  __syncthreads();
  const int t = blockIdx.x * DT + threadIdx.x;
  if (t >= Tp) return;

  // d[r][k]: plane k of window w0+r at triangle t (6 scale, 3 rotation)
  float d[WR][9];
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
  float m[9], t0v[9];
#pragma unroll
  for (int k = 0; k < 6; ++k) m[k] = means_s[(size_t)k * Tp + t];
#pragma unroll
  for (int k = 0; k < 3; ++k) m[6 + k] = means_r[(size_t)k * Tp + t];
#pragma unroll
  for (int e = 0; e < 9; ++e) t0v[e] = t0[(size_t)e * Tp + t];

#pragma unroll
  for (int r = 0; r < WR; ++r) {
    const int w = w0 + r;
    if (w >= W) break;
    float p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = d[r][k] + m[k];
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
    float* out = dt + (size_t)w * 9 * Tp + t;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float tv = rot[i][0] * s[0][k] + rot[i][1] * s[1][k] + rot[i][2] * s[2][k];
        out[(size_t)(3 * i + k) * Tp] = tv - t0v[3 * i + k];
      }
  }
}

constexpr int BM = 64, BN = 64, BK = 16, GT = 256;  // GEMM tile, 4x4 per thread

// C (M, N) = A (M, K) . B (K, N) + x0[m % 3][n]; A, B, C row-major f32.
// Requires K % BK == 0 and K % 4 == 0.
__global__ void __launch_bounds__(GT)
solve_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ x0, float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int a_m = tid / 4, a_k = (tid % 4) * 4;    // A tile: one float4 per thread
  const int b_k = tid / 16, b_n = (tid % 16) * 4;  // B tile: four floats per thread

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    float4 av = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m0 + a_m < M)
      av = *reinterpret_cast<const float4*>(A + (size_t)(m0 + a_m) * K + k0 + a_k);
    As[a_k + 0][a_m] = av.x;
    As[a_k + 1][a_m] = av.y;
    As[a_k + 2][a_m] = av.z;
    As[a_k + 3][a_m] = av.w;
    const float* brow = B + (size_t)(k0 + b_k) * N;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + b_n + q;
      Bs[b_k][b_n + q] = n < N ? brow[n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] += ar[i] * br[jj];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n < N) C[(size_t)m * N + n] = x0[(size_t)(m % 3) * N + n] + acc[i][jj];
    }
  }
}

}  // namespace

// dt: scratch (W, 9, Tp); out: (W, 3, NF). Tp % BK == 0 is required.
extern "C" int sdfa_decode_solve(const float* coef_s, const float* coef_r,
                                 const float* basis_s, const float* means_s,
                                 const float* basis_r, const float* means_r,
                                 const float* p, const float* t0, const float* x0,
                                 float* dt, float* out, int W, int Ks, int Kr, int Tp,
                                 int NF, cudaStream_t stream) {
  if (Ks <= 0 || Ks > KMAX || Kr <= 0 || Kr > KMAX || Tp <= 0 || Tp % BK || NF <= 0)
    return (int)cudaErrorInvalidValue;
  if (W <= 0) return 0;
  decode_delta_kernel<<<dim3((Tp + DT - 1) / DT, (W + WR - 1) / WR), DT, 0, stream>>>(
      coef_s, coef_r, basis_s, means_s, basis_r, means_r, t0, dt, W, Ks, Kr, Tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = 3 * W, K = 3 * Tp;
  solve_gemm_kernel<<<dim3((NF + BN - 1) / BN, (M + BM - 1) / BM), GT, 0, stream>>>(
      dt, p, x0, out, M, NF, K);
  return (int)cudaGetLastError();
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
