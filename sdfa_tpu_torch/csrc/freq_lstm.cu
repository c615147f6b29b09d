// FreqLstm "full" mode: x (rows, F, C) -> (rows, OUT).
//
// Replaces sdfa_tpu/ops/pallas_freq_lstm.py:_freq_lstm_kernel (entry point
// freq_lstm_fused). Per row: input projection x_f.W_ih, the forward
// (f = 0..F-1) and reverse (f = F-1..0) recurrences h.W_hh with torch gate
// order i, f, g, o, and the output projection
//   out = sum_f h_fwd(f).W_proj[f, 0] + h_rev(f).W_proj[f, 1] + b_proj,
// where W_proj's row index is f*2H + d*H + h.
//
// What bounds it on the H100: operations, and before them latency. At the
// flagship shapes (F=32, C=64, H=128, OUT=256) a row costs 32 steps x 2
// directions x (64+128) x 512 + 8192 x 256 multiply-adds = 16.8 MFLOP in f32
// and reads 8 KB of input; the weights (W_ih 256 KB, W_hh 512 KB, W_proj 8 MB)
// are small. Only h.W_hh, a quarter of the work, depends on the step before:
// a kernel that keeps the two projections inside the step loop, walks the two
// directions one after the other and fetches its weights from L2 every step
// is a chain of 64 latency-bound phases whose time does not fall with the
// rows. A request has 768 rows, not the thousands that would hide that.
//
// Design, three phases per chunk of rows, each a kernel (four launches):
//
// 1. proj_kernel<4H> of bilstm_layer.cuh: xp[d] = x.W_ih[d] + gate bias for all
//    (row, f) pairs and both directions, one tiled f32 product ahead of the
//    recurrence.
// 2. steps_kernel<128, ...> of bilstm_layer.cuh, the cluster step of the other
//    biLSTM kernels: a cluster of 4 blocks holds ONE direction's W_hh (256 KB)
//    in shared memory for the whole launch and owns 32 rows, h goes round
//    through distributed shared memory, two sub-tiles take turns. The two
//    directions run in different clusters side by side, so the chain is F
//    steps long, not 2 F. h (rows, F, 2H) goes to scratch.
// 3. out_parts_kernel + out_sum_kernel: out = h.reshape(rows, F 2H).W_proj +
//    b_proj as the same tiled f32 product. With 256 output columns and a few
//    hundred rows a plain tiling has a dozen tiles for 132 multiprocessors, so
//    K = F 2H is split in slabs of KSLAB (two frequency steps), one block per
//    (tile, slab), partial sums to scratch; out_sum_kernel adds the slabs in
//    slab order, then the bias. No atomics: results repeat bit for bit.
//
// Scratch, sized by the caller for one chunk of rows: xp 2 x 4H floats per
// (row, f) pair (128 KB a row at F = 32), h 2H floats per pair (32 KB a row),
// the partial sums F 2H / KSLAB x OUT floats a row (16 KB). The caller takes
// whole waves of resident clusters as a chunk (62 clusters of 4 on the H100:
// 992 rows), so no chunk ends in a barely filled wave of its own making.
//
// f32 throughout (expf/tanhf, no fast-math), sums in another order than the
// plain version's.
#include "bilstm_layer.cuh"

using namespace bilstm;

namespace {

constexpr int FH = 128;      // hidden units per direction
constexpr int FG = 4 * FH;   // gate width
constexpr int OUT = 256;     // projection width
constexpr int KSLAB = 512;   // K range of one partial sum of the output projection
static_assert(OUT % PN == 0 && KSLAB % PK == 0 && KSLAB % 4 == 0, "the product's tiles");

// Row groups of 8 to a sub-tile (a cluster owns 16 RG rows) and blocks a
// multiprocessor should hold: compile-time constants, chosen on the card
// (chip_smoke.py --profile builds the other row tile with -D and times it).
#ifndef SDFA_FREQ_RG
#define SDFA_FREQ_RG 2
#endif
using FreqDims = StepDims<FH, SDFA_FREQ_RG>;
inline StepsKernel freq_steps_kernel() {
  return steps_kernel<FH, SDFA_FREQ_RG, RowMajor, false, 2>;
}

// part[s] (M, OUT) = h[:, s KSLAB .. (s + 1) KSLAB) . W_proj[the same rows].
// grid (OUT / PN, ceil(M / PM), slabs). It is proj_kernel's tile (PM x PN, PK
// deep, 8 x 8 outputs a thread, the next tile fetched into registers while
// this one is multiplied) over a K range of its own, with a row stride of A
// apart from that range; the layer kernels' proj_kernel is left as it is, since
// one loop shared by both cost their projection 1% on the card.
__global__ void __launch_bounds__(PT, 2)
out_parts_kernel(const float* __restrict__ h, const float* __restrict__ w_proj,
                 float* __restrict__ part, int M, int K) {
  __shared__ __align__(16) float As[2][PK][PM];
  __shared__ __align__(16) float Bs[2][PK][PN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * PN, m0 = blockIdx.y * PM;
  const int k0 = blockIdx.z * KSLAB, k1 = min(K, k0 + KSLAB);
  const int a_m = tid % PM, a_k = (tid / PM) * 8;  // h tile: 8 k of one row per thread
  const int b_k = tid / 32, b_n = (tid % 32) * 4;  // W tile: rows b_k, b_k + 8, one float4 each
  const bool row_ok = m0 + a_m < M;
  const float* arow = h + (size_t)(row_ok ? m0 + a_m : 0) * K;
  const float* bcol = w_proj + n0 + b_n;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float ar[8];
  float4 br[2];
  load_a(arow, row_ok, k0 + a_k, k1, 1, ar);
  load_b<OUT>(bcol, k0 + b_k, k1, br);
  const int tiles = (k1 - k0 + PK - 1) / PK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) As[buf][a_k + i][a_m] = ar[i];
#pragma unroll
    for (int i = 0; i < 2; ++i) *reinterpret_cast<float4*>(&Bs[buf][b_k + 8 * i][b_n]) = br[i];
    __syncthreads();  // this tile is in place; the other buffer's readers are done (see below)
    if (tile + 1 < tiles) {
      load_a(arow, row_ok, k0 + (tile + 1) * PK + a_k, k1, 1, ar);
      load_b<OUT>(bcol, k0 + (tile + 1) * PK + b_k, k1, br);
    }
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    // No barrier here: the next turn writes the other buffer, whose last
    // readers all passed this turn's barrier after they finished with it.
  }

  float* out = part + (size_t)blockIdx.z * M * OUT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float4*>(out + (size_t)m * OUT + n0 + half * 64 + tx * 4) = make_float4(
          acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2], acc[i][4 * half + 3]);
  }
}

// out (M, OUT) = part[0] + part[1] + ... in slab order, then + b_proj.
__global__ void __launch_bounds__(256)
out_sum_kernel(const float4* __restrict__ part, const float4* __restrict__ b_proj,
               float4* __restrict__ out, int M, int slabs) {
  const int n4 = M * (OUT / 4);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 sum = part[i];
  for (int s = 1; s < slabs; ++s) {
    const float4 v = part[(size_t)s * n4 + i];
    sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
  }
  if (b_proj) {
    const float4 b = b_proj[i % (OUT / 4)];
    sum.x += b.x; sum.y += b.y; sum.z += b.z; sum.w += b.w;
  }
  out[i] = sum;
}

// One chunk of n rows through the three phases.
cudaError_t run_chunk(const float* x, const float* w_ih, const float* w_hh, const float* gb,
                      const float* w_proj, const float* b_proj, float* xp, float* h, float* part,
                      float* out, int n, int F, int C, cudaStream_t stream) {
  cudaError_t err = launch_proj<FG>(x, C, w_ih, gb, xp, n * F, stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  err = cluster_config(config, attr, freq_steps_kernel(),
                       dim3(FreqDims::CL, (n + FreqDims::RT - 1) / FreqDims::RT, 2),
                       FreqDims::THREADS, FreqDims::SMEM, FreqDims::CL, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&config, freq_steps_kernel(), (const float*)xp, w_hh, h,
                           (float*)nullptr, (float*)nullptr, n, F);
  if (err != cudaSuccess) return err;
  const int K = F * 2 * FH, slabs = (K + KSLAB - 1) / KSLAB;
  out_parts_kernel<<<dim3(OUT / PN, (n + PM - 1) / PM, slabs), PT, 0, stream>>>(h, w_proj, part,
                                                                              n, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  out_sum_kernel<<<(n * (OUT / 4) + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<const float4*>(b_proj),
      reinterpret_cast<float4*>(out), n, slabs);
  return cudaGetLastError();
}

}  // namespace

// xp (2, chunk, F, 4H), h (chunk, F, 2H) and part (slabs, chunk, OUT) are
// scratch for one chunk of rows; the rows are walked `chunk` at a time.
extern "C" int sdfa_freq_lstm(const float* x, const float* w_ih, const float* w_hh,
                              const float* gb, const float* w_proj, const float* b_proj,
                              float* xp, float* h, float* part, float* out, int rows, int F,
                              int C, int hidden, int out_dim, int chunk, cudaStream_t stream) {
  if (hidden != FH || out_dim != OUT || C <= 0 || F <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  for (int row0 = 0; row0 < rows; row0 += chunk) {
    const int n = rows - row0 < chunk ? rows - row0 : chunk;
    const cudaError_t err = run_chunk(x + (size_t)row0 * F * C, w_ih, w_hh, gb, w_proj, b_proj,
                                      xp, h, part, out + (size_t)row0 * OUT, n, F, C, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// n[0]: how many clusters of the step kernel the card holds at once; n[1]: the
// rows a cluster owns; n[2]: the K range of one partial sum of the output
// projection.
extern "C" int sdfa_freq_lstm_tiling(int* n) {
  n[1] = FreqDims::RT;
  n[2] = KSLAB;
  return (int)max_active_clusters(n, freq_steps_kernel(), FreqDims::THREADS, FreqDims::SMEM,
                                  FreqDims::CL);
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
