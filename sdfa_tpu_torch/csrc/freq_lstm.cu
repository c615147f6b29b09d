// FreqLstm "full" mode: x (rows, F, C) -> (rows, OUT).
//
// Replaces sdfa_tpu/ops/pallas_freq_lstm.py:_freq_lstm_kernel (entry point
// freq_lstm_fused). Per row: input projection x_f.W_ih, the forward
// (f = 0..F-1) and reverse (f = F-1..0) recurrences h.W_hh with torch gate
// order i, f, g, o, and the output projection
//   out = sum_f h_fwd(f).W_proj[f, 0] + h_rev(f).W_proj[f, 1] + b_proj,
// where W_proj's row index is f*2H + d*H + h. The JAX gate sends it any H
// that is a multiple of 128 and any OUT (sdfa_tpu/nn/recurrent.py:427-435);
// so does this one.
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
// 1. proj_kernel of bilstm_layer.cuh (<512> at H = 128, <1024> at 256, <0>
//    from 384 on): xp[d] = x.W_ih[d] + gate bias for all (row, f) pairs and
//    both directions, one product ahead of the recurrence, in 3xTF32 on the
//    tensor cores (W_ih staged transposed and split once per call).
// 2. the step loop of bilstm_layer.cuh over the frequency steps. At H = 128,
//    steps_kernel<128, ...>, the cluster step of the other biLSTM kernels: a
//    cluster of 4 blocks holds ONE direction's W_hh (256 KB) in shared
//    memory for the whole launch and owns 32 rows, h goes round through
//    distributed shared memory, two sub-tiles take turns. The two directions
//    run in different clusters side by side, so the chain is F steps long,
//    not 2 F. At H = 256 the layer kernels' instantiation (clusters of 8
//    blocks, 32 rows), from H = 384 on the wide step loop (W_hh through L2,
//    one grid-wide barrier a step). h (rows, F, 2H) goes to scratch.
// 3. out_parts_kernel + out_sum_kernel: out = h.reshape(rows, F 2H).W_proj +
//    b_proj as a tiled f32 product on the FMA units. With 256 output columns and a few
//    hundred rows a plain tiling has a dozen tiles for 132 multiprocessors, so
//    K = F 2H is split in slabs of KSLAB, one block per (tile, slab), partial
//    sums to scratch; out_sum_kernel adds the slabs in slab order, then the
//    bias. No atomics: results repeat bit for bit. OUT is a run-time width:
//    the last column tile is padded (its loads zero, its stores skipped), and
//    an OUT that is no multiple of 4 (or an unaligned W_proj / b_proj) takes
//    scalar loads and stores instead of float4.
//
// Scratch, sized by the caller: W_ih staged (2, 8H, K padded to 32) for the
// call; for one chunk of rows xp 2 x 4H floats per
// (row, f) pair (128 KB a row at F = 32, H = 128), h 2H floats per pair (32
// KB a row), the partial sums F 2H / KSLAB x OUT floats a row (16 KB). The
// caller takes whole waves of resident clusters (of the wide loop's row tiles,
// both directions) as a chunk (62 clusters of 4 on the H100 at H = 128: 992
// rows), so no chunk ends in a barely filled wave of its own making.
//
// The recurrence and the output projection in f32 (expf/tanhf, no
// fast-math), the input projection in 3xTF32 (f32-grade), sums in another
// order than the plain version's.
#include "bilstm_layer.cuh"

using namespace bilstm;

namespace {

constexpr int KSLAB = 512;  // K range of one partial sum of the output projection

// The output projection's tile: PM x PN outputs, PK deep, PT threads holding 8
// x 8 outputs each.
constexpr int PM = 128, PN = 128, PK = 16, PT = 256;
static_assert(KSLAB % PK == 0 && KSLAB % 4 == 0, "the product's tiles");

// Eight consecutive k of one row of A from k on as two float4, zero from K on
// or for a row past M (K and the row's start are multiples of 4 floats: h's
// rows are F 2H long).
__device__ __forceinline__ void load_a(const float* arow, bool row_ok, int k, int K,
                                       float (&ar)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) ar[i] = 0.0f;
  if (!row_ok) return;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (k + 4 * h < K) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(arow + k + 4 * h));
      ar[4 * h] = v.x; ar[4 * h + 1] = v.y; ar[4 * h + 2] = v.z; ar[4 * h + 3] = v.w;
    }
}

// Row groups of 8 to a sub-tile (a cluster owns 16 RG rows) and blocks a
// multiprocessor should hold at H = 128: compile-time constants, chosen on the
// card (chip_smoke.py --profile builds the other row tile with -D and times it).
#ifndef SDFA_FREQ_RG
#define SDFA_FREQ_RG 2
#endif
using FreqDims = StepDims<128, SDFA_FREQ_RG>;
inline StepsKernel freq_steps_kernel() {
  return steps_kernel<128, SDFA_FREQ_RG, RowMajor, false, 2>;
}

// Four consecutive columns n .. n + 3 of B's row k (zero from K or N on); B
// has N floats to a row. VEC: N is a multiple of 4 and B 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ float4 load_b4(const float* b, int k, int K, int n, int N) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k >= K) return v;
  const float* p = b + (size_t)k * N + n;
  if (VEC) return n < N ? __ldg(reinterpret_cast<const float4*>(p)) : v;
  if (n < N) v.x = __ldg(p);
  if (n + 1 < N) v.y = __ldg(p + 1);
  if (n + 2 < N) v.z = __ldg(p + 2);
  if (n + 3 < N) v.w = __ldg(p + 3);
  return v;
}

// part[s] (M, N) = h[:, s KSLAB .. (s + 1) KSLAB) . W_proj[the same rows].
// grid (ceil(N / PN), ceil(M / PM), slabs): a SIMT f32 tile (PM x PN, PK deep,
// 8 x 8 outputs a thread, the next tile fetched into registers while this one
// is multiplied; sums k by k from the slab's first) over a K range of its own,
// with a row stride of A apart from that range and the output width N a
// run-time value, its last tile padded. It is what the input projection was
// before it moved to the tensor cores (bilstm_layer.cuh::proj_kernel).
template <bool VEC>
__global__ void __launch_bounds__(PT, 2)
out_parts_kernel(const float* __restrict__ h, const float* __restrict__ w_proj,
                 float* __restrict__ part, int M, int K, int N) {
  __shared__ __align__(16) float As[2][PK][PM];
  __shared__ __align__(16) float Bs[2][PK][PN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * PN, m0 = blockIdx.y * PM;
  const int k0 = blockIdx.z * KSLAB, k1 = min(K, k0 + KSLAB);
  const int a_m = tid % PM, a_k = (tid / PM) * 8;  // h tile: 8 k of one row per thread
  const int b_k = tid / 32, b_n = (tid % 32) * 4;  // W tile: rows b_k, b_k + 8, one float4 each
  const bool row_ok = m0 + a_m < M;
  const float* arow = h + (size_t)(row_ok ? m0 + a_m : 0) * K;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float ar[8];
  float4 br[2];
  load_a(arow, row_ok, k0 + a_k, k1, ar);
#pragma unroll
  for (int i = 0; i < 2; ++i) br[i] = load_b4<VEC>(w_proj, k0 + b_k + 8 * i, k1, n0 + b_n, N);
  const int tiles = (k1 - k0 + PK - 1) / PK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) As[buf][a_k + i][a_m] = ar[i];
#pragma unroll
    for (int i = 0; i < 2; ++i) *reinterpret_cast<float4*>(&Bs[buf][b_k + 8 * i][b_n]) = br[i];
    __syncthreads();  // this tile is in place; the other buffer's readers are done (see below)
    if (tile + 1 < tiles) {
      const int kn = k0 + (tile + 1) * PK;
      load_a(arow, row_ok, kn + a_k, k1, ar);
#pragma unroll
      for (int i = 0; i < 2; ++i) br[i] = load_b4<VEC>(w_proj, kn + b_k + 8 * i, k1, n0 + b_n, N);
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

  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      float* o = out + (size_t)m * N + n;
      const float* a = acc[i] + 4 * half;
      if (VEC) {
        if (n < N) *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) o[e] = a[e];
      }
    }
  }
}

// out (M, N) = part[0] + part[1] + ... in slab order, then + b_proj; VEC: four
// columns a thread.
template <bool VEC>
__global__ void __launch_bounds__(256)
out_sum_kernel(const float* __restrict__ part, const float* __restrict__ b_proj,
               float* __restrict__ out, int M, int N, int slabs) {
  const int W = VEC ? 4 : 1;
  const int n_items = M * (N / W), i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const size_t plane = (size_t)M * N;
  if (VEC) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    float4 sum = p4[i];
    for (int s = 1; s < slabs; ++s) {
      const float4 v = p4[(size_t)s * (plane / 4) + i];
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    if (b_proj) {
      const float4 b = reinterpret_cast<const float4*>(b_proj)[i % (N / 4)];
      sum.x += b.x; sum.y += b.y; sum.z += b.z; sum.w += b.w;
    }
    reinterpret_cast<float4*>(out)[i] = sum;
  } else {
    float sum = part[i];
    for (int s = 1; s < slabs; ++s) sum += part[(size_t)s * plane + i];
    if (b_proj) sum += b_proj[i % N];
    out[i] = sum;
  }
}

// The step loop over a chunk's n rows at H units, from xp into h.
cudaError_t run_steps(const float* xp, const float* w_hh, float* h, int n, int F, int H,
                      cudaStream_t stream) {
  if (H > 256)
    return wide_run(layer_wide_kernel(), H, n, stream, xp, w_hh, h, (float*)nullptr,
                    (float*)nullptr, n, F, H);
  const StepsKernel kernel = H == 128 ? freq_steps_kernel() : layer_steps_kernel<256>();
  const int cl = H == 128 ? FreqDims::CL : LayerDims<256>::CL;
  const int rt = H == 128 ? FreqDims::RT : LayerDims<256>::RT;
  const int threads = H == 128 ? FreqDims::THREADS : LayerDims<256>::THREADS;
  const int smem = H == 128 ? FreqDims::SMEM : LayerDims<256>::SMEM;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_config(config, attr, kernel, dim3(cl, (n + rt - 1) / rt, 2),
                                         threads, smem, cl, stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, kernel, xp, w_hh, h, (float*)nullptr, (float*)nullptr, n,
                            F);
}

// One chunk of n rows through the three phases; wt: W_ih staged by
// prep_proj_weights.
cudaError_t run_chunk(const float* x, const float* wt, const float* w_hh, const float* gb,
                      const float* w_proj, const float* b_proj, float* xpad, float* xp, float* h,
                      float* part, float* out, int n, int F, int C, int H, int N,
                      cudaStream_t stream) {
  cudaError_t err = run_proj_h(H, x, C, wt, gb, xpad, xp, n * F, stream);
  if (err != cudaSuccess) return err;
  err = run_steps(xp, w_hh, h, n, F, H, stream);
  if (err != cudaSuccess) return err;
  const int K = F * 2 * H, slabs = (K + KSLAB - 1) / KSLAB;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w_proj) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b_proj) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((N + PN - 1) / PN, (n + PM - 1) / PM, slabs);
  if (vec)
    out_parts_kernel<true><<<grid, PT, 0, stream>>>(h, w_proj, part, n, K, N);
  else
    out_parts_kernel<false><<<grid, PT, 0, stream>>>(h, w_proj, part, n, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int items = vec ? n * (N / 4) : n * N;
  if (vec)
    out_sum_kernel<true><<<(items + 255) / 256, 256, 0, stream>>>(part, b_proj, out, n, N, slabs);
  else
    out_sum_kernel<false><<<(items + 255) / 256, 256, 0, stream>>>(part, b_proj, out, n, N,
                                                                    slabs);
  return cudaGetLastError();
}

}  // namespace

// wt (2, 8H, proj_kw(C)) is scratch for the staged W_ih; xpad (chunk F,
// proj_kpad(C)) where x needs it (proj_needs_pad), else null; xp (2, chunk, F,
// 4H), h (chunk, F, 2H) and part (slabs, chunk, OUT) are scratch for one chunk
// of rows; the rows are walked `chunk` at a time.
extern "C" int sdfa_freq_lstm(const float* x, const float* w_ih, const float* w_hh,
                              const float* gb, const float* w_proj, const float* b_proj,
                              float* wt, float* xpad, float* xp, float* h, float* part,
                              float* out, int rows, int F, int C, int hidden, int out_dim,
                              int chunk, cudaStream_t stream) {
  if (!takes_hidden(hidden) || out_dim <= 0 || C <= 0 || F <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prep_proj_weights(w_ih, C, wt, 4 * hidden, stream);
  for (int row0 = 0; row0 < rows && err == cudaSuccess; row0 += chunk) {
    const int n = rows - row0 < chunk ? rows - row0 : chunk;
    err = run_chunk(x + (size_t)row0 * F * C, wt, w_hh, gb, w_proj, b_proj, xpad, xp, h, part,
                    out + (size_t)row0 * out_dim, n, F, C, hidden, out_dim, stream);
  }
  return (int)err;
}

// n[0], n[1]: how many clusters of the step kernel the card holds at once at H
// = 128 and at H = 256; n[2]: how many blocks of the wide step loop; n[3]: the
// rows a cluster owns at H = 128 (32 at 256 and in the wide loop, as built by
// default); n[4]: the K range of one partial sum of the output projection.
extern "C" int sdfa_freq_lstm_tiling(int* n) {
  n[3] = FreqDims::RT;
  n[4] = KSLAB;
  cudaError_t err = max_active_clusters(n, freq_steps_kernel(), FreqDims::THREADS,
                                        FreqDims::SMEM, FreqDims::CL);
  if (err == cudaSuccess) err = layer_max_active_clusters<256>(n + 1);
  if (err == cudaSuccess) err = wide_capacity(n + 2, layer_wide_kernel());
  return (int)err;
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
