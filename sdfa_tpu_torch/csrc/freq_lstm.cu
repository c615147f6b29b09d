// FreqLstm "full" mode, fused: x (rows, F, C) -> (rows, OUT).
//
// Replaces sdfa_tpu/ops/pallas_freq_lstm.py:_freq_lstm_kernel (entry
// point freq_lstm_fused). Per row: input projection x_f.W_ih, the forward
// (f = 0..F-1) and reverse (f = F-1..0) recurrences h.W_hh with torch gate
// order i, f, g, o, and the output projection
//   out = sum_f h_fwd(f).W_proj[f, 0] + h_rev(f).W_proj[f, 1] + b_proj,
// where W_proj's row index is f*2H + d*H + h. The (rows, F*2H) concat is
// never written: each step's h is folded into a per-row accumulator.
//
// What bounds it on the H100: at the flagship shapes (F=32, C=64, H=128,
// OUT=256) a row costs 32 steps x 2 directions x (64+128)x512 + 128x256
// multiply-adds = 16.8 MFLOP and reads 8 KB of input; the weights
// (W_ih 256 KB, W_hh 512 KB, W_proj 8 MB, all f32) are re-read by every
// block at every step. With 16 rows per block that is ~32 MB of weight
// reads per block, served from the 50 MB L2 that holds all ~9 MB of
// weights: the kernel is bound by L2->SM bandwidth and f32 FMA throughput, not
// by HBM (4 clips x 768 frames move 25 MB of activations in total).
//
// Design: one block owns a tile of R=16 rows for the whole recurrence;
// h of both directions lives in shared memory, c in registers, and the
// (16 x 256) output accumulator in registers (one output column per
// thread). Each thread computes the four gates of one hidden unit for
// 8 rows, so every weight value it loads from L2 feeds 8 FMAs. W_hh
// (256 KB per direction) exceeds a block's 227 KB of shared memory, so
// weights are read through L2/L1 rather than staged. Arithmetic is f32
// throughout (expf/tanhf, no fast-math).
#include <cuda_runtime.h>

namespace {

constexpr int H = 128;           // hidden units per direction
constexpr int G = 4 * H;         // gate width
constexpr int OUT = 256;         // projection width
constexpr int R = 16;            // rows per block
constexpr int THREADS = 256;
constexpr int RG = THREADS / H;  // row groups in the gate phase
constexpr int RPT = R / RG;      // rows per thread in the gate phase
constexpr int CMAX = 128;        // largest input width the x tile holds
static_assert(THREADS == OUT, "one output column per thread");

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(THREADS)
freq_lstm_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                 const float* __restrict__ w_hh, const float* __restrict__ gb,
                 const float* __restrict__ w_proj, const float* __restrict__ b_proj,
                 float* __restrict__ out, int rows, int F, int C) {
  __shared__ float xs[R][CMAX];
  __shared__ float hs[2][R][H];

  const int tid = threadIdx.x;
  const int j = tid % H;   // hidden unit of this thread's gates
  const int rg = tid / H;  // which RPT-row slice of the tile
  const int row0 = blockIdx.x * R;

  float c_state[2][RPT];
  float acc[R];
#pragma unroll
  for (int r = 0; r < RPT; ++r) c_state[0][r] = c_state[1][r] = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  for (int i = tid; i < 2 * R * H; i += THREADS) (&hs[0][0][0])[i] = 0.0f;
  __syncthreads();

  for (int step = 0; step < F; ++step) {
    for (int d = 0; d < 2; ++d) {
      const int f = d == 0 ? step : F - 1 - step;
      for (int i = tid; i < R * C; i += THREADS) {
        const int r = i / C, c = i % C, row = row0 + r;
        xs[r][c] = row < rows ? x[((size_t)row * F + f) * C + c] : 0.0f;
      }
      __syncthreads();

      float g[4][RPT];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float b = gb ? gb[d * G + q * H + j] : 0.0f;
#pragma unroll
        for (int r = 0; r < RPT; ++r) g[q][r] = b;
      }
      const float* wi = w_ih + (size_t)d * C * G + j;
      for (int c = 0; c < C; ++c) {
        const float w0 = wi[c * G], w1 = wi[c * G + H], w2 = wi[c * G + 2 * H],
                    w3 = wi[c * G + 3 * H];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float xv = xs[rg * RPT + r][c];
          g[0][r] += xv * w0; g[1][r] += xv * w1; g[2][r] += xv * w2; g[3][r] += xv * w3;
        }
      }
      const float* wh = w_hh + (size_t)d * H * G + j;
      for (int k = 0; k < H; ++k) {
        const float w0 = wh[k * G], w1 = wh[k * G + H], w2 = wh[k * G + 2 * H],
                    w3 = wh[k * G + 3 * H];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float hv = hs[d][rg * RPT + r][k];
          g[0][r] += hv * w0; g[1][r] += hv * w1; g[2][r] += hv * w2; g[3][r] += hv * w3;
        }
      }
      __syncthreads();  // every read of hs[d] for this step is done

#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float cn = sigm(g[1][r]) * c_state[d][r] + sigm(g[0][r]) * tanhf(g[2][r]);
        c_state[d][r] = cn;
        hs[d][rg * RPT + r][j] = sigm(g[3][r]) * tanhf(cn);
      }
      __syncthreads();

      // out[:, tid] += h_d(f) . W_proj[f*2H + d*H + k, tid]
      const float* wp = w_proj + ((size_t)f * 2 * H + (size_t)d * H) * OUT + tid;
      for (int k = 0; k < H; ++k) {
        const float w = wp[(size_t)k * OUT];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += hs[d][r][k] * w;
      }
    }
  }

  const float b = b_proj ? b_proj[tid] : 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row < rows) out[(size_t)row * OUT + tid] = acc[r] + b;
  }
}

}  // namespace

extern "C" int sdfa_freq_lstm(const float* x, const float* w_ih, const float* w_hh,
                              const float* gb, const float* w_proj, const float* b_proj,
                              float* out, int rows, int F, int C, int hidden, int out_dim,
                              cudaStream_t stream) {
  if (hidden != H || out_dim != OUT || C > CMAX || C <= 0 || F <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  freq_lstm_kernel<<<(rows + R - 1) / R, THREADS, 0, stream>>>(
      x, w_ih, w_hh, gb, w_proj, b_proj, out, rows, F, C);
  return (int)cudaGetLastError();
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
