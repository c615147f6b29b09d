// One bidirectional LSTM layer over a block's rows: the step loop shared by
// the fused 2-layer kernel (bilstm2.cu) and the per-layer kernel
// (bilstm_layer.cu). Included by both; each builds its own copy.
//
// One block owns R=4 rows. 512 threads: threads 0..255 run the forward
// direction and 256..511 the reverse, one hidden unit each, four gates x R
// rows in registers; h lives in shared memory, c in registers. Each loaded
// weight value feeds R FMAs. f32 throughout (expf/tanhf, no fast-math).
#pragma once
#include <cuda_runtime.h>

namespace bilstm {

constexpr int H = 256;            // hidden units per direction
constexpr int G = 4 * H;          // gate width
constexpr int R = 4;              // rows per block
constexpr int THREADS = 2 * H;    // one thread per (direction, hidden unit)
constexpr int INMAX = 2 * H;      // widest layer input (layer 2: 2H)

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

struct Smem {
  float xs[2][R][INMAX];  // this step's input rows, per direction
  float hs[2][R][H];      // recurrent state h, per direction
};

// One bidirectional layer over the block's R rows. xin (rows, T, in) may be
// the stack written earlier in this kernel, so it is read with ld.global.cg
// (L2), never through the read-only path.
__device__ void run_layer(Smem& sm, const float* xin, int in, const float* __restrict__ w_ih,
                          const float* __restrict__ w_hh, const float* __restrict__ gb,
                          float* yout, int rows, int T, int row0) {
  const int tid = threadIdx.x;
  const int d = tid / H;  // direction of this thread
  const int j = tid % H;  // hidden unit of this thread

  float c_state[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c_state[r] = 0.0f;
    sm.hs[d][r][j] = 0.0f;
  }
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = gb ? gb[d * G + q * H + j] : 0.0f;
  const float* wi = w_ih + (size_t)d * in * G + j;
  const float* wh = w_hh + (size_t)d * H * G + j;

  for (int step = 0; step < T; ++step) {
    for (int i = tid; i < 2 * R * in; i += THREADS) {
      const int dd = i / (R * in), rem = i % (R * in);
      const int r = rem / in, c = rem % in, row = row0 + r;
      const int t = dd == 0 ? step : T - 1 - step;
      sm.xs[dd][r][c] = row < rows ? __ldcg(xin + ((size_t)row * T + t) * in + c) : 0.0f;
    }
    __syncthreads();  // x tile loaded; h of the previous step visible

    float g[4][R];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r) g[q][r] = bias[q];
    for (int c = 0; c < in; ++c) {
      const float w0 = wi[(size_t)c * G], w1 = wi[(size_t)c * G + H],
                  w2 = wi[(size_t)c * G + 2 * H], w3 = wi[(size_t)c * G + 3 * H];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = sm.xs[d][r][c];
        g[0][r] += xv * w0; g[1][r] += xv * w1; g[2][r] += xv * w2; g[3][r] += xv * w3;
      }
    }
    for (int k = 0; k < H; ++k) {
      const float w0 = wh[k * G], w1 = wh[k * G + H], w2 = wh[k * G + 2 * H],
                  w3 = wh[k * G + 3 * H];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hv = sm.hs[d][r][k];
        g[0][r] += hv * w0; g[1][r] += hv * w1; g[2][r] += hv * w2; g[3][r] += hv * w3;
      }
    }
    __syncthreads();  // every read of hs and xs for this step is done

    const int t = d == 0 ? step : T - 1 - step;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float cn = sigm(g[1][r]) * c_state[r] + sigm(g[0][r]) * tanhf(g[2][r]);
      c_state[r] = cn;
      const float h = sigm(g[3][r]) * tanhf(cn);
      sm.hs[d][r][j] = h;
      const int row = row0 + r;
      if (row < rows) yout[((size_t)row * T + t) * (2 * H) + d * H + j] = h;
    }
  }
  __syncthreads();  // the layer's output is complete and visible to the block
}

}  // namespace bilstm
