// The biLSTM training core: both directions' recurrences from precomputed
// input projections, forward and backward (BPTT).
//
// Replaces sdfa_tpu/ops/pallas_bilstm_train.py:_fwd_kernel and _bwd_kernel
// (entry point bilstm_core, a custom_vjp). The input projection x.W_ih + b
// and the weight gradient dW_hh = h_prev^T . dg stay outside, as large
// library products, exactly as the JAX package leaves them to XLA.
//
//   forward : xp (2, T, rows, 4H), w_hh (2, H, 4H)
//             -> out (T, rows, 2H), gates (2, T, rows, 4H), c (2, T, rows, H)
//   backward: gates, c, w_hh^T (2, 4H, H), dout (T, rows, 2H)
//             -> dg (2, T, rows, 4H) = d(xp)
//
// Every tensor is indexed by TIME. Direction 1 walks t = T-1 .. 0, so its
// previous step is t + 1; the residuals (post-activation gates i, f, g, o
// and the cell state) sit at the time index they belong to, not at the
// direction's step number as in the Pallas kernel.
//
// What bounds it on the H100. FreqLstm core (T=32, rows=6400, H=128): each
// pass moves xp or dg plus the gates (839 MB each) and c, out or dout
// (210 MB each) through HBM once, about 2.1 GB, against 54 GFLOP of f32
// FMAs in the h.W_hh (d_pre.W_hh^T) product: operations bound it. Time LSTM
// (T=64, rows=100, H=256): 6.7 GFLOP and 84 MB per layer, but only 100 rows
// and 64 dependent steps, each re-reading one direction's 1 MB of w_hh from
// L2: the step latency bounds it, not the card's peak.
//
// Design: one block owns R rows of ONE direction (grid = row blocks x 2) for
// the whole recurrence, H threads, one hidden unit each. h (forward) or
// d_pre (backward) of the block's rows goes through shared memory, because
// every thread needs all of it for the product; c, dh and dc stay in
// registers. Weights stream from L2, each loaded value feeding R FMAs, with
// the shared operand read as float4. R is 16 (H=128) or 8 (H=256) when that
// still gives a block to every SM, else 4. No atomics: one thread owns each
// output element, so results repeat bit for bit. f32 throughout.
#include <cuda_runtime.h>

namespace {

constexpr int kSMs = 132;  // H100: use the large row tile only if it still fills the card

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int H, int R>
__global__ void __launch_bounds__(H)
core_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                float* __restrict__ out, float* __restrict__ gates, float* __restrict__ cs,
                int T, int rows) {
  constexpr int G = 4 * H;
  __shared__ __align__(16) float hs[R][H];
  const int j = threadIdx.x;  // hidden unit
  const int d = blockIdx.y;   // direction
  const int row0 = blockIdx.x * R;
  const float* wh = w_hh + (size_t)d * H * G + j;

  float c_state[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c_state[r] = 0.0f;
    hs[r][j] = 0.0f;
  }
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    const size_t base = ((size_t)d * T + t) * rows;  // (d, t, 0) in row units

    float g[4][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const float* p = xp + (base + row) * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q][r] = row < rows ? __ldg(p + q * H) : 0.0f;
    }
    for (int k = 0; k < H; k += 4) {
      float w[4][4];  // [k offset][gate]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[kk][q] = __ldg(wh + (size_t)(k + kk) * G + q * H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(&hs[r][k]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          g[q][r] += hv.x * w[0][q];
          g[q][r] += hv.y * w[1][q];
          g[q][r] += hv.z * w[2][q];
          g[q][r] += hv.w * w[3][q];
        }
      }
    }
    __syncthreads();  // every read of hs for this step is done

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float gi = sigm(g[0][r]), gf = sigm(g[1][r]), gg = tanhf(g[2][r]),
                  go = sigm(g[3][r]);
      const float cn = gf * c_state[r] + gi * gg;
      c_state[r] = cn;
      const float h = go * tanhf(cn);
      hs[r][j] = h;
      const int row = row0 + r;
      if (row < rows) {
        out[((size_t)t * rows + row) * (2 * H) + d * H + j] = h;
        float* gp = gates + (base + row) * G + j;
        gp[0] = gi; gp[H] = gf; gp[2 * H] = gg; gp[3 * H] = go;
        cs[(base + row) * H + j] = cn;
      }
    }
    __syncthreads();  // h of this step visible to the block
  }
}

template <int H, int R>
__global__ void __launch_bounds__(H)
core_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                const float* __restrict__ w_hht, const float* __restrict__ dout,
                float* __restrict__ dg, int T, int rows) {
  constexpr int G = 4 * H;
  __shared__ __align__(16) float dpre[R][G];
  const int j = threadIdx.x;
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const float* wt = w_hht + (size_t)d * G * H + j;  // w_hh^T[d][k][j]

  float dh[R], dc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dh[r] = dc[r] = 0.0f;

  for (int step = T - 1; step >= 0; --step) {
    const int t = d == 0 ? step : T - 1 - step;
    const int t_prev = d == 0 ? t - 1 : t + 1;  // the direction's previous step
    const size_t base = ((size_t)d * T + t) * rows;
    const size_t base_prev = ((size_t)d * T + t_prev) * rows;

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      float di = 0.0f, df = 0.0f, dgg = 0.0f, dgo = 0.0f;
      if (row < rows) {
        const float* gp = gates + (base + row) * G + j;
        const float gi = __ldg(gp), gf = __ldg(gp + H), gg = __ldg(gp + 2 * H),
                    go = __ldg(gp + 3 * H);
        const float c = __ldg(cs + (base + row) * H + j);
        const float c_prev = step > 0 ? __ldg(cs + (base_prev + row) * H + j) : 0.0f;
        const float tc = tanhf(c);
        const float dh_tot = __ldg(dout + ((size_t)t * rows + row) * (2 * H) + d * H + j) + dh[r];
        const float dcv = dc[r] + dh_tot * go * (1.0f - tc * tc);
        di = dcv * gg * gi * (1.0f - gi);
        df = dcv * c_prev * gf * (1.0f - gf);
        dgg = dcv * gi * (1.0f - gg * gg);
        dgo = dh_tot * tc * go * (1.0f - go);
        dc[r] = dcv * gf;
        float* op = dg + (base + row) * G + j;
        op[0] = di; op[H] = df; op[2 * H] = dgg; op[3 * H] = dgo;
      }
      dpre[r][j] = di; dpre[r][H + j] = df; dpre[r][2 * H + j] = dgg; dpre[r][3 * H + j] = dgo;
    }
    if (step == 0) break;  // dh of the first step is used by nothing
    __syncthreads();  // d_pre of the block's rows written

    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    for (int k = 0; k < G; k += 4) {
      const float w0 = __ldg(wt + (size_t)k * H), w1 = __ldg(wt + (size_t)(k + 1) * H),
                  w2 = __ldg(wt + (size_t)(k + 2) * H), w3 = __ldg(wt + (size_t)(k + 3) * H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(&dpre[r][k]);
        acc[r] += p.x * w0;
        acc[r] += p.y * w1;
        acc[r] += p.z * w2;
        acc[r] += p.w * w3;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) dh[r] = acc[r];
    __syncthreads();  // every read of d_pre is done before the next step overwrites it
  }
}

template <int H, int R>
int launch_fwd(const float* xp, const float* w_hh, float* out, float* gates, float* cs, int T,
               int rows, cudaStream_t stream) {
  core_fwd_kernel<H, R><<<dim3((rows + R - 1) / R, 2), H, 0, stream>>>(xp, w_hh, out, gates, cs,
                                                                      T, rows);
  return (int)cudaGetLastError();
}

template <int H, int R>
int launch_bwd(const float* gates, const float* cs, const float* w_hht, const float* dout,
               float* dg, int T, int rows, cudaStream_t stream) {
  core_bwd_kernel<H, R><<<dim3((rows + R - 1) / R, 2), H, 0, stream>>>(gates, cs, w_hht, dout,
                                                                      dg, T, rows);
  return (int)cudaGetLastError();
}

// true if row tiles of `big` rows, times two directions, still give every SM a block
bool fills_card(int rows, int big) { return 2 * ((rows + big - 1) / big) >= kSMs; }

}  // namespace

extern "C" int sdfa_bilstm_core_fwd(const float* xp, const float* w_hh, float* out, float* gates,
                                    float* cs, int T, int rows, int hidden,
                                    cudaStream_t stream) {
  if (T <= 0 || (hidden != 128 && hidden != 256)) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  if (hidden == 128)
    return fills_card(rows, 16) ? launch_fwd<128, 16>(xp, w_hh, out, gates, cs, T, rows, stream)
                                : launch_fwd<128, 4>(xp, w_hh, out, gates, cs, T, rows, stream);
  return fills_card(rows, 8) ? launch_fwd<256, 8>(xp, w_hh, out, gates, cs, T, rows, stream)
                             : launch_fwd<256, 4>(xp, w_hh, out, gates, cs, T, rows, stream);
}

extern "C" int sdfa_bilstm_core_bwd(const float* gates, const float* cs, const float* w_hht,
                                    const float* dout, float* dg, int T, int rows, int hidden,
                                    cudaStream_t stream) {
  if (T <= 0 || (hidden != 128 && hidden != 256)) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  if (hidden == 128)
    return fills_card(rows, 16)
               ? launch_bwd<128, 16>(gates, cs, w_hht, dout, dg, T, rows, stream)
               : launch_bwd<128, 4>(gates, cs, w_hht, dout, dg, T, rows, stream);
  return fills_card(rows, 8) ? launch_bwd<256, 8>(gates, cs, w_hht, dout, dg, T, rows, stream)
                             : launch_bwd<256, 4>(gates, cs, w_hht, dout, dg, T, rows, stream);
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
