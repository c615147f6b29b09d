// One bidirectional LSTM layer over time: x (rows, T, in) -> (rows, T, 2H)
// with forward h in [..., :H] and reverse h in [..., H:]; the input
// projection x_t.W_ih is computed in the kernel and both directions run in
// one step loop.
//
// Replaces sdfa_tpu/ops/pallas_bilstm.py:_bilstm_kernel (entry point
// bilstm_layer_fused), which the JAX package runs per layer for every
// bidirectional stack that is not two layers deep. It is one layer of the
// fused 2-layer kernel: the step loop is run_layer of bilstm_layer.cuh,
// called once.
//
// What bounds it on the H100: a row costs T x 2 directions x (in + 256) x
// 1024 multiply-adds (67 MFLOP at T=64, in=256), and every step re-reads the
// layer's weights (2 MB at in=256, 3 MB at in=512, f32) from L2, so L2->SM
// bandwidth and f32 FMA throughput bound it; HBM sees only x and the output.
#include "bilstm_layer.cuh"

namespace {

using namespace bilstm;

__global__ void __launch_bounds__(THREADS)
bilstm_layer_kernel(const float* __restrict__ x, int in, const float* __restrict__ w_ih,
                    const float* __restrict__ w_hh, const float* __restrict__ gb,
                    float* __restrict__ out, int rows, int T) {
  __shared__ Smem sm;
  run_layer(sm, x, in, w_ih, w_hh, gb, out, rows, T, blockIdx.x * R);
}

}  // namespace

extern "C" int sdfa_bilstm_layer(const float* x, const float* w_ih, const float* w_hh,
                                 const float* gb, float* out, int rows, int T, int in,
                                 int hidden, cudaStream_t stream) {
  if (hidden != H || in <= 0 || in > INMAX || T <= 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  bilstm_layer_kernel<<<(rows + R - 1) / R, THREADS, 0, stream>>>(x, in, w_ih, w_hh, gb, out,
                                                                 rows, T);
  return (int)cudaGetLastError();
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
