// One bidirectional LSTM layer over time: x (rows, T, in) -> (rows, T, 2H)
// with forward h in [..., :H] and reverse h in [..., H:].
//
// Replaces sdfa_tpu/ops/pallas_bilstm.py:_bilstm_kernel (entry point
// bilstm_layer_fused), which the JAX package runs per layer for every
// bidirectional stack that is not two layers deep.
//
// What bounds it on the H100: operations. A row costs T x 2 directions x
// (in + 256) x 1024 f32 multiply-adds (67 MFLOP at T=64, in=256); device
// memory sees x, the output and one round trip of the projection scratch, and
// the weights once. The design is run_layer of bilstm_layer.cuh: the input
// projection as one tiled product ahead of the recurrence, then the step loop
// with W_hh held in the shared memory of an 8-block cluster.
//
// The rows are walked in chunks of `chunk` rows so that the scratch xp
// (2, chunk, T, 4H) does not grow with the batch; the caller sizes it.
#include "bilstm_layer.cuh"

using namespace bilstm;

extern "C" int sdfa_bilstm_layer(const float* x, const float* w_ih, const float* w_hh,
                                 const float* gb, float* xp, float* out, int rows, int T, int in,
                                 int hidden, int chunk, cudaStream_t stream) {
  if (hidden != H || in <= 0 || in > INMAX || T <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  for (int row0 = 0; row0 < rows; row0 += chunk) {
    const int n = rows - row0 < chunk ? rows - row0 : chunk;
    const cudaError_t err = run_layer(x + (size_t)row0 * T * in, in, w_ih, w_hh, gb, xp,
                                      out + (size_t)row0 * T * 2 * H, n, T, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// *n: how many clusters of the step kernel the card holds at once.
extern "C" int sdfa_bilstm_layer_clusters(int* n) { return (int)layer_max_active_clusters(n); }

#ifdef SDFA_STEP_CLOCKS
// out[0..3]: SM clocks thread 0 of the first block spent in the product, the
// warp exchanges, the cell + sending h, and the barrier + output, summed over
// the last launch's steps.
extern "C" int sdfa_bilstm_layer_step_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, step_clocks, sizeof(long long) * STEP_PARTS);
}
#endif

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
