// One bidirectional LSTM layer over time: x (rows, T, in) -> (rows, T, 2H)
// with forward h in [..., :H] and reverse h in [..., H:].
//
// Replaces sdfa_tpu/ops/pallas_bilstm.py:_bilstm_kernel (entry point
// bilstm_layer_fused), which the JAX package runs per layer for every
// bidirectional stack that is not two layers deep.
//
// What bounds it on the H100: operations. A row costs T x 2 directions x
// (in + H) x 4H f32 multiply-adds (67 MFLOP at T=64, in=256, H=256); device
// memory sees x, the output and one round trip of the projection scratch, and
// the weights once. The design is run_layer<H> of bilstm_layer.cuh: the input
// projection as one tiled product ahead of the recurrence, then the step loop
// with W_hh held in the shared memory of a cluster (8 blocks at H = 256, 4 at
// H = 128). The JAX gate takes any H and input that are multiples of 128
// (sdfa_tpu/nn/recurrent.py:293-296); this one takes H of 128 and 256 and
// inputs up to 512 wide, and the port's modules route any other shape to the
// plain recurrence before they launch.
//
// The rows are walked in chunks of `chunk` rows so that the scratch xp
// (2, chunk, T, 4H) does not grow with the batch; the caller sizes it.
#include "bilstm_layer.cuh"

using namespace bilstm;

namespace {

template <int HH>
cudaError_t run_chunks(const float* x, const float* w_ih, const float* w_hh, const float* gb,
                       float* xp, float* out, int rows, int T, int in, int chunk,
                       cudaStream_t stream) {
  for (int row0 = 0; row0 < rows; row0 += chunk) {
    const int n = rows - row0 < chunk ? rows - row0 : chunk;
    const cudaError_t err = run_layer<HH>(x + (size_t)row0 * T * in, in, w_ih, w_hh, gb, xp,
                                          out + (size_t)row0 * T * 2 * HH, n, T, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int sdfa_bilstm_layer(const float* x, const float* w_ih, const float* w_hh,
                                 const float* gb, float* xp, float* out, int rows, int T, int in,
                                 int hidden, int chunk, cudaStream_t stream) {
  if ((hidden != 128 && hidden != 256) || in <= 0 || in > INMAX || T <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)(hidden == 128
                   ? run_chunks<128>(x, w_ih, w_hh, gb, xp, out, rows, T, in, chunk, stream)
                   : run_chunks<256>(x, w_ih, w_hh, gb, xp, out, rows, T, in, chunk, stream));
}

// n[0], n[1]: how many clusters of the step kernel the card holds at once at
// H = 128 and at H = 256.
extern "C" int sdfa_bilstm_layer_clusters(int* n) {
  const cudaError_t err = layer_max_active_clusters<128>(n);
  if (err != cudaSuccess) return (int)err;
  return (int)layer_max_active_clusters<256>(n + 1);
}

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
