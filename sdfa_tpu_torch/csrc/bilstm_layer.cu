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
// the weights once. The design is run_layer_h of bilstm_layer.cuh: the input
// projection as one product ahead of the recurrence (3xTF32 on the tensor
// cores, any input width; W_ih staged transposed and split once per call),
// then the step loop. At H = 128 and 256 the step loop holds W_hh in the
// shared memory of a cluster (4 or 8 blocks); from H = 384 on, where no
// cluster's shared memory holds it, the wide step loop streams W_hh through
// L2 and multiplies on the tensor cores in 3xTF32, one grid-wide barrier a
// step. The JAX gate takes any H and input that
// are multiples of 128 (sdfa_tpu/nn/recurrent.py:293-296); this one takes any
// H that is a multiple of 128 and any input width.
//
// The rows are walked in chunks of `chunk` rows so that the scratch xp
// (2, chunk, T, 4H) does not grow with the batch; the caller sizes it.
#include "bilstm_layer.cuh"

using namespace bilstm;

namespace {

cudaError_t run_chunks(const float* x, const float* w_ih, const float* w_hh, const float* gb,
                       float* wt, float* xpad, float* xp, float* out, int rows, int T, int in,
                       int hidden, int chunk, cudaStream_t stream) {
  cudaError_t err = prep_proj_weights(w_ih, in, wt, 4 * hidden, stream);
  for (int row0 = 0; row0 < rows && err == cudaSuccess; row0 += chunk) {
    const int n = rows - row0 < chunk ? rows - row0 : chunk;
    err = run_layer_h(hidden, x + (size_t)row0 * T * in, in, wt, w_hh, gb, xpad, xp,
                      out + (size_t)row0 * T * 2 * hidden, n, T, stream);
  }
  return err;
}

}  // namespace

// wt (2, 8 hidden, proj_kw(in)) scratch for the staged W_ih; xpad (chunk * T,
// proj_kpad(in)) scratch where x needs it (proj_needs_pad), else null; xp (2,
// chunk, T, 4 hidden) scratch.
extern "C" int sdfa_bilstm_layer(const float* x, const float* w_ih, const float* w_hh,
                                 const float* gb, float* wt, float* xpad, float* xp, float* out,
                                 int rows, int T, int in, int hidden, int chunk,
                                 cudaStream_t stream) {
  if (!takes_hidden(hidden) || in <= 0 || T <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)run_chunks(x, w_ih, w_hh, gb, wt, xpad, xp, out, rows, T, in, hidden, chunk,
                         stream);
}

// The input projection alone, as the layer kernels run it: xp (2, M, 4 hidden)
// = x (M, in) . w_ih (2, in, 4 hidden) + gb, with the same scratch wt and xpad
// (M, proj_kpad(in)) where x needs it.
extern "C" int sdfa_bilstm_layer_projection(const float* x, const float* w_ih, const float* gb,
                                            float* wt, float* xpad, float* xp, int M, int in,
                                            int hidden, cudaStream_t stream) {
  if (!takes_hidden(hidden) || in <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prep_proj_weights(w_ih, in, wt, 4 * hidden, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)run_proj_h(hidden, x, in, wt, gb, xpad, xp, M, stream);
}

// n[0]: the k depth of a stage of the input projection (its weights' K is
// padded to a multiple); n[1]: how many of its blocks the card holds at once.
extern "C" int sdfa_bilstm_layer_proj_tiling(int* n) {
  n[0] = PBK;
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaFuncSetAttribute(proj_kernel<0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, PROJ_SMEM);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, proj_kernel<0>, PTH, PROJ_SMEM);
  n[1] = sms * per;
  return (int)err;
}

// n[0], n[1]: how many clusters of the step kernel the card holds at once at
// H = 128 and at H = 256.
extern "C" int sdfa_bilstm_layer_clusters(int* n) {
  const cudaError_t err = layer_max_active_clusters<128>(n);
  if (err != cudaSuccess) return (int)err;
  return (int)layer_max_active_clusters<256>(n + 1);
}

// n[0]: how many blocks of the wide step loop the card holds at once; n[1]:
// the rows a block owns, n[2] its units, n[3] the k depth of a stage.
extern "C" int sdfa_bilstm_layer_wide_blocks(int* n) {
  n[1] = WR;
  n[2] = WU;
  n[3] = WK;
  return (int)wide_capacity(n, layer_wide_kernel(), WF_SMEM);
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
