// Two stacked bidirectional LSTM layers behind one entry point: x (rows, T,
// in) -> (rows, T, 2H) with forward h in [..., :H] and reverse h in
// [..., H:].
//
// Replaces sdfa_tpu/ops/pallas_bilstm2.py:_bilstm2_kernel (entry point
// bilstm_2layer_fused). Layer 2's first forward step needs layer 1's reverse
// output at t = 0, which exists only once layer 1's whole reverse pass is
// done, so all of layer 1 (both directions) precedes layer 2.
//
// What bounds it on the H100: operations. At the flagship shapes (T=64,
// in=256, H=256) a row costs 64 steps x 2 directions x ((256+256) +
// (512+256)) x 1024 multiply-adds = 335 MFLOP in f32; the weights (10 MB) are
// read from device memory once per launch and row chunk.
//
// Design: run_layer_h of bilstm_layer.cuh (the input projection in 3xTF32 on
// the tensor cores, then the step loop with W_hh in the shared memory of a
// cluster: 8 blocks at H = 256, 4 at H = 128) is enqueued twice on the stream
// per row chunk, both layers' W_ih staged once per call before them, layer 1's
// output stack (chunk, T, 2H) in device memory between them. The TPU kernel
// fused the layers to keep that stack in on-chip memory; here a row's stack
// is 128 KB against its 335 MFLOP, at 256 rows the 33.5 MB sit in the 50 MB
// L2, and the kernel boundary is the ordering layer 2 needs (its blocks read
// what other blocks wrote). One cluster holding both directions would need
// 16 blocks, a non-portable size that fits fewer clusters on the card, and
// gains only that round trip. From H = 384 on each layer runs the wide step
// loop of bilstm_layer.cuh instead (W_hh streamed through L2, h.W_hh in
// 3xTF32 on the tensor cores, one grid-wide barrier a step). The caller sizes the scratch: xp (2, chunk, T, 4H) and stack
// (chunk, T, 2H), shared by all chunks. H is any multiple of 128 and the
// first layer's input any width: what the JAX gate sends to its kernel
// (sdfa_tpu/nn/recurrent.py:236-238).
#include "bilstm_layer.cuh"

using namespace bilstm;

namespace {

cudaError_t run_chunks(const float* x, const float* w_ih1, const float* w_hh1, const float* gb1,
                       const float* w_ih2, const float* w_hh2, const float* gb2, float* wt1,
                       float* wt2, float* xpad, float* xp, float* stack, float* out, int rows,
                       int T, int in1, int hidden, int chunk, cudaStream_t stream) {
  cudaError_t err = prep_proj_weights(w_ih1, in1, wt1, 4 * hidden, stream);
  if (err == cudaSuccess) err = prep_proj_weights(w_ih2, 2 * hidden, wt2, 4 * hidden, stream);
  for (int row0 = 0; row0 < rows && err == cudaSuccess; row0 += chunk) {
    const int n = rows - row0 < chunk ? rows - row0 : chunk;
    err = run_layer_h(hidden, x + (size_t)row0 * T * in1, in1, wt1, w_hh1, gb1, xpad, xp, stack,
                      n, T, stream);
    if (err == cudaSuccess)
      err = run_layer_h(hidden, stack, 2 * hidden, wt2, w_hh2, gb2, nullptr, xp,
                        out + (size_t)row0 * T * 2 * hidden, n, T, stream);
  }
  return err;
}

}  // namespace

// wt1 (2, 8 hidden, proj_kw(in1)) and wt2 (2, 8 hidden, proj_kw(2 hidden))
// scratch for the staged W_ih of each layer; xpad (chunk * T, proj_kpad(in1))
// scratch where x needs it (proj_needs_pad), else null.
extern "C" int sdfa_bilstm2(const float* x, const float* w_ih1, const float* w_hh1,
                            const float* gb1, const float* w_ih2, const float* w_hh2,
                            const float* gb2, float* wt1, float* wt2, float* xpad, float* xp,
                            float* stack, float* out, int rows, int T, int in1, int hidden,
                            int chunk, cudaStream_t stream) {
  if (!takes_hidden(hidden) || in1 <= 0 || T <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)run_chunks(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2, wt1, wt2, xpad, xp, stack, out,
                         rows, T, in1, hidden, chunk, stream);
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
