// Two stacked bidirectional LSTM layers, fused: x (rows, T, in) ->
// (rows, T, 2H) with forward h in [..., :H] and reverse h in [..., H:].
//
// Replaces sdfa_tpu/ops/pallas_bilstm2.py:_bilstm2_kernel (entry point
// bilstm_2layer_fused). Phase 1 runs layer 1 (forward over t = 0..T-1 and
// reverse over t = T-1..0, concurrently) and writes its (T, 2H) output per
// row into a scratch stack; phase 2 runs layer 2 from that stack. Layer 2's
// first forward step needs layer 1's reverse output at t = 0, which exists
// only once the whole reverse pass is done, so the two phases cannot
// overlap. Input projections x_t.W_ih are computed in the kernel.
//
// What bounds it on the H100: at the flagship shapes (T=64, in=256,
// H=256) a row costs 64 steps x 2 directions x ((256+256) + (512+256)) x
// 1024 multiply-adds = 335 MFLOP, and every step re-reads the step's
// weights (layer 1: 2 MB, layer 2: 3 MB per direction, f32) — ~640 MB
// of weight reads per block over the recurrence. All weights (~10 MB) sit
// in the 50 MB L2, so L2->SM bandwidth and f32 FMA throughput bound the kernel;
// HBM sees only x, the stack and the output. One row's layer-1 stack is
// 64 x 512 f32 = 128 KB, too large to keep a row tile's stack in shared
// memory, so it lives in a global scratch tensor the wrapper allocates (at
// serving sizes it stays L2-resident).
//
// Design: one block owns R=4 rows for both layers, so no other block ever
// reads its stack. 512 threads: threads 0..255 run the forward direction
// and 256..511 the reverse, one hidden unit each, four gates x R rows in
// registers; h lives in shared memory, c in registers. Each loaded weight
// value feeds R FMAs. f32 throughout (expf/tanhf, no fast-math).
#include "bilstm_layer.cuh"

namespace {

using namespace bilstm;

__global__ void __launch_bounds__(THREADS)
bilstm2_kernel(const float* __restrict__ x, int in1, const float* __restrict__ w_ih1,
               const float* __restrict__ w_hh1, const float* __restrict__ gb1,
               const float* __restrict__ w_ih2, const float* __restrict__ w_hh2,
               const float* __restrict__ gb2, float* stack, float* __restrict__ out,
               int rows, int T) {
  __shared__ Smem sm;
  const int row0 = blockIdx.x * R;
  run_layer(sm, x, in1, w_ih1, w_hh1, gb1, stack, rows, T, row0);
  run_layer(sm, stack, 2 * H, w_ih2, w_hh2, gb2, out, rows, T, row0);
}

}  // namespace

extern "C" int sdfa_bilstm2(const float* x, const float* w_ih1, const float* w_hh1,
                            const float* gb1, const float* w_ih2, const float* w_hh2,
                            const float* gb2, float* stack, float* out, int rows, int T,
                            int in1, int hidden, cudaStream_t stream) {
  if (hidden != H || in1 <= 0 || in1 > INMAX || T <= 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  bilstm2_kernel<<<(rows + R - 1) / R, THREADS, 0, stream>>>(
      x, in1, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2, stack, out, rows, T);
  return (int)cudaGetLastError();
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
