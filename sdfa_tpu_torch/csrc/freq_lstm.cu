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
//    blocks, 32 rows), from H = 384 on the wide step loop (W_hh streamed
//    through L2, h.W_hh in 3xTF32 on the tensor cores, blocks of 64 rows, one
//    grid-wide barrier a step). h (rows, F, 2H) goes to scratch.
// 3. out_parts_kernel + out_sum_kernel: out = h.reshape(rows, F 2H).W_proj +
//    b_proj, in 3xTF32 on the tensor cores (see "the output projection"
//    below). With 256 output columns and a few hundred rows a plain tiling has
//    a dozen tiles for 132 multiprocessors, so K = F 2H is split in slabs of
//    KSLAB, one block per (tile, slab), partial sums to scratch;
//    out_sum_kernel adds the slabs in slab order in f32, then the bias. No
//    atomics: results repeat bit for bit. OUT is a run-time width.
//
// Scratch, sized by the caller: W_ih staged (2, 8H, K padded to 32) for the
// call; for one chunk of rows xp 2 x 4H floats per
// (row, f) pair (128 KB a row at F = 32, H = 128), h 2H floats per pair (32
// KB a row), the partial sums F 2H / KSLAB x OUT floats a row (16 KB). The
// caller takes whole waves of resident clusters (of the wide loop's row tiles,
// both directions) as a chunk (62 clusters of 4 on the H100 at H = 128: 992
// rows), so no chunk ends in a barely filled wave of its own making.
//
// The recurrence in f32 (expf/tanhf, no fast-math), both projections in
// 3xTF32 (f32-grade operands, the tensor cores' truncating f32 sums), sums in
// another order than the plain version's.
#include "bilstm_layer.cuh"

using namespace bilstm;

namespace {

constexpr int KSLAB = 512;  // K range of one partial sum of the output projection

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

// --- the output projection: part[s] (M, N) = h[:, slab s] . W_proj[slab s] ---
//
// Replaces the TPU kernel's last step, acc += h_new . w_proj[d, step]
// (sdfa_tpu/ops/pallas_freq_lstm.py:255-266, 3 bf16 passes in its precise
// mode). What bounds it on the H100: operations, 2 M K N FLOP a call (3.2
// GFLOP at a request's 768 rows, K = 8192, N = 256), and below a few hundred
// rows the 8-67 MB of W_proj it reads. It runs on the tensor cores in 3xTF32
// (each f32 operand as hi + lo, two TF32 values; hi.hi + hi.lo + lo.hi,
// missing lo.lo, under 2^-22 of each product): three passes at 495 TFLOP/s
// against one at 67 on the FMA units.
//
// TF32 wgmma reads B only K-major from shared memory, and W_proj comes (K, N)
// with N fastest. Rather than stage W_proj transposed (a pass over all of it,
// 8-67 MB, on every call), the kernel computes the transposed product,
// part^T (N, M) = W_proj^T . h^T: A = W_proj^T comes from registers, so any
// layout of W's tile serves (each thread reads its fragments from the tile
// as copied, [k][n], and splits them in registers); B = h^T, whose K-major
// form is h as the step loop wrote it, (M, K) with k fastest. A stage copies
// a 32 k x 128 row tile of h (the 128-byte swizzle, as proj_kernel's weight
// strips) and a 32 k x 128 column tile of W_proj (rows padded to OW_LD floats
// so that a warp's fragment reads fall in 32 banks), both with cp.async; each
// thread splits the 16-byte chunks of h it copied itself, hi in place and lo
// into a tile beside it, then fence.proxy.async and one block barrier a stage
// make them the products' B. W_proj is read once a call, in f32, and nothing
// outlives the call: a weight updated in place is always seen.
//
// A block of two warpgroups owns OBN columns x OBM rows (each warpgroup 64
// columns, wgmma m64n128k8 over the 128 rows) over one slab; a 2-stage ring,
// one copy in flight, two blocks a multiprocessor. Sum order: for each k tile
// of OBK from the slab's first and each k step of 8 in it, hi.hi, hi.lo,
// lo.hi into one accumulator, never promoted (the slabs keep the tensor
// cores' truncating sums 512 deep); then out_sum_kernel. On the H100 out lands
// 3.4-4.4e-6 of its largest value from a float64 product at K = 8192 to 32768
// (chip_smoke.py's output projection rows). The accumulators (part^T) go
// through shared memory once the products are done, so that each warp stores
// whole rows of part. Its rows are independent of M: a row's bits do not
// depend on the rows that share its call.
//
// Edges: rows of h past M and columns of W past N read as zero (the copies'
// source size) and are never stored; W_proj's rows are copied 16 bytes at a
// time where N is a multiple of 4 and W_proj 16-byte aligned (VEC), else 4
// bytes at a time. h is the caller's scratch (16-byte rows: K a multiple of 4).
constexpr int OBN = 128, OBM = 128, OBK = 32, OTH = 256;  // tile columns, rows, k a stage; threads
constexpr int OSTAGES = 2;                 // ring depth: one copy in flight
constexpr int OROW = OBK * 4;              // a row of h's tile: 128 bytes, one swizzle row
constexpr int OH_BYTES = OBM * OROW;       // h's tile (hi after the split), and its lo part
constexpr int OW_LD = OBN + 8;             // floats a k row of W's tile (8 t + g: 32 banks)
constexpr int OW_BYTES = OBK * OW_LD * 4;
constexpr int OSTAGE_BYTES = 2 * OH_BYTES + OW_BYTES;  // 49 KB
constexpr int OOUT_LD = OBN + 4;  // floats a row of the staged output tile (8 t + g: 32 banks)
constexpr int OUT_SMEM =
    (OSTAGES * OSTAGE_BYTES > OBM * OOUT_LD * 4 ? OSTAGES * OSTAGE_BYTES : OBM * OOUT_LD * 4) +
    1024;                                  // + room to align the ring to 1024 B
static_assert(OSTAGE_BYTES % 1024 == 0 && OH_BYTES % 1024 == 0, "descriptor tiles on 1024 B");
static_assert(OROW == 128 && OTH / 8 == 32 && OBM % 32 == 0, "h's copy layout");
static_assert(OBN == 4 * 32 && OTH == 2 * 128 && OBK % 8 == 0, "W's copy, the warpgroups");
static_assert(KSLAB % OBK == 0, "whole k tiles a slab");

// grid (ceil(N / OBN), ceil(M / OBM), slabs), OTH threads, OUT_SMEM bytes of
// dynamic shared memory. h (M, K) with K % 4 == 0 and 16-byte rows; W_proj (K,
// N); part (slabs, M, N).
template <bool VEC>
__global__ void __launch_bounds__(OTH, 2)
out_parts_kernel(const float* __restrict__ h, const float* __restrict__ w_proj,
                 float* __restrict__ part, int M, int K, int N) {
  using namespace tf32mma;
  extern __shared__ uint8_t out_smem[];
  const uint32_t ring_off = ((smem_u32(out_smem) + 1023u) & ~1023u) - smem_u32(out_smem);
  const uint32_t ring = smem_u32(out_smem) + ring_off;
  uint8_t* const ring_p = out_smem + ring_off;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int n0 = blockIdx.x * OBN, m0 = blockIdx.y * OBM;
  const int k0 = blockIdx.z * KSLAB, k1 = min(K, k0 + KSLAB);
  const int nk = (k1 - k0 + OBK - 1) / OBK;

  // h's copy: thread (r0, c) moves 16-byte chunk c of rows r0, r0 + 32, ...;
  // rows 32 apart share r % 8, so its swizzled chunk is one.
  const int c = tid % 8, r0 = tid / 8;
  const uint32_t h_dst = (uint32_t)(r0 * OROW + ((c ^ (r0 & 7)) << 4));
  const float* h_src = h + (size_t)(m0 + r0) * K + c * 4;
  // W's copy (VEC): thread (wr, wc) moves 16-byte chunk wc of k rows wr, wr + 8, ...
  const int wc = tid % 32, wr = tid / 32;
  auto load = [&](int kt, int slot) {
    const uint32_t st = ring + slot * OSTAGE_BYTES, sw = st + 2 * OH_BYTES;
    const int kb = k0 + kt * OBK;
    const bool k_ok = kb + c * 4 < k1;
#pragma unroll
    for (int i = 0; i < OBM / 32; ++i) {
      const bool ok = k_ok && m0 + r0 + 32 * i < M;
      cp_async16(st + h_dst + i * 32 * OROW, ok ? h_src + (size_t)i * 32 * K + kb : h,
                 ok ? 16 : 0);
    }
    if (VEC) {
#pragma unroll
      for (int i = 0; i < OBK / 8; ++i) {
        const int k = kb + wr + 8 * i, n = n0 + 4 * wc;
        const bool ok = k < k1 && n < N;
        cp_async16(sw + ((wr + 8 * i) * OW_LD + 4 * wc) * 4,
                   ok ? w_proj + (size_t)k * N + n : w_proj, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < OBK * OBN / OTH; ++i) {
        const int e = tid + OTH * i, kr = e / OBN, nn = e % OBN;
        const int k = kb + kr, n = n0 + nn;
        const bool ok = k < k1 && n < N;
        cp_async4(sw + (kr * OW_LD + nn) * 4, ok ? w_proj + (size_t)k * N + n : w_proj,
                  ok ? 4 : 0);
      }
    }
  };

  // This thread's A fragment of a k step (8 k): a[0] (g, t), a[1] (g + 8, t),
  // a[2] (g, t + 4), a[3] (g + 8, t + 4) of its warp's 16 rows of A = W^T, that
  // is W's tile at k row t (+ 4) and column nb + g (+ 8).
  const int g = lane / 4, t = lane % 4;
  const int nb = wg * 64 + 16 * ((tid % 128) / 32);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int s = 0; s < OSTAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<OSTAGES - 2>();  // this thread's copies of tile kt have landed
    const int slot = kt % OSTAGES;
    uint8_t* const st_p = ring_p + slot * OSTAGE_BYTES;
    // h's chunks this thread copied: hi in place, lo into the tile beside
#pragma unroll
    for (int i = 0; i < OBM / 32; ++i) {
      float4* const p = reinterpret_cast<float4*>(st_p + h_dst + i * 32 * OROW);
      const float4 v = *p;
      float4 hi, lo;
      hi.x = __uint_as_float(tf32_bits(v.x)); lo.x = __uint_as_float(tf32_bits(v.x - hi.x));
      hi.y = __uint_as_float(tf32_bits(v.y)); lo.y = __uint_as_float(tf32_bits(v.y - hi.y));
      hi.z = __uint_as_float(tf32_bits(v.z)); lo.z = __uint_as_float(tf32_bits(v.z - hi.z));
      hi.w = __uint_as_float(tf32_bits(v.w)); lo.w = __uint_as_float(tf32_bits(v.w - hi.w));
      *p = hi;
      *reinterpret_cast<float4*>(st_p + OH_BYTES + h_dst + i * 32 * OROW) = lo;
    }
    // wgmma reads shared memory through the async proxy: make the split visible to it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // every tile of kt is in place; everyone is done with tile kt - 1's slot
    const int nxt = kt + OSTAGES - 1;
    if (nxt < nk) load(nxt, nxt % OSTAGES);
    cp_async_commit();
    const float* ws = reinterpret_cast<const float*>(st_p + 2 * OH_BYTES) + nb + g;
    uint32_t hi[OBK / 8][4], lo[OBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < OBK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = ws[(8 * kk + t + 4 * (i >> 1)) * OW_LD + 8 * (i & 1)];
        hi[kk][i] = tf32_bits(v);
        lo[kk][i] = tf32_bits(v - __uint_as_float(hi[kk][i]));
      }
    const uint32_t stage = ring + slot * OSTAGE_BYTES;
    const uint64_t dh = smem_desc(stage), dl = smem_desc(stage + OH_BYTES);
    wgmma_fence();  // the fragments are written: order them before the products read them
#pragma unroll
    for (int kk = 0; kk < OBK / 8; ++kk) {
      wgmma_m64n128k8_tf32_rs(acc, hi[kk], dh + 2 * kk);
      wgmma_m64n128k8_tf32_rs(acc, hi[kk], dl + 2 * kk);
      wgmma_m64n128k8_tf32_rs(acc, lo[kk], dh + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    // the products read the fragments until the wait: keep their registers till here
#pragma unroll
    for (int kk = 0; kk < OBK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(hi[kk][i]), "r"(lo[kk][i]));
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // The output tile through the ring, transposed back: this thread holds
  // part^T's rows (columns of part) nb + g and nb + g + 8 at part's rows 8 j +
  // 2 t, + 1; then warp w stores rows w, w + 8, ... of the tile, lane l its
  // columns 4 l .. 4 l + 3.
  __syncthreads();  // both warpgroups' products are done with the ring
  float* tile = reinterpret_cast<float*>(ring_p);
#pragma unroll
  for (int j = 0; j < OBM / 8; ++j) {
    float* const o = tile + (8 * j + 2 * t) * OOUT_LD + nb + g;
    o[0] = acc[4 * j];
    o[OOUT_LD] = acc[4 * j + 1];
    o[8] = acc[4 * j + 2];
    o[OOUT_LD + 8] = acc[4 * j + 3];
  }
  __syncthreads();
  float* const out = part + (size_t)blockIdx.z * M * N;
  const int n = n0 + 4 * lane;
  for (int r = tid / 32; r < OBM && m0 + r < M; r += OTH / 32) {
    const float4 v = *reinterpret_cast<const float4*>(tile + r * OOUT_LD + 4 * lane);
    float* const o = out + (size_t)(m0 + r) * N + n;
    if (VEC) {
      if (n < N) *reinterpret_cast<float4*>(o) = v;
    } else {
      if (n < N) o[0] = v.x;
      if (n + 1 < N) o[1] = v.y;
      if (n + 2 < N) o[2] = v.z;
      if (n + 3 < N) o[3] = v.w;
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

// The output projection of M rows: out (M, N) = h (M, K) . w_proj (K, N) +
// b_proj, part (slabs, M, N) scratch.
template <bool VEC>
cudaError_t launch_out_proj(const float* h, const float* w_proj, const float* b_proj,
                            float* part, float* out, int M, int K, int N, cudaStream_t stream) {
  // granted on the device that is current: also on a thread that launches first
  cudaError_t err = cudaFuncSetAttribute(out_parts_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, OUT_SMEM);
  if (err != cudaSuccess) return err;
  const int slabs = (K + KSLAB - 1) / KSLAB;
  const dim3 grid((N + OBN - 1) / OBN, (M + OBM - 1) / OBM, slabs);
  out_parts_kernel<VEC><<<grid, OTH, OUT_SMEM, stream>>>(h, w_proj, part, M, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int items = VEC ? M * (N / 4) : M * N;
  out_sum_kernel<VEC><<<(items + 255) / 256, 256, 0, stream>>>(part, b_proj, out, M, N, slabs);
  return cudaGetLastError();
}

cudaError_t run_out_proj(const float* h, const float* w_proj, const float* b_proj, float* part,
                         float* out, int M, int K, int N, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (K <= 0 || K % 4 || N <= 0) return cudaErrorInvalidValue;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w_proj) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b_proj) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch_out_proj<true>(h, w_proj, b_proj, part, out, M, K, N, stream)
             : launch_out_proj<false>(h, w_proj, b_proj, part, out, M, K, N, stream);
}

// The step loop over a chunk's n rows at H units, from xp into h.
cudaError_t run_steps(const float* xp, const float* w_hh, float* h, int n, int F, int H,
                      cudaStream_t stream) {
  if (H > 256)
    return wide_run(layer_wide_kernel(), WF_SMEM, H, n, stream, xp, w_hh, h, (float*)nullptr,
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
  return run_out_proj(h, w_proj, b_proj, part, out, n, F * 2 * H, N, stream);
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
// rows a cluster owns at H = 128 (32 at 256; a block of the wide loop owns
// WR); n[4]: the K range of one partial sum of the output projection.
extern "C" int sdfa_freq_lstm_tiling(int* n) {
  n[3] = FreqDims::RT;
  n[4] = KSLAB;
  cudaError_t err = max_active_clusters(n, freq_steps_kernel(), FreqDims::THREADS,
                                        FreqDims::SMEM, FreqDims::CL);
  if (err == cudaSuccess) err = layer_max_active_clusters<256>(n + 1);
  if (err == cudaSuccess) err = wide_capacity(n + 2, layer_wide_kernel(), WF_SMEM);
  return (int)err;
}

// The output projection alone, as a chunk runs it: out (M, N) = h (M, K) .
// w_proj (K, N) + b_proj (or none), part (ceil(K / KSLAB), M, N) scratch.
extern "C" int sdfa_freq_lstm_output_projection(const float* h, const float* w_proj,
                                                const float* b_proj, float* part, float* out,
                                                int M, int K, int N, cudaStream_t stream) {
  if (M < 0) return (int)cudaErrorInvalidValue;
  return (int)run_out_proj(h, w_proj, b_proj, part, out, M, K, N, stream);
}

// n[0]: the k depth of a stage of the output projection; n[1]: how many of its
// blocks the card holds at once.
extern "C" int sdfa_freq_lstm_out_tiling(int* n) {
  n[0] = OBK;
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaFuncSetAttribute(out_parts_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, OUT_SMEM);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, out_parts_kernel<true>, OTH,
                                                        OUT_SMEM);
  n[1] = sms * per;
  return (int)err;
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
