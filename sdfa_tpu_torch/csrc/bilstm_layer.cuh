// One bidirectional LSTM layer on the H100: the code shared by the per-layer
// kernel (bilstm_layer.cu), the 2-layer kernel (bilstm2.cu), the training core
// (bilstm_core.cu) and FreqLstm (freq_lstm.cu). Each includes it and builds its
// own copy.
//
// Replaces the body the two Pallas kernels share, sdfa_tpu/ops/
// pallas_bilstm.py:_bilstm_kernel and pallas_bilstm2.py:_bilstm2_kernel (the
// in-kernel projection x_t.W_ih followed by the 64-step recurrence).
//
// What bounds it on this card: operations. A row costs T x 2 directions x
// (in + 256) x 1024 multiply-adds in f32, and the part that depends on the
// previous step (h.W_hh, a third to a half of them) is a chain of T dependent
// steps. A step loop that re-reads its weights every step runs at the pace L2
// feeds them; the design below reads every weight from device memory once
// per launch. What is left in a step is the product itself, where the FMA
// units and the shared-memory loads that feed them (16 bytes a lane for 8 to
// 16 FMAs) are about equally busy, then the cell's expf/tanhf and the cluster
// barrier, which no warp's product overlaps.
//
// Design, two kernels per layer and row chunk:
//
// 1. proj_kernel: xp[d] = x . W_ih[d] (+ gate bias) for every (row, t) of
//    the chunk and both directions at once: nothing in it depends on the
//    recurrence, so it is one product outside the dependent chain, on the
//    tensor cores in 3xTF32 (wgmma: see "the input projection" below;
//    proj_weights_kernel stages W_ih transposed and split once per call). xp (2, rows, T, 4H) is scratch in device memory, written once and
//    read once. The kernel is a template on the gate width (4 x 256 or 4 x
//    128; 0: at run time).
// 2. steps_kernel (as described at H = 256; at H = 128 a cluster is 4
//    blocks, 64 KB of W_hh each): a cluster of CL = 8 blocks owns RT = 32 rows of one
//    direction. One direction's W_hh is 256 x 1024 f32 = 1 MB: no block's
//    shared memory holds it, eight blocks' do. Block s keeps the four gates
//    of hidden units 32s .. 32s+31 (hidden unit j owns gate columns j, H+j,
//    2H+j, 3H+j, so a block's 128 columns are four strided runs of 32),
//    128 KB, loaded once per launch. Each step it multiplies the full h
//    (its own shared-memory copy) by its slice, adds the xp slab it asked
//    for before the product, applies the cell to its 32 units (c in
//    registers), writes its h slice to the output and into the h buffer of
//    all 8 blocks through distributed shared memory, and meets the cluster
//    at a barrier. h is double-buffered: peers write step t+1's h into the
//    buffer nobody reads during step t.
//    The barrier and the h exchange are latency, not work, so the 32 rows
//    are two sub-tiles of 16 that take turns: a block arrives at the barrier
//    for sub-tile A, multiplies B, and only then waits for A's h.
//    256 threads: a warp holds 8 units x 8 rows x 4 gates with k split in
//    four interleaved quarters over its lanes (32 accumulators a thread, h
//    read as four broadcast float4, the weights as one float4 per k); two
//    warp exchanges sum the quarters and leave each lane the 2 rows x 4
//    gates it finishes. No block-level barrier inside a step.
//    The step loop is a template on the hidden width, the rows of a sub-tile
//    and the tensors' order: the training core (bilstm_core.cu) runs the same
//    step indexed by time, with the gates and the cell state written out as
//    well, at H = 256 and at H = 128 (a cluster of 4 blocks); FreqLstm runs
//    it over its frequency steps, a row's steps together, at H = 128 and
//    (as the layer kernels' instantiation) 256, and the layer kernels at
//    either width (run_layer_h).
// 3. From H = 384 on (any multiple of 128), where no cluster's shared memory
//    holds one direction's W_hh, wide_steps_kernel and wide_bwd_kernel below
//    take the step loop's place for all four kernels: W_hh streamed through
//    L2, the step's product in 3xTF32 on the tensor cores, one grid-wide
//    barrier a step (see "the wide step loop").
//
// The recurrence in f32 (expf/tanhf, correctly rounded reciprocal, no
// fast-math), its sums in another order than the plain version's: k in four
// interleaved quarters for h.W_hh (the wide loop: 3xTF32, k tile by k tile of
// WK, see there). x.W_ih in 3xTF32, k tile by k tile of 32 and
// within a tile k step by k step of 8 (hi.hi, hi.lo, lo.hi), the bias last:
// ops/bilstm_layer.py::projection_tiled computes it that way.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace bilstm {

namespace cg = cooperative_groups;

// --- the input projection: xp[d] (M, GW) = x (M, K) . W_ih[d] (K, GW) + gb[d] ---
// GW is the gate width, 4 x the hidden width: 4 x 256 or 4 x 128 as a template
// argument; GW = 0 takes it at run time (`gw`, the wide step loop's 4 x 384 and up).
//
// 3xTF32 on the tensor cores: with v = hi + lo for each f32 operand (hi =
// rna(v), lo = rna(v - hi), two TF32 values, 22 bits together), x . W = x_hi
// W_hi + x_hi W_lo + x_lo W_hi (missing x_lo W_lo, under 2^-22 of each product).
// What bounds it on the H100: operations, 3 passes of 2 M K 8H FLOP at 495
// TFLOP/s (TF32), and for K = 64 (FreqLstm) the xp it writes, 2 M 4H floats at
// 3.35 TB/s. TF32 wgmma takes both operands K-major, and W_ih comes (2, K, GW),
// so proj_weights_kernel first writes W_ih^T split into its two parts, wt (2, 2
// GW, KW): part 0 hi, part 1 lo, row d GW + c the column c of W_ih[d], K padded
// with zeros to KW = a multiple of PBK. It runs in the same C launch as the
// product, on every call (0.5-8 MB of wt at the shipped widths, 2-9 us on the
// H100): no split weights outlive the call, so an update of W_ih in place is
// always seen.
//
// proj_kernel then runs as csrc/decode_solve.cu's split_product_kernel: a block
// of two warpgroups owns a PBM x PBN tile of xp (64 rows a warpgroup); 16-byte
// cp.async copies fill a ring of PSTAGES stages of PBK k (x, W hi, W lo: 48 KB a
// stage, one 128-byte swizzle row per matrix row); each thread reads its x
// fragments of a stage from shared memory, splits them in registers, and issues
// the three products a k step with A from registers and B through descriptors
// (wgmma m64n128k8, f32 accumulators in registers, never promoted). Sum order:
// for each k tile of PBK from k = 0 on and each k step of 8 in it, hi.hi, hi.lo,
// lo.hi into one accumulator; then the gate bias. The tensor cores' f32 sums do
// not round to nearest, and their error grows with K: on the H100 xp lands 6e-7
// (K = 64) to 7.9e-6 (K = 1024) of the largest |xp| from a float64 product,
// where a float32 product is 2-7e-7 from it (chip_smoke.py's projection rows;
// promoting the sums to f32 registers would cost 64 registers a thread, beyond
// two blocks a multiprocessor). The output tile goes through shared memory (the
// ring, once the products are done) so that every warp stores whole 512-byte
// rows of xp as float4.
//
// x is read with 16-byte copies: K a multiple of 4 and x 16-byte aligned.
// Otherwise (one route, `proj_needs_pad`) proj_pad_kernel first copies x into
// the caller's scratch xpad (M, K rounded up to 4), zero-filled. Rows past M and
// k past K read as zero (the copy's source size); rows past M are never stored.

constexpr int PBM = 128, PBN = 128, PBK = 32, PTH = 256;  // tile rows, columns, k a stage; threads
constexpr int PSTAGES = 2;                                 // ring depth: one copy in flight
constexpr int PROW = PBK * 4;                              // a tile row of a stage: 128 bytes
constexpr int PA_BYTES = PBM * PROW, PB_BYTES = PBN * PROW;
constexpr int PSTAGE_BYTES = PA_BYTES + 2 * PB_BYTES;      // 48 KB
constexpr int POUT_LD = PBN + 8;  // floats a row of the staged output tile: the float2 writes of
                                  // a half-warp (8 rows x 4 column pairs) fall in 32 banks
constexpr int PROJ_SMEM =
    (PSTAGES * PSTAGE_BYTES > PBM * POUT_LD * 4 ? PSTAGES * PSTAGE_BYTES : PBM * POUT_LD * 4) +
    1024;                                                  // + room to align the ring to 1024 B
constexpr int PGROUP = 16;  // row tiles walked together: the blocks that run at once share
                            // their x rows and W columns through L2 (W hi + lo is 64 MB at
                            // H = 1024, K = 1024)
static_assert(PROW == 128 && PTH / 8 == 32 && PBM % 32 == 0 && PBN % 32 == 0, "copy layout");
static_assert(PBN == 4 * 32 && PTH == 2 * 128, "epilogue: a warp stores a row as 32 float4");

// KW: the weight strips' K, padded to whole k tiles.
inline int proj_kw(int K) { return (K + PBK - 1) / PBK * PBK; }
// Whether x goes through xpad first: 16-byte copies need K % 4 == 0 and x aligned.
inline bool proj_needs_pad(const float* x, int K) {
  return K % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0;
}
// Columns of xpad: K rounded up to 4.
inline int proj_kpad(int K) { return (K + 3) / 4 * 4; }

// wt (2, 2 gw, KW) from w_ih (2, K, gw): transposed, split, zero from K on.
// grid (KW / 32, 2 gw / 32), 256 threads: a 32 x 32 tile through shared memory,
// read along the gate columns and written along k.
static __global__ void __launch_bounds__(256)
proj_weights_kernel(const float* __restrict__ w_ih, float* __restrict__ wt, int K, int KW,
                    int gw) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;  // n over both directions' 2 gw
  const int d = n0 / gw, c0 = n0 % gw;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8)
    tile[i][tx] = k0 + i < K ? w_ih[((size_t)d * K + k0 + i) * gw + c0 + tx] : 0.0f;
  __syncthreads();
  const size_t part = (size_t)2 * gw * KW;
  for (int i = ty; i < 32; i += 8) {
    const float v = tile[tx][i];  // (k0 + tx, n0 + i)
    const float hi = __uint_as_float(tf32mma::tf32_bits(v));
    const size_t at = (size_t)(n0 + i) * KW + k0 + tx;
    wt[at] = hi;
    wt[part + at] = __uint_as_float(tf32mma::tf32_bits(v - hi));
  }
}

// xpad (M, kp) = x (M, K), zero from K on
static __global__ void __launch_bounds__(256)
proj_pad_kernel(const float* __restrict__ x, float* __restrict__ xpad, int M, int K, int kp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * kp) return;
  const size_t m = i / kp;
  const int k = (int)(i % kp);
  xpad[i] = k < K ? x[m * K + k] : 0.0f;
}

// grid (2 gw / PBN x ceil(M / PBM)), PTH threads, PROJ_SMEM bytes of dynamic
// shared memory. x (M, K) with K % 4 == 0 and 16-byte rows; wt (2, 2 gw, KW)
// from proj_weights_kernel; gb (2, gw) or null.
template <int GW>
static __global__ void __launch_bounds__(PTH, 2)
proj_kernel(const float* __restrict__ x, const float* __restrict__ wt,
            const float* __restrict__ gb, float* __restrict__ xp, int M, int K, int KW,
            int gw_arg) {
  using namespace tf32mma;
  extern __shared__ uint8_t proj_smem[];
  const uint32_t ring_off = ((smem_u32(proj_smem) + 1023u) & ~1023u) - smem_u32(proj_smem);
  const uint32_t ring = smem_u32(proj_smem) + ring_off;
  const int gw = GW > 0 ? GW : gw_arg;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;

  // the tile: PGROUP row tiles at a time, their row tiles fastest, then the columns
  const int ntn = 2 * gw / PBN, ntm = (M + PBM - 1) / PBM;
  const int per_group = PGROUP * ntn, first = (int)blockIdx.x / per_group * PGROUP;
  const int rows_in = ntm - first < PGROUP ? ntm - first : PGROUP;
  const int in_group = (int)blockIdx.x % per_group;
  const int m0 = (first + in_group % rows_in) * PBM;
  const int n0 = in_group / rows_in * PBN;  // over both directions' 2 gw columns
  const int nk = KW / PBK;

  // The copy: thread (r0, c) moves 16-byte chunk c of rows r0, r0 + 32, ... of
  // the three strips; rows 32 apart share r % 8, so its swizzled chunk is one.
  const int c = tid % 8, r0 = tid / 8;
  const uint32_t dst0 = (uint32_t)(r0 * PROW + ((c ^ (r0 & 7)) << 4));
  const float* a_src = x + (size_t)(m0 + r0) * K + c * 4;
  const float* bh_src = wt + (size_t)(n0 + r0) * KW + c * 4;
  const float* bl_src = bh_src + (size_t)2 * gw * KW;
  auto load = [&](int kt, int slot) {
    const uint32_t sa = ring + slot * PSTAGE_BYTES + dst0, sh = sa + PA_BYTES,
                   sl = sh + PB_BYTES;
    const bool k_ok = kt * PBK + c * 4 < K;
#pragma unroll
    for (int i = 0; i < PBM / 32; ++i) {
      const bool ok = k_ok && m0 + r0 + 32 * i < M;
      cp_async16(sa + i * 32 * PROW, ok ? a_src + (size_t)i * 32 * K + kt * PBK : x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < PBN / 32; ++i) {
      cp_async16(sh + i * 32 * PROW, bh_src + (size_t)i * 32 * KW + kt * PBK, 16);
      cp_async16(sl + i * 32 * PROW, bl_src + (size_t)i * 32 * KW + kt * PBK, 16);
    }
  };

  // This thread's A fragment of a k step (8 columns): a[0] (g, t), a[1] (g + 8,
  // t), a[2] (g, t + 4), a[3] (g + 8, t + 4), rows of its warp's 16 in its
  // warpgroup's 64, g = lane / 4, t = lane % 4. Rows 8 apart share the swizzle
  // (row % 8 = g): column 8 kk + 4 h lies in chunk (2 kk + h) ^ g of its row.
  const int g = lane / 4;
  const uint8_t* frag =
      proj_smem + ring_off + (wg * 64 + 16 * ((tid % 128) / 32) + g) * PROW + (lane % 4) * 4;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int s = 0; s < PSTAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<PSTAGES - 2>();  // this thread's copies of tile kt have landed
    // wgmma reads shared memory through the async proxy: make the copies visible to it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // everyone's have; and everyone is done with tile kt - 1's slot
    const int nxt = kt + PSTAGES - 1;
    if (nxt < nk) load(nxt, nxt % PSTAGES);
    cp_async_commit();
    const int slot = kt % PSTAGES;
    uint32_t hi[PBK / 8][4], lo[PBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < PBK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = *reinterpret_cast<const float*>(
            frag + slot * PSTAGE_BYTES + (i & 1) * 8 * PROW + (((2 * kk + (i >> 1)) ^ g) << 4));
        hi[kk][i] = tf32_bits(v);
        lo[kk][i] = tf32_bits(v - __uint_as_float(hi[kk][i]));
      }
    const uint32_t stage = ring + slot * PSTAGE_BYTES;
    const uint64_t dh = smem_desc(stage + PA_BYTES), dl = smem_desc(stage + PA_BYTES + PB_BYTES);
    wgmma_fence();  // the fragments are written: order them before the products read them
#pragma unroll
    for (int kk = 0; kk < PBK / 8; ++kk) {
      wgmma_m64n128k8_tf32_rs(acc, hi[kk], dh + 2 * kk);
      wgmma_m64n128k8_tf32_rs(acc, hi[kk], dl + 2 * kk);
      wgmma_m64n128k8_tf32_rs(acc, lo[kk], dh + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    // the products read the fragments until the wait: keep their registers till here
#pragma unroll
    for (int kk = 0; kk < PBK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(hi[kk][i]), "r"(lo[kk][i]));
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // The output tile through the ring: each thread writes its accumulators
  // (rows g and g + 8 of its warp's 16, columns 8 j + 2 t, + 1), then warp w
  // stores rows w, w + 8, ... of the tile, lane l its columns 4 l .. 4 l + 3.
  __syncthreads();  // both warpgroups' products are done with the ring
  float* tile = reinterpret_cast<float*>(proj_smem + ring_off);
  const int row = wg * 64 + 16 * ((tid % 128) / 32) + g;
#pragma unroll
  for (int j = 0; j < PBN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(tile + row * POUT_LD + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(tile + (row + 8) * POUT_LD + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  const int d = n0 / gw, col = n0 % gw + 4 * lane;  // n0 never straddles the directions
  const float4 bias = gb ? *reinterpret_cast<const float4*>(gb + (size_t)d * gw + col)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = tid / 32; r < PBM && m0 + r < M; r += PTH / 32) {
    float4 v = *reinterpret_cast<const float4*>(tile + r * POUT_LD + 4 * lane);
    v.x += bias.x; v.y += bias.y; v.z += bias.z; v.w += bias.w;
    *reinterpret_cast<float4*>(xp + ((size_t)d * M + m0 + r) * gw + col) = v;
  }
}

// wt (2, 2 gw, proj_kw(K)) from w_ih (2, K, gw) on `stream`: once per call of
// a kernel, before its row chunks.
inline cudaError_t prep_proj_weights(const float* w_ih, int K, float* wt, int gw,
                                     cudaStream_t stream) {
  const int kw = proj_kw(K);
  proj_weights_kernel<<<dim3(kw / 32, 2 * gw / 32), 256, 0, stream>>>(w_ih, wt, K, kw, gw);
  return cudaGetLastError();
}

// proj_kernel over M rows of x (M, in) on `stream`: xp (2, M, GW), or (2, M,
// gw) with GW = 0. wt from prep_proj_weights; xpad (M, proj_kpad(in)) scratch,
// used (and needed) only where proj_needs_pad.
template <int GW>
inline cudaError_t launch_proj(const float* x, int in, const float* wt, const float* gb,
                               float* xpad, float* xp, int M, cudaStream_t stream, int gw = GW) {
  if (M <= 0) return cudaSuccess;
  if (gw % PBN) return cudaErrorInvalidValue;
  int K = in;
  if (proj_needs_pad(x, in)) {
    if (!xpad) return cudaErrorInvalidValue;
    K = proj_kpad(in);
    const size_t n = (size_t)M * K;
    proj_pad_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(x, xpad, M, in, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    x = xpad;
  }
  // granted on the device that is current: also on a thread that launches first
  cudaError_t err = cudaFuncSetAttribute(proj_kernel<GW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, PROJ_SMEM);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(2 * gw / PBN) * (unsigned)((M + PBM - 1) / PBM);
  proj_kernel<GW><<<blocks, PTH, PROJ_SMEM, stream>>>(x, wt, gb, xp, M, K, proj_kw(in), gw);
  return cudaGetLastError();
}

// --- the recurrence: one cluster per (row tile, direction) ---------------------

constexpr int UPB = 32;  // hidden units per block, whatever the width: a cluster is HH / UPB blocks

// Sizes of the step loop at HH hidden units with RG row groups of 8 rows to a
// sub-tile. The layer kernels run <256, 2>: 8 blocks, 32 rows, 256 threads.
template <int HH, int RG>
struct StepDims {
  static constexpr int CL = HH / UPB;     // blocks per cluster
  static constexpr int G = 4 * HH;        // gate width
  static constexpr int SUB = 8 * RG;      // rows per sub-tile
  static constexpr int RT = 2 * SUB;      // rows per cluster, walked as two sub-tiles
  static constexpr int HS = SUB + 4;      // row stride of the transposed h buffers: the four
                                          // float4 a warp reads per load lie in different banks
  static constexpr int THREADS = 128 * RG;  // warp = (unit group of 8, row group of 8); lane =
                                            // (k quarter, unit)
  static constexpr int WROW = 4 * UPB;      // floats per k of the W_hh slice [k][unit][gate]
  static constexpr int WS_FLOATS = HH * WROW;
  static constexpr int HT_FLOATS = 2 * 2 * HH * HS;  // h, transposed [sub-tile][buffer][k][row]
  static constexpr int SMEM = (WS_FLOATS + HT_FLOATS) * 4;  // <256, 2>: 212,992 of 232,448 B
};

// Where (row, t) lies in the step loop's tensors, in rows of G (xp, gates), of
// 2 HH (out) or of HH (c) floats: the layer kernels keep a row's steps
// together, (rows, T, .); the training core is indexed by time, (T, rows, .).
struct RowMajor {
  static __device__ __forceinline__ size_t pos(int row, int t, int rows, int T) {
    return (size_t)row * T + t;
  }
};
struct TimeMajor {
  static __device__ __forceinline__ size_t pos(int row, int t, int rows, int T) {
    return (size_t)t * rows + row;
  }
};

// 1 / (1 + e^-x) with the correctly rounded reciprocal (what 1.0f / y rounds to)
__device__ __forceinline__ float sigm(float x) { return __frcp_rn(1.0f + expf(-x)); }

// acc[r0 + r][q] += h[r] * w[q] for four rows
__device__ __forceinline__ void fma4(float (&acc)[8][4], int r0, const float4& h,
                                     const float4& w) {
  const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc[r0 + r][0] += hv[r] * w.x;
    acc[r0 + r][1] += hv[r] * w.y;
    acc[r0 + r][2] += hv[r] * w.z;
    acc[r0 + r][3] += hv[r] * w.w;
  }
}

// The cluster's hardware barrier in its two halves. arrive: this thread's
// accesses so far (its stores into the peers' shared memory, its reads of what
// they stored into its own) are released; wait: every thread of the cluster
// has arrived and what they released is visible here.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Block s's slice of one direction's W_hh (HH, 4 HH) into shared memory:
// W_hh[:, q HH + j] for its units j = s UPB .. s UPB + 31, gates interleaved
// per unit, [k][unit][gate] with WROW floats to a k. Read from device memory
// once per launch, by the forward and the backward step loops alike.
template <int HH, int WROW, int THREADS>
__device__ __forceinline__ void load_w_slice(float* ws, const float* wd, int s, int tid) {
  for (int i = tid; i < HH * 4 * UPB; i += THREADS) {
    const int k = i / (4 * UPB), q = (i / UPB) % 4, uu = i % UPB;
    ws[k * WROW + uu * 4 + q] = wd[(size_t)k * (4 * HH) + q * HH + s * UPB + uu];
  }
}

// grid (CL, row tiles, 2 directions), cluster (CL, 1, 1), StepDims::SMEM bytes
// of dynamic shared memory. xp holds the input projections (+ bias) of both
// directions, laid out as Order says. With SAVE the post-activation gates
// i, f, g, o (laid out as xp) and the cell state (as xp, HH wide) are written
// too, each at its (row, t): what a backward pass needs.
//
// Rows do not depend on each other, so the tile's two sub-tiles A and B take
// turns: a block sends its h for A, arrives at the cluster barrier, and
// multiplies B while that h travels and the barrier completes; it waits for
// A's phase only at the end of B's turn, just before A's next product. One
// barrier phase is open at a time (arrive and wait alternate), and no
// block-level barrier is needed inside a step.
//
// Built with -DSDFA_STEP_CLOCKS, thread 0 of the first block adds up the SM
// clocks it spends in each part of a turn (STEP_CLOCK marks the parts).
#ifdef SDFA_STEP_CLOCKS
constexpr int STEP_PARTS = 4;  // product, warp exchanges, cell + sending h, barrier + output
__device__ long long step_clocks[STEP_PARTS];
#define STEP_CLOCK(i)                \
  {                                  \
    const long long now = clock64(); \
    clocks[i] += now - last;         \
    last = now;                      \
  }
#else
#define STEP_CLOCK(i)
#endif
template <int HH, int RG, class Order, bool SAVE, int MINB>
static __global__ void __launch_bounds__(StepDims<HH, RG>::THREADS, MINB)
steps_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
             float* __restrict__ out, float* __restrict__ gates, float* __restrict__ cs,
             int rows, int T) {
  using D = StepDims<HH, RG>;
  constexpr int CL = D::CL, G = D::G, SUB = D::SUB, RT = D::RT, HS = D::HS;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* ht = ws + D::WS_FLOATS;

  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.block_rank();  // which 32 hidden units
  const int d = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kq = lane / 8;                  // this lane sums k = kq, kq + 4, kq + 8, ...
  const int u = 8 * (warp / RG) + lane % 8; // unit within the block
  const int rg = warp % RG;                 // rows 8 rg .. 8 rg + 7 of a sub-tile in the product
  const int j = s * UPB + u;                // hidden unit
  const int rfin = 8 * rg + 2 * kq;         // the two rows of a sub-tile this thread finishes

  load_w_slice<HH, D::WROW, D::THREADS>(ws, w_hh + (size_t)d * HH * G, s, tid);
  for (int i = tid; i < D::HT_FLOATS; i += D::THREADS) ht[i] = 0.0f;
  // every block of the cluster runs and has zeroed its h before a peer writes into it
  cluster.sync();

  float* peer[CL];
#pragma unroll
  for (int b = 0; b < CL; ++b) peer[b] = cluster.map_shared_rank(ht, b);

  float c_state[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  const size_t dir = (size_t)d * rows * T;  // direction d of xp, gates and c, in (row, t) pairs
  const float* xcol = xp + dir * G + j;
  float* ocol = out + d * HH + j;
  const float* wcol = ws + (kq * UPB + u) * 4;
  const bool hi = lane & 16, mid = lane & 8;
#ifdef SDFA_STEP_CLOCKS
  long long clocks[STEP_PARTS] = {0, 0, 0, 0}, last = clock64();
#endif

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    const int cur = step & 1;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row0 = blockIdx.y * RT + a * SUB + rfin;

      // this turn's slab of xp, asked for now and used after the product
      float xv[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xv[r][q] = row0 + r < rows
                         ? __ldcs(xcol + Order::pos(row0 + r, t, rows, T) * G + q * HH) : 0.0f;

      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      const float* hc = ht + ((a * 2 + cur) * HH + kq) * HS + 8 * rg;
#pragma unroll 8
      for (int kk = 0; kk < HH / 4; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(wcol + kk * 16 * UPB);
        const float4 h0 = *reinterpret_cast<const float4*>(hc + kk * 4 * HS);
        const float4 h1 = *reinterpret_cast<const float4*>(hc + kk * 4 * HS + 4);
        fma4(acc, 0, h0, w);
        fma4(acc, 4, h1, w);
      }
      STEP_CLOCK(0)

      // the four k quarters of a unit sit in one warp: two exchanges sum them
      // and leave each lane the two rows it finishes (rows 2 kq, 2 kq + 1 of 8)
      float half[4][4], pre[2][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float send = hi ? acc[r][q] : acc[4 + r][q];
          const float keep = hi ? acc[4 + r][q] : acc[r][q];
          half[r][q] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float send = mid ? half[r][q] : half[2 + r][q];
          const float keep = mid ? half[2 + r][q] : half[r][q];
          pre[r][q] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
      STEP_CLOCK(1)

      float hv[2], act[2][4], cv[2];  // h; the gates after their activations; c
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = pre[r][q] + xv[r][q];
        act[r][0] = sigm(g[0]);
        act[r][1] = sigm(g[1]);
        act[r][2] = tanhf(g[2]);
        act[r][3] = sigm(g[3]);
        const float cn = act[r][1] * c_state[a][r] + act[r][0] * act[r][2];
        c_state[a][r] = cn;
        cv[r] = cn;
        hv[r] = act[r][3] * tanhf(cn);
      }
      const float2 hvec = make_float2(hv[0], hv[1]);
      const int dst = ((a * 2 + 1 - cur) * HH + j) * HS + rfin;
#pragma unroll
      for (int b = 0; b < CL; ++b) *reinterpret_cast<float2*>(peer[b] + dst) = hvec;
      STEP_CLOCK(2)

      // close the phase the other sub-tile opened a turn ago (its h is now
      // visible, and every block is done reading the buffer it replaces), then
      // open this sub-tile's
      if (a == 1 || step > 0) cluster_wait();
      cluster_arrive();
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + r < rows) {
          const size_t p = Order::pos(row0 + r, t, rows, T);
          ocol[p * (2 * HH)] = hv[r];
          if (SAVE) {
#pragma unroll
            for (int q = 0; q < 4; ++q) gates[(dir + p) * G + q * HH + j] = act[r][q];
            cs[(dir + p) * HH + j] = cv[r];
          }
        }
      STEP_CLOCK(3)
    }
  }
  cluster_wait();  // no block leaves while a peer may still write into it
#ifdef SDFA_STEP_CLOCKS
  if (tid == 0 && blockIdx.x + blockIdx.y + blockIdx.z == 0)
    for (int i = 0; i < STEP_PARTS; ++i) step_clocks[i] = clocks[i];
#endif
}

// A launch of `kernel` as clusters of `cl` blocks on `stream`, with `smem`
// bytes of dynamic shared memory (granted to the kernel here, on the device
// that is current: also on a thread that launches it for the first time).
template <class Kernel>
inline cudaError_t cluster_config(cudaLaunchConfig_t& config, cudaLaunchAttribute& attr,
                                  Kernel kernel, dim3 grid, int threads, int smem, int cl,
                                  cudaStream_t stream) {
  config = cudaLaunchConfig_t{};
  config.gridDim = grid;
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// How many clusters of such a launch the card runs at once.
template <class Kernel>
inline cudaError_t max_active_clusters(int* n, Kernel kernel, int threads, int smem, int cl) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const cudaError_t err =
      cluster_config(config, attr, kernel, dim3(cl, 16, 2), threads, smem, cl, 0);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, kernel, &config);
}

// The step loop of a layer at HH hidden units: StepDims<HH, 2>, a row's steps
// together, nothing saved. HH = 256: clusters of 8 blocks, one block to a
// multiprocessor (212,992 B of shared memory). HH = 128: clusters of 4 blocks,
// two to a multiprocessor (106,496 B each, at most 128 registers a thread), so
// that one block's barrier and cell hide behind the other's product: the same
// instantiation as FreqLstm's step loop.
template <int HH>
using LayerDims = StepDims<HH, 2>;
using StepsKernel = void (*)(const float*, const float*, float*, float*, float*, int, int);
template <int HH>
inline StepsKernel layer_steps_kernel() {
  return steps_kernel<HH, 2, RowMajor, false, HH == 128 ? 2 : 1>;
}

// The step loop of one layer over `rows` rows (one chunk) at HH hidden units:
// xp (2, rows, T, 4 HH) -> out (rows, T, 2 HH). A refused launch returns
// CUDA's error: there is no other path.
template <int HH>
inline cudaError_t run_layer_steps(const float* xp, const float* w_hh, float* out, int rows, int T,
                                   cudaStream_t stream) {
  using D = LayerDims<HH>;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_config(config, attr, layer_steps_kernel<HH>(),
                                         dim3(D::CL, (rows + D::RT - 1) / D::RT, 2), D::THREADS,
                                         D::SMEM, D::CL, stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, layer_steps_kernel<HH>(), xp, w_hh, out, (float*)nullptr,
                            (float*)nullptr, rows, T);
}

// How many clusters of a layer's step loop at HH hidden units the card runs at
// once (at H = 256 the H100 holds 15: 256 rows x 2 directions, 16 clusters,
// take two waves).
template <int HH>
inline cudaError_t layer_max_active_clusters(int* n) {
  using D = LayerDims<HH>;
  return max_active_clusters(n, layer_steps_kernel<HH>(), D::THREADS, D::SMEM, D::CL);
}


// --- the wide step loop: H a multiple of 128 from 384 up ------------------------
//
// One direction's W_hh at H = 384 is 2.36 MB: a cluster of H / 32 blocks
// would need 12 of them with 196,608 B of W_hh each beside its h buffers,
// more than the 232,448 B a block has; at H = 512 (4 MB) even a
// non-portable cluster of 16 holds only 3.7 MB. So W_hh is not held: the
// wide loop streams it through L2 (both directions' W_hh are 8 MiB at H = 512
// against a 50 MB L2), and a step is one product per block followed by one
// grid-wide barrier.
//
// One cooperative launch (cudaLaunchAttributeCooperative: every block is
// resident, so `grid.sync()` cannot deadlock) walks all T steps for a wave of
// rows; the rows are walked in waves of whole row tiles whose blocks fit the
// card at once (wide_capacity: resident blocks a multiprocessor x
// multiprocessors). Block (x, y, z), one warpgroup, owns hidden units WU x ..
// WU x + 15 of direction z for rows WR y .. WR y + 63 of the wave, in both
// passes and for the whole launch, so the cell state (forward) and dc
// (backward) stay in registers.
//
// What bounds it on the H100: the latency of a step, not the card's peak. A
// step's product is small (64 rows x 64 columns x H a block forward) and every
// step waits for the one before it, so a block's warps run one after the other:
// the step's first copies, the k tiles' copies, splits and products, the cell,
// the barrier. The product runs on the tensor cores in 3xTF32 (each f32
// operand as TF32 hi + lo; hi.hi + hi.lo + lo.hi, missing lo.lo, under 2^-22
// of each product: three passes at 495 TFLOP/s against one at 67 on the FMA
// units), its operands through a ring of cp.async stages of WK k: one L2
// round trip a step is exposed, the next tiles are in flight behind the
// products. Every W_hh tile a block reads serves its 64 rows. The TF32 parts
// are rounded as cvt.rna rounds (tf32_bits_finite: two integer instructions
// for the finite operands these are, against cvt.rna's four), since a step's
// splits, not its products, were most of its instructions.
//
// Forward (wide_steps_kernel): the block's pre-activations, 64 rows x 64 gate
// columns = h_prev (64 x H) . W_hh[:, its columns], computed transposed,
// pre^T = W_slice^T . h_prev^T: TF32 wgmma reads B K-major only, and W_hh
// lies (H, 4H) with the columns fastest. A = W_slice^T comes from registers,
// so its tile is copied as it lies ([k][column], WK x 64 floats, the columns
// XOR-swizzled by k so that a warp's fragment reads fall in 32 banks) and each
// thread splits its fragments there. B = h_prev is K-major as the step before
// wrote it: the output itself at the previous time index ((rows, 2H), k
// fastest; there is no h buffer), copied in the 128-byte swizzle and split in
// shared memory by the thread that copied each chunk, hi in place and lo
// beside it. wgmma m64n64k8; a 3-stage ring of 24 KB, three blocks a
// multiprocessor.
//
// Backward (wide_bwd_kernel): dh of the block's 64 rows x 16 units is the
// previous step's d_pre of all 4H columns (read back from dg) times W_hh's rows
// of its units, a product of K = 4H, computed directly: A = d_pre, K-major as
// dg holds it, copied in the 128-byte swizzle and split in registers (as
// proj_kernel's x); B = W_hh's unit rows, K-major as they lie, split in shared
// memory. wgmma m64n16k8; a 4-stage ring of 12 KB, three blocks a
// multiprocessor (four would spill). Neither pass stages anything before the call: W_hh is read
// in f32 on every call, an update in place always seen.
//
// The cells: after the last k tile a block's product goes through shared
// memory (a ring slot no copy targets any more), so that each thread takes one
// row and 8 neighbouring units: its xp slab, residuals and d(out) come in, and
// h, the gates, c or d_pre go out, 16 bytes at a time, the slab asked for
// before the step's product.
//
// Coherence: h (d_pre) was written in this launch by other blocks before the
// last grid.sync(); cp.async.cg reads it from L2, past L1. The splits are
// generic stores that wgmma reads through the async proxy: fence.proxy.async,
// then the block barrier of the stage.
//
// Sums: for each k tile of WK from k = 0 on, the tensor cores add its k steps
// of 8 (hi.hi, hi.lo, lo.hi each) into one accumulator, whose sum is then
// added to a total in f32 registers (promoted every k tile: the tensor cores'
// truncating sums never run deeper than WK); then the xp slab (forward) or
// d(out) (backward). The cell in f32 as the cluster step has it (expf/tanhf,
// correctly rounded reciprocal). ops/bilstm_layer.py::wide_steps_tiled and
// ops/bilstm_core.py::wide_backward_steps_tiled walk the same tiling and sums.

constexpr int WR = 64;   // rows a block owns: the forward product's N, the backward's M
constexpr int WU = 16;   // hidden units a block owns: 4 WU = 64 gate columns (the forward's M)
constexpr int WK = 32;   // k depth of a stage
constexpr int WT = 128;  // threads: one warpgroup
constexpr int WROW = WK * 4;  // a K-major tile row of a stage: 128 bytes, one swizzle row
constexpr int WF_STAGES = 3;                                  // the forward's ring
constexpr int WF_H_BYTES = WR * WROW;                         // h's tile (hi), and its lo part
constexpr int WF_W_BYTES = WK * 4 * WU * 4;                   // W_hh's tile, [k][64 columns]
constexpr int WF_STAGE_BYTES = 2 * WF_H_BYTES + WF_W_BYTES;   // 24 KB
constexpr int WF_SMEM = WF_STAGES * WF_STAGE_BYTES + 1024;    // + room to align the ring
constexpr int WB_STAGES = 4;                                  // the backward's ring
constexpr int WB_A_BYTES = WR * WROW;                         // d_pre's tile
constexpr int WB_B_BYTES = WU * WROW;                         // W_hh's unit rows (hi), and lo
constexpr int WB_STAGE_BYTES = WB_A_BYTES + 2 * WB_B_BYTES;   // 12 KB
constexpr int WB_SMEM = WB_STAGES * WB_STAGE_BYTES + 1024;
static_assert(WT == 128 && WR == 64 && WU == 16 && WK == 32 && WROW == 128 && WT / 8 == WU,
              "the tiling and the copies");
static_assert(WF_STAGE_BYTES % 1024 == 0 && WF_H_BYTES % 1024 == 0 && WB_STAGE_BYTES % 1024 == 0 &&
                  WB_A_BYTES % 1024 == 0 && WB_B_BYTES % 1024 == 0,
              "descriptor tiles on 1024 B");

constexpr int WPRE_LD = 4 * WU + 4;  // floats a row of the forward's product re-laid [row][column]
constexpr int WDH_LD = WU + 4;       // floats a row of the backward's dh re-laid [row][unit]
static_assert(WR * WPRE_LD * 4 <= WF_STAGE_BYTES && WR * WDH_LD * 4 <= WB_STAGE_BYTES,
              "the re-laid product fits a ring slot");

// v's hi and lo TF32 parts, each component's (tf32_bits_finite).
__device__ __forceinline__ void split4(const float4& v, float4& hi, float4& lo) {
  using tf32mma::tf32_bits_finite;
  hi.x = __uint_as_float(tf32_bits_finite(v.x));
  hi.y = __uint_as_float(tf32_bits_finite(v.y));
  hi.z = __uint_as_float(tf32_bits_finite(v.z));
  hi.w = __uint_as_float(tf32_bits_finite(v.w));
  lo.x = __uint_as_float(tf32_bits_finite(v.x - hi.x));
  lo.y = __uint_as_float(tf32_bits_finite(v.y - hi.y));
  lo.z = __uint_as_float(tf32_bits_finite(v.z - hi.z));
  lo.w = __uint_as_float(tf32_bits_finite(v.w - hi.w));
}
__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
// Component i (a constant once unrolled) of v.
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The ring's first 1024-byte boundary in a kernel's dynamic shared memory.
__device__ __forceinline__ uint32_t ring_offset(const uint8_t* smem) {
  return ((tf32mma::smem_u32(smem) + 1023u) & ~1023u) - tf32mma::smem_u32(smem);
}

// grid (H / WU, row tiles of the wave, 2 directions), WT threads, WF_SMEM
// bytes of dynamic shared memory, cooperative. `rows` and `T` give the tensors'
// layout (Order), [row0, row0 + nrows) the rows of this launch. With SAVE the
// post-activation gates (laid out as xp) and the cell state (as xp, H wide)
// are written too, as steps_kernel does.
template <class Order, bool SAVE>
static __global__ void __launch_bounds__(WT, 3)
wide_steps_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                  float* out, float* __restrict__ gates, float* __restrict__ cs, int rows,
                  int T, int H, int row0, int nrows) {
  using namespace tf32mma;
  extern __shared__ uint8_t wide_smem[];
  const uint32_t ring_off = ring_offset(wide_smem);
  const uint32_t ring = smem_u32(wide_smem) + ring_off;
  uint8_t* const ring_p = wide_smem + ring_off;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, g = lane / 4, t4 = lane % 4;
  const int d = blockIdx.z, G = 4 * H, nk = H / WK;
  const int u0 = blockIdx.x * WU;  // the block's first unit
  const int rt = row0 + blockIdx.y * WR, end = row0 + nrows;
  const size_t dir = (size_t)d * rows * T;  // direction d of xp, gates and c, in (row, t) pairs
  const float* wd = w_hh + (size_t)d * H * G;

  // Row m of the product (pre^T) is gate m / 16 of unit u0 + m % 16. W's copy:
  // thread (k rows wk, wk + 8, ...; chunk wc) moves W_hh[k][columns of 4 wc .. 4 wc + 3]
  // to the tile's row k at 4 wc XOR (k % 4) 8, k % 4 = wk % 4 for all its rows.
  const int wc = tid % 16, wk = tid / 16;
  const float* w_src = wd + (size_t)wk * G + (wc / 4) * H + u0 + 4 * (wc % 4);
  const uint32_t w_dst =
      2 * WF_H_BYTES + (uint32_t)(wk * 4 * WU + ((4 * wc) ^ ((wk & 3) << 3))) * 4;
  // h's copy: thread (r0, c) moves 16-byte chunk c of tile rows r0, r0 + 16, ...;
  // rows 16 apart share r % 8, so its swizzled chunk is one.
  const int c = tid % 8, r0 = tid / 8;
  const uint32_t h_dst = (uint32_t)(r0 * WROW + ((c ^ (r0 & 7)) << 4));
  // This thread's A fragment of a k step: row 16 w + g (+ 8) at k t4 (+ 4), all of
  // them at k % 4 = t4, so XOR t4 8: a warp's 32 reads fall in 32 banks.
  const int col_a = (16 * w + g) ^ (t4 << 3), col_b = (16 * w + g + 8) ^ (t4 << 3);
  // The cells this thread finishes: row rt + rr, units u0 + uc .. u0 + uc + 7.
  const int rr = tid / 2, uc = 8 * (tid % 2), row = rt + rr;
  const bool row_ok = row < end;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float c_state[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) c_state[u] = 0.0f;

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    const int tp = d == 0 ? t - 1 : t + 1;  // the direction's previous step

    const float* h_src[4];
    bool h_ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt + r0 + 16 * i;
      h_ok[i] = r < end;
      h_src[i] = out + Order::pos(h_ok[i] ? r : row0, tp, rows, T) * (2 * H) + d * H + c * 4;
    }
    auto load = [&](int kt, int slot) {
      const uint32_t st = ring + slot * WF_STAGE_BYTES;
      const int k0 = kt * WK;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cp_async16(st + h_dst + i * 16 * WROW, h_src[i] + k0, h_ok[i] ? 16 : 0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cp_async16(st + w_dst + i * 8 * 4 * WU * 4, w_src + (size_t)(k0 + 8 * i) * G, 16);
    };
    if (step > 0)  // the step's first tiles, asked for before anything else
      for (int s = 0; s < WF_STAGES - 1; ++s) {  // nk >= 12 > WF_STAGES - 1
        load(s, s);
        cp_async_commit();
      }

    // this step's slab of xp (its row, 4 gates x 8 units), asked for now and used after
    // the product
    const size_t p = Order::pos(row_ok ? row : row0, t, rows, T);
    float4 xv[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        xv[q][hh] = row_ok ? __ldcs(reinterpret_cast<const float4*>(
                                 xp + (dir + p) * G + q * H + u0 + uc + 4 * hh))
                           : zero;

    float tot[32];  // the product, promoted every k tile: [j][row g / g + 8][e] as wgmma's
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[i] = 0.0f;

    if (step > 0) {
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<WF_STAGES - 2>();  // this thread's copies of tile kt have landed
        const int slot = kt % WF_STAGES;
        uint8_t* const st_p = ring_p + slot * WF_STAGE_BYTES;
        // h's chunks this thread copied: hi in place, lo into the tile beside
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4* const ph = reinterpret_cast<float4*>(st_p + h_dst + i * 16 * WROW);
          const float4 v = *ph;
          float4 hi, lo;
          split4(v, hi, lo);
          *ph = hi;
          *reinterpret_cast<float4*>(st_p + WF_H_BYTES + h_dst + i * 16 * WROW) = lo;
        }
        // wgmma reads shared memory through the async proxy: make the split visible to it
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();  // every tile of kt is in place; everyone is done with tile kt - 1's slot
        const int nxt = kt + WF_STAGES - 1;
        if (nxt < nk) load(nxt, nxt % WF_STAGES);
        cp_async_commit();
        const float* ws = reinterpret_cast<const float*>(st_p + 2 * WF_H_BYTES) + t4 * 4 * WU;
        uint32_t hi[WK / 8][4], lo[WK / 8][4];
#pragma unroll
        for (int kk = 0; kk < WK / 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = ws[(8 * kk + 4 * (i >> 1)) * 4 * WU + ((i & 1) ? col_b : col_a)];
            hi[kk][i] = tf32_bits_finite(v);
            lo[kk][i] = tf32_bits_finite(v - __uint_as_float(hi[kk][i]));
          }
        const uint32_t stage = ring + slot * WF_STAGE_BYTES;
        const uint64_t dh = smem_desc(stage), dl = smem_desc(stage + WF_H_BYTES);
        float acc[32];
        wgmma_fence();  // the fragments are written: order them before the products read them
#pragma unroll
        for (int kk = 0; kk < WK / 8; ++kk) {
          wgmma_m64n64k8_tf32_rs(acc, hi[kk], dh + 2 * kk, kk > 0);
          wgmma_m64n64k8_tf32_rs(acc, hi[kk], dl + 2 * kk, 1);
          wgmma_m64n64k8_tf32_rs(acc, lo[kk], dh + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        // the products read the fragments until the wait: keep their registers till here,
        // and read the accumulators only after it
#pragma unroll
        for (int kk = 0; kk < WK / 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(hi[kk][i]), "r"(lo[kk][i]));
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          asm volatile("" : "+f"(acc[i])::"memory");
          tot[i] += acc[i];
        }
      }
    }

    // The product through shared memory, [row][column], so that this thread reads its
    // row's 4 gates x 8 units: in the ring slot of tile nk, which no copy of this step
    // targets and which every thread was done with at the last tile's barrier.
    float* const pre_s = reinterpret_cast<float*>(ring_p + (nk % WF_STAGES) * WF_STAGE_BYTES);
    float4 pv[4][2];
    if (step > 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            pre_s[(8 * j + 2 * t4 + e) * WPRE_LD + 16 * w + g + 8 * h] = tot[4 * j + 2 * h + e];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          pv[q][hh] = *reinterpret_cast<const float4*>(pre_s + rr * WPRE_LD + 16 * q + uc + 4 * hh);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) pv[q][0] = pv[q][1] = zero;
    }

    float act[4][8], hv[8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float4 s = add4(pv[q][hh], xv[q][hh]);
        act[q][4 * hh] = s.x;
        act[q][4 * hh + 1] = s.y;
        act[q][4 * hh + 2] = s.z;
        act[q][4 * hh + 3] = s.w;
      }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      act[0][u] = sigm(act[0][u]);
      act[1][u] = sigm(act[1][u]);
      act[2][u] = tanhf(act[2][u]);
      act[3][u] = sigm(act[3][u]);
      c_state[u] = act[1][u] * c_state[u] + act[0][u] * act[2][u];
      hv[u] = act[3][u] * tanhf(c_state[u]);
    }
    if (row_ok) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int u = 4 * hh;
        *reinterpret_cast<float4*>(out + p * (2 * H) + d * H + u0 + uc + u) =
            make_float4(hv[u], hv[u + 1], hv[u + 2], hv[u + 3]);
        if (SAVE) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float4*>(gates + (dir + p) * G + q * H + u0 + uc + u) =
                make_float4(act[q][u], act[q][u + 1], act[q][u + 2], act[q][u + 3]);
          *reinterpret_cast<float4*>(cs + (dir + p) * H + u0 + uc + u) =
              make_float4(c_state[u], c_state[u + 1], c_state[u + 2], c_state[u + 3]);
        }
      }
    }
    if (step + 1 < T) grid.sync();  // this step's h is written everywhere before it is read
  }
}

// grid (H / WU, row tiles of the wave, 2 directions), WT threads, WB_SMEM bytes
// of dynamic shared memory, cooperative: the training core's backward at a
// wide H. Inputs and output are time-ordered as in core_bwd_kernel
// (bilstm_core.cu): gates (2, T, rows, 4H) post-activation, c (2, T, rows, H),
// d(out) (T, rows, 2H) -> dg (2, T, rows, 4H) = d(xp). A block owns the same
// (units, rows, direction) as in the forward and carries their dc in
// registers.
static __global__ void __launch_bounds__(WT, 3)
wide_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                const float* __restrict__ w_hh, const float* __restrict__ dout, float* dg,
                int rows, int T, int H, int row0, int nrows) {
  using namespace tf32mma;
  extern __shared__ uint8_t wide_smem[];
  const uint32_t ring_off = ring_offset(wide_smem);
  const uint32_t ring = smem_u32(wide_smem) + ring_off;
  uint8_t* const ring_p = wide_smem + ring_off;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, g = lane / 4, t4 = lane % 4;
  const int d = blockIdx.z, G = 4 * H, nk = G / WK;
  const int u0 = blockIdx.x * WU;
  const int rt = row0 + blockIdx.y * WR, end = row0 + nrows;
  const size_t dir = (size_t)d * rows * T;
  const float* wd = w_hh + (size_t)d * H * G;

  // d_pre's copy: thread (r0, c) moves chunk c of tile rows r0, r0 + 16, ...; W's:
  // chunk c of unit row r0 (WT / 8 = WU rows). Both in the 128-byte swizzle.
  const int c = tid % 8, r0 = tid / 8;
  const uint32_t a_dst = (uint32_t)(r0 * WROW + ((c ^ (r0 & 7)) << 4));
  const uint32_t b_dst = WB_A_BYTES + a_dst;
  const float* b_src = wd + (size_t)(u0 + r0) * G + c * 4;
  // This thread's A fragment of a k step: rows 16 w + g (+ 8), k t4 (+ 4); rows 8
  // apart share the swizzle (row % 8 = g): k 8 kk + 4 h lies in chunk (2 kk + h) ^ g.
  const uint8_t* frag = ring_p + (16 * w + g) * WROW + t4 * 4;
  // The cells this thread finishes: row rt + rr, units u0 + uc .. u0 + uc + 7.
  const int rr = tid / 2, uc = 8 * (tid % 2), row = rt + rr;
  const bool row_ok = row < end;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float dc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) dc[u] = 0.0f;

  for (int step = T - 1; step >= 0; --step) {
    const int t = d == 0 ? step : T - 1 - step;
    const int tn = d == 0 ? t + 1 : t - 1;  // the step processed before this one
    const int tp = d == 0 ? t - 1 : t + 1;  // the direction's previous step (its c)

    const float* a_src[4];
    bool a_ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt + r0 + 16 * i;
      a_ok[i] = r < end;
      a_src[i] = dg + (dir + (size_t)tn * rows + (a_ok[i] ? r : row0)) * G + c * 4;
    }
    auto load = [&](int kt, int slot) {
      const uint32_t st = ring + slot * WB_STAGE_BYTES;
      const int k0 = kt * WK;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cp_async16(st + a_dst + i * 16 * WROW, a_src[i] + k0, a_ok[i] ? 16 : 0);
      cp_async16(st + b_dst, b_src + k0, 16);
    };
    if (step < T - 1)  // the step's first tiles, asked for before anything else
      for (int s = 0; s < WB_STAGES - 1; ++s) {  // nk >= 48 > WB_STAGES - 1
        load(s, s);
        cp_async_commit();
      }

    // this step's residuals of its row (4 gates, c, c of the previous step, d(out), 8 units
    // each), asked for now and used after the product
    const int rowc = row_ok ? row : row0;
    const size_t p = dir + (size_t)t * rows + rowc;
    const float* g_src = gates + p * G + u0 + uc;
    const float* c_src = cs + p * H + u0 + uc;
    const float* cp_src = cs + (dir + (size_t)tp * rows + rowc) * H + u0 + uc;
    const float* do_src = dout + ((size_t)t * rows + rowc) * (2 * H) + d * H + u0 + uc;
    float4 gv[4][2], cv[2], cpv[2], dov[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gv[q][hh] = row_ok ? __ldcs(reinterpret_cast<const float4*>(g_src + q * H + 4 * hh)) : zero;
      cv[hh] = row_ok ? __ldcs(reinterpret_cast<const float4*>(c_src + 4 * hh)) : zero;
      cpv[hh] = row_ok && step > 0 ? __ldg(reinterpret_cast<const float4*>(cp_src + 4 * hh))
                                   : zero;
      dov[hh] = row_ok ? __ldcs(reinterpret_cast<const float4*>(do_src + 4 * hh)) : zero;
    }

    float tot[8];  // dh, promoted every k tile: [j][row g / g + 8][e] as wgmma's
#pragma unroll
    for (int i = 0; i < 8; ++i) tot[i] = 0.0f;

    if (step < T - 1) {
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<WB_STAGES - 2>();  // this thread's copies of tile kt have landed
        const int slot = kt % WB_STAGES;
        uint8_t* const st_p = ring_p + slot * WB_STAGE_BYTES;
        {  // the chunk of W this thread copied: hi in place, lo beside
          float4* const pw = reinterpret_cast<float4*>(st_p + b_dst);
          const float4 v = *pw;
          float4 hi, lo;
          split4(v, hi, lo);
          *pw = hi;
          *reinterpret_cast<float4*>(st_p + WB_B_BYTES + b_dst) = lo;
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();  // every tile of kt is in place; everyone is done with tile kt - 1's slot
        const int nxt = kt + WB_STAGES - 1;
        if (nxt < nk) load(nxt, nxt % WB_STAGES);
        cp_async_commit();
        uint32_t hi[WK / 8][4], lo[WK / 8][4];
#pragma unroll
        for (int kk = 0; kk < WK / 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = *reinterpret_cast<const float*>(
                frag + slot * WB_STAGE_BYTES + (i & 1) * 8 * WROW +
                (((2 * kk + (i >> 1)) ^ g) << 4));
            hi[kk][i] = tf32_bits_finite(v);
            lo[kk][i] = tf32_bits_finite(v - __uint_as_float(hi[kk][i]));
          }
        const uint32_t stage = ring + slot * WB_STAGE_BYTES;
        const uint64_t dh = smem_desc(stage + WB_A_BYTES),
                       dl = smem_desc(stage + WB_A_BYTES + WB_B_BYTES);
        float acc[8];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WK / 8; ++kk) {
          wgmma_m64n16k8_tf32_rs(acc, hi[kk], dh + 2 * kk, kk > 0);
          wgmma_m64n16k8_tf32_rs(acc, hi[kk], dl + 2 * kk, 1);
          wgmma_m64n16k8_tf32_rs(acc, lo[kk], dh + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int kk = 0; kk < WK / 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(hi[kk][i]), "r"(lo[kk][i]));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          asm volatile("" : "+f"(acc[i])::"memory");
          tot[i] += acc[i];
        }
      }
    }

    // dh through shared memory, [row][unit], in the ring slot of tile nk (as the forward)
    float* const dh_s = reinterpret_cast<float*>(ring_p + (nk % WB_STAGES) * WB_STAGE_BYTES);
    float4 dhv[2] = {zero, zero};
    if (step < T - 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dh_s[(16 * w + g + 8 * h) * WDH_LD + 8 * j + 2 * t4 + e] = tot[4 * j + 2 * h + e];
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        dhv[hh] = *reinterpret_cast<const float4*>(dh_s + rr * WDH_LD + uc + 4 * hh);
    }

    float dp[4][8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int hh = u / 4, e = u % 4;
      const float gi = comp(gv[0][hh], e), gf = comp(gv[1][hh], e);
      const float gg = comp(gv[2][hh], e), go = comp(gv[3][hh], e);
      const float tc = tanhf(comp(cv[hh], e));
      const float dh_tot = comp(dov[hh], e) + comp(dhv[hh], e);
      const float dcv = dc[u] + dh_tot * go * (1.0f - tc * tc);
      dp[0][u] = dcv * gg * gi * (1.0f - gi);
      dp[1][u] = dcv * comp(cpv[hh], e) * gf * (1.0f - gf);
      dp[2][u] = dcv * gi * (1.0f - gg * gg);
      dp[3][u] = dh_tot * tc * go * (1.0f - go);
      dc[u] = dcv * gf;
    }
    if (row_ok) {
      float* const op = dg + p * G + u0 + uc;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float4*>(op + q * H + 4 * hh) =
              make_float4(dp[q][4 * hh], dp[q][4 * hh + 1], dp[q][4 * hh + 2], dp[q][4 * hh + 3]);
    }
    if (step > 0) grid.sync();  // this step's d_pre is written everywhere before it is read
  }
}

// Grants a wide step kernel its dynamic shared memory (and the carveout that
// holds its blocks) on the device that is current.
template <class Kernel>
inline cudaError_t wide_attributes(Kernel kernel, int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// How many blocks of a wide step kernel (with `smem` bytes of dynamic shared
// memory) the current device holds at once.
template <class Kernel>
inline cudaError_t wide_capacity(int* n, Kernel kernel, int smem) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = wide_attributes(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, WT, smem);
  *n = sms * per;
  return err;
}

// Rows one cooperative launch takes at H units with `capacity` resident
// blocks: whole row tiles, each 2 H / WU blocks (0: not even one tile fits).
inline int wide_wave_rows(int H, int capacity) { return capacity / (2 * (H / WU)) * WR; }

// `kernel` (`smem` bytes of dynamic shared memory) over `rows` rows at H
// units, one cooperative launch per wave of rows; its arguments are `args...`
// followed by (row0, nrows). A refused launch returns CUDA's error: there is
// no other path.
template <class Kernel, class... Args>
inline cudaError_t wide_run(Kernel kernel, int smem, int H, int rows, cudaStream_t stream,
                            Args... args) {
  int capacity = 0;
  cudaError_t err = wide_capacity(&capacity, kernel, smem);
  if (err != cudaSuccess) return err;
  const int wave = wide_wave_rows(H, capacity);
  if (wave <= 0) return cudaErrorCooperativeLaunchTooLarge;
  for (int row0 = 0; row0 < rows; row0 += wave) {
    const int n = rows - row0 < wave ? rows - row0 : wave;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(H / WU, (n + WR - 1) / WR, 2);
    config.blockDim = dim3(WT, 1, 1);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    config.attrs = &attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, args..., row0, n);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

using WideStepsKernel = void (*)(const float*, const float*, float*, float*, float*, int, int,
                                 int, int, int);
// The wide step loop of a layer: a row's steps together, nothing saved.
inline WideStepsKernel layer_wide_kernel() { return wide_steps_kernel<RowMajor, false>; }

// The input projection of a layer at H units over M (row, step) pairs:
// proj_kernel<512> at H = 128, <1024> at 256, <0> from 384 on. wt from
// prep_proj_weights; xpad as launch_proj takes it.
inline cudaError_t run_proj_h(int H, const float* x, int in, const float* wt, const float* gb,
                              float* xpad, float* xp, int M, cudaStream_t stream) {
  if (H == 128) return launch_proj<512>(x, in, wt, gb, xpad, xp, M, stream);
  if (H == 256) return launch_proj<1024>(x, in, wt, gb, xpad, xp, M, stream);
  return launch_proj<0>(x, in, wt, gb, xpad, xp, M, stream, 4 * H);
}

// One layer over `rows` rows (one chunk) at any H the JAX gate sends to a
// kernel (a multiple of 128): the input projection, then the cluster step at
// 128 and 256, the wide loop from 384 up. x (rows, T, in) -> out (rows, T, 2H);
// wt: W_ih as prep_proj_weights stages it; xpad and xp are scratch for rows * T
// * proj_kpad(in) (used only where x needs it) and 2 * rows * T * 4H floats.
inline cudaError_t run_layer_h(int H, const float* x, int in, const float* wt,
                               const float* w_hh, const float* gb, float* xpad, float* xp,
                               float* out, int rows, int T, cudaStream_t stream) {
  const cudaError_t err = run_proj_h(H, x, in, wt, gb, xpad, xp, rows * T, stream);
  if (err != cudaSuccess) return err;
  if (H == 128) return run_layer_steps<128>(xp, w_hh, out, rows, T, stream);
  if (H == 256) return run_layer_steps<256>(xp, w_hh, out, rows, T, stream);
  return wide_run(layer_wide_kernel(), WF_SMEM, H, rows, stream, (const float*)xp, w_hh, out,
                  (float*)nullptr, (float*)nullptr, rows, T, H);
}

// Whether the layer kernels take `hidden` units: a multiple of 128.
inline bool takes_hidden(int hidden) { return hidden > 0 && hidden % 128 == 0; }

}  // namespace bilstm
