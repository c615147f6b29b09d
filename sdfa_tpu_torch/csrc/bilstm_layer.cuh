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
//    recurrence, so it is one tiled f32 product outside the dependent chain
//    (128 x 128 tile, 16 deep, 8 x 8 outputs per thread, the next tile
//    fetched into registers while this one is multiplied). xp (2, rows, T,
//    4H) is scratch in device memory, written once and read once. The kernel
//    is a template on the gate width (4 x 256 or 4 x 128).
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
//    it at H = 128 over its frequency steps, a row's steps together, and the
//    layer kernels at either width (run_layer<HH>).
//
// f32 throughout (expf/tanhf, correctly rounded reciprocal, no fast-math).
// Sums run in another order than the plain version's: k in four interleaved
// quarters for h.W_hh, sequential for x.W_ih.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bilstm {

namespace cg = cooperative_groups;

constexpr int INMAX = 512;  // widest layer input the layer kernels take (layer 2 at H = 256: 2H)

// --- the input projection: xp[d] (M, GW) = x (M, K) . W_ih[d] (K, GW) + gb[d] ---
// GW is the gate width, 4 x the hidden width: 4 x 256 or 4 x 128.

constexpr int PM = 128, PN = 128, PK = 16, PT = 256;  // tile and threads

// Eight consecutive k of one row of A from k on, zero from K on or for a row
// past M. `vec`: the row's K-range is a multiple of 4 long and 16-byte aligned.
__device__ __forceinline__ void load_a(const float* arow, bool row_ok, int k, int K, int vec,
                                       float (&ar)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) ar[i] = 0.0f;
  if (!row_ok) return;
  if (vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (k + 4 * h < K) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(arow + k + 4 * h));
        ar[4 * h] = v.x; ar[4 * h + 1] = v.y; ar[4 * h + 2] = v.z; ar[4 * h + 3] = v.w;
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k + i < K) ar[i] = __ldg(arow + k + i);
  }
}

// Two float4 of B's rows k and k + 8 (zero from K on); B has LDB floats to a row.
template <int LDB>
__device__ __forceinline__ void load_b(const float* bcol, int k, int K, float4 (&br)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = k + 8 * h;
    br[h] = kk < K ? __ldg(reinterpret_cast<const float4*>(bcol + (size_t)kk * LDB))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// grid (2 GW / PN, ceil(M / PM)): blockIdx.x walks the columns of both
// directions, so neighbouring blocks share their rows of x.
template <int GW>
static __global__ void __launch_bounds__(PT, 2)
proj_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
            const float* __restrict__ gb, float* __restrict__ xp, int M, int K, int vec) {
  __shared__ __align__(16) float As[2][PK][PM];
  __shared__ __align__(16) float Bs[2][PK][PN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d = blockIdx.x / (GW / PN), n0 = (blockIdx.x % (GW / PN)) * PN;
  const int m0 = blockIdx.y * PM;
  const int a_m = tid % PM, a_k = (tid / PM) * 8;  // x tile: 8 k of one row per thread
  const int b_k = tid / 32, b_n = (tid % 32) * 4;  // W tile: rows b_k, b_k + 8, one float4 each
  const bool row_ok = m0 + a_m < M;
  const float* arow = x + (size_t)(row_ok ? m0 + a_m : 0) * K;
  const float* bcol = w_ih + (size_t)d * K * GW + n0 + b_n;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float ar[8];
  float4 br[2];
  load_a(arow, row_ok, a_k, K, vec, ar);
  load_b<GW>(bcol, b_k, K, br);
  const int tiles = (K + PK - 1) / PK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) As[buf][a_k + i][a_m] = ar[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) *reinterpret_cast<float4*>(&Bs[buf][b_k + 8 * h][b_n]) = br[h];
    __syncthreads();  // this tile is in place; the other buffer's readers are done (see below)
    if (tile + 1 < tiles) {
      load_a(arow, row_ok, (tile + 1) * PK + a_k, K, vec, ar);
      load_b<GW>(bcol, (tile + 1) * PK + b_k, K, br);
    }
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    // No barrier here: the next turn writes the other buffer, whose last
    // readers all passed this turn's barrier after they finished with it.
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      float4 v = make_float4(acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
                             acc[i][4 * half + 3]);
      if (gb) {
        const float4 bv = *reinterpret_cast<const float4*>(gb + d * GW + n);
        v.x += bv.x; v.y += bv.y; v.z += bv.z; v.w += bv.w;
      }
      *reinterpret_cast<float4*>(xp + ((size_t)d * M + m) * GW + n) = v;
    }
  }
}

// proj_kernel over M rows of x (M, in) on `stream`: xp (2, M, GW).
template <int GW>
inline cudaError_t launch_proj(const float* x, int in, const float* w_ih, const float* gb,
                               float* xp, int M, cudaStream_t stream) {
  const int vec = in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  proj_kernel<GW><<<dim3(2 * GW / PN, (M + PM - 1) / PM), PT, 0, stream>>>(x, w_ih, gb, xp, M, in,
                                                                         vec);
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

// One layer over `rows` rows (one chunk) at HH hidden units: x (rows, T, in)
// -> out (rows, T, 2 HH); xp is scratch for 2 * rows * T * 4 HH floats. A
// refused launch returns CUDA's error: there is no other path.
template <int HH>
inline cudaError_t run_layer(const float* x, int in, const float* w_ih, const float* w_hh,
                             const float* gb, float* xp, float* out, int rows, int T,
                             cudaStream_t stream) {
  using D = LayerDims<HH>;
  cudaError_t err = launch_proj<D::G>(x, in, w_ih, gb, xp, rows * T, stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  err = cluster_config(config, attr, layer_steps_kernel<HH>(),
                       dim3(D::CL, (rows + D::RT - 1) / D::RT, 2), D::THREADS, D::SMEM, D::CL,
                       stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, layer_steps_kernel<HH>(), (const float*)xp, w_hh, out,
                            (float*)nullptr, (float*)nullptr, rows, T);
}

// How many clusters of a layer's step loop at HH hidden units the card runs at
// once (at H = 256, 16 cover 256 rows x 2 directions in one wave).
template <int HH>
inline cudaError_t layer_max_active_clusters(int* n) {
  using D = LayerDims<HH>;
  return max_active_clusters(n, layer_steps_kernel<HH>(), D::THREADS, D::SMEM, D::CL);
}

}  // namespace bilstm
