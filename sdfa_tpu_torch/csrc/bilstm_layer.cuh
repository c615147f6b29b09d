// One bidirectional LSTM layer on the H100: the code shared by the per-layer
// kernel (bilstm_layer.cu) and the 2-layer kernel (bilstm2.cu). Included by
// both; each builds its own copy.
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
//    4H) is scratch in device memory, written once and read once.
// 2. steps_kernel: a cluster of CL = 8 blocks owns RT = 32 rows of one
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

constexpr int H = 256;        // hidden units per direction
constexpr int G = 4 * H;      // gate width
constexpr int INMAX = 2 * H;  // widest layer input (layer 2: 2H)

// --- the input projection: xp[d] (M, G) = x (M, K) . W_ih[d] (K, G) + gb[d] ---

constexpr int PM = 128, PN = 128, PK = 16, PT = 256;  // tile and threads

// Eight consecutive k of one row of x from k on, zero past K or for a row
// past M. `vec`: K % 4 == 0 and x is 16-byte aligned.
__device__ __forceinline__ void load_a(const float* arow, bool row_ok, int k, int K, int vec,
                                       float (&ar)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) ar[i] = 0.0f;
  if (!row_ok) return;
  if (vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (k + 4 * h < K) {
        const float4 v = *reinterpret_cast<const float4*>(arow + k + 4 * h);
        ar[4 * h] = v.x; ar[4 * h + 1] = v.y; ar[4 * h + 2] = v.z; ar[4 * h + 3] = v.w;
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k + i < K) ar[i] = arow[k + i];
  }
}

// Two float4 of W_ih rows k and k + 8 (zero past K).
__device__ __forceinline__ void load_b(const float* bcol, int k, int K, float4 (&br)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = k + 8 * h;
    br[h] = kk < K ? *reinterpret_cast<const float4*>(bcol + (size_t)kk * G)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// grid (2 G / PN, ceil(M / PM)): blockIdx.x walks the columns of both
// directions, so neighbouring blocks share their rows of x.
static __global__ void __launch_bounds__(PT, 2)
proj_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
            const float* __restrict__ gb, float* __restrict__ xp, int M, int K, int vec) {
  __shared__ __align__(16) float As[2][PK][PM];
  __shared__ __align__(16) float Bs[2][PK][PN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d = blockIdx.x / (G / PN), n0 = (blockIdx.x % (G / PN)) * PN;
  const int m0 = blockIdx.y * PM;
  const int a_m = tid % PM, a_k = (tid / PM) * 8;  // x tile: 8 k of one row per thread
  const int b_k = tid / 32, b_n = (tid % 32) * 4;  // W tile: rows b_k, b_k + 8, one float4 each
  const bool row_ok = m0 + a_m < M;
  const float* arow = x + (size_t)(row_ok ? m0 + a_m : 0) * K;
  const float* bcol = w_ih + (size_t)d * K * G + n0 + b_n;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float ar[8];
  float4 br[2];
  load_a(arow, row_ok, a_k, K, vec, ar);
  load_b(bcol, b_k, K, br);
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
      load_b(bcol, (tile + 1) * PK + b_k, K, br);
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
        const float4 bv = *reinterpret_cast<const float4*>(gb + d * G + n);
        v.x += bv.x; v.y += bv.y; v.z += bv.z; v.w += bv.w;
      }
      *reinterpret_cast<float4*>(xp + ((size_t)d * M + m) * G + n) = v;
    }
  }
}

// --- the recurrence: one cluster per (row tile, direction) ---------------------

constexpr int CL = 8;              // blocks per cluster
constexpr int UPB = H / CL;        // hidden units per block: 32
constexpr int RT = 32;             // rows per cluster, walked as two sub-tiles of SUB rows
constexpr int SUB = RT / 2;
constexpr int HS = SUB + 4;        // row stride of the transposed h buffers: the four float4
                                   // a warp reads per load then lie in different banks
constexpr int STEP_THREADS = 256;  // warp = (unit group of 8, row group of 8); lane = (k
                                   // quarter, unit)
constexpr int WS_FLOATS = H * UPB * 4;      // W_hh slice [k][unit][gate]
constexpr int HT_FLOATS = 2 * 2 * H * HS;   // h, transposed [sub-tile][buffer][k][row]
constexpr int STEP_SMEM = (WS_FLOATS + HT_FLOATS) * 4;  // 212,992 of 232,448 B

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
// writes so far (its h in the peers' shared memory) are released; wait: every
// thread of the cluster has arrived and what they released is visible here.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// grid (CL, row tiles, 2 directions), cluster (CL, 1, 1), STEP_SMEM bytes of
// dynamic shared memory. xp (2, rows, T, G) comes from proj_kernel.
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
static __global__ void __launch_bounds__(STEP_THREADS, 1)
steps_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
             float* __restrict__ out, int rows, int T) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* ht = ws + WS_FLOATS;

  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.block_rank();  // which 32 hidden units
  const int d = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kq = lane / 8;                 // this lane sums k = kq, kq + 4, kq + 8, ...
  const int u = 8 * (warp / 2) + lane % 8; // unit within the block
  const int rg = warp % 2;                 // rows 8 rg .. 8 rg + 7 of a sub-tile in the product
  const int j = s * UPB + u;               // hidden unit
  const int rfin = 8 * rg + 2 * kq;        // the two rows of a sub-tile this thread finishes

  // W_hh[d][:, q H + j] for the block's units, gates interleaved per unit
  const float* wd = w_hh + (size_t)d * H * G;
  for (int i = tid; i < H * 4 * UPB; i += STEP_THREADS) {
    const int k = i / (4 * UPB), q = (i / UPB) % 4, uu = i % UPB;
    ws[(k * UPB + uu) * 4 + q] = wd[(size_t)k * G + q * H + s * UPB + uu];
  }
  for (int i = tid; i < HT_FLOATS; i += STEP_THREADS) ht[i] = 0.0f;
  // every block of the cluster runs and has zeroed its h before a peer writes into it
  cluster.sync();

  float* peer[CL];
#pragma unroll
  for (int b = 0; b < CL; ++b) peer[b] = cluster.map_shared_rank(ht, b);

  float c_state[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  const float* xcol = xp + (size_t)d * rows * T * G + j;
  float* ocol = out + d * H + j;
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
                         ? __ldcs(xcol + ((size_t)(row0 + r) * T + t) * G + q * H) : 0.0f;

      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      const float* hc = ht + ((a * 2 + cur) * H + kq) * HS + 8 * rg;
#pragma unroll 8
      for (int kk = 0; kk < H / 4; ++kk) {
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

      float hv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = pre[r][q] + xv[r][q];
        const float cn = sigm(g[1]) * c_state[a][r] + sigm(g[0]) * tanhf(g[2]);
        c_state[a][r] = cn;
        hv[r] = sigm(g[3]) * tanhf(cn);
      }
      const float2 hvec = make_float2(hv[0], hv[1]);
      const int dst = ((a * 2 + 1 - cur) * H + j) * HS + rfin;
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
        if (row0 + r < rows) ocol[((size_t)(row0 + r) * T + t) * (2 * H)] = hv[r];
      STEP_CLOCK(3)
    }
  }
  cluster_wait();  // no block leaves while a peer may still write into it
#ifdef SDFA_STEP_CLOCKS
  if (tid == 0 && blockIdx.x + blockIdx.y + blockIdx.z == 0)
    for (int i = 0; i < STEP_PARTS; ++i) step_clocks[i] = clocks[i];
#endif
}

inline void steps_config(cudaLaunchConfig_t& config, cudaLaunchAttribute& attr, int rows,
                         cudaStream_t stream) {
  config = cudaLaunchConfig_t{};
  config.gridDim = dim3(CL, (rows + RT - 1) / RT, 2);
  config.blockDim = dim3(STEP_THREADS, 1, 1);
  config.dynamicSmemBytes = STEP_SMEM;
  config.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
}

// One layer over `rows` rows (one chunk): x (rows, T, in) -> out (rows, T,
// 2H); xp is scratch for 2 * rows * T * G floats. A refused launch returns
// CUDA's error: there is no other path.
inline cudaError_t run_layer(const float* x, int in, const float* w_ih, const float* w_hh,
                             const float* gb, float* xp, float* out, int rows, int T,
                             cudaStream_t stream) {
  const int M = rows * T;
  const int vec = in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  proj_kernel<<<dim3(2 * G / PN, (M + PM - 1) / PM), PT, 0, stream>>>(x, w_ih, gb, xp, M, in,
                                                                     vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(steps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             STEP_SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  steps_config(config, attr, rows, stream);
  return cudaLaunchKernelEx(&config, steps_kernel, (const float*)xp, w_hh, out, rows, T);
}

// How many clusters of steps_kernel the card runs at once (16 cover 256 rows
// x 2 directions in one wave).
inline cudaError_t max_active_clusters(int* n) {
  cudaError_t err = cudaFuncSetAttribute(steps_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, STEP_SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  steps_config(config, attr, 16 * RT, 0);
  return cudaOccupancyMaxActiveClusters(n, steps_kernel, &config);
}

}  // namespace bilstm
