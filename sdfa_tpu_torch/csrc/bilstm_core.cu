// The biLSTM training core: both directions' recurrences from precomputed
// input projections, forward and backward (BPTT).
//
// Replaces sdfa_tpu/ops/pallas_bilstm_train.py:_fwd_kernel and _bwd_kernel
// (entry point bilstm_core, a custom_vjp). The input projection x.W_ih + b
// and the weight gradient dW_hh = h_prev^T . dg stay outside, as large
// library products, exactly as the JAX package leaves them to XLA.
//
//   forward : xp (2, T, rows, 4H), w_hh (2, H, 4H)
//             -> out (T, rows, 2H), gates (2, T, rows, 4H), c (2, T, rows, H)
//   backward: gates, c, w_hh (2, H, 4H), dout (T, rows, 2H)
//             -> dg (2, T, rows, 4H) = d(xp)
//
// Every tensor is indexed by TIME. Direction 1 walks t = T-1 .. 0, so its
// previous step is t + 1; the residuals (post-activation gates i, f, g, o
// and the cell state) sit at the time index they belong to, not at the
// direction's step number as in the Pallas kernel.
//
// What bounds it on the H100. FreqLstm core (T=32, rows=6400, H=128): each
// pass moves xp or dg plus the gates (839 MB each) and c, out or dout
// (210 MB each) through HBM once, about 2.1 GB, against 54 GFLOP of f32
// FMAs in the h.W_hh (d_pre.W_hh^T) product: operations bound it. Time LSTM
// (T=64, rows=100, H=256): 6.7 GFLOP and 84 MB per layer, but only 100 rows
// and 64 dependent steps: the latency of a step bounds it, not the card's
// peak, so a step must not wait for weights.
//
// Design, the same for both passes: a cluster of H / 32 thread blocks owns a
// tile of rows of ONE direction for the whole recurrence, and block s keeps
// the four gates of hidden units 32s .. 32s+31, W_hh[:, its 128 columns], in
// shared memory as [k][unit][gate]: W_hh is read from device memory once per
// cluster and launch, never per step. The tile is two sub-tiles that take
// turns, so that one's exchange and cluster barrier hide behind the other's
// product.
//
// Forward: steps_kernel of bilstm_layer.cuh (the step loop of the layer
// kernels) indexed by time, which also writes the gates and c: a block
// multiplies the full h by its slice, applies the cell to its units, and
// hands its h slice to every block of the cluster through distributed shared
// memory.
//
// Backward: core_bwd_kernel below. Per step a block needs dh[:, its units] =
// sum over all 4H gate columns of d_pre . W_hh^T, but produces d_pre only for
// its own 128 columns. So it multiplies its own d_pre slice by the SAME
// [k][unit][gate] slice the forward holds, contracting over its (unit, gate)
// columns, which gives partial sums for all H units; it sends block b the
// partial sums of b's units (a reduce-scatter through distributed shared
// memory), and each block adds the H / 32 partial sums of its units in block
// order. No atomics and a fixed order: results repeat bit for bit. No
// transposed copy of W_hh is needed. Gathering the whole d_pre tile in every
// block instead would need 128 KB per buffer beside a 128 KB slice of
// W_hh^T, more than a block has, and move four times the bytes.
// dh and dc stay in registers, tanh(c) is recomputed, and a turn's reads
// that do not depend on the recurrence (gates, c, c of the previous step,
// dout) are asked for before the previous turn's product.
//
// From H = 384 on (any multiple of 128), where no cluster's shared memory
// holds one direction's W_hh, both passes run the wide step loop of
// bilstm_layer.cuh instead: wide_steps_kernel indexed by time with the gates
// and c saved, and wide_bwd_kernel (d_pre of the previous step read back from
// dg); both stream W_hh through L2 and multiply on the tensor cores in
// 3xTF32, one grid-wide barrier a step.
//
// f32 throughout (expf/tanhf, no fast-math).
#include "bilstm_layer.cuh"

using namespace bilstm;

namespace {

// Row groups of 8 to a sub-tile (a cluster owns 16 RG rows) and blocks a
// multiprocessor should hold, per hidden width: compile-time constants, chosen
// on the card (chip_smoke.py --profile builds the other choices with -D and
// times them). H = 256: 16-row tiles, so that the train step's 100 rows are 14
// clusters in one wave of the 15 the card holds, not 8. H = 128: 32-row tiles
// and two blocks to a multiprocessor (105 KB of shared memory and at most 128
// registers each), so that one block's barrier and cell hide behind the
// other's product.
#ifndef SDFA_CORE_RG128
#define SDFA_CORE_RG128 2
#endif
#ifndef SDFA_CORE_MINB128
#define SDFA_CORE_MINB128 2
#endif
#ifndef SDFA_CORE_RG256
#define SDFA_CORE_RG256 1
#endif
template <int HH> struct Tile;
template <> struct Tile<128> {
  static constexpr int RG = SDFA_CORE_RG128, MINB = SDFA_CORE_MINB128;
};
template <> struct Tile<256> {
  static constexpr int RG = SDFA_CORE_RG256, MINB = 1;
};

template <int HH, int RG>
struct BwdDims {
  using S = StepDims<HH, RG>;
  static constexpr int CL = S::CL, G = S::G, SUB = S::SUB, RT = S::RT, HS = S::HS;
  static constexpr int THREADS = S::THREADS;
  // A row of the W_hh slice is padded by one float4: the product reads one
  // (unit, gate) column group of 8 or 16 consecutive k at a time, and they
  // then lie in different banks.
  static constexpr int WROW = 4 * UPB + 4;
  static constexpr int WS_FLOATS = HH * WROW;
  static constexpr int RX_FLOATS = 2 * CL * UPB * HS;  // partial dh [sub-tile][sender][unit][row]
  static constexpr int DP_FLOATS = 2 * SUB * 4 * UPB;  // d_pre [sub-tile][row][unit][gate]
  static constexpr int SMEM = (WS_FLOATS + RX_FLOATS + DP_FLOATS) * 4;  // <256, 1>: 167,936 B
  // The product's warp = (a quarter of the H outputs, row group of 8); its
  // lanes = (part of the contraction, KL outputs side by side), 4 outputs a
  // lane, KL apart.
  static constexpr int KL = HH / 16;
  static constexpr int CS = 32 / KL;  // parts the 128 (unit, gate) columns are summed in: 2 or 4
  static constexpr int NR = 8 / CS;   // rows of its 8 a lane is left with after the exchange
};

// What the cell of one (row, unit) reads at a step.
struct CellIn {
  float g[4], c, c_prev, dout;
};

// grid (CL, row tiles, 2 directions), cluster (CL, 1, 1), BwdDims::SMEM bytes
// of dynamic shared memory.
//
// A turn of sub-tile a at a step: the cell of the block's units (rows 2 warp,
// 2 warp + 1 of the sub-tile, unit = lane) turns dh, dc and the residuals
// into d_pre, writes it to dg and, as [row][unit][gate], to shared memory;
// after a block barrier every warp multiplies d_pre by the block's W_hh slice
// (8 rows x 4 outputs a lane over its part of the 128 columns, the parts
// summed by warp exchanges); the lane then waits for the phase the other
// sub-tile opened a turn ago, adds that sub-tile's partial sums in block
// order into its dh, sends its own partial sums to the blocks that own those
// units, and arrives. A sub-tile's receive buffer is read between the wait
// that makes it visible and the arrive that lets the peers go on, so it is
// never overwritten early and one buffer per sub-tile is enough. At the
// direction's first step (the last turn pair) no dh is needed: no product.
template <int HH, int RG, int MINB>
__global__ void __launch_bounds__(BwdDims<HH, RG>::THREADS, MINB)
core_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                const float* __restrict__ w_hh, const float* __restrict__ dout,
                float* __restrict__ dg, int rows, int T) {
  using D = BwdDims<HH, RG>;
  constexpr int CL = D::CL, G = D::G, SUB = D::SUB, RT = D::RT, HS = D::HS;
  constexpr int WROW = D::WROW, KL = D::KL, CS = D::CS, NR = D::NR;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* rx = ws + D::WS_FLOATS;
  float* dp = rx + D::RX_FLOATS;

  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.block_rank();  // which 32 hidden units
  const int d = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j = s * UPB + lane;                        // the cell's hidden unit
  const int cq = lane / KL;                            // the product's part of the columns
  const int rg = warp % RG;                            // ... its rows 8 rg .. 8 rg + 7
  const int k0 = (warp / RG) * (HH / 4) + lane % KL;   // ... its outputs k0 + KL kk, kk < 4
  const int keep0 = 8 * rg + NR * cq;                  // the NR rows it is left with

  load_w_slice<HH, WROW, D::THREADS>(ws, w_hh + (size_t)d * HH * G, s, tid);
  cluster.sync();  // every block of the cluster runs before a peer writes into it

  const size_t dir = (size_t)d * rows * T;
  const int tile_row = blockIdx.y * RT + 2 * warp;  // + a SUB + r: the cell's rows

  auto load_in = [&](int step, int a, CellIn (&in)[2]) {
    const int t = d == 0 ? step : T - 1 - step;
    const int t_prev = d == 0 ? t - 1 : t + 1;  // the direction's previous step
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = tile_row + a * SUB + r;
      if (row < rows) {
        const size_t p = dir + (size_t)t * rows + row;
#pragma unroll
        for (int q = 0; q < 4; ++q) in[r].g[q] = __ldcs(gates + p * G + q * HH + j);
        in[r].c = __ldcs(cs + p * HH + j);
        in[r].c_prev =
            step > 0 ? __ldg(cs + (dir + (size_t)t_prev * rows + row) * HH + j) : 0.0f;
        in[r].dout = __ldcs(dout + ((size_t)t * rows + row) * (2 * HH) + d * HH + j);
      } else {
        in[r] = CellIn{{0.0f, 0.0f, 0.0f, 0.0f}, 0.0f, 0.0f, 0.0f};
      }
    }
  };
  // dh of sub-tile a's (rows, unit) of this thread: the partial sums of all
  // blocks, added in block order
  auto read_dh = [&](int a, float (&dh)[2]) {
    const float* p = rx + (a * CL * UPB + lane) * HS + 2 * warp;
    float2 sum = *reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int b = 1; b < CL; ++b) {
      const float2 v = *reinterpret_cast<const float2*>(p + b * UPB * HS);
      sum.x += v.x;
      sum.y += v.y;
    }
    dh[0] = sum.x;
    dh[1] = sum.y;
  };

  float dh[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, dc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  CellIn in[2];
  load_in(T - 1, 0, in);

  for (int step = T - 1; step >= 0; --step) {
    const int t = d == 0 ? step : T - 1 - step;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float gi = in[r].g[0], gf = in[r].g[1], gg = in[r].g[2], go = in[r].g[3];
        const float tc = tanhf(in[r].c);
        const float dh_tot = in[r].dout + dh[a][r];
        const float dcv = dc[a][r] + dh_tot * go * (1.0f - tc * tc);
        const float4 dpre = make_float4(dcv * gg * gi * (1.0f - gi),
                                        dcv * in[r].c_prev * gf * (1.0f - gf),
                                        dcv * gi * (1.0f - gg * gg),
                                        dh_tot * tc * go * (1.0f - go));
        dc[a][r] = dcv * gf;
        const int row = tile_row + a * SUB + r;
        if (row < rows) {
          float* op = dg + (dir + (size_t)t * rows + row) * G + j;
          op[0] = dpre.x; op[HH] = dpre.y; op[2 * HH] = dpre.z; op[3 * HH] = dpre.w;
        }
        if (step > 0)
          *reinterpret_cast<float4*>(dp + ((a * SUB + 2 * warp + r) * UPB + lane) * 4) = dpre;
      }
      // the next turn's residuals, asked for now and used after this turn's product
      if (a == 0) load_in(step, 1, in);
      else if (step > 0) load_in(step - 1, 0, in);

      if (step == 0) {  // dh of the direction's first step is used by nothing
        if (a == 0 && T > 1) {
          cluster_wait();
          read_dh(1, dh[1]);
        }
        continue;
      }
      __syncthreads();  // d_pre of the sub-tile is written; the product two turns ago is done

      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[r][kk] = 0.0f;
      const float* wp = ws + k0 * WROW + 4 * cq;
      const float* dpa = dp + (a * SUB + 8 * rg) * (4 * UPB) + 4 * cq;
#pragma unroll 4
      for (int i = 0; i < UPB / CS; ++i) {  // the units cq, cq + CS, ...: four gates each
        float4 w[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          w[kk] = *reinterpret_cast<const float4*>(wp + kk * KL * WROW + i * 4 * CS);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(dpa + r * (4 * UPB) + i * 4 * CS);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[r][kk] += v.x * w[kk].x;
            acc[r][kk] += v.y * w[kk].y;
            acc[r][kk] += v.z * w[kk].z;
            acc[r][kk] += v.w * w[kk].w;
          }
        }
      }

      // the parts of the contraction sit in one warp: exchanges sum them and
      // leave each lane NR of its 8 rows
      float part[NR][4];
      if constexpr (CS == 2) {
        const bool hi = lane & 16;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float send = hi ? acc[r][kk] : acc[4 + r][kk];
            const float keep = hi ? acc[4 + r][kk] : acc[r][kk];
            part[r][kk] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
          }
      } else {
        const bool hi = lane & 16, mid = lane & 8;
        float half[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float send = hi ? acc[r][kk] : acc[4 + r][kk];
            const float keep = hi ? acc[4 + r][kk] : acc[r][kk];
            half[r][kk] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float send = mid ? half[r][kk] : half[2 + r][kk];
            const float keep = mid ? half[2 + r][kk] : half[r][kk];
            part[r][kk] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
          }
      }

      // close the phase the other sub-tile opened a turn ago and take its dh,
      // then send this sub-tile's partial sums and open its phase
      if (a == 1 || step < T - 1) {
        cluster_wait();
        read_dh(1 - a, dh[1 - a]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = k0 + kk * KL;  // unit k % UPB of block k / UPB
        float* dst = cluster.map_shared_rank(
            rx + ((a * CL + s) * UPB + k % UPB) * HS + keep0, k / UPB);
        if constexpr (NR == 4)
          *reinterpret_cast<float4*>(dst) =
              make_float4(part[0][kk], part[1][kk], part[2][kk], part[3][kk]);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(part[0][kk], part[1][kk]);
      }
      cluster_arrive();
    }
  }
}

using BwdKernel = void (*)(const float*, const float*, const float*, const float*, float*, int,
                           int);

// Both passes at one hidden width: their kernels, launches and occupancy.
template <int HH>
struct Core {
  static constexpr int RG = Tile<HH>::RG, MINB = Tile<HH>::MINB;
  using S = StepDims<HH, RG>;
  using B = BwdDims<HH, RG>;
  static StepsKernel fwd_kernel() { return steps_kernel<HH, RG, TimeMajor, true, MINB>; }
  static BwdKernel bwd_kernel() { return core_bwd_kernel<HH, RG, MINB>; }

  // clusters of CL blocks over (row tiles, 2 directions)
  template <class Kernel, class... Args>
  static cudaError_t launch(Kernel kernel, int smem, int rows, cudaStream_t stream,
                            Args... args) {
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr;
    const cudaError_t err =
        cluster_config(config, attr, kernel, dim3(S::CL, (rows + S::RT - 1) / S::RT, 2),
                       S::THREADS, smem, S::CL, stream);
    if (err != cudaSuccess) return err;
    return cudaLaunchKernelEx(&config, kernel, args...);
  }
  static cudaError_t forward(const float* xp, const float* w_hh, float* out, float* gates,
                             float* cs, int T, int rows, cudaStream_t stream) {
    return launch(fwd_kernel(), S::SMEM, rows, stream, xp, w_hh, out, gates, cs, rows, T);
  }
  static cudaError_t backward(const float* gates, const float* cs, const float* w_hh,
                              const float* dout, float* dg, int T, int rows,
                              cudaStream_t stream) {
    return launch(bwd_kernel(), B::SMEM, rows, stream, gates, cs, w_hh, dout, dg, rows, T);
  }
  static cudaError_t clusters(int* fwd, int* bwd) {
    const cudaError_t err =
        max_active_clusters(fwd, fwd_kernel(), S::THREADS, S::SMEM, S::CL);
    if (err != cudaSuccess) return err;
    return max_active_clusters(bwd, bwd_kernel(), S::THREADS, B::SMEM, S::CL);
  }
};

}  // namespace

// The wide loop's kernels: the forward indexed by time with the gates and c
// saved, and the backward.
inline WideStepsKernel wide_fwd_kernel() { return wide_steps_kernel<TimeMajor, true>; }

extern "C" int sdfa_bilstm_core_fwd(const float* xp, const float* w_hh, float* out, float* gates,
                                    float* cs, int T, int rows, int hidden,
                                    cudaStream_t stream) {
  if (T <= 0 || !takes_hidden(hidden)) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  if (hidden == 128) return (int)Core<128>::forward(xp, w_hh, out, gates, cs, T, rows, stream);
  if (hidden == 256) return (int)Core<256>::forward(xp, w_hh, out, gates, cs, T, rows, stream);
  return (int)wide_run(wide_fwd_kernel(), WF_SMEM, hidden, rows, stream, xp, w_hh,
                       out, gates, cs, rows, T, hidden);
}

extern "C" int sdfa_bilstm_core_bwd(const float* gates, const float* cs, const float* w_hh,
                                    const float* dout, float* dg, int T, int rows, int hidden,
                                    cudaStream_t stream) {
  if (T <= 0 || !takes_hidden(hidden)) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  if (hidden == 128) return (int)Core<128>::backward(gates, cs, w_hh, dout, dg, T, rows, stream);
  if (hidden == 256) return (int)Core<256>::backward(gates, cs, w_hh, dout, dg, T, rows, stream);
  return (int)wide_run(wide_bwd_kernel, WB_SMEM, hidden, rows, stream, gates, cs, w_hh,
                       dout, dg, rows, T, hidden);
}

// n[0..3]: how many clusters the card holds at once of the forward and the
// backward kernel at H = 128, then at H = 256.
extern "C" int sdfa_bilstm_core_clusters(int* n) {
  const cudaError_t err = Core<128>::clusters(n, n + 1);
  if (err != cudaSuccess) return (int)err;
  return (int)Core<256>::clusters(n + 2, n + 3);
}

// n[0], n[1]: how many blocks of the wide loop's forward and backward kernels
// the card holds at once.
extern "C" int sdfa_bilstm_core_wide_blocks(int* n) {
  const cudaError_t err = wide_capacity(n, wide_fwd_kernel(), WF_SMEM);
  if (err != cudaSuccess) return (int)err;
  return (int)wide_capacity(n + 1, wide_bwd_kernel, WB_SMEM);
}

// Rows a cluster (a block of the wide loop, from H = 384 on: WR) owns at `hidden`
// units (0 for a width the kernels do not take).
extern "C" int sdfa_bilstm_core_row_tile(int hidden) {
  if (hidden == 128) return Core<128>::S::RT;
  if (hidden == 256) return Core<256>::S::RT;
  return takes_hidden(hidden) ? WR : 0;
}

extern "C" const char* sdfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
