// AGC + squelch FSM + carrier-PLL feedback core of the fused AM receiver,
// one sequential warmup+main scan per lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudsp/pallas/am_backend_scan.py
// (_make_kernel, wrapped by front_chunked_pallas). The plain PyTorch
// version is tpudsp_torch/kernels/am_backend.front_sample_step, looped by
// tpudsp_torch/cuda/am_backend_scan.front_chunked_ref; the wrapper that
// launches this kernel is tpudsp_torch/cuda/am_backend_scan._launch.
//
// Layout: scan_step.cuh's staged pipeline, three warps per group of 32
// lanes, grid ceil(lanes / 32). Lane l = c * nchunks + i carries chunk i
// of stream c. Warp 0 runs the AGC gain chain (g, y2p); warp 1, one stage
// behind, runs rssi, the squelch FSM (mode, timer) and the zeroed AGC
// output, writes the modes and stages the inputs with cp.async; warp 2, one
// more stage behind, runs the carrier PLL (theta, freq) on that output and
// writes vr. The warmup windows are NOT materialised: each lane reads its
// history from the chunk planes and skips samples before its stream's
// start -- the per-lane t_start of the TPU kernel, t_start = warmup -
// min(warmup, i * chunk), derived from the lane index. A launch with
// warmup = 0 and nchunks = 1 is the exact sequential front (front_exact)
// over each stream: the same kernel serves the chunked route, the tail fix
// and the sharded receiver's single-lane entry scan.
//
// Two instances of one body, by the caller's layout. The planes instance
// (am_front_scan) reads (chunk, lanes) f32 planes, lane c * nchunks + i, and
// stores each step's vr and mode to (chunk, lanes) planes. The matrix
// instance (am_front_scan_mc) reads the streams as the columns of the
// channelizer's (len, C) complex64 matrix Y in place, lane i * C + c, so a
// group is 32 adjacent channels of one chunk; zeros past len stand for the
// last chunk's padding. Its vr and modes go to (C, len) rows: the squelch
// and PLL warps leave each step's mode and vr in the stage buffer they have
// just read (the gain ring, the AGC output ring), and the squelch warp,
// which has time to spare, writes a stage's modes out after running it and
// the PLL's vr two stages later, before refilling that buffer, each lane's
// run of a stage as coalesced stores (scan_step.cuh's write_rows; its
// buffers padded to GROUP + 1 floats a row). The steps are the same, so
// the outputs and states are the planes instance's bit for bit: the lanes'
// grouping only decides which warps take the bounded PLL path, which gives
// the same bits.
//
// Math. Exactly the step of front_sample_step: the AGC half is
// scan_step.cuh's gain_step and squelch_step (shared with agc_scan.cu), the
// PLL half uses the 6-coefficient polynomial atan2 (patan2) and f32
// constants; expf, logf, log10f and sincosf with no fast math, built with
// -fmad=false so no multiply-add is contracted that the plain version
// rounds twice. The theta wrap is a floor-mod with the divisor's sign
// (jnp.mod / torch.remainder), one compare and one exact subtraction or
// rounded addition on the loop's range (scan_step.cuh).
//
// Bound. Each lane is a chain of 7680 dependent steps at the main path's
// 4M-sample block (3840 warmup + 3840 chunk) and the main path has only 25
// lanes: one group on one SM. The kernel moves ~16 bytes per step per lane,
// so it is bound by the latency of a step, not by bytes or FLOPs. The first
// kernel ran the AGC (~258 ns) and the PLL (~320 ns) halves of a step one
// after the other in one thread: ~599 ns a step. Here they overlap in
// separate warps (the gain warp takes ~104 ns a step), and the step is
// paced by the PLL warp's chain: sincosf, two products and a sum, patan2
// (an IEEE divide, whose slow-path check is the one branch left in the
// step, and a 6-term unfused Horner), the loop filter and the wrap. Once a
// stage is known to keep theta in [-pi, pi] and the wrap's argument in
// (-2 pi, 4 pi) (scan_step.cuh's bounded_stage, one warp vote per stage),
// the PLL warp runs libdevice's branch-free sincosf path and the wrap
// without its fmodf branch: ~280 ns a step on the H100 (PERF.md). Filling
// the card (more, shorter chunks; several streams per launch) changes the
// function and is not done here.

#include "scan_step.cuh"

namespace {

using namespace tpudsp;

constexpr int WARPS = 3;
// f32 words of shared memory per lane per step of a stage: XBUF input
// stages of (re, im), a double-buffered gain ring and a double-buffered
// ring of the AGC output (re, im)
constexpr int WORDS = 2 * XBUF + 2 + 4;

// An instance's shared memory: the stage buffers at PITCH floats a row, and
// the matrix instance's row spans of its lanes
template <bool MATRIX>
struct Layout {
  static constexpr int PITCH = MATRIX ? GROUP + 1 : GROUP;
  static constexpr int SPAN = STAGE * PITCH;   // floats of one [STAGE][PITCH] buffer
  static constexpr int SMEM =                  // bytes per block
      SPAN * WORDS * sizeof(float) + (MATRIX ? GROUP * sizeof(RowSpan) : 0);
  static_assert(SMEM <= SMEM_MAX, "the stage buffers exceed a block's shared memory");
  // two blocks an SM (the coherent bank's 160 groups in one wave on 132
  // SMs); 1 KB of each block's shared memory is the system's
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks must fit an SM");
};

__device__ __forceinline__ float patan2f(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float t = lo / (hi > 0.0f ? hi : 1.0f);
  const float z2 = t * t;
  float acc = -0.01172120f;  // Horner from the last coefficient
  acc = acc * z2 + 0.05265332f;
  acc = acc * z2 + -0.11643287f;
  acc = acc * z2 + 0.19354346f;
  acc = acc * z2 + -0.33262347f;
  acc = acc * z2 + 0.99997726f;
  float a = t * acc;
  a = ay > ax ? HALF_PI_F - a : a;
  a = x < 0.0f ? PI_F - a : a;
  a = y < 0.0f ? -a : a;
  return hi > 0.0f ? a : 0.0f;
}

// the PLL half of front_sample_step on the AGC output (outr, outi);
// returns vr = Re(v). A step that is not live keeps theta and freq. BOUNDED:
// theta and the wrap's argument are known to lie where sincosf and the wrap
// take no branch (bounded_stage), so neither branch is compiled in.
template <bool BOUNDED>
__device__ __forceinline__ float pll_step(const PllParams& p, bool live, float outr,
                                          float outi, float& theta, float& freq) {
  float s, c;
  if (BOUNDED)
    sin_cos_reduced(theta, s, c);
  else
    sincosf(theta, &s, &c);
  const float vr = outr * c + outi * s;
  const float vi = outi * c - outr * s;
  const float err = patan2f(vi, vr) * p.use_pll;
  const float fr = freq + p.alpha * err;
  const float th = wrap_theta<BOUNDED>(theta + p.beta * err + fr);
  freq = live ? fr : freq;
  theta = live ? th : theta;
  return vr;
}

// MATRIX: xre is Y, the (len, lanes / nchunks) complex64 matrix, and xim is
// unused; vr_out / modes_out are (C, len) rows, written unless null. Else
// xre / xim / vr_out / modes_out are (chunk, lanes) planes and len is unused.
template <bool MATRIX>
__global__ void __launch_bounds__(WARPS * GROUP)
am_front_scan_kernel(const float* __restrict__ scal,
                     const float* __restrict__ xre, const float* __restrict__ xim,
                     const float* __restrict__ g0, const float* __restrict__ y2p0,
                     const int* __restrict__ mode0, const int* __restrict__ timer0,
                     const float* __restrict__ th0, const float* __restrict__ fr0,
                     float* __restrict__ vr_out, int* __restrict__ modes_out,
                     float* __restrict__ gN, float* __restrict__ y2pN,
                     int* __restrict__ modeN, int* __restrict__ timerN,
                     float* __restrict__ thN, float* __restrict__ frN,
                     int lanes, int nchunks, int chunk, int warmup, int len) {
  using Lay = Layout<MATRIX>;
  constexpr int P = Lay::PITCH;
  constexpr int SP = Lay::SPAN;
  extern __shared__ float smem[];
  const GroupLane g(lanes, nchunks, chunk, warmup, MATRIX);
  const AgcParams p = load_agc_params(scal);
  PllParams pp;
  pp.alpha = scal[6];
  pp.beta = scal[7];
  pp.use_pll = scal[8];
  const int role = threadIdx.x / GROUP;   // 0: gain, 1: squelch + loads, 2: PLL
  const int streams = lanes / nchunks;
  const bool rows = MATRIX && vr_out != nullptr;
  float* const sre = smem;
  float* const sim = sre + XBUF * SP;
  float* const gring = sim + XBUF * SP;
  float* const ore = gring + 2 * SP;
  float* const oim = ore + 2 * SP;
  RowSpan* const spans = reinterpret_cast<RowSpan*>(oim + 2 * SP);

  // a lane beyond `lanes` starts from a fixed state and never steps
  float gain = g.ok ? g0[g.c] : 1.0f;
  float y2p = g.ok ? y2p0[g.c] : 0.0f;
  float gprev = gain;
  int mode = g.ok ? mode0[g.c] : 0;
  int timer = g.ok ? timer0[g.c] : 0;
  float theta = g.ok ? th0[g.c] : 0.0f;
  float freq = g.ok ? fr0[g.c] : 0.0f;

  auto stage = [&](int s) {
    const int b = (s % XBUF) * SP;
    if constexpr (MATRIX)
      stage_matrix_inputs<P>(g, xre, streams, len, sre + b, sim + b, s);
    else
      stage_inputs(g, xre, xim, sre + b, sim + b, s);
  };
  if (role == 1) {
    if constexpr (MATRIX) spans[g.j] = row_span(g, len);
    stage(0);
    cp_async_wait_all();
  }
  __syncthreads();
  // iteration it: gain runs stage it, squelch stage it - 1 while the
  // inputs of stage it + 1 arrive, the PLL stage it - 2; in the matrix
  // instance the squelch warp writes out the PLL's vr of stage it - 3, one
  // iteration more
  for (int it = 0; it <= g.nstages + 1 + MATRIX; ++it) {
    if (role == 0) {
      if (it < g.nstages) {
        const int b = (it % XBUF) * SP;
        float* const gr = gring + (it % 2) * SP;
        run_stage<P>(g, it, sre + b, sim + b, sre + b,
                     [&](int k, int tau, float xr, float xi, float) {
                       gain_step(p, g.live(tau), xr, xi, gain, y2p);
                       gr[k * P + g.j] = gain;
                     });
      }
    } else if (role == 1) {
      if (it + 1 < g.nstages) stage(it + 1);
      if (rows) {
        // stage it - 3's vr lies in the AGC output ring that this
        // iteration's squelch stage refills
        const int v = it - 3;
        if (v >= 0 && v < g.nstages) write_rows<P>(spans, ore + (v % 2) * SP, v, warmup, vr_out);
        __syncwarp();
      }
      const int s = it - 1;
      if (s >= 0 && s < g.nstages) {
        const int b = (s % XBUF) * SP;
        float* const gr = gring + (s % 2) * SP;
        float* const wr = ore + (s % 2) * SP;
        float* const wi = oim + (s % 2) * SP;
        run_stage<P>(g, s, sre + b, sim + b, gr,
                     [&](int k, int tau, float xr, float xi, float gnew) {
                       const int o = k * P + g.j;
                       squelch_step(p, g.live(tau), xr, xi, gprev, gnew, mode, timer,
                                    wr[o], wi[o]);
                       gprev = gnew;
                       if constexpr (MATRIX)
                         gr[o] = __int_as_float(mode);   // the gain it read, spent
                       else
                         store_if(g.writes(tau), modes_out + g.out_index(tau), mode);
                     });
        if (rows) {
          __syncwarp();
          write_rows<P>(spans, gr, s, warmup, modes_out);
        }
      }
      cp_async_wait_all();
    } else {
      const int s = it - 2;
      if (s >= 0 && s < g.nstages) {
        float* const rr = ore + (s % 2) * SP;
        const float* ri = oim + (s % 2) * SP;
        auto put_vr = [&](int k, int tau, float vr) {
          if constexpr (MATRIX)
            rr[k * P + g.j] = vr;   // in place of the AGC output's real part, read
          else
            store_if(g.writes(tau), vr_out + g.out_index(tau), vr);
        };
        if (bounded_stage(pp, theta, freq))
          run_stage<P>(g, s, rr, ri, rr, [&](int k, int tau, float outr, float outi, float) {
            put_vr(k, tau, pll_step<true>(pp, g.live(tau), outr, outi, theta, freq));
          });
        else
          run_stage<P>(g, s, rr, ri, rr, [&](int k, int tau, float outr, float outi, float) {
            put_vr(k, tau, pll_step<false>(pp, g.live(tau), outr, outi, theta, freq));
          });
      }
    }
    __syncthreads();
  }
  if (g.ok) {
    if (role == 0) {
      gN[g.l] = gain;
      y2pN[g.l] = y2p;
    } else if (role == 1) {
      modeN[g.l] = mode;
      timerN[g.l] = timer;
    } else {
      thN[g.l] = theta;
      frN[g.l] = freq;
    }
  }
}

template <bool MATRIX>
int launch(const float* scal, const float* xre, const float* xim, const float* g0,
           const float* y2p0, const int* mode0, const int* timer0, const float* th0,
           const float* fr0, float* vr, int* modes, float* gN, float* y2pN, int* modeN,
           int* timerN, float* thN, float* frN, int lanes, int nchunks, int chunk,
           int warmup, int len, void* stream) {
  if (lanes <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(am_front_scan_kernel<MATRIX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Layout<MATRIX>::SMEM);
  // the largest carveout, which two blocks of the matrix instance need
  if (e == cudaSuccess && MATRIX)
    e = cudaFuncSetAttribute(am_front_scan_kernel<MATRIX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (lanes + GROUP - 1) / GROUP;
  am_front_scan_kernel<MATRIX><<<blocks, WARPS * GROUP, Layout<MATRIX>::SMEM,
                                 static_cast<cudaStream_t>(stream)>>>(
      scal, xre, xim, g0, y2p0, mode0, timer0, th0, fr0, vr, modes, gN, y2pN, modeN, timerN,
      thN, frN, lanes, nchunks, chunk, warmup, len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Launch on `stream` and return a
// cudaError_t (0 on success); they do not synchronise. Initial state vectors
// are per stream (lanes / nchunks), final state vectors per lane.
//
// am_front_scan: planes xre/xim/vr/modes are (chunk, lanes) row-major, lane
// c * nchunks + i.
extern "C" int am_front_scan(const float* scal, const float* xre, const float* xim,
                             const float* g0, const float* y2p0, const int* mode0,
                             const int* timer0, const float* th0, const float* fr0,
                             float* vr, int* modes, float* gN, float* y2pN,
                             int* modeN, int* timerN, float* thN, float* frN,
                             int lanes, int nchunks, int chunk, int warmup,
                             void* stream) {
  return launch<false>(scal, xre, xim, g0, y2p0, mode0, timer0, th0, fr0, vr, modes, gN, y2pN,
                       modeN, timerN, thN, frN, lanes, nchunks, chunk, warmup, 0, stream);
}

// am_front_scan_mc: the C streams are the columns of y, a row-major (len,
// C) complex64 matrix, read in place; lane i * C + c, nchunks * chunk >= len;
// vr (f32) and modes (i32) are (C, len) row-major, both written unless vr
// is null.
extern "C" int am_front_scan_mc(const float* scal, const float* y, const float* g0,
                                const float* y2p0, const int* mode0, const int* timer0,
                                const float* th0, const float* fr0, float* vr, int* modes,
                                float* gN, float* y2pN, int* modeN, int* timerN, float* thN,
                                float* frN, int C, int nchunks, int chunk, int warmup, int len,
                                void* stream) {
  return launch<true>(scal, y, nullptr, g0, y2p0, mode0, timer0, th0, fr0, vr, modes, gN, y2pN,
                      modeN, timerN, thN, frN, C * nchunks, nchunks, chunk, warmup, len,
                      stream);
}
