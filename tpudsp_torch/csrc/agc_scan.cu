// Chunk-parallel AGC gain loop + squelch FSM, one sequential warmup+main
// scan per lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudsp/pallas/agc_scan.py (_agc_kernel,
// wrapped by agc_chunked_pallas). The plain PyTorch version is
// tpudsp_torch/kernels/agc.sample_step, looped over lane vectors by
// kernels/agc.agc_apply / agc_apply_chunked and
// cuda/agc_scan.agc_chunked_pallas_ref; the wrapper that launches this
// kernel is tpudsp_torch/cuda/agc_scan._launch. It serves all three routes
// of the AGC op: the Pallas route (chunk 1024), the XLA route
// (chunk = chunk_for(warmup)) and the exact scan (one lane per stream,
// warmup 0).
//
// Layout: scan_step.cuh's staged pipeline, two warps per group of 32
// lanes, grid ceil(lanes / 32). Warp 0 runs the gain chain (g, y2p) alone
// and hands each step's gain over through a ring in shared memory; warp 1
// runs rssi (log10f), the squelch FSM and the output one stage behind, and
// stages the next stage's inputs with cp.async. The warmup windows are NOT
// materialised: the history of a lane is read from the chunk planes, which
// also serves a warmup longer than the chunk (3840 > 1024 at alpha = 0.01)
// -- the history then spans several earlier chunks of the same stream, and
// a stage may cross a chunk boundary.
//
// Math. scan_step.cuh's gain_step and squelch_step, the two halves of
// agc.sample_step in its order, with output y = (yr * scale, yi * scale),
// zeroed in ENABLED / SIGNALLO.
//
// Bound. A lane is a chain of dependent steps, 3840 + 1024 at the 4M-sample
// main shape over 3907 lanes, one at the exact route. The bytes the
// function must move (8 B in, 12 B out per sample: 80 MB at 4M samples,
// ~24 us at 3.35 TB/s) are far below what the chain costs, so the kernel is
// bound by the latency of one step of the gain chain (mul, mul, add, mul,
// add, logf, mul, expf, mul, fminf, select). The first kernel paid that
// plus log10f and the FSM in one instruction stream, and on the Pallas
// route a fresh L2/HBM access per step, its rows lying 15.6 KB apart: ~590
// ns a step (258 ns on the exact route). Here the gain warp reads its
// inputs from shared memory a block of steps ahead and its step is the gain
// chain alone, ~104 ns on the H100 on every route (PERF.md).

#include "scan_step.cuh"

namespace {

using namespace tpudsp;

constexpr int WARPS = 2;
// f32 words of shared memory per lane per step of a stage: XBUF input
// stages of (re, im) and a double-buffered gain ring
constexpr int WORDS = 2 * XBUF + 2;
constexpr int SMEM = STAGE * GROUP * WORDS * sizeof(float);  // bytes per block
static_assert(SMEM <= SMEM_MAX, "the stage buffers exceed a block's shared memory");

__global__ void __launch_bounds__(WARPS * GROUP)
agc_scan_kernel(const float* __restrict__ scal,
                const float* __restrict__ xre, const float* __restrict__ xim,
                const float* __restrict__ g0, const float* __restrict__ y2p0,
                const int* __restrict__ mode0, const int* __restrict__ timer0,
                float* __restrict__ yre, float* __restrict__ yim,
                int* __restrict__ modes_out,
                float* __restrict__ gN, float* __restrict__ y2pN,
                int* __restrict__ modeN, int* __restrict__ timerN,
                int lanes, int nchunks, int chunk, int warmup) {
  extern __shared__ float smem[];
  const GroupLane g(lanes, nchunks, chunk, warmup);
  const AgcParams p = load_agc_params(scal);
  const int role = threadIdx.x / GROUP;   // 0: gain, 1: squelch + loads
  float* const sre = smem;
  float* const sim = sre + XBUF * SPAN;
  float* const gring = sim + XBUF * SPAN;

  // a lane beyond `lanes` starts from a fixed state and never steps
  float gain = g.ok ? g0[g.c] : 1.0f;
  float y2p = g.ok ? y2p0[g.c] : 0.0f;
  float gprev = gain;
  int mode = g.ok ? mode0[g.c] : 0;
  int timer = g.ok ? timer0[g.c] : 0;

  if (role == 1) {
    stage_inputs(g, xre, xim, sre, sim, 0);
    cp_async_wait_all();
  }
  __syncthreads();
  // iteration it: gain runs stage it, squelch stage it - 1 while the
  // inputs of stage it + 1 arrive
  for (int it = 0; it <= g.nstages; ++it) {
    if (role == 0) {
      if (it < g.nstages) {
        const int b = (it % XBUF) * SPAN;
        float* const gr = gring + (it % 2) * SPAN;
        run_stage(g, it, sre + b, sim + b, sre + b,
                  [&](int k, int tau, float xr, float xi, float) {
                    gain_step(p, g.live(tau), xr, xi, gain, y2p);
                    gr[k * GROUP + g.j] = gain;
                  });
      }
    } else {
      if (it + 1 < g.nstages) {
        const int b = ((it + 1) % XBUF) * SPAN;
        stage_inputs(g, xre, xim, sre + b, sim + b, it + 1);
      }
      const int s = it - 1;
      if (s >= 0) {
        const int b = (s % XBUF) * SPAN;
        run_stage(g, s, sre + b, sim + b, gring + (s % 2) * SPAN,
                  [&](int, int tau, float xr, float xi, float gnew) {
                    float outr, outi;
                    squelch_step(p, g.live(tau), xr, xi, gprev, gnew, mode, timer,
                                 outr, outi);
                    gprev = gnew;
                    const bool w = g.writes(tau);
                    const int64_t o = g.out_index(tau);
                    store_if(w, yre + o, outr);
                    store_if(w, yim + o, outi);
                    store_if(w, modes_out + o, mode);
                  });
      }
      cp_async_wait_all();
    }
    __syncthreads();
  }
  if (g.ok) {
    if (role == 0) {
      gN[g.l] = gain;
      y2pN[g.l] = y2p;
    } else {
      modeN[g.l] = mode;
      timerN[g.l] = timer;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. scal holds the 6 f32 AGC scalars;
// planes xre/xim/yre/yim/modes are (chunk, lanes) row-major; initial state
// vectors are per stream (lanes / nchunks); final state vectors are per
// lane. Launches on `stream` and returns a cudaError_t (0 on success); it
// does not synchronise.
extern "C" int agc_scan(const float* scal, const float* xre, const float* xim,
                        const float* g0, const float* y2p0, const int* mode0,
                        const int* timer0, float* yre, float* yim, int* modes,
                        float* gN, float* y2pN, int* modeN, int* timerN,
                        int lanes, int nchunks, int chunk, int warmup,
                        void* stream) {
  if (lanes <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      agc_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (lanes + GROUP - 1) / GROUP;
  agc_scan_kernel<<<blocks, WARPS * GROUP, SMEM, static_cast<cudaStream_t>(stream)>>>(
      scal, xre, xim, g0, y2p0, mode0, timer0, yre, yim, modes, gN, y2pN,
      modeN, timerN, lanes, nchunks, chunk, warmup);
  return static_cast<int>(cudaGetLastError());
}
