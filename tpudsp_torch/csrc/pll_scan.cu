// Carrier-PLL scan, one sequential warmup+main scan per lane, for NVIDIA
// Hopper (sm_90a).
//
// The JAX package runs this loop as a lax.scan, not as a Pallas kernel:
// tpudsp/kernels/pll.py pll_carrier_scan (exact) and, through _chunked_scan,
// pll_carrier_scan_chunked. On the card it is this kernel, never a Python
// loop of per-sample launches. The plain PyTorch version is
// tpudsp_torch/kernels/pll.pll_step, looped by kernels/pll.
// pll_carrier_scan / pll_carrier_scan_chunked; the wrapper that launches
// this kernel is tpudsp_torch/cuda/pll_scan._launch. The exact scan is one
// lane per stream with warmup 0; the chunked form runs lanes as
// scan_step.cuh lays them out.
//
// Math, per sample, as pll.py's step: v = x e^{-j theta} written as
// (xr cos + xi sin, xi cos - xr sin); err = atan2f(Im v, Re v) -- libm
// atan2, as pll.py:57, not the polynomial of am_front_scan.cu; sin and cos
// from one sincosf, which returns the bits of sinf and cosf; the output
// is theta BEFORE the update; freq += alpha err; theta = wrap(theta +
// beta err + freq) with the floor-mod wrap of scan_step.cuh.
//
// Layout: scan_step.cuh's staged pipeline, two warps per group of 32
// lanes, grid ceil(lanes / 32). Warp 0 runs the PLL chain (theta, freq) on
// inputs in shared memory and stores theta with predicated stores; warp 1
// copies the next stage's inputs into shared memory with cp.async
// (stage_inputs: the warmup row and shift stepped, not divided) while the
// stage runs, so no step waits on device memory. Before each stage the PLL
// warp votes (bounded_stage): where every lane keeps theta in [-pi, pi]
// and the wrap's argument in (-2 pi, 4 pi), the stage runs sin_cos_reduced
// (libdevice's sincosf without its Payne-Hanek branch, the same bits) and
// the wrap without its fmodf branch (the same bits in that range);
// otherwise it runs sincosf and the full wrap.
//
// Bound. A lane is a chain of dependent steps (sincos, atan2f, the loop
// filter, the wrap); the exact route is one lane, so the kernel runs one
// chain and is bound by its latency, not by the 12 bytes per sample it
// moves (about 0.34 us for 96000 samples at 3.35 TB/s). What is left on
// the chain is atan2f itself, with the IEEE divide and its slow-path check.

#include "scan_step.cuh"

namespace {

using namespace tpudsp;

constexpr int WARPS = 2;
constexpr int NBUF = 2;   // input stages resident: the PLL warp's and the one in flight
// f32 words of shared memory per lane per step of a stage: NBUF stages of
// (re, im)
constexpr int WORDS = 2 * NBUF;
constexpr int SMEM = STAGE * GROUP * WORDS * sizeof(float);  // bytes per block
static_assert(SMEM <= SMEM_MAX, "the stage buffers exceed a block's shared memory");

// One step of pll.py's loop on the input (xr, xi). A step that is not live
// keeps theta and freq. BOUNDED: the stage was voted bounded, so neither
// sincosf's nor the wrap's branch is compiled in.
template <bool BOUNDED>
__device__ __forceinline__ void pll_step(const PllParams& p, bool live, float xr, float xi,
                                         float& theta, float& freq) {
  float si, co;
  if (BOUNDED)
    sin_cos_reduced(theta, si, co);
  else
    sincosf(theta, &si, &co);
  const float vr = xr * co + xi * si;
  const float vi = xi * co - xr * si;
  const float err = atan2f(vi, vr);
  const float fr = freq + p.alpha * err;
  const float th = wrap_theta<BOUNDED>(theta + p.beta * err + fr);
  freq = live ? fr : freq;
  theta = live ? th : theta;
}

template <bool BOUNDED>
__device__ __forceinline__ void pll_stage(const GroupLane& g, const PllParams& p, int s,
                                          const float* sre, const float* sim,
                                          float* theta_out, float& theta, float& freq) {
  run_stage(g, s, sre, sim, sre, [&](int, int tau, float xr, float xi, float) {
    store_if(g.writes(tau), theta_out + g.out_index(tau), theta);
    pll_step<BOUNDED>(p, g.live(tau), xr, xi, theta, freq);
  });
}

__global__ void __launch_bounds__(WARPS * GROUP)
pll_scan_kernel(const float* __restrict__ scal,
                const float* __restrict__ xre, const float* __restrict__ xim,
                const float* __restrict__ th0, const float* __restrict__ fr0,
                float* __restrict__ theta_out,
                float* __restrict__ thN, float* __restrict__ frN,
                int lanes, int nchunks, int chunk, int warmup) {
  extern __shared__ float smem[];
  const GroupLane g(lanes, nchunks, chunk, warmup);
  PllParams p;
  p.alpha = scal[0];
  p.beta = scal[1];
  p.use_pll = 1.0f;
  const int role = threadIdx.x / GROUP;   // 0: PLL, 1: loads
  float* const sre = smem;
  float* const sim = sre + NBUF * SPAN;

  // a lane beyond `lanes` starts from a fixed state and never steps
  float theta = g.ok ? th0[g.c] : 0.0f;
  float freq = g.ok ? fr0[g.c] : 0.0f;

  if (role == 1) {
    stage_inputs(g, xre, xim, sre, sim, 0);
    cp_async_wait_all();
  }
  __syncthreads();
  // stage s: the PLL warp runs it while the inputs of stage s + 1 arrive
  for (int s = 0; s < g.nstages; ++s) {
    const int b = (s % NBUF) * SPAN;
    if (role == 0) {
      if (bounded_stage(p, theta, freq))
        pll_stage<true>(g, p, s, sre + b, sim + b, theta_out, theta, freq);
      else
        pll_stage<false>(g, p, s, sre + b, sim + b, theta_out, theta, freq);
    } else {
      if (s + 1 < g.nstages) {
        const int nb = ((s + 1) % NBUF) * SPAN;
        stage_inputs(g, xre, xim, sre + nb, sim + nb, s + 1);
      }
      cp_async_wait_all();
    }
    __syncthreads();
  }
  if (g.ok && role == 0) {
    thN[g.l] = theta;
    frN[g.l] = freq;
  }
}

}  // namespace

// Plain C entry point for ctypes. scal = [alpha, beta] (f32); planes
// xre/xim/theta are (chunk, lanes) row-major; initial state vectors are per
// stream (lanes / nchunks); final state vectors are per lane. Launches on
// `stream` and returns cudaGetLastError() (0 on success); it does not
// synchronise.
extern "C" int pll_scan(const float* scal, const float* xre, const float* xim,
                        const float* th0, const float* fr0, float* theta,
                        float* thN, float* frN,
                        int lanes, int nchunks, int chunk, int warmup,
                        void* stream) {
  if (lanes <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      pll_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (lanes + GROUP - 1) / GROUP;
  pll_scan_kernel<<<blocks, WARPS * GROUP, SMEM, static_cast<cudaStream_t>(stream)>>>(
      scal, xre, xim, th0, fr0, theta, thN, frN, lanes, nchunks, chunk, warmup);
  return static_cast<int>(cudaGetLastError());
}
