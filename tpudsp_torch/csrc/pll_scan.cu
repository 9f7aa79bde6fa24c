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
// Bound. A lane is a chain of dependent steps (sincosf, atan2f, the wrap);
// the exact route is one lane, so the kernel runs one thread and is bound
// by that chain's latency, not by the 12 bytes per sample it moves (about
// 0.34 us for 96000 samples at 3.35 TB/s). The design keeps theta and freq
// in registers; the chunked route trades 2x the steps for lanes.

#include "scan_step.cuh"

namespace {

using namespace tpudsp;

__global__ void __launch_bounds__(128)
pll_scan_kernel(const float* __restrict__ scal,
                const float* __restrict__ xre, const float* __restrict__ xim,
                const float* __restrict__ th0, const float* __restrict__ fr0,
                float* __restrict__ theta_out,
                float* __restrict__ thN, float* __restrict__ frN,
                int lanes, int nchunks, int chunk, int warmup) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int c = l / nchunks;   // stream
  const int i = l % nchunks;   // chunk within the stream
  const float alpha = scal[0];
  const float beta = scal[1];
  float theta = th0[c];
  float freq = fr0[c];

  auto step = [&](float xr, float xi) {
    float si, co;
    sincosf(theta, &si, &co);
    const float vr = xr * co + xi * si;
    const float vi = xi * co - xr * si;
    const float err = atan2f(vi, vr);
    freq = freq + alpha * err;
    theta = wrap_theta(theta + beta * err + freq);
  };

  const int64_t L = lanes;
  // warmup: stream samples [i*chunk - warmup, i*chunk), those >= 0 only
  const int64_t s0 = warmup_start(i, chunk, warmup);
  for (int t = (s0 < 0 ? static_cast<int>(-s0) : 0); t < warmup; ++t) {
    const int64_t src = plane_index(s0 + t, c, nchunks, chunk, L);
    step(xre[src], xim[src]);
  }
  for (int t = 0; t < chunk; ++t) {
    const int64_t idx = static_cast<int64_t>(t) * L + l;
    theta_out[idx] = theta;
    step(xre[idx], xim[idx]);
  }
  thN[l] = theta;
  frN[l] = freq;
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
  const int threads = 128;
  const int blocks = (lanes + threads - 1) / threads;
  pll_scan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      scal, xre, xim, th0, fr0, theta, thN, frN, lanes, nchunks, chunk, warmup);
  return static_cast<int>(cudaGetLastError());
}
