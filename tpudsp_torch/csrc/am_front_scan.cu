// AGC + squelch FSM + carrier-PLL feedback core of the fused AM receiver,
// one sequential warmup+main scan per lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudsp/pallas/am_backend_scan.py
// (_make_kernel, wrapped by front_chunked_pallas). The plain PyTorch
// version is tpudsp_torch/kernels/am_backend.front_sample_step, looped by
// tpudsp_torch/cuda/am_backend_scan.front_chunked_ref; the wrapper that
// launches this kernel is tpudsp_torch/cuda/am_backend_scan._launch.
//
// Layout (scan_step.cuh). Lane l = c * nchunks + i carries chunk i of
// stream c. One thread per lane, 128 threads per block, grid
// ceil(lanes / 128). The six feedback values (g, y2p, mode, timer, theta,
// freq) live in registers for the whole warmup + main loop. The warmup
// windows are NOT materialised: each lane reads its history from the chunk
// planes and skips samples before its stream's start -- the per-lane
// t_start of the TPU kernel, t_start = warmup - min(warmup, i * chunk),
// derived from the lane index. A launch with warmup = 0 and nchunks = 1 is
// the exact sequential front (front_exact) over each stream.
//
// Math. Exactly the step of front_sample_step: the AGC half is
// scan_step.cuh's AgcLane::step (shared with agc_scan.cu), the PLL half
// uses the 6-coefficient polynomial atan2 (patan2) and f32 constants;
// expf, logf, log10f, sinf, cosf with no fast-math, built with -fmad=false
// so no multiply-add is contracted that the plain version rounds twice.
// The theta wrap is a floor-mod with the divisor's sign (jnp.mod /
// torch.remainder).
//
// Bound. Each lane is a chain of dependent steps (~7680 at the main path's
// 4M-sample block: 3840 warmup + 3840 chunk), and the main path has only
// 25 lanes, i.e. one partly-filled warp on one SM: the kernel is bound by
// the latency of one step's dependent transcendental chain, not by bytes
// or FLOPs (it moves ~16 bytes per step per lane). Filling the card
// (more, shorter chunks; several streams per launch) is later work.

#include "scan_step.cuh"

namespace {

using namespace tpudsp;

struct Params {
  AgcParams agc;
  float pll_alpha, pll_beta, use_pll;
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

struct Lane {
  AgcLane agc;
  float theta, freq;

  // one front_sample_step; returns vr = Re(v) and leaves the new mode in
  // agc.mode
  __device__ __forceinline__ float step(const Params& p, float xr, float xi) {
    float outr, outi;
    agc.step(p.agc, xr, xi, outr, outi);
    const float c = cosf(theta);
    const float s = sinf(theta);
    const float vr = outr * c + outi * s;
    const float vi = outi * c - outr * s;
    const float err = patan2f(vi, vr) * p.use_pll;
    freq = freq + p.pll_alpha * err;
    theta = wrap_theta(theta + p.pll_beta * err + freq);
    return vr;
  }
};

__global__ void __launch_bounds__(128)
am_front_scan_kernel(const float* __restrict__ scal,
                     const float* __restrict__ xre, const float* __restrict__ xim,
                     const float* __restrict__ g0, const float* __restrict__ y2p0,
                     const int* __restrict__ mode0, const int* __restrict__ timer0,
                     const float* __restrict__ th0, const float* __restrict__ fr0,
                     float* __restrict__ vr_out, int* __restrict__ modes_out,
                     float* __restrict__ gN, float* __restrict__ y2pN,
                     int* __restrict__ modeN, int* __restrict__ timerN,
                     float* __restrict__ thN, float* __restrict__ frN,
                     int lanes, int nchunks, int chunk, int warmup) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int c = l / nchunks;   // stream
  const int i = l % nchunks;   // chunk within the stream

  Params p;
  p.agc = load_agc_params(scal);
  p.pll_alpha = scal[6];
  p.pll_beta = scal[7];
  p.use_pll = scal[8];

  Lane st;
  st.agc.g = g0[c];
  st.agc.y2p = y2p0[c];
  st.agc.mode = mode0[c];
  st.agc.timer = timer0[c];
  st.theta = th0[c];
  st.freq = fr0[c];

  const int64_t L = lanes;
  // warmup: stream samples [i*chunk - warmup, i*chunk), those >= 0 only
  const int64_t s0 = warmup_start(i, chunk, warmup);
  for (int t = (s0 < 0 ? static_cast<int>(-s0) : 0); t < warmup; ++t) {
    const int64_t src = plane_index(s0 + t, c, nchunks, chunk, L);
    st.step(p, xre[src], xim[src]);
  }
  for (int t = 0; t < chunk; ++t) {
    const int64_t idx = static_cast<int64_t>(t) * L + l;
    vr_out[idx] = st.step(p, xre[idx], xim[idx]);
    modes_out[idx] = st.agc.mode;
  }
  gN[l] = st.agc.g;
  y2pN[l] = st.agc.y2p;
  modeN[l] = st.agc.mode;
  timerN[l] = st.agc.timer;
  thN[l] = st.theta;
  frN[l] = st.freq;
}

}  // namespace

// Plain C entry point for ctypes. Planes xre/xim/vr/modes are (chunk, lanes)
// row-major; initial state vectors are per stream (lanes / nchunks);
// final state vectors are per lane. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int am_front_scan(const float* scal, const float* xre, const float* xim,
                             const float* g0, const float* y2p0, const int* mode0,
                             const int* timer0, const float* th0, const float* fr0,
                             float* vr, int* modes, float* gN, float* y2pN,
                             int* modeN, int* timerN, float* thN, float* frN,
                             int lanes, int nchunks, int chunk, int warmup,
                             void* stream) {
  if (lanes <= 0) return 0;
  const int threads = 128;
  const int blocks = (lanes + threads - 1) / threads;
  am_front_scan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      scal, xre, xim, g0, y2p0, mode0, timer0, th0, fr0, vr, modes, gN, y2pN,
      modeN, timerN, thN, frN, lanes, nchunks, chunk, warmup);
  return static_cast<int>(cudaGetLastError());
}
