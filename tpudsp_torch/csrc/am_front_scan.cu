// AGC + squelch FSM + carrier-PLL feedback core of the fused AM receiver,
// one sequential warmup+main scan per lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudsp/pallas/am_backend_scan.py
// (_make_kernel, wrapped by front_chunked_pallas). The plain PyTorch
// version is tpudsp_torch/kernels/am_backend.front_sample_step, looped by
// tpudsp_torch/cuda/am_backend_scan.front_chunked_ref; the wrapper that
// launches this kernel is tpudsp_torch/cuda/am_backend_scan._launch.
//
// Layout. Lane l = c * nchunks + i carries chunk i of stream c. One thread
// per lane, 128 threads per block, grid ceil(lanes / 128). The six
// feedback values (g, y2p, mode, timer, theta, freq) live in registers for
// the whole warmup + main loop. Inputs and outputs are time-major
// (steps, lanes) planes, so a warp's loads and stores at one step are
// contiguous. The warmup windows are NOT materialised: warmup step t of
// lane (c, i) reads stream sample s = i * chunk - warmup + t straight from
// the chunk planes (chunk s / chunk of the same stream, row s % chunk), and
// steps with s < 0 are skipped -- the per-lane t_start of the TPU kernel,
// t_start = warmup - min(warmup, i * chunk), derived from the lane index.
// A launch with warmup = 0 and nchunks = 1 is the exact sequential front
// (front_exact) over each stream.
//
// Math. Exactly the step of front_sample_step with the 6-coefficient
// polynomial atan2 (patan2) and f32 constants; expf, logf, log10f, sinf,
// cosf with no fast-math, built with -fmad=false so no multiply-add is
// contracted that the plain version rounds twice. The theta wrap is a
// floor-mod with the divisor's sign (jnp.mod / torch.remainder).
//
// Bound. Each lane is a chain of dependent steps (~7680 at the main path's
// 4M-sample block: 3840 warmup + 3840 chunk), and the main path has only
// 25 lanes, i.e. one partly-filled warp on one SM: the kernel is bound by
// the latency of one step's dependent transcendental chain, not by bytes
// or FLOPs (it moves ~16 bytes per step per lane). Filling the card
// (more, shorter chunks; several streams per launch) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SQ_UNKNOWN = 0;
constexpr int SQ_ENABLED = 1;
constexpr int SQ_RISE = 2;
constexpr int SQ_SIGNALHI = 3;
constexpr int SQ_FALL = 4;
constexpr int SQ_SIGNALLO = 5;
constexpr int SQ_TIMEOUT = 6;
constexpr int SQ_DISABLED = 7;

// f32 roundings of pi/2, pi and 2 pi, as the JAX package's f32 constants
constexpr float HALF_PI_F = 1.57079637050628662109375f;
constexpr float PI_F = 3.1415927410125732421875f;
constexpr float TWO_PI_F = 6.283185482025146484375f;

struct Params {
  float alpha, threshold, scale, pll_alpha, pll_beta, use_pll;
  bool locked, squelch;
  int timeout;
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
  float g, y2p, theta, freq;
  int mode, timer;

  // one front_sample_step; returns vr = Re(v) and leaves the new mode in
  // `mode`
  __device__ __forceinline__ float step(const Params& p, float xr, float xi) {
    const float yr = xr * g;
    const float yi = xi * g;
    const float y2 = yr * yr + yi * yi;
    y2p = (1.0f - p.alpha) * y2p + p.alpha * y2;
    const float g_new = fminf(g * expf(-0.5f * p.alpha * logf(y2p + 1e-30f)), 1e6f);
    g = p.locked ? g : g_new;
    const float rssi = -20.0f * log10f(fmaxf(g, 1e-30f));
    const bool high = rssi > p.threshold;

    // squelch FSM, branch-free, in tpudsp/kernels/agc.py _fsm_step's order
    int nm = mode;
    nm = (mode == SQ_UNKNOWN || mode == SQ_ENABLED) ? (high ? SQ_RISE : SQ_ENABLED) : nm;
    nm = (mode == SQ_RISE) ? (high ? SQ_SIGNALHI : SQ_FALL) : nm;
    nm = (mode == SQ_SIGNALHI && !high) ? SQ_FALL : nm;
    nm = (mode == SQ_FALL) ? (high ? SQ_SIGNALHI : SQ_SIGNALLO) : nm;
    timer = (mode == SQ_FALL && !high) ? p.timeout : timer;
    const bool in_lo = mode == SQ_SIGNALLO;
    timer = (in_lo && !high) ? timer - 1 : timer;
    nm = in_lo ? (high ? SQ_SIGNALHI : (timer <= 0 ? SQ_TIMEOUT : SQ_SIGNALLO)) : nm;
    nm = (mode == SQ_TIMEOUT) ? SQ_ENABLED : nm;
    mode = p.squelch ? nm : SQ_DISABLED;

    const bool zero = mode == SQ_ENABLED || mode == SQ_SIGNALLO;
    const float outr = zero ? 0.0f : yr * p.scale;
    const float outi = zero ? 0.0f : yi * p.scale;
    const float c = cosf(theta);
    const float s = sinf(theta);
    const float vr = outr * c + outi * s;
    const float vi = outi * c - outr * s;
    const float err = patan2f(vi, vr) * p.use_pll;
    freq = freq + p.pll_alpha * err;
    float m = fmodf(theta + p.pll_beta * err + freq + PI_F, TWO_PI_F);
    m = m < 0.0f ? m + TWO_PI_F : m;  // the divisor is positive
    theta = m - PI_F;
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
  p.alpha = scal[0];
  p.locked = scal[1] > 0.5f;
  p.squelch = scal[2] > 0.5f;
  p.threshold = scal[3];
  p.timeout = static_cast<int>(scal[4]);
  p.scale = scal[5];
  p.pll_alpha = scal[6];
  p.pll_beta = scal[7];
  p.use_pll = scal[8];

  Lane st;
  st.g = g0[c];
  st.y2p = y2p0[c];
  st.mode = mode0[c];
  st.timer = timer0[c];
  st.theta = th0[c];
  st.freq = fr0[c];

  const int64_t L = lanes;
  // warmup: stream samples [i*chunk - warmup, i*chunk), those >= 0 only
  const int64_t s0 = static_cast<int64_t>(i) * chunk - warmup;
  for (int t = (s0 < 0 ? static_cast<int>(-s0) : 0); t < warmup; ++t) {
    const int64_t s = s0 + t;
    const int64_t src = (s % chunk) * L + (static_cast<int64_t>(c) * nchunks + s / chunk);
    st.step(p, xre[src], xim[src]);
  }
  for (int t = 0; t < chunk; ++t) {
    const int64_t idx = static_cast<int64_t>(t) * L + l;
    vr_out[idx] = st.step(p, xre[idx], xim[idx]);
    modes_out[idx] = st.mode;
  }
  gN[l] = st.g;
  y2pN[l] = st.y2p;
  modeN[l] = st.mode;
  timerN[l] = st.timer;
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
