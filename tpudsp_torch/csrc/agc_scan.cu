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
// Layout (scan_step.cuh). One thread per lane, 128 threads per block, grid
// ceil(lanes / 128); the four AGC values (g, y2p, mode, timer) live in
// registers for the whole warmup + main loop. The warmup windows are NOT
// materialised: each lane reads its history from the chunk planes, which
// also serves a warmup longer than the chunk (3840 > 1024 at alpha = 0.01)
// -- the history then spans several earlier chunks of the same stream.
//
// Math. scan_step.cuh's AgcLane::step, shared with am_front_scan.cu, with
// output y = (yr * scale, yi * scale), zeroed in ENABLED / SIGNALLO.
//
// Bound. The step is a dependent chain (logf, expf, log10f, the FSM) and a
// lane runs warmup + chunk of them: 3840 + 1024 at the 4M-sample main
// shape, spread over 3907 lanes (31 blocks of 128 on 132 SMs). The bytes
// the function must move (8 B in, 12 B out per sample: 80 MB at 4M
// samples, ~24 us at 3.35 TB/s) are far below what the step latency costs,
// so the kernel is bound by that latency; the Pallas route's warmup of
// 3.75 chunks per lane also makes it do 4.75x the function's steps. The
// design keeps the loop in registers and every step's loads contiguous
// across a warp; shortening the warmup or filling the SMs more is later
// work. The exact route (one lane) is a pure latency chain.

#include "scan_step.cuh"

namespace {

using namespace tpudsp;

__global__ void __launch_bounds__(128)
agc_scan_kernel(const float* __restrict__ scal,
                const float* __restrict__ xre, const float* __restrict__ xim,
                const float* __restrict__ g0, const float* __restrict__ y2p0,
                const int* __restrict__ mode0, const int* __restrict__ timer0,
                float* __restrict__ yre, float* __restrict__ yim,
                int* __restrict__ modes_out,
                float* __restrict__ gN, float* __restrict__ y2pN,
                int* __restrict__ modeN, int* __restrict__ timerN,
                int lanes, int nchunks, int chunk, int warmup) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int c = l / nchunks;   // stream
  const int i = l % nchunks;   // chunk within the stream
  const AgcParams p = load_agc_params(scal);

  AgcLane st;
  st.g = g0[c];
  st.y2p = y2p0[c];
  st.mode = mode0[c];
  st.timer = timer0[c];

  const int64_t L = lanes;
  float outr, outi;
  // warmup: stream samples [i*chunk - warmup, i*chunk), those >= 0 only
  const int64_t s0 = warmup_start(i, chunk, warmup);
  for (int t = (s0 < 0 ? static_cast<int>(-s0) : 0); t < warmup; ++t) {
    const int64_t src = plane_index(s0 + t, c, nchunks, chunk, L);
    st.step(p, xre[src], xim[src], outr, outi);
  }
  for (int t = 0; t < chunk; ++t) {
    const int64_t idx = static_cast<int64_t>(t) * L + l;
    st.step(p, xre[idx], xim[idx], outr, outi);
    yre[idx] = outr;
    yim[idx] = outi;
    modes_out[idx] = st.mode;
  }
  gN[l] = st.g;
  y2pN[l] = st.y2p;
  modeN[l] = st.mode;
  timerN[l] = st.timer;
}

}  // namespace

// Plain C entry point for ctypes. scal holds the 6 f32 AGC scalars;
// planes xre/xim/yre/yim/modes are (chunk, lanes) row-major; initial state
// vectors are per stream (lanes / nchunks); final state vectors are per
// lane. Launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise.
extern "C" int agc_scan(const float* scal, const float* xre, const float* xim,
                        const float* g0, const float* y2p0, const int* mode0,
                        const int* timer0, float* yre, float* yim, int* modes,
                        float* gN, float* y2pN, int* modeN, int* timerN,
                        int lanes, int nchunks, int chunk, int warmup,
                        void* stream) {
  if (lanes <= 0) return 0;
  const int threads = 128;
  const int blocks = (lanes + threads - 1) / threads;
  agc_scan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      scal, xre, xim, g0, y2p0, mode0, timer0, yre, yim, modes, gN, y2pN,
      modeN, timerN, lanes, nchunks, chunk, warmup);
  return static_cast<int>(cudaGetLastError());
}
