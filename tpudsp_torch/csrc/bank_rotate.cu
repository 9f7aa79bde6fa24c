// The receiver bank's output rotation and FM discriminator in one pass,
// for NVIDIA Hopper (sm_90a): from the channel filter's output to the FM
// rows that the audio decimator reads.
//
// Replaces no Pallas kernel. The JAX package runs this step in XLA
// (tpudsp/chains/bank.py bank_step: the uint32 phase lattice, the complex
// rotation, then freqdem's conjugate product and the polynomial atan2);
// the port ran it as eager PyTorch passes over (C, nj) tensors
// (chains/bank.phase_lattice, the rotation, chains/bank._fm_base). Its
// plain version is tpudsp_torch/kernels/bank_rotate.fm_base; the wrapper
// is tpudsp_torch/cuda/bank_rotate.fm_base. chains/bank.bank_step takes
// it where every channel of the bank is FM.
//
// Function. For output m of channel c of y (C, nj) complex64:
//   u = phase_c + n0 dtheta_c + m (dtheta_c D1)   (uint32, mod 2^32)
//   theta = f32(u) * scale                        (round to nearest; scale
//                                                   = f32(2 pi / 2^32))
//   w[m] = y[m] e^{-j theta}: sincosf(-theta) (libdevice's, no fast math),
//          then wr = yr c - yi s, wi = yr s + yi c
//   base[c, m] = patan2(di, dr) / div, the conjugate product of w[m] after
//          w[m - 1] (fd_prev_c before m = 0) as four real products
//          (fm_discriminator.cuh, shared with fm_deemph_cols), div = f32(2
//          pi kd), an IEEE divide
// and fd_last_c = w[nj - 1]. The arithmetic is the plain version's, in its
// order; the file is built with -fmad=false, so no product and sum is
// contracted that the plain version rounds twice, and the two agree bit
// for bit.
//
// Layout. A warp takes CHUNK = 32 RUN consecutive outputs of one channel;
// lane l takes outputs m0 + 32 r + l for r < RUN, so each of the warp's
// loads reads 256 contiguous bytes and each store writes 128. The warp
// loads its RUN samples a lane first, all in flight at once. Lane l's
// angle starts at its first output's and steps by 32 dtheta_c D1, exact in
// uint32 because the sum wraps mod 2^32 as the lattice does. The rotated
// sample before an output is lane l - 1's, by a shuffle; lane 0 takes lane
// 31's of the step before, and before the chunk's first output it rotates
// the sample before the chunk itself (fd_prev at m = 0). Each sample is
// read once, but for those 1 in CHUNK.
//
// Bound. At the bank16 shape (C = 16, nj = 800,000) it reads y once (102.4
// MB) and writes the rows once (51.2 MB): 153.6 MB, 0.0458 ms at 3.35
// TB/s. Its ~38 f32 operations an output (the angle's 2, sine and cosine
// one each, the rotation's 6, the discriminator's 27 with its two divides:
// 0.49 GFLOP) take 0.0073 ms at 67 TFLOP/s. So bytes bind.

#include <cuda_runtime.h>

#include "fm_discriminator.cuh"

namespace {

using namespace fm_discriminator;

constexpr int THREADS = 256;
constexpr int RUN = 16;              // outputs a lane
constexpr int CHUNK = 32 * RUN;      // consecutive outputs of one channel a warp

// v e^{-j theta}, theta = f32(u) * scale
__device__ __forceinline__ float2 rotate(float2 v, unsigned u, float scale) {
  const float theta = __uint2float_rn(u) * scale;
  float s, c;
  sincosf(-theta, &s, &c);
  return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
}

__global__ void __launch_bounds__(THREADS)
bank_rotate_kernel(const float2* __restrict__ y, const long long* __restrict__ phase,
                   const long long* __restrict__ n0, const long long* __restrict__ dtheta,
                   const float2* __restrict__ fd_prev, float* __restrict__ base,
                   float2* __restrict__ fd_last, int C, int nj, int D1, int chunks,
                   float scale, float div) {
  const int lane = threadIdx.x % 32;
  const long long warp = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  if (warp >= static_cast<long long>(C) * chunks) return;   // a whole warp
  const int c = static_cast<int>(warp / chunks);
  const int m0 = static_cast<int>(warp % chunks) * CHUNK;
  const float2* row = y + static_cast<size_t>(c) * nj;
  float* out = base + static_cast<size_t>(c) * nj;
  float2 v[RUN];
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const int m = m0 + 32 * r + lane;
    v[r] = m < nj ? row[m] : make_float2(0.0f, 0.0f);
  }
  // the values in [0, 2^32) of the int64 phase, n0 and dtheta
  const unsigned dth = static_cast<unsigned>(dtheta[c]);
  const unsigned start = static_cast<unsigned>(phase[c]) + static_cast<unsigned>(*n0) * dth;
  const unsigned step = dth * static_cast<unsigned>(D1);
  // the rotated sample before the chunk's first output (lane 0's)
  float2 carry = fd_prev[c];
  if (lane == 0 && m0 > 0) carry = rotate(row[m0 - 1], start + (m0 - 1) * step, scale);
  unsigned u = start + static_cast<unsigned>(m0 + lane) * step;
  const int from = (lane + 31) % 32;
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const int m = m0 + 32 * r + lane;
    const float2 w = rotate(v[r], u, scale);
    u += 32u * step;
    const float2 p = make_float2(__shfl_sync(0xffffffffu, w.x, from),
                                 __shfl_sync(0xffffffffu, w.y, from));
    const float2 before = lane > 0 ? p : carry;
    carry = p;   // lane 0: lane 31's, the sample before its next output
    if (m < nj) out[m] = discriminator(w, before, div);
    if (m == nj - 1) fd_last[c] = w;
  }
}

}  // namespace

// Plain C entry point for ctypes. y: (C, nj) complex64 row-major; phase,
// dtheta: (C,) int64 and n0: one int64, each in [0, 2^32); fd_prev,
// fd_last: (C,) complex64; base: (C, nj) f32 row-major, written; scale =
// f32(2 pi / 2^32), div = f32(2 pi kd). Launches on `stream` and returns
// the CUDA error (0 on success); it does not synchronise.
extern "C" int bank_rotate(const float2* y, const long long* phase, const long long* n0,
                           const long long* dtheta, const float2* fd_prev, float* base,
                           float2* fd_last, int C, int nj, int D1, float scale, float div,
                           void* stream) {
  if (C <= 0 || nj <= 0) return 0;
  const int chunks = (nj + CHUNK - 1) / CHUNK;
  const long long threads = static_cast<long long>(C) * chunks * 32;
  const unsigned blocks = static_cast<unsigned>((threads + THREADS - 1) / THREADS);
  bank_rotate_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      y, phase, n0, dtheta, fd_prev, base, fd_last, C, nj, D1, chunks, scale, div);
  return static_cast<int>(cudaGetLastError());
}
