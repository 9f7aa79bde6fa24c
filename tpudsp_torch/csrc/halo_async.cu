// Strided complex decimating FIR over [halo | shard]: the compute of the
// async-halo front end, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudsp/pallas/halo_async.py (_kernel,
// wrapped by bank_front_async). On the TPU one kernel starts an inter-chip
// RDMA of the shard's input tail to its right neighbour, computes the
// interior output tiles while it is in flight, waits, and computes the
// boundary tile from the received halo. Here the exchange runs outside the
// kernel, as a send/receive on the time group that the wrapper
// (tpudsp_torch/cuda/halo_async.bank_front_async) posts, and this kernel is
// launched twice: over the interior outputs [S, nj), which read only the
// shard's own samples, while the exchange is in flight; then, after the
// wrapper's wait has ordered the stream after the transfer, over the
// boundary outputs [0, S) with the received halo. The plain PyTorch version
// is cuda/halo_async.cfir_ref (kernels/decimate.strided_cfir_matmul_wide
// over the centred samples, tile by tile).
//
// Function. With X = [halo (halo_len samples) | x (n samples) | pad],
//   y[c, j] = sum_{k < win} X[j*D1 + k] * T[k, c]   (complex, win = Kc*D1)
// for j in [j_begin, j_end). Samples are c64, or raw (re, im) int16 / uint8
// pairs converted to f32 and centred by `off` on load (127.5 for uint8; the
// taps carry the wire scale), as the TPU kernel centres them before its
// dot. Samples past the end of x read as the centred pad value (the TPU
// wrapper pads with 0, or 127 for uint8); the taps that reach them are zero.
//
// Layout. One block per tile of B consecutive outputs. The block stages the
// tile's input span, (B-1)*D1 + win samples, in shared memory as float2
// (re, im), converting on load with coalesced reads. Each thread then owns
// one output j and CG channels and accumulates their 2*CG sums over the win
// taps in f32, in the order k = 0, 1, ..., with one rounding per multiply
// and per add (-fmad=false). The taps are read from device memory as
// (win, C) float2 (Tr, Ti), or as (win, C) float Tr when the taps are real
// (Ti = 0, as on the AM path), which drops the two zero products and half
// the tap bytes and gives the same sums; all threads of a warp read the
// same tap, so each load is one broadcast served by L1. A block has
// B x (C / CG) threads, capped at 1024 (channel groups beyond the cap
// loop). B is the largest power of two up to 256 whose span fits in half
// an SM's shared memory, so two blocks share an SM; CG is the largest of
// 4, 3, 2, 1 that divides C and still leaves at least 128 threads a block
// where it can. At the AM shape (C = 3, D1 = 125, win = 3000): B = 64 (an
// 87 KB span), CG = 1, 192 threads. At the bank shape (C = 16, D1 = 10,
// win = 130): B = 256 (21 KB), CG = 4, 1024 threads.
//
// Bound. 4 f32 operations per tap, channel and output with real taps, 8
// with complex ones: 1.15 GFLOP at the AM shape (real taps, Kc = 24,
// nj = 32000 per 4M-sample shard: 17 us at 67 TFLOP/s) and 6.7 GFLOP at
// the bank shape (Kc = 13, nj = 400000 per 4M samples: 99 us), against
// 10 us and 25 us for their bytes (32 MB of c64 in, 0.8 MB and 51 MB out,
// at 3.35 TB/s). So the function is bound by operations, and this kernel
// by the rate at which the SMs execute them: every tap load and every
// multiply and add is its own instruction. A register tile of several
// outputs per thread (taps loaded once for all), or the tensor cores in
// 3xTF32, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr size_t kSpanBytes = 232448 / 2;  // half of a block's 227 KB

template <typename E> struct Pair;
template <> struct Pair<float> { using V = float2; };
template <> struct Pair<int16_t> { using V = short2; };
template <> struct Pair<uint8_t> { using V = uchar2; };

// Sample i of an interleaved (re, im) array of E, as f32 minus `off`.
template <typename E>
__device__ __forceinline__ float2 centred(const E* p, int64_t i, float off) {
  const typename Pair<E>::V v = reinterpret_cast<const typename Pair<E>::V*>(p)[i];
  return make_float2(static_cast<float>(v.x) - off,
                     static_cast<float>(v.y) - off);
}

// One tap's products added to an output's (re, im) sums, in a fixed order:
// a real tap t, or a complex tap (Tr, Ti).
__device__ __forceinline__ void mac(float& ar, float& ai, float2 v, float t) {
  ar = ar + v.x * t;
  ai = ai + v.y * t;
}
__device__ __forceinline__ void mac(float& ar, float& ai, float2 v, float2 t) {
  ar = ar + v.x * t.x;
  ar = ar - v.y * t.y;
  ai = ai + v.x * t.y;
  ai = ai + v.y * t.x;
}

// The shape of one launch.
struct Shape {
  int n, halo_len, C, win, D1, nj, j_begin, j_end, B;
  float off, pad;
};

// Tap: float (real taps) or float2 (complex taps).
template <typename E, typename Tap, int CG>
__global__ void __launch_bounds__(1024)
cfir_kernel(const E* __restrict__ x, const E* __restrict__ halo,
            const Tap* __restrict__ taps, float2* __restrict__ y, Shape s) {
  extern __shared__ float2 span[];
  const int j0 = s.j_begin + blockIdx.x * s.B;
  const int nspan = (s.B - 1) * s.D1 + s.win;
  const int64_t g0 = static_cast<int64_t>(j0) * s.D1;
  for (int i = threadIdx.x; i < nspan; i += blockDim.x) {
    const int64_t g = g0 + i;   // index into X = [halo | x | pad]
    float2 v;
    if (g < s.halo_len) {
      v = centred(halo, g, s.off);
    } else if (g - s.halo_len < s.n) {
      v = centred(x, g - s.halo_len, s.off);
    } else {
      v = make_float2(s.pad, s.pad);
    }
    span[i] = v;
  }
  __syncthreads();

  const int jl = threadIdx.x % s.B;
  const int j = j0 + jl;
  if (j >= s.j_end) return;
  const float2* xs = span + jl * s.D1;
  const int groups = s.C / CG;
  for (int grp = threadIdx.x / s.B; grp < groups; grp += blockDim.x / s.B) {
    const int c0 = grp * CG;
    float ar[CG], ai[CG];
#pragma unroll
    for (int q = 0; q < CG; ++q) {
      ar[q] = 0.0f;
      ai[q] = 0.0f;
    }
    const Tap* tk = taps + c0;
    for (int k = 0; k < s.win; ++k, tk += s.C) {
      const float2 v = xs[k];
#pragma unroll
      for (int q = 0; q < CG; ++q) mac(ar[q], ai[q], v, __ldg(tk + q));
    }
#pragma unroll
    for (int q = 0; q < CG; ++q)
      y[static_cast<int64_t>(c0 + q) * s.nj + j] = make_float2(ar[q], ai[q]);
  }
}

template <typename E, typename Tap, int CG>
int launch(const void* x, const void* halo, const void* taps, void* y,
           const Shape& s, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>((s.B - 1) * s.D1 + s.win) * sizeof(float2);
  auto kern = cfir_kernel<E, Tap, CG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = s.C / CG;
  const int threads = s.B * (groups < 1024 / s.B ? groups : 1024 / s.B);
  const int blocks = (s.j_end - s.j_begin + s.B - 1) / s.B;
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(halo),
      static_cast<const Tap*>(taps), static_cast<float2*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, typename Tap>
int launch_cg(int CG, const void* x, const void* halo, const void* taps,
              void* y, const Shape& s, cudaStream_t st) {
  switch (CG) {
    case 4: return launch<E, Tap, 4>(x, halo, taps, y, s, st);
    case 3: return launch<E, Tap, 3>(x, halo, taps, y, s, st);
    case 2: return launch<E, Tap, 2>(x, halo, taps, y, s, st);
    default: return launch<E, Tap, 1>(x, halo, taps, y, s, st);
  }
}

template <typename E>
int launch_taps(bool real_taps, int CG, const void* x, const void* halo,
                const void* taps, void* y, const Shape& s, cudaStream_t st) {
  return real_taps ? launch_cg<E, float>(CG, x, halo, taps, y, s, st)
                   : launch_cg<E, float2>(CG, x, halo, taps, y, s, st);
}

}  // namespace

// Plain C entry point for ctypes. x: n interleaved (re, im) samples of the
// format `fmt` (0: f32, i.e. complex64; 1: int16; 2: uint8); halo: halo_len
// samples of the same format; taps: (win, C) complex64 (Tr + i Ti, win =
// Kc*D1, correlation order), or (win, C) float32 Tr when real_taps is
// nonzero; y: (C, nj) complex64, of which the outputs [j_begin, j_end) are
// written. Launches on `stream` and returns the CUDA error (0 on success);
// it does not synchronise.
extern "C" int halo_async(const void* x, const void* halo, const void* taps,
                          void* y, int fmt, int real_taps, int n, int halo_len,
                          int C, int win, int D1, int nj, int j_begin,
                          int j_end, void* stream) {
  if (j_end <= j_begin) return 0;
  int B = 256;
  while (B > 32 &&
         static_cast<size_t>((B - 1) * D1 + win) * sizeof(float2) > kSpanBytes)
    B /= 2;
  if (static_cast<size_t>((B - 1) * D1 + win) * sizeof(float2) > 2 * kSpanBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  int CG = 1;
  for (int cg = 4; cg > 1; --cg) {
    if (C % cg == 0 && B * (C / cg) >= 128) {
      CG = cg;
      break;
    }
  }
  const float off = fmt == 2 ? 127.5f : 0.0f;
  const Shape s{n, halo_len, C, win, D1, nj, j_begin, j_end, B, off,
                fmt == 2 ? 127.0f - 127.5f : 0.0f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool real = real_taps != 0;
  switch (fmt) {
    case 0: return launch_taps<float>(real, CG, x, halo, taps, y, s, st);
    case 1: return launch_taps<int16_t>(real, CG, x, halo, taps, y, s, st);
    case 2: return launch_taps<uint8_t>(real, CG, x, halo, taps, y, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
