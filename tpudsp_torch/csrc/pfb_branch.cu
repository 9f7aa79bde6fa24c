// The polyphase filter bank's branch sum, before the channel IFFT, for
// NVIDIA Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: tpudsp/chains/channelizer.py
// channelize (:185-190) and channelize_i16 (:226-235) frame the carried
// tail and the block as a reversed (M, C) matrix and run T shifted
// multiply-adds over it, which XLA fuses into one pass; its 'conv' engine
// (:121-151) writes the same sum as one depthwise dilated convolution. In
// eager PyTorch every tap would write a product and a sum over the (M, C)
// matrix, so on the card the branch sum is this kernel, one launch a
// block. The plain PyTorch version is tpudsp_torch/kernels/pfb.
// branch_accumulate; the wrapper that launches this kernel is
// tpudsp_torch/cuda/pfb.
//
// Math, in the plain version's order, so that the two agree bit for bit
// (built with -fmad=false: no multiply and add is contracted). With C
// branches, T taps a branch, oversampling os (hop R = C / os), the carried
// tail of htail = (T-1) C + C-1 samples before the block x, xfull = tail
// ++ x:
//   u[m, p] = sum over t = 0..T-1 of Ht[t, p] xfull[(m + os (T-1-t)) R + C-1-p]
// from u = 0, multiply then add, re and im apart. Raw int16 / uint8 [re,
// im] samples convert to f32 at the product; for uint8, 127.5 times the
// branch's tap sum (in order t = 0..T-1) is subtracted from both parts.
//
// Layout. For one branch p the samples it reads form one sequence z[q] =
// xfull[q R + C-1-p], and u[m, p] is a T-tap filter along it: the sum over
// t of Ht[t, p] z[m + os (T-1-t)]. A thread owns one branch and a run of F
// consecutive frames: it keeps its T taps and a window of the last os
// (T-1) + 1 samples of z in registers, and per frame reads one new sample
// and writes one output. So each sample of the block is read once from
// device memory by each branch that uses it (once at os = 1; at os = 2 the
// branches p and p + R read the same samples a frame apart, and the second
// read comes from L2, the two threads being in one launch wave), plus os
// (T-1) samples to fill the window at the start of a run. The lanes of a
// warp own consecutive branches of one run, so every step reads 32
// consecutive samples of one hop row (in descending order) and writes 32
// consecutive outputs of one frame. Index j < htail reads the tail, any
// other j reads x[j - htail], once per sample read: the block is never
// copied behind the tail. The window needs T at compile time: instances
// for T up to 4, 8, 12 and 16, the taps past T masked in the unrolled
// loops; the wrapper refuses T > 16. F is chosen at launch so that the runs
// of all branches fill the card's resident threads once (at least MIN_RUN
// frames a run where M allows).
//
// Bound. At BASELINE config 4 (C = 1024, T = 12, os = 1, N = 1024 x 16384
// samples a block) the function moves N x 8 bytes in and M C x 8 out: 268
// MB for complex64, 0.0801 ms at 3.35 TB/s (int16 input 201 MB, 0.0601 ms;
// uint8 168 MB, 0.0501 ms; os = 2 doubles the output); it does 4 T = 48
// f32 operations an output, 0.805 GFLOP, 0.012 ms at 67 TFLOP/s. So bytes
// bound it: the design reads each sample once and writes each output once,
// coalesced.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// An input sample as loaded (Raw) and as (re, im) f32; AHEAD samples are
// loaded before the frames that use them, so that a thread keeps about 32
// bytes of loads in flight whatever the wire type
struct C64 {
  using Raw = float2;
  static constexpr int AHEAD = 4;
  static __device__ __forceinline__ Raw load(const void* p, long long j) {
    return reinterpret_cast<const float2*>(p)[j];
  }
  static __device__ __forceinline__ float2 value(Raw v) { return v; }
};
struct I16 {
  using Raw = short2;
  static constexpr int AHEAD = 8;
  static __device__ __forceinline__ Raw load(const void* p, long long j) {
    return reinterpret_cast<const short2*>(p)[j];
  }
  static __device__ __forceinline__ float2 value(Raw v) {
    return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
  }
};
struct U8 {
  using Raw = uchar2;
  static constexpr int AHEAD = 16;
  static __device__ __forceinline__ Raw load(const void* p, long long j) {
    return reinterpret_cast<const uchar2*>(p)[j];
  }
  static __device__ __forceinline__ float2 value(Raw v) {
    return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
  }
};

constexpr int THREADS = 256;
constexpr int MAX_TAPS = 16;
constexpr int MIN_RUN = 32;

// Sample j of tail ++ x, as loaded
template <class In>
__device__ __forceinline__ typename In::Raw fetch(const void* tail, const void* x,
                                                  long long htail, long long j) {
  return j < htail ? In::load(tail, j) : In::load(x, j - htail);
}

// One frame: push its newest sample into the window v (v[k] = z[newest -
// k]), then u = sum over t < T of h[t] v[OS t], in order from 0
template <bool Offset, int TMAX, int OS, int W>
__device__ __forceinline__ void frame(float2 (&v)[W], float2 newest, const float (&h)[TMAX],
                                      int T, float sum, float2* out) {
#pragma unroll
  for (int k = W - 1; k > 0; --k) v[k] = v[k - 1];
  v[0] = newest;
  float re = 0.0f, im = 0.0f;
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    if (t < T) {
      re = re + h[t] * v[OS * t].x;
      im = im + h[t] * v[OS * t].y;
    }
  }
  if (Offset) {
    const float dc = 127.5f * sum;
    re = re - dc;
    im = im - dc;
  }
  *out = make_float2(re, im);
}

template <class In, bool Offset, int TMAX, int OS>
__global__ void __launch_bounds__(THREADS)
pfb_branch_kernel(const float* __restrict__ ht, const void* __restrict__ tail,
                  const void* __restrict__ x, float2* __restrict__ u, int T, int C, int M,
                  int F, int runs) {
  constexpr int W = OS * (TMAX - 1) + 1;   // the window, newest sample first
  constexpr int D = In::AHEAD;
  const long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (g >= static_cast<long long>(runs) * C) return;
  const int run = static_cast<int>(g / C);
  const int p = static_cast<int>(g - static_cast<long long>(run) * C);
  const int m0 = run * F;
  const int m1 = m0 + F < M ? m0 + F : M;
  const long long R = C / OS;
  const long long htail = static_cast<long long>(T) * C - 1;
  const long long r = C - 1 - p;           // z[q] = (tail ++ x)[q R + r]
  const int span = OS * (T - 1);           // the newest sample's lead on the oldest
  float h[TMAX];
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    h[t] = t < T ? ht[t * C + p] : 0.0f;
    if (Offset && t < T) sum = sum + h[t];
  }
  // v[k] = z[n - k] with n the newest sample of the frame before m0: frame
  // m reads z[m + span - OS t] = v[OS t] once z[m + span] is pushed in
  float2 v[W];
#pragma unroll
  for (int k = 0; k < W; ++k)
    v[k] = k < span ? In::value(fetch<In>(tail, x, htail, (m0 + span - 1 - k) * R + r))
                    : make_float2(0.0f, 0.0f);
  float2* out = u + p;
  int m = m0;
  for (; m + D <= m1; m += D) {
    typename In::Raw raw[D];
#pragma unroll
    for (int i = 0; i < D; ++i) raw[i] = fetch<In>(tail, x, htail, (m + i + span) * R + r);
#pragma unroll
    for (int i = 0; i < D; ++i)
      frame<Offset, TMAX, OS>(v, In::value(raw[i]), h, T, sum,
                              out + static_cast<long long>(m + i) * C);
  }
#pragma unroll 1
  for (; m < m1; ++m)
    frame<Offset, TMAX, OS>(v, In::value(fetch<In>(tail, x, htail, (m + span) * R + r)), h, T,
                            sum, out + static_cast<long long>(m) * C);
}

template <class In, bool Offset, int TMAX, int OS>
int run(const float* ht, const void* tail, const void* x, float2* u, int T, int C, int M,
        cudaStream_t stream) {
  const auto kernel = pfb_branch_kernel<In, Offset, TMAX, OS>;
  // the card's resident threads for this instance: one run per thread of
  // them, fewer where a run would be shorter than MIN_RUN frames
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const long long resident = static_cast<long long>(sms > 0 ? sms : 1) *
                             (per_sm > 0 ? per_sm : 1) * THREADS;
  long long want = (resident + C - 1) / C;
  const long long most = (M + MIN_RUN - 1) / MIN_RUN;
  want = want < most ? want : most;
  const int F = static_cast<int>((M + want - 1) / want);
  const int runs = (M + F - 1) / F;
  const long long blocks = (static_cast<long long>(runs) * C + THREADS - 1) / THREADS;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(ht, tail, x, u, T, C, M, F,
                                                                 runs);
  return static_cast<int>(cudaGetLastError());
}

template <class In, bool Offset, int OS>
int by_taps(const float* ht, const void* tail, const void* x, float2* u, int T, int C, int M,
            cudaStream_t s) {
  if (T <= 4) return run<In, Offset, 4, OS>(ht, tail, x, u, T, C, M, s);
  if (T <= 8) return run<In, Offset, 8, OS>(ht, tail, x, u, T, C, M, s);
  if (T <= 12) return run<In, Offset, 12, OS>(ht, tail, x, u, T, C, M, s);
  return run<In, Offset, MAX_TAPS, OS>(ht, tail, x, u, T, C, M, s);
}

template <class In, bool Offset>
int by_os(const float* ht, const void* tail, const void* x, float2* u, int T, int C, int os,
          int M, cudaStream_t s) {
  return os == 1 ? by_taps<In, Offset, 1>(ht, tail, x, u, T, C, M, s)
                 : by_taps<In, Offset, 2>(ht, tail, x, u, T, C, M, s);
}

}  // namespace

// Plain C entry point for ctypes. ht: (T, C) f32 row-major, T <= 16; tail:
// the carried htail = (T-1) C + C-1 samples and x: the block's N samples,
// both of the input type `kind` (0 complex64, 1 int16 [re, im] pairs, 2
// uint8 [re, im] pairs); u: (M, C) complex64 out, M = N os / C. Launches on
// `stream` and returns a cudaError_t (0 on success); does not synchronise.
extern "C" int pfb_branch(const float* ht, const void* tail, const void* x, void* u, int kind,
                          int T, int C, int os, int M, void* stream) {
  if (M <= 0 || C <= 0 || T <= 0) return 0;
  if ((os != 1 && os != 2) || C % os || T > MAX_TAPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  float2* out = static_cast<float2*>(u);
  switch (kind) {
    case 0: return by_os<C64, false>(ht, tail, x, out, T, C, os, M, s);
    case 1: return by_os<I16, false>(ht, tail, x, out, T, C, os, M, s);
    case 2: return by_os<U8, true>(ht, tail, x, out, T, C, os, M, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
