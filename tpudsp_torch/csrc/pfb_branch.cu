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
// Layout. A thread per output (m, p), in a grid-stride loop over the M C
// outputs in row-major order: neighbouring threads take neighbouring
// branches, so a warp reads 32 consecutive input samples (in descending
// order) and writes 32 consecutive outputs. Index j < htail reads the
// tail, any other j reads x[j - htail]: the block is never copied behind
// the tail. Each input sample is read by T frames' threads; the reads
// after the first come from L2 (the frames of one tap lie R samples
// apart). The taps (T C f32) stay in L1 and L2.
//
// Bound. At BASELINE config 4 (C = 1024, T = 12, os = 1, N = 1024 x 16384
// samples a block) the function moves N x 8 bytes in and M C x 8 out: 268
// MB for complex64, 0.0801 ms at 3.35 TB/s (int16 input 201 MB, 0.0601 ms;
// uint8 168 MB, 0.0501 ms; os = 2 doubles the output); it does 4 T = 48
// f32 operations an output, 0.805 GFLOP, 0.012 ms at 67 TFLOP/s. So bytes
// bound it: the design keeps one read of each sample from device memory
// and one write of each output.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// One input sample's (re, im) as f32
struct C64 {
  static __device__ __forceinline__ float2 load(const void* p, size_t j) {
    return reinterpret_cast<const float2*>(p)[j];
  }
};
struct I16 {
  static __device__ __forceinline__ float2 load(const void* p, size_t j) {
    const short2 v = reinterpret_cast<const short2*>(p)[j];
    return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
  }
};
struct U8 {
  static __device__ __forceinline__ float2 load(const void* p, size_t j) {
    const uchar2 v = reinterpret_cast<const uchar2*>(p)[j];
    return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
  }
};

constexpr int THREADS = 256;

template <class In, bool Offset>
__global__ void __launch_bounds__(THREADS)
pfb_branch_kernel(const float* __restrict__ ht, const void* __restrict__ tail,
                  const void* __restrict__ x, float2* __restrict__ u, int T, int C, int os,
                  int M) {
  const int R = C / os;
  const long long htail = static_cast<long long>(T - 1) * C + C - 1;
  const long long total = static_cast<long long>(M) * C;
  for (long long o = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; o < total;
       o += static_cast<long long>(gridDim.x) * THREADS) {
    const int m = static_cast<int>(o / C);
    const int p = static_cast<int>(o - static_cast<long long>(m) * C);
    float re = 0.0f, im = 0.0f, sum = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float h = ht[t * C + p];
      const long long j = static_cast<long long>(m + os * (T - 1 - t)) * R + C - 1 - p;
      const float2 v = j < htail ? In::load(tail, j) : In::load(x, j - htail);
      re = re + h * v.x;
      im = im + h * v.y;
      if (Offset) sum = sum + h;
    }
    if (Offset) {
      const float dc = 127.5f * sum;
      re = re - dc;
      im = im - dc;
    }
    u[o] = make_float2(re, im);
  }
}

template <class In, bool Offset>
int run(const float* ht, const void* tail, const void* x, float2* u, int T, int C, int os, int M,
        cudaStream_t stream) {
  const long long total = static_cast<long long>(M) * C;
  // enough blocks to fill every SM many times over; the loop takes the rest
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  const auto kernel = pfb_branch_kernel<In, Offset>;
  kernel<<<blocks, THREADS, 0, stream>>>(ht, tail, x, u, T, C, os, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. ht: (T, C) f32 row-major; tail: the
// carried htail = (T-1) C + C-1 samples and x: the block's N samples, both
// of the input type `kind` (0 complex64, 1 int16 [re, im] pairs, 2 uint8
// [re, im] pairs); u: (M, C) complex64 out, M = N os / C. Launches on
// `stream` and returns a cudaError_t (0 on success); does not synchronise.
extern "C" int pfb_branch(const float* ht, const void* tail, const void* x, void* u, int kind,
                          int T, int C, int os, int M, void* stream) {
  if (M <= 0 || C <= 0 || T <= 0) return 0;
  if (os != 1 && os != 2) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  float2* out = static_cast<float2*>(u);
  switch (kind) {
    case 0: return run<C64, false>(ht, tail, x, out, T, C, os, M, s);
    case 1: return run<I16, false>(ht, tail, x, out, T, C, os, M, s);
    case 2: return run<U8, true>(ht, tail, x, out, T, C, os, M, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
