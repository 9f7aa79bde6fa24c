// CPU stand-ins for the CUDA features csrc/am_front_scan.cu,
// csrc/biquad_scan.cu, csrc/first_order_scan.cu and csrc/pfb_branch.cu use,
// so that tests/test_torch_am_front_emulated.py, tests/test_torch_biquad_
// emulated.py, tests/test_torch_first_order_cols_emulated.py and
// tests/test_torch_pfb_emulated.py can build the kernels' sources with g++
// and run them on the host: a launch runs its blocks one
// after the other,
// in ticket order, each block's threads as std::threads with std::barrier
// for __syncthreads, __syncwarp and the warp shuffles (emulate_launch), or, for a
// kernel whose threads never wait for each other, one thread after the
// other (emulate_serial_launch). Floating point is IEEE single (no
// contraction: -ffp-contract=off), __fmaf_rn is fmaf.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __restrict__

struct dim3_ {
  unsigned x, y, z;
};
inline thread_local dim3_ threadIdx, blockIdx, gridDim;
using cudaError_t = int;
using cudaStream_t = void*;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
  cudaDevAttrMultiProcessorCount = 16
};
struct float4 {
  float x, y, z, w;
};
struct float2 {
  float x, y;
};
struct short2 {
  short x, y;
};
struct uchar2 {
  unsigned char x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }

inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline int __float2int_rn(float x) { return static_cast<int>(std::nearbyint(x)); }
inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}
inline int __float_as_int(float f) {
  int v;
  std::memcpy(&v, &f, sizeof v);
  return v;
}
inline void __nanosleep(unsigned) {}
inline void __trap() {
  std::fprintf(stderr, "trap\n");
  std::abort();
}
inline float __ldcg(const float* p) { return *p; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {   // thread 0 alone calls it
  const unsigned old = *p;
  *p += v;
  return old;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// the emulated card: g_sms SMs of one resident block each, so that a
// test sets how many threads a launch shape fills
inline int g_sms = 1;
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = g_sms;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

// the running block's barriers and the warps' exchange slots
inline std::barrier<>* g_block;
inline std::vector<std::barrier<>*> g_warps;
inline float g_lanes[32][32];
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warps[threadIdx.x / 32]->arrive_and_wait(); }

inline float shuffle(float v, int src, bool in_range) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_lanes[w][l] = v;
  g_warps[w]->arrive_and_wait();
  const float r = in_range ? g_lanes[w][src] : v;
  g_warps[w]->arrive_and_wait();
  return r;
}
inline bool __all_sync(unsigned, bool p) {
  const int w = threadIdx.x / 32;
  g_lanes[w][threadIdx.x % 32] = p ? 1.0f : 0.0f;
  g_warps[w]->arrive_and_wait();
  bool all = true;
  for (int k = 0; k < 32; ++k) all = all && g_lanes[w][k] != 0.0f;
  g_warps[w]->arrive_and_wait();
  return all;
}
inline float __shfl_up_sync(unsigned, float v, int d) {
  const int l = threadIdx.x % 32;
  return shuffle(v, l - d, l >= d);
}
inline float __shfl_sync(unsigned, float v, int src) { return shuffle(v, src, true); }
inline float __shfl_down_sync(unsigned, float v, int d) {
  const int l = threadIdx.x % 32;
  return shuffle(v, l + d, l + d < 32);
}

// kernel<<<grid, threads, ...>>>(args...), as the test rewrites it
template <class Kernel, class... A>
void emulate_launch(int grid, int threads, Kernel kernel, A... args) {
  for (int block = 0; block < grid; ++block) {
    std::barrier<> all(threads);
    g_warps.clear();
    for (int w = 0; w < threads / 32; ++w) g_warps.push_back(new std::barrier<>(32));
    g_block = &all;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = block;
        gridDim.x = grid;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
    for (auto* w : g_warps) delete w;
  }
}

// kernel<<<grid, threads, ...>>>(args...) of a kernel with no barrier and
// no shuffle: every thread of every block in turn, on the calling thread
template <class Kernel, class... A>
void emulate_serial_launch(int grid, int threads, Kernel kernel, A... args) {
  gridDim.x = grid;
  for (int block = 0; block < grid; ++block)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = block;
      threadIdx.x = t;
      kernel(args...);
    }
}
