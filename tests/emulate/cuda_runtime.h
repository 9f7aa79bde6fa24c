// CPU stand-ins for the CUDA features csrc/biquad_scan.cu uses, so that
// tests/test_torch_biquad_emulated.py can build the kernel's source with
// g++ and run it on the host: a launch runs its blocks one after the
// other, in ticket order, each block's threads as std::threads with
// std::barrier for __syncthreads and the warp shuffles. Floating point is
// IEEE single (no contraction: -ffp-contract=off), __fmaf_rn is fmaf.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __restrict__

struct dim3_ {
  unsigned x, y, z;
};
inline thread_local dim3_ threadIdx;
using cudaError_t = int;
using cudaStream_t = void*;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct float4 {
  float x, y, z, w;
};

inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
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

// the running block's barriers and the warps' exchange slots
inline std::barrier<>* g_block;
inline std::vector<std::barrier<>*> g_warps;
inline float g_lanes[32][32];
inline void __syncthreads() { g_block->arrive_and_wait(); }

inline float shuffle(float v, int src, bool in_range) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_lanes[w][l] = v;
  g_warps[w]->arrive_and_wait();
  const float r = in_range ? g_lanes[w][src] : v;
  g_warps[w]->arrive_and_wait();
  return r;
}
inline float __shfl_up_sync(unsigned, float v, int d) {
  const int l = threadIdx.x % 32;
  return shuffle(v, l - d, l >= d);
}
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
        kernel(args...);
      });
    for (auto& t : ts) t.join();
    for (auto* w : g_warps) delete w;
  }
}
