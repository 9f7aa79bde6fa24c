// The double-float arithmetic and the tile-to-tile chain shared by the
// blocked scans first_order_scan.cu and biquad_scan.cu.
//
// Double-float: a value as an unevaluated f32 pair (hi, lo), with the
// Dekker/Knuth error-free transforms of tpudsp_torch/kernels/iir.py (the
// plain versions run the same operations in the same order; every source
// that includes this is built with -fmad=false, so no multiply and add is
// contracted).
//
// The chain: a launch's blocks take their tiles in the order they start
// (an atomic ticket on a counter in a scratch buffer), so a block only
// waits for a tile that a block which started before it holds. All that
// passes from one tile of a row to the next is its entry value, through a
// link in the same buffer: the value by plain stores, then the launch's
// epoch (never 0, a new one each launch on the buffer) as the flag by a
// release store; the reader acquires the flag, then reads the value past
// L1. The wrapper keeps one buffer per stream (cuda/launch.chain), made
// zero once: launches on one stream run in order, so they share it
// without clearing it. Every kernel's links have the one width LINK with
// the flag in the last slot, so a flag slot only ever holds an epoch,
// whichever kernel used the buffer before: a value left by another
// kernel can never be read as a flag.

#pragma once

#include <cuda_runtime.h>

namespace tile_chain {

struct Df {
  float hi, lo;
};

__device__ __forceinline__ Df two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}

__device__ __forceinline__ void dk_split(float a, float& hi, float& lo) {
  const float t = 4097.0f * a;   // 2^12 + 1
  hi = t - (t - a);
  lo = a - hi;
}

__device__ __forceinline__ Df two_prod(float a, float b) {
  const float p = a * b;
  float ah, al, bh, bl;
  dk_split(a, ah, al);
  dk_split(b, bh, bl);
  return {p, ((ah * bh - p) + ah * bl + al * bh) + al * bl};
}

__device__ __forceinline__ Df renorm(float hi, float lo) {
  const float s = hi + lo;
  return {s, lo - (s - hi)};
}

__device__ __forceinline__ Df df_add(Df x, Df y) {
  const Df s = two_sum(x.hi, y.hi);
  return renorm(s.hi, s.lo + (x.lo + y.lo));
}

__device__ __forceinline__ Df df_mul(Df x, Df y) {
  const Df p = two_prod(x.hi, y.hi);
  return renorm(p.hi, p.lo + (x.hi * y.lo + x.lo * y.hi));
}

// 32-bit slots of a link: its value (up to LINK - 1 floats), then its flag
// in the last slot (cuda/launch.LINK)
constexpr int LINK = 8;

// A value of N floats at `link`, then its flag
template <int N>
__device__ __forceinline__ void publish(float* link, const float (&v)[N], int epoch) {
  static_assert(N < LINK, "a link's value ends before its flag");
#pragma unroll
  for (int i = 0; i < N; ++i) link[i] = v[i];
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(link + LINK - 1), "r"(epoch)
               : "memory");
}

template <int N>
__device__ __forceinline__ void await(const float* link, float (&v)[N], int epoch) {
  static_assert(N < LINK, "a link's value ends before its flag");
  for (long long spin = 0;; ++spin) {
    int ready;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(ready)
                 : "l"(link + LINK - 1)
                 : "memory");
    if (ready == epoch) break;
    if (spin > (1ll << 24)) __trap();   // never: the tile before is on a running block
    __nanosleep(32);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __ldcg(link + i);
}

// Where a launch's blocks find their tiles and pass their entries on.
struct Chain {
  unsigned* counter;   // blocks started on this scratch buffer, ever
  unsigned base;       // its value when this launch was enqueued
  int epoch;
  float* links;        // the launch's links, LINK slots each

  // This block's ticket, in the order the blocks start. Ends with
  // __syncthreads.
  __device__ __forceinline__ int ticket(int* slot) const {
    if (threadIdx.x == 0) *slot = static_cast<int>(atomicAdd(counter, 1u) - base);
    __syncthreads();
    return *slot;
  }
};

// The chain of a launch over `scratch`: 4 int32 (the counter), then the links
__host__ inline Chain make_chain(int* scratch, int base, int epoch) {
  return Chain{reinterpret_cast<unsigned*>(scratch), static_cast<unsigned>(base), epoch,
               reinterpret_cast<float*>(scratch + 4)};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tile_chain
