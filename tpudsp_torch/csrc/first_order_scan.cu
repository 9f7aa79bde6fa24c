// Blocked first-order recurrence y[n] = b0 x[n] + a y[n-1] with a
// double-float carry, and the AM receiver's linear tail built from two of
// them, for NVIDIA Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: tpudsp/kernels/iir.py:283
// first_order_apply_blocked runs the within-block prefix as one einsum and
// carries the block entry values through a sequential lax.scan. On the card
// it is this kernel, one launch per call, never a Python loop of launches.
// The plain PyTorch versions are tpudsp_torch/kernels/iir.
// first_order_apply_blocked and kernels/iir.linear_tail; the wrapper that
// launches this kernel is tpudsp_torch/cuda/first_order.
//
// Entry points:
//   first_order_scan: one recurrence over each of C rows;
//   linear_tail_scan: the DC tracker (b0 = 1 - rho, a = rho), audio = (vr -
//     dc * use_dc) * inv_mod, then the de-emphasis, over each of C rows.
//
// Math, in the plain version's order, so that the two agree bit for bit
// (built with -fmad=false: no multiply and add is contracted):
//   1. the within-block prefix of each L = 32 block, Yin[b, i] = sum over j
//      = 0..31 of x[bL + j] T[i, j], in order, zeros included, multiply
//      then add, from the host table T[i, j] = b0 a^(i-j) (rounded from
//      float64);
//   2. the block entry values in double-float, one block after the other,
//      in the body of the JAX scan: E[0] = (y_prev, 0), E[b+1] =
//      df_add(df_mul(a^L, E[b]), (Yin[b, 31], 0)), a^L split from float64
//      by the host;
//   3. y = Yin + a^(i+1) (EH + EL).
//
// Layout. One block of 256 threads per row; the row runs in tiles of 2048
// samples (64 blocks of L), with the tile's input and prefix in shared
// memory. Each thread keeps its row of T (its i = thread % 32) and a^(i+1)
// in registers and computes 8 prefix sums of a tile, whose inputs are
// shared-memory broadcasts. One thread runs the carry over the tile's 64
// blocks from the shared prefix, the other threads load the next tile's
// input meanwhile. The second recurrence of the tail runs on the audio of
// the same tile, which the first one has just made: a tile needs nothing
// of the later ones, so the tail stays one pass over the row, and neither
// recurrence's output goes to device memory before the pcm.
//
// Bound. At the AM receiver's shape (one row, n = 96000, B = 3000 blocks)
// the tail moves 8 bytes a sample (vr in, pcm out: 0.77 MB, 0.23 us at
// 3.35 TB/s) and does 2 x 64 operations a sample (12.3 MFLOP, 0.18 us at
// 67 TFLOP/s). What bounds it is the carry: 2 x 3000 dependent
// double-float steps of about twenty dependent f32 operations each, in one
// thread. A parallel carry (a warp-level scan of the (a^L, S) pairs) would
// round in another order than the JAX package's sequential scan and is not
// done here; the prefix of the next tile, which the carry does not need,
// could overlap it in other warps.

#include <cuda_runtime.h>

namespace {

constexpr int L = 32;                 // samples per block
constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;         // samples of a tile per thread
constexpr int TILE = THREADS * PER_THREAD;   // samples per tile
constexpr int TILE_BLOCKS = TILE / L;
static_assert(THREADS % L == 0, "a thread's i is its index mod L");

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

// One recurrence's constants in this thread's registers: its row of T,
// a^(i+1) for its i, and a^L.
struct Recurrence {
  float t[L];
  float power;
  Df aL;

  __device__ Recurrence(const float* __restrict__ tab) {
    const int i = threadIdx.x % L;
#pragma unroll
    for (int j = 0; j < L; ++j) t[j] = tab[i * L + j];
    power = tab[L * L + i];
    aL = {tab[L * L + L], tab[L * L + L + 1]};
  }

  // Yin of this thread's samples k = threadIdx.x + r THREADS of the tile
  // in sx, into sy
  __device__ __forceinline__ void prefix(const float* sx, float* sy) const {
    float acc[PER_THREAD];
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) acc[r] = 0.0f;
    const int base = threadIdx.x - threadIdx.x % L;
#pragma unroll
    for (int j = 0; j < L; ++j) {
#pragma unroll
      for (int r = 0; r < PER_THREAD; ++r)
        acc[r] = acc[r] + sx[base + r * THREADS + j] * t[j];
    }
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) sy[threadIdx.x + r * THREADS] = acc[r];
  }
};

// The carry over the first `nb` blocks of a tile, by one thread: se[b] =
// EH + EL of block b, e advanced past each block. The blocks' last prefix
// values are read in groups of 8 ahead of the chain that uses them.
__device__ __forceinline__ void carry(Df aL, Df& e, const float* sy, float* se, int nb) {
  for (int b0 = 0; b0 < nb; b0 += 8) {
    float s[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] = b0 + u < nb ? sy[(b0 + u) * L + L - 1] : 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (b0 + u < nb) {
        se[b0 + u] = e.hi + e.lo;
        e = df_add(df_mul(aL, e), Df{s[u], 0.0f});
      }
    }
  }
}

// This thread's samples of tile `tile` of a row of n, zeros past the end
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int n, int tile,
                                          float (&v)[PER_THREAD]) {
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int k = tile * TILE + threadIdx.x + r * THREADS;
    v[r] = k < n ? x[k] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
first_order_scan_kernel(const float* __restrict__ tab, const float* __restrict__ x,
                        const float* __restrict__ y_prev, float* __restrict__ y,
                        float* __restrict__ y_last, int n) {
  __shared__ float sx[TILE];
  __shared__ float sy[TILE];
  __shared__ float se[TILE_BLOCKS];
  const Recurrence rec(tab);
  const size_t row = blockIdx.x;
  x += row * n;
  y += row * n;
  Df e{y_prev[row], 0.0f};   // meaningful in thread 0, which runs the carry
  const int tiles = (n + TILE - 1) / TILE;
  float v[PER_THREAD];
  load_tile(x, n, 0, v);
  for (int tile = 0; tile < tiles; ++tile) {
    __syncthreads();   // the previous tile is done with sx, sy and se
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) sx[threadIdx.x + r * THREADS] = v[r];
    if (tile + 1 < tiles) load_tile(x, n, tile + 1, v);
    __syncthreads();
    rec.prefix(sx, sy);
    __syncthreads();
    const int start = tile * TILE;
    if (threadIdx.x == 0) carry(rec.aL, e, sy, se, (min(n - start, TILE) + L - 1) / L);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int k = threadIdx.x + r * THREADS;
      const float out = sy[k] + rec.power * se[k / L];
      if (start + k < n) y[start + k] = out;
      if (start + k == n - 1) y_last[row] = out;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
linear_tail_kernel(const float* __restrict__ tab_dc, const float* __restrict__ tab_de,
                   const float* __restrict__ scal, const float* __restrict__ vr,
                   const float* __restrict__ dc0, const float* __restrict__ de0,
                   float* __restrict__ pcm, float* __restrict__ dc_last,
                   float* __restrict__ de_last, int n) {
  __shared__ float sx[TILE];
  __shared__ float sy[TILE];
  __shared__ float se[TILE_BLOCKS];
  const Recurrence dc(tab_dc);
  const Recurrence de(tab_de);
  const float use_dc = scal[0];
  const float inv_mod = scal[1];
  const size_t row = blockIdx.x;
  vr += row * n;
  pcm += row * n;
  Df e_dc{dc0[row], 0.0f};   // the carries live in thread 0
  Df e_de{de0[row], 0.0f};
  const int tiles = (n + TILE - 1) / TILE;
  float v[PER_THREAD];
  load_tile(vr, n, 0, v);
  for (int tile = 0; tile < tiles; ++tile) {
    const int start = tile * TILE;
    const int nb = (min(n - start, TILE) + L - 1) / L;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) sx[threadIdx.x + r * THREADS] = v[r];
    if (tile + 1 < tiles) load_tile(vr, n, tile + 1, v);
    __syncthreads();
    // the DC tracker
    dc.prefix(sx, sy);
    __syncthreads();
    if (threadIdx.x == 0) carry(dc.aL, e_dc, sy, se, nb);
    __syncthreads();
    // audio over this thread's samples, in place of vr; zeros past the end,
    // where the de-emphasis reads its padding
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int k = threadIdx.x + r * THREADS;
      const float track = sy[k] + dc.power * se[k / L];
      if (start + k == n - 1) dc_last[row] = track;
      sx[k] = start + k < n ? (sx[k] - track * use_dc) * inv_mod : 0.0f;
    }
    __syncthreads();
    // the de-emphasis
    de.prefix(sx, sy);
    __syncthreads();
    if (threadIdx.x == 0) carry(de.aL, e_de, sy, se, nb);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int k = threadIdx.x + r * THREADS;
      const float out = sy[k] + de.power * se[k / L];
      if (start + k < n) pcm[start + k] = out;
      if (start + k == n - 1) de_last[row] = out;
    }
  }
}

}  // namespace

// Plain C entry points for ctypes. tab / tab_dc / tab_de are the host
// tables of kernels/iir.block_table (L * L + L + 2 f32 values: T row-major,
// a^(i+1), a^L as (hi, lo)); x / vr / y / pcm are
// (rows, n) row-major f32; y_prev, y_last, dc0, de0, dc_last, de_last are
// (rows,); scal = [use_dc, inv_mod]. Each launches on `stream` and returns
// a cudaError_t (0 on success); neither synchronises.
extern "C" int first_order_scan(const float* tab, const float* x, const float* y_prev,
                                float* y, float* y_last, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  first_order_scan_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, x, y_prev, y, y_last, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_tail_scan(const float* tab_dc, const float* tab_de, const float* scal,
                                const float* vr, const float* dc0, const float* de0,
                                float* pcm, float* dc_last, float* de_last, int rows, int n,
                                void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  linear_tail_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tab_dc, tab_de, scal, vr, dc0, de0, pcm, dc_last, de_last, n);
  return static_cast<int>(cudaGetLastError());
}
