// The compensated (double-float) SOS cascade: each second-order section's
// transposed direct form II recurrence, for NVIDIA Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: tpudsp/kernels/iir.py:212
// sos_apply_df runs each section (_biquad_scan_df, :159) as a log-depth
// lax.associative_scan of double-float 2x2 maps, a few hundred small ops
// a section. On the card it is this kernel, one launch for the whole
// cascade of a call. The plain PyTorch version is tpudsp_torch/kernels/
// iir.sos_apply_df; the wrapper is tpudsp_torch/cuda/biquad_scan.
//
// Math. A section (b0, b1, b2, 1, a1, a2) is the state recurrence
//   v[n] = A v[n-1] + c x[n],  A = [[-a1, 1], [-a2, 0]],
//   c = [b1 - a1 b0, b2 - a2 b0],  y[n] = b0 x[n] + v[n-1][0],
// with every value of v a double-float pair (hi, lo) and A, c split from
// the float64 design (the f32-rounded a1, a2 of a low-Fc design move its
// poles by enough to change the filter). A product's error term is the
// exact one, by a fused multiply-add (prod, dmul below). One step, in the
// plain version's order (built with -fmad=false, so the two agree bit for
// bit):
//   u_k = renorm(prod(c_k.hi, x) + c_k.lo x), k = 0, 1;
//   v0' = df_add(dmul(-a1, v0), df_add(v1, u0)); v1' = df_add(dmul(-a2,
//   v0), u1).
// The output is f32, y = b0 x + (v0.hi + v0.lo) of the previous sample,
// and the state carried from call to call is f32 (hi + lo), as in the JAX
// package. Per section, blocks of L = 16 samples, tiles of TB = 128
// blocks (T = 2048 samples), windows of W = 128 tiles:
//   1. each block from a zero entry, 16 steps, keeping each sample's local
//      state v_loc[i] (its first component in registers; the whole state
//      at the row's last sample); the last is S[b], the constant of the
//      block's affine map v -> A^L v + S[b];
//   2. the inclusive scan P of the S[b] within the tile, log-depth: within
//      each run of 32 blocks (a warp), P[b] <- A^(L d) P[b-d] + P[b] at d =
//      1, 2, ..., 16; the runs' last values T_r in order, C_0 = T_0, C_r =
//      A^(32 L) C_(r-1) + T_r; then P[b] <- A^(L (l+1)) C_(r-1) + P[b] for
//      block l of run r > 0. P[TB-1] is the tile's aggregate P_t (its map
//      v -> A^T v + P_t), published at once for the later tiles of its
//      window;
//   3. the tile's entry: thread k < j (j the tile's place in its window)
//      takes tile k's aggregate and makes A^(T (j-1-k)) P_k, the other
//      threads 0; each warp adds its 32 in a fixed tree (at d = 16, 8, 4,
//      2, 1 lane l takes its value + lane l + d's), thread 0 the warps'
//      sums in order, and E_t = A^(T j) E_w + F from the window's entry
//      E_w. The window's last tile publishes the next window's entry A^T
//      E_t + P_t; E_0 = (v_prev, 0). Every tile folds in the same order
//      whenever its links land, so the bits do not depend on timing, and
//      a link crosses a window (262,144 samples), not a tile;
//   4. the block entries E[0] = E_t, E[b] = A^(L b) E_t + P[b-1], then no
//      second pass: v[i] = A^(i+1) E[b] + v_loc[i] are independent
//      products, of which y[i] needs only row 0 of A^i (y[i] = b0 x[i] +
//      v[i-1][0]), and the whole state is made at the row's last sample.
// The powers A^(L m), A^k and A^(T m) are float64 matrix powers split by
// the host (kernels/iir.sos_table). Near-unit poles (radius ~0.9983 at
// BroadcastAM's 20 Hz highpass) are why the steps stay double-float.
//
// Layout. One launch runs every section over every row: a complex64 row
// is two rows, its re and im parts (the coefficients are real), read and
// written in the interleaved layout. One block of TB threads per tile of a
// row, thread b owning block b (its 16 samples in a padded shared row,
// overwritten by y): CLowpassIIR's 2^18-sample complex64 call is 2 x 128
// blocks, about 2 on each of the 132 SMs, and BroadcastAM's 6291 real
// samples 4. A tile runs its sections one after the other on its shared
// rows, each section's table row copied in (cp.async) while the section
// before runs; section s of a tile waits only for section s of the tiles
// before it in its window and for its window's entry (csrc/tile_chain.
// cuh's links, in start order, so no block waits for one that has not
// started).
//
// Bound. The function needs one double-float step per sample, row and
// section: 104 f32 operations as the cascade of the JAX package counts it
// (its step with Dekker products, 101 once the constants' splits come
// from the host and x's and v0.hi's are made once, and y, 3), against 8
// bytes a sample of a row (x in, y out) for the whole cascade. At
// CLowpassIIR(order=8) on 2^18 complex64 samples (4 sections, 2 rows)
// that is 0.218 GFLOP (3.26 us at 67 TFLOP/s) against 4.2 MB (1.25 us at
// 3.35 TB/s): operations bound it. This kernel's step is 65 operations
// (prod 2, dmul 9, df_add 11); it spends about 1.7 steps a sample (row 0
// of a product, ~40, and ~7 products a block in the scan). Each section
// is a round of latency: the 16-step chain and the scan, the links of the
// window's tiles, the products; the tiles of a row wait for each other
// once a section.

#include "tile_chain.cuh"

namespace {

using namespace tile_chain;

constexpr int L = 16;                 // samples per block
constexpr int TB = 128;               // blocks per tile, one per thread
constexpr int THREADS = TB;
constexpr int TILE = TB * L;          // samples per tile
constexpr int W = TB;                 // tiles per window, one per thread
constexpr int ROW = L + 1;            // a block's padded row in shared memory
constexpr int WARPS = THREADS / 32;
constexpr int HEAD = 16;              // a section's coefficients in its table row
// a section's powers: A^(L m), m = 0..TB-1; A^k, k = 1..L; A^(TILE m),
// m = 0..W-1
constexpr int SAMPLE_POW = TB - 1;    // A^k at SAMPLE_POW + k
constexpr int TILE_POW = TB + L;      // A^(TILE m) at TILE_POW + m
constexpr int NPOW = TB + L + W;
constexpr int WIDTH = HEAD + 8 * NPOW;   // floats of a section's table row
static_assert(TB % 32 == 0, "whole warps: the scan runs within each and then across them");

struct V2 {
  Df x, y;
};

// A 2x2 double-float matrix [[a, b], [c, d]]
struct M2 {
  Df a, b, c, d;
};

// The product a b = p + e, e = a b - p by one fused multiply-add (Hopper
// runs it at the rate of a multiply), where tile_chain's two_prod spends a
// Dekker split of each factor and 7 more operations for the same e (the
// two differ only where Dekker's partial products underflow).
__device__ __forceinline__ Df prod(float a, float b) {
  const float p = a * b;
  return {p, __fmaf_rn(a, b, -p)};
}

// df_mul with the product by prod
__device__ __forceinline__ Df dmul(Df x, Df y) {
  const Df p = prod(x.hi, y.hi);
  return renorm(p.hi, p.lo + (x.hi * y.lo + x.lo * y.hi));
}

__device__ __forceinline__ V2 add(V2 p, V2 q) { return {df_add(p.x, q.x), df_add(p.y, q.y)}; }

// m p
__device__ __forceinline__ V2 mul(const M2& m, V2 p) {
  return {df_add(dmul(m.a, p.x), dmul(m.b, p.y)), df_add(dmul(m.c, p.x), dmul(m.d, p.y))};
}

// m p + q
__device__ __forceinline__ V2 mv(const M2& m, V2 p, V2 q) { return add(mul(m, p), q); }

constexpr unsigned ALL = 0xffffffffu;

__device__ __forceinline__ V2 shfl_up(V2 p, int d) {
  return {{__shfl_up_sync(ALL, p.x.hi, d), __shfl_up_sync(ALL, p.x.lo, d)},
          {__shfl_up_sync(ALL, p.y.hi, d), __shfl_up_sync(ALL, p.y.lo, d)}};
}

__device__ __forceinline__ V2 shfl_down(V2 p, int d) {
  return {{__shfl_down_sync(ALL, p.x.hi, d), __shfl_down_sync(ALL, p.x.lo, d)},
          {__shfl_down_sync(ALL, p.y.hi, d), __shfl_down_sync(ALL, p.y.lo, d)}};
}

__device__ __forceinline__ void publish_v(float* link, V2 p, int epoch) {
  const float v[4] = {p.x.hi, p.x.lo, p.y.hi, p.y.lo};
  publish(link, v, epoch);
}

__device__ __forceinline__ V2 await_v(const float* link, int epoch) {
  float v[4];
  await(link, v, epoch);
  return {{v[0], v[1]}, {v[2], v[3]}};
}

// A section's table row, copied to shared memory without staging in
// registers (16 bytes a copy; the rows are 16-byte aligned: WIDTH % 4 == 0)
__device__ __forceinline__ void fetch_row(float* dst, const float* src) {
  static_assert(WIDTH % 4 == 0, "whole 16-byte copies");
  for (int k = 4 * threadIdx.x; k < WIDTH; k += 4 * THREADS)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst + k))),
                 "l"(src + k)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void fetched() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Shared memory: the tile's rows, two sections' table rows (this one's
// and the next's, in flight), the scan's values, the entry and the ticket.
struct Smem {
  static constexpr int SX = 0;                       // TB x ROW
  static constexpr int TAB = (SX + TB * ROW + 3) / 4 * 4;   // 2 x WIDTH, 16-byte aligned
  static constexpr int BUF = TAB + 2 * WIDTH;        // TB + WARPS V2
  static constexpr int SLOT = BUF + 4 * (TB + WARPS);       // a V2, the ticket
  static constexpr int FLOATS = SLOT + 8;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(BYTES <= 232448, "shared memory");
};

// A section: its coefficients in registers, its powers in shared memory
// as 8 arrays (entry a, b, c, d, each hi then lo), from its table row t in
// shared memory.
struct Section {
  Df m00, m10, c0, c1;
  float b0;
  const float* pw;

  __device__ explicit Section(const float* t)
      : m00{t[0], t[1]}, m10{t[2], t[3]}, c0{t[4], t[5]}, c1{t[6], t[7]}, b0(t[8]),
        pw(t + HEAD) {}

  __device__ __forceinline__ M2 power(int m) const {
    return {{pw[0 * NPOW + m], pw[1 * NPOW + m]}, {pw[2 * NPOW + m], pw[3 * NPOW + m]},
            {pw[4 * NPOW + m], pw[5 * NPOW + m]}, {pw[6 * NPOW + m], pw[7 * NPOW + m]}};
  }

  __device__ __forceinline__ V2 step(V2 v, float x) const {
    Df u0 = prod(c0.hi, x);
    u0 = renorm(u0.hi, u0.lo + c0.lo * x);
    Df u1 = prod(c1.hi, x);
    u1 = renorm(u1.hi, u1.lo + c1.lo * x);
    return {df_add(dmul(m00, v.x), df_add(v.y, u0)), df_add(dmul(m10, v.x), u1)};
  }
};

// Sample k of a tile in the padded rows
__device__ __forceinline__ int at(int k) { return (k / L) * ROW + k % L; }

// Sample k of row `row` of the (rows, n) f32 block at x[row * rs + k * cs]:
// (rs, cs) = (n, 1) for real rows, (1, 2) for the re and im rows of an
// interleaved complex64 row. v_prev and v_last hold f32 (sections, 2,
// rows): the real (sections, 2) state, or the complex64 one as floats.
__global__ void __launch_bounds__(THREADS)
biquad_scan_kernel(const float* __restrict__ tab, const float* __restrict__ x,
                   const float* __restrict__ v_prev, float* __restrict__ y,
                   float* __restrict__ v_last, int sections, int n, int rows, int tiles, int rs,
                   int cs, Chain chain) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sx = smem + Smem::SX;
  float* rows_tab = smem + Smem::TAB;  // section s's table row at rows_tab + (s % 2) WIDTH
  V2* buf = reinterpret_cast<V2*>(smem + Smem::BUF);
  V2* tot = buf + TB;                 // a value of each warp's
  V2* slot = reinterpret_cast<V2*>(smem + Smem::SLOT);
  fetch_row(rows_tab, tab);
  const int id = chain.ticket(reinterpret_cast<int*>(smem + Smem::SLOT + 4));
  const int row = id / tiles;
  const int tile = id % tiles;
  const int j = tile % W;             // the tile's place in its window
  const int window = tile / W;
  const int windows = (tiles + W - 1) / W;
  const int b = threadIdx.x;
  const int lane = b % 32;
  const int warp = b / 32;
  x += static_cast<size_t>(row) * rs;
  y += static_cast<size_t>(row) * rs;
  const int start = tile * TILE;
#pragma unroll
  for (int r = 0; r < L; ++r) {
    const int k = b + r * THREADS;
    sx[at(k)] = start + k < n ? x[static_cast<size_t>(start + k) * cs] : 0.0f;
  }
  float* xr = sx + b * ROW;           // this thread's block
  const int first = start + b * L;    // its first sample's index in the row
  const V2 zero{{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int s = 0; s < sections; ++s) {
    // a link per tile (its aggregate), then one per window (its entry)
    float* links = chain.links + (static_cast<size_t>(s) * rows + row) * (tiles + windows) * LINK;
    fetched();
    __syncthreads();                  // this section's row is in; the one before is done
    if (s + 1 < sections)             // with the other buffer and with slot
      fetch_row(rows_tab + (s + 1) % 2 * WIDTH, tab + static_cast<size_t>(s + 1) * WIDTH);
    const Section sec(rows_tab + s % 2 * WIDTH);
    // 1. this block from a zero entry, keeping v_loc[i].x (and the whole
    // state at the row's last sample)
    float xv[L];
    Df loc[L - 1];
    V2 p = zero, end = zero;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      xv[i] = xr[i];
      p = sec.step(p, xv[i]);
      if (i < L - 1) loc[i] = p.x;
      if (first + i == n - 1) end = p;
    }
    // 2. the scan of the tile's block constants: within the warp's run
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const V2 q = shfl_up(p, d);
      if (lane >= d) p = mv(sec.power(d), q, p);
    }
    if (lane == 31) tot[warp] = p;
    __syncthreads();
    // ... then the runs before this warp's, in order (C = T_0, then C <-
    // A^(32 L) C + T_r), carried over its lane + 1 blocks
    if (warp > 0) {
      V2 c = tot[0];
      for (int r = 1; r < warp; ++r) c = mv(sec.power(32), c, tot[r]);
      p = mv(sec.power(lane + 1), c, p);
    }
    buf[b] = p;
    // the tile's aggregate, for the later tiles of its window
    if (b == TB - 1 && j < W - 1 && tile + 1 < tiles) publish_v(links + tile * LINK, p, chain.epoch);
    __syncthreads();
    // 3. the tile's entry: the fold of its window's aggregates before it
    // (thread k takes tile k's; each warp adds its 32 in a tree, thread 0
    // the warps' sums in order), from the window's entry; the window's
    // last tile hands on the next's
    {
      V2 f = zero;
      if (b < j)
        f = mul(sec.power(TILE_POW + j - 1 - b), await_v(links + (tile - j + b) * LINK, chain.epoch));
#pragma unroll
      for (int d = 16; d > 0; d /= 2) f = add(f, shfl_down(f, d));
      if (lane == 0) tot[warp] = f;
    }
    __syncthreads();
    if (b == 0) {
      V2 f = tot[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) f = add(f, tot[w]);
      V2 e{{v_prev[(2 * s) * rows + row], 0.0f}, {v_prev[(2 * s + 1) * rows + row], 0.0f}};
      if (window > 0) e = await_v(links + (tiles + window) * LINK, chain.epoch);
      e = mv(sec.power(TILE_POW + j), e, f);
      if (j == W - 1 && tile + 1 < tiles)
        publish_v(links + (tiles + window + 1) * LINK, mv(sec.power(TILE_POW + 1), e, buf[TB - 1]),
                  chain.epoch);
      *slot = e;
    }
    __syncthreads();
    // 4. this block's entry, then each sample's state from it: y in place
    // of x (zeros past the end, where the next section reads its padding)
    const V2 e = b == 0 ? *slot : mv(sec.power(b), *slot, buf[b - 1]);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      Df prev = e.x;
      if (i > 0) {
        const M2 m = sec.power(SAMPLE_POW + i);
        prev = df_add(df_add(dmul(m.a, e.x), dmul(m.b, e.y)), loc[i - 1]);
      }
      xr[i] = first + i < n ? sec.b0 * xv[i] + (prev.hi + prev.lo) : 0.0f;
    }
    if (first <= n - 1 && n - 1 < first + L) {
      const V2 v = mv(sec.power(SAMPLE_POW + n - first), e, end);
      v_last[(2 * s) * rows + row] = v.x.hi + v.x.lo;
      v_last[(2 * s + 1) * rows + row] = v.y.hi + v.y.lo;
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int r = 0; r < L; ++r) {
    const int k = b + r * THREADS;
    if (start + k < n) y[static_cast<size_t>(start + k) * cs] = sx[at(k)];
  }
}

}  // namespace

// Plain C entry point for ctypes. tab is kernels/iir.sos_table's (sections,
// WIDTH) f32 table, 16-byte aligned: per section m00 = -a1, m10 = -a2,
// c0, c1 as (hi, lo), b0, padding to HEAD floats, then the powers (A^(L
// m), m = 0..TB-1; A^k, k = 1..L; A^(TILE m), m = 0..W-1) as 8 arrays of
// NPOW (entries a, b, c, d, each hi then lo). x and y are `rows` rows of n
// samples, sample k of row r at [r * rs + k * cs]; v_prev and v_last are
// (sections, 2, rows) f32. scratch is the stream's buffer of cuda/launch.
// chain: 4 int32 (the count of blocks ever started on it), then LINK (8)
// int32 per link: per section and row, one a tile (tiles = n / 2048
// rounded up) and one a window (windows = tiles / 128 rounded up), zero
// when made;
// base is the count when this launch is enqueued and epoch a value no launch
// on it has used yet (not 0). Launches on `stream` and returns a
// cudaError_t (0 on success); does not synchronise.
extern "C" int biquad_scan(const float* tab, const float* x, const float* v_prev, float* y,
                           float* v_last, int* scratch, int sections, int rows, int n, int rs,
                           int cs, int base, int epoch, void* stream) {
  if (sections <= 0 || rows <= 0 || n <= 0) return 0;
  static const cudaError_t set = allow_smem(biquad_scan_kernel, Smem::BYTES);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles = (n + TILE - 1) / TILE;
  biquad_scan_kernel<<<rows * tiles, THREADS, Smem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      tab, x, v_prev, y, v_last, sections, n, rows, tiles, rs, cs,
      make_chain(scratch, base, epoch));
  return static_cast<int>(cudaGetLastError());
}
