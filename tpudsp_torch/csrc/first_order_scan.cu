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
//   first_order_scan: one recurrence over each of C rows, read and written
//     with the strides its caller gives: rows one after the other, or the
//     re and im parts of an interleaved complex64 row as two rows (b0 and
//     a are real, so the parts are independent), in place in the complex
//     layout. The complex64 call's JAX twin, tpudsp/kernels/iir.py:343
//     first_order_apply_blocked_c64, carries its block entries as plain
//     complex64; this kernel carries them in double-float for either;
//   linear_tail_scan: the DC tracker (b0 = 1 - rho, a = rho), audio = (vr -
//     dc * use_dc) * inv_mod, then the de-emphasis, over each of C rows;
//   first_order_scan_cols: one recurrence down each column of a row-major
//     (n, C) matrix, read in place, written as C rows of n (its JAX twin,
//     tpudsp/kernels/iir.py:381 first_order_apply_blocked_mc, runs an (L,
//     L) einsum over column blocks and a lax.scan), at tiles of 32 blocks;
//     see its own note below.
//
// Math, in the plain version's order, so that the two agree bit for bit
// (built with -fmad=false: no multiply and add is contracted):
//   1. the within-block prefix of each L = 32 block, Yin[b, i] = sum over j
//      = 0..31 of x[bL + j] T[i, j], in order, zeros included, multiply
//      then add, from the host table T[i, j] = b0 a^(i-j) (rounded from
//      float64);
//   2. the block entry values in double-float, a tile of TB = 256 blocks
//      at a time: the inclusive scan P of the block sums S[b] = Yin[b, 31]
//      within the tile, log-depth, from P[b] = (S[b], 0): within each run
//      of 32 blocks (a warp's), P[b] <- df_add(df_mul(a^(L d), P[b-d]),
//      P[b]) where b - d is in the run, at d = 1, 2, ..., 16; the same over
//      the 8 runs' last values W at d = 1, 2, 4 (powers a^(32 L d)); then
//      P[b] <- df_add(df_mul(a^(L (l+1)), W[r-1]), P[b]) for block l of run
//      r > 0. Then E[0] = E_t and E[b] = df_add(df_mul(a^(L b), E_t),
//      P[b-1]), and the next tile's entry E_t' = df_add(df_mul(a^(L TB),
//      E_t), P[TB-1]), from E_0 = (y_prev, 0). Every power a^(L m), m =
//      0..TB, is split from float64 by the host;
//   3. y = Yin + a^(i+1) (EH + EL).
// The JAX package carries block after block (its lax.scan body); the tree
// rounds in another order, within 2^-44 relative of it and of float64
// (tests/test_torch_first_order.py).
//
// Layout. One block of TB = 256 threads per tile of TB blocks of L (8192
// samples) of a row, the tile's input and prefix in shared memory as one
// padded row of L + 1 floats per block (conflict-free for a warp whose
// lanes own consecutive blocks, and for one that reads a block's 32
// samples). Thread b owns block b of the tile: its prefix (32 independent
// sums, T read transposed from shared memory as broadcasts), its element
// of the scan (within its warp's run by __shfl_up_sync, the runs' totals by
// warp 0) and its entry value. The tiles of a row run on as many SMs at
// once; all that passes from tile to tile is the entry E_t: thread 0 of a
// tile's block waits for the previous tile's (an acquire load of its flag
// in a scratch buffer), takes the one double-float step
// and publishes the next tile's (a release store) before the block
// finishes its own tile. Blocks take their tiles in the order they start
// (an atomic ticket), so a block only waits for a tile that a running or
// finished block holds. The wrapper keeps the ticket counter and the
// links in one buffer per stream, made zero once; a flag holds the epoch
// of the launch that set it, so nothing is cleared between launches (the
// double-float steps and the chain are csrc/tile_chain.cuh's, shared with
// biquad_scan.cu). Input and output lines are strided by thread (k =
// thread + r TB), so they are coalesced (every other float of a line for
// a complex64 row). In linear_tail_scan the second
// recurrence runs on the audio of the same tile, which the first one has
// just made, with a chain of entries of its own: neither recurrence's
// output goes to device memory before the pcm.
//
// Bound. At the AM receiver's shape (one row, n = 96000, B = 3000 blocks,
// 12 tiles) the tail moves 8 bytes a sample (vr in, pcm out: 0.77 MB, 0.23
// us at 3.35 TB/s) and does 2 x 64 operations a sample (12.3 MFLOP, 0.18 us
// at 67 TFLOP/s). A tile's prefix is 1 M single f32 instructions on its
// SM (~5 us for the two recurrences), and the chains of entries are 12
// steps each, one flag's round trip through L2 apiece. The column entry at
// BASELINE config 4's de-emphasis ((16384, 1024) f32) moves 134 MB (0.040
// ms at 3.35 TB/s) and does 64 operations a sample (1.07 GFLOP, 0.016 ms
// at 67 TFLOP/s); it issues 33 single f32 instructions a sample for the
// prefix (the products of T's zeros skipped where they change nothing).
// With a block for each 8 channels it takes 128 of the card's 132 SMs.

#include "tile_chain.cuh"

namespace {

using namespace tile_chain;

constexpr int L = 32;                 // samples per block
constexpr int TB = 256;               // blocks per tile, one per thread
constexpr int THREADS = TB;
constexpr int TILE = TB * L;          // samples per tile
constexpr int PER_THREAD = TILE / THREADS;
constexpr int ROW = L + 1;            // a block's padded row in shared memory
constexpr int LEVELS = 8;             // log2(TB)
constexpr int WARPS = THREADS / 32;
constexpr int POW = L * L + L;        // offset of the block powers in a table
static_assert(1 << LEVELS == TB && THREADS % L == 0 && WARPS <= 32, "tile geometry");

// Shared memory of a launch with R recurrences: T transposed per
// recurrence, the tile's input and prefix rows, the entry values and two
// buffers of the scan.
template <int R>
struct Smem {
  static constexpr int TT = 0;                       // R x (L x L) floats
  static constexpr int SX = TT + R * L * L;          // TB x ROW
  static constexpr int SY = SX + TB * ROW;           // TB x ROW
  static constexpr int SE = SY + TB * ROW;           // TB
  static constexpr int BUF = SE + TB;                // TB + 2 WARPS Df
  static constexpr int SLOT = BUF + 2 * (TB + 2 * WARPS);   // an entry, a ticket
  static constexpr int FLOATS = SLOT + 4;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(BUF % 2 == 0 && BYTES <= 232448, "shared memory");
};

// One recurrence's constants: in shared memory, T transposed (tt[j L + i]
// = T[i, j]); in this thread's registers, a^(i+1) for its output lane i,
// the scan's level powers a^(L 2^k), a^(L (lane + 1)), a^(L b) for its
// block b and a^(L TB).
struct Recurrence {
  const float* tt;
  float power;
  Df level[LEVELS];
  Df mlane, mb, mtb;

  __device__ Recurrence(const float* __restrict__ tab, float* tt_smem) : tt(tt_smem) {
    for (int k = threadIdx.x; k < L * L; k += THREADS) tt_smem[(k % L) * L + k / L] = tab[k];
    power = tab[L * L + threadIdx.x % L];
#pragma unroll
    for (int k = 0; k < LEVELS; ++k)
      level[k] = {tab[POW + 2 * (1 << k)], tab[POW + 2 * (1 << k) + 1]};
    mlane = {tab[POW + 2 * (threadIdx.x % 32 + 1)], tab[POW + 2 * (threadIdx.x % 32 + 1) + 1]};
    mb = {tab[POW + 2 * threadIdx.x], tab[POW + 2 * threadIdx.x + 1]};
    mtb = {tab[POW + 2 * TB], tab[POW + 2 * TB + 1]};
  }

  // Yin of this thread's block b = threadIdx.x, from row b of sx into
  // row b of sy
  __device__ __forceinline__ void prefix(const float* sx, float* sy) const {
    float acc[L];
#pragma unroll
    for (int i = 0; i < L; ++i) acc[i] = 0.0f;
    const float* xr = sx + threadIdx.x * ROW;
#pragma unroll 1
    for (int j = 0; j < L; ++j) {
      const float v = xr[j];
      const float4* t4 = reinterpret_cast<const float4*>(tt + j * L);
#pragma unroll
      for (int q = 0; q < L / 4; ++q) {
        const float4 t = t4[q];
        acc[4 * q] = acc[4 * q] + v * t.x;
        acc[4 * q + 1] = acc[4 * q + 1] + v * t.y;
        acc[4 * q + 2] = acc[4 * q + 2] + v * t.z;
        acc[4 * q + 3] = acc[4 * q + 3] + v * t.w;
      }
    }
    float* yr = sy + threadIdx.x * ROW;
#pragma unroll
    for (int i = 0; i < L; ++i) yr[i] = acc[i];
  }

  // The scan of the tile's block sums in sy, inclusive, into s = buf[0,
  // TB). Ends with __syncthreads.
  __device__ __forceinline__ void scan(const float* sy, Df* buf) const {
    const int b = threadIdx.x;
    const int lane = b % 32;
    const int warp = b / 32;
    Df* tot = buf + TB;          // WARPS: each warp's run, then their scan
    Df p{sy[b * ROW + L - 1], 0.0f};
    // 1. within the warp's run of 32 blocks
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int d = 1 << k;
      const Df q{__shfl_up_sync(0xffffffffu, p.hi, d), __shfl_up_sync(0xffffffffu, p.lo, d)};
      if (lane >= d) p = df_add(df_mul(level[k], q), p);
    }
    if (lane == 31) tot[warp] = p;
    __syncthreads();
    // 2. the runs' totals across the tile, by warp 0
    if (warp == 0) {
      Df t = lane < WARPS ? tot[lane] : Df{0.0f, 0.0f};
#pragma unroll
      for (int k = 5; k < LEVELS; ++k) {
        const int d = 1 << (k - 5);
        const Df q{__shfl_up_sync(0xffffffffu, t.hi, d), __shfl_up_sync(0xffffffffu, t.lo, d)};
        if (lane >= d) t = df_add(df_mul(level[k], q), t);
      }
      if (lane < WARPS) tot[WARPS + lane] = t;
    }
    __syncthreads();
    // 3. the runs before this warp's, carried over its lane + 1 blocks
    if (warp > 0) p = df_add(df_mul(mlane, tot[WARPS + warp - 1]), p);
    buf[b] = p;
    __syncthreads();
  }

  // The tile's entry E_t, each block's entry EH + EL into se. Thread 0
  // takes E_t (e0 on a row's first tile, else the previous tile's link),
  // publishes the next tile's, a^(L TB) E_t + P[TB-1], to `next` (unless
  // null), and shares E_t through `slot`. Ends with __syncthreads.
  __device__ __forceinline__ void enter(const Df* s, float* se, Df* slot, Df e0,
                                        const float* prev, float* next, int epoch) const {
    const int b = threadIdx.x;
    if (b == 0) {
      Df e = e0;
      if (prev != nullptr) {
        float v[2];
        await(prev, v, epoch);
        e = {v[0], v[1]};
      }
      if (next != nullptr) {
        const Df t = df_add(df_mul(mtb, e), s[TB - 1]);
        const float v[2] = {t.hi, t.lo};
        publish(next, v, epoch);
      }
      *slot = e;
    }
    __syncthreads();
    const Df e = *slot;
    const Df eb = b == 0 ? e : df_add(df_mul(mb, e), s[b - 1]);
    se[b] = eb.hi + eb.lo;
    __syncthreads();
  }
};

// Sample k of a tile in the padded rows
__device__ __forceinline__ int at(int k) { return (k / L) * ROW + k % L; }

// The tile of a row of n that starts at `start` into the padded rows of
// sx, zeros past the end; sample k of the row at x[k * cs]
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int n, int start,
                                          float* sx, int cs = 1) {
#pragma unroll 8
  for (int r = 0; r < PER_THREAD; ++r) {
    const int k = threadIdx.x + r * THREADS;
    sx[at(k)] = start + k < n ? x[static_cast<size_t>(start + k) * cs] : 0.0f;
  }
}

// The links of recurrence `rec` of a launch over `rows` rows of `tiles`
// tiles: the one before this tile's (null on a row's first tile) and this
// tile's own (null on its last)
struct Links {
  const float* prev;
  float* next;
  __device__ Links(const Chain& chain, int rec, int rows, int row, int tiles, int tile) {
    float* l = chain.links + (static_cast<size_t>(rec) * rows + row) * tiles * LINK;
    prev = tile > 0 ? l + (tile - 1) * LINK : nullptr;
    next = tile + 1 < tiles ? l + tile * LINK : nullptr;
  }
};

// Sample k of row `row` of a (rows, n) f32 block at x[row * rs + k * cs]:
// (rs, cs) = (n, 1) for rows one after the other, (1, 2) for the re and
// im rows of an interleaved complex64 row.
__global__ void __launch_bounds__(THREADS)
first_order_scan_kernel(const float* __restrict__ tab, const float* __restrict__ x,
                        const float* __restrict__ y_prev, float* __restrict__ y,
                        float* __restrict__ y_last, int n, int rows, int tiles, int rs, int cs,
                        Chain chain) {
  using S = Smem<1>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sx = smem + S::SX;
  float* sy = smem + S::SY;
  float* se = smem + S::SE;
  Df* buf = reinterpret_cast<Df*>(smem + S::BUF);
  Df* slot = reinterpret_cast<Df*>(smem + S::SLOT);
  const Recurrence rec(tab, smem + S::TT);
  const int id = chain.ticket(reinterpret_cast<int*>(smem + S::SLOT + 2));
  const int row = id / tiles;
  const int tile = id % tiles;
  const Links links(chain, 0, rows, row, tiles, tile);
  x += static_cast<size_t>(row) * rs;
  y += static_cast<size_t>(row) * rs;
  const int start = tile * TILE;
  load_tile(x, n, start, sx, cs);
  __syncthreads();
  rec.prefix(sx, sy);
  __syncthreads();
  rec.scan(sy, buf);
  rec.enter(buf, se, slot, Df{y_prev[row], 0.0f}, links.prev, links.next, chain.epoch);
#pragma unroll 8
  for (int r = 0; r < PER_THREAD; ++r) {
    const int k = threadIdx.x + r * THREADS;
    const float out = sy[at(k)] + rec.power * se[k / L];
    if (start + k < n) y[static_cast<size_t>(start + k) * cs] = out;
    if (start + k == n - 1) y_last[row] = out;
  }
}

__global__ void __launch_bounds__(THREADS)
linear_tail_kernel(const float* __restrict__ tab_dc, const float* __restrict__ tab_de,
                   const float* __restrict__ scal, const float* __restrict__ vr,
                   const float* __restrict__ dc0, const float* __restrict__ de0,
                   float* __restrict__ pcm, float* __restrict__ dc_last,
                   float* __restrict__ de_last, int n, int rows, int tiles, Chain chain) {
  using S = Smem<2>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sx = smem + S::SX;
  float* sy = smem + S::SY;
  float* se = smem + S::SE;
  Df* buf = reinterpret_cast<Df*>(smem + S::BUF);
  Df* slot = reinterpret_cast<Df*>(smem + S::SLOT);
  const Recurrence dc(tab_dc, smem + S::TT);
  const Recurrence de(tab_de, smem + S::TT + L * L);
  const float use_dc = scal[0];
  const float inv_mod = scal[1];
  const int id = chain.ticket(reinterpret_cast<int*>(smem + S::SLOT + 2));
  const int row = id / tiles;
  const int tile = id % tiles;
  const Links links_dc(chain, 0, rows, row, tiles, tile);
  const Links links_de(chain, 1, rows, row, tiles, tile);
  vr += static_cast<size_t>(row) * n;
  pcm += static_cast<size_t>(row) * n;
  const int start = tile * TILE;
  load_tile(vr, n, start, sx);
  __syncthreads();
  // the DC tracker
  dc.prefix(sx, sy);
  __syncthreads();
  dc.scan(sy, buf);
  dc.enter(buf, se, slot, Df{dc0[row], 0.0f}, links_dc.prev, links_dc.next, chain.epoch);
  // audio over this thread's samples, in place of vr; zeros past the end,
  // where the de-emphasis reads its padding
#pragma unroll 8
  for (int r = 0; r < PER_THREAD; ++r) {
    const int k = threadIdx.x + r * THREADS;
    const float track = sy[at(k)] + dc.power * se[k / L];
    if (start + k == n - 1) dc_last[row] = track;
    sx[at(k)] = start + k < n ? (sx[at(k)] - track * use_dc) * inv_mod : 0.0f;
  }
  __syncthreads();
  // the de-emphasis
  de.prefix(sx, sy);
  __syncthreads();
  de.scan(sy, buf);
  de.enter(buf, se, slot, Df{de0[row], 0.0f}, links_de.prev, links_de.next, chain.epoch);
#pragma unroll 8
  for (int r = 0; r < PER_THREAD; ++r) {
    const int k = threadIdx.x + r * THREADS;
    const float out = sy[at(k)] + de.power * se[k / L];
    if (start + k < n) pcm[start + k] = out;
    if (start + k == n - 1) de_last[row] = out;
  }
}

// The column entry: one recurrence down each column of a row-major (n, C)
// f32 matrix, read in place, written as C rows of n. A block of threads
// takes CG = 8 adjacent channels and walks their tiles of CTB = 32 blocks
// (1024 samples, one warp's run of the scan) in order, each channel's
// tile entry carried from tile to tile in registers: no block waits for
// another. STAGES = 2 tiles are in shared memory at once: while the block
// computes one, the next one's columns are copied in by cp.async (a warp
// copies the 32 bytes of each of 4 time rows; the channel stride is 32 /
// CG floats past a multiple of 32 banks, so the copies do not conflict).
// Warp w owns channel w: lane b takes block b's prefix in place over its
// input, the warp scans the 32 block sums by shuffles, takes the tile's
// entry, hands the next tile's on, and writes the channel's row of the
// tile, coalesced. Per channel it is the rows entry's arithmetic at a tile
// of CTB blocks (kernels/iir.first_order_apply_blocked with tb =
// COLS_TILE_BLOCKS).
constexpr int CG = 8;                       // channels a block, a warp each
constexpr int CTB = 32;                     // blocks of L in a tile of the column entry
constexpr int CTILE = CTB * L;              // samples of a channel in a tile
constexpr int CTHREADS = 32 * CG;
constexpr int STAGES = 2;                   // tiles in shared memory at once
constexpr int CSTRIDE = CTB * ROW + 32 / CG;   // a channel's padded rows
static_assert(CTB == 32 && CG * CTILE % CTHREADS == 0 && (CTB * ROW) % 32 == 0,
              "column tile geometry");
constexpr size_t COL_SMEM = STAGES * CG * CSTRIDE * sizeof(float);
static_assert(COL_SMEM <= 232448, "shared memory");

// One float from global into shared memory by cp.async, or a zero where
// `in` is false; the copies of a stage are one group
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies of all but the latest N groups have landed
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Recurrence::prefix for the column entry, from registers: T is
// lower-triangular Toeplitz (T[i, j] = c[i - j] = b0 a^(i-j) for j <= i, 0
// above the diagonal: kernels/iir.block_table), so for output i the
// products are xr[j] c[i - j] for j <= i, then the products xr[j] 0 for j
// > i. Those add +-0 to a sum that started at +0 and so is never -0, which
// leaves it as it is unless some xr[j] is infinite or NaN: they are added,
// in order, only in a block that holds such a sample. The same operations
// on the same values, in the same order, as Recurrence::prefix, wherever
// they change a bit.
__device__ __forceinline__ void toeplitz_prefix(const float (&c)[L], const float* xr,
                                                float* yr) {
  float acc[L];
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = 0.0f;
  bool finite = true;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float v = xr[j];
    finite = finite && fabsf(v) <= 3.402823466e38f;
#pragma unroll
    for (int i = j; i < L; ++i) acc[i] = acc[i] + v * c[i - j];
  }
  if (!finite) {   // for each i, the products of j = i+1..L-1 in order
#pragma unroll
    for (int j = 1; j < L; ++j) {
      const float zero = xr[j] * 0.0f;
#pragma unroll
      for (int i = 0; i < j; ++i) acc[i] = acc[i] + zero;
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) yr[i] = acc[i];
}

// The CG columns of tile `tile` from channel c0 on into sx (CG x CSTRIDE),
// zeros past the ends, as one group of copies (an empty one past the last
// tile)
__device__ __forceinline__ void stage(const float* __restrict__ x, float* sx, int tile,
                                      int tiles, int n, int C, int c0) {
  if (tile < tiles) {
    const int start = tile * CTILE;
#pragma unroll 8
    for (int q = 0; q < CG * CTILE / CTHREADS; ++q) {
      const int k = threadIdx.x + q * CTHREADS;
      const int g = k % CG, r = k / CG;
      const bool in = start + r < n && c0 + g < C;
      copy4(sx + g * CSTRIDE + at(r), in ? x + static_cast<size_t>(start + r) * C + c0 + g : x,
            in);
    }
  }
  copies_commit();
}

// x: (n, C) row-major; y: C rows of n; y_prev, y_last: (C,). Block k takes
// channels k CG .. k CG + CG - 1.
__global__ void __launch_bounds__(CTHREADS)
first_order_cols_kernel(const float* __restrict__ tab, const float* __restrict__ x,
                        const float* __restrict__ y_prev, float* __restrict__ y,
                        float* __restrict__ y_last, int n, int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * CG;
  const int ch = c0 + threadIdx.x / 32;   // this warp's channel; lane: its block
  const int tiles = (n + CTILE - 1) / CTILE;
  for (int s = 0; s < STAGES - 1; ++s) stage(x, smem + s * CG * CSTRIDE, s, tiles, n, C, c0);
  float c[L];   // T's first column
#pragma unroll
  for (int d = 0; d < L; ++d) c[d] = tab[d * L];
  Df level[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) level[k] = {tab[POW + 2 * (1 << k)], tab[POW + 2 * (1 << k) + 1]};
  const Df mb{tab[POW + 2 * lane], tab[POW + 2 * lane + 1]};
  const Df mtb{tab[POW + 2 * CTB], tab[POW + 2 * CTB + 1]};
  const float power = tab[L * L + lane];
  Df e{ch < C ? y_prev[ch] : 0.0f, 0.0f};   // the tile's entry E_t
  for (int tile = 0; tile < tiles; ++tile) {
    // the tile STAGES - 1 on into the stage the tile before used
    stage(x, smem + (tile + STAGES - 1) % STAGES * CG * CSTRIDE, tile + STAGES - 1, tiles, n, C,
          c0);
    copies_wait<STAGES - 1>();
    __syncthreads();
    const int start = tile * CTILE;
    float* rows = smem + tile % STAGES * CG * CSTRIDE + (threadIdx.x / 32) * CSTRIDE;
    toeplitz_prefix(c, rows + lane * ROW, rows + lane * ROW);
    // the inclusive scan of the 32 block sums, in double-float:
    // P[b] <- a^(L d) P[b-d] + P[b] for b >= d, d = 1, ..., 16
    Df p{rows[lane * ROW + L - 1], 0.0f};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int d = 1 << k;
      const Df q{__shfl_up_sync(0xffffffffu, p.hi, d), __shfl_up_sync(0xffffffffu, p.lo, d)};
      if (lane >= d) p = df_add(df_mul(level[k], q), p);
    }
    // block b's entry EH + EL, from P[b-1]; the next tile's, a^(L CTB) E_t
    // + P[CTB-1]
    const Df pb{__shfl_up_sync(0xffffffffu, p.hi, 1), __shfl_up_sync(0xffffffffu, p.lo, 1)};
    const Df eb = lane == 0 ? e : df_add(df_mul(mb, e), pb);
    rows[lane * ROW + L] = eb.hi + eb.lo;
    e = df_add(df_mul(mtb, e),
               Df{__shfl_sync(0xffffffffu, p.hi, 31), __shfl_sync(0xffffffffu, p.lo, 31)});
    __syncwarp();
    // y = Yin + a^(i+1) (EH + EL) over the channel's row of the tile
    if (ch < C) {
      float* yr = y + static_cast<size_t>(ch) * n;
#pragma unroll 8
      for (int b = 0; b < CTB; ++b) {
        const int k = b * L + lane;
        const float out = rows[at(k)] + power * rows[b * ROW + L];
        if (start + k < n) yr[start + k] = out;
        if (start + k == n - 1) y_last[ch] = out;
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  copies_wait<0>();
}

}  // namespace

// Plain C entry points for ctypes. tab / tab_dc / tab_de are the host
// tables of kernels/iir.block_table (L * L + L + 2 (TB + 1) f32 values: T
// row-major, a^(i+1), a^(L m) for m = 0..TB as (hi, lo)); vr / pcm are
// (rows, n) row-major f32; x / y are `rows` rows of n f32 samples, sample k
// of row r at [r * rs + k * cs]: (rs, cs) = (n, 1) for rows one after the
// other, (1, 2) for the re and im rows of one interleaved complex64 row;
// y_prev, y_last, dc0, de0, dc_last, de_last are (rows,) (a complex64
// scalar is the re and im rows' pair); scal = [use_dc, inv_mod]. scratch
// is the stream's buffer of cuda/launch.chain: 4 int32 (the count of
// blocks ever started on it), then a link of LINK (8) per recurrence, row
// and tile (tiles = n / 8192 rounded up), zero when made; base is the
// count when this launch is enqueued and epoch a value no launch on it has
// used yet (not 0). Each launches on `stream` and returns a cudaError_t (0
// on success); none synchronises.
extern "C" int first_order_scan(const float* tab, const float* x, const float* y_prev,
                                float* y, float* y_last, int* scratch, int rows, int n, int rs,
                                int cs, int base, int epoch, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  static bool smem_set[MAX_DEVICES];
  const cudaError_t set = allow_smem(first_order_scan_kernel, Smem<1>::BYTES, smem_set);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles = (n + TILE - 1) / TILE;
  first_order_scan_kernel<<<rows * tiles, THREADS, Smem<1>::BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      tab, x, y_prev, y, y_last, n, rows, tiles, rs, cs, make_chain(scratch, base, epoch));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_tail_scan(const float* tab_dc, const float* tab_de, const float* scal,
                                const float* vr, const float* dc0, const float* de0,
                                float* pcm, float* dc_last, float* de_last, int* scratch,
                                int rows, int n, int base, int epoch, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  static bool smem_set[MAX_DEVICES];
  const cudaError_t set = allow_smem(linear_tail_kernel, Smem<2>::BYTES, smem_set);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles = (n + TILE - 1) / TILE;
  linear_tail_kernel<<<rows * tiles, THREADS, Smem<2>::BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      tab_dc, tab_de, scal, vr, dc0, de0, pcm, dc_last, de_last, n, rows, tiles,
      make_chain(scratch, base, epoch));
  return static_cast<int>(cudaGetLastError());
}

// x: (n, C) f32 row-major, read in place; y: C rows of n (the transpose of
// the (n, C) result); y_prev, y_last: (C,). A block for each 8 channels.
extern "C" int first_order_scan_cols(const float* tab, const float* x, const float* y_prev,
                                     float* y, float* y_last, int C, int n, void* stream) {
  if (C <= 0 || n <= 0) return 0;
  static bool smem_set[MAX_DEVICES];
  const cudaError_t set = allow_smem(first_order_cols_kernel, COL_SMEM, smem_set);
  if (set != cudaSuccess) return static_cast<int>(set);
  first_order_cols_kernel<<<(C + CG - 1) / CG, CTHREADS, COL_SMEM,
                            static_cast<cudaStream_t>(stream)>>>(tab, x, y_prev, y, y_last, n,
                                                                 C);
  return static_cast<int>(cudaGetLastError());
}
