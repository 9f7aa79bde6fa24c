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
// poles by enough to change the filter). One step, in the plain
// version's order (built with -fmad=false, so the two agree bit for bit):
//   u_k = renorm(two_prod(c_k.hi, x) + c_k.lo x), k = 0, 1;
//   v0' = df_add(df_add(df_mul(-a1, v0), v1), u0); v1' = df_add(df_mul(-a2,
//   v0), u1).
// The output is f32, y = b0 x + (v0.hi + v0.lo) of the previous sample,
// and the state carried from call to call is f32 (hi + lo), as in the JAX
// package. A tile of TB = 256 blocks of L = 32 samples at a time:
//   1. each block from a zero entry, 32 steps: S[b], the constant of the
//      block's affine map v -> A^L v + S[b];
//   2. the inclusive scan P of the S[b] within the tile, log-depth: within
//      each run of 32 blocks, P[b] <- A^(L d) P[b-d] + P[b] at d = 1, 2,
//      ..., 16; the same over the 8 runs' last values W at d = 1, 2, 4;
//      then P[b] <- A^(L (l+1)) W[r-1] + P[b] for block l of run r > 0
//      (each a double-float 2x2 matrix times a vector, plus a vector);
//   3. the entries: E[0] = E_t, E[b] = A^(L b) E_t + P[b-1], the next
//      tile's E_t' = A^(L TB) E_t + P[TB-1], from E_0 = (v_prev, 0);
//   4. each block again from its entry, 32 steps, writing y.
// The powers A^(L m), m = 0..TB, are float64 matrix powers split by the
// host (kernels/iir.sos_table). Near-unit poles (radius ~0.9983 at
// BroadcastAM's 20 Hz highpass) are why the steps stay double-float.
//
// Layout. One launch runs every section over every row: a complex64 row
// is two rows, its re and im parts (the coefficients are real), read and
// written in the interleaved layout. One block of TB threads per tile of a
// row, thread b owning block b (its 32 samples in a padded shared row,
// overwritten by y); the tiles of a row run on as many SMs at once, and
// only E_t passes from tile to tile, through csrc/tile_chain.cuh's links
// (one chain per section and row). A tile runs its sections one after the
// other on its shared rows; section s + 1 of a tile waits only for
// section s + 1 of the tile before, so the sections of the tiles run as a
// wavefront.
//
// Bound. A step as written here is 125 f32 operations (two_prod 17,
// renorm 3, df_mul 24, df_add 11: two input terms of 22, then 46 and 35
// for the two state components). The function needs one step per sample,
// row and section, 101 operations once the Dekker splits of the constant
// coefficients (c0.hi, c1.hi, -a1, -a2: 4 each) come from the host and x
// and v0.hi are split once each (4 each), and y (3): 104 operations,
// against 8 bytes a sample of a row (x in, y out) for the whole cascade.
// At CLowpassIIR(order=8) on 2^18 complex64 samples (4 sections, 2 rows)
// that is 0.218 GFLOP (3.26 us at 67 TFLOP/s) against 4.2 MB (1.25 us at
// 3.35 TB/s): operations bound it. This kernel runs each block twice
// (passes 1 and 4) and each thread's 2 x 32 steps are a dependent chain,
// so it runs at the latency of that chain and of the tile-to-tile links,
// far above the bound.

#include "tile_chain.cuh"

namespace {

using namespace tile_chain;

constexpr int L = 32;                 // samples per block
constexpr int TB = 256;               // blocks per tile, one per thread
constexpr int THREADS = TB;
constexpr int TILE = TB * L;          // samples per tile
constexpr int PER_THREAD = TILE / THREADS;
constexpr int ROW = L + 1;            // a block's padded row in shared memory
constexpr int WARPS = THREADS / 32;
constexpr int HEAD = 16;              // a section's coefficients in its table row
constexpr int NPOW = TB + 1;          // the block powers A^(L m), m = 0..TB
constexpr int WIDTH = HEAD + 8 * NPOW;   // floats of a section's table row
static_assert(THREADS % L == 0 && WARPS == 8 && TB == 256, "tile geometry");

struct V2 {
  Df x, y;
};

// A 2x2 double-float matrix [[a, b], [c, d]]
struct M2 {
  Df a, b, c, d;
};

// m p + q
__device__ __forceinline__ V2 mv(const M2& m, V2 p, V2 q) {
  return {df_add(df_add(df_mul(m.a, p.x), df_mul(m.b, p.y)), q.x),
          df_add(df_add(df_mul(m.c, p.x), df_mul(m.d, p.y)), q.y)};
}

__device__ __forceinline__ V2 shfl_up(V2 p, int d) {
  constexpr unsigned all = 0xffffffffu;
  return {{__shfl_up_sync(all, p.x.hi, d), __shfl_up_sync(all, p.x.lo, d)},
          {__shfl_up_sync(all, p.y.hi, d), __shfl_up_sync(all, p.y.lo, d)}};
}

// Shared memory: the tile's rows, the section's block powers, two buffers
// of the scan, the entry and the ticket.
struct Smem {
  static constexpr int SX = 0;                       // TB x ROW
  static constexpr int POWS = SX + TB * ROW;         // 8 x NPOW
  static constexpr int BUF = POWS + 8 * NPOW;        // TB + 2 WARPS V2
  static constexpr int SLOT = BUF + 4 * (TB + 2 * WARPS);   // a V2, the ticket
  static constexpr int FLOATS = SLOT + 8;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(BYTES <= 232448, "shared memory");
};

// A section: its coefficients in registers, its block powers in shared
// memory as 8 arrays (entry a, b, c, d of A^(L m), each hi then lo).
struct Section {
  Df m00, m10, c0, c1;
  float b0;
  const float* pw;

  __device__ Section(const float* __restrict__ t, const float* pw_smem)
      : m00{t[0], t[1]}, m10{t[2], t[3]}, c0{t[4], t[5]}, c1{t[6], t[7]}, b0(t[8]),
        pw(pw_smem) {}

  __device__ __forceinline__ M2 power(int m) const {
    return {{pw[0 * NPOW + m], pw[1 * NPOW + m]}, {pw[2 * NPOW + m], pw[3 * NPOW + m]},
            {pw[4 * NPOW + m], pw[5 * NPOW + m]}, {pw[6 * NPOW + m], pw[7 * NPOW + m]}};
  }

  __device__ __forceinline__ V2 step(V2 v, float x) const {
    Df u0 = two_prod(c0.hi, x);
    u0 = renorm(u0.hi, u0.lo + c0.lo * x);
    Df u1 = two_prod(c1.hi, x);
    u1 = renorm(u1.hi, u1.lo + c1.lo * x);
    return {df_add(df_add(df_mul(m00, v.x), v.y), u0), df_add(df_mul(m10, v.x), u1)};
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
  float* pw = smem + Smem::POWS;
  V2* buf = reinterpret_cast<V2*>(smem + Smem::BUF);
  V2* tot = buf + TB;                 // each warp's run, then their scan
  V2* slot = reinterpret_cast<V2*>(smem + Smem::SLOT);
  const int id = chain.ticket(reinterpret_cast<int*>(smem + Smem::SLOT + 4));
  const int row = id / tiles;
  const int tile = id % tiles;
  const int b = threadIdx.x;
  const int lane = b % 32;
  const int warp = b / 32;
  x += static_cast<size_t>(row) * rs;
  y += static_cast<size_t>(row) * rs;
  const int start = tile * TILE;
#pragma unroll 8
  for (int r = 0; r < PER_THREAD; ++r) {
    const int k = b + r * THREADS;
    sx[at(k)] = start + k < n ? x[static_cast<size_t>(start + k) * cs] : 0.0f;
  }
  float* xr = sx + b * ROW;           // this thread's block
  const int first = start + b * L;    // its first sample's index in the row
  const V2 zero{{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int s = 0; s < sections; ++s) {
    const float* t = tab + static_cast<size_t>(s) * WIDTH;
    __syncthreads();                  // the section before is done with pw and slot
    for (int k = b; k < 8 * NPOW; k += THREADS) pw[k] = t[HEAD + k];
    const Section sec(t, pw);
    __syncthreads();
    // 1. this block from a zero entry
    V2 p = zero;
#pragma unroll 4
    for (int i = 0; i < L; ++i) p = sec.step(p, xr[i]);
    // 2. the scan of the tile's block constants: within the warp's run
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int d = 1 << k;
      const V2 q = shfl_up(p, d);
      if (lane >= d) p = mv(sec.power(d), q, p);
    }
    if (lane == 31) tot[warp] = p;
    __syncthreads();
    // ... the runs' totals across the tile, by warp 0
    if (warp == 0) {
      V2 w = lane < WARPS ? tot[lane] : zero;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int d = 1 << k;
        const V2 q = shfl_up(w, d);
        if (lane >= d) w = mv(sec.power(32 * d), q, w);
      }
      if (lane < WARPS) tot[WARPS + lane] = w;
    }
    __syncthreads();
    // ... and the runs before this warp's, carried over its lane + 1 blocks
    if (warp > 0) p = mv(sec.power(lane + 1), tot[WARPS + warp - 1], p);
    buf[b] = p;
    __syncthreads();
    // 3. the tile's entry, from the tile before (or v_prev), and the next
    // tile's, published; then this block's entry
    if (b == 0) {
      float* links = chain.links + (static_cast<size_t>(s) * rows + row) * tiles * LINK;
      V2 e{{v_prev[(2 * s) * rows + row], 0.0f}, {v_prev[(2 * s + 1) * rows + row], 0.0f}};
      if (tile > 0) {
        float v[4];
        await(links + (tile - 1) * LINK, v, chain.epoch);
        e = {{v[0], v[1]}, {v[2], v[3]}};
      }
      if (tile + 1 < tiles) {
        const V2 nx = mv(sec.power(TB), e, buf[TB - 1]);
        const float v[4] = {nx.x.hi, nx.x.lo, nx.y.hi, nx.y.lo};
        publish(links + tile * LINK, v, chain.epoch);
      }
      *slot = e;
    }
    __syncthreads();
    V2 v = b == 0 ? *slot : mv(sec.power(b), *slot, buf[b - 1]);
    // 4. this block again from its entry, y in place of x (zeros past the
    // end, where the next section reads its padding)
#pragma unroll 4
    for (int i = 0; i < L; ++i) {
      const float xi = xr[i];
      const float prev = v.x.hi + v.x.lo;
      v = sec.step(v, xi);
      const int g = first + i;
      xr[i] = g < n ? sec.b0 * xi + prev : 0.0f;
      if (g == n - 1) {
        v_last[(2 * s) * rows + row] = v.x.hi + v.x.lo;
        v_last[(2 * s + 1) * rows + row] = v.y.hi + v.y.lo;
      }
    }
  }
  __syncthreads();
#pragma unroll 8
  for (int r = 0; r < PER_THREAD; ++r) {
    const int k = b + r * THREADS;
    if (start + k < n) y[static_cast<size_t>(start + k) * cs] = sx[at(k)];
  }
}

}  // namespace

// Plain C entry point for ctypes. tab is kernels/iir.sos_table's (sections,
// WIDTH) f32 table: per section m00 = -a1, m10 = -a2, c0, c1 as (hi, lo),
// b0, padding to HEAD floats, then the block powers A^(L m), m = 0..TB,
// as 8 arrays of TB + 1 (entries a, b, c, d, each hi then lo). x and y are
// `rows` rows of n samples, sample k of row r at [r * rs + k * cs]; v_prev
// and v_last are (sections, 2, rows) f32. scratch is the stream's buffer of
// cuda/launch.chain: 4 int32 (the count of blocks ever started on it), then
// a link of LINK (8) per section, row and tile (tiles = n / 8192 rounded
// up), zero when made;
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
