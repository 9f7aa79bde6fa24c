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
// Layout. One block per tile of B consecutive outputs and all C channels.
// The block stages the taps once, per phase p as [p][q][c] (k = q D1 + p;
// a row of Kc C taps and one pad), and the tile's input span in polyphase
// form: row p holds X[(j0 + m) D1 + p] for m < M = B + Kc rounded up to R,
// with one pad sample after every R (a thread's R samples sit 9 apart from
// the next thread's: a half-warp's 8-byte loads hit distinct banks). c64
// samples are copied with cp.async; int16 / uint8 ones are converted and
// centred on load. Each thread computes R = 8 consecutive outputs for CG
// channels (R x CG x 2 independent f32 sums, fused multiply-adds with
// __fmaf_rn) over a group of phases: for each phase p and each q it reads
// one tap per channel (the lanes of a half-warp share p: a broadcast)
// and keeps a sliding window of 2R samples of row p in registers, so each
// sample and each tap loaded serves R outputs. Threads are (output group g,
// channel group, phase group h), g fastest. Where the B / R output groups
// and the channel groups give fewer than 64 threads (the AM shape's many
// phases: D1 = 125), the phases are split over H groups, up to 512 threads
// with real taps (256 with complex ones). Every thread's sums go to shared
// memory once the span is done with, and are added there, h in order, and
// stored with consecutive threads on consecutive outputs.
// B is the largest power of two up to 256 whose taps and span fit in one
// block's 227 KB; CG the largest of 4, 3, 2, 1 that divides C. At the AM
// shape (C = 3, D1 = 125, Kc = 24, real taps): B = 128 (a 171 KB span, 36
// KB of taps), CG = 3, H = 32 groups of 4 phases, 512 threads. At the bank
// shape (C = 16, D1 = 10, Kc = 13, complex taps): B = 256 (32 KB for the
// span or the sums, 17 KB of taps), CG = 4, H = 1, 128 threads. The
// summation order is the kernel's own: the plain version is a matmul, held
// to 110 dB, not to its bits.
//
// Bound. 4 f32 operations per tap, channel and output with real taps, 8
// with complex ones: 1.15 GFLOP at the AM shape (real taps, Kc = 24,
// nj = 32000 per 4M-sample shard: 17 us at 67 TFLOP/s) and 6.7 GFLOP at
// the bank shape (Kc = 13, nj = 400000 per 4M samples: 99 us), against
// 10 us and 25 us for their bytes (32 MB of c64 in, 0.8 MB and 51 MB out,
// at 3.35 TB/s). So the function is bound by operations: a fused
// multiply-add is two of them, and with the window and the broadcast taps
// a thread issues about one shared-memory load per 2 x CG x R of them.
// The tensor cores (3xTF32 over each phase's Toeplitz form) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int R = 8;                  // consecutive outputs per thread
constexpr size_t kSmemMax = 232448;   // a block's 227 KB

template <typename E> struct Pair;
template <> struct Pair<float> { using V = float2; };
template <> struct Pair<int16_t> { using V = short2; };
template <> struct Pair<uint8_t> { using V = uchar2; };

// The shape of one launch (see halo_async below for how it is chosen).
struct Shape {
  int n, halo_len, C, win, D1, Kc, nj, j_begin, j_end;
  int B;      // outputs per block
  int G;      // output groups, B / R
  int NCG;    // channel groups, C / CG
  int H;      // phase groups
  int PH;     // phases per group
  int M;      // span samples per phase
  int P;      // span row stride, in samples
  int TS;     // tap row stride per phase, in taps
  int tap_bytes;
  float off, pad;
};

// Position of span sample m of a phase row: one pad sample after every R
__device__ __forceinline__ int pos(int m) { return m + m / R; }

__device__ __forceinline__ void cp_async8(float2* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Sample i of an interleaved (re, im) array of E into *dst, as f32 minus
// `off`: c64 by cp.async, the wire formats converted on load.
template <typename E>
__device__ __forceinline__ void stage(float2* dst, const E* p, int64_t i, float off) {
  const typename Pair<E>::V v = reinterpret_cast<const typename Pair<E>::V*>(p)[i];
  *dst = make_float2(static_cast<float>(v.x) - off, static_cast<float>(v.y) - off);
}
template <>
__device__ __forceinline__ void stage<float>(float2* dst, const float* p, int64_t i, float) {
  cp_async8(dst, reinterpret_cast<const float2*>(p) + i);
}

// One tap's products added to an output's (re, im) sums, fused: a real tap
// t, or a complex tap (Tr, Ti).
__device__ __forceinline__ void mac(float& ar, float& ai, float2 v, float t) {
  ar = __fmaf_rn(v.x, t, ar);
  ai = __fmaf_rn(v.y, t, ai);
}
__device__ __forceinline__ void mac(float& ar, float& ai, float2 v, float2 t) {
  ar = __fmaf_rn(v.x, t.x, ar);
  ar = __fmaf_rn(-v.y, t.y, ar);
  ai = __fmaf_rn(v.x, t.y, ai);
  ai = __fmaf_rn(v.y, t.x, ai);
}

// The products of nq <= R taps q0 + qq (tq points at tap q0 of channel c0
// of a phase row) with the window w (w[qq + r] is the sample of output r
// at tap q0 + qq), added to the R outputs' sums of CG channels.
template <typename Tap, int CG, bool PARTIAL>
__device__ __forceinline__ void taps_chunk(float (&ar)[CG][R], float (&ai)[CG][R],
                                           const float2 (&w)[2 * R], const Tap* tq, int C,
                                           int nq) {
#pragma unroll
  for (int qq = 0; qq < R; ++qq) {
    if (!PARTIAL || qq < nq) {
      Tap t[CG];
#pragma unroll
      for (int c = 0; c < CG; ++c) t[c] = tq[qq * C + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < CG; ++c) mac(ar[c][r], ai[c][r], w[qq + r], t[c]);
      }
    }
  }
}

// Threads a block may have: 512 with real taps (fewer registers a thread),
// 256 with complex ones.
template <typename Tap>
struct MaxThreads {
  static constexpr int value = sizeof(Tap) == sizeof(float) ? 512 : 256;
};

// Tap: float (real taps) or float2 (complex taps).
template <typename E, typename Tap, int CG>
__global__ void __launch_bounds__(MaxThreads<Tap>::value)
cfir_kernel(const E* __restrict__ x, const E* __restrict__ halo,
            const Tap* __restrict__ taps, float2* __restrict__ y, Shape s) {
  extern __shared__ float4 smem4[];
  Tap* st = reinterpret_cast<Tap*>(smem4);
  float2* span = reinterpret_cast<float2*>(reinterpret_cast<char*>(smem4) + s.tap_bytes);
  const int j0 = s.j_begin + blockIdx.x * s.B;

  // the taps, (win, C) with k = q D1 + p, as [p][q][c]
  for (int i = threadIdx.x; i < s.win * s.C; i += blockDim.x) {
    const int k = i / s.C;
    const int q = k / s.D1;
    st[(k - q * s.D1) * s.TS + q * s.C + (i - k * s.C)] = taps[i];
  }
  // the span, X[g0 + m D1 + p] for m < M, with X = [halo | x | pad]
  const int64_t g0 = static_cast<int64_t>(j0) * s.D1;
  for (int i = threadIdx.x; i < s.M * s.D1; i += blockDim.x) {
    const int m = i / s.D1;
    float2* dst = span + (i - m * s.D1) * s.P + pos(m);
    const int64_t g = g0 + i;
    if (g < s.halo_len) {
      stage(dst, halo, g, s.off);
    } else if (g - s.halo_len < s.n) {
      stage(dst, x, g - s.halo_len, s.off);
    } else {
      *dst = make_float2(s.pad, s.pad);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int g = threadIdx.x % s.G;
  const int rest = threadIdx.x / s.G;
  const int c0 = (rest % s.NCG) * CG;
  const int h = rest / s.NCG;
  float ar[CG][R], ai[CG][R];
#pragma unroll
  for (int c = 0; c < CG; ++c) {
#pragma unroll
    for (int r = 0; r < R; ++r) ar[c][r] = ai[c][r] = 0.0f;
  }
  const int p_end = min(s.D1, (h + 1) * s.PH);
  for (int p = h * s.PH; p < p_end; ++p) {
    const float2* row = span + p * s.P + g * (R + 1);   // sample m = g R
    const Tap* tp = st + p * s.TS + c0;
    float2 w[2 * R];
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = row[r];
    int q0 = 0;
    for (; q0 + R <= s.Kc; q0 += R) {
      const float2* next = row + (q0 / R + 1) * (R + 1);   // m = g R + q0 + R
#pragma unroll
      for (int r = 0; r < R; ++r) w[R + r] = next[r];
      taps_chunk<Tap, CG, false>(ar, ai, w, tp + q0 * s.C, s.C, R);
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = w[R + r];
    }
    if (q0 < s.Kc) {
      const float2* next = row + (q0 / R + 1) * (R + 1);
#pragma unroll
      for (int r = 0; r < R; ++r) w[R + r] = next[r];
      taps_chunk<Tap, CG, true>(ar, ai, w, tp + q0 * s.C, s.C, s.Kc - q0);
    }
  }

  // the sums, [h][c][B] over the span once every thread is done with it,
  // then added in order of h and stored with consecutive threads on
  // consecutive outputs
  __syncthreads();
  float2* part = span;
#pragma unroll
  for (int c = 0; c < CG; ++c) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      part[(h * s.C + c0 + c) * s.B + g * R + r] = make_float2(ar[c][r], ai[c][r]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < s.C * s.B; e += blockDim.x) {
    const int c = e / s.B;
    const int j = j0 + (e - c * s.B);
    float2 acc = part[e];
    for (int hh = 1; hh < s.H; ++hh) {
      const float2 v = part[hh * s.C * s.B + e];
      acc.x = acc.x + v.x;
      acc.y = acc.y + v.y;
    }
    if (j < s.j_end) y[static_cast<int64_t>(c) * s.nj + j] = acc;
  }
}

template <typename E, typename Tap, int CG>
int launch(const void* x, const void* halo, const void* taps, void* y,
           const Shape& s, size_t smem, cudaStream_t stream) {
  auto kern = cfir_kernel<E, Tap, CG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (s.j_end - s.j_begin + s.B - 1) / s.B;
  kern<<<blocks, s.G * s.NCG * s.H, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(halo),
      static_cast<const Tap*>(taps), static_cast<float2*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, typename Tap>
int launch_cg(int CG, const void* x, const void* halo, const void* taps,
              void* y, const Shape& s, size_t smem, cudaStream_t st) {
  switch (CG) {
    case 4: return launch<E, Tap, 4>(x, halo, taps, y, s, smem, st);
    case 3: return launch<E, Tap, 3>(x, halo, taps, y, s, smem, st);
    case 2: return launch<E, Tap, 2>(x, halo, taps, y, s, smem, st);
    default: return launch<E, Tap, 1>(x, halo, taps, y, s, smem, st);
  }
}

template <typename E>
int launch_taps(bool real_taps, int CG, const void* x, const void* halo,
                const void* taps, void* y, const Shape& s, size_t smem, cudaStream_t st) {
  return real_taps ? launch_cg<E, float>(CG, x, halo, taps, y, s, smem, st)
                   : launch_cg<E, float2>(CG, x, halo, taps, y, s, smem, st);
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
  if (C <= 0 || D1 <= 0 || win <= 0 || win % D1 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int CG = 1;   // the most channels a thread, of 4, 3, 2, 1, that divide C
  for (int cg = 4; cg > 1; --cg) {
    if (C % cg == 0) {
      CG = cg;
      break;
    }
  }
  const int Kc = win / D1;
  const int Kcr = (Kc + R - 1) / R * R;
  const bool real = real_taps != 0;
  const int max_t = real ? MaxThreads<float>::value : MaxThreads<float2>::value;
  const int TS = Kc * C + 1;
  const size_t tap_bytes =
      (static_cast<size_t>(D1) * TS * (real ? sizeof(float) : sizeof(float2)) + 15) / 16 * 16;
  auto span_bytes = [&](int B) {
    return static_cast<size_t>(D1) * ((R + 1) * (B + Kcr) / R | 1) * sizeof(float2);
  };
  // the sums of H phase groups
  auto region = [&](int B, int H) {
    const size_t part = static_cast<size_t>(H) * C * B * sizeof(float2);
    return part > span_bytes(B) ? part : span_bytes(B);
  };
  int B = 256;
  while (B > R && (tap_bytes + region(B, 1) > kSmemMax || B / R * (C / CG) > max_t)) B /= 2;
  if (tap_bytes + region(B, 1) > kSmemMax || B / R * (C / CG) > max_t)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = B / R;
  const int NCG = C / CG;
  int H = G * NCG >= 64 ? 1 : (D1 < max_t / (G * NCG) ? D1 : max_t / (G * NCG));
  while (H > 1 && tap_bytes + region(B, H) > kSmemMax) --H;
  const int PH = (D1 + H - 1) / H;
  H = (D1 + PH - 1) / PH;   // no empty phase group
  const float off = fmt == 2 ? 127.5f : 0.0f;
  const Shape s{n, halo_len, C, win, D1, Kc, nj, j_begin, j_end, B, G, NCG, H, PH,
                B + Kcr, (R + 1) * (B + Kcr) / R | 1, TS, static_cast<int>(tap_bytes), off,
                fmt == 2 ? 127.0f - 127.5f : 0.0f};
  const size_t smem = tap_bytes + region(B, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_taps<float>(real, CG, x, halo, taps, y, s, smem, st);
    case 1: return launch_taps<int16_t>(real, CG, x, halo, taps, y, s, smem, st);
    case 2: return launch_taps<uint8_t>(real, CG, x, halo, taps, y, s, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
