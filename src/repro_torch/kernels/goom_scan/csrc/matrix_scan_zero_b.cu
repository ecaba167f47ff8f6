// Zero-B matrix scan over GOOMs for Hopper (sm_90a): all prefix states
//
//     X_t = (A_t ... A_1) X_0        (paper eq. 26 with B = 0, split log/sign)
//
// in three passes, at a depth of about 2 L + T / L block products instead of
// T.  With X_0 = I it is cumulative_lmme, which carries the chains and the
// Lyapunov LLE.
//
// Replaces the TPU kernel repro/kernels/goom_scan/matrix_scan.py::
// _matrix_scan_kernel_zero_b (entry matrix_scan_kernel_call_zero_b) and the
// functions of its Pallas-GPU siblings in matrix_scan_gpu.py.  The design is
// that of the two-pass GPU kernel (matrix_scan_gpu.py: part
// _matrix_scan_gpu_part_kernel_zero_b, stitch _prod_stitch, fix-up
// _matrix_scan_gpu_fixup_kernel_zero_b), with the stitch as a pass of its own.
// Time is cut into K chunks of L steps (L from T alone: ops.zero_b_chunk_len):
//
//   1. part    grid (K - 1, G, column tiles of d).  Each block walks its
//              chunk c and writes the chunk's product P_c = A_end ... A_start,
//              logs in f64 (K - 1, G, d, d).  The chunks run in parallel.
//      scale   one warp per row of every P_c: its logs become
//              sign * exp(log - row max) in f64, once for all stitch blocks.
//   2. stitch  grid (1, G, column tiles of m).  X_in(0) = x0 and
//              X_in(c+1) = P_c X_in(c): the state entering each chunk, logs
//              in f64 (K, G, d, m).
//   3. fix-up  grid (K, G, column tiles of m).  Each block walks its chunk
//              again from X_in(c), X_t = A_t X_{t-1}, and writes every X_t.
//
// Why the fix-up walks instead of applying in-chunk prefix products
// (X_t = P_t X_in, the GPU kernel's fix-up): a chunk product P is nearly
// rank-deficient and so is a long chain's X_in.  In P X_in every row cancels
// by the same factor (the cosine between P's top right singular vector and
// X_in's top left one), and f32 errors in P's entries or in the f32 sum
// grow by its inverse: emulated, 2-10x the sequential walk's distance to
// float64, and no better with P's logs in f64.  Multiplying by one fresh A_t
// per step cancels no more than one random matrix does.  So the only
// products of two long chains are the part pass's and the stitch's, and
// those run in f64 (contraction, the carry's exps and logs; P's exps too).
// A's own exps stay f32 everywhere: an error in A_t is an error of the
// input, which a walk does not amplify.  Emulated, this lands at or below
// the sequential walk's distance (tests/test_torch_zero_b_passes.py).
//
// One block product ("step"), as the plain version's lmme_reference:
//   - the left operand M is exponentiated once per row, sign *
//     exp(log - detached row max), and staged in shared memory: A_t's by
//     the exp pre-pass above d = 16 (by the block itself at d <= 16), P_c's
//     by the scale pass;
//   - the right operand (the carry) lives in registers, its logs in f64:
//     each thread owns the carry entries it computes.  Column maxima are a
//     warp shuffle plus one value per warp in shared memory, and each thread
//     exponentiates its own entries into shared memory;
//   - the contraction is FMA with register tiling: each thread owns
//     kRM x kCM outputs (rows ty + kTR * r, columns kCM * tx + c; 4 x 4 of a
//     128 x 32 tile above d = 16, 4 x 2 of 128 x 16 in the stitch, whose few
//     blocks wait on their f64 FMAs), reads M along k four at a time from rows
//     whose stride puts a warp's rows in distinct banks, and the carry four
//     columns at a time;
//   - the un-scaling log|acc| + row max + column max is f64.
// Two barriers per step.  A_{t+1} is loaded while step t contracts: at
// d <= 16 a thread owns one entry of A and holds the next in registers;
// above, the part pass and the fix-up copy the pre-pass's exps with cp.async
// into a second buffer.  No TF32 and no tensor cores.  An all-zero row or
// column (max -inf) scales by 0, so exact zeros come out as (-inf, +1) and
// never NaN.
//
// What bounds it on this card: counted per call, bytes (each input plane
// read once, each output plane written once): at d=128, T=2001 524 MB, 0.16 ms
// at 3.35 TB/s; at (1000,16,16) 1.2 us.  The passes read A (or its exps)
// three times and run at 2 L + K depth: at small d the per-step latency of
// one block sets the time, at d=128 the part pass's f64 FMAs.
//
// Plain C interface, loaded with ctypes.  No fast-math: exp/log are the
// accurate library functions in both precisions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;  // the wrapper raises above
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Mode { kPart = 0, kStitch = 1, kFixup = 2 };

struct Strides {
  int64_t t, g, r, c;  // time, recurrence, row, column (elements)
};

struct Params {
  int T, G, d, m;
  int L, K;                  // chunk length and count
  int d4;                    // d rounded up to a multiple of 4
  const float* a_log;        // A (T, G, d, d) by strides
  const float* a_sign;
  Strides a;
  const float* x_log;        // x0 (G, d, m) by strides (t unused)
  const float* x_sign;
  Strides x;
  double* p_log;             // P (K - 1, G, d, d), contiguous: logs, then
  float* p_sign;             // (after the scale pass) sign * exp(log - row max)
  double* p_rmax;            // P's row maxima (K - 1, G, d)
  double* in_log;            // X_in (K, G, d, m), contiguous
  float* in_sign;
  float* out_log;            // X (T, G, d, m), contiguous
  float* out_sign;
  float* a_exp;              // above d = 16: A's exps (T or 1, G, d, d4)
  float* a_rmax;             // and its row maxima (T or 1, G, d)
};

// A block's tile of one product: all d rows (padded to kRows) by kCols
// columns; thread (ty, tx) owns rows ty + kTR * r and columns kCM * tx + c.
template <int RM, int CM, int TR, int TC, bool SMALL>
struct Tile {
  static constexpr int kRM = RM, kCM = CM, kTR = TR, kTC = TC;
  static constexpr int kRows = RM * TR, kCols = CM * TC;
  static constexpr bool kSmall = SMALL;  // one M entry per thread
  static_assert(TR * TC == kThreads, "one thread per (ty, tx)");
};
using SmallTile = Tile<1, 1, 16, 16, true>;   // d <= 16
using BigTile = Tile<4, 4, 32, 8, false>;     // d <= 128
using NarrowTile = Tile<4, 2, 32, 8, false>;  // d <= 128, the stitch: twice the blocks

// Per pass: MT, the type M's exps are staged in (A's are taken in f32 and
// stored in MT); AT, the type of the carry's exps and of the contraction.
template <int kMode> struct Types;
template <> struct Types<kPart> { using MT = float; using AT = double; };
template <> struct Types<kStitch> { using MT = double; using AT = double; };
template <> struct Types<kFixup> { using MT = float; using AT = float; };

// row stride of M's exps: a warp's rows ty, ty + 1, ... start four banks
// apart, so its four-wide loads along k hit distinct banks
template <class Tl, class MT>
__host__ __device__ constexpr int ld_of() {
  return (Tl::kRows + 31) / 32 * 32 + (sizeof(MT) == 4 ? 4 : 2);
}

// Above d = 16 the part pass and the fix-up take A's exps from the exp
// pre-pass, copied straight into shared memory with cp.async into two
// buffers: step t+1's copy runs while step t contracts.
template <class Tl, int kMode>
__host__ __device__ constexpr bool has_pre() { return kMode != kStitch && !Tl::kSmall; }

template <class Tl, int kMode>
constexpr size_t smem_bytes() {
  using MT = typename Types<kMode>::MT;
  using AT = typename Types<kMode>::AT;
  constexpr size_t bufs = has_pre<Tl, kMode>() ? 2 : 1;
  return bufs * sizeof(MT) * Tl::kRows * ld_of<Tl, MT>() +
         sizeof(AT) * Tl::kRows * Tl::kCols +
         sizeof(double) * (Tl::kRows + kWarps * Tl::kCols) + bufs * sizeof(float) * Tl::kRows;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.0f; }
__device__ __forceinline__ double finite_or_zero(double v) { return isfinite(v) ? v : 0.0; }

template <class T>
__device__ __forceinline__ T warp_max(T v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float exp_of(float v) { return expf(v); }
__device__ __forceinline__ double exp_of(double v) { return exp(v); }
__device__ __forceinline__ double log_abs(float v) { return (double)logf(fabsf(v)); }
__device__ __forceinline__ double log_abs(double v) { return log(fabs(v)); }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// offset of A_t[i][k] in the input
__device__ __forceinline__ int64_t a_offset(const Params& p, int t, int g, int i, int k) {
  return t * p.a.t + g * p.a.g + i * p.a.r + k * p.a.c;
}

template <class Tl, int kMode>
__global__ void __launch_bounds__(kThreads)
matrix_scan_zero_b_kernel(const Params p) {
  using MT = typename Types<kMode>::MT;
  using AT = typename Types<kMode>::AT;
  constexpr int RM = Tl::kRM, CM = Tl::kCM, TR = Tl::kTR, TC = Tl::kTC;
  constexpr int kCols = Tl::kCols, kLd = ld_of<Tl, MT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kPre = has_pre<Tl, kMode>();
  constexpr int kBufs = kPre ? 2 : 1;
  MT* sAe = reinterpret_cast<MT*>(smem_raw);                   // kBufs x kRows x kLd
  AT* sXe = reinterpret_cast<AT*>(sAe + kBufs * Tl::kRows * kLd);       // kRows x kCols
  double* sRmax = reinterpret_cast<double*>(sXe + Tl::kRows * kCols);  // kRows
  double* sRed = sRmax + Tl::kRows;                                     // kWarps x kCols
  float* sRm = reinterpret_cast<float*>(sRed + kWarps * kCols);  // kBufs x kRows, copied

  const int d = p.d, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid / TC, tx = tid % TC;
  const int g = blockIdx.y;
  const int ncols = kMode == kPart ? d : p.m;
  const int j0 = blockIdx.z * kCols + CM * tx;  // first of this thread's columns
  const int d4 = (d + 3) & ~3;

  // steps: the part pass walks t = start+1 .. end (its carry starts as
  // A_start), the fix-up t = start .. end, the stitch c = 0 .. K-2
  int t_begin = 0, n_steps = 0;
  const int chunk = blockIdx.x;
  if (kMode == kStitch) {
    n_steps = p.K - 1;
  } else {
    t_begin = chunk * p.L + (kMode == kPart ? 1 : 0);
    n_steps = min((chunk + 1) * p.L, p.T) - t_begin;
  }

  // zero both staging planes once: the k padding [d, d4) and the rows past d
  // then contribute exact zeros
  {
    float* z = reinterpret_cast<float*>(smem_raw);
    const int n = (int)((sizeof(MT) * kBufs * Tl::kRows * kLd +
                         sizeof(AT) * Tl::kRows * kCols) / 4);
    for (int e = tid; e < n; e += kThreads) z[e] = 0.0f;
  }

  // the carry: this thread's entries, logs in f64
  double cl[RM][CM];
  float cs[RM][CM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = ty + TR * r;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      const int j = j0 + c;
      double l = -INFINITY;
      float s = 1.0f;
      if (i < d && j < ncols) {
        if (kMode == kPart) {  // the chunk's first factor
          const int64_t o = a_offset(p, chunk * p.L, g, i, j);
          l = p.a_log[o];
          s = p.a_sign[o];
        } else if (kMode == kStitch) {
          const int64_t o = g * p.x.g + i * p.x.r + j * p.x.c;
          l = p.x_log[o];
          s = p.x_sign[o];
          const int64_t q = ((int64_t)g * d + i) * p.m + j;  // X_in(0) = x0
          p.in_log[q] = l;
          p.in_sign[q] = s;
        } else {
          const int64_t o = (((int64_t)chunk * p.G + g) * d + i) * p.m + j;
          l = p.in_log[o];
          s = p.in_sign[o];
        }
      }
      cl[r][c] = l;
      cs[r][c] = s;
    }
  }

  // per-warp column maxima of the carry -> sRed; the lanes of one tx hold
  // one column
  auto column_partials = [&]() {
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      double v = -INFINITY;
#pragma unroll
      for (int r = 0; r < RM; ++r) v = fmax(v, cl[r][c]);
      for (int o = TC; o < 32; o <<= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane < TC) sRed[warp * kCols + CM * tx + c] = v;
    }
  };
  // the carry's column maxima (from sRed) and its exps into sXe
  double cmx[CM];
  auto stage_carry = [&]() {
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      double v = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v = fmax(v, sRed[w * kCols + CM * tx + c]);
      cmx[c] = finite_or_zero(v);
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + TR * r;
      if (i < d) {
#pragma unroll
        for (int c = 0; c < CM; ++c)
          sXe[i * kCols + CM * tx + c] = cs[r][c] * exp_of((AT)(cl[r][c] - cmx[c]));
      }
    }
  };

  // above d = 16: the copy of A_t's exps and row maxima into buffer ``buf``
  auto prefetch = [&](int t, int buf) {
    const int64_t row0 = ((int64_t)(p.a.t == 0 ? 0 : t) * p.G + g) * d;
    const int q4 = p.d4 / 4;
    MT* dst = sAe + buf * Tl::kRows * kLd;
    for (int e = tid; e < d * q4; e += kThreads) {
      const int i = e / q4, k = e % q4 * 4;
      cp_async(&dst[i * kLd + k], p.a_exp + (row0 + i) * p.d4 + k, 16);
    }
    for (int i = tid; i < d; i += kThreads)
      cp_async(&sRm[buf * Tl::kRows + i], p.a_rmax + row0 + i, 4);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // at d <= 16 thread (i, k) = (tid / 16, tid % 16) owns one entry of A_t,
  // fetched a step ahead
  const int si = tid >> 4, sk = tid & 15;
  float nl = -INFINITY, ns = 1.0f;
  auto fetch = [&](int t) {
    if (kMode != kStitch && si < d && sk < d) {
      const int64_t o = a_offset(p, t, g, si, sk);
      nl = p.a_log[o];
      ns = p.a_sign[o];
    }
  };
  auto stage_m = [&](int t) {
    if (kMode == kStitch) {  // P_c's exps and row maxima, staged by the scale pass
      const double* pe = p.p_log + ((int64_t)t * p.G + g) * d * d;
#pragma unroll 8
      for (int e = tid; e < d * d; e += kThreads) sAe[e / d * kLd + e % d] = (MT)pe[e];
      for (int i = tid; i < d; i += kThreads) sRmax[i] = p.p_rmax[((int64_t)t * p.G + g) * d + i];
    } else {  // d <= 16: the entry fetched a step ahead
      const float mx = finite_or_zero(warp_max(nl, 16));
      if (si < d && sk < d) sAe[si * kLd + sk] = (MT)(ns * expf(nl - mx));
      if (sk == 0 && si < d) sRmax[si] = (double)mx;
    }
  };
  auto step_time = [&](int s) { return kMode == kStitch ? s : t_begin + s; };

  __syncthreads();  // zeroed planes before any thread stages into them
  column_partials();
  if (kPre && n_steps > 0) prefetch(step_time(0), 0);
  __syncthreads();
  if (Tl::kSmall && n_steps > 0) fetch(step_time(0));

  for (int s = 0; s < n_steps; ++s) {
    const int t = step_time(s), buf = kPre ? s & 1 : 0;
    stage_carry();
    if (kPre)
      asm volatile("cp.async.wait_all;\n" ::);
    else
      stage_m(t);
    __syncthreads();
    if (Tl::kSmall && s + 1 < n_steps) fetch(step_time(s + 1));
    if (kPre && s + 1 < n_steps) prefetch(step_time(s + 1), buf ^ 1);
    const MT* sA = sAe + buf * Tl::kRows * kLd;

    AT acc[RM][CM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CM; ++c) acc[r][c] = 0;
    for (int k = 0; k < d4; k += 4) {
      MT a[RM][4];
#pragma unroll
      for (int r = 0; r < RM; ++r) load4(&sA[(ty + TR * r) * kLd + k], a[r]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        AT xv[CM];
        if constexpr (CM == 4) {
          load4(&sXe[(k + kk) * kCols + CM * tx], xv);
        } else {
#pragma unroll
          for (int c = 0; c < CM; ++c) xv[c] = sXe[(k + kk) * kCols + CM * tx + c];
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < CM; ++c) acc[r][c] = fma((AT)a[r][kk], xv[c], acc[r][c]);
      }
    }

    // epilogue: un-scale in f64; the stitch writes X_in(s + 1), the fix-up X_t
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + TR * r;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const int j = j0 + c;
        double l = -INFINITY;
        float sg = 1.0f;
        if (i < d && j < ncols) {
          l = log_abs(acc[r][c]) + (kPre ? (double)sRm[buf * Tl::kRows + i] : sRmax[i]) +
              cmx[c];
          sg = acc[r][c] >= 0 ? 1.0f : -1.0f;
          if (kMode == kStitch) {
            const int64_t q = (((int64_t)(s + 1) * p.G + g) * d + i) * p.m + j;
            p.in_log[q] = l;
            p.in_sign[q] = sg;
          } else if (kMode == kFixup) {
            const int64_t q = (((int64_t)t * p.G + g) * d + i) * p.m + j;
            p.out_log[q] = (float)l;
            p.out_sign[q] = sg;
          }
        }
        cl[r][c] = l;
        cs[r][c] = sg;
      }
    }
    column_partials();
    __syncthreads();
  }

  if (kMode == kPart) {  // the chunk's product P_c
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + TR * r;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        const int j = j0 + c;
        if (i < d && j < ncols) {
          const int64_t q = (((int64_t)chunk * p.G + g) * d + i) * d + j;
          p.p_log[q] = cl[r][c];
          p.p_sign[q] = cs[r][c];
        }
      }
    }
  }
}

// Above d = 16, first: A's exps, once per (t, g, row) for all blocks of all
// passes: the row max (f32) and sign * exp(log - max) in f32, each row padded
// with zeros to d4 so that it is copied 16 bytes at a time.  A time-invariant
// A (time stride 0) is taken once.
__global__ void __launch_bounds__(kThreads)
matrix_scan_zero_b_exp_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (int64_t)(p.a.t == 0 ? 1 : p.T) * p.G * p.d) return;
  const int i = (int)(row % p.d), g = (int)(row / p.d % p.G);
  const int t = (int)(row / ((int64_t)p.d * p.G));
  float l[kMaxD / 32], s[kMaxD / 32];
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMaxD / 32; ++q) {
    const int k = lane + 32 * q;
    l[q] = -INFINITY;
    s[q] = 1.0f;
    if (k < p.d) {
      const int64_t o = a_offset(p, t, g, i, k);
      l[q] = p.a_log[o];
      s[q] = p.a_sign[o];
    }
    mx = fmaxf(mx, l[q]);
  }
  mx = finite_or_zero(warp_max(mx, 32));
  float* e = p.a_exp + row * p.d4;
#pragma unroll
  for (int q = 0; q < kMaxD / 32; ++q) {
    const int k = lane + 32 * q;
    if (k < p.d4) e[k] = k < p.d ? s[q] * expf(l[q] - mx) : 0.0f;
  }
  if (lane == 0) p.a_rmax[row] = mx;
}

// Between part and stitch: every row of every chunk product, by one warp,
// to sign * exp(log - row max) in f64, in place, and its max to p_rmax.  The
// stitch then stages P_c without a max or an exp, and each exp is taken once
// instead of once per stitch block.
__global__ void __launch_bounds__(kThreads)
matrix_scan_zero_b_scale_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (int64_t)(p.K - 1) * p.G * p.d) return;
  double* lg = p.p_log + row * p.d;
  const float* sg = p.p_sign + row * p.d;
  double v[kMaxD / 32];
  double mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMaxD / 32; ++q) {
    const int k = lane + 32 * q;
    v[q] = k < p.d ? lg[k] : -INFINITY;
    mx = fmax(mx, v[q]);
  }
  mx = finite_or_zero(warp_max(mx, 32));
#pragma unroll
  for (int q = 0; q < kMaxD / 32; ++q) {
    const int k = lane + 32 * q;
    if (k < p.d) lg[k] = sg[k] * exp(v[q] - mx);
  }
  if (lane == 0) p.p_rmax[row] = mx;
}

void load_strides(Strides* s, const int64_t* v, bool timed) {
  int k = 0;
  s->t = timed ? v[k++] : 0;
  s->g = v[k++];
  s->r = v[k++];
  s->c = v[k++];
}

template <class Tl, int kMode>
cudaError_t launch_pass(const Params& p, dim3 grid, cudaStream_t stream) {
  if (grid.x == 0) return cudaSuccess;  // no chunk needs this pass
  const size_t smem = smem_bytes<Tl, kMode>();
  if (smem > 48 * 1024) {
    static bool set = false;  // once per instantiation
    if (!set) {
      const cudaError_t e = cudaFuncSetAttribute(
          matrix_scan_zero_b_kernel<Tl, kMode>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      set = true;
    }
  }
  matrix_scan_zero_b_kernel<Tl, kMode><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tl for the part pass and the fix-up, Ts for the stitch
template <class Tl, class Ts>
cudaError_t launch_all(const Params& p, cudaStream_t stream) {
  const unsigned tiles_d = (p.d + Tl::kCols - 1) / Tl::kCols;
  const unsigned tiles_m = (p.m + Tl::kCols - 1) / Tl::kCols;
  cudaError_t e;
  if (!Tl::kSmall) {
    const int64_t rows = (int64_t)(p.a.t == 0 ? 1 : p.T) * p.G * p.d;
    matrix_scan_zero_b_exp_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                                    stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = launch_pass<Tl, kPart>(p, dim3(p.K - 1, p.G, tiles_d), stream);
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)(p.K - 1) * p.G * p.d;
  if (rows > 0) {
    matrix_scan_zero_b_scale_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                                      stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = launch_pass<Ts, kStitch>(p, dim3(1, p.G, (p.m + Ts::kCols - 1) / Ts::kCols), stream);
  if (e != cudaSuccess) return e;
  return launch_pass<Tl, kFixup>(p, dim3(p.K, p.G, tiles_m), stream);
}

}  // namespace

// a (T,G,d,d) by strides (t, g, row, col), x0 (G,d,m) by strides (g, row,
// col); out (T,G,d,m) contiguous.  Scratch from the caller, K = ceil(T / L):
// the chunk products p (K-1, G, d, d) with f64 logs and their row maxima
// p_rmax (K-1, G, d), x_in (K, G, d, m) with f64 logs, and above d = 16 A's
// exps a_exp (T, G, d, d4) and row maxima a_rmax (T, G, d), T -> 1 for a
// time stride of 0 (d4: d rounded up to a multiple of 4).  Launches exp
// (above d = 16), part, scale, stitch and fix-up on ``stream`` (part and
// scale only when K > 1); returns a cudaError_t.
extern "C" int repro_matrix_scan_zero_b_forward(
    const float* a_log, const float* a_sign, const float* x_log, const float* x_sign,
    float* out_log, float* out_sign, double* p_log, float* p_sign, double* p_rmax,
    double* in_log, float* in_sign, float* a_exp, float* a_rmax, int T, int G, int d,
    int m, int L, const int64_t* a_strides, const int64_t* x_strides, void* stream) {
  if (T < 0 || G < 0 || d < 1 || d > kMaxD || m < 1 || L < 1 || x_log == nullptr)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || G == 0) return (int)cudaSuccess;
  if (G > 65535 || (m + 15) / 16 > 65535) return (int)cudaErrorInvalidConfiguration;
  Params p{};
  p.T = T;
  p.G = G;
  p.d = d;
  p.m = m;
  p.L = L;
  p.K = (T + L - 1) / L;
  p.d4 = (d + 3) & ~3;
  p.a_log = a_log;
  p.a_sign = a_sign;
  load_strides(&p.a, a_strides, true);
  p.x_log = x_log;
  p.x_sign = x_sign;
  load_strides(&p.x, x_strides, false);
  p.p_log = p_log;
  p.p_sign = p_sign;
  p.p_rmax = p_rmax;
  p.in_log = in_log;
  p.in_sign = in_sign;
  p.out_log = out_log;
  p.out_sign = out_sign;
  p.a_exp = a_exp;
  p.a_rmax = a_rmax;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(d <= 16 ? launch_all<SmallTile, SmallTile>(p, s)
                        : launch_all<BigTile, NarrowTile>(p, s));
}
