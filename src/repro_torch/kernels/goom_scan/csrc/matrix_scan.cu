// Matrix scan over GOOMs with a B operand, for Hopper (sm_90a): all states of
//
//     X_t = A_t X_{t-1} (+) B_t        (paper eq. 26, split log/sign form)
//
// in one kernel launch per call.
//
// Replaces the TPU kernel repro/kernels/goom_scan/matrix_scan.py::
// _matrix_scan_kernel (entry matrix_scan_kernel_call) and the functions of its
// Pallas-GPU siblings in matrix_scan_gpu.py (seq, tree, two_pass).  The form
// with no B operand has a kernel of its own, matrix_scan_zero_b.cu.
//
// The columns of X are independent under the recurrence, so a block owns one
// recurrence g and a tile of state columns, and nothing crosses blocks.  One
// "step" on a column x is the TPU kernel's _blmme followed by its _lse2: the
// left operand M (A_t, or a chunk's transition P) exponentiated once per row
// as sign * exp(log - detached row max), the column's exps against its
// detached max, the contraction in FMAs, log|acc| + row max + column max in
// f64.  The bias joins the contraction's sum as sign * exp(log - those
// maxima) when that exponent is within 80 e-folds (a normal f32; the signed
// LSE of the TPU kernel otherwise, and for an exact zero), so a step takes
// one log.  Both-zero or exact cancellation gives (-inf, +1).  An all-zero
// row or column (max -inf) scales by 0, never by -inf, so exact zeros come
// out as (-inf, +1) and never NaN.
//
// d <= 32: matrix_scan_warp_kernel.  One warp walks one time chunk of the
// tile's columns, warp-synchronously: lane (i, h) owns row i and half h of
// the contraction (two lanes per row at d <= 16, one at d <= 32), so maxima
// are shuffles, the carry's exps go through a per-warp scratch row, and a
// step crosses only __syncwarp.  Every input is copied with cp.async into
// shared memory ahead of use: x0 and a time-invariant A (time stride 0,
// exponentiated once per walk) at the start, and each warp's A_t and B_t,
// the whole chunk at the start when it fits (the main path) or a ring of NS
// stages issued NS - 1 steps ahead.  Time is cut into K chunks of L steps
// (ops.with_b_chunk_len(T, d); K = 1 is the plain walk):
//   1. part     each chunk c < K-1 from a zero start: B*_c, the state at its
//               end, walked in f32 as the fix-up walks; for a time-varying A
//               also P_c = A_end ... A_start, walked in f64 beside it.  For a
//               time-invariant A, P = A^L once per block by log2 L squarings
//               in f64 on the block's other warps, one output a thread.
//   2. stitch   X_in(0) = x0, X_in(c+1) = P_c X_in(c) (+) B*_c, by one warp,
//               as a walk's step with P's f64 logs (f32 exps and sum).
//   3. fix-up   each chunk walked again from X_in(c) in f32, every X_t
//               written (never X_t = P_{c,t} X_in: see matrix_scan_zero_b.cu).
// The products P run in f64: a product of L steps is nearly rank-deficient,
// and its errors grow where the stitch cancels against it (emulated, f32
// products land up to 2.6x the plain version's distance to float64 at T =
// 256).  The stitch's own step does not need f64: emulated with B = 0 it
// stays within 2x the walk's distance and far below the plain version's
// (tests/test_torch_with_b_passes.py).
// The walk keeps the carry's logs in f64 and rounds each output to f32 once:
// a long chain's logs reach thousands, where one f32 ulp is 1e-4.  Within a
// step the contraction over k is two 8-term FMA chains summed (d <= 16) or
// one 32-term chain (d <= 32), fixed by d: an output's bits depend on its
// column, d and L, never on G, m or the tile.
//
// d > 32: matrix_scan_block_kernel, the walk (L = T) with one block per (g,
// column tile) and one thread per output: A_{t+1} and B_{t+1} are copied
// with cp.async while step t runs; barriers inside a step.  Off every main
// path.
//
// What bounds it on this card: counted per call, bytes (each input plane
// read once, a time-invariant A once per g, each output written once): at
// the decode shape (G=48, T=1, d=16, m=4) 172 KB, 0.05 us at 3.35 TB/s; at
// the 64-token chunk (G=48, T=64, d=16, m=1) 0.27 us.  Both are far below
// one step's latency (about 0.5 us, a chain of shuffles, exp, FMAs and log):
// the time is the depth, 2 L + K - 2 steps instead of T, after one round
// trip for the inputs.
//
// Plain C interface, loaded with ctypes.  No fast-math: exp/log are the
// accurate library functions in both precisions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;        // the wrapper raises above
constexpr int kWarpMaxD = 32;     // the warp kernel's d; the block kernel above
constexpr int kGroup = 4;         // columns of one register step group
constexpr int kMaxStages = 8;     // ring stages per warp (cp.async.wait_group)
constexpr int kSmemMax = 232448;  // shared memory a block can opt in to
constexpr int kBlockThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t t, g, r, c;  // time, recurrence, row, column (elements)
};

struct Params {
  int T, G, d, m;
  int L, K, NS;     // chunk length and count, ring stages
  int nc;           // state columns per block
  int a_fixed;      // A's time stride is 0 (or T = 1)
  const float* a_log;
  const float* a_sign;
  const float* b_log;
  const float* b_sign;
  const float* x_log;  // null: X_0 = 0
  const float* x_sign;
  Strides a, b, x;     // x: entering state (t unused)
  float* out_log;      // (T, G, d, m) contiguous
  float* out_sign;
};

// rows R of a warp step: 16 (two lanes per row) or 32 (one); KP terms a lane
template <int R>
struct Lay {
  static constexpr int H = 32 / R, KP = R / H;
  static constexpr int kMaxK = R == 16 ? 16 : 4;  // chunks (warps)
  static constexpr int kMaxWarps = kMaxK + (R == 16 ? 4 : 8);
  static constexpr int kMaxThreads = 32 * kMaxWarps;
};

// warps that square A (a time-invariant A cut into chunks): as many as the
// block has beside its K chunk warps, at most eight
__host__ __device__ inline int squaring_warps(const Params& p, int R) {
  if (!p.a_fixed || p.K == 1) return 0;
  const int spare = (R == 16 ? Lay<16>::kMaxWarps : Lay<32>::kMaxWarps) - p.K;
  return spare < 8 ? spare : 8;
}

__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.0f; }
__device__ __forceinline__ double finite_or_zero(double v) { return isfinite(v) ? v : 0.0; }
__device__ __forceinline__ float exp_of(float v) { return expf(v); }
__device__ __forceinline__ double exp_of(double v) { return exp(v); }
__device__ __forceinline__ double log_abs(float v) { return (double)logf(fabsf(v)); }
__device__ __forceinline__ double log_abs(double v) { return log(fabs(v)); }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most ``pending`` of this thread's groups are in flight
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads));
}

// signed LSE of (l, s) and (l2, s2), in AT; both zero or exact cancellation
// gives (-inf, +1)
template <class AT>
__device__ __forceinline__ void lse_into(double& l, float& s, double l2, float s2) {
  const double mx = finite_or_zero(fmax(l, l2));
  const AT sum = (AT)s * exp_of((AT)(l - mx)) + (AT)s2 * exp_of((AT)(l2 - mx));
  l = log_abs(sum) + mx;
  s = sum >= (AT)0 ? 1.0f : -1.0f;
}

// exps of a bias within this many e-folds of the step's scale are normal
// numbers in AT, so the bias joins the contraction's sum
template <class AT> struct Lin;
template <> struct Lin<float> { static constexpr double kMax = 80.0; };
template <> struct Lin<double> { static constexpr double kMax = 700.0; };

// Row i of the left operand M (row-major, logs LT, signs f32) as lane (i, h)
// needs it: exps sign * exp(log - row max) in MT of its KP terms k = h KP +
// kk (zero past d), and the row max (finite, or 0).
template <int R, class MT, class LT>
__device__ __forceinline__ double row_exps(const LT* lg, const float* sg, int d,
                                           MT (&ae)[Lay<R>::KP]) {
  constexpr int KP = Lay<R>::KP;
  const int lane = threadIdx.x & 31, i = lane % R, h = lane / R;
  LT v[KP];
  LT mx = -INFINITY;
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
    const int k = h * KP + kk;
    v[kk] = i < d && k < d ? lg[i * d + k] : (LT)-INFINITY;
    mx = fmax(mx, v[kk]);
  }
  if (Lay<R>::H == 2) mx = fmax(mx, __shfl_xor_sync(kFull, mx, 16));
  mx = finite_or_zero(mx);
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
    const int k = h * KP + kk;
    ae[kk] = i < d && k < d ? (MT)sg[i * d + k] * exp_of((MT)(v[kk] - mx)) : (MT)0;
  }
  return (double)mx;
}

// One step on NC columns: x <- M x (+) b.  Lane (i, h) holds row i of each
// column (logs f64, replicated over h) and of b; ``sE`` is the warp's
// scratch row (NC x R of AT).  Rows past d stay (-inf, +1).
template <int R, int NC, class MT, class AT, bool kB>
__device__ __forceinline__ void col_step(const MT (&ae)[Lay<R>::KP], double rm, int d,
                                         double (&cl)[NC], float (&cs)[NC],
                                         const double (&bl)[NC], const float (&bs)[NC],
                                         AT* sE) {
  constexpr int KP = Lay<R>::KP;
  const int lane = threadIdx.x & 31, i = lane % R, h = lane / R;
  double cmx[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    double v = i < d ? cl[c] : -INFINITY;
#pragma unroll
    for (int o = R / 2; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
    cmx[c] = finite_or_zero(v);
    if (h == 0) sE[c * R + i] = i < d ? (AT)cs[c] * exp_of((AT)(cl[c] - cmx[c])) : (AT)0;
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const AT* e = sE + c * R + h * KP;
    // the bias in the step's scale, exponentiated beside the contraction
    const double sc = rm + cmx[c], bp = kB ? bl[c] - sc : 0.0;
    const bool lin = kB && fabs(bp) < Lin<AT>::kMax;
    const AT eb = lin ? (AT)bs[c] * exp_of((AT)bp) : (AT)0;
    AT acc = 0;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) acc = fma((AT)ae[kk], e[kk], acc);
    if (Lay<R>::H == 2) acc += __shfl_xor_sync(kFull, acc, 16);
    acc += eb;
    double l = log_abs(acc) + sc;
    float s = acc >= (AT)0 ? 1.0f : -1.0f;
    // a bias far from the scale (or an exact zero): the signed LSE
    if (kB && !lin && bl[c] != -INFINITY) lse_into<AT>(l, s, bl[c], bs[c]);
    if (i >= d) {
      l = -INFINITY;
      s = 1.0f;
    }
    cl[c] = l;
    cs[c] = s;
  }
  __syncwarp();  // sE is free again
}

// Shared memory of the warp kernel, computed alike on host and device.
struct WarpSmem {
  size_t p_log, p_exp, p_rmax, bst_log, xin_log, scratch;  // f64 arrays
  size_t p_sign, bst_sign, xin_sign, x0, a, ring;   // f32 arrays
  size_t slot;                                      // floats a ring stage
  size_t bytes;
  int np, warps;
  __host__ __device__ WarpSmem(const Params& p, int R) {
    const size_t d = p.d, dd = d * d, nc = p.nc, km = p.K - 1;
    np = p.K == 1 ? 0 : (p.a_fixed ? 1 : p.K - 1);
    warps = p.K + squaring_warps(p, R);
    size_t o = 0;
    p_log = o;    o += 8 * np * dd;
    const size_t sq = p.a_fixed && p.K > 1 ? 1 : 0;  // squarings: P's exps by
    p_exp = o;    o += 8 * sq * 2 * dd;                // row and by column, and
    p_rmax = o;   o += 8 * sq * 2 * d;                 // its row and column maxima
    bst_log = o;  o += 8 * km * d * nc;
    xin_log = o;  o += 8 * km * d * nc;
    scratch = o;  o += 8 * (size_t)warps * kGroup * R;
    p_sign = o;   o += 4 * np * dd;
    bst_sign = o; o += 4 * km * d * nc;
    xin_sign = o; o += 4 * km * d * nc;
    x0 = o;       o += 4 * 2 * d * nc;
    a = o;        o += p.a_fixed ? 4 * 2 * dd : 0;
    slot = (p.a_fixed ? 0 : 2 * dd) + 2 * d * nc;
    ring = o;     o += 4 * (size_t)p.K * p.NS * slot;
    bytes = o;
  }
};

// A warp's copies of its chunk's steps t0 .. t0+n-1 (A_t when time-varying,
// B_t's columns).  Resident (n <= NS): every step copied at the start in one
// cp.async group, and kept for the fix-up.  Else a ring of NS stages, step j
// in stage j % NS, issued NS - 1 steps ahead: each issue() commits one group
// (empty past the window), so before step j's wait exactly NS - 1 groups
// follow its.
template <int NC>
struct Ring {
  float* base;
  int slot, NS, t0, n, issued;
  __device__ bool resident() const { return n <= NS; }
  __device__ float* stage(int j) const { return base + (size_t)(j % NS) * slot; }
  __device__ void copy(const Params& p, int g, int j0, int live, int j) const {
    const int lane = threadIdx.x & 31, d = p.d, t = t0 + j;
    float* dst = stage(j);
    if (!p.a_fixed) {
      const int dd = d * d;
      for (int e = lane; e < dd; e += 32) {
        const int64_t o = (int64_t)t * p.a.t + (int64_t)g * p.a.g +
                          (int64_t)(e / d) * p.a.r + (int64_t)(e % d) * p.a.c;
        cp_async4(dst + e, p.a_log + o);
        cp_async4(dst + dd + e, p.a_sign + o);
      }
      dst += 2 * dd;
    }
    for (int e = lane; e < d * NC; e += 32) {
      const int i = e / NC, c = e % NC;
      if (c < live) {
        const int64_t o = (int64_t)t * p.b.t + (int64_t)g * p.b.g + (int64_t)i * p.b.r +
                          (int64_t)(j0 + c) * p.b.c;
        cp_async4(dst + e, p.b_log + o);
        cp_async4(dst + d * NC + e, p.b_sign + o);
      } else {
        dst[e] = -INFINITY;
        dst[d * NC + e] = 1.0f;
      }
    }
  }
  __device__ void issue(const Params& p, int g, int j0, int live) {
    if (issued < n) copy(p, g, j0, live, issued);
    cp_commit();
    ++issued;
  }
  // every step of a resident window, as one flat loop over its elements
  __device__ void copy_all(const Params& p, int g, int j0, int live) const {
    const int lane = threadIdx.x & 31, d = p.d, dd = d * d, per = d * NC;
    const int boff = p.a_fixed ? 0 : 2 * dd;
    for (int e = lane; e < n * per; e += 32) {
      const int j = e / per, r = e - j * per, i = r / NC, c = r - i * NC;
      float* dst = base + (size_t)j * slot + boff;
      if (c < live) {
        const int64_t o = (int64_t)(t0 + j) * p.b.t + (int64_t)g * p.b.g +
                          (int64_t)i * p.b.r + (int64_t)(j0 + c) * p.b.c;
        cp_async4(dst + r, p.b_log + o);
        cp_async4(dst + per + r, p.b_sign + o);
      } else {
        dst[r] = -INFINITY;
        dst[per + r] = 1.0f;
      }
    }
    if (!p.a_fixed) {
      for (int e = lane; e < n * dd; e += 32) {
        const int j = e / dd, r = e - j * dd, i = r / d, k = r - i * d;
        float* dst = base + (size_t)j * slot;
        const int64_t o = (int64_t)(t0 + j) * p.a.t + (int64_t)g * p.a.g +
                          (int64_t)i * p.a.r + (int64_t)k * p.a.c;
        cp_async4(dst + r, p.a_log + o);
        cp_async4(dst + dd + r, p.a_sign + o);
      }
    }
  }
  // the first copies, from the start of the window; returns the groups
  // committed
  __device__ int prime(const Params& p, int g, int j0, int live) {
    issued = 0;
    if (resident()) {
      copy_all(p, g, j0, live);
      cp_commit();
      issued = n;
      return 1;
    }
    for (int s = 0; s + 1 < NS; ++s) issue(p, g, j0, live);
    return NS - 1;
  }
  // step j's stage, landed and visible to the warp
  __device__ const float* next(const Params& p, int g, int j0, int live, int j) {
    if (resident()) {
      if (j == 0) cp_wait(0);
    } else {
      issue(p, g, j0, live);
      cp_wait(NS - 1);
    }
    __syncwarp();
    return stage(j);
  }
};

// the bias of a step without one (never read)
__device__ const double kNoBl[kGroup] = {};
__device__ const float kNoBs[kGroup] = {};

// kFixed: A's time stride is 0 (one column a warp); else four columns a
// warp, so that fewer warps copy each A_t.  kChunks: K > 1 (else the walk
// alone, the decode step's kernel, with no part or stitch compiled in)
template <int R, bool kFixed, bool kChunks>
__global__ void __launch_bounds__(kChunks ? Lay<R>::kMaxThreads : 32)
matrix_scan_warp_kernel(const Params p) {
  constexpr int KP = Lay<R>::KP, NC = kFixed ? 1 : kGroup;
  extern __shared__ __align__(16) unsigned char smem[];
  const WarpSmem lay(p, R);
  double* sPl = reinterpret_cast<double*>(smem + lay.p_log);
  double* sBsl = reinterpret_cast<double*>(smem + lay.bst_log);
  double* sXil = reinterpret_cast<double*>(smem + lay.xin_log);
  float* sPs = reinterpret_cast<float*>(smem + lay.p_sign);
  float* sBss = reinterpret_cast<float*>(smem + lay.bst_sign);
  float* sXis = reinterpret_cast<float*>(smem + lay.xin_sign);
  float* sX0 = reinterpret_cast<float*>(smem + lay.x0);  // logs, then signs
  float* sA = reinterpret_cast<float*>(smem + lay.a);    // logs, then signs

  const int d = p.d, dd = d * d, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, i = lane % R, h = lane / R;
  const int g = blockIdx.x, j0 = blockIdx.y * NC, live = min(NC, p.m - j0);
  const bool walker = warp < p.K;  // else a squaring warp
  const int c0 = warp;             // a walker's chunk
  const int n = walker ? min(p.L, p.T - c0 * p.L) : 0;
  double* scr = reinterpret_cast<double*>(smem + lay.scratch) + (size_t)warp * kGroup * R;

  // inputs: x0's tile and a time-invariant A, then each walker's first stages
  for (int e = tid; e < d * NC; e += nt) {
    const int r = e / NC, c = e % NC;
    if (p.x_log != nullptr && c < live) {
      const int64_t o = (int64_t)g * p.x.g + (int64_t)r * p.x.r + (int64_t)(j0 + c) * p.x.c;
      cp_async4(sX0 + e, p.x_log + o);
      cp_async4(sX0 + d * NC + e, p.x_sign + o);
    } else {
      sX0[e] = -INFINITY;
      sX0[d * NC + e] = 1.0f;
    }
  }
  if (kFixed) {  // rows by lane groups of R: no division on the way to the copies
    const int k = lane % R;
    for (int r = warp * Lay<R>::H + h; r < d; r += (nt >> 5) * Lay<R>::H) {
      if (k < d) {
        const int64_t o = (int64_t)g * p.a.g + (int64_t)r * p.a.r + (int64_t)k * p.a.c;
        cp_async4(sA + r * d + k, p.a_log + o);
        cp_async4(sA + dd + r * d + k, p.a_sign + o);
      }
    }
  }
  cp_commit();
  Ring<NC> ring{reinterpret_cast<float*>(smem + lay.ring) + (size_t)warp * p.NS * lay.slot,
                (int)lay.slot, p.NS, c0 * p.L, n, 0};
  cp_wait(walker ? ring.prime(p, g, j0, live) : 0);  // x0 and A landed
  __syncthreads();

  // a time-invariant A's exps, once per walk (f32, as every A_t's)
  float afe[KP];
  double afm = 0.0;
  if (kFixed) afm = row_exps<R, float, float>(sA, sA + dd, d, afe);

  if (kChunks) {  // K > 1: part and stitch
    // ---- 1. part: B*_c (f32) and, for a time-varying A, P_c (f64) ----------
    if (walker && c0 < p.K - 1) {
      double bl[NC];
      float bs[NC];
      for (int j = 0; j < p.L; ++j) {
        const float* st = ring.next(p, g, j0, live, j);
        const float* sb = st + (kFixed ? 0 : 2 * dd);
        double b2l[NC];
        float b2s[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          b2l[c] = i < d ? (double)sb[i * NC + c] : -INFINITY;
          b2s[c] = i < d ? sb[d * NC + i * NC + c] : 1.0f;
        }
        double* pl = sPl + (size_t)c0 * dd;
        float* ps = sPs + (size_t)c0 * dd;
        if (j == 0) {  // from zero: X = [A_start | B_start]
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            bl[c] = b2l[c];
            bs[c] = b2s[c];
          }
          if (!kFixed && i < d) {
            for (int kk = 0; kk < KP; ++kk) {
              const int k = h * KP + kk;
              if (k < d) {
                pl[i * d + k] = st[i * d + k];
                ps[i * d + k] = st[dd + i * d + k];
              }
            }
          }
          __syncwarp();
          continue;
        }
        float ae[KP];
        double rm = afm;
        if (kFixed) {
#pragma unroll
          for (int kk = 0; kk < KP; ++kk) ae[kk] = afe[kk];
        } else {
          rm = row_exps<R, float, float>(st, st + dd, d, ae);
        }
        col_step<R, NC, float, float, true>(ae, rm, d, bl, bs, b2l, b2s,
                                            reinterpret_cast<float*>(scr));
        if (!kFixed) {  // P_c's columns, in place, kGroup at a time
          for (int k0 = 0; k0 < d; k0 += kGroup) {
            double ql[kGroup];
            float qs[kGroup];
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              const bool ok = i < d && k0 + c < d;
              ql[c] = ok ? pl[i * d + k0 + c] : -INFINITY;
              qs[c] = ok ? ps[i * d + k0 + c] : 1.0f;
            }
            col_step<R, kGroup, float, double, false>(ae, rm, d, ql, qs, kNoBl, kNoBs, scr);
            if (h == 0 && i < d) {
#pragma unroll
              for (int c = 0; c < kGroup; ++c)
                if (k0 + c < d) {
                  pl[i * d + k0 + c] = ql[c];
                  ps[i * d + k0 + c] = qs[c];
                }
            }
            __syncwarp();
          }
        }
      }
      if (h == 0 && i < d) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          sBsl[((size_t)c0 * d + i) * NC + c] = bl[c];
          sBss[((size_t)c0 * d + i) * NC + c] = bs[c];
        }
      }
      if (!ring.resident()) ring.prime(p, g, j0, live);  // the fix-up streams it again
    } else if (!walker) {
      // P = A^L by log2 L squarings in f64 on the remaining warps, as the
      // plain version's LMME: row maxima of P as the left operand, column
      // maxima as the right, each entry exponentiated against both, then one
      // output of the product a thread (k in order), log|acc| + both maxima
      const int sqt = 32 * (lay.warps - p.K), st = tid - 32 * p.K;
      double* sLe = reinterpret_cast<double*>(smem + lay.p_exp);  // by row
      double* sRe = sLe + dd;                                      // by column
      double* sRm = reinterpret_cast<double*>(smem + lay.p_rmax);
      double* sCm = sRm + d;
      for (int e = st; e < dd; e += sqt) {
        sPl[e] = sA[e];
        sPs[e] = sA[dd + e];
      }
      for (int e = p.L; e > 1; e >>= 1) {
        named_sync(1, sqt);  // P written
        // lane group st / R takes row a and column a: their maxima by
        // shuffles, then each entry's exp against both
        for (int a0 = 0; a0 < d; a0 += sqt / R) {
          const int a = a0 + st / R, b = st % R;
          const bool ok = a < d && b < d;
          const double vr = ok ? sPl[a * d + b] : -INFINITY;
          const double vc = ok ? sPl[b * d + a] : -INFINITY;
          double mr = vr, mc = vc;
#pragma unroll
          for (int o = R / 2; o > 0; o >>= 1) {
            mr = fmax(mr, __shfl_xor_sync(kFull, mr, o));
            mc = fmax(mc, __shfl_xor_sync(kFull, mc, o));
          }
          mr = finite_or_zero(mr);
          mc = finite_or_zero(mc);
          if (ok) {
            sLe[a * d + b] = (double)sPs[a * d + b] * exp(vr - mr);
            sRe[b * d + a] = (double)sPs[b * d + a] * exp(vc - mc);
          }
          if (a < d && b == 0) {
            sRm[a] = mr;
            sCm[a] = mc;
          }
        }
        named_sync(1, sqt);
        for (int e2 = st; e2 < dd; e2 += sqt) {
          const int r = e2 / d, c = e2 % d;
          double acc = 0.0;
          for (int k = 0; k < d; ++k) acc = fma(sLe[r * d + k], sRe[k * d + c], acc);
          sPl[e2] = log(fabs(acc)) + sRm[r] + sCm[c];
          sPs[e2] = acc >= 0.0 ? 1.0f : -1.0f;
        }
      }
    }
    __syncthreads();

    // ---- 2. stitch: X_in(c+1) = P_c X_in(c) (+) B*_c -------------------------
    if (warp == 0 && p.K > 1) {
      double xl[NC];
      float xs[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        xl[c] = i < d ? (double)sX0[i * NC + c] : -INFINITY;
        xs[c] = i < d ? sX0[d * NC + i * NC + c] : 1.0f;
      }
      float pe[KP];
      double prm = 0.0;
      if (kFixed) prm = row_exps<R, float, double>(sPl, sPs, d, pe);
      for (int c = 0; c + 1 < p.K; ++c) {
        if (!kFixed)
          prm = row_exps<R, float, double>(sPl + (size_t)c * dd, sPs + (size_t)c * dd, d, pe);
        double b2l[NC];
        float b2s[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          b2l[cc] = i < d ? sBsl[((size_t)c * d + i) * NC + cc] : -INFINITY;
          b2s[cc] = i < d ? sBss[((size_t)c * d + i) * NC + cc] : 1.0f;
        }
        col_step<R, NC, float, float, true>(pe, prm, d, xl, xs, b2l, b2s,
                                            reinterpret_cast<float*>(scr));
        if (h == 0 && i < d) {
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            sXil[((size_t)c * d + i) * NC + cc] = xl[cc];
            sXis[((size_t)c * d + i) * NC + cc] = xs[cc];
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- 3. fix-up: every chunk walked from X_in(c) in f32 ------------------
  if (!walker) return;
  double xl[NC];
  float xs[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (i >= d) {
      xl[c] = -INFINITY;
      xs[c] = 1.0f;
    } else if (c0 == 0) {
      xl[c] = (double)sX0[i * NC + c];
      xs[c] = sX0[d * NC + i * NC + c];
    } else {
      xl[c] = sXil[((size_t)(c0 - 1) * d + i) * NC + c];
      xs[c] = sXis[((size_t)(c0 - 1) * d + i) * NC + c];
    }
  }
  for (int j = 0; j < n; ++j) {
    const float* st = ring.next(p, g, j0, live, j);
    const float* sb = st + (kFixed ? 0 : 2 * dd);
    double b2l[NC];
    float b2s[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      b2l[c] = i < d ? (double)sb[i * NC + c] : -INFINITY;
      b2s[c] = i < d ? sb[d * NC + i * NC + c] : 1.0f;
    }
    float ae[KP];
    double rm = afm;
    if (kFixed) {
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) ae[kk] = afe[kk];
    } else {
      rm = row_exps<R, float, float>(st, st + dd, d, ae);
    }
    col_step<R, NC, float, float, true>(ae, rm, d, xl, xs, b2l, b2s,
                                        reinterpret_cast<float*>(scr));
    if (i < d) {
      const int t = c0 * p.L + j;
      const int64_t o = (((int64_t)t * p.G + g) * d + i) * p.m + j0;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c >= live) continue;
        if (h == 0) p.out_log[o + c] = (float)xl[c];
        if (h == Lay<R>::H - 1) p.out_sign[o + c] = xs[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// d > 32: the walk, one block per (g, column tile), one thread per output
// ---------------------------------------------------------------------------
struct BlockSmem {
  size_t xl, mc, nl, ns, ae, mr, b, xs, e, bytes;
  int tm;
  __host__ __device__ BlockSmem(const Params& p) {
    const size_t d = p.d, dd = d * d;
    tm = p.nc;
    const size_t dt = d * tm;
    size_t o = 0;
    xl = o; o += 8 * 2 * dt;  // carry logs (f64), double-buffered
    mc = o; o += 8 * tm;      // the carry's column maxima (f64)
    nl = o; o += 4 * dd;      // A_t logs (copied ahead)
    ns = o; o += 4 * dd;      // A_t signs
    ae = o; o += 4 * dd;      // A_t's exps
    mr = o; o += 4 * d;       // A_t's row maxima
    b = o;  o += 4 * 2 * 2 * dt;  // B_t logs and signs, two stages
    xs = o; o += 4 * 2 * dt;  // carry signs, double-buffered
    e = o;  o += 4 * dt;      // the carry's exps (and x0's logs on arrival)
    bytes = o;
  }
};

__global__ void __launch_bounds__(kBlockThreads)
matrix_scan_block_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockSmem S(p);
  const int d = p.d, tm = S.tm, dd = d * d, dt = d * tm;
  double* sXl = reinterpret_cast<double*>(smem + S.xl);
  double* sMc = reinterpret_cast<double*>(smem + S.mc);
  float* sNl = reinterpret_cast<float*>(smem + S.nl);
  float* sNs = reinterpret_cast<float*>(smem + S.ns);
  float* sA = reinterpret_cast<float*>(smem + S.ae);
  float* sMr = reinterpret_cast<float*>(smem + S.mr);
  float* sB = reinterpret_cast<float*>(smem + S.b);
  float* sXs = reinterpret_cast<float*>(smem + S.xs);
  float* sE = reinterpret_cast<float*>(smem + S.e);
  const int g = blockIdx.x, j0 = blockIdx.y * tm, live = min(tm, p.m - j0);
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  auto copy_a = [&](int t) {
    for (int e = tid; e < dd; e += nt) {
      const int64_t o = (int64_t)t * p.a.t + (int64_t)g * p.a.g + (int64_t)(e / d) * p.a.r +
                        (int64_t)(e % d) * p.a.c;
      cp_async4(sNl + e, p.a_log + o);
      cp_async4(sNs + e, p.a_sign + o);
    }
  };
  auto copy_b = [&](int t) {
    float* dst = sB + (t & 1) * 2 * dt;
    for (int e = tid; e < dt; e += nt) {
      const int r = e / tm, c = e % tm;
      if (c < live) {
        const int64_t o = (int64_t)t * p.b.t + (int64_t)g * p.b.g + (int64_t)r * p.b.r +
                          (int64_t)(j0 + c) * p.b.c;
        cp_async4(dst + e, p.b_log + o);
        cp_async4(dst + dt + e, p.b_sign + o);
      }
    }
  };

  // x0's logs land in sE and are widened below; its signs in sXs
  for (int e = tid; e < dt; e += nt) {
    const int r = e / tm, c = e % tm;
    if (p.x_log != nullptr && c < live) {
      const int64_t o = (int64_t)g * p.x.g + (int64_t)r * p.x.r + (int64_t)(j0 + c) * p.x.c;
      cp_async4(sE + e, p.x_log + o);
      cp_async4(sXs + e, p.x_sign + o);
    } else {
      sE[e] = -INFINITY;
      sXs[e] = 1.0f;
    }
  }
  copy_a(0);
  copy_b(0);
  cp_commit();

  int cur = 0;
  for (int t = 0; t < p.T; ++t) {
    cp_wait(0);
    __syncthreads();  // A_t (when new) and B_t landed; step t-1 done
    if (t == 0)
      for (int e = tid; e < dt; e += nt) sXl[e] = (double)sE[e];
    if (t == 0 || !p.a_fixed) {
      for (int r = warp; r < d; r += nwarps) {
        float v = -INFINITY;
        for (int k = lane; k < d; k += 32) v = fmaxf(v, sNl[r * d + k]);
        for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
        if (lane == 0) sMr[r] = finite_or_zero(v);
      }
      __syncthreads();
      for (int e = tid; e < dd; e += nt) sA[e] = sNs[e] * expf(sNl[e] - sMr[e / d]);
      __syncthreads();  // sNl, sNs free
      if (!p.a_fixed && t + 1 < p.T) copy_a(t + 1);
    }
    if (t + 1 < p.T) copy_b(t + 1);
    cp_commit();

    const double* xl = sXl + cur * dt;
    const float* xs = sXs + cur * dt;
    for (int c = warp; c < tm; c += nwarps) {
      double v = -INFINITY;
      for (int r = lane; r < d; r += 32) v = fmax(v, xl[r * tm + c]);
      for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
      if (lane == 0) sMc[c] = finite_or_zero(v);
    }
    __syncthreads();
    for (int e = tid; e < dt; e += nt) sE[e] = xs[e] * expf((float)(xl[e] - sMc[e % tm]));
    __syncthreads();

    double* nl = sXl + (cur ^ 1) * dt;
    float* ns = sXs + (cur ^ 1) * dt;
    const float* bt = sB + (t & 1) * 2 * dt;
    for (int e = tid; e < dt; e += nt) {
      const int r = e / tm, c = e % tm;
      if (c >= live) {
        nl[e] = -INFINITY;
        ns[e] = 1.0f;
        continue;
      }
      const float* ar = sA + r * d;
      float acc = 0.0f;
      for (int k = 0; k < d; ++k) acc = fmaf(ar[k], sE[k * tm + c], acc);
      double l = (double)logf(fabsf(acc)) + sMr[r] + sMc[c];
      float s = acc >= 0.0f ? 1.0f : -1.0f;
      lse_into<float>(l, s, (double)bt[e], bt[dt + e]);
      const int64_t o = (((int64_t)t * p.G + g) * d + r) * p.m + j0 + c;
      p.out_log[o] = (float)l;
      p.out_sign[o] = s;
      nl[e] = l;
      ns[e] = s;
    }
    cur ^= 1;
  }
}

void load_strides(Strides* s, const int64_t* v, bool timed) {
  int k = 0;
  s->t = timed ? v[k++] : 0;
  s->g = v[k++];
  s->r = v[k++];
  s->c = v[k++];
}

template <class F>
cudaError_t allow_smem(F* kernel, size_t bytes, int* granted) {
  if (bytes <= 48 * 1024 || (int)bytes <= *granted) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *granted = (int)bytes;
  return e;
}

template <int R, bool kFixed, bool kChunks>
cudaError_t launch_warp(Params p, cudaStream_t stream) {
  constexpr int NC = kFixed ? 1 : kGroup;
  static int granted = 0;
  if (p.K > Lay<R>::kMaxK) return cudaErrorInvalidValue;
  if (p.K > 1 && p.a_fixed && (p.L & (p.L - 1))) return cudaErrorInvalidValue;  // A^L by squarings
  p.nc = NC;
  // stages a warp: the whole chunk when it fits (resident), else a ring of
  // at most kMaxStages, at least two
  p.NS = 1;
  const WarpSmem base(p, R);
  const size_t per_stage = 4 * (size_t)p.K * base.slot;
  const size_t fixed = base.bytes - per_stage;
  int ns = p.L;
  if (fixed + per_stage * ns > (size_t)kSmemMax) {
    ns = kMaxStages;
    while (ns > 2 && fixed + per_stage * ns > (size_t)kSmemMax) --ns;
  }
  p.NS = ns < 2 ? 2 : ns;
  const WarpSmem sm(p, R);
  if (sm.bytes > (size_t)kSmemMax) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (p.m + NC - 1) / NC;
  if (tiles > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t e = allow_smem(matrix_scan_warp_kernel<R, kFixed, kChunks>, sm.bytes, &granted);
  if (e != cudaSuccess) return e;
  matrix_scan_warp_kernel<R, kFixed, kChunks>
      <<<dim3((unsigned)p.G, (unsigned)tiles), 32 * sm.warps, sm.bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_block(Params p, cudaStream_t stream) {
  static int granted = 0;
  const int cap = p.d > 64 ? 512 : 1024;  // outputs a block owns
  p.nc = p.m < cap / p.d ? p.m : cap / p.d;
  const BlockSmem S(p);
  const int64_t tiles = (p.m + p.nc - 1) / p.nc;
  if (tiles > 65535) return cudaErrorInvalidConfiguration;
  const int dt = p.d * p.nc;
  const int threads = dt >= kBlockThreads ? kBlockThreads : ((dt + 31) / 32) * 32;
  cudaError_t e = allow_smem(matrix_scan_block_kernel, S.bytes, &granted);
  if (e != cudaSuccess) return e;
  matrix_scan_block_kernel<<<dim3((unsigned)p.G, (unsigned)tiles), threads, S.bytes, stream>>>(
      p);
  return cudaGetLastError();
}

}  // namespace

// a (T,G,d,d), b (T,G,d,m), x0 (G,d,m) or null (zeros); out (T,G,d,m)
// contiguous.  Strides in elements: a and b (t, g, row, col), x0 (g, row,
// col).  L: the time chunk (ops.with_b_chunk_len; L >= T walks), taken at
// d <= 32 only.  One kernel on ``stream``; returns a cudaError_t.
extern "C" int repro_matrix_scan_forward(
    const float* a_log, const float* a_sign, const float* b_log, const float* b_sign,
    const float* x_log, const float* x_sign, float* out_log, float* out_sign,
    int T, int G, int d, int m, int L, const int64_t* a_strides, const int64_t* b_strides,
    const int64_t* x_strides, void* stream) {
  if (T < 0 || G < 0 || d < 1 || d > kMaxD || m < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (T == 0 || G == 0) return (int)cudaSuccess;
  Params p{};
  p.T = T;
  p.G = G;
  p.d = d;
  p.m = m;
  p.a_log = a_log;
  p.a_sign = a_sign;
  p.b_log = b_log;
  p.b_sign = b_sign;
  p.x_log = x_log;
  p.x_sign = x_sign;
  p.out_log = out_log;
  p.out_sign = out_sign;
  load_strides(&p.a, a_strides, true);
  load_strides(&p.b, b_strides, true);
  if (x_log != nullptr) load_strides(&p.x, x_strides, false);
  p.a_fixed = p.a.t == 0 || T == 1;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d > kWarpMaxD) {
    p.L = T;
    p.K = 1;
    return (int)launch_block(p, s);
  }
  p.L = L < T ? L : T;
  p.K = (T + p.L - 1) / p.L;
  cudaError_t e;
  if (p.K == 1)
    e = d <= 16 ? (p.a_fixed ? launch_warp<16, true, false>(p, s)
                             : launch_warp<16, false, false>(p, s))
                : (p.a_fixed ? launch_warp<32, true, false>(p, s)
                             : launch_warp<32, false, false>(p, s));
  else
    e = d <= 16 ? (p.a_fixed ? launch_warp<16, true, true>(p, s)
                             : launch_warp<16, false, true>(p, s))
                : (p.a_fixed ? launch_warp<32, true, true>(p, s)
                             : launch_warp<32, false, true>(p, s));
  return (int)e;
}
