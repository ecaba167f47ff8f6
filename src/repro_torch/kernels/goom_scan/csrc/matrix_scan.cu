// Fused matrix scan over GOOMs for Hopper (sm_90a): all states of
//
//     X_t = A_t X_{t-1} (+) B_t        (paper eq. 26, split log/sign form)
//
// Replaces the TPU kernel repro/kernels/goom_scan/matrix_scan.py::
// _matrix_scan_kernel (entry matrix_scan_kernel_call) and the functions of its
// Pallas-GPU siblings in matrix_scan_gpu.py.  The form with no B operand
// (X_t = (A_t ... A_1) X_0) has a three-pass kernel of its own,
// matrix_scan_zero_b.cu; the template's kHasB=false branch is this walk's
// zero-B form, kept for when the with-B walk is redesigned the same way, and
// no entry point instantiates it.
//
// Design.  One block owns one recurrence g and one tile of tm state columns;
// the columns of X are independent under the recurrence, so tiles never talk.
// The block walks t = 0..T-1 in order, keeping the carry X_{t-1} in shared
// memory.  Each step is the batched LMME of the TPU kernel's _blmme followed
// by its _lse2:
//   1. A_t's row maxima (detached), then sign * exp(log - max) once per
//      element into shared memory, shared by all tm columns (a time-invariant
//      A, time stride 0, is loaded and exponentiated once);
//   2. the carry's column maxima, then its exps;
//   3. the contraction in f32 FMAs, un-scaled in log space;
//   4. B_t folded in with signed LSE; both-zero or exact cancellation gives
//      (-inf, +1);
//   5. X_t written out and kept as the next carry (double-buffered).
// An all-zero row or column (max -inf) scales by 0, never by -inf, so an
// exact zero comes out as (-inf, +1) and never NaN.
//
// The carry's logs, their column maxima and the un-scaling are kept in f64.
// A long chain's logs reach thousands, where one f32 ulp is 1e-4: rounding
// the carry to f32 at every step would add that much relative error to each
// column's scale per step, a random walk over T steps that the tree of the
// plain version (log T roundings) does not take.  Outputs are rounded to
// f32 once.  Everything else (A, the exps, the contraction) stays f32.
//
// Why the time axis is sequential: the TPU kernel spends O(T d^2 (d+m) log BT)
// MXU flops on an in-chunk associative scan of (A, B) compounds, because the
// TPU's grid is sequential anyway and the MXU wants d x d products.  Walking
// the recurrence directly is O(T d^2 m) work, the least there is, at O(T)
// depth.  A log-depth time axis (the tree and two-pass designs of
// matrix_scan_gpu.py), tensor cores and TMA are a later redesign.
//
// What bounds it on this card: counted per call, bytes.  Each input plane is
// read once (a stride-0 A once per g), each output plane written once: at
// the decode shape (G=48, T=1, d=16, m=4) 172 KB, about 0.05 us at 3.35 TB/s;
// at d=128, T=2001, m=128, 524 MB, about 0.16 ms.  At O(T) depth with one
// block per (g, tile) the kernel is far from either: serving calls are bound
// by launch latency, and long chains by the per-step latency of one block.
//
// Plain C interface, loaded with ctypes.  No fast-math: expf/logf only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;         // one MXU tile on the TPU; the wrapper raises above
constexpr int kOutsPerBlock = 1024;  // rows x tile columns a block owns per step
constexpr int kMaxThreads = 256;

struct Strides {
  int64_t t, g, r, c;  // time, recurrence, row, column (elements)
};

struct ScanDesc {
  int T, G, d, m, tm;  // tm: state columns per block
  Strides a, b, x;     // x: entering state (t unused)
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max over a slice, with a non-finite max replaced by 0 (scale by 0)
__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.0f;
}

__device__ __forceinline__ double finite_or_zero(double v) {
  return isfinite(v) ? v : 0.0;
}

template <bool kHasB>
__global__ void matrix_scan_kernel(const float* __restrict__ a_log,
                                   const float* __restrict__ a_sign,
                                   const float* __restrict__ b_log,
                                   const float* __restrict__ b_sign,
                                   const float* __restrict__ x_log,
                                   const float* __restrict__ x_sign,
                                   float* __restrict__ out_log,
                                   float* __restrict__ out_sign,
                                   ScanDesc sd) {
  extern __shared__ double smem[];
  const int d = sd.d, tm = sd.tm, dd = d * d, dt = d * tm;
  const int64_t g = blockIdx.x;
  const int j0 = blockIdx.y * tm;
  const int live = min(tm, sd.m - j0);  // live columns of this tile
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  double* sXl = smem;        // 2*dt  carry logs (f64), double-buffered
  double* sMc = sXl + 2 * dt;  // tm    column maxima of the carry (f64)
  float* sA = reinterpret_cast<float*>(sMc + tm);  // dd  sign * exp(log - row max) of A_t
  float* sMr = sA + dd;      // d     row maxima of A_t
  float* sE = sMr + d;       // dt    sign * exp(log - column max) of the carry
  float* sXs = sE + dt;      // 2*dt  carry signs

  // entering state: x0's tile, or exact zeros; dead columns stay zero
  for (int e = tid; e < dt; e += nt) {
    const int i = e / tm, j = e % tm;
    double l = -INFINITY;
    float s = 1.0f;
    if (x_log != nullptr && j < live) {
      const int64_t off = g * sd.x.g + i * sd.x.r + (j0 + j) * sd.x.c;
      l = x_log[off];
      s = x_sign[off];
    }
    sXl[e] = l;
    sXs[e] = s;
  }

  const bool a_fixed = sd.a.t == 0;
  int cur = 0;
  for (int t = 0; t < sd.T; ++t) {
    if (t == 0 || !a_fixed) {
      const int64_t a_off = t * sd.a.t + g * sd.a.g;
      __syncthreads();  // the previous step is done reading sA
      for (int e = tid; e < dd; e += nt)
        sA[e] = a_log[a_off + (e / d) * sd.a.r + (e % d) * sd.a.c];
      __syncthreads();
      for (int i = warp; i < d; i += nwarps) {
        float v = -INFINITY;
        for (int k = lane; k < d; k += 32) v = fmaxf(v, sA[i * d + k]);
        v = warp_max(v);
        if (lane == 0) sMr[i] = finite_or_zero(v);
      }
      __syncthreads();
      for (int e = tid; e < dd; e += nt)
        sA[e] = a_sign[a_off + (e / d) * sd.a.r + (e % d) * sd.a.c] *
                expf(sA[e] - sMr[e / d]);
    }

    const double* xl = sXl + cur * dt;
    const float* xs = sXs + cur * dt;
    __syncthreads();  // carry written, sA ready, sMc and sE free
    for (int j = warp; j < tm; j += nwarps) {
      double v = -INFINITY;
      for (int i = lane; i < d; i += 32) v = fmax(v, xl[i * tm + j]);
      v = warp_max(v);
      if (lane == 0) sMc[j] = finite_or_zero(v);
    }
    __syncthreads();
    for (int e = tid; e < dt; e += nt)
      sE[e] = xs[e] * expf((float)(xl[e] - sMc[e % tm]));
    __syncthreads();

    double* nl = sXl + (cur ^ 1) * dt;
    float* ns = sXs + (cur ^ 1) * dt;
    for (int e = tid; e < dt; e += nt) {
      const int i = e / tm, j = e % tm;
      if (j >= live) {
        nl[e] = -INFINITY;
        ns[e] = 1.0f;
        continue;
      }
      const float* ar = sA + i * d;
      float acc = 0.0f;
      for (int k = 0; k < d; ++k) acc = fmaf(ar[k], sE[k * tm + j], acc);
      double l = (double)logf(fabsf(acc)) + sMr[i] + sMc[j];
      float s = acc >= 0.0f ? 1.0f : -1.0f;
      if (kHasB) {  // signed LSE of (A_t X_{t-1}) and B_t
        const int64_t b_off = t * sd.b.t + g * sd.b.g + i * sd.b.r + (j0 + j) * sd.b.c;
        const double l2 = b_log[b_off];
        const float s2 = b_sign[b_off];
        const double mx = finite_or_zero(fmax(l, l2));
        const float sum = s * expf((float)(l - mx)) + s2 * expf((float)(l2 - mx));
        l = (double)logf(fabsf(sum)) + mx;
        s = sum >= 0.0f ? 1.0f : -1.0f;
      }
      const int64_t o = ((t * (int64_t)sd.G + g) * d + i) * sd.m + j0 + j;
      out_log[o] = (float)l;
      out_sign[o] = s;
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

template <bool kHasB>
int launch(const float* a_log, const float* a_sign, const float* b_log,
           const float* b_sign, const float* x_log, const float* x_sign,
           float* out_log, float* out_sign, int T, int G, int d, int m,
           const int64_t* a_strides, const int64_t* b_strides,
           const int64_t* x_strides, void* stream) {
  if (T < 0 || G < 0 || d < 1 || d > kMaxD || m < 1) return (int)cudaErrorInvalidValue;
  if (T == 0 || G == 0) return (int)cudaSuccess;
  ScanDesc sd{};
  sd.T = T;
  sd.G = G;
  sd.d = d;
  sd.m = m;
  sd.tm = m < kOutsPerBlock / d ? m : kOutsPerBlock / d;
  load_strides(&sd.a, a_strides, true);
  if (kHasB) load_strides(&sd.b, b_strides, true);
  if (x_log != nullptr) load_strides(&sd.x, x_strides, false);
  const int64_t tiles = (m + sd.tm - 1) / sd.tm;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const int dt = d * sd.tm;
  const int threads = dt >= kMaxThreads ? kMaxThreads : ((dt + 31) / 32) * 32;
  const size_t smem = sizeof(double) * (2 * (size_t)dt + sd.tm) +
                      sizeof(float) * ((size_t)d * d + d + 3 * (size_t)dt);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        matrix_scan_kernel<kHasB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  matrix_scan_kernel<kHasB><<<dim3((unsigned)G, (unsigned)tiles), threads, smem,
                              (cudaStream_t)stream>>>(
      a_log, a_sign, b_log, b_sign, x_log, x_sign, out_log, out_sign, sd);
  return (int)cudaGetLastError();
}

}  // namespace

// a (T,G,d,d), b (T,G,d,m), x0 (G,d,m) or null (zeros), out (T,G,d,m)
// contiguous.  Strides in elements: a and b (t, g, row, col), x0 (g, row, col).
extern "C" int repro_matrix_scan_forward(
    const float* a_log, const float* a_sign, const float* b_log, const float* b_sign,
    const float* x_log, const float* x_sign, float* out_log, float* out_sign,
    int T, int G, int d, int m, const int64_t* a_strides, const int64_t* b_strides,
    const int64_t* x_strides, void* stream) {
  return launch<true>(a_log, a_sign, b_log, b_sign, x_log, x_sign, out_log, out_sign,
                      T, G, d, m, a_strides, b_strides, x_strides, stream);
}
