// Diagonal scan over GOOMs for Hopper (sm_90a): all states of
//
//     x_t = a_t (.) x_{t-1} (+) b_t        (split log/sign form)
//
// over (T, C) planes, with (.) the log-space product (logs add, signs
// multiply) and (+) signed log-sum-exp.  x0 (C) enters at t = 0; an absent
// x0 is an exact zero (-inf, +1).
//
// Replaces the TPU kernel repro/kernels/goom_scan/goom_scan.py::_scan_kernel
// (entry goom_scan_kernel_call) and the function of its Pallas-GPU siblings
// in goom_scan_gpu.py (seq, tree, two-pass).  Mamba's segment_states reaches
// it once per layer for every prefill chunk and decode step.
//
// Design.  One thread owns one channel c and walks t = 0..T-1 in order,
// keeping the carry in registers.  Neighbouring threads own neighbouring
// channels, so every load and store of a time row is coalesced.  The loads
// of a_t and b_t do not depend on the carry: each thread issues kAhead
// steps' loads before it combines them, so the memory latency of one step
// hides behind the others.  Channels are independent under the recurrence,
// so blocks never talk; batch dims reach the kernel flattened into C as one
// stride (a stride of 0 broadcasts), and nothing is padded.
//
// The combine is the TPU kernel's _lse2: m = max(l1, l2); both-zero inputs
// (m at or below -1e30) and exact cancellation give (-inf, +1), and the sign
// is +1 for a sum >= 0.  The carry's log is kept in f64: at e+-200 one f32
// ulp of a log is 1.5e-5, and rounding the carry to f32 at every step would
// random-walk each channel's scale by that much per step, where the plain
// version's tree rounds log T times.  The exps, the sum and its log stay f32
// (their arguments are O(1)); outputs are rounded to f32 once.
//
// What bounds it on this card: bytes.  16 B read (a and b, log and sign) and
// 8 B written per element, plus 8 B per channel for x0.  At Mamba's decode
// step over 4 slots (T=1, C=4*8192*16) that is 16.8 MB, 5.0 us at 3.35
// TB/s; at a 64-token prefill chunk (T=64, C=8192*16) 202 MB, 60 us.  The
// operations per element (two expf, one logf, a few adds) are far below the
// card's f32 rate.  The TPU kernel's (channel tile, time tile) grid with a
// VMEM carry and in-chunk associative scan is not carried over: on Hopper a
// sequential time walk per thread is already the least work, and C is large
// enough on this path to fill the card.
//
// Plain C interface, loaded with ctypes.  No fast-math: expf/logf only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;          // time steps whose loads are in flight together
constexpr double kNeg = -1e30;     // at or below: an exact zero for combining

__global__ void __launch_bounds__(kThreads)
diag_scan_kernel(const float* __restrict__ a_log, const float* __restrict__ a_sign,
                 int64_t a_st_t, int64_t a_st_c,
                 const float* __restrict__ b_log, const float* __restrict__ b_sign,
                 int64_t b_st_t, int64_t b_st_c,
                 const float* __restrict__ x_log, const float* __restrict__ x_sign,
                 int64_t x_st_c,
                 float* __restrict__ out_log, float* __restrict__ out_sign,
                 int64_t T, int64_t C) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;

  double xl = -INFINITY;
  float xs = 1.0f;
  if (x_log != nullptr) {
    xl = (double)__ldg(x_log + c * x_st_c);
    xs = __ldg(x_sign + c * x_st_c);
  }
  const float* al_p = a_log + c * a_st_c;
  const float* as_p = a_sign + c * a_st_c;
  const float* bl_p = b_log + c * b_st_c;
  const float* bs_p = b_sign + c * b_st_c;

  for (int64_t t0 = 0; t0 < T; t0 += kAhead) {
    float al[kAhead], as[kAhead], bl[kAhead], bs[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int64_t t = t0 + k;
      if (t < T) {
        al[k] = __ldg(al_p + t * a_st_t);
        as[k] = __ldg(as_p + t * a_st_t);
        bl[k] = __ldg(bl_p + t * b_st_t);
        bs[k] = __ldg(bs_p + t * b_st_t);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int64_t t = t0 + k;
      if (t < T) {
        // a_t (.) x_{t-1}, then (+) b_t
        const double l1 = (double)al[k] + xl;
        const float s1 = as[k] * xs;
        const double l2 = (double)bl[k];
        const double m = fmax(l1, l2);
        if (m <= kNeg) {
          xl = -INFINITY;
          xs = 1.0f;
        } else {
          const float sum = s1 * expf((float)(l1 - m)) + bs[k] * expf((float)(l2 - m));
          if (sum == 0.0f) {
            xl = -INFINITY;
            xs = 1.0f;
          } else {
            xl = (double)logf(fabsf(sum)) + m;
            xs = sum >= 0.0f ? 1.0f : -1.0f;
          }
        }
        out_log[t * C + c] = (float)xl;
        out_sign[t * C + c] = xs;
      }
    }
  }
}

}  // namespace

// All T states into out_log/out_sign, (T, C) row-major.  Operand element
// (t, c) sits at t * st_t + c * st_c of its plane (log and sign share
// strides); x_log == nullptr starts from zero.  Returns a cudaError_t.
extern "C" int repro_diag_scan_forward(
    const float* a_log, const float* a_sign, int64_t a_st_t, int64_t a_st_c,
    const float* b_log, const float* b_sign, int64_t b_st_t, int64_t b_st_c,
    const float* x_log, const float* x_sign, int64_t x_st_c,
    float* out_log, float* out_sign, int64_t T, int64_t C, void* stream) {
  if (T < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || C == 0) return (int)cudaSuccess;
  const int64_t blocks = (C + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  diag_scan_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a_log, a_sign, a_st_t, a_st_c, b_log, b_sign, b_st_t, b_st_c,
      x_log, x_sign, x_st_c, out_log, out_sign, T, C);
  return (int)cudaGetLastError();
}
