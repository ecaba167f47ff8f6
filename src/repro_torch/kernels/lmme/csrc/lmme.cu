// LMME over GOOMs for Hopper (sm_90a): out = log|A_exp @ B_exp| in split form.
//
// Replaces the TPU kernel repro/kernels/lmme/lmme.py::_lmme_kernel (entry
// lmme_kernel_call) and its Pallas-GPU sibling lmme_gpu.py::_lmme_gpu_kernel.
// Those stream K tiles through fast memory with a running row/column max; here
// the whole contraction of one output element is one thread's loop, so the
// exact row max of A and column max of B are taken first and every term is
// exponentiated once, near unit scale, against them.  That is the plain
// version's algorithm (repro_torch.core.ops.lmme_reference), summed in f32 FMA.
//
// What bounds it on this card: on the serving path the operands are
// (48,16,16) and (N,48,16,1) f32 planes with N a few hundred at most, so a
// call moves well under 1 MB and does ~N*48*16*16*2 flops: it is bound by
// launch latency, not by bytes or operations.  The design answers with one
// launch per call and no padding or broadcast copies: leading batch dims come
// in as strides (stride 0 broadcasts A without materialising it) and m=1
// matvecs are taken as they are.
//
// Plain C interface, loaded with ctypes.  No fast-math: expf/logf only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBatchDims = 6;

struct BatchDesc {
  int ndim;                        // leading batch dims, broadcast already
  int64_t size[kMaxBatchDims];
  int64_t a_stride[kMaxBatchDims]; // 0 where A is broadcast
  int64_t b_stride[kMaxBatchDims]; // 0 where B is broadcast
};

struct MatDesc {
  int n, d, m;
  int64_t a_rs, a_cs;  // A (n, d) row / column strides, shared by both planes
  int64_t b_rs, b_cs;  // B (d, m)
};

__global__ void lmme_kernel(const float* __restrict__ a_log,
                            const float* __restrict__ a_sign,
                            const float* __restrict__ b_log,
                            const float* __restrict__ b_sign,
                            float* __restrict__ out_log,
                            float* __restrict__ out_sign,
                            BatchDesc bd, MatDesc md, int64_t total) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % md.m);
  int64_t t = idx / md.m;
  const int i = (int)(t % md.n);
  t /= md.n;
  int64_t off_a = 0, off_b = 0;
  for (int k = bd.ndim - 1; k >= 0; --k) {
    const int64_t c = t % bd.size[k];
    t /= bd.size[k];
    off_a += c * bd.a_stride[k];
    off_b += c * bd.b_stride[k];
  }
  const float* al = a_log + off_a + (int64_t)i * md.a_rs;
  const float* as = a_sign + off_a + (int64_t)i * md.a_rs;
  const float* bl = b_log + off_b + (int64_t)j * md.b_cs;
  const float* bs = b_sign + off_b + (int64_t)j * md.b_cs;

  float mr = -INFINITY, mc = -INFINITY;
  for (int k = 0; k < md.d; ++k) {
    mr = fmaxf(mr, al[k * md.a_cs]);
    mc = fmaxf(mc, bl[k * md.b_rs]);
  }
  // all-zero row or column (max -inf): scale by 0, so -inf - m is no NaN
  if (!isfinite(mr)) mr = 0.0f;
  if (!isfinite(mc)) mc = 0.0f;

  float acc = 0.0f;
  for (int k = 0; k < md.d; ++k) {
    const float ea = as[k * md.a_cs] * expf(al[k * md.a_cs] - mr);
    const float eb = bs[k * md.b_rs] * expf(bl[k * md.b_rs] - mc);
    acc = fmaf(ea, eb, acc);
  }
  out_log[idx] = logf(fabsf(acc)) + mr + mc;
  out_sign[idx] = acc >= 0.0f ? 1.0f : -1.0f;
}

}  // namespace

extern "C" int repro_lmme_forward(const float* a_log, const float* a_sign,
                                  const float* b_log, const float* b_sign,
                                  float* out_log, float* out_sign,
                                  int ndim, const int64_t* batch_size,
                                  const int64_t* a_batch_stride,
                                  const int64_t* b_batch_stride,
                                  int n, int d, int m,
                                  int64_t a_rs, int64_t a_cs,
                                  int64_t b_rs, int64_t b_cs,
                                  void* stream) {
  if (ndim < 0 || ndim > kMaxBatchDims) return (int)cudaErrorInvalidValue;
  BatchDesc bd;
  bd.ndim = ndim;
  int64_t total = (int64_t)n * m;
  for (int k = 0; k < kMaxBatchDims; ++k) {
    const bool live = k < ndim;
    bd.size[k] = live ? batch_size[k] : 1;
    bd.a_stride[k] = live ? a_batch_stride[k] : 0;
    bd.b_stride[k] = live ? b_batch_stride[k] : 0;
    total *= bd.size[k];
  }
  MatDesc md{n, d, m, a_rs, a_cs, b_rs, b_cs};
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  lmme_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      a_log, a_sign, b_log, b_sign, out_log, out_sign, bd, md, total);
  return (int)cudaGetLastError();
}
