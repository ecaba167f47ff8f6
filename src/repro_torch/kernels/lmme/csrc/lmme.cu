// LMME over GOOMs for Hopper (sm_90a): out = log|A_exp @ B_exp| in split form.
//
// Replaces the TPU kernel repro/kernels/lmme/lmme.py::_lmme_kernel (entry
// lmme_kernel_call) and its Pallas-GPU sibling lmme_gpu.py::_lmme_gpu_kernel.
// Those stream K tiles through fast memory with a running row/column max;
// here the exact row max of A and column max of B are taken first, and every
// element is exponentiated once per block, near unit scale, against them:
// the plain version's algorithm (repro_torch.core.ops.lmme_reference), summed
// in f32 FMA.  No TF32.
//
// One output's f32 value depends only on its row of A, its column of B and
// d, never on the call's batch, n or m, so that chunked prefill equals full
// prefill on the card.  Both launch shapes below compute it the same way:
//   - row max mr and column max mc: exact (fmaxf), a non-finite max -> 0;
//   - ea = sign * expf(log - mr), eb = sign * expf(log - mc);
//   - the K order, a function of d alone: chains of kSeg = 64 terms
//     acc = fmaf(ea_k, eb_k, acc) from 0 in k order, the chains' sums folded
//     left to right (one chain, the plain k-order sum, for d <= 64);
//   - out = logf(|acc|) + mr + mc, sign +1 for acc >= 0.
//
// Two launch shapes, picked by the wrapper from the call's shape:
//   batched  d <= 64, n <= 64, n*m <= 256, and the batch dims split into
//            dims that A varies over (collapsed into one, V) and dims A is
//            broadcast over (stride 0, collapsed into one, Q).  The serving
//            path: A (48,16,16) over N = S*B rows of B (N,48,16,1), the A
//            doubling, the admit fold, the 64-token chunk.  Grid (V, Q / qb):
//            a block stages A_v's exps once (a warp per row, read along k)
//            and reuses them for its qb rows of Q; a warp per column of B
//            takes its max and exps; one thread per output.
//   tiled    everything else (the chains' square d = 8..128, the 2-D
//            (130,70)x(70,50), d = 256): a block owns a 16 x 16 output tile
//            of one batch entry.  A pre-pass takes the tile's exact row and
//            column maxima; then K stages of 256: each element exponentiated
//            once into shared memory, the (output, 64-chain) work items
//            spread over all threads (so a long d with few outputs splits
//            its K over the block), partial sums folded in order by each
//            output's owner thread.  No atomics.
// Batch offsets are computed once per block.
//
// What bounds it on this card: on the serving path a call moves well under
// 1 MB (bytes bound it at ~0.05 us) and does ~N*48*16*16*2 flops: launch
// latency and one block's dependent loads set its time.  Leading batch dims
// come in as strides (stride 0 broadcasts A without materialising it).
//
// Plain C interface, loaded with ctypes.  No fast-math: expf/logf only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 64;                 // one FMA chain of the K order
constexpr int kSegsPerStage = 4;
constexpr int kKC = kSeg * kSegsPerStage;  // k per tiled stage
constexpr int kBM = 16, kBN = 16;        // tiled output tile
constexpr int kMaxBatchDims = 6;
constexpr int kBatchedMaxD = 64, kBatchedMaxN = 64;
constexpr int kBatchedStage = 64 * (kBatchedMaxD + 1);  // floats per staged operand

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

struct Flat {          // one collapsed batch dim of the batched shape
  int64_t size, a, b, o;  // its size and its strides in A, B and out
};

__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.0f; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void finish(float acc, float mr, float mc, float* out_log,
                                       float* out_sign, int64_t o) {
  out_log[o] = logf(fabsf(acc)) + mr + mc;
  out_sign[o] = acc >= 0.0f ? 1.0f : -1.0f;
}

// max of one row (or column) of ``len`` <= 64 entries by a warp, lanes along
// it; its exps (sign * exp(log - max)) go to dst[k], the max is returned
__device__ __forceinline__ float warp_stage(const float* lg, const float* sg, int64_t st,
                                            int len, int lane, float* dst) {
  float l[2], s[2];
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = lane + 32 * q;
    l[q] = -INFINITY;
    s[q] = 1.0f;
    if (k < len) {
      l[q] = lg[k * st];
      s[q] = sg[k * st];
    }
    mx = fmaxf(mx, l[q]);
  }
  mx = finite_or_zero(warp_max(mx));
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = lane + 32 * q;
    if (k < len) dst[k] = s[q] * expf(l[q] - mx);
  }
  return mx;
}

__global__ void __launch_bounds__(kThreads)
lmme_batched_kernel(const float* __restrict__ a_log, const float* __restrict__ a_sign,
                    const float* __restrict__ b_log, const float* __restrict__ b_sign,
                    float* __restrict__ out_log, float* __restrict__ out_sign,
                    Flat fv, Flat fq, int qb, MatDesc md) {
  __shared__ float sA[kBatchedStage];   // n x (d+1): exps of A_v, row-major
  __shared__ float sB[kBatchedStage];   // (qb*m) x (d+1): exps of B's columns
  __shared__ float sMr[kBatchedMaxN];
  __shared__ float sMc[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = md.n, d = md.d, m = md.m, ld = d + 1;
  const int64_t v = blockIdx.x, q0 = (int64_t)blockIdx.y * qb;
  const int nq = fq.size - q0 < qb ? (int)(fq.size - q0) : qb;
  const int64_t off_a = v * fv.a;  // A is the same for every q
  const int64_t off_b = v * fv.b + q0 * fq.b, off_o = v * fv.o + q0 * fq.o;

  for (int i = warp; i < n; i += kWarps) {
    const float mx = warp_stage(a_log + off_a + i * md.a_rs, a_sign + off_a + i * md.a_rs,
                                md.a_cs, d, lane, sA + i * ld);
    if (lane == 0) sMr[i] = mx;
  }
  for (int c = warp; c < nq * m; c += kWarps) {
    const int64_t o = off_b + (c / m) * fq.b + (c % m) * md.b_cs;
    const float mx = warp_stage(b_log + o, b_sign + o, md.b_rs, d, lane, sB + c * ld);
    if (lane == 0) sMc[c] = mx;
  }
  __syncthreads();

  if (tid < nq * n * m) {
    const int q = tid / (n * m), r = tid % (n * m), i = r / m, j = r % m, c = q * m + j;
    const float* ar = sA + i * ld;
    const float* bc = sB + c * ld;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(ar[k], bc[k], acc);
    finish(acc, sMr[i], sMc[c], out_log, out_sign, off_o + q * fq.o + i * m + j);
  }
}

__global__ void __launch_bounds__(kThreads)
lmme_tiled_kernel(const float* __restrict__ a_log, const float* __restrict__ a_sign,
                  const float* __restrict__ b_log, const float* __restrict__ b_sign,
                  float* __restrict__ out_log, float* __restrict__ out_sign,
                  BatchDesc bd, MatDesc md, int tiles_n, int tiles_m) {
  __shared__ float sA[kKC * (kBM + 1)];             // k-major exps of the tile's A rows
  __shared__ float sB[kKC * kBN];                   // k-major exps of its B columns
  __shared__ float sP[kSegsPerStage * kBM * kBN];   // one stage's chain sums
  __shared__ float sRed[kThreads];
  __shared__ float sMr[kBM], sMc[kBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = md.n, d = md.d, m = md.m;

  const int64_t tiles = (int64_t)tiles_n * tiles_m;
  const int tile = (int)(blockIdx.x % tiles);
  int64_t bi = blockIdx.x / tiles;
  const int64_t batch = bi;
  int64_t off_a = 0, off_b = 0;
  for (int k = bd.ndim - 1; k >= 0; --k) {
    const int64_t c = bi % bd.size[k];
    bi /= bd.size[k];
    off_a += c * bd.a_stride[k];
    off_b += c * bd.b_stride[k];
  }
  const int i0 = tile / tiles_m * kBM, j0 = tile % tiles_m * kBN;
  const int rows = min(kBM, n - i0), cols = min(kBN, m - j0);
  const float* al = a_log + off_a + i0 * md.a_rs;
  const float* as = a_sign + off_a + i0 * md.a_rs;
  const float* bl = b_log + off_b + j0 * md.b_cs;
  const float* bs = b_sign + off_b + j0 * md.b_cs;

  // exact maxima: a warp per row of A (along k); 16 threads per column of B
  for (int r = warp; r < rows; r += kWarps) {
    float v = -INFINITY;
    for (int k = lane; k < d; k += 32) v = fmaxf(v, al[r * md.a_rs + k * md.a_cs]);
    v = warp_max(v);
    if (lane == 0) sMr[r] = finite_or_zero(v);
  }
  {
    const int c = tid % kBN, kq = tid / kBN;
    float v = -INFINITY;
    if (c < cols)
      for (int k = kq; k < d; k += kThreads / kBN) v = fmaxf(v, bl[k * md.b_rs + c * md.b_cs]);
    sRed[tid] = v;
  }
  __syncthreads();
  if (tid < kBN) {
    float v = -INFINITY;
    for (int kq = 0; kq < kThreads / kBN; ++kq) v = fmaxf(v, sRed[kq * kBN + tid]);
    sMc[tid] = finite_or_zero(v);
  }

  const int live = rows * cols;  // output o -> (o / cols, o % cols), owned by thread o
  float total = 0.0f;
  for (int k0 = 0; k0 < d; k0 += kKC) {
    const int kc = min(kKC, d - k0);
    __syncthreads();  // maxima ready; the last stage's reads of sA, sB, sP done
    for (int e = tid; e < rows * kc; e += kThreads) {
      const int r = e / kc, k = e % kc;
      const int64_t o = r * md.a_rs + (int64_t)(k0 + k) * md.a_cs;
      sA[k * (kBM + 1) + r] = as[o] * expf(al[o] - sMr[r]);
    }
    for (int e = tid; e < kc * cols; e += kThreads) {
      const int k = e / cols, c = e % cols;
      const int64_t o = (int64_t)(k0 + k) * md.b_rs + c * md.b_cs;
      sB[k * kBN + c] = bs[o] * expf(bl[o] - sMc[c]);
    }
    __syncthreads();
    const int nseg = (kc + kSeg - 1) / kSeg;
    for (int w = tid; w < live * nseg; w += kThreads) {
      const int o = w % live, sg = w / live, r = o / cols, c = o % cols;
      const int ke = min(sg * kSeg + kSeg, kc);
      float acc = 0.0f;
      for (int k = sg * kSeg; k < ke; ++k) acc = fmaf(sA[k * (kBM + 1) + r], sB[k * kBN + c], acc);
      sP[sg * kBM * kBN + o] = acc;
    }
    __syncthreads();
    if (tid < live)
      for (int sg = 0; sg < nseg; ++sg) {
        const float p = sP[sg * kBM * kBN + tid];
        total = (k0 == 0 && sg == 0) ? p : total + p;
      }
  }
  __syncthreads();  // sMc is read below even when d = 0 ran no stage
  if (tid < live) {
    const int r = tid / cols, c = tid % cols;
    finish(total, sMr[r], sMc[c], out_log, out_sign,
           (batch * n + i0 + r) * (int64_t)m + j0 + c);
  }
}

}  // namespace

// Tiled form: any batch (ndim <= 6 leading dims, broadcast by stride), out
// (batch..., n, m) contiguous.
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
  if (ndim < 0 || ndim > kMaxBatchDims || n < 0 || d < 0 || m < 0)
    return (int)cudaErrorInvalidValue;
  BatchDesc bd;
  bd.ndim = ndim;
  int64_t nbatch = 1;
  for (int k = 0; k < kMaxBatchDims; ++k) {
    const bool live = k < ndim;
    bd.size[k] = live ? batch_size[k] : 1;
    bd.a_stride[k] = live ? a_batch_stride[k] : 0;
    bd.b_stride[k] = live ? b_batch_stride[k] : 0;
    nbatch *= bd.size[k];
  }
  if (nbatch == 0 || n == 0 || m == 0) return (int)cudaSuccess;
  MatDesc md{n, d, m, a_rs, a_cs, b_rs, b_cs};
  const int tiles_n = (n + kBM - 1) / kBM, tiles_m = (m + kBN - 1) / kBN;
  const int64_t blocks = nbatch * tiles_n * tiles_m;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  lmme_tiled_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a_log, a_sign, b_log, b_sign, out_log, out_sign, bd, md, tiles_n, tiles_m);
  return (int)cudaGetLastError();
}

// Batched form: batch (V, Q) with A constant over Q (v_*/q_*: size and the
// strides of A, B and out); qb rows of Q per block.  The wrapper checks the
// shape limits; they are checked again here.
extern "C" int repro_lmme_batched_forward(const float* a_log, const float* a_sign,
                                          const float* b_log, const float* b_sign,
                                          float* out_log, float* out_sign,
                                          const int64_t* v_desc, const int64_t* q_desc,
                                          int qb, int n, int d, int m,
                                          int64_t a_rs, int64_t a_cs,
                                          int64_t b_rs, int64_t b_cs, void* stream) {
  const Flat fv{v_desc[0], v_desc[1], v_desc[2], v_desc[3]};
  const Flat fq{q_desc[0], q_desc[1], q_desc[2], q_desc[3]};
  if (n < 1 || d < 1 || m < 1 || d > kBatchedMaxD || n > kBatchedMaxN || qb < 1 ||
      qb * n * m > kThreads || (int64_t)qb * m * (d + 1) > kBatchedStage || fq.a != 0)
    return (int)cudaErrorInvalidValue;
  if (fv.size == 0 || fq.size == 0) return (int)cudaSuccess;
  const int64_t gy = (fq.size + qb - 1) / qb;
  if (fv.size > 0x7fffffff || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  MatDesc md{n, d, m, a_rs, a_cs, b_rs, b_cs};
  lmme_batched_kernel<<<dim3((unsigned)fv.size, (unsigned)gy), kThreads, 0,
                        (cudaStream_t)stream>>>(a_log, a_sign, b_log, b_sign, out_log,
                                                out_sign, fv, fq, qb, md);
  return (int)cudaGetLastError();
}
