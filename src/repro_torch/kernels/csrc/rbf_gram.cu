// RBF Gram matrix on Hopper: K[b, i, j] = exp(-gamma * ||x[b, i] - y[b, j]||^2).
//
// Replaces: src/repro/kernels/rbf_gram.py:rbf_gram_pallas (body
// _rbf_gram_kernel), batched over a leading dim as ops.rbf_gram does.
//
// What bounds it on an H100: the output write. d is tiny (3 for the paper's
// (f, p, N) features, 2 for the engine's (f, cores) grid), so each output
// costs about 3d + 6 flops and 4 bytes: at the fit shape (4, 1760, 1760) the
// 49.6 MB write is about 15 us at 3.35 TB/s. The accurate expf (some 20
// instructions) and the distance make ~40 instructions an output, about
// 17 us of instruction slots on the card's 132 SMs, so the stores have to
// stream while that runs.
//
// Design:
// * A thread owns 4 consecutive columns j .. j + 3 of one batch item: their
//   y rows (d floats each, d <= 16, a template argument so that they stay
//   in registers) and ||y||^2 are loaded once, and the thread walks
//   up to kRowsPerThread rows, writing one float4 a row with a streaming store
//   (st.global.cs: the output is not read again by this kernel). A row
//   whose 4 columns are not 16-byte aligned (m % 4 != 0) or run past m is
//   written as scalars.
// * A block is 32 x 8 threads: a warp covers 128 consecutive columns of
//   one row (512 bytes, coalesced), the 8 warps take rows ty, ty + 8, ...
//   of a band of 64 rows, or of 32, 16 or 8 where a 64-row band would make
//   fewer than two blocks an SM (one evaluate predict, 352 x 1,760, makes
//   84). The x row and ||x||^2 are read by the whole warp at
//   one address (a broadcast from L1) and computed by each thread; there
//   is no shared memory and no __syncthreads.
// * The arithmetic is the plain version's (kernels/ref.py), term by term:
//   xx + yy - 2 xy, clamped at 0, then expf(-gamma d2), with every sum
//   taken left to right. __fmul_rn / __fadd_rn keep nvcc from contracting
//   into FMAs the plain version does not have, and expf is the accurate
//   one (the build has no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuads = 32;  // threads along the columns, 4 columns each
constexpr int kRowLanes = 8;
constexpr int kRowsPerThread = 8;
constexpr int kMinBlocks = 264;  // two an SM of the H100's 132
constexpr int kMaxD = 16;

template <int D>
__device__ __forceinline__ float sq_norm(const float (&v)[D]) {
  float s = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int c = 1; c < D; ++c) s = __fadd_rn(s, __fmul_rn(v[c], v[c]));
  return s;
}

template <int D>
__global__ void __launch_bounds__(kQuads * kRowLanes)
    rbf_gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ out, int n, int m, int band, float neg_gamma) {
  const int b = blockIdx.z;
  const int j = 4 * (blockIdx.x * kQuads + threadIdx.x);
  if (j >= m) return;  // no barrier below
  const int ncol = min(4, m - j);
  const float* xb = x + (size_t)b * n * D;
  const float* yb = y + (size_t)b * m * D;

  float yv[4][D];
  float yy[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int jj = q < ncol ? j + q : j;  // past m: a copy of column j, never stored
#pragma unroll
    for (int c = 0; c < D; ++c) yv[q][c] = yb[(size_t)jj * D + c];
    yy[q] = sq_norm<D>(yv[q]);
  }

  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int i_end = min(n, ((int)blockIdx.y + 1) * band);
  for (int i = blockIdx.y * band + threadIdx.y; i < i_end; i += kRowLanes) {
    float xv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) xv[c] = __ldg(xb + (size_t)i * D + c);
    const float xx = sq_norm<D>(xv);
    float k[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float xy = __fmul_rn(xv[0], yv[q][0]);
#pragma unroll
      for (int c = 1; c < D; ++c) xy = __fadd_rn(xy, __fmul_rn(xv[c], yv[q][c]));
      float d2 = __fsub_rn(__fadd_rn(xx, yy[q]), __fmul_rn(2.0f, xy));
      d2 = fmaxf(d2, 0.0f);
      k[q] = expf(__fmul_rn(neg_gamma, d2));
    }
    const size_t off = ((size_t)b * n + i) * m + j;
    if (ncol == 4 && aligned && (off & 3) == 0) {
      __stcs(reinterpret_cast<float4*>(out + off), make_float4(k[0], k[1], k[2], k[3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < ncol) __stcs(out + off + q, k[q]);
    }
  }
}

template <int D>
void launch_d(const float* x, const float* y, float* out, int b, int n, int m,
              float neg_gamma, cudaStream_t stream) {
  const int col_blocks = (m + 4 * kQuads - 1) / (4 * kQuads);
  int band = kRowLanes * kRowsPerThread;  // rows a block
  while (band > kRowLanes &&
         (int64_t)col_blocks * ((n + band - 1) / band) * b < kMinBlocks)
    band /= 2;
  const dim3 block(kQuads, kRowLanes);
  const dim3 grid(col_blocks, (n + band - 1) / band, b);
  rbf_gram_kernel<D><<<grid, block, 0, stream>>>(x, y, out, n, m, band, neg_gamma);
}

}  // namespace

// x (b, n, d), y (b, m, d), out (b, n, m); all float32, contiguous, on
// `device`. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rbf_gram_launch(const void* x, const void* y, void* out, int b,
                               int n, int m, int d, float neg_gamma,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > kMaxD || b > 65535) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* yp = static_cast<const float*>(y);
  float* op = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
#define RBF_CASE(D) \
  case D: launch_d<D>(xp, yp, op, b, n, m, neg_gamma, s); break;
    RBF_CASE(1) RBF_CASE(2) RBF_CASE(3) RBF_CASE(4) RBF_CASE(5) RBF_CASE(6)
    RBF_CASE(7) RBF_CASE(8) RBF_CASE(9) RBF_CASE(10) RBF_CASE(11) RBF_CASE(12)
    RBF_CASE(13) RBF_CASE(14) RBF_CASE(15) RBF_CASE(16)
#undef RBF_CASE
  }
  return (int)cudaGetLastError();
}
