// RBF Gram matrix on Hopper: K[b, i, j] = exp(-gamma * ||x[b, i] - y[b, j]||^2).
//
// Replaces: src/repro/kernels/rbf_gram.py:rbf_gram_pallas (body
// _rbf_gram_kernel), batched over a leading dim as ops.rbf_gram does.
//
// What bounds it on an H100: the output write. d is tiny (3 for the paper's
// (f, p, N) features, 2 for the engine's (f, cores) grid), so each output
// costs about 3d + 6 flops and 4 bytes: at the fit shape (4, 1760, 1760) the
// 49.6 MB write is about 15 us at 3.35 TB/s, against about 1 us of fp32 math.
//
// Design:
// * One block per 32 x 32 output tile of one batch item (grid.z = batch).
//   The block stages its 32 x rows and 32 y rows (d floats each, d <= 16) in
//   shared memory and computes ||x||^2 and ||y||^2 once per row. d is not
//   padded: the 128-lane padding of the TPU kernel has no meaning here.
// * 32 x 8 threads; a thread writes 4 outputs of one column, so a warp
//   writes 32 consecutive floats of a row: coalesced along m.
// * The arithmetic is the plain version's (kernels/ref.py), term by term:
//   xx + yy - 2 xy, clamped at 0, then expf(-gamma d2), with every sum
//   taken left to right. __fmul_rn / __fadd_rn keep nvcc from contracting
//   into FMAs the plain version does not have, and expf is the accurate
//   one (the build has no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;
constexpr int kMaxD = 16;

__global__ void rbf_gram_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                float* __restrict__ out, int n, int m, int d,
                                float neg_gamma) {
  __shared__ float sx[kTile][kMaxD + 1];
  __shared__ float sy[kTile][kMaxD + 1];
  __shared__ float sxx[kTile];
  __shared__ float syy[kTile];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const float* xb = x + (size_t)b * n * d;
  const float* yb = y + (size_t)b * m * d;
  float* ob = out + (size_t)b * n * m;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kRowsPerPass;

  for (int idx = tid; idx < kTile * d; idx += nthreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    sx[r][c] = (i0 + r < n) ? xb[(size_t)(i0 + r) * d + c] : 0.0f;
    sy[r][c] = (j0 + r < m) ? yb[(size_t)(j0 + r) * d + c] : 0.0f;
  }
  __syncthreads();

  if (tid < kTile) {
    float s = __fmul_rn(sx[tid][0], sx[tid][0]);
    for (int c = 1; c < d; ++c) s = __fadd_rn(s, __fmul_rn(sx[tid][c], sx[tid][c]));
    sxx[tid] = s;
  } else if (tid < 2 * kTile) {
    const int r = tid - kTile;
    float s = __fmul_rn(sy[r][0], sy[r][0]);
    for (int c = 1; c < d; ++c) s = __fadd_rn(s, __fmul_rn(sy[r][c], sy[r][c]));
    syy[r] = s;
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int j = j0 + tx;
  if (j >= m) return;
  for (int r = threadIdx.y; r < kTile; r += kRowsPerPass) {
    const int i = i0 + r;
    if (i >= n) break;
    float xy = __fmul_rn(sx[r][0], sy[tx][0]);
    for (int c = 1; c < d; ++c) xy = __fadd_rn(xy, __fmul_rn(sx[r][c], sy[tx][c]));
    float d2 = __fsub_rn(__fadd_rn(sxx[r], syy[tx]), __fmul_rn(2.0f, xy));
    d2 = fmaxf(d2, 0.0f);
    ob[(size_t)i * m + j] = expf(__fmul_rn(neg_gamma, d2));
  }
}

}  // namespace

// x (b, n, d), y (b, m, d), out (b, n, m); all float32, contiguous, on
// `device`. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rbf_gram_launch(const void* x, const void* y, void* out, int b,
                               int n, int m, int d, float neg_gamma,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  dim3 block(kTile, kRowsPerPass);
  dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, b);
  rbf_gram_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)out, n, m, d, neg_gamma);
  return (int)cudaGetLastError();
}
