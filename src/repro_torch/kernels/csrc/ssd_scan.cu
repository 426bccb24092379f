// Mamba2 SSD intra-chunk block on Hopper (state-space duality, arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan.py:ssd_chunks_pallas (body
// _ssd_chunk_kernel). For one (b*h, chunk) of T steps it computes
//   a_cum = cumsum(a)                         (a = dt * A, log decays)
//   L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j, else 0
//   M = (C B^T) * L * dt[j];  y_intra = M x
//   states = (B * exp(a_cum[T-1] - a_cum) * dt)^T x
//   c_decay = C * exp(a_cum);  chunk_decay = exp(a_cum[T-1])
// The inter-chunk recurrence and the state-output product stay in the
// wrapper as torch ops (kernels/ops.py:ssd_scan_chunked), as in the
// reference.
//
// What bounds it on an H100: operations. At the mamba2-130m prefill shape
// (b*h 192, 8 chunks, T 128, p 64, n 128) a chunk needs, on the causal
// triangle of T(T+1)/2 pairs, tri*n (C B^T) + tri*p (M x) multiply-adds,
// plus T*n*p (states): 8.1 GFLOP a call in all, 0.121 ms at the fp32 rate
// of 67 TFLOP/s (the reference asks for f32 dot products), against about
// 261 MB moved (0.078 ms at 3.35 TB/s).
//
// Design (a first version that is right; no tensor cores yet):
// * One block of 256 threads per (chunk, b*h). B and C are read per group
//   (head h of H reads group h / (H / G) of the (b, S, G, n) inputs): the
//   reference repeats them to H heads first.
// * The block stages B and C transposed (n-major, row stride T + 4) and x
//   (T-major) in shared memory as f32; rows and columns are zero-padded to
//   multiples of 4, so every product below runs over float4 micro-tiles of
//   4 x 4 outputs per thread: two 16-byte shared loads feed 16 FMAs.
// * a_cum is a block-level inclusive scan (Hillis-Steele) in shared memory.
// * B, C, x and the whole T x T matrix M do not fit in 227 KB together at
//   T = n = 128, p = 64, so M is built 64 rows at a time (rows i0..i0+63
//   need only columns j < i0 + 64), stored transposed, and consumed by the
//   y_intra product before the next row tile: 202,240 bytes of shared memory
//   in all at that shape, one block per SM.
// * c_decay is written while C is staged; all math is f32 with fmaf and the
//   accurate expf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 64;
constexpr int kMaxT = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxSmemBytes = 232448;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__host__ __device__ __forceinline__ size_t smem_floats(int T, int n, int p) {
  const int Tp = round4(T);
  return (size_t)2 * round4(n) * (Tp + 4) + (size_t)Tp * round4(p) + (size_t)Tp * kRowTile +
         (size_t)3 * Tp;
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ B,
                     const float* __restrict__ C, float* __restrict__ y,
                     float* __restrict__ states, float* __restrict__ c_decay,
                     float* __restrict__ chunk_decay, int H, int G, int nc, int T, int P,
                     int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Tp = round4(T), n4 = round4(N), p4 = round4(P), ld = Tp + 4;
  float* bt = smem;                  // [n4][ld]  B transposed
  float* ct = bt + (size_t)n4 * ld;  // [n4][ld]  C transposed
  float* xs = ct + (size_t)n4 * ld;  // [Tp][p4]
  float* mt = xs + (size_t)Tp * p4;  // [Tp][kRowTile]  one row tile of M, transposed
  float* acum = mt + (size_t)Tp * kRowTile;
  float* dts = acum + Tp;
  float* w = dts + Tp;  // exp(a_cum[T-1] - a_cum) * dt

  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / H;
  const int gi = (bh - bi * H) / (H / G);
  const int tid = threadIdx.x;
  const size_t chunk_id = (size_t)bh * nc + c;

  for (int t = tid; t < Tp; t += kThreads) {
    dts[t] = t < T ? dt[chunk_id * T + t] : 0.f;
    acum[t] = t < T ? a[chunk_id * T + t] : 0.f;
  }
  __syncthreads();
  for (int off = 1; off < Tp; off <<= 1) {
    float v = 0.f;
    if (tid < Tp && tid >= off) v = acum[tid - off];
    __syncthreads();
    if (tid < Tp) acum[tid] += v;
    __syncthreads();
  }
  const float a_last = acum[T - 1];
  for (int t = tid; t < Tp; t += kThreads) w[t] = t < T ? expf(a_last - acum[t]) * dts[t] : 0.f;
  if (tid == 0) chunk_decay[chunk_id] = expf(a_last);

  // B, C rows t of this chunk and group: (b, nc*T, G, N) row-major
  const size_t row_stride = (size_t)G * N;
  const size_t bc_base = ((size_t)bi * nc * T + (size_t)c * T) * row_stride + (size_t)gi * N;
  for (int idx = tid; idx < Tp * n4; idx += kThreads) {
    const int t = idx / n4;
    const int k = idx - t * n4;
    float bv = 0.f, cv = 0.f;
    if (t < T && k < N) {
      bv = B[bc_base + t * row_stride + k];
      cv = C[bc_base + t * row_stride + k];
      c_decay[(chunk_id * T + t) * N + k] = cv * expf(acum[t]);
    }
    bt[k * ld + t] = bv;
    ct[k * ld + t] = cv;
  }
  for (int idx = tid; idx < Tp * p4; idx += kThreads) {
    const int t = idx / p4;
    const int q = idx - t * p4;
    xs[idx] = (t < T && q < P) ? x[(chunk_id * T + t) * P + q] : 0.f;
  }
  __syncthreads();

  // y_intra, one tile of kRowTile rows at a time
  const int mq = p4 / 4;
  for (int i0 = 0; i0 < Tp; i0 += kRowTile) {
    const int rows = min(kRowTile, Tp - i0);
    const int mi = rows / 4;
    const int jmax = i0 + rows;  // causal: row i needs j <= i only
    const int mj = jmax / 4;
    for (int u = tid; u < mi * mj; u += kThreads) {
      const int ui = u % mi;
      const int uj = u / mi;
      const int ib = i0 + 4 * ui;
      const int jb = 4 * uj;
      float cb[4][4] = {};
      for (int k = 0; k < n4; ++k)
        fma4x4(cb, *reinterpret_cast<const float4*>(ct + k * ld + ib),
               *reinterpret_cast<const float4*>(bt + k * ld + jb));
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = jb + cc;
        float mv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ib + r;
          mv[r] = i >= j ? cb[r][cc] * expf(acum[i] - acum[j]) * dts[j] : 0.f;
        }
        *reinterpret_cast<float4*>(mt + j * kRowTile + 4 * ui) =
            make_float4(mv[0], mv[1], mv[2], mv[3]);
      }
    }
    __syncthreads();
    for (int u = tid; u < mi * mq; u += kThreads) {
      const int uq = u % mq;
      const int ui = u / mq;
      const int qb = 4 * uq;
      float acc[4][4] = {};
      for (int j = 0; j < jmax; ++j)
        fma4x4(acc, *reinterpret_cast<const float4*>(mt + j * kRowTile + 4 * ui),
               *reinterpret_cast<const float4*>(xs + j * p4 + qb));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * ui + r;
        if (i >= T) continue;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          if (qb + cc < P) y[(chunk_id * T + i) * P + qb + cc] = acc[r][cc];
      }
    }
    __syncthreads();  // mt is rewritten by the next row tile
  }

  // chunk state: states[k, q] = sum_t B[t, k] w[t] x[t, q]
  for (int u = tid; u < (n4 / 4) * mq; u += kThreads) {
    const int uq = u % mq;
    const int kb = 4 * (u / mq);
    const int qb = 4 * uq;
    float acc[4][4] = {};
    for (int t = 0; t < Tp; ++t) {
      const float wt = w[t];
      const float4 bw = make_float4(bt[kb * ld + t] * wt, bt[(kb + 1) * ld + t] * wt,
                                    bt[(kb + 2) * ld + t] * wt, bt[(kb + 3) * ld + t] * wt);
      fma4x4(acc, bw, *reinterpret_cast<const float4*>(xs + t * p4 + qb));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kb + r;
      if (k >= N) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (qb + cc < P) states[(chunk_id * N + k) * P + qb + cc] = acc[r][cc];
    }
  }
}

}  // namespace

// x (b*h, nc, T, P), dt and a (b*h, nc, T), B and C (b, nc*T, G, N); outputs
// y (b*h, nc, T, P), states (b*h, nc, N, P), c_decay (b*h, nc, T, N),
// chunk_decay (b*h, nc). All float32, contiguous, on `device`. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_chunks_launch(const void* x, const void* dt, const void* a, const void* B,
                                 const void* C, void* y, void* states, void* c_decay,
                                 void* chunk_decay, int b, int h, int g, int nc, int T, int P,
                                 int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || g < 1 || h % g != 0 || nc < 1 || T < 1 || T > kMaxT || N < 1 || N > kMaxN ||
      P < 1 || P > kMaxP || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(T, N, P) * sizeof(float);
  if (bytes > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // once per device, so that a launch captured in a CUDA graph makes no
  // other runtime call than the launch itself
  static bool smem_opt_in[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_opt_in[device]) {
    err = cudaFuncSetAttribute(ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_opt_in[device] = true;
  }
  dim3 grid(nc, b * h);
  ssd_chunk_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)B, (const float*)C,
      (float*)y, (float*)states, (float*)c_decay, (float*)chunk_decay, h, g, nc, T, P, N);
  return (int)cudaGetLastError();
}
