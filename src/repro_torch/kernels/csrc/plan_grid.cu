// The fused planning-grid sweep of the engine on Hopper: per-row masked
// objective argmin, and per-row Pareto keep-set.
//
// Replaces: src/repro/kernels/plan_grid.py:plan_argmin_pallas (body
// _plan_argmin_kernel) and src/repro/kernels/plan_grid.py:pareto_mask_pallas
// (body _pareto_mask_kernel).
//
// plan_argmin -- what bounds it on an H100: bytes. It reads t (B, G) f32 and
// the mask (B, G) u8 once and does about 5 flops a point: at B = 10^4,
// G = 352 that is 17.6 MB, about 5.3 us at 3.35 TB/s. Design: one warp per
// row, a lane walks the row with stride 32 (coalesced loads), keeps its
// first minimum, and the warp reduces (value, index) pairs with shuffles;
// equal values go to the lower index, so the result is the first flat
// minimum, np.argmin's rule. An all-masked row returns 0. A NaN step time
// stays NaN through the floor and a feasible NaN metric comes first, at its
// first index, as torch.argmin and np.argmin order NaN (the plain version
// and the engine's exact path).
//
// pareto_mask -- what bounds it on an H100: bytes. The function needs no
// more than a sort and a running minimum per row (O(G log G), as the
// engine's host pareto_frontier computes it); its t, e, mask and keep-set
// are 10 bytes a point, 35 MB at B = 10^4, G = 352, about 10.5 us at
// 3.35 TB/s. This kernel tests all pairs instead, up to 1.24e9 at that
// size with about 8 operations each (about 0.15 ms of fp32 issue), so it
// is far from the bound: a per-row sort in shared memory is the way to it
// (later work). Design: one block of 256
// threads per row; the row's t, e and feasibility (mask and finite) are
// staged in shared memory in tiles of 1024 points, each thread owns the
// points p = tid, tid + 256, ..., and loops over all q of the tile with the
// predicate of the reference, index tie-break included. A point stops
// testing once it is dominated.
//
// T^k: tpow() below returns 1 for k = 0, t for k = 1 and t*t for k = 2
// (powf otherwise, which the engine never asks for). kernels/ref.py and the
// engine's exact path compute T^k the same way, so the three agree bit for
// bit; a pow that is one ulp off would flip near-tie argmins.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kParetoThreads = 256;
constexpr int kParetoTile = 1024;

__device__ __forceinline__ float tpow(float t, float k) {
  if (k == 0.0f) return 1.0f;
  if (k == 1.0f) return t;
  if (k == 2.0f) return __fmul_rn(t, t);
  return powf(t, k);
}

// (v, i) comes before (b, bi) in torch.argmin's order: NaN first, then the
// smaller value, then, on equal values, the lower index
__device__ __forceinline__ bool argmin_before(float v, int i, float b, int bi) {
  const bool vn = isnan(v);
  const bool bn = isnan(b);
  if (vn != bn) return vn;
  if (vn || v == b) return i < bi;
  return v < b;
}

__global__ void plan_argmin_kernel(const float* __restrict__ t,
                                   const float* __restrict__ w,
                                   const float* __restrict__ k,
                                   const uint8_t* __restrict__ mask,
                                   int32_t* __restrict__ out, int B, int G,
                                   float time_floor) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // uniform across the warp
  const float kr = k[row];
  const float* tr = t + (size_t)row * G;
  const uint8_t* mr = mask + (size_t)row * G;
  float best = INFINITY;
  int best_idx = G;  // a lane with no point (lane >= G) loses to any index
  for (int g = lane; g < G; g += 32) {
    const float tr_g = tr[g];
    // clamp_min's rule, not fmaxf's: a NaN step time stays NaN
    const float tt = tr_g < time_floor ? time_floor : tr_g;
    const float e = __fmul_rn(w[g], tt);
    const float metric = __fmul_rn(e, tpow(tt, kr));
    const float v = mr[g] ? metric : INFINITY;
    if (argmin_before(v, g, best, best_idx)) {
      best = v;
      best_idx = g;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_idx, off);
    if (argmin_before(ob, oi, best, best_idx)) {
      best = ob;
      best_idx = oi;
    }
  }
  // every point of an all-masked row is +inf, so index 0 comes first
  if (lane == 0) out[row] = best_idx;
}

__global__ void pareto_mask_kernel(const float* __restrict__ t,
                                   const float* __restrict__ e,
                                   const uint8_t* __restrict__ mask,
                                   uint8_t* __restrict__ out, int G) {
  __shared__ float st[kParetoTile];
  __shared__ float se[kParetoTile];
  __shared__ uint8_t sf[kParetoTile];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* tr = t + (size_t)row * G;
  const float* er = e + (size_t)row * G;
  const uint8_t* mr = mask + (size_t)row * G;

  for (int p0 = 0; p0 < G; p0 += kParetoThreads) {
    const int p = p0 + tid;
    const bool valid = p < G;
    const float tp = valid ? tr[p] : 0.0f;
    const float ep = valid ? er[p] : 0.0f;
    const bool fp = valid && mr[p] && isfinite(tp) && isfinite(ep);
    bool dominated = false;
    for (int q0 = 0; q0 < G; q0 += kParetoTile) {
      const int nq = min(kParetoTile, G - q0);
      __syncthreads();  // the previous tile is no longer read
      for (int i = tid; i < nq; i += kParetoThreads) {
        const float tq = tr[q0 + i];
        const float eq = er[q0 + i];
        st[i] = tq;
        se[i] = eq;
        sf[i] = mr[q0 + i] && isfinite(tq) && isfinite(eq);
      }
      __syncthreads();
      if (fp && !dominated) {
        for (int j = 0; j < nq; ++j) {
          const float tq = st[j];
          const float eq = se[j];
          const bool beats =
              sf[j] && ((tq < tp && eq <= ep) || (tq == tp && eq < ep) ||
                        (tq == tp && eq == ep && q0 + j < p));
          if (beats) {
            dominated = true;
            break;
          }
        }
      }
    }
    if (valid) out[(size_t)row * G + p] = (fp && !dominated) ? 1 : 0;
  }
}

}  // namespace

// t, mask (B, G); w (G,); k (B,); out (B,) int32. Returns cudaGetLastError().
extern "C" int plan_argmin_launch(const void* t, const void* w, const void* k,
                                  const void* mask, void* out, int B, int G,
                                  float time_floor, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  plan_argmin_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)w, (const float*)k, (const uint8_t*)mask,
      (int32_t*)out, B, G, time_floor);
  return (int)cudaGetLastError();
}

// t, e, mask, out (B, G); out is bool (one byte, 0/1). Returns
// cudaGetLastError().
extern "C" int pareto_mask_launch(const void* t, const void* e,
                                  const void* mask, void* out, int B, int G,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pareto_mask_kernel<<<B, kParetoThreads, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)e, (const uint8_t*)mask, (uint8_t*)out, G);
  return (int)cudaGetLastError();
}
