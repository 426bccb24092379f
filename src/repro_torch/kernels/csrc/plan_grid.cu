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
// and the engine's exact path). A point's step time, power and mask byte
// are loaded before T^k's branches: with the mask test written after them,
// nvcc issues the mask byte's load only once the branches reconverge, so
// each step of the row waits for two DRAM round trips one after the other
// (cuobjdump -sass for sm_90a). The grid is persistent: as many blocks as
// the SMs hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor, 8
// an SM on an H100), each warp walking rows, so no second wave of blocks
// trails the first (one block per 8 rows takes 1,250 blocks at B = 10^4,
// 194 past the 1,056 the SMs hold).
//
// pareto_mask -- what bounds it on an H100: bytes. Its t, e, mask and
// keep-set are 10 bytes a point, 35 MB at B = 10^4, G = 352, about 10.5 us
// at 3.35 TB/s. The function needs no more than a sort and a running
// minimum a row, as the engine's host pareto_frontier computes it: sort the
// row's points by (t, e, flat index) ascending, infeasible ones (masked, or
// t or e not finite) last; a feasible point is kept iff its e is strictly
// below the minimum e of every point before it. That is the reference's
// predicate exactly: an earlier point either has a smaller t, or the same t
// and a smaller e, or the same (t, e) and a lower index, so it beats p iff
// its e <= p's.
// Design (pareto_sort_kernel, G up to kSortMaxSlots): one warp a row, four
// rows a block. t and e are mapped to unsigned integers that order as the
// floats do (-0.0 first made +0.0, as the reference's == has them equal);
// an infeasible point gets t = e = 0xffffffff, above any finite value. The
// sort key is one 64-bit word, t above the flat index, so every key is
// distinct and a compare-exchange is one 64-bit compare and two selects
// (integer work: the sort's instruction count, not bytes, sets this
// kernel's time); e stays in shared memory at its flat index, gathered
// after the sort. The row's N = 32 R slots (R = 4 ..
// 32, N the next power of two at or above G; padding all ones) live in
// registers, R a lane, sorted position lane * R + r; the loads fill slot r
// of a lane with point 32 r + lane, so they are coalesced. A bitonic sort
// runs its strides below R inside a lane's registers and the strides from
// R up by xor shuffles (at N = 512: 30 register stages and 15 shuffle
// stages, about 11,500 compare-exchanges a row). Sorted by (t, index), a
// point p is kept iff feasible, e_p is below the minimum e of every point
// before it (earlier t, or the same t and a lower index), and e_p is at
// most the minimum e of the later points of the same t: the same rule.
// The first minimum is an exclusive min-scan (a lane's slots, then the
// lanes by shuffles); the second a backward walk within the lane and a
// segmented scan over the lanes of each lane's leading run of equal t. The
// keep flags go to shared memory at their flat index and out as
// consecutive bytes.
// Past kSortMaxSlots (pareto_pairs_kernel) one block of 256 threads a row
// tests all pairs, O(G^2): the row's t, e and feasibility are staged in
// shared memory in tiles of 1024 points, each thread owns the points p =
// tid, tid + 256, ..., and loops over all q of the tile with the predicate
// of the reference, index tie-break included; a point stops testing once it
// is dominated. kernels/plan_grid.py:pareto_plan picks the path from (B, G).
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
constexpr int kSortWarps = 4;  // rows a block of the sort path
constexpr int kSortMaxSlots = 1024;
constexpr uint32_t kLast = 0xffffffffu;  // above every finite value's key

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

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    plan_argmin_kernel(const float* __restrict__ t, const float* __restrict__ w,
                       const float* __restrict__ k, const uint8_t* __restrict__ mask,
                       int32_t* __restrict__ out, int B, int G, float time_floor) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarpsPerBlock;
  for (int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32; row < B; row += stride) {
    const float kr = k[row];
    const float* tr = t + (size_t)row * G;
    const uint8_t* mr = mask + (size_t)row * G;
    float best = INFINITY;
    int best_idx = G;  // a lane with no point (lane >= G) loses to any index
    for (int g = lane; g < G; g += 32) {
      // all three loads before T^k's branches (see the note at the top)
      const float tr_g = tr[g];
      const float w_g = w[g];
      const bool feasible = mr[g] != 0;
      // clamp_min's rule, not fmaxf's: a NaN step time stays NaN
      const float tt = tr_g < time_floor ? time_floor : tr_g;
      const float e = __fmul_rn(w_g, tt);
      const float metric = __fmul_rn(e, tpow(tt, kr));
      const float v = feasible ? metric : INFINITY;
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
}

__global__ void pareto_pairs_kernel(const float* __restrict__ t,
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

// a float as an unsigned key that orders as the float does, for finite
// values; -0.0 becomes +0.0 first (the reference's == has them equal)
__device__ __forceinline__ uint32_t ordered_key(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// one warp a row, R slots a lane (N = 32 R >= G); see the note at the top.
// The register budget: six blocks an SM up to R = 16 (at most 85 a thread;
// G = 352 runs at R = 16), one at R = 32 (so that it needs no spill)
template <int R>
__global__ void __launch_bounds__(kSortWarps * 32, R > 16 ? 1 : 6)
    pareto_sort_kernel(const float* __restrict__ t, const float* __restrict__ e,
                       const uint8_t* __restrict__ mask, uint8_t* __restrict__ out, int B,
                       int G) {
  constexpr int kLogN = R == 4 ? 7 : R == 8 ? 8 : R == 16 ? 9 : 10;
  static_assert(32 * R == 1 << kLogN, "R is 4, 8, 16 or 32");
  __shared__ uint32_t s_e[kSortWarps][32 * R];  // ordered e by flat index
  __shared__ uint8_t s_keep[kSortWarps][32 * R];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kSortWarps + warp;
  if (row >= B) return;  // uniform across the warp; the block never syncs
  const float* tr = t + (size_t)row * G;
  const float* er = e + (size_t)row * G;
  const uint8_t* mr = mask + (size_t)row * G;
  uint32_t* se = s_e[warp];

  // key: ordered t (kLast when infeasible) above the flat index; padding
  // slots all ones, after every point
  uint64_t a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = 32 * r + lane;
    a[r] = ~0ull;
    if (g < G) {
      const float tv = tr[g];
      const float ev = er[g];
      const bool feasible = mr[g] && isfinite(tv) && isfinite(ev);
      se[g] = feasible ? ordered_key(ev) : kLast;
      a[r] = ((uint64_t)(feasible ? ordered_key(tv) : kLast) << 32) | (uint32_t)g;
    }
  }

  // bitonic sort, ascending over positions lane * R + r: stage (k, j) pairs
  // position x with x ^ j, the smaller key first where x & k == 0
#pragma unroll
  for (int lk = 1; lk <= kLogN; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int k = 1 << lk;
      const int j = 1 << lj;
      if (j >= R) {  // the partner is slot r of lane ^ (j / R)
        const int lm = j / R;
        const bool take_min = ((lane & lm) == 0) == (((lane * R) & k) == 0);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint64_t o = __shfl_xor_sync(0xffffffffu, a[r], lm);
          if ((o < a[r]) == take_min) a[r] = o;
        }
      } else {  // the partner is slot r ^ j of this lane
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int q = r ^ j;
          if (q > r) {
            const bool up = ((lane * R + r) & k) == 0;
            const uint64_t x = a[r];
            const uint64_t y = a[q];
            const bool swap = (y < x) == up;
            a[r] = swap ? y : x;
            a[q] = swap ? x : y;
          }
        }
      }
    }
  }
  __syncwarp();  // the e stores above, before the gathers below

  // per slot: e, gathered by flat index; whether feasible, and whether the
  // next slot has the same t, as bits (the t halves of the keys die here)
  uint32_t ev[R];
  uint32_t feasible = 0u;
  uint32_t same_next = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t i = (uint32_t)a[r];
    const uint32_t tk = (uint32_t)(a[r] >> 32);
    ev[r] = i < (uint32_t)G ? se[i] : kLast;
    if (tk != kLast) feasible |= 1u << r;
    if (r + 1 < R && tk == (uint32_t)(a[r + 1] >> 32)) same_next |= 1u << r;
  }
  const uint32_t head_t = (uint32_t)(a[0] >> 32);
  const uint32_t tail_t = (uint32_t)(a[R - 1] >> 32);

  // the minimum e over the later points of the same t, per slot: within
  // the lane by a backward walk, from the lanes after it by a segmented
  // scan of each lane's leading run of equal t (min e over the run, and
  // whether it fills the lane, so that the run goes on into the next)
  const uint32_t head_run = same_next ^ (same_next + 1u);  // bits of slots 0 .. run end
  uint32_t head_min = ev[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if ((head_run >> r) & 1u) head_min = min(head_min, ev[r]);
  bool open = head_t == tail_t;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t next_t = __shfl_down_sync(0xffffffffu, head_t, off);
    const uint32_t next_min = __shfl_down_sync(0xffffffffu, head_min, off);
    const bool next_open = __shfl_down_sync(0xffffffffu, open, off);
    if (lane + off < 32 && open && next_t == head_t) {
      head_min = min(head_min, next_min);
      open = next_open;
    } else {
      open = false;
    }
  }
  const uint32_t next_t = __shfl_down_sync(0xffffffffu, head_t, 1);
  const uint32_t next_min = __shfl_down_sync(0xffffffffu, head_min, 1);
  uint32_t later = lane < 31 && next_t == tail_t ? next_min : kLast;
  uint32_t no_later_below = 0u;  // bit r: no later point of slot r's t has a smaller e
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    if (ev[r] <= later) no_later_below |= 1u << r;
    if (r > 0) later = ((same_next >> (r - 1)) & 1u) ? min(ev[r], later) : kLast;
  }

  // the minimum e over every earlier point: the lanes before this one (an
  // inclusive shuffle scan of the lanes' minima, shifted by one), then on
  // through this lane's slots
  uint32_t lane_min = kLast;
#pragma unroll
  for (int r = 0; r < R; ++r) lane_min = min(lane_min, ev[r]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(0xffffffffu, lane_min, off);
    if (lane >= off) lane_min = min(lane_min, o);
  }
  uint32_t earlier = __shfl_up_sync(0xffffffffu, lane_min, 1);
  if (lane == 0) earlier = kLast;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t i = (uint32_t)a[r];
    if (i < (uint32_t)G)
      s_keep[warp][i] = ((feasible & no_later_below) >> r) & 1u && ev[r] < earlier;
    earlier = min(earlier, ev[r]);
  }
  __syncwarp();
  uint8_t* orow = out + (size_t)row * G;
  for (int g = lane; g < G; g += 32) orow[g] = s_keep[warp][g];
}

}  // namespace

// t, mask (B, G); w (G,); k (B,); out (B,) int32, any G and alignment. The
// grid is the blocks the device's SMs hold at once, queried once a device
// (so that no query runs inside a CUDA-graph capture) and no more than the
// B rows need. Returns a cudaError_t.
extern "C" int plan_argmin_launch(const void* t, const void* w, const void* k,
                                  const void* mask, void* out, int B, int G,
                                  float time_floor, int device, void* stream) {
  constexpr int kDevices = 64;
  static int resident[kDevices];  // 0: not queried yet
  if (device < 0 || device >= kDevices) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plan_argmin_kernel,
                                                        kWarpsPerBlock * 32, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    resident[device] = per_sm * sms;
  }
  const int needed = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = needed < resident[device] ? needed : resident[device];
  plan_argmin_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)w, (const float*)k, (const uint8_t*)mask,
      (int32_t*)out, B, G, time_floor);
  return (int)cudaGetLastError();
}

// t, e, mask, out (B, G); out is bool (one byte, 0/1). `slots` picks the
// path: 128, 256, 512 or 1024 (>= G) the sort kernel with that many slots
// a row, 0 the all-pairs kernel. Returns cudaGetLastError().
extern "C" int pareto_mask_launch(const void* t, const void* e,
                                  const void* mask, void* out, int B, int G,
                                  int slots, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* tp = (const float*)t;
  const float* ep = (const float*)e;
  const uint8_t* mp = (const uint8_t*)mask;
  uint8_t* op = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (slots == 0) {
    pareto_pairs_kernel<<<B, kParetoThreads, 0, s>>>(tp, ep, mp, op, G);
    return (int)cudaGetLastError();
  }
  if (G > slots) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kSortWarps - 1) / kSortWarps;
  const int threads = kSortWarps * 32;
  switch (slots) {
    case 128: pareto_sort_kernel<4><<<blocks, threads, 0, s>>>(tp, ep, mp, op, B, G); break;
    case 256: pareto_sort_kernel<8><<<blocks, threads, 0, s>>>(tp, ep, mp, op, B, G); break;
    case 512: pareto_sort_kernel<16><<<blocks, threads, 0, s>>>(tp, ep, mp, op, B, G); break;
    case kSortMaxSlots:
      pareto_sort_kernel<32><<<blocks, threads, 0, s>>>(tp, ep, mp, op, B, G);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
