// Flash attention forward on Hopper: online-softmax attention with causal,
// sliding-window and kv_len masks, grouped-query heads read by index.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas (body
// _flash_kernel), and the jnp decode path the reference takes when kv_len or
// q_offset is traced (src/repro/kernels/ops.py:flash_attention): here both
// are runtime launch arguments, so prefill and every decode step launch this
// kernel.
//
// What bounds it on an H100: at the prefill shape (b 8, H 24, Hk 2, S 1024,
// D 128, causal) operations: about 51.5 GFLOP of QK^T and PV against about
// 109 MB moved, so 0.052 ms at the bf16 tensor-core rate (989 TFLOP/s) and
// 0.77 ms at the fp32 FMA rate this kernel uses (67 TFLOP/s). At a decode
// step (one query row, kv_len about 1,056) bytes: the K/V cache of the two kv
// heads, about 8.7 MB, 2.6 us at 3.35 TB/s.
//
// Design (a first version that is right; no tensor cores yet):
// * GQA by indexing: query head h reads kv head h / (H / Hk). The reference
//   repeats K/V to H heads before its kernel (12x the reads for starcoder2);
//   here the query heads of one group read the same K/V rows, from L2.
// * Tile kernel (sq >= 16, prefill): one block per (b*h, 64-query tile),
//   256 threads, 4 threads per query row, each holding a quarter of the row's
//   q and of its f32 accumulator in registers. K/V tiles of 32 keys are
//   staged in shared memory as f32 (bf16 converted with __bfloat162float).
//   A thread's dims are float4 chunks part, part + 4, ... so the 4 threads of
//   a row read 64 contiguous bytes and the 8 rows of a warp read them as a
//   broadcast: no bank conflicts. A row's dot product is summed across its 4
//   threads with two xor shuffles. Per kv tile: scores for the 32 keys, the
//   masked max, p = exp(s - m) zeroed where masked, l and acc rescaled.
// * Only the kv tiles that the block's rows can see are visited: keys below
//   q_offset + q0 - window + 1 (window) and at or past min(kv_len,
//   q_offset + last row + 1) (causal) are never loaded, as the reference's
//   block-level early-out skips fully masked kv blocks.
// * Row kernel (sq < 16, decode): one query row has no reuse for a staged
//   tile, so one block per (query row, b*h) splits the keys over slots of
//   D/4 lanes (a lane holds 4 dims of q and of its slot's accumulator);
//   each slot walks keys slot, slot + nslots, ... four at a time (the four
//   K and V loads are started before the math), with its own running max and
//   sum, and the slots are merged through shared memory at the end. K/V rows
//   are read straight from global memory, coalesced along D.
// * Masking follows flash_attention.py:81-105: finite NEG_INF = -1e30, p = 0
//   where masked, l floored at 1e-30: a fully masked row gives 0.
// * Math in f32 (fmaf, the accurate expf); output in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTileQ = 64;
constexpr int kTileK = 32;
constexpr int kParts = 4;
constexpr int kTileThreads = kTileQ * kParts;  // 256
constexpr int kRowThreads = 256;
constexpr int kRowUnroll = 4;
constexpr int kRowKernelBelowSq = 16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hk, Sq, Skv;
  float scale;
  int causal, window, kv_len, q_offset;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  p[0] = from_f32<T>(v.x);
  p[1] = from_f32<T>(v.y);
  p[2] = from_f32<T>(v.z);
  p[3] = from_f32<T>(v.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpby4(float4 acc, float corr, float p, float4 v) {
  return make_float4(fmaf(p, v.x, acc.x * corr), fmaf(p, v.y, acc.y * corr),
                     fmaf(p, v.z, acc.z * corr), fmaf(p, v.w, acc.w * corr));
}

__device__ __forceinline__ bool allowed(const Params& p, int q_pos, int k_pos) {
  if (k_pos >= p.kv_len) return false;
  if (p.causal && q_pos < k_pos) return false;
  if (p.window > 0 && q_pos - k_pos >= p.window) return false;
  return true;
}

template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads)
    flash_tile_kernel(Params p) {
  constexpr int kVec = D / 4 / kParts;  // float4 chunks a thread holds
  __shared__ float4 sk[kTileK][D / 4];
  __shared__ float4 sv[kTileK][D / 4];

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hk);
  const int q0 = blockIdx.x * kTileQ;
  const int tid = threadIdx.x;
  const int row = tid / kParts;
  const int part = tid - row * kParts;
  const int qi = q0 + row;
  const int q_pos = p.q_offset + qi;
  const T* qb = static_cast<const T*>(p.q) + (size_t)bh * p.Sq * D;
  const size_t kv_base = (size_t)(b * p.Hk + hk) * p.Skv * D;
  const T* kb = static_cast<const T*>(p.k) + kv_base;
  const T* vb = static_cast<const T*>(p.v) + kv_base;

  float4 qr[kVec];
  float4 acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = 4 * (part + kParts * i);
    qr[i] = qi < p.Sq ? load4(qb + (size_t)qi * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(q0 + kTileQ, p.Sq) - 1;
  int k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, p.q_offset + q_last + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, p.q_offset + q0 - p.window + 1);

  for (int k0 = (k_lo / kTileK) * kTileK; k0 < k_hi; k0 += kTileK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kTileK * D; idx += kTileThreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < p.Skv) {
        kv = to_f32(kb[(size_t)kr * D + c]);
        vv = to_f32(vb[(size_t)kr * D + c]);
      }
      reinterpret_cast<float*>(sk[r])[c] = kv;
      reinterpret_cast<float*>(sv[r])[c] = vv;
    }
    __syncthreads();

    float s[kTileK];
    uint32_t ok_bits = 0u;
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      float part_sum = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) part_sum = dot4(qr[i], sk[j][part + kParts * i], part_sum);
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 1);
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 2);
      const bool ok = allowed(p, q_pos, k0 + j);
      ok_bits |= (ok ? 1u : 0u) << j;
      s[j] = ok ? part_sum * p.scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      s[j] = ((ok_bits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float4 a = make_float4(acc[i].x * corr, acc[i].y * corr, acc[i].z * corr, acc[i].w * corr);
#pragma unroll
      for (int j = 0; j < kTileK; ++j) a = axpby4(a, 1.f, s[j], sv[j][part + kParts * i]);
      acc[i] = a;
    }
    m = m_new;
  }

  if (qi < p.Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = static_cast<T*>(p.o) + (size_t)bh * p.Sq * D + (size_t)qi * D;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = 4 * (part + kParts * i);
      store4(ob + c, make_float4(acc[i].x / denom, acc[i].y / denom, acc[i].z / denom,
                                 acc[i].w / denom));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kRowThreads)
    flash_row_kernel(Params p) {
  constexpr int kLanes = D / 4;  // lanes of one slot, 4 dims each
  constexpr int kSlots = kRowThreads / kLanes;
  __shared__ float s_m[kSlots];
  __shared__ float s_l[kSlots];
  __shared__ float4 s_acc[kSlots][kLanes];

  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hk);
  const int slot = threadIdx.x / kLanes;
  const int lane = threadIdx.x - slot * kLanes;
  const int q_pos = p.q_offset + qi;
  const size_t kv_base = (size_t)(b * p.Hk + hk) * p.Skv * D;
  const T* kb = static_cast<const T*>(p.k) + kv_base + 4 * lane;
  const T* vb = static_cast<const T*>(p.v) + kv_base + 4 * lane;
  const float4 qr = load4(static_cast<const T*>(p.q) + ((size_t)bh * p.Sq + qi) * D + 4 * lane);

  int k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, q_pos + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, q_pos - p.window + 1);

  float m = kNegInf;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // the trip count is the same for every thread: the shuffles stay converged
  for (int kbase = k_lo; kbase < k_hi; kbase += kSlots * kRowUnroll) {
    float4 kk[kRowUnroll], vv[kRowUnroll];
    bool ok[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int kp = kbase + slot + u * kSlots;
      ok[u] = kp < k_hi && allowed(p, q_pos, kp);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      kk[u] = ok[u] ? load4(kb + (size_t)kp * D) : z;
      vv[u] = ok[u] ? load4(vb + (size_t)kp * D) : z;
    }
    float s[kRowUnroll];
    float m_cur = kNegInf;
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      float d = dot4(qr, kk[u], 0.f);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      s[u] = ok[u] ? d * p.scale : kNegInf;
      m_cur = fmaxf(m_cur, s[u]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    float4 a = make_float4(acc.x * corr, acc.y * corr, acc.z * corr, acc.w * corr);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const float pu = ok[u] ? expf(s[u] - m_new) : 0.f;
      psum += pu;
      a = axpby4(a, 1.f, pu, vv[u]);
    }
    l = l * corr + psum;
    acc = a;
    m = m_new;
  }

  if (lane == 0) {
    s_m[slot] = m;
    s_l[slot] = l;
  }
  s_acc[slot][lane] = acc;
  __syncthreads();
  if (threadIdx.x < kLanes) {
    float mx = kNegInf;
    for (int s = 0; s < kSlots; ++s) mx = fmaxf(mx, s_m[s]);
    float lt = 0.f;
    float4 at = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < kSlots; ++s) {
      const float w = expf(s_m[s] - mx);
      lt = fmaf(s_l[s], w, lt);
      at = axpby4(at, 1.f, w, s_acc[s][threadIdx.x]);
    }
    const float denom = fmaxf(lt, 1e-30f);
    T* ob = static_cast<T*>(p.o) + ((size_t)bh * p.Sq + qi) * D + 4 * threadIdx.x;
    store4(ob, make_float4(at.x / denom, at.y / denom, at.z / denom, at.w / denom));
  }
}

template <typename T, int D>
cudaError_t launch_typed(const Params& p, int bh, cudaStream_t stream) {
  if (p.Sq < kRowKernelBelowSq) {
    dim3 grid(p.Sq, bh);
    flash_row_kernel<T, D><<<grid, kRowThreads, 0, stream>>>(p);
  } else {
    dim3 grid((p.Sq + kTileQ - 1) / kTileQ, bh);
    flash_tile_kernel<T, D><<<grid, kTileThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Params& p, int d, int bh, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_typed<T, 16>(p, bh, stream);
    case 32: return launch_typed<T, 32>(p, bh, stream);
    case 64: return launch_typed<T, 64>(p, bh, stream);
    case 128: return launch_typed<T, 128>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o (b, h, sq, d); k, v (b, hk, skv, d); all contiguous, one dtype (f32
// when is_bf16 == 0, bf16 otherwise), on `device`. window <= 0 means none;
// keys at or past kv_len are masked; query i sits at position q_offset + i.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int h, int hk, int sq, int skv, int d,
                                      int is_bf16, float scale, int causal, int window,
                                      int kv_len, int q_offset, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || hk < 1 || h % hk != 0 || sq < 1 || skv < 1 || kv_len < 0 || kv_len > skv ||
      q_offset < 0 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, h, hk, sq, skv, scale, causal, window, kv_len, q_offset};
  cudaStream_t s = (cudaStream_t)stream;
  err = is_bf16 ? launch_dim<__nv_bfloat16>(p, d, b * h, s) : launch_dim<float>(p, d, b * h, s);
  return (int)err;
}
