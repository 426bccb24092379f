// Blockwise symmetric int8 codec of the gradient compression on Hopper:
// quantize a flat f32 vector to int8 with one f32 scale per 256 elements,
// and dequantize it back.
//
// Replaces: src/repro/kernels/int8_codec.py:int8_quantize_pallas (body
// _quant_kernel) and src/repro/kernels/int8_codec.py:int8_dequantize_pallas
// (body _dequant_kernel), with the contract of the reference's
// int8_quantize_ref / int8_dequantize_ref: n elements are padded with zeros
// to nb = ceil(n / 256) blocks (not to the Pallas wrapper's 64-block row
// groups), q has nb * 256 elements and scales nb.
//
// What bounds it on an H100: bytes. Quantize reads 4 bytes and writes 1 a
// element (plus 4 a block); dequantize reads 1 and writes 4. At the largest
// parameter of starcoder2-3b (the tied embedding, 150,994,944 elements)
// either one moves about 757 MB, 0.226 ms at 3.35 TB/s; the arithmetic (a
// division, a rounding, a clamp an element) is far below the fp32 rate.
//
// Design: quantize gives one warp to each 256-element block. A lane loads
// eight floats as two float4s (elements 4 lane .. 4 lane + 3 and 128 + 4 lane
// .. 128 + 4 lane + 3, so each load instruction of the warp covers 512
// contiguous bytes); the last, ragged block is loaded element by element
// with the tail masked to zeros. The block maximum of |x| is a butterfly of
// shuffles with a NaN-propagating maximum (fmaxf would drop a NaN and give
// the block a finite scale where the reference's jnp.max gives NaN, hence
// scale 1). scale = amax * f32(1/127) where amax > 0, else 1 (zero blocks
// and NaN blocks): the product with the reciprocal is what the reference
// computes for amax / 127 once XLA compiles it (in its Pallas kernel and in
// its jitted train step), one ulp off a true division in about 3% of
// blocks. q = clamp(rint(x / scale), -127, 127) with the division rounded
// to nearest (__fdiv_rn), rintf's half-to-even rounding (jnp.round's and
// torch.round's), and an explicit NaN test before the clamp: a NaN element,
// and every element of an inf block (x / inf is 0 or NaN), gives q = 0, as
// the plain version's isnan -> 0 (a float-to-int8 cast of NaN is not
// defined). Each lane stores two char4s, lane 0 the scale. Dequantize gives
// each thread four elements: a char4 read, the block's scale, and a float4
// write of q * scale into an output of exactly n elements (the tail element
// by element). Both equal the plain versions bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // elements a scale covers
constexpr int kWarpsPerCta = 8;
constexpr int kDequantThreads = 256;
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1/127), XLA's constant

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ signed char quant_one(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  if (isnan(r)) return 0;
  r = r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);
  return (signed char)__float2int_rn(r);
}

__global__ void int8_quantize_kernel(const float* __restrict__ x,
                                     signed char* __restrict__ q,
                                     float* __restrict__ scales, int64_t n,
                                     int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t blk = (int64_t)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= nb) return;  // uniform across the warp
  const int64_t base = blk * kBlock;
  float v[8];
  if (base + kBlock <= n) {
    const float4 a = *reinterpret_cast<const float4*>(x + base + 4 * lane);
    const float4 b = *reinterpret_cast<const float4*>(x + base + 128 + 4 * lane);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t i = base + (j < 4 ? 4 * lane + j : 128 + 4 * lane + (j - 4));
      v[j] = i < n ? x[i] : 0.0f;
    }
  }
  float amax = fabsf(v[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) amax = nan_max(amax, fabsf(v[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
  char4 lo, hi;
  lo.x = quant_one(v[0], scale); lo.y = quant_one(v[1], scale);
  lo.z = quant_one(v[2], scale); lo.w = quant_one(v[3], scale);
  hi.x = quant_one(v[4], scale); hi.y = quant_one(v[5], scale);
  hi.z = quant_one(v[6], scale); hi.w = quant_one(v[7], scale);
  *reinterpret_cast<char4*>(q + base + 4 * lane) = lo;
  *reinterpret_cast<char4*>(q + base + 128 + 4 * lane) = hi;
  if (lane == 0) scales[blk] = scale;
}

__global__ void int8_dequantize_kernel(const signed char* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ out, int64_t n) {
  const int64_t e = ((int64_t)blockIdx.x * kDequantThreads + threadIdx.x) * 4;
  if (e >= n) return;
  const char4 c = *reinterpret_cast<const char4*>(q + e);  // q holds nb * 256 >= n
  const float s = scales[e / kBlock];  // 4 | 256: the four share a block
  const float4 o = make_float4(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s),
                               __fmul_rn((float)c.z, s), __fmul_rn((float)c.w, s));
  if (e + 4 <= n) {
    *reinterpret_cast<float4*>(out + e) = o;
  } else {
    const float t[4] = {o.x, o.y, o.z, o.w};
    for (int j = 0; e + j < n; ++j) out[e + j] = t[j];
  }
}

}  // namespace

// x (n,) f32, 16-byte aligned; q (nb * 256,) int8; scales (nb,) f32, with
// nb = ceil(n / 256). Returns cudaGetLastError().
extern "C" int int8_quantize_launch(const void* x, void* q, void* scales, int64_t n,
                                    int64_t nb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t ctas = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  int8_quantize_kernel<<<(unsigned)ctas, kWarpsPerCta * 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, (signed char*)q, (float*)scales, n, nb);
  return (int)cudaGetLastError();
}

// q (nb * 256,) int8; scales (nb,) f32; out (n,) f32, 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int int8_dequantize_launch(const void* q, const void* scales, void* out,
                                      int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t quads = (n + 3) / 4;
  const int64_t ctas = (quads + kDequantThreads - 1) / kDequantThreads;
  int8_dequantize_kernel<<<(unsigned)ctas, kDequantThreads, 0, (cudaStream_t)stream>>>(
      (const signed char*)q, (const float*)scales, (float*)out, n);
  return (int)cudaGetLastError();
}
