// Attention backward on Hopper, bf16: dq, dk and dv of softmax(q k^T * scale)
// v with the causal, sliding-window and kv_len masks and the grouped-query
// heads of csrc/flash_attention.cu, from the forward's output and its
// log-sum-exp.
//
// Replaces no TPU kernel: the reference's backward is jnp, the chunked
// recompute of src/repro/kernels/ops.py:_flash_vjp (flash_attention_bwd_ref
// in src/repro/kernels/ref.py). The port ran its plain PyTorch copy
// (kernels/ref.py:flash_attention_bwd_ref) on the card: f32 products with
// TF32 off, 512 x 512 blocks stepped through by the host, the causally
// masked half included, 1.65 s of starcoder2-3b's 2.9 s training step.
//
// What bounds it on an H100 (989 TFLOP/s bf16 on the tensor cores, 3.35
// TB/s): operations. At starcoder2-3b's training shape (b 2, H 24, Hk 2, S
// 4,096, D 128, causal) the four products dV = P^T dO, dP = dO V^T, dQ = dS
// K and dK = dS^T Q over the causal pairs are 412 GFLOP, 0.42 ms; with S =
// Q K^T recomputed, 515 GFLOP, 0.52 ms. The bytes (q, k, v, out, dout read,
// dq, dk, dv written, about 0.22 GB with dq's f32 sums) take 0.07 ms.
//
// Design (FlashAttention-2's backward, laid out as FlashAttention-3's on
// Hopper's wgmma):
// * attn_bwd_prep_kernel: a warp a query row computes D = rowsum(dO o O) in
//   f32 and lse2 = lse * log2(e) (+inf for a row with no key, and for the
//   padding rows up to a whole 64-row tile, so that their P is 0).
// * attn_bwd_kernel: a block owns 128 keys of one (b, query head), two
//   warpgroups (256 threads) 64 keys each: K and V stay in shared memory,
//   and the block walks the 64-row query tiles that see a key of its tile,
//   Q, dO, lse2 and D of the next tile loaded by cp.async while this one
//   is computed (two stages), each tile read once for both warpgroups. Per
//   query tile, on the tensor cores (bf16 in, f32 sums), each warpgroup:
//   - S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries each): both
//     operands from shared memory through 128-byte swizzled descriptors,
//     the forward's layout, with the roles of its Q and K swapped;
//   - P^T = exp2(S^T * scale log2(e) - lse2) and dS^T = P^T o (dP^T - D)
//     in registers; masks only on tiles that cross the diagonal, the
//     window's edge or kv_len; tiles no query sees are never visited;
//   - dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A
//     operands (the S accumulator's fragment is an A fragment) and dO, Q
//     as MN-major B operands (the forward's V layout); dV and dK stay in
//     f32 registers for the whole walk (223 registers a thread at d 128,
//     no spill);
//   - dS goes to shared memory as bf16 in the [query][key] layout of a
//     K-major A operand; each warpgroup then computes 64 columns of dQ =
//     dS K over all 128 keys (32 f32 a thread), writes them to an f32
//     staging tile, and 64 threads add its rows into an f32 scratch dq by
//     TMA bulk reduce-add (cp.reduce.async.bulk), which the L2 applies
//     while the next tile is computed. Measured at the training shape on an
//     H100, dQ's sums by per-thread float2 atomics from one warpgroup of 64
//     keys took 1.0 of 2.6 ms; a second kernel a query tile would compute
//     S and dP again (seven products for five).
//   P and dS are rounded to bf16 only as operands of the dV, dK and dQ
//   products, as FlashAttention does; lse, D and every sum stay f32.
// * Load balance: the group's query heads are split across blocks, so the
//   grid is (key tile, b, query head): 32 x 48 = 1,536 blocks at the
//   training shape, one an SM (184,320 bytes of shared memory). Under the
//   causal mask key tile 0 sees every query tile and the last one a
//   single tile, so blocks are numbered key tile first: the longest blocks
//   start in the first waves. Each warpgroup adds its partial dK and dV
//   (one query head's share of the group's sum) into f32 scratch with
//   float2 atomics, once a block.
// * attn_bwd_convert_kernel: the f32 scratch to bf16, dq and dk times the
//   scale (folded out of dS).
// * Head dims 16, 32, 64 and 128 (16 and 32 zero-padded to 64 in shared
//   memory; up to 64 the first warpgroup computes dQ alone); the wrapper
//   pads 96 and 112 to 128 and keeps the true d's scale. f32 inputs and
//   d 256 take the plain backward (kernels/ops.py).
// * No --use_fast_math: exp2f is the accurate one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;      // query rows a step, keys a warpgroup: one warpgroup's rows
constexpr int kBlockK = 128;   // keys a block: two warpgroups
constexpr int kThreads = 256;
constexpr int kPrepRows = 8;  // rows a prep block: a warp each
constexpr int kMaxDevices = 64;

struct BwdParams {
  const bf16* q;     // (b, h, sq, D)
  const bf16* k;     // (b, hk, skv, D)
  const bf16* v;
  const bf16* dout;  // (b, h, sq, D)
  const float* lse2;   // (b, h, sq_pad)
  const float* delta;  // (b, h, sq_pad)
  float* dq;  // (b, h, sq, D) f32 sums
  float* dk;  // (b, hk, skv, D) f32 sums
  float* dv;
  int H, Hk, Sq, Skv, SqPad, BH;
  float c;  // scale * log2(e)
  int causal, window, kv_len, q_offset;
};

__device__ __forceinline__ bool allowed(const BwdParams& p, int q_pos, int k_pos) {
  if (k_pos >= p.kv_len) return false;
  if (p.causal && q_pos < k_pos) return false;
  if (p.window > 0 && q_pos - k_pos >= p.window) return false;
  return true;
}

// ---------------------------------------------------------------------------
// shared-memory copies and tensor-core instructions
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's shared-memory writes visible to wgmma's (async) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous region (from the wgmma instruction to wgmma_wait_all)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

#define BWD_ACC32_OUT                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define BWD_REGS32                                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

// D (64 x 64) = A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major);
// the first k step overwrites (accumulate == 0), the rest add
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" BWD_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : BWD_ACC32_OUT
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the same with B MN-major (the transpose bit of 16-bit types)
__device__ __forceinline__ void wgmma_ss_m64n64_bt(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" BWD_REGS32
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : BWD_ACC32_OUT
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, registers) * B (16 x 64 MN-major, shared)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" BWD_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : BWD_ACC32_OUT
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128) += A (64 x 16, registers) * B (16 x 128 MN-major, shared)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int DP>
struct RS;
template <>
struct RS<64> {
  static __device__ __forceinline__ void run(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    wgmma_rs_m64n64(o, a, desc);
  }
};
template <>
struct RS<128> {
  static __device__ __forceinline__ void run(float (&o)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    wgmma_rs_m64n128(o, a, desc);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of the main kernel: two 64-key tiles each of K and V, two
// stages of Q and dO (each tile a [64][DP] bf16 matrix stored as DP/64
// swizzle atoms of [64][64]: 128-byte rows whose 16-byte chunks are permuted
// by chunk ^ (row % 8), wgmma's 128-byte swizzle, on 1024-byte boundaries),
// dS ([64 queries][128 keys], an atom per warpgroup's keys), dQ's f32 rows
// for the bulk reduction ([64][D + 8]: the 8 floats of padding put the rows
// of a warp's stores on distinct banks), and two stages of lse2 and D.
template <int D>
struct BwdTile {
  static constexpr int kDP = D < 64 ? 64 : D;  // width in shared memory
  static constexpr int kAtom = 64 * 128;
  static constexpr int kMat = kAtom * (kDP / 64);
  static constexpr int kRowF = D + 8;  // floats a row of dQ's staging
  static constexpr int kK = 0, kV = 2 * kMat, kQ = 4 * kMat, kDO = 6 * kMat;  // + stage kMat
  static constexpr int kDS = 8 * kMat;
  static constexpr int kDQ = kDS + 2 * kAtom;
  static constexpr int kStats = kDQ + kTile * kRowF * 4;  // stage st: lse2, D at + 512 st
  static constexpr int kSmem = kStats + 2 * 2 * kTile * 4 + 1024;  // + alignment
};

// rows [row0, row0 + 64) of a (n, D) bf16 matrix into a swizzled [64][DP]
// tile; rows at or past n are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst, const bf16* src, int row0, int n,
                                                int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int cc = idx - r * kChunks;
    const bool ok = row0 + r < n;
    const bf16* g = src + (size_t)(ok ? row0 + r : 0) * D + cc * 8;
    cp_async16(dst + (cc >> 3) * BwdTile<D>::kAtom + r * 128 + (((cc & 7) ^ (r & 7)) << 4), g,
               ok);
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// a warp a row of (b * h, sq_pad): D = sum over d of dO * O in f32, and
// lse2 = lse * log2(e), +inf where lse is -inf (no key) or past sq
__global__ void __launch_bounds__(32 * kPrepRows)
    attn_bwd_prep_kernel(const bf16* o, const bf16* dout, const float* lse, float* lse2,
                         float* delta, int sq, int sq_pad, int d, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * kPrepRows + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t bh = row / sq_pad;
  const int i = (int)(row - bh * sq_pad);
  float acc = 0.f;
  float l = -INFINITY;
  if (i < sq) {
    const size_t at = (size_t)bh * sq + i;
    const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(o + at * d);
    const __nv_bfloat162* grow = reinterpret_cast<const __nv_bfloat162*>(dout + at * d);
    for (int c = lane; c < d / 2; c += 32) {
      const float2 a = __bfloat1622float2(orow[c]);
      const float2 g = __bfloat1622float2(grow[c]);
      acc = fmaf(a.x, g.x, acc);
      acc = fmaf(a.y, g.y, acc);
    }
    l = lse[at];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = l == -INFINITY ? INFINITY : l * kLog2e;
  }
}

__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src, int bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the bulk reductions this thread issued have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// one block a (128-key tile, b * h), a warpgroup a 64-key half: see the
// file's note
template <int D>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_kernel(BwdParams p) {
  using T = BwdTile<D>;
  constexpr int DP = T::kDP;
  constexpr int kAtom = T::kAtom;
  constexpr int kMat = T::kMat;
  constexpr int NA = DP / 2;  // dK and dV accumulators a thread
  extern __shared__ __align__(1024) uint8_t smem_bwd[];
  const uint32_t base = (smem_u32(smem_bwd) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_bwd + (base - smem_u32(smem_bwd));
  const float* const stats = reinterpret_cast<const float*>(base_ptr + T::kStats);
  float* const dq_stage = reinterpret_cast<float*>(base_ptr + T::kDQ);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroup: keys 64 wg .. 64 wg + 63 of the block's tile
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int jt = blockIdx.x / p.BH;  // key tile first: the longest blocks lead
  const int bh = blockIdx.x - jt * p.BH;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hk);
  const int k0 = jt * kBlockK;
  if (k0 >= p.kv_len) return;

  // the query rows that see a key of this tile
  const int k_last = min(k0 + kBlockK, p.kv_len) - 1;
  const int q_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k_last + p.window - p.q_offset) : p.Sq;
  if (q_lo >= q_hi) return;
  const int t_lo = q_lo / kTile;
  const int nt = (q_hi + kTile - 1) / kTile - t_lo;

  const bf16* qb = p.q + (size_t)bh * p.Sq * D;
  const bf16* dob = p.dout + (size_t)bh * p.Sq * D;
  const size_t kv_base = (size_t)(b * p.Hk + hk) * p.Skv * D;
  const float* lse2b = p.lse2 + (size_t)bh * p.SqPad;
  const float* deltab = p.delta + (size_t)bh * p.SqPad;
  float* dqb = p.dq + (size_t)bh * p.Sq * D;

  if (D < 64) {  // zero the padding columns once; cp.async never writes them
    for (int i = tid * 16; i < T::kDS; i += kThreads * 16)
      *reinterpret_cast<uint4*>(base_ptr + i) = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  auto load_stage = [&](int st, int qt) {
    const int q0 = qt * kTile;
    load_tile_sw128<D>(base + T::kQ + st * kMat, qb, q0, p.Sq, tid);
    load_tile_sw128<D>(base + T::kDO + st * kMat, dob, q0, p.Sq, tid);
    if (tid < 32) {  // 16 chunks of lse2, then 16 of D
      const float* src = (tid < 16 ? lse2b : deltab) + q0 + 4 * (tid & 15);
      cp_async16(base + T::kStats + st * 512 + (tid < 16 ? 0 : 256) + 16 * (tid & 15), src,
                 true);
    }
  };

  for (int half = 0; half < 2; ++half) {
    load_tile_sw128<D>(base + T::kK + half * kMat, p.k + kv_base, k0 + half * kTile, p.Skv, tid);
    load_tile_sw128<D>(base + T::kV + half * kMat, p.v + kv_base, k0 + half * kTile, p.Skv, tid);
  }
  load_stage(0, t_lo);
  cp_async_commit();

  // this warpgroup's tiles of K and V; this thread's rows of its (key-row)
  // accumulators: keys kp0 and kp1 = kp0 + 8
  const uint32_t s_kw = base + T::kK + wg * kMat;
  const uint32_t s_vw = base + T::kV + wg * kMat;
  const int kw0 = k0 + wg * kTile;
  const int r0 = 16 * warp + g;
  const int kp0 = kw0 + r0;
  const int kp1 = kp0 + 8;
  // dQ's 64-column slice of this warpgroup (at DP = 64 the first computes it all)
  const bool dq_slice = DP == 128 || wg == 0;
  float dv[NA], dk[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    dv[i] = 0.f;
    dk[i] = 0.f;
  }

  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    if (it + 1 < nt) {  // the next tile's copy overlaps this tile's math
      load_stage(st ^ 1, t_lo + it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t s_q = base + T::kQ + st * kMat;
    const uint32_t s_do = base + T::kDO + st * kMat;
    const int q0 = (t_lo + it) * kTile;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, DP / 16 k steps
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
      wgmma_ss_m64n64(s, sw128_desc(s_kw + off, 16, 1024), sw128_desc(s_q + off, 16, 1024),
                      kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
      wgmma_ss_m64n64(dp, sw128_desc(s_vw + off, 16, 1024), sw128_desc(s_do + off, 16, 1024),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place; element 4 j + 2 hf + e is key r0 + 8 hf of the
    // warpgroup's tile, query q0 + 8 j + 2 t4 + e
    const bool edge = kw0 + kTile > p.kv_len ||
                      (p.causal && kw0 + kTile - 1 > p.q_offset + q0) ||
                      (p.window > 0 && p.q_offset + q0 + kTile - 1 - kw0 >= p.window);
    const float* lse_s = stats + st * 128;
    const float* delta_s = lse_s + 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dd = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float le = e ? l2.y : l2.x;
        const float de = e ? dd.y : dd.x;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * j + 2 * hf + e;
          float x = exp2f(fmaf(s[i], p.c, -le));
          if (edge && !allowed(p, p.q_offset + q0 + col + e, hf ? kp1 : kp0)) x = 0.f;
          s[i] = x;
          dp[i] = x * (dp[i] - de);
        }
      }
    }

    // dS to shared memory for dQ: (key r, query c) at [c][64 wg + r], swizzled
    uint8_t* const ds_ptr = base_ptr + T::kDS + wg * kAtom;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + 8 * hf;
          *reinterpret_cast<bf16*>(ds_ptr + c * 128 + (((r >> 3) ^ (c & 7)) << 4) +
                                   (r & 7) * 2) = __float2bfloat16(dp[4 * j + 2 * hf + e]);
        }
      }
    }

    // P^T and dS^T as A fragments: k step kk holds queries 16 kk .. 16 kk + 15
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }
    }
    fence_proxy_async();  // dS's stores, before wgmma reads them
    if (tid < kTile) bulk_wait_read();  // the last tile's dQ rows have left the staging
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q (dO and Q rows 16 kk .. 16 kk + 15 as
    // MN-major B: two 8-row groups, SBO 1024; atoms of 64 columns, LBO), and
    // this warpgroup's 64 columns of dQ = dS K over the block's 128 keys (A
    // = dS, [query][key] K-major, an atom per 64 keys; B = K rows, MN-major;
    // the accumulator's rows are queries), in one group
    float a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a[i] = 0.f;
    fence_regs(a);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      RS<DP>::run(dv, pa[kk], sw128_desc(s_do + kk * 16 * 128, kAtom, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      RS<DP>::run(dk, da[kk], sw128_desc(s_q + kk * 16 * 128, kAtom, 1024));
    if (dq_slice) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_ss_m64n64_bt(a, sw128_desc(base + T::kDS + (kk >> 2) * kAtom + (kk & 3) * 32, 16,
                                         1024),
                           sw128_desc(base + T::kK + (kk >> 2) * kMat + wg * kAtom +
                                          (kk & 3) * 16 * 128,
                                      kAtom, 1024),
                           kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(a);
    fence_regs(dv);
    fence_regs(dk);

    // dQ's rows to the staging, then one bulk reduction a row into dq
    if (dq_slice) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (DP == 128 ? 64 * wg : 0) + 8 * j + 2 * t4;
        if (col < D) {
          *reinterpret_cast<float2*>(dq_stage + r0 * T::kRowF + col) =
              make_float2(a[4 * j], a[4 * j + 1]);
          *reinterpret_cast<float2*>(dq_stage + (r0 + 8) * T::kRowF + col) =
              make_float2(a[4 * j + 2], a[4 * j + 3]);
        }
      }
    }
    fence_proxy_async();  // the staging's stores, before the bulk copies read them
    __syncthreads();
    if (tid < kTile && q0 + tid < p.Sq)
      bulk_reduce_add_f32(dqb + (size_t)(q0 + tid) * D, base + T::kDQ + tid * T::kRowF * 4,
                          D * 4);
  }
  if (tid < kTile) bulk_wait_all();

  // the warpgroup's share of the group's dK and dV
  float* dkb = p.dk + kv_base;
  float* dvb = p.dv + kv_base;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (col < D) {
      if (kp0 < p.kv_len) {
        atomicAdd(reinterpret_cast<float2*>(dkb + (size_t)kp0 * D + col),
                  make_float2(dk[4 * j], dk[4 * j + 1]));
        atomicAdd(reinterpret_cast<float2*>(dvb + (size_t)kp0 * D + col),
                  make_float2(dv[4 * j], dv[4 * j + 1]));
      }
      if (kp1 < p.kv_len) {
        atomicAdd(reinterpret_cast<float2*>(dkb + (size_t)kp1 * D + col),
                  make_float2(dk[4 * j + 2], dk[4 * j + 3]));
        atomicAdd(reinterpret_cast<float2*>(dvb + (size_t)kp1 * D + col),
                  make_float2(dv[4 * j + 2], dv[4 * j + 3]));
      }
    }
  }
}

// f32 sums to bf16, times `scale`; n a multiple of 4
__global__ void __launch_bounds__(256)
    attn_bwd_convert_kernel(const float* src, bf16* dst, int64_t n, float scale) {
  const int64_t n4 = n / 4;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dst) + 2 * i;
    out[0] = __floats2bfloat162_rn(x.x * scale, x.y * scale);
    out[1] = __floats2bfloat162_rn(x.z * scale, x.w * scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

cudaError_t convert(const float* src, void* dst, int64_t n, float scale, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n / 4 + 255) / 256;
  attn_bwd_convert_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      src, static_cast<bf16*>(dst), n, scale);
  return cudaGetLastError();
}

// the dynamic shared memory attribute, once per head dim and device, so that
// a launch captured in a CUDA graph makes no other runtime call than itself
template <int D>
cudaError_t launch_main(const BwdParams& p, int key_tiles, int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  constexpr int smem = BwdTile<D>::kSmem;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  attn_bwd_kernel<D><<<(unsigned)((int64_t)key_tiles * p.BH), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout (b, h, sq, d) and k, v (b, hk, skv, d) bf16, lse (b, h, sq) f32,
// all contiguous on `device`; d in 16, 32, 64, 128. Scratch: lse2 and delta
// (b, h, sq_pad) f32 with sq_pad = sq rounded up to 64; dq_acc (b, h, sq, d),
// dk_acc and dv_acc (b, hk, skv, d) f32, zeroed by the caller. Writes dq
// (b, h, sq, d), dk and dv (b, hk, skv, d) in bf16. window <= 0 means none;
// keys at or past kv_len are masked; query i sits at position q_offset + i.
// Returns cudaGetLastError() after the last launch (0 = launched).
extern "C" int attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, void* lse2, void* delta,
                                    void* dq_acc, void* dk_acc, void* dv_acc, void* dq, void* dk,
                                    void* dv, int b, int h, int hk, int sq, int skv, int d,
                                    float scale, int causal, int window, int kv_len,
                                    int q_offset, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || hk < 1 || h % hk != 0 || sq < 1 || skv < 1 || kv_len < 0 || kv_len > skv ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int sq_pad = (sq + kTile - 1) / kTile * kTile;
  const int64_t rows = (int64_t)b * h * sq_pad;
  attn_bwd_prep_kernel<<<(unsigned)((rows + kPrepRows - 1) / kPrepRows), 32 * kPrepRows, 0,
                         s>>>(static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                              static_cast<const float*>(lse), static_cast<float*>(lse2),
                              static_cast<float*>(delta), sq, sq_pad, d, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int key_tiles = (kv_len + kBlockK - 1) / kBlockK;
  if (key_tiles > 0 && (int64_t)key_tiles * b * h > 0x7fffffff) return (int)cudaErrorInvalidValue;
  BwdParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
              static_cast<const float*>(lse2), static_cast<const float*>(delta),
              static_cast<float*>(dq_acc), static_cast<float*>(dk_acc),
              static_cast<float*>(dv_acc), h, hk, sq, skv, sq_pad, b * h, scale * kLog2e,
              causal, window, kv_len, q_offset};
  if (key_tiles > 0) {
    switch (d) {
      case 16: err = launch_main<16>(p, key_tiles, device, s); break;
      case 32: err = launch_main<32>(p, key_tiles, device, s); break;
      case 64: err = launch_main<64>(p, key_tiles, device, s); break;
      case 128: err = launch_main<128>(p, key_tiles, device, s); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t nq = (int64_t)b * h * sq * d;
  const int64_t nk = (int64_t)b * hk * skv * d;
  err = convert(static_cast<const float*>(dq_acc), dq, nq, scale, s);
  if (err == cudaSuccess) err = convert(static_cast<const float*>(dk_acc), dk, nk, scale, s);
  if (err == cudaSuccess) err = convert(static_cast<const float*>(dv_acc), dv, nk, 1.f, s);
  return (int)err;
}
