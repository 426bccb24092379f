// Flash attention forward on Hopper: online-softmax attention with causal,
// sliding-window and kv_len masks, grouped-query heads read by index, and
// the log-sum-exp of every row (the backward's residual) beside the output.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas (body
// _flash_kernel), and the jnp decode path the reference takes when kv_len or
// q_offset is traced (src/repro/kernels/ops.py:flash_attention): here both
// are runtime launch arguments, so prefill, training and every decode step
// launch this kernel, and the backward's (out, lse) recompute does too.
//
// What bounds it on an H100 (989 TFLOP/s bf16 on the tensor cores, 3.35
// TB/s): at starcoder2-3b's prefill (b 8, H 24, Hk 2, S 1024, D 128,
// causal) operations: 51.5 GFLOP of QK^T and PV against 109 MB moved, 0.052
// ms on the tensor cores; at its training shape (b 2, S 4,096) 206 GFLOP,
// 0.21 ms. At a decode step (one query row, kv_len about 1,056) bytes: the
// K/V cache of the two kv heads, about 8.7 MB, 2.6 us.
//
// Design, by path (kernels/flash_attention.py:launch_plan picks it):
// * bf16, sq >= 16 (prefill, training): flash_mma_tile_kernel. One warpgroup
//   (128 threads) a block owns 64 query rows of one (b, h); two blocks fit
//   an SM, so one block's softmax overlaps the other's matrix products.
//   - S = Q K^T and O += P V run on the tensor cores with wgmma (bf16 in,
//     f32 accumulation): Q and K are read from shared memory through 128-byte
//     swizzled descriptors (K-major), V as the MN-major B operand (the
//     transpose bit of 16-bit types), P from registers as the A operand: the
//     S accumulator's fragment is the A fragment of the next product, so P
//     never goes through shared memory.
//   - P is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both run
//     through P V into one accumulator: P keeps about 16 bits, so the output
//     is the f32 result rounded once to bf16, as the plain version's is. QK^T
//     needs no split (products of bf16 values are exact in f32).
//   - K/V tiles of 64 keys go through a ring of two stages in dynamic shared
//     memory, loaded with cp.async (zero-filled past the sequence), so the
//     next tile's copy overlaps this tile's math. Head dims below 64 are
//     zero-padded to 64 in shared memory (one swizzle atom wide).
//   - The online softmax runs in registers on the accumulator fragment, in
//     base 2 with scale * log2(e) folded into one multiply (exp2f, the
//     accurate one). Masks are applied only on tiles that cross the diagonal,
//     the window's edge or kv_len; tiles no row can see are never loaded.
//     Causal grids run the heaviest query tiles first.
//   - Epilogue: O / max(l, 1e-30) in bf16, and lse = m + log l (natural log,
//     -inf for a row with l == 0), f32.
// * bf16, sq < 16 (decode): flash_decode_kernel, GQA-packed. One block a
//   (b, kv head, key split) takes the groups * sq query rows of that kv
//   group as the rows of an mma.sync m16n8k16 tile (16, 32 or 64 rows a
//   block), so each K/V byte is read once, not once per query head. The
//   split count (launch_plan) gives >= 2 blocks an SM where the cache has
//   the tiles; four warps split the rows and the keys of each 64-key tile
//   (ldmatrix from padded shared rows; V through ldmatrix.trans), P in two
//   bf16 terms as above. Each split writes its (m, l, acc) to scratch that
//   the wrapper allocates; flash_merge_kernel, launched by the same C call,
//   merges the splits into the output and lse. Every row masks with its own
//   position q_offset + i.
// * f32 (the SMOKE configurations and their goldens): flash_tile_kernel and
//   flash_row_kernel, fp32 FMAs (TF32 stays off), with finite NEG_INF =
//   -1e30, p = 0 where masked, and l floored at 1e-30 as
//   flash_attention.py:81-105; each also writes lse.
// * Head dims 16, 32, 64, 128 and 256 have instances (the wrapper pads 96
//   and 112 to 128). At 256 (gemma3-12b) each path keeps its design within
//   the SM's budget: the wgmma tile kernel takes 164,864 bytes of shared
//   memory, one block an SM, and runs P V as two n = 128 halves into its
//   128 accumulators a thread; the decode kernel reads its Q fragments from
//   shared memory instead of 64 registers and takes at most 32 packed rows
//   a block (64 would spill); the f32 tile kernel stages key tiles of 16
//   (32 KB of static shared memory), and a slot of the f32 row kernel is
//   one warp, 8 dims a lane.
// * No --use_fast_math: expf / exp2f / logf are the accurate ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the f32 kernels' finite mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kDecodeBelowSq = 16;  // bf16: sq < 16 takes the decode kernel
constexpr int kMaxDevices = 64;

// f32 FMA kernels
constexpr int kTileQ = 64;
constexpr int kTileK = 32;
constexpr int kParts = 4;
constexpr int kTileThreads = kTileQ * kParts;  // 256
constexpr int kRowThreads = 256;
constexpr int kRowUnroll = 4;

// bf16 tensor-core tile kernel
constexpr int kMmaTileQ = 64;  // one warpgroup's rows
constexpr int kMmaTileK = 64;
constexpr int kMmaThreads = 128;

// bf16 decode kernel
constexpr int kDecTileK = 64;
constexpr int kDecThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // (b, h, sq) or null
  float* part;  // decode scratch (b, hk, rows, splits, d + 2) or null
  int H, Hk, Sq, Skv;
  float scale;
  int causal, window, kv_len, q_offset;
  int splits;
};

__device__ __forceinline__ bool allowed(const Params& p, int q_pos, int k_pos) {
  if (k_pos >= p.kv_len) return false;
  if (p.causal && q_pos < k_pos) return false;
  if (p.window > 0 && q_pos - k_pos >= p.window) return false;
  return true;
}

// ---------------------------------------------------------------------------
// f32 FMA kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
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

__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? m + logf(l) : -INFINITY;
}

// One block per (b*h, 64-query tile), 4 threads a query row, each holding a
// quarter of the row's q and f32 accumulator; K/V tiles of 32 keys (16 at
// D = 256, so that both stay under the 48 KB of static shared memory)
// staged in shared memory, read as float4 broadcasts; a row's dot product
// summed over its 4 threads with two xor shuffles.
template <int D>
__global__ void __launch_bounds__(kTileThreads)
    flash_tile_kernel(Params p) {
  constexpr int kVec = D / 4 / kParts;  // float4 chunks a thread holds
  constexpr int TK = D > 128 ? kTileK / 2 : kTileK;
  __shared__ float4 sk[TK][D / 4];
  __shared__ float4 sv[TK][D / 4];

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
  const float* qb = static_cast<const float*>(p.q) + (size_t)bh * p.Sq * D;
  const size_t kv_base = (size_t)(b * p.Hk + hk) * p.Skv * D;
  const float* kb = static_cast<const float*>(p.k) + kv_base;
  const float* vb = static_cast<const float*>(p.v) + kv_base;

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

  for (int k0 = (k_lo / TK) * TK; k0 < k_hi; k0 += TK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < TK * D; idx += kTileThreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < p.Skv) {
        kv = kb[(size_t)kr * D + c];
        vv = vb[(size_t)kr * D + c];
      }
      reinterpret_cast<float*>(sk[r])[c] = kv;
      reinterpret_cast<float*>(sv[r])[c] = vv;
    }
    __syncthreads();

    float s[TK];
    uint32_t ok_bits = 0u;
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
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
    for (int j = 0; j < TK; ++j) {
      s[j] = ((ok_bits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float4 a = make_float4(acc[i].x * corr, acc[i].y * corr, acc[i].z * corr, acc[i].w * corr);
#pragma unroll
      for (int j = 0; j < TK; ++j) a = axpby4(a, 1.f, s[j], sv[j][part + kParts * i]);
      acc[i] = a;
    }
    m = m_new;
  }

  if (qi < p.Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* ob = static_cast<float*>(p.o) + (size_t)bh * p.Sq * D + (size_t)qi * D;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = 4 * (part + kParts * i);
      ob[c] = acc[i].x / denom;
      ob[c + 1] = acc[i].y / denom;
      ob[c + 2] = acc[i].z / denom;
      ob[c + 3] = acc[i].w / denom;
    }
    if (p.lse != nullptr && part == 0) p.lse[(size_t)bh * p.Sq + qi] = lse_of(m, l);
  }
}

// One block per (query row, b*h): the keys split over slots of D/4 lanes (a
// lane holds 4 dims of q and of its slot's accumulator; at D = 256 a slot
// is one warp and a lane holds 8 dims, dims 4 lane.. and 128 + 4 lane..);
// each slot walks keys slot, slot + nslots, ... four at a time with its own
// running max and sum, and the slots merge through shared memory at the end.
template <int D>
__global__ void __launch_bounds__(kRowThreads)
    flash_row_kernel(Params p) {
  constexpr int kVecs = D > 128 ? D / 128 : 1;  // float4 chunks a lane holds
  constexpr int kLanes = D / 4 / kVecs;          // lanes of one slot, at most a warp
  constexpr int kSlots = kRowThreads / kLanes;
  __shared__ float s_m[kSlots];
  __shared__ float s_l[kSlots];
  __shared__ float4 s_acc[kSlots][kLanes * kVecs];

  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hk);
  const int slot = threadIdx.x / kLanes;
  const int lane = threadIdx.x - slot * kLanes;
  const int q_pos = p.q_offset + qi;
  const size_t kv_base = (size_t)(b * p.Hk + hk) * p.Skv * D;
  const float* kb = static_cast<const float*>(p.k) + kv_base + 4 * lane;
  const float* vb = static_cast<const float*>(p.v) + kv_base + 4 * lane;
  const float* qrow = static_cast<const float*>(p.q) + ((size_t)bh * p.Sq + qi) * D + 4 * lane;
  float4 qr[kVecs], acc[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    qr[i] = load4(qrow + 4 * kLanes * i);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, q_pos + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, q_pos - p.window + 1);

  float m = kNegInf;
  float l = 0.f;
  // the trip count is the same for every thread: the shuffles stay converged
  for (int kbase = k_lo; kbase < k_hi; kbase += kSlots * kRowUnroll) {
    float4 kk[kRowUnroll][kVecs], vv[kRowUnroll][kVecs];
    bool ok[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int kp = kbase + slot + u * kSlots;
      ok[u] = kp < k_hi && allowed(p, q_pos, kp);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        kk[u][i] = ok[u] ? load4(kb + (size_t)kp * D + 4 * kLanes * i) : z;
        vv[u][i] = ok[u] ? load4(vb + (size_t)kp * D + 4 * kLanes * i) : z;
      }
    }
    float s[kRowUnroll];
    float m_cur = kNegInf;
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) d = dot4(qr[i], kk[u][i], d);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      s[u] = ok[u] ? d * p.scale : kNegInf;
      m_cur = fmaxf(m_cur, s[u]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    float4 a[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      a[i] = make_float4(acc[i].x * corr, acc[i].y * corr, acc[i].z * corr, acc[i].w * corr);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const float pu = ok[u] ? expf(s[u] - m_new) : 0.f;
      psum += pu;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) a[i] = axpby4(a[i], 1.f, pu, vv[u][i]);
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) acc[i] = a[i];
    m = m_new;
  }

  if (lane == 0) {
    s_m[slot] = m;
    s_l[slot] = l;
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) s_acc[slot][lane + kLanes * i] = acc[i];
  __syncthreads();
  if (threadIdx.x < kLanes * kVecs) {  // one float4 of the output row a thread
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
    float* ob = static_cast<float*>(p.o) + ((size_t)bh * p.Sq + qi) * D + 4 * threadIdx.x;
    ob[0] = at.x / denom;
    ob[1] = at.y / denom;
    ob[2] = at.z / denom;
    ob[3] = at.w / denom;
    if (p.lse != nullptr && threadIdx.x == 0) p.lse[(size_t)bh * p.Sq + qi] = lse_of(mx, lt);
  }
}

// ---------------------------------------------------------------------------
// bf16: shared-memory copies, tensor-core instructions, softmax pieces
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

// S (64 x 64) = A (64 x 16, shared) * B (64 x 16 K-major, shared); the
// first k step overwrites (accumulate == 0), the rest add
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, registers) * B (16 x 64 MN-major, shared)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
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

__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// p (two f32, neighbouring columns) -> bf16 pairs p_hi = bf16(p) and
// p_lo = bf16(p - p_hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// one online-softmax step of a row held as `n` values by each of 4 threads
// (x in base-2 units, -inf where masked): returns the factor that rescales
// the row's old sum and accumulator, updates m and l, and turns x into p
template <int N>
__device__ __forceinline__ float softmax_step(float (&x)[N], float& m, float& l) {
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) mx = fmaxf(mx, x[i]);
  const float m_new = fmaxf(m, quad_max(mx));
  const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
  const float corr = exp2f(m - m_use);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = exp2f(x[i] - m_use);
    sum += x[i];
  }
  l = l * corr + sum;  // this thread's share; summed over the quad at the end
  m = m_new;
  return corr;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core tile kernel (sq >= 16)
// ---------------------------------------------------------------------------

// Shared memory of the tile kernel: Q (64 rows) and two stages of K and V
// (64 keys each), each a [rows][DP] bf16 matrix stored as DP/64 swizzle
// atoms of [rows][64], 128-byte rows whose 16-byte chunks are permuted by
// chunk ^ (row % 8): wgmma's 128-byte swizzle, for atoms on 1024-byte
// boundaries.
template <int D>
struct MmaTile {
  static constexpr int kDP = D < 64 ? 64 : D;  // width in shared memory
  static constexpr int kAtomBytes = 64 * 128;  // 64 rows of one atom
  static constexpr int kMatBytes = kAtomBytes * (kDP / 64);
  static constexpr int kSmem = 5 * kMatBytes + 1024;  // Q, 2 x (K, V), alignment
};

// rows [row0, row0 + 64) of a (n, D) bf16 matrix into a swizzled [64][DP]
// tile; rows at or past n are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst, const bf16* src, int row0, int n,
                                                int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = tid; idx < 64 * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int cc = idx - r * kChunks;
    const bool ok = row0 + r < n;
    const bf16* g = src + (size_t)(ok ? row0 + r : 0) * D + cc * 8;
    cp_async16(dst + (cc >> 3) * MmaTile<D>::kAtomBytes + r * 128 + (((cc & 7) ^ (r & 7)) << 4),
               g, ok);
  }
}

template <int DP>
struct PV;
template <>
struct PV<64> {
  static __device__ __forceinline__ void run(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    wgmma_rs_m64n64(o, a, desc);
  }
};
template <>
struct PV<128> {
  static __device__ __forceinline__ void run(float (&o)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    wgmma_rs_m64n128(o, a, desc);
  }
};
// D = 256: two n = 128 products, on the accumulator's halves (n8 blocks
// 0-15 and 16-31) and on V's column atoms 0-1 and 2-3
template <>
struct PV<256> {
  static __device__ __forceinline__ void run(float (&o)[128], const uint32_t (&a)[4],
                                             uint64_t desc) {
    constexpr uint64_t kHalf = (2 * 64 * 128) >> 4;  // two atoms, in descriptor units
    wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(&o[0]), a, desc);
    wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(&o[64]), a, desc + kHalf);
  }
};

// two blocks an SM up to D = 128; at D = 256 the 164,864 bytes of shared
// memory hold one, and the 128 accumulators a thread want the registers
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D > 128 ? 1 : 2)
    flash_mma_tile_kernel(Params p) {
  constexpr int DP = MmaTile<D>::kDP;
  constexpr int kAtom = MmaTile<D>::kAtomBytes;
  constexpr int kMat = MmaTile<D>::kMatBytes;
  constexpr int NO = DP / 2;  // output accumulators a thread
  extern __shared__ __align__(1024) uint8_t smem_tile[];
  const uint32_t base = (smem_u32(smem_tile) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  // stage st: K at s_q + (1 + 2 st) kMat, V at s_q + (2 + 2 st) kMat

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hk);
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int q0 = qt * kMmaTileQ;
  const bf16* qb = static_cast<const bf16*>(p.q) + (size_t)bh * p.Sq * D;
  const size_t kv_base = (size_t)(b * p.Hk + hk) * p.Skv * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + kv_base;
  const bf16* vb = static_cast<const bf16*>(p.v) + kv_base;

  // the keys any row of this tile can see
  const int q_last = min(q0 + kMmaTileQ, p.Sq) - 1;
  int k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, p.q_offset + q_last + 1);
  const int k_lo = p.window > 0 ? max(0, p.q_offset + q0 - p.window + 1) : 0;
  const int t_lo = k_lo / kMmaTileK;
  const int nt = k_hi > k_lo ? (k_hi + kMmaTileK - 1) / kMmaTileK - t_lo : 0;

  if (D < 64) {  // zero the padding columns once; cp.async never writes them
    for (int i = tid * 16; i < 5 * kMat; i += kMmaThreads * 16)
      *reinterpret_cast<uint4*>(smem_tile + (base - smem_u32(smem_tile)) + i) =
          make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // this thread's rows of the accumulator fragments: r0 and r0 + 8
  const int r0 = q0 + 16 * warp + g;
  const int qp0 = p.q_offset + r0;
  const int qp1 = qp0 + 8;
  const float c = p.scale * kLog2e;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (nt > 0) {
    load_tile_sw128<D>(s_q, qb, q0, p.Sq, tid);
    load_tile_sw128<D>(s_q + kMat, kb, t_lo * kMmaTileK, p.Skv, tid);
    load_tile_sw128<D>(s_q + 2 * kMat, vb, t_lo * kMmaTileK, p.Skv, tid);
    cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    if (it + 1 < nt) {  // the next tile's copy overlaps this tile's math
      const int kn = (t_lo + it + 1) * kMmaTileK;
      load_tile_sw128<D>(s_q + (1 + 2 * (st ^ 1)) * kMat, kb, kn, p.Skv, tid);
      load_tile_sw128<D>(s_q + (2 + 2 * (st ^ 1)) * kMat, vb, kn, p.Skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t s_k = s_q + (1 + 2 * st) * kMat;
    const uint32_t s_v = s_q + (2 + 2 * st) * kMat;
    const int k0 = (t_lo + it) * kMmaTileK;

    // S = Q K^T: 64 x 64, DP / 16 k steps of 32 bytes inside the atoms
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
      wgmma_ss_m64n64(s, sw128_desc(s_q + off, 16, 1024), sw128_desc(s_k + off, 16, 1024),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // base-2 scores; masks only where the tile crosses an edge
    const bool edge = k0 + kMmaTileK > p.kv_len ||
                      (p.causal && k0 + kMmaTileK - 1 > p.q_offset + q0) ||
                      (p.window > 0 && p.q_offset + q0 + kMmaTileQ - 1 - k0 >= p.window);
    float x0[16], x1[16];  // rows r0 and r0 + 8; column 8 j + 2 t4 + e at [2 j + e]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x0[2 * j + e] = s[4 * j + e] * c;
        x1[2 * j + e] = s[4 * j + 2 + e] * c;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t4 + e;
          if (!allowed(p, qp0, key)) x0[2 * j + e] = -INFINITY;
          if (!allowed(p, qp1, key)) x1[2 * j + e] = -INFINITY;
        }
      }
    }
    const float corr0 = softmax_step(x0, m0, l0);
    const float corr1 = softmax_step(x1, m1, l1);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }

    // P as the A operand of P V, in two bf16 terms: k step kk holds keys
    // 16 kk .. 16 kk + 15, i.e. the n8 blocks 2 kk and 2 kk + 1 of S
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_bf16(x0[4 * kk], x0[4 * kk + 1], ph[kk][0], pl[kk][0]);
      split_bf16(x1[4 * kk], x1[4 * kk + 1], ph[kk][1], pl[kk][1]);
      split_bf16(x0[4 * kk + 2], x0[4 * kk + 3], ph[kk][2], pl[kk][2]);
      split_bf16(x1[4 * kk + 2], x1[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // V rows 16 kk .. 16 kk + 15: two 8-row groups (SBO 1024), atoms of 64
      // columns 64 rows apart (LBO)
      const uint64_t desc = sw128_desc(s_v + kk * 16 * 128, kAtom, 1024);
      PV<DP>::run(o, ph[kk], desc);
      PV<DP>::run(o, pl[kk], desc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // this stage is free for the copy two tiles ahead
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  bf16* ob = static_cast<bf16*>(p.o) + (size_t)bh * p.Sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
          pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r0 + 8 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)(r0 + 8) * D + col) =
          pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
  if (p.lse != nullptr && t4 == 0) {
    float* lb = p.lse + (size_t)bh * p.Sq;
    if (r0 < p.Sq) lb[r0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : -INFINITY;
    if (r0 + 8 < p.Sq) lb[r0 + 8] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// bf16 decode kernel (sq < 16): GQA-packed rows, key splits, then a merge
// ---------------------------------------------------------------------------

// Up to D = 128 a thread keeps its Q fragments in registers; at D = 256
// they would take 64 of them beside the 128 of the O accumulator, so the
// block's (at most 32, launch_decode) packed Q rows sit in shared memory
// after the K/V stages and each k step reads its fragment there.
template <int D>
struct Decode {
  static constexpr int kLd = D + 8;  // shared row stride (bf16): 16-byte pad, no bank conflicts
  static constexpr bool kQSmem = D > 128;
  static constexpr int kQRows = 32;
  static constexpr int kKV = 2 * 2 * kDecTileK * kLd;  // bf16: 2 stages of K and V
  static constexpr int kSmem = (kKV + (kQSmem ? kQRows * kLd : 0)) * 2;
};

// packed row r of a kv group: query head hk * groups + r / sq, query r % sq
__device__ __forceinline__ size_t packed_row(const Params& p, int b, int hk, int r) {
  const int groups = p.H / p.Hk;
  return ((size_t)(b * p.H + hk * groups + r / p.Sq)) * p.Sq + r % p.Sq;
}

// NRT row tiles of 16 (16, 32 or 64 packed rows a block); the four warps
// are NRT row tiles x (4 / NRT) key groups, each key group taking a
// 64 / (4 / NRT)-key slice of every 64-key tile
template <int D, int NRT>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(Params p) {
  constexpr int KG = 4 / NRT;
  constexpr int KW = kDecTileK / KG;  // keys a warp takes of a tile
  constexpr int RB = 16 * NRT;         // packed rows a block
  constexpr int LD = Decode<D>::kLd;
  constexpr int NB = KW / 8;           // n8 blocks of S
  constexpr int ND = D / 8;            // n8 blocks of O
  extern __shared__ __align__(16) uint8_t smem_dec[];
  bf16* sk = reinterpret_cast<bf16*>(smem_dec);  // [2][64][LD]
  bf16* sv = sk + 2 * kDecTileK * LD;

  const int split = blockIdx.x;
  const int rb = blockIdx.y;
  const int bhk = blockIdx.z;
  const int b = bhk / p.Hk;
  const int hk = bhk - b * p.Hk;
  const int R = (p.H / p.Hk) * p.Sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rt = warp % NRT;
  const int kg = warp / NRT;
  const int ra = rb * RB + rt * 16 + g;  // this thread's packed rows ra, ra + 8
  const int rbb = ra + 8;
  const int qp0 = ra < R ? p.q_offset + ra % p.Sq : -1;  // -1: a padding row, all masked
  const int qp1 = rbb < R ? p.q_offset + rbb % p.Sq : -1;

  // Q fragments (A of m16n8k16) straight from global memory into registers,
  // or (kQSmem) the block's packed rows into shared memory; padding rows 0
  constexpr bool kQSmem = Decode<D>::kQSmem;
  static_assert(!kQSmem || RB <= Decode<D>::kQRows, "Q rows past the shared buffer");
  bf16* sq = sk + Decode<D>::kKV;  // [kQRows][LD], used when kQSmem
  uint32_t qa[kQSmem ? 1 : D / 16][4];
  if constexpr (kQSmem) {
    constexpr int kChunks = D / 8;
    for (int idx = tid; idx < RB * kChunks; idx += kDecThreads) {
      const int row = idx / kChunks;
      const int cc = idx - row * kChunks;
      const int r = rb * RB + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < R)
        v = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.q) +
                                            packed_row(p, b, hk, r) * D + cc * 8);
      *reinterpret_cast<uint4*>(sq + row * LD + cc * 8) = v;
    }
    // the first tile's __syncthreads below orders these stores before the reads
  } else {
    const bf16* qa_row = static_cast<const bf16*>(p.q) + packed_row(p, b, hk, min(ra, R - 1)) * D;
    const bf16* qb_row = static_cast<const bf16*>(p.q) + packed_row(p, b, hk, min(rbb, R - 1)) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = 16 * kk + 2 * t4;
      qa[kk][0] = ra < R ? *reinterpret_cast<const uint32_t*>(qa_row + col) : 0u;
      qa[kk][1] = rbb < R ? *reinterpret_cast<const uint32_t*>(qb_row + col) : 0u;
      qa[kk][2] = ra < R ? *reinterpret_cast<const uint32_t*>(qa_row + col + 8) : 0u;
      qa[kk][3] = rbb < R ? *reinterpret_cast<const uint32_t*>(qb_row + col + 8) : 0u;
    }
  }

  // the keys any row of the group can see (positions q_offset .. + sq - 1),
  // in 64-key tiles shared out evenly over the splits
  int k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, p.q_offset + p.Sq);
  const int k_lo = p.window > 0 ? max(0, p.q_offset - p.window + 1) : 0;
  const int t_lo = k_lo / kDecTileK;
  const int n_all = k_hi > k_lo ? (k_hi + kDecTileK - 1) / kDecTileK - t_lo : 0;
  const int per = (n_all + p.splits - 1) / p.splits;
  const int ts = t_lo + split * per;
  const int nt = max(0, min(t_lo + n_all, ts + per) - ts);

  const size_t kv_base = (size_t)(b * p.Hk + hk) * p.Skv * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + kv_base;
  const bf16* vb = static_cast<const bf16*>(p.v) + kv_base;
  auto load = [&](int stage, int tile) {
    constexpr int kChunks = D / 8;
    const int key0 = tile * kDecTileK;
    for (int idx = tid; idx < kDecTileK * kChunks; idx += kDecThreads) {
      const int r = idx / kChunks;
      const int cc = idx - r * kChunks;
      const bool ok = key0 + r < p.Skv;
      const size_t src = (size_t)(ok ? key0 + r : 0) * D + cc * 8;
      const int dst = (stage * kDecTileK + r) * LD + cc * 8;
      cp_async16(smem_u32(sk + dst), kb + src, ok);
      cp_async16(smem_u32(sv + dst), vb + src, ok);
    }
    cp_async_commit();
  };

  const float c = p.scale * kLog2e;
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (nt > 0) load(0, ts);
  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    if (it + 1 < nt) {
      load(st ^ 1, ts + it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kw0 = kg * KW;  // this warp's first key of the tile
    const int k0 = (ts + it) * kDecTileK + kw0;
    const bf16* tk = sk + st * kDecTileK * LD;
    const bf16* tv = sv + st * kDecTileK * LD;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    // S += Q K^T over k step kk, from Q's A fragment a
    auto qk_step = [&](int kk, const uint32_t(&a)[4]) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t b0, b1;
        ldmatrix_x2(smem_u32(tk + (kw0 + nb * 8 + (lane & 7)) * LD + 16 * kk +
                             8 * ((lane >> 3) & 1)),
                    b0, b1);
        mma_m16n8k16(s[nb], a, b0, b1);
      }
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (kQSmem) {  // rows rt 16 + g and + 8, columns 16 kk + 2 t4 (+ 8)
        const bf16* q0 = sq + (rt * 16 + g) * LD + 16 * kk + 2 * t4;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(q0),
                               *reinterpret_cast<const uint32_t*>(q0 + 8 * LD),
                               *reinterpret_cast<const uint32_t*>(q0 + 8),
                               *reinterpret_cast<const uint32_t*>(q0 + 8 * LD + 8)};
        qk_step(kk, a);
      } else {
        qk_step(kk, qa[kk]);
      }
    }
    float x0[2 * NB], x1[2 * NB];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * nb + 2 * t4 + e;
        x0[2 * nb + e] = qp0 >= 0 && allowed(p, qp0, key) ? s[nb][e] * c : -INFINITY;
        x1[2 * nb + e] = qp1 >= 0 && allowed(p, qp1, key) ? s[nb][2 + e] * c : -INFINITY;
      }
    }
    const float corr0 = softmax_step(x0, m0, l0);
    const float corr1 = softmax_step(x1, m1, l1);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= corr0;
      o[nd][1] *= corr0;
      o[nd][2] *= corr1;
      o[nd][3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(x0[4 * kk], x0[4 * kk + 1], ph[0], pl[0]);
      split_bf16(x1[4 * kk], x1[4 * kk + 1], ph[1], pl[1]);
      split_bf16(x0[4 * kk + 2], x0[4 * kk + 3], ph[2], pl[2]);
      split_bf16(x1[4 * kk + 2], x1[4 * kk + 3], ph[3], pl[3]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(smem_u32(tv + (kw0 + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                   nd * 8),
                          b0, b1);
        mma_m16n8k16(o[nd], ph, b0, b1);
        mma_m16n8k16(o[nd], pl, b0, b1);
      }
    }
    __syncthreads();  // this stage is free for the copy two tiles ahead
  }

  // merge the key groups of each row tile through shared memory (the K/V
  // stages are free now), then write this split's (acc, m, l) per row
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* s_acc = reinterpret_cast<float*>(smem_dec);  // [KG][RB][D]
  float* s_m = s_acc + KG * RB * D;                   // [KG][RB]
  float* s_l = s_m + KG * RB;
  const int lr = rt * 16 + g;  // row within the block
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t4;
    s_acc[(kg * RB + lr) * D + col] = o[nd][0];
    s_acc[(kg * RB + lr) * D + col + 1] = o[nd][1];
    s_acc[(kg * RB + lr + 8) * D + col] = o[nd][2];
    s_acc[(kg * RB + lr + 8) * D + col + 1] = o[nd][3];
  }
  if (t4 == 0) {
    s_m[kg * RB + lr] = m0;
    s_l[kg * RB + lr] = l0;
    s_m[kg * RB + lr + 8] = m1;
    s_l[kg * RB + lr + 8] = l1;
  }
  __syncthreads();
  for (int idx = tid; idx < RB * D; idx += kDecThreads) {
    const int row = idx / D;
    const int d = idx - row * D;
    const int r = rb * RB + row;
    if (r >= R) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < KG; ++k) mx = fmaxf(mx, s_m[k * RB + row]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float w = exp2f(s_m[k * RB + row] - m_use);
      lt = fmaf(s_l[k * RB + row], w, lt);
      at = fmaf(s_acc[(k * RB + row) * D + d], w, at);
    }
    float* out = p.part + (((size_t)bhk * R + r) * p.splits + split) * (D + 2);
    out[d] = at;
    if (d == 0) {
      out[D] = mx;
      out[D + 1] = lt;
    }
  }
}

// one block of D threads per packed row: the splits' (acc, m, l) merged
// into the output row and its lse
template <int D>
__global__ void __launch_bounds__(D)
    flash_merge_kernel(Params p) {
  const int R = (p.H / p.Hk) * p.Sq;
  const int row = blockIdx.x;  // (b * hk) * R + r
  const int bhk = row / R;
  const int r = row - bhk * R;
  const int b = bhk / p.Hk;
  const int hk = bhk - b * p.Hk;
  const int d = threadIdx.x;
  const float* part = p.part + (size_t)row * p.splits * (D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, part[s * (D + 2) + D]);
  const float m_use = mx == -INFINITY ? 0.f : mx;
  float lt = 0.f, at = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float w = exp2f(part[s * (D + 2) + D] - m_use);
    lt = fmaf(part[s * (D + 2) + D + 1], w, lt);
    at = fmaf(part[s * (D + 2) + d], w, at);
  }
  const size_t orow = packed_row(p, b, hk, r);
  static_cast<bf16*>(p.o)[orow * D + d] = __float2bfloat16(at / fmaxf(lt, 1e-30f));
  if (p.lse != nullptr && d == 0) p.lse[orow] = lt > 0.f ? (mx + log2f(lt)) * kLn2 : -INFINITY;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the dynamic shared memory attribute, once per kernel and device, so that a
// launch captured in a CUDA graph makes no other runtime call than itself
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, int device, bool (&done)[kMaxDevices]) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_f32(const Params& p, int bh, cudaStream_t stream) {
  if (p.Sq < kDecodeBelowSq) {
    flash_row_kernel<D><<<dim3(p.Sq, bh), kRowThreads, 0, stream>>>(p);
  } else {
    flash_tile_kernel<D><<<dim3((p.Sq + kTileQ - 1) / kTileQ, bh), kTileThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma_tile(const Params& p, int bh, int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  constexpr int smem = MmaTile<D>::kSmem;
  cudaError_t err = opt_in_smem(flash_mma_tile_kernel<D>, smem, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Sq + kMmaTileQ - 1) / kMmaTileQ);
  flash_mma_tile_kernel<D><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int NRT>
cudaError_t launch_decode_rows(const Params& p, int b, int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  constexpr int smem = Decode<D>::kSmem;
  cudaError_t err = opt_in_smem(flash_decode_kernel<D, NRT>, smem, device, done);
  if (err != cudaSuccess) return err;
  const int R = (p.H / p.Hk) * p.Sq;
  const dim3 grid(p.splits, (R + 16 * NRT - 1) / (16 * NRT), b * p.Hk);
  flash_decode_kernel<D, NRT><<<grid, kDecThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_merge_kernel<D><<<b * p.Hk * R, D, 0, stream>>>(p);
  return cudaGetLastError();
}

// 16, 32 or 64 packed rows a block; at D = 256 at most 32 (64 rows, one
// key group, would hold S for 64 keys beside the 128 O accumulators and
// spill), so more packed rows take more row blocks
template <int D>
cudaError_t launch_decode(const Params& p, int b, int device, cudaStream_t stream) {
  const int R = (p.H / p.Hk) * p.Sq;
  if (R <= 16) return launch_decode_rows<D, 1>(p, b, device, stream);
  if constexpr (D > 128) {
    return launch_decode_rows<D, 2>(p, b, device, stream);
  } else {
    if (R <= 32) return launch_decode_rows<D, 2>(p, b, device, stream);
    return launch_decode_rows<D, 4>(p, b, device, stream);
  }
}

template <int D>
cudaError_t launch_dim(const Params& p, int b, int is_bf16, int device, cudaStream_t stream) {
  if (!is_bf16) return launch_f32<D>(p, b * p.H, stream);
  if (p.Sq < kDecodeBelowSq) return launch_decode<D>(p, b, device, stream);
  return launch_mma_tile<D>(p, b * p.H, device, stream);
}

}  // namespace

// q, o (b, h, sq, d); k, v (b, hk, skv, d); all contiguous, one dtype (f32
// when is_bf16 == 0, bf16 otherwise), on `device`. lse (b, h, sq) f32 or
// null. window <= 0 means none; keys at or past kv_len are masked; query i
// sits at position q_offset + i. The bf16 decode path (sq < 16) takes
// `splits` key splits and f32 scratch of part_elems >= b * hk * (h / hk *
// sq) * splits * (d + 2) elements; the other paths ignore both. Returns
// cudaGetLastError() after the last launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, void* part, int64_t part_elems, int b, int h,
                                      int hk, int sq, int skv, int d, int is_bf16, float scale,
                                      int causal, int window, int kv_len, int q_offset,
                                      int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || hk < 1 || h % hk != 0 || sq < 1 || skv < 1 || kv_len < 0 || kv_len > skv ||
      q_offset < 0 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  const bool decode = is_bf16 && sq < kDecodeBelowSq;
  if (decode && (splits < 1 || part == nullptr ||
                 part_elems < (int64_t)b * h * sq * splits * (d + 2)))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, static_cast<float*>(lse), static_cast<float*>(part), h, hk, sq, skv,
           scale, causal, window, kv_len, q_offset, splits};
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: err = launch_dim<16>(p, b, is_bf16, device, s); break;
    case 32: err = launch_dim<32>(p, b, is_bf16, device, s); break;
    case 64: err = launch_dim<64>(p, b, is_bf16, device, s); break;
    case 128: err = launch_dim<128>(p, b, is_bf16, device, s); break;
    case 256: err = launch_dim<256>(p, b, is_bf16, device, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
