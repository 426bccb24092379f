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
// What bounds it on an H100: at the mamba2-130m prefill shape (b*h 192, 8
// chunks, T 128, p 64, n 128, one group) a chunk needs, on the causal
// triangle of T(T+1)/2 pairs, tri*n (C B^T) + tri*p (M x) multiply-adds,
// plus T*n*p (states): 2.63 M a (b*h, chunk), 8.1 GFLOP a call, 0.121 ms at
// the fp32 rate of 67 TFLOP/s (the reference asks for f32 dot products).
// This kernel runs them on the tensor cores as 3xTF32 (three TF32 products
// for each f32 one): 24.3 GFLOP, 0.049 ms at 495 TFLOP/s (mma.sync reached
// 270 TFLOP/s in a loop of nothing else on the H100); sharing C B^T among a
// block's heads takes 12-head slices to 1.67 M a (b*h, chunk), 15.3 GFLOP.
// So bytes bound it: 261.6 MB moved, 0.078 ms at 3.35 TB/s.
//
// Design:
// * A block runs a slice of one group's heads on one (batch row, chunk)
//   (kernels/ssd_scan.py:head_slice picks the slice so the 1-D grid of
//   b*nc*g*slices blocks runs in the fewest waves; 12 heads at mamba2-130m's
//   shapes, one wave of 128 blocks). B and C are read per group, as the
//   (b, S, G, n) inputs hold them (the reference repeats them to H heads),
//   staged once, and C B^T is computed once for the slice.
// * Staging: B, C and the first head's x, dt and a go to shared memory as
//   f32 with cp.async (16-byte copies where rows are aligned); the next
//   head's x, dt and a are in flight while a head runs (two buffers). T and
//   n are zero-padded to multiples of 16 and x to 64 columns; row strides
//   are 4 mod 32 floats, so every fragment load below hits 32 banks.
//   207,872 bytes at the largest shape: one block of 8 warps per SM.
// * All three products are mma.sync m16n8k8 TF32 with f32 accumulation, in
//   3xTF32: each f32 operand is split at fragment load into hi (TF32) and
//   lo = v - hi, and a b = al bh + ah bl + ah bh (lo lo, 2^-22 relative,
//   dropped), so the products keep about f32 accuracy with TF32 off
//   everywhere else. Each of the three runs over all of a warp's tiles
//   before the next, so no mma waits on the one before it. mma.sync, not
//   wgmma: wgmma's TF32 form wants both operands K-major, and x as the B
//   operand of M x is MN-major.
// * A warp owns a 16-row strip i0 .. i0 + 15 of the chunk (warps w and
//   w + 4, which share a scheduler, take strips w and 7 - w). Once a block
//   it runs S = C B^T on the causal columns j < i0 + 16 only (the tile
//   count is a template argument) and keeps S in registers. For each head
//   it builds M = S * exp(a_cum[i] - a_cum[j]) * dt[j] (0 above the
//   diagonal) with the accurate expf and multiplies M by x straight from
//   registers: the accumulator holds columns 2t and 2t + 1 of each 8-column
//   tile where the A fragment wants t and t + 4, so the k index of M x is
//   permuted (slot t <-> column 2t, slot t + 4 <-> 2t + 1) and x's B
//   fragment reads the rows in the same order. M never goes through shared
//   memory.
// * Per head, a_cum is a scan by one warp (shuffles). The chunk state
//   (Bw)^T x, which reads B transposed with the same permuted k over t, and
//   c_decay = C * exp(a_cum) go 16 rows at a time to whichever warp is free
//   (a counter in shared memory), so the warps with short causal strips take
//   more, and c_decay's stores mix with the others' math.
// * No --use_fast_math: expf is the accurate one, as in the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxHeadSlice = 32;  // heads of one group a block runs, sharing C B^T
// the dynamic shared memory of the largest layout (T 128, n 128, p 64):
// 207,872 bytes, under the 232,448 an SM gives one block
constexpr int kMaxSmemBytes =
    4 * (2 * kMaxT * (kMaxN + 4) + 2 * kMaxT * (kMaxP + 4) + 6 * kMaxT);
constexpr int kQTiles = kMaxP / 8;  // 8-column tiles of y and of the state
constexpr int kLdx = kMaxP + 4;     // x's row stride in shared memory
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// the shared-memory layout: T and n padded to 16 (row strips, state row
// tiles), x to all kMaxP columns (so the y and state tiles need no branch);
// row strides of 4 mod 32 floats
struct Layout {
  int Tp, Np, ldbc;
};

__host__ __device__ __forceinline__ Layout make_layout(int T, int N) {
  Layout l;
  l.Tp = round_up(T, 16);
  l.Np = round_up(N, 16);
  l.ldbc = round_up(l.Np, 32) + 4;
  return l;
}

// B and C, x of two heads, dt and a of two heads, a_cum and w
__host__ __device__ __forceinline__ size_t smem_bytes(const Layout& l) {
  return sizeof(float) *
         ((size_t)2 * l.Tp * l.ldbc + (size_t)2 * l.Tp * kLdx + (size_t)6 * l.Tp);
}



// v = hi + lo to about 21 significant bits. hi is v rounded to TF32 to
// nearest, ties away (what cvt.rna.tf32.f32 gives for finite v), by an
// integer add and mask; lo = v - hi is exact, and the tensor core reads its
// top 19 bits. Two integer operations and a subtraction: cvt.rna on both
// took the kernel from 0.455 to 0.65 ms at the prefill shape, with the same
// errors against the plain version.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += a b[j] over NT tiles in 3xTF32: the two cross terms, then hi hi,
// each over all tiles before the next, so no mma waits on the one before
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[NT][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(d[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(d[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(d[j], ah, bh[j][0], bh[j][1]);
}

// the A fragment (rows g, g + 8; k slots t, t + 4) from four f32 values
__device__ __forceinline__ void split_a(float v0, float v1, float v2, float v3,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
  split(v2, hi[2], lo[2]);
  split(v3, hi[3], lo[3]);
}

__device__ __forceinline__ void split_b(float v0, float v1, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// global -> shared without a register round trip, asynchronously: 16 bytes
// (both addresses 16-byte aligned) or 4
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n floats of one row, by warp lane: 16-byte copies when `vec`
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n, bool vec,
                                         int lane) {
  if (vec) {
    for (int k = 4 * lane; k < n; k += 128) cp_async16(dst + k, src + k);
  } else {
    for (int k = lane; k < n; k += 32) cp_async4(dst + k, src + k);
  }
}

// zero columns [from, to) of one row, by warp lane
__device__ __forceinline__ void zero_row(float* dst, int from, int to, int lane) {
  for (int k = from + lane; k < to; k += 32) dst[k] = 0.f;
}

// rows r0 and r0 + 8 of a 16 x 64 accumulator tile set, inside (rows, cols)
__device__ __forceinline__ void store_rows(float* __restrict__ out, size_t row_base, int r0,
                                           int rows, int cols, int t4,
                                           const float (&acc)[kQTiles][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= rows) continue;
    float* p = out + (row_base + r) * (size_t)cols;
#pragma unroll
    for (int qt = 0; qt < kQTiles; ++qt) {
      const int q = 8 * qt + 2 * t4;
      if (cols % 2 == 0) {  // rows start 8-byte aligned: one 8-byte store a pair
        if (q < cols)
          *reinterpret_cast<float2*>(p + q) = make_float2(acc[qt][2 * half], acc[qt][2 * half + 1]);
      } else {
        if (q < cols) p[q] = acc[qt][2 * half];
        if (q + 1 < cols) p[q + 1] = acc[qt][2 * half + 1];
      }
    }
  }
}

// what a warp's work reads: the staged chunk of one (b, group) and the
// buffers of the head being run
struct Ctx {
  int ldbc, Tp, Np, T, P, N;
  const float* bs;    // [Tp][ldbc]  B
  const float* cs;    // [Tp][ldbc]  C
  const float* xs;    // [Tp][kLdx]  x of this head
  const float* dts;   // [Tp]        dt of this head
  const float* acum;  // [Tp]
  const float* w;     // [Tp]        exp(a_cum[T-1] - a_cum) * dt
  size_t id;          // this head's (b*h, chunk): b*h * nc + chunk
  int lane, g8, t4;
};

// x's B fragments for all kQTiles column tiles, k slot t4 at row r and slot
// t4 + 4 at row r + 1 (the permuted k of M x and of the chunk state)
__device__ __forceinline__ void x_frags(const Ctx& c, int r, uint32_t (&bh)[kQTiles][2],
                                        uint32_t (&bl)[kQTiles][2]) {
  const float* x0 = c.xs + r * kLdx + c.g8;
#pragma unroll
  for (int qt = 0; qt < kQTiles; ++qt) split_b(x0[8 * qt], x0[kLdx + 8 * qt], bh[qt], bl[qt]);
}

// S = C B^T on rows i0 .. i0 + 15 and the NJT causal column tiles j < i0 + 16
template <int NJT>
__device__ __forceinline__ void cb_strip(const Ctx& c, int i0, float (&s)[NJT][4]) {
  const int ld = c.ldbc;
  const float* c0 = c.cs + (i0 + c.g8) * ld + c.t4;
  const float* b0 = c.bs + c.g8 * ld + c.t4;
  for (int k0 = 0; k0 < c.Np; k0 += 8) {
    uint32_t ah[4], al[4], bh[NJT][2], bl[NJT][2];
    split_a(c0[k0], c0[8 * ld + k0], c0[k0 + 4], c0[8 * ld + k0 + 4], ah, al);
#pragma unroll
    for (int jt = 0; jt < NJT; ++jt) {
      const float* br = b0 + 8 * jt * ld + k0;
      split_b(br[0], br[4], bh[jt], bl[jt]);
    }
    mma_3xtf32(s, ah, al, bh, bl);
  }
}

// rows i0 .. i0 + 15 of this head's y_intra from the strip's S: M = S *
// exp(a_cum[i] - a_cum[j]) * dt[j] (0 above the diagonal) in registers,
// then y = M x with M's A fragment taken from the accumulator: it holds
// columns 2 t4 and 2 t4 + 1 where the A fragment wants t4 and t4 + 4, so M x
// runs over a permuted k. The loop over column tiles is not unrolled (an
// unrolled one per strip length overflowed the instruction cache, 24 us a
// head): tile jt is always s[0], and s rotates by one tile a step, NJT steps
// bringing it back to where it was for the next head.
template <int NJT>
__device__ __forceinline__ void y_strip(const Ctx& c, int i0, float (&s)[NJT][4],
                                        float* __restrict__ y) {
  const int i_0 = i0 + c.g8, i_1 = i_0 + 8;
  const float ac0 = c.acum[i_0], ac1 = c.acum[i_1];
  float acc[kQTiles][4];
#pragma unroll
  for (int qt = 0; qt < kQTiles; ++qt) acc[qt][0] = acc[qt][1] = acc[qt][2] = acc[qt][3] = 0.f;
#pragma unroll 1
  for (int jt = 0; jt < NJT; ++jt) {
    const int j_0 = 8 * jt + 2 * c.t4, j_1 = j_0 + 1;
    const float aj0 = c.acum[j_0], aj1 = c.acum[j_1], d0 = c.dts[j_0], d1 = c.dts[j_1];
    const float m00 = i_0 >= j_0 ? s[0][0] * expf(ac0 - aj0) * d0 : 0.f;
    const float m01 = i_0 >= j_1 ? s[0][1] * expf(ac0 - aj1) * d1 : 0.f;
    const float m10 = i_1 >= j_0 ? s[0][2] * expf(ac1 - aj0) * d0 : 0.f;
    const float m11 = i_1 >= j_1 ? s[0][3] * expf(ac1 - aj1) * d1 : 0.f;
    uint32_t ah[4], al[4], bh[kQTiles][2], bl[kQTiles][2];
    split_a(m00, m10, m01, m11, ah, al);  // slot t4 <-> column j_0, slot t4 + 4 <-> j_1
    x_frags(c, j_0, bh, bl);
    mma_3xtf32(acc, ah, al, bh, bl);
    float first[4] = {s[0][0], s[0][1], s[0][2], s[0][3]};
#pragma unroll
    for (int u = 0; u + 1 < NJT; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[u][r] = s[u + 1][r];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[NJT - 1][r] = first[r];
  }
  store_rows(y, c.id * c.T, i_0, c.T, c.P, c.t4, acc);
}

// state rows k0 .. k0 + 15, all columns: states[k, q] = sum_t B[t, k] w[t]
// x[t, q], with t permuted as in y_strip so that B's transpose is read
// without bank conflicts
__device__ __forceinline__ void state_rows(const Ctx& c, int k0, float* __restrict__ states) {
  const int ld = c.ldbc;
  float acc[kQTiles][4];
#pragma unroll
  for (int qt = 0; qt < kQTiles; ++qt) acc[qt][0] = acc[qt][1] = acc[qt][2] = acc[qt][3] = 0.f;
  const float* b0 = c.bs + 2 * c.t4 * ld + k0 + c.g8;
  for (int t0 = 0; t0 < c.Tp; t0 += 8) {
    const int ta = t0 + 2 * c.t4;  // slot t4 <-> step ta, slot t4 + 4 <-> ta + 1
    const float wa = c.w[ta], wb = c.w[ta + 1];
    const float* ba = b0 + t0 * ld;
    uint32_t ah[4], al[4], bh[kQTiles][2], bl[kQTiles][2];
    split_a(ba[0] * wa, ba[8] * wa, ba[ld] * wb, ba[ld + 8] * wb, ah, al);
    x_frags(c, ta, bh, bl);
    mma_3xtf32(acc, ah, al, bh, bl);
  }
  store_rows(states, c.id * c.N, k0 + c.g8, c.N, c.P, c.t4, acc);
}

// a_cum = cumsum(a) over the chunk by one warp (lane l sums steps 4l ..
// 4l + 3, then the lanes' totals are scanned with shuffles); padded steps
// add 0. Then w and the chunk's total decay.
__device__ __forceinline__ void scan_head(const float* a, const float* dts, float* acum,
                                          float* w, int T, int Tp, int lane,
                                          float* chunk_decay) {
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    run += t < Tp ? a[t] : 0.f;
    v[u] = run;
  }
  float total = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, total, off);
    if (lane >= off) total += o;
  }
  const float before = total - run;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    if (t < Tp) acum[t] = v[u] + before;
  }
  __syncwarp();
  const float a_last = acum[T - 1];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    if (t < Tp) w[t] = t < T ? expf(a_last - acum[t]) * dts[t] : 0.f;
  }
  if (lane == 0) *chunk_decay = expf(a_last);
}

struct Args {
  const float *x, *dt, *a, *B, *C;
  float *y, *states, *c_decay, *chunk_decay;
  int H, G, nc, T, P, N;
  bool vec;
};

// x, dt and a of one head into buffer `buf` (cp.async; rows t < T only:
// the padding was zeroed once)
__device__ __forceinline__ void fetch_head(const Args& p, size_t id, float* xs, float* dts,
                                           float* as, int warp, int lane, int tid) {
  for (int t = warp; t < p.T; t += kWarps)
    copy_row(xs + t * kLdx, p.x + (id * p.T + t) * p.P, p.P, p.vec, lane);
  for (int t = tid; t < p.T; t += kThreads) {
    cp_async4(dts + t, p.dt + id * p.T + t);
    cp_async4(as + t, p.a + id * p.T + t);
  }
  cp_async_commit();
}

// one warp's part of a block: the head slice's heads in turn, x, dt and a of
// the next head in flight while this one runs. NJT > 0: the warp owns a
// 16-row strip, whose S = C B^T it computes once and keeps in registers.
template <int NJT>
__device__ __forceinline__ void run_heads(const Args& p, Ctx c, int i0, size_t first_id,
                                          int heads, float* xs, float* dtb, float* ab,
                                          float* acum, float* w, int* next_item, int warp,
                                          int tid) {
  constexpr int kS = NJT > 0 ? NJT : 1;
  float s[kS][4];
#pragma unroll
  for (int jt = 0; jt < kS; ++jt) s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.f;
  const int buf_x = c.Tp * kLdx;
  for (int hh = 0; hh < heads; ++hh) {
    const int cur = hh & 1;
    c.id = first_id + (size_t)hh * p.nc;  // the next head's chunk is nc further on
    if (hh + 1 < heads) {
      fetch_head(p, c.id + p.nc, xs + (cur ^ 1) * buf_x, dtb + (cur ^ 1) * c.Tp,
                 ab + (cur ^ 1) * c.Tp, warp, c.lane, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this head's x, dt, a (and B, C) are in shared memory
    c.xs = xs + cur * buf_x;
    c.dts = dtb + cur * c.Tp;
    if (warp == 0)
      scan_head(ab + cur * c.Tp, c.dts, acum, w, c.T, c.Tp, c.lane, p.chunk_decay + c.id);
    if constexpr (NJT > 0) {
      if (hh == 0) cb_strip<NJT>(c, i0, s);
    }
    __syncthreads();  // a_cum and w
    if constexpr (NJT > 0) y_strip<NJT>(c, i0, s, p.y);
    // then, to whichever warp is free: the chunk state 16 rows at a time,
    // and c_decay 16 rows at a time (its stores among the other warps' math)
    const int state_items = c.Np / 16;
    const int items = state_items + (c.T + 15) / 16;
    for (;;) {
      int item = 0;
      if (c.lane == 0) item = atomicAdd(next_item + hh, 1);
      item = __shfl_sync(0xffffffffu, item, 0);
      if (item >= items) break;
      if (item < state_items) {
        state_rows(c, 16 * item, p.states);
        continue;
      }
      const int t0 = 16 * (item - state_items);
      for (int t = t0; t < min(t0 + 16, c.T); ++t) {
        const float decay_in = expf(acum[t]);
        float* out = p.c_decay + (c.id * c.T + t) * c.N;
        for (int k = c.lane; k < c.N; k += 32) out[k] = c.cs[t * c.ldbc + k] * decay_in;
      }
    }
    __syncthreads();  // every warp is done with this head's buffers
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_kernel(const Args p, int head_slice, int slices) {
  extern __shared__ float4 smem4[];
  __shared__ int next_item[kMaxHeadSlice];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout l = make_layout(p.T, p.N);
  float* bs = smem;                          // [Tp][ldbc]     B rows of this chunk and group
  float* cs = bs + (size_t)l.Tp * l.ldbc;    // [Tp][ldbc]     C
  float* xs = cs + (size_t)l.Tp * l.ldbc;    // [2][Tp][kLdx]  x of this head and the next
  float* dtb = xs + (size_t)2 * l.Tp * kLdx; // [2][Tp]        dt
  float* ab = dtb + 2 * l.Tp;                // [2][Tp]        a
  float* acum = ab + 2 * l.Tp;               // [Tp]
  float* w = acum + l.Tp;                    // [Tp]

  // block -> (b, chunk, group, head slice), slices fastest: the blocks of
  // one group's heads read the same B and C rows one after another
  const int per_group = p.H / p.G;
  const int sl = blockIdx.x % slices;
  int rest = blockIdx.x / slices;
  const int gi = rest % p.G;
  rest /= p.G;
  const int c = rest % p.nc;
  const int bi = rest / p.nc;
  const int head0 = gi * per_group + sl * head_slice;
  const int heads = min(head_slice, per_group - sl * head_slice);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // B and C rows t of this chunk and group ((b, nc*T, G, N) row-major), with
  // the first head's x, dt and a; padding rows and columns zeroed once
  const size_t row_stride = (size_t)p.G * p.N;
  const size_t bc_base =
      ((size_t)bi * p.nc * p.T + (size_t)c * p.T) * row_stride + (size_t)gi * p.N;
  for (int t = warp; t < l.Tp; t += kWarps) {
    float* brow = bs + t * l.ldbc;
    float* crow = cs + t * l.ldbc;
    if (t < p.T) {
      copy_row(brow, p.B + bc_base + t * row_stride, p.N, p.vec, lane);
      copy_row(crow, p.C + bc_base + t * row_stride, p.N, p.vec, lane);
    }
    const int k_from = t < p.T ? p.N : 0, q_from = t < p.T ? p.P : 0;
    zero_row(brow, k_from, l.Np, lane);
    zero_row(crow, k_from, l.Np, lane);
    zero_row(xs + t * kLdx, q_from, kMaxP, lane);
    zero_row(xs + (l.Tp + t) * kLdx, q_from, kMaxP, lane);
  }
  for (int t = p.T + tid; t < l.Tp; t += kThreads)
    dtb[t] = dtb[l.Tp + t] = ab[t] = ab[l.Tp + t] = 0.f;
  if (tid < kMaxHeadSlice) next_item[tid] = 0;
  const size_t first_id = ((size_t)bi * p.H + head0) * p.nc + c;  // (b*h, chunk) of head0
  fetch_head(p, first_id, xs, dtb, ab, warp, lane, tid);

  const Ctx ctx{l.ldbc, l.Tp, l.Np, p.T, p.P, p.N, bs, cs, xs, dtb, acum, w, first_id, lane,
                lane >> 2, lane & 3};
  // warps w and w + 4 share a scheduler, so they take strips w and 7 - w
  const int strip = warp < 4 ? warp : 11 - warp;
  const int i0 = 16 * strip;
#define SSD_RUN(NJT) \
  run_heads<NJT>(p, ctx, i0, first_id, heads, xs, dtb, ab, acum, w, next_item, warp, tid)
  switch (strip < l.Tp / 16 ? strip : -1) {
    case 0: SSD_RUN(2); break;
    case 1: SSD_RUN(4); break;
    case 2: SSD_RUN(6); break;
    case 3: SSD_RUN(8); break;
    case 4: SSD_RUN(10); break;
    case 5: SSD_RUN(12); break;
    case 6: SSD_RUN(14); break;
    case 7: SSD_RUN(16); break;
    default: SSD_RUN(0); break;  // no strip: c_decay and the chunk state only
  }
#undef SSD_RUN
}

}  // namespace

// x (b*h, nc, T, P), dt and a (b*h, nc, T), B and C (b, nc*T, G, N); outputs
// y (b*h, nc, T, P), states (b*h, nc, N, P), c_decay (b*h, nc, T, N),
// chunk_decay (b*h, nc). All float32, contiguous, on `device`. A block runs
// head_slice heads of one group (kernels/ssd_scan.py:head_slice picks it).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_chunks_launch(const void* x, const void* dt, const void* a, const void* B,
                                 const void* C, void* y, void* states, void* c_decay,
                                 void* chunk_decay, int b, int h, int g, int nc, int T, int P,
                                 int N, int head_slice, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || h < 1 || g < 1 || h % g != 0 || nc < 1 || T < 1 || T > kMaxT || N < 1 ||
      N > kMaxN || P < 1 || P > kMaxP || head_slice < 1 || head_slice > kMaxHeadSlice)
    return (int)cudaErrorInvalidValue;
  const int slices = (h / g + head_slice - 1) / head_slice;
  const long long blocks = (long long)b * nc * g * slices;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(make_layout(T, N));
  if (bytes > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // once per device, so that a launch captured in a CUDA graph makes no
  // other runtime call than the launch itself
  static bool smem_opt_in[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_opt_in[device]) {
    err = cudaFuncSetAttribute(ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_opt_in[device] = true;
  }
  // 16-byte copies where every row of B, C and x starts 16-byte aligned
  const bool vec = N % 4 == 0 && P % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)B | (uintptr_t)C) % 16 == 0;
  const Args args{(const float*)x, (const float*)dt, (const float*)a, (const float*)B,
                  (const float*)C, (float*)y, (float*)states, (float*)c_decay,
                  (float*)chunk_decay, h, g, nc, T, P, N, vec};
  ssd_chunk_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      args, head_slice, slices);
  return (int)cudaGetLastError();
}
