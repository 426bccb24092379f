// Mamba2 SSD backward on Hopper: the gradients of the chunked scan of
// kernels/ops.py:ssd_scan_chunked (csrc/ssd_scan.cu's chunk block, the
// inter-chunk recurrence and the state-output product) with respect to x,
// dt, A, B, C and the initial state.
//
// Replaces no TPU kernel: the reference's backward is jnp, the VJP of
// ssd_scan_ref under src/repro/kernels/ops.py:_ssd_vjp. The port ran its
// plain PyTorch copy (autograd through kernels/ref.py:ssd_scan_ref) on the
// card: f32 einsums that lower to gemv and (b, nc, h, T, T) temporaries,
// about 1.2 s of mamba2-130m's 1.68 s training step.
//
// The forward, per (b*h, chunk c) of T steps, a = dt * A:
//   cum = cumsum(a);  L[t, s] = exp(cum_t - cum_s) (t >= s);  S = C B^T
//   M = S o L o dt_s;  y = M x + exp(cum_t) C_t H_c
//   H_{c+1} = exp(cum_{T-1}) H_c + (B o w)^T x,  w_s = exp(cum_{T-1} - cum_s) dt_s
// and its gradient, G_c the gradient of H_{c+1}:
//   Z_c = (C o exp(cum))^T dY;  G_{c-1} = exp(cum_{T-1}) G_c + Z_c;  d h0 = G_{-1}
//   dM = dY x^T;  dS = dM o L o dt_s;  R = dM o S o L;  Q = R o dt_s
//   dx = M^T dY + (B o w) G;  dB = dS^T C + w o (x G^T);  dC = dS B + exp(cum) o (dY H^T)
//   d cum_t = sum_s Q[t, s] - sum_t' Q[t', t] + exp(cum_t) dY_t . (C H_c)_t
//             - w_t dw_t + [t = T-1] (sum_s w_s dw_s + exp(cum_{T-1}) <G_c, H_c>),
//   dw = rowdot(x, B G);  d a = reverse cumsum of d cum
//   d dt = sum_t R[t, s] + dw o exp(cum_{T-1} - cum) + d a * A;  dA = sum d a * dt
// dB and dC are summed over the heads of a group.
//
// What bounds it on an H100: bytes. At mamba2-130m's training shape (b 2,
// s 4,096, 24 heads of 64, state 128, one group, T 128: b*h 48 x 32 chunks)
// the products are twice the forward's: dS B and dS^T C once a group, dM
// and M^T dY a head on the causal pairs, x G^T, (B o w) G, dY H^T and Z a
// head at T*n*p; 16.4 GFLOP a layer (22.6 with the dS products a head),
// 0.033 ms at the TF32 rate of 495 TFLOP/s (3xTF32 takes three times the
// tensor-core work, and this design adds C H a head for d cum: 0.12 ms at
// that rate). The f32 bytes of x, dY, dx, G, H and Z (12.6 M elements
// each) and of B, C, dB and dC are 320 MB, 0.096 ms at 3.35 TB/s
// (chipbench/metrics/ssd_bwd_roofline.train.py counts the same).
//
// Design (the forward's split: chunk-parallel kernels around the sequential
// scan over chunks, which kernels/ssd_bwd.py runs as torch ops):
// * A block runs a slice of one group's heads on one (batch row, chunk), as
//   the forward (kernels/ssd_scan.py:head_slice picks the slice: 12 heads at
//   mamba2-130m's shapes, 28 at zamba2-7b's). B and C are staged once a
//   block and S = C B^T is computed once for the slice; dB and dC are summed
//   over the slice's heads inside the block, and each slice writes its own
//   partial, summed by the wrapper in a fixed order. There are no float
//   atomics: every output element is written by one thread of one block,
//   so the gradients repeat bit for bit (an int counter in shared memory
//   only hands out work, as the forward's does).
// * ssd_bwd_intra_kernel (before the scan): a warp owns a 16-row strip of
//   source steps s. Once a block it computes S^T on the strip's t >= s and
//   keeps it in registers; for each head it computes dM^T = x dY^T two
//   8-column tiles at a time (each 3xTF32 term in its own accumulator: six
//   short chains of products in place of one long one), forms M^T, dS^T, R
//   and Q in registers, runs dx += M^T dY with the accumulator as the A
//   fragment (k permuted, as the forward's y_strip), adds dS^T into an f32
//   [s][t] tile in shared memory (B's space, once S^T is in registers) and
//   sums R and Q by row and (by shuffles across the strip, then over the
//   warps in a fixed order) by column. Then Z = (C o exp(cum))^T dY, 16
//   state rows at a time to whichever warp is free (strip 0 has 8 times the
//   column tiles of strip 7). After the last head B is staged again (x's
//   space) and dB = (sum dS)^T C and dC = (sum dS) B run once for the slice.
// * ssd_bwd_state_kernel (after the scan): twice over the slice's heads,
//   once with (B, x, G, w) and once with (C, dY, H, exp(cum)): P = B G (or
//   C H) gives dx += w o P and dw (or the y-state term of d cum), and the
//   strip's dB (or dC) += (w o x) G^T (or (exp(cum) o dY) H^T) sums over the
//   heads in registers, with each head's x and G (dY and H) loaded by
//   cp.async while the one before runs (two buffers). Then
//   ssd_bwd_finish_kernel, a warp a (b*h, chunk), folds the row vectors into
//   d cum, takes its reverse cumsum by shuffles and writes d dt and the
//   chunk's part of dA (in the state kernel, one warp doing this after each
//   head held the other seven at the next head's barrier).
// * All products are mma.sync m16n8k8 TF32 with f32 accumulation, in 3xTF32
//   (the forward's split: each f32 operand hi + lo, lo lo dropped), so they
//   keep about f32 accuracy with TF32 off everywhere else; row strides are
//   4 or 8 mod 32 floats, so fragment loads do not conflict on banks but for
//   the A operand of dC (two ways). The exponentials are the accurate expf.
// * Limits of the forward: T <= 128, n <= 128, p <= 64, T and n zero-padded
//   to multiples of 16, p to 64 columns; 214,016 and 211,968 bytes of
//   shared memory at the largest shape, one block of 8 warps per SM.
// * Kernel names hold "ssd_bwd" and never the forward's "ssd_chunk".

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxHeadSlice = 32;
constexpr int kLdx = kMaxP + 4;     // rows of x, dY, G and H in shared memory
constexpr int kPanel = 64;          // output columns a pass: kQTiles tiles of 8
constexpr int kQTiles = kPanel / 8;
constexpr int kMaxTiles = kMaxT / 8;  // column tiles of the longest strip
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// padded sizes and row strides (floats): B and C rows of the intra kernel
// (ldbc, 4 mod 32: natural and permuted-k fragment loads), dS^T rows (lds,
// 8 mod 32: float2 loads at a permuted k) and B or C rows of the state kernel
// (ldm, 8 mod 32, the same)
struct Dims {
  int Tp, Np, Nq, Pp, ldbc, lds, ldm;
};

__host__ __device__ __forceinline__ Dims make_dims(int T, int N, int P) {
  Dims d;
  d.Tp = round_up(T, 16);
  d.Np = round_up(N, 16);
  d.Nq = round_up(N, kPanel);
  d.Pp = round_up(P, 8);
  d.ldbc = d.Nq + 4;
  d.lds = round_up(d.Tp, 32) + 8;
  d.ldm = round_up(d.Np, 32) + 8;
  return d;
}

// intra: B then the summed dS^T; C; x and dY (then B again); dt, a, cum,
// exp(cum), the row sums of R and Q; the warps' column sums of Q
__host__ __device__ __forceinline__ size_t intra_floats(const Dims& d) {
  return (size_t)d.Tp * imax(d.ldbc, d.lds) + (size_t)d.Tp * d.ldbc + (size_t)2 * d.Tp * kLdx +
         (size_t)(6 + kWarps) * d.Tp;
}

// state: B or C; x or dY of two heads; G or H of two heads; dt and a of two
// heads, cum, and w or exp(cum)
__host__ __device__ __forceinline__ size_t state_floats(const Dims& d) {
  return (size_t)d.Tp * d.ldm + (size_t)2 * d.Tp * kLdx + (size_t)2 * d.Nq * kLdx +
         (size_t)6 * d.Tp;
}

constexpr int kIntraMaxBytes =
    4 * (kMaxT * (kMaxT + 8) + kMaxT * (kMaxN + 4) + 2 * kMaxT * kLdx + (6 + kWarps) * kMaxT);
constexpr int kStateMaxBytes =
    4 * (kMaxT * (kMaxN + 8) + 2 * kMaxT * kLdx + 2 * kMaxN * kLdx + 6 * kMaxT);

// v = hi + lo to about 21 significant bits (csrc/ssd_scan.cu's split)
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

// d[j] += a b[j] over NT tiles in 3xTF32: the two cross terms, then hi hi
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

// the A fragment: rows g, g + 8 at k slot t (v0, v1) and t + 4 (v2, v3)
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

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

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

// rows [0, rows) of a (src_rows x cols) row-major matrix into shared memory
// rows of stride ld, by warps; columns [cols, width) and rows [rows, padded)
// zeroed
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, size_t src_stride,
                                      int rows, int padded, int cols, int width, bool vec,
                                      int warp, int lane) {
  for (int r = warp; r < padded; r += kWarps) {
    float* row = dst + (size_t)r * ld;
    if (r < rows) copy_row(row, src + (size_t)r * src_stride, cols, vec, lane);
    zero_row(row, r < rows ? cols : 0, width, lane);
  }
}

// rows r0 and r0 + 8 of a 16 x 64 accumulator panel into out[(row0 + r) *
// stride + q] for r < rows, q < cols (out at the panel's first column);
// kAdd adds to what is there
template <bool kAdd>
__device__ __forceinline__ void put_panel(float* __restrict__ out, size_t row0, size_t stride,
                                          int r0, int rows, int cols, int t4,
                                          const float (&acc)[kQTiles][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= rows) continue;
    float* p = out + (row0 + r) * stride;
#pragma unroll
    for (int qt = 0; qt < kQTiles; ++qt) {
      const int q = 8 * qt + 2 * t4;
      if (q < cols) p[q] = kAdd ? p[q] + acc[qt][2 * half] : acc[qt][2 * half];
      if (q + 1 < cols) p[q + 1] = kAdd ? p[q + 1] + acc[qt][2 * half + 1] : acc[qt][2 * half + 1];
    }
  }
}

// B fragments of all kQTiles column tiles from a k-major operand of stride
// ld: k slot t4 at row r, slot t4 + 4 at row r + 1 (the permuted k)
__device__ __forceinline__ void kmajor_frags(const float* m, int ld, int r, int g8,
                                             uint32_t (&bh)[kQTiles][2],
                                             uint32_t (&bl)[kQTiles][2]) {
  const float* m0 = m + r * ld + g8;
#pragma unroll
  for (int qt = 0; qt < kQTiles; ++qt) split_b(m0[8 * qt], m0[ld + 8 * qt], bh[qt], bl[qt]);
}

// cum = cumsum(a) over the chunk by one warp, as csrc/ssd_scan.cu's
// scan_head (the same sums in the same order); padded steps add 0
__device__ __forceinline__ void prefix_sum(const float* a, float* cum, int Tp, int lane) {
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
    if (t < Tp) cum[t] = v[u] + before;
  }
  __syncwarp();
}

// block -> (b, chunk, group, head slice), slices fastest (the forward's order)
struct BlockPos {
  int bi, c, gi, sl, head0, heads;
};

__device__ __forceinline__ BlockPos block_pos(int H, int G, int nc, int head_slice, int slices) {
  BlockPos bp;
  bp.sl = blockIdx.x % slices;
  int rest = blockIdx.x / slices;
  bp.gi = rest % G;
  rest /= G;
  bp.c = rest % nc;
  bp.bi = rest / nc;
  const int per_group = H / G;
  bp.head0 = bp.gi * per_group + bp.sl * head_slice;
  bp.heads = min(head_slice, per_group - bp.sl * head_slice);
  return bp;
}

// ---------------------------------------------------------------------------
// ssd_bwd_intra_kernel
// ---------------------------------------------------------------------------

struct IntraArgs {
  const float *x, *dt, *a, *B, *C, *dy;
  float *dx, *z, *ddt, *dcum, *decay, *dBp, *dCp;
  int b, H, G, nc, T, P, N;
  bool vec;
};

struct IntraCtx {
  int T, P, N, Tp, Np, Pp, lds, ldbc;
  float* ds;          // [Tp][lds]   dS^T summed over the slice's heads
  const float* cs;    // [Tp][ldbc]  C
  const float* xs;    // [Tp][kLdx]  x of this head
  const float* ys;    // [Tp][kLdx]  dY of this head
  const float* dts;   // [Tp]
  const float* cum;   // [Tp]
  const float* ein;   // [Tp]        exp(cum), 0 past T
  float* ddt_row;     // [Tp]        sum_t R[t, s]
  float* dcum_row;    // [Tp]        -sum_t Q[t, s]
  float* qpart;       // [kWarps][Tp] sum over a warp's rows s of Q[t, s]
  size_t id;          // this head's (b*h, chunk)
  int lane, g8, t4, warp;
};

// S^T[s, t] = B_s . C_t on the strip's rows s = i0 .. i0 + 15 and its njt
// column tiles t = i0 .. i0 + 8 njt - 1 (t >= s lies there); st[jt] for
// jt >= njt stays 0
__device__ __forceinline__ void st_strip(const float* bs, const float* cs, int ld, int Np,
                                         int i0, int njt, int g8, int t4,
                                         float (&st)[kMaxTiles][4]) {
  zero_acc(st);
  const float* a0 = bs + (i0 + g8) * ld + t4;
  const float* b0 = cs + (i0 + g8) * ld + t4;
  for (int k0 = 0; k0 < Np; k0 += 8) {
    uint32_t ah[4], al[4];
    split_a(a0[k0], a0[8 * ld + k0], a0[k0 + 4], a0[8 * ld + k0 + 4], ah, al);
#pragma unroll
    for (int jt = 0; jt < kMaxTiles; ++jt) {
      if (jt < njt) {
        const float* br = b0 + 8 * jt * ld + k0;
        uint32_t bh[2], bl[2];
        split_b(br[0], br[4], bh, bl);
        mma_tf32(st[jt], al, bh[0], bh[1]);
        mma_tf32(st[jt], ah, bl[0], bl[1]);
        mma_tf32(st[jt], ah, bh[0], bh[1]);
      }
    }
  }
}

// dM^T[s, t] = x_s . dY_t on the strip's rows and the column tiles tt and
// tt + 8: the three 3xTF32 terms of each tile in accumulators of their own,
// so that six chains of at most kMaxP / 8 products run side by side (one
// chain of 3 Pp / 8 a tile took most of a head's time), summed at the end
__device__ __forceinline__ void dm_pair(const IntraCtx& c, const float* xa, int tt,
                                        float (&dm)[2][4]) {
  float lh[2][4], hl[2][4], hh[2][4];
  zero_acc(lh);
  zero_acc(hl);
  zero_acc(hh);
  const float* yb = c.ys + (tt + c.g8) * kLdx + c.t4;
#pragma unroll
  for (int k0 = 0; k0 < kMaxP; k0 += 8) {
    if (k0 < c.Pp) {
      uint32_t ah[4], al[4], bh[2][2], bl[2][2];
      split_a(xa[k0], xa[8 * kLdx + k0], xa[k0 + 4], xa[8 * kLdx + k0 + 4], ah, al);
      split_b(yb[k0], yb[k0 + 4], bh[0], bl[0]);
      split_b(yb[8 * kLdx + k0], yb[8 * kLdx + k0 + 4], bh[1], bl[1]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mma_tf32(lh[u], al, bh[u][0], bh[u][1]);
        mma_tf32(hl[u], ah, bl[u][0], bl[u][1]);
        mma_tf32(hh[u], ah, bh[u][0], bh[u][1]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) dm[u][r] = hh[u][r] + (lh[u][r] + hl[u][r]);
}

// one head on the strip's rows s, two column tiles a step: dM^T (dm_pair),
// then M^T, dS^T, R and Q in registers; dx = M^T dY; dS^T into the slice's
// sum; R and Q summed by row (ddt_row, dcum_row) and by column (qpart).
// Tiles jt and jt + 1 are always st[0] and st[1]: st rotates by two tiles a
// step (the forward's y_strip rotates by one), and every warp takes all
// kMaxTiles / 2 steps, working on the first njt / 2, so st is back where it
// was for the next head. One code path for every strip length: a copy a
// length (the forward's) kept eight loop bodies in the instruction cache.
__device__ __forceinline__ void intra_strip(const IntraCtx& c, int i0, int njt,
                                            float (&st)[kMaxTiles][4], bool first,
                                            float* __restrict__ dx) {
  const int s0 = i0 + c.g8, s1 = s0 + 8;
  const float cs0 = c.cum[s0], cs1 = c.cum[s1], d0 = c.dts[s0], d1 = c.dts[s1];
  float acc[kQTiles][4];
  zero_acc(acc);
  float rr0 = 0.f, rr1 = 0.f, rq0 = 0.f, rq1 = 0.f;
  const float* xa = c.xs + s0 * kLdx + c.t4;
#pragma unroll 1
  for (int jt = 0; jt < kMaxTiles; jt += 2) {
    if (jt < njt) {  // past the strip, st only keeps turning
      float dm[2][4];
      dm_pair(c, xa, i0 + 8 * jt, dm);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t0 = i0 + 8 * (jt + u) + 2 * c.t4, t1 = t0 + 1;
        const float ct0 = c.cum[t0], ct1 = c.cum[t1];
        // element e: row s0 (e 0, 1) or s1 (e 2, 3), column t0 (e 0, 2) or t1 (e 1, 3)
        float mt[4], dst[4], q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? s0 : s1, t = (e & 1) ? t1 : t0;
          const float cums = e < 2 ? cs0 : cs1, dtv = e < 2 ? d0 : d1,
                      cumt = (e & 1) ? ct1 : ct0;
          const bool on = t >= s && t < c.T;
          const float L = on ? expf(cumt - cums) : 0.f;
          const float sv = st[u][e], dv = dm[u][e];
          mt[e] = sv * L * dtv;
          dst[e] = dv * L * dtv;
          const float r = dv * sv * L;
          q[e] = t > s ? r * dtv : 0.f;  // the diagonal's L is 1 whatever cum is
          if (e < 2) {
            rr0 += r;
            rq0 += q[e];
          } else {
            rr1 += r;
            rq1 += q[e];
          }
        }
        {
          uint32_t ah[4], al[4], bh[kQTiles][2], bl[kQTiles][2];
          split_a(mt[0], mt[2], mt[1], mt[3], ah, al);  // slot t4 <-> t0, slot t4 + 4 <-> t1
          kmajor_frags(c.ys, kLdx, t0, c.g8, bh, bl);
          mma_3xtf32(acc, ah, al, bh, bl);
        }
        float2* p0 = reinterpret_cast<float2*>(c.ds + s0 * c.lds + t0);
        float2* p1 = reinterpret_cast<float2*>(c.ds + s1 * c.lds + t0);
        if (first) {
          *p0 = make_float2(dst[0], dst[1]);
          *p1 = make_float2(dst[2], dst[3]);
        } else {
          float2 v0 = *p0, v1 = *p1;
          v0.x += dst[0];
          v0.y += dst[1];
          v1.x += dst[2];
          v1.y += dst[3];
          *p0 = v0;
          *p1 = v1;
        }
        float c0 = q[0] + q[2], c1 = q[1] + q[3];  // over the strip's rows, by shuffles
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, off);
          c1 += __shfl_xor_sync(0xffffffffu, c1, off);
        }
        if (c.g8 == 0) {
          c.qpart[c.warp * c.Tp + t0] = c0;
          c.qpart[c.warp * c.Tp + t1] = c1;
        }
      }
    }
    float head[2][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) head[0][r] = st[0][r], head[1][r] = st[1][r];
#pragma unroll
    for (int u = 0; u + 2 < kMaxTiles; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[u][r] = st[u + 2][r];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      st[kMaxTiles - 2][r] = head[0][r];
      st[kMaxTiles - 1][r] = head[1][r];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rr0 += __shfl_xor_sync(0xffffffffu, rr0, off);
    rr1 += __shfl_xor_sync(0xffffffffu, rr1, off);
    rq0 += __shfl_xor_sync(0xffffffffu, rq0, off);
    rq1 += __shfl_xor_sync(0xffffffffu, rq1, off);
  }
  if (c.t4 == 0) {
    c.ddt_row[s0] = rr0;
    c.ddt_row[s1] = rr1;
    c.dcum_row[s0] = -rq0;
    c.dcum_row[s1] = -rq1;
  }
  put_panel<false>(dx, c.id * c.T, c.P, s0, c.T, c.P, c.t4, acc);
}

// Z rows k0 .. k0 + 15: Z[k, q] = sum_t C[t, k] exp(cum_t) dY[t, q], t
// permuted so that C's transpose is read without bank conflicts
__device__ __forceinline__ void z_rows(const IntraCtx& c, int k0, float* __restrict__ z) {
  float acc[kQTiles][4];
  zero_acc(acc);
  const float* cb = c.cs + 2 * c.t4 * c.ldbc + k0 + c.g8;
  for (int t0 = 0; t0 < c.Tp; t0 += 8) {
    const int ta = t0 + 2 * c.t4;
    const float ea = c.ein[ta], eb = c.ein[ta + 1];
    const float* ca = cb + t0 * c.ldbc;
    uint32_t ah[4], al[4], bh[kQTiles][2], bl[kQTiles][2];
    split_a(ca[0] * ea, ca[8] * ea, ca[c.ldbc] * eb, ca[c.ldbc + 8] * eb, ah, al);
    kmajor_frags(c.ys, kLdx, ta, c.g8, bh, bl);
    mma_3xtf32(acc, ah, al, bh, bl);
  }
  put_panel<false>(z, c.id * c.N, c.P, k0 + c.g8, c.N, c.P, c.t4, acc);
}

// dB rows s = i0 .. i0 + 15 of the slice: sum_t dS^T[s, t] C[t, :] over
// t >= i0, a 64-column panel at a time; dS^T read at a permuted k by float2
__device__ __forceinline__ void db_rows(const IntraCtx& c, int i0, float* __restrict__ out,
                                        size_t row0, size_t stride) {
  const int s0 = i0 + c.g8;
  for (int pn = 0; pn < c.N; pn += kPanel) {
    float acc[kQTiles][4];
    zero_acc(acc);
    for (int k0 = i0; k0 < c.Tp; k0 += 8) {
      const float2 u = *reinterpret_cast<const float2*>(c.ds + s0 * c.lds + k0 + 2 * c.t4);
      const float2 v =
          *reinterpret_cast<const float2*>(c.ds + (s0 + 8) * c.lds + k0 + 2 * c.t4);
      uint32_t ah[4], al[4], bh[kQTiles][2], bl[kQTiles][2];
      split_a(u.x, v.x, u.y, v.y, ah, al);
      kmajor_frags(c.cs + pn, c.ldbc, k0 + 2 * c.t4, c.g8, bh, bl);
      mma_3xtf32(acc, ah, al, bh, bl);
    }
    put_panel<false>(out + pn, row0, stride, s0, c.T, min(kPanel, c.N - pn), c.t4, acc);
  }
}

// dC rows t = i0 .. i0 + 15 of the slice: sum_s dS^T[s, t] B[s, :] over
// s < i0 + 16, B staged again at `bs` (stride ldbc)
__device__ __forceinline__ void dc_rows(const IntraCtx& c, const float* bs, int i0,
                                        float* __restrict__ out, size_t row0, size_t stride) {
  for (int pn = 0; pn < c.N; pn += kPanel) {
    float acc[kQTiles][4];
    zero_acc(acc);
    for (int k0 = 0; k0 < i0 + 16; k0 += 8) {
      const float* d0 = c.ds + (k0 + 2 * c.t4) * c.lds + i0 + c.g8;
      uint32_t ah[4], al[4], bh[kQTiles][2], bl[kQTiles][2];
      split_a(d0[0], d0[8], d0[c.lds], d0[c.lds + 8], ah, al);
      kmajor_frags(bs + pn, c.ldbc, k0 + 2 * c.t4, c.g8, bh, bl);
      mma_3xtf32(acc, ah, al, bh, bl);
    }
    put_panel<false>(out + pn, row0, stride, i0 + c.g8, c.T, min(kPanel, c.N - pn), c.t4, acc);
  }
}

// x, dY, dt and a of one head (cp.async, rows t < T; the padding was zeroed
// once)
__device__ __forceinline__ void fetch_intra(const IntraArgs& p, size_t id, float* xs, float* ys,
                                            float* dts, float* as, int warp, int lane, int tid) {
  for (int t = warp; t < p.T; t += kWarps) {
    copy_row(xs + t * kLdx, p.x + (id * p.T + t) * p.P, p.P, p.vec, lane);
    copy_row(ys + t * kLdx, p.dy + (id * p.T + t) * p.P, p.P, p.vec, lane);
  }
  for (int t = tid; t < p.T; t += kThreads) {
    cp_async4(dts + t, p.dt + id * p.T + t);
    cp_async4(as + t, p.a + id * p.T + t);
  }
  cp_async_commit();
}

__device__ __forceinline__ void run_intra(const IntraArgs& p, IntraCtx c, const BlockPos& bp,
                                          int i0, int njt, const float* bs, float* xs,
                                          float* ys, float* dts, float* as, float* cum,
                                          float* ein, int* next_item, int tid) {
  float st[kMaxTiles][4];
  if (njt > 0) st_strip(bs, c.cs, c.ldbc, c.Np, i0, njt, c.g8, c.t4, st);
  __syncthreads();  // B's space now takes the summed dS^T
  const size_t first_id = ((size_t)bp.bi * p.H + bp.head0) * p.nc + bp.c;
  for (int hh = 0; hh < bp.heads; ++hh) {
    c.id = first_id + (size_t)hh * p.nc;
    if (hh > 0) {
      fetch_intra(p, c.id, xs, ys, dts, as, c.warp, c.lane, tid);
      cp_async_wait<0>();
      __syncthreads();
    }
    if (c.warp == 0) {
      prefix_sum(as, cum, c.Tp, c.lane);
      for (int t = c.lane; t < c.Tp; t += 32) ein[t] = t < c.T ? expf(cum[t]) : 0.f;
      if (c.lane == 0) p.decay[c.id] = expf(cum[c.T - 1]);
    }
    __syncthreads();  // cum and exp(cum)
    if (njt > 0) intra_strip(c, i0, njt, st, hh == 0, p.dx);
    // then Z, 16 state rows at a time, to whichever warp is free (a counter
    // in shared memory), so the warps with short strips take more
    for (;;) {
      int item = 0;
      if (c.lane == 0) item = atomicAdd(next_item + hh, 1);
      item = __shfl_sync(0xffffffffu, item, 0);
      if (16 * item >= c.Np) break;
      z_rows(c, 16 * item, p.z);
    }
    __syncthreads();  // the row and column sums of every strip
    for (int t = tid; t < c.T; t += kThreads) {
      float v = c.dcum_row[t];
      for (int w = 0; w < kWarps; ++w) v += c.qpart[w * c.Tp + t];
      p.dcum[c.id * c.T + t] = v;
      p.ddt[c.id * c.T + t] = c.ddt_row[t];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_intra_kernel(const IntraArgs p, int head_slice, int slices) {
  extern __shared__ float4 smem4[];
  __shared__ int next_item[kMaxHeadSlice];  // each head's next Z item
  float* smem = reinterpret_cast<float*>(smem4);
  const Dims d = make_dims(p.T, p.N, p.P);
  float* r1 = smem;                                         // B, then dS^T summed
  float* cs = r1 + (size_t)d.Tp * imax(d.ldbc, d.lds);      // C
  float* xs = cs + (size_t)d.Tp * d.ldbc;                   // x, then B again
  float* ys = xs + (size_t)d.Tp * kLdx;                     // dY
  float* dts = ys + (size_t)d.Tp * kLdx;
  float* as = dts + d.Tp;
  float* cum = as + d.Tp;
  float* ein = cum + d.Tp;
  float* ddt_row = ein + d.Tp;
  float* dcum_row = ddt_row + d.Tp;
  float* qpart = dcum_row + d.Tp;                           // [kWarps][Tp]

  const BlockPos bp = block_pos(p.H, p.G, p.nc, head_slice, slices);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row_stride = (size_t)p.G * p.N;
  const size_t bc_base =
      ((size_t)bp.bi * p.nc * p.T + (size_t)bp.c * p.T) * row_stride + (size_t)bp.gi * p.N;
  stage(r1, d.ldbc, p.B + bc_base, row_stride, p.T, d.Tp, p.N, d.Nq, p.vec, warp, lane);
  stage(cs, d.ldbc, p.C + bc_base, row_stride, p.T, d.Tp, p.N, d.Nq, p.vec, warp, lane);
  for (int t = warp; t < d.Tp; t += kWarps) {
    const int from = t < p.T ? p.P : 0;
    zero_row(xs + t * kLdx, from, kMaxP, lane);
    zero_row(ys + t * kLdx, from, kMaxP, lane);
  }
  for (int t = p.T + tid; t < d.Tp; t += kThreads) dts[t] = as[t] = 0.f;
  for (int i = tid; i < kWarps * d.Tp; i += kThreads) qpart[i] = 0.f;
  if (tid < kMaxHeadSlice) next_item[tid] = 0;
  const size_t first_id = ((size_t)bp.bi * p.H + bp.head0) * p.nc + bp.c;
  fetch_intra(p, first_id, xs, ys, dts, as, warp, lane, tid);
  cp_async_wait<0>();
  __syncthreads();

  const IntraCtx ctx{p.T, p.P, p.N, d.Tp, d.Np, d.Pp, d.lds, d.ldbc, r1, cs, xs, ys, dts,
                     cum, ein, ddt_row, dcum_row, qpart, first_id, lane, lane >> 2, lane & 3,
                     warp};
  // warps w and w + 4 share a scheduler: strips w and 7 - w (anti-causal
  // strips: strip 0 has the most column tiles)
  const int strip = warp < 4 ? warp : 11 - warp;
  const int nstrips = d.Tp / 16;
  const bool strip_on = strip < nstrips;
  const int i0 = 16 * strip;
  run_intra(p, ctx, bp, i0, strip_on ? 2 * (nstrips - strip) : 0, r1, xs, ys, dts, as, cum,
            ein, next_item, tid);

  // every head's dS^T is summed; B again into x's space, then dB and dC
  __syncthreads();
  stage(xs, d.ldbc, p.B + bc_base, row_stride, p.T, d.Tp, p.N, d.Nq, p.vec, warp, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (strip_on) {
    // (slices, b, nc*T, G, N): this slice's rows of this chunk and group
    const size_t out0 = (size_t)bp.sl * p.b * p.nc * p.T * row_stride + bc_base;
    db_rows(ctx, i0, p.dBp + out0, 0, row_stride);
    dc_rows(ctx, xs, i0, p.dCp + out0, 0, row_stride);
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_state_kernel
// ---------------------------------------------------------------------------

struct StateArgs {
  const float *x, *dt, *a, *B, *C, *dy, *Hs, *Gs;
  float *dx, *dw, *dcy, *dBp, *dCp;
  int b, H, G, nc, T, P, N;
  bool vec;
};

// X (x or dY: T x P), Y (G or H: N x P), dt and a of one head
__device__ __forceinline__ void fetch_state(const StateArgs& p, const float* X, const float* Y,
                                            size_t id, float* xs, float* ys, float* dts,
                                            float* as, int warp, int lane, int tid) {
  for (int t = warp; t < p.T; t += kWarps)
    copy_row(xs + t * kLdx, X + (id * p.T + t) * p.P, p.P, p.vec, lane);
  for (int k = warp; k < p.N; k += kWarps)
    copy_row(ys + k * kLdx, Y + (id * p.N + k) * p.P, p.P, p.vec, lane);
  for (int t = tid; t < p.T; t += kThreads) {
    cp_async4(dts + t, p.dt + id * p.T + t);
    cp_async4(as + t, p.a + id * p.T + t);
  }
  cp_async_commit();
}

// P rows t = i0 .. i0 + 15 of M0 Y (M0 rows of stride ldm read at a permuted
// k by float2; Y k-major)
__device__ __forceinline__ void p_rows(const float* ms, int ldm, const float* ys, int Np, int i0,
                                       int g8, int t4, float (&acc)[kQTiles][4]) {
  zero_acc(acc);
  const float* m0 = ms + (i0 + g8) * ldm + 2 * t4;
  for (int k0 = 0; k0 < Np; k0 += 8) {
    const float2 u = *reinterpret_cast<const float2*>(m0 + k0);
    const float2 v = *reinterpret_cast<const float2*>(m0 + 8 * ldm + k0);
    uint32_t ah[4], al[4], bh[kQTiles][2], bl[kQTiles][2];
    split_a(u.x, v.x, u.y, v.y, ah, al);
    kmajor_frags(ys, kLdx, k0 + 2 * t4, g8, bh, bl);
    mma_3xtf32(acc, ah, al, bh, bl);
  }
}

// acc[panel] += (sc o X)[t] Y^T on rows t = i0 .. i0 + 15, panels of 64
// state columns (natural k over p)
__device__ __forceinline__ void outer_rows(const float* xs, const float* ys, const float* sc,
                                           int Pp, int Nq, int i0, int g8, int t4,
                                           float (&acc)[kMaxN / kPanel][kQTiles][4]) {
  const float sc0 = sc[i0 + g8], sc1 = sc[i0 + g8 + 8];
  const float* xa = xs + (i0 + g8) * kLdx + t4;
#pragma unroll
  for (int pn = 0; pn < kMaxN / kPanel; ++pn) {
    if (pn * kPanel >= Nq) continue;
    const float* yb = ys + (pn * kPanel + g8) * kLdx + t4;
    for (int k0 = 0; k0 < Pp; k0 += 8) {
      uint32_t ah[4], al[4], bh[kQTiles][2], bl[kQTiles][2];
      split_a(xa[k0] * sc0, xa[8 * kLdx + k0] * sc1, xa[k0 + 4] * sc0,
              xa[8 * kLdx + k0 + 4] * sc1, ah, al);
#pragma unroll
      for (int qt = 0; qt < kQTiles; ++qt) {
        const float* yr = yb + 8 * qt * kLdx + k0;
        split_b(yr[0], yr[4], bh[qt], bl[qt]);
      }
      mma_3xtf32(acc[pn], ah, al, bh, bl);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_state_kernel(const StateArgs p, int head_slice, int slices) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Dims d = make_dims(p.T, p.N, p.P);
  float* ms = smem;                                   // [Tp][ldm]      B or C
  float* xs = ms + (size_t)d.Tp * d.ldm;              // [2][Tp][kLdx]  x or dY
  float* ys = xs + (size_t)2 * d.Tp * kLdx;           // [2][Nq][kLdx]  G or H
  float* dtb = ys + (size_t)2 * d.Nq * kLdx;          // [2][Tp]
  float* ab = dtb + 2 * d.Tp;                         // [2][Tp]
  float* cum = ab + 2 * d.Tp;                         // [Tp]
  float* sc = cum + d.Tp;                             // [Tp]  w, or exp(cum)

  const BlockPos bp = block_pos(p.H, p.G, p.nc, head_slice, slices);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, t4 = lane & 3;
  const size_t row_stride = (size_t)p.G * p.N;
  const size_t bc_base =
      ((size_t)bp.bi * p.nc * p.T + (size_t)bp.c * p.T) * row_stride + (size_t)bp.gi * p.N;
  const size_t out0 = (size_t)bp.sl * p.b * p.nc * p.T * row_stride + bc_base;
  const size_t first_id = ((size_t)bp.bi * p.H + bp.head0) * p.nc + bp.c;
  const int strip = warp < 4 ? warp : 11 - warp;
  const bool strip_on = strip < d.Tp / 16;
  const int i0 = 16 * strip;
  const int bufx = d.Tp * kLdx, bufy = d.Nq * kLdx;

  // padding, zeroed once: the copies below write rows t < T (k < N) and
  // columns q < P only
  for (int r = warp; r < d.Tp; r += kWarps) {
    const int from = r < p.T ? p.P : 0;
    zero_row(xs + r * kLdx, from, kMaxP, lane);
    zero_row(xs + bufx + r * kLdx, from, kMaxP, lane);
  }
  for (int r = warp; r < d.Nq; r += kWarps) {
    const int from = r < p.N ? p.P : 0;
    zero_row(ys + r * kLdx, from, kMaxP, lane);
    zero_row(ys + bufy + r * kLdx, from, kMaxP, lane);
  }
  for (int t = p.T + tid; t < d.Tp; t += kThreads)
    dtb[t] = dtb[d.Tp + t] = ab[t] = ab[d.Tp + t] = 0.f;

  for (int side = 0; side < 2; ++side) {
    // side 0: (B, x, G, w) -> dx, dw, dB; side 1: (C, dY, H, exp(cum)) -> the
    // y-state term of d cum (dcy), dC
    const float* X = side ? p.dy : p.x;
    const float* Y = side ? p.Hs : p.Gs;
    stage(ms, d.ldm, (side ? p.C : p.B) + bc_base, row_stride, p.T, d.Tp, p.N, d.Np, p.vec,
          warp, lane);
    fetch_state(p, X, Y, first_id, xs, ys, dtb, ab, warp, lane, tid);  // with B or C
    float acc[kMaxN / kPanel][kQTiles][4];
    zero_acc(acc[0]);
    zero_acc(acc[1]);
    for (int hh = 0; hh < bp.heads; ++hh) {
      const int cur = hh & 1;
      const size_t id = first_id + (size_t)hh * p.nc;
      if (hh + 1 < bp.heads) {
        fetch_state(p, X, Y, id + p.nc, xs + (cur ^ 1) * bufx, ys + (cur ^ 1) * bufy,
                    dtb + (cur ^ 1) * d.Tp, ab + (cur ^ 1) * d.Tp, warp, lane, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this head's x (dY), G (H), dt and a
      const float* xh = xs + cur * bufx;
      const float* yh = ys + cur * bufy;
      const float* dth = dtb + cur * d.Tp;
      if (warp == 0) {
        prefix_sum(ab + cur * d.Tp, cum, d.Tp, lane);
        const float last = cum[p.T - 1];
        for (int t = lane; t < d.Tp; t += 32) {
          const bool in = t < p.T;
          sc[t] = side ? (in ? expf(cum[t]) : 0.f) : (in ? expf(last - cum[t]) : 0.f) * dth[t];
        }
      }
      __syncthreads();  // cum and sc
      if (strip_on) {
        float pr[kQTiles][4];
        p_rows(ms, d.ldm, yh, d.Np, i0, g8, t4, pr);
        // row dots with x (dY); side 0 adds w o P to dx
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = i0 + g8 + 8 * half;
          const float* xr = xh + t * kLdx;
          float* dxr = p.dx + (id * p.T + t) * p.P;
          const float w = sc[t];
#pragma unroll
          for (int qt = 0; qt < kQTiles; ++qt) {
            const int q = 8 * qt + 2 * t4;
            const float v0 = pr[qt][2 * half], v1 = pr[qt][2 * half + 1];
            part[half] += xr[q] * v0 + xr[q + 1] * v1;  // x (dY) is 0 past P and T
            if (side == 0 && t < p.T) {
              if (q < p.P) dxr[q] += w * v0;
              if (q + 1 < p.P) dxr[q + 1] += w * v1;
            }
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
          part[1] += __shfl_xor_sync(0xffffffffu, part[1], off);
        }
        if (t4 == 0) {  // dw, or exp(cum) dY . (C H) (ssd_bwd_finish_kernel reads them)
          float* out = (side ? p.dcy : p.dw) + id * p.T;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = i0 + g8 + 8 * half;
            if (t < p.T) out[t] = side ? sc[t] * part[half] : part[half];
          }
        }
        outer_rows(xh, yh, sc, d.Pp, d.Nq, i0, g8, t4, acc);
      }
      __syncthreads();  // every warp is done with this head's buffers
    }
    if (strip_on) {
      float* out = (side ? p.dCp : p.dBp) + out0;
#pragma unroll
      for (int pn = 0; pn < kMaxN / kPanel; ++pn)
        if (pn * kPanel < p.N)
          put_panel<true>(out + pn * kPanel, 0, row_stride, i0 + g8, p.T,
                          min(kPanel, p.N - pn * kPanel), t4, acc[pn]);
    }
    __syncthreads();  // every warp is done with B (C) and the head buffers
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_finish_kernel
// ---------------------------------------------------------------------------

struct FinishArgs {
  const float *dt, *a, *A, *gh, *dw, *dcy, *dcum;
  float *ddt, *dA;
  long long count;  // b*h * nc
  int nc, T;
};

// a warp a (b*h, chunk): d cum from its parts (the intra kernel's dcum, -w dw,
// the y-state term dcy, and at T-1 sum w dw and exp(cum_{T-1}) <G, H>), its
// reverse cumsum d a by shuffles, d dt = (the intra kernel's ddt) + dw
// exp(cum_{T-1} - cum) + d a A, and the chunk's part of dA, sum d a dt
__global__ void __launch_bounds__(kThreads) ssd_bwd_finish_kernel(const FinishArgs p) {
  const int lane = threadIdx.x & 31;
  const long long id = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (id >= p.count) return;
  const size_t v0 = (size_t)id * p.T;
  // cum as csrc/ssd_scan.cu's scan_head sums it (lane l: steps 4l .. 4l + 3)
  float cum[4], run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    run += t < p.T ? p.a[v0 + t] : 0.f;
    cum[u] = run;
  }
  float total = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, total, off);
    if (lane >= off) total += o;
  }
  const float before = total - run;
#pragma unroll
  for (int u = 0; u < 4; ++u) cum[u] += before;
  const int ju = (p.T - 1) & 3;
  const float mine = ju == 0 ? cum[0] : ju == 1 ? cum[1] : ju == 2 ? cum[2] : cum[3];
  const float last = __shfl_sync(0xffffffffu, mine, (p.T - 1) >> 2);
  float g[4], dtv[4], direct[4], wdw_sum = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    g[u] = dtv[u] = direct[u] = 0.f;
    if (t < p.T) {
      dtv[u] = p.dt[v0 + t];
      const float dend = expf(last - cum[u]), dw = p.dw[v0 + t], wdw = dend * dtv[u] * dw;
      wdw_sum += wdw;
      g[u] = p.dcum[v0 + t] - wdw + p.dcy[v0 + t];
      direct[u] = p.ddt[v0 + t] + dw * dend;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wdw_sum += __shfl_xor_sync(0xffffffffu, wdw_sum, off);
  if (lane == (p.T - 1) >> 2) {
    const float tail = wdw_sum + expf(last) * p.gh[id];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u == ju) g[u] += tail;
  }
  // reverse cumsum: within the lane, then the lanes after it
  float suffix[4];
  run = 0.f;
#pragma unroll
  for (int u = 3; u >= 0; --u) {
    run += g[u];
    suffix[u] = run;
  }
  total = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, total, off);
    if (lane + off < 32) total += o;
  }
  const float after = total - run;
  const float Ah = p.A[id / p.nc];
  float part = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = 4 * lane + u;
    if (t < p.T) {
      const float da = suffix[u] + after;
      p.ddt[v0 + t] = direct[u] + da * Ah;
      part += da * dtv[u];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) p.dA[id] = part;
}

int opt_in(const void* kernel, int bytes, bool (&done)[kMaxDevices], int device) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    done[device] = true;
  }
  return 0;
}

bool bad_shape(int b, int h, int g, int nc, int T, int P, int N, int head_slice) {
  return b < 1 || h < 1 || g < 1 || h % g != 0 || nc < 1 || T < 1 || T > kMaxT || N < 1 ||
         N > kMaxN || P < 1 || P > kMaxP || head_slice < 1 || head_slice > kMaxHeadSlice;
}

}  // namespace

// Before the reverse scan over chunks. x, dy (b*h, nc, T, P), dt and a
// (b*h, nc, T), B and C (b, nc*T, G, N) -> dx (the M^T dY part), z (b*h, nc,
// N, P), ddt (the dM part of d dt) and dcum (the dM part of d cum) (b*h,
// nc, T), decay (b*h, nc) = exp(cum_{T-1}), dB_part and dC_part (slices, b,
// nc*T, G, N) (the dS parts). All float32, contiguous, on `device`.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_bwd_intra_launch(const void* x, const void* dt, const void* a, const void* B,
                                    const void* C, const void* dy, void* dx, void* z, void* ddt,
                                    void* dcum, void* decay, void* dB_part, void* dC_part, int b,
                                    int h, int g, int nc, int T, int P, int N, int head_slice,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(b, h, g, nc, T, P, N, head_slice)) return (int)cudaErrorInvalidValue;
  const int slices = (h / g + head_slice - 1) / head_slice;
  const long long blocks = (long long)b * nc * g * slices;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t bytes = 4 * intra_floats(make_dims(T, N, P));
  if (bytes > (size_t)kIntraMaxBytes) return (int)cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  const int rc = opt_in((const void*)ssd_bwd_intra_kernel, kIntraMaxBytes, done, device);
  if (rc != 0) return rc;
  const bool vec = N % 4 == 0 && P % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)dy | (uintptr_t)B | (uintptr_t)C) % 16 == 0;
  const IntraArgs args{(const float*)x,  (const float*)dt, (const float*)a,  (const float*)B,
                       (const float*)C,  (const float*)dy, (float*)dx,       (float*)z,
                       (float*)ddt,      (float*)dcum,     (float*)decay,    (float*)dB_part,
                       (float*)dC_part,  b,                h,                g,
                       nc,               T,                P,                N,
                       vec};
  ssd_bwd_intra_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      args, head_slice, slices);
  return (int)cudaGetLastError();
}

// After the reverse scan. x, dy (b*h, nc, T, P), dt and a (b*h, nc, T), A
// (b*h) the heads' rates, B and C (b, nc*T, G, N), H the chunks' entry
// states and G the gradients of their exit states (b*h, nc, N, P), gh (b*h,
// nc) = <G, H>; dw and dcy (b*h, nc, T) scratch. Launches the state kernel,
// which adds the state parts into dx, dB_part and dC_part, then the finish
// kernel, which writes the finished ddt (from the intra kernel's ddt and
// dcum) and dA_part (b*h, nc).
extern "C" int ssd_bwd_state_launch(const void* x, const void* dt, const void* a, const void* A,
                                    const void* B, const void* C, const void* dy,
                                    const void* Hs, const void* Gs, const void* gh, void* dx,
                                    void* ddt, void* dcum, void* dw, void* dcy, void* dA_part,
                                    void* dB_part, void* dC_part, int b, int h, int g, int nc,
                                    int T, int P, int N, int head_slice, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(b, h, g, nc, T, P, N, head_slice)) return (int)cudaErrorInvalidValue;
  const int slices = (h / g + head_slice - 1) / head_slice;
  const long long blocks = (long long)b * nc * g * slices;
  const long long count = (long long)b * h * nc;
  const long long finish_blocks = (count + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL || finish_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t bytes = 4 * state_floats(make_dims(T, N, P));
  if (bytes > (size_t)kStateMaxBytes) return (int)cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  const int rc = opt_in((const void*)ssd_bwd_state_kernel, kStateMaxBytes, done, device);
  if (rc != 0) return rc;
  const bool vec = N % 4 == 0 && P % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)dy | (uintptr_t)B | (uintptr_t)C | (uintptr_t)Hs |
                    (uintptr_t)Gs) % 16 == 0;
  const StateArgs args{(const float*)x,  (const float*)dt, (const float*)a,  (const float*)B,
                       (const float*)C,  (const float*)dy, (const float*)Hs, (const float*)Gs,
                       (float*)dx,       (float*)dw,       (float*)dcy,      (float*)dB_part,
                       (float*)dC_part,  b,                h,                g,
                       nc,               T,                P,                N,
                       vec};
  ssd_bwd_state_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      args, head_slice, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const FinishArgs fin{(const float*)dt, (const float*)a,   (const float*)A, (const float*)gh,
                       (const float*)dw, (const float*)dcy, (const float*)dcum,
                       (float*)ddt,      (float*)dA_part,   count,           nc,
                       T};
  ssd_bwd_finish_kernel<<<(unsigned)finish_blocks, kThreads, 0, (cudaStream_t)stream>>>(fin);
  return (int)cudaGetLastError();
}
