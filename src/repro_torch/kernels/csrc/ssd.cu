// Mamba-2 SSD chunk scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::ssd_pallas (body
// _kernel, :29).  Per (batch b, head hd), walking the sequence in chunks of
// q rows with the carried state H (p x n) and, within a chunk, csum_i the
// inclusive cumulative sum of dA_t = dt_t * A[hd] and xb_t = x_t * dt_t:
//
//   y_i   = sum_{j <= i} (C_i . B_j) exp(csum_i - csum_j) xb_j
//           + exp(csum_i) (H C_i)
//   H    <- exp(csum_last) H + sum_j exp(csum_last - csum_j) xb_j (x) B_j
//
// the chunked reference's arithmetic (src/repro/nn/ssm.py::ssd_reference),
// with the final H written out as the state.
//
// What bounds it on an H100.  A chunk is four products: the scores C B^T
// (q x q x n, causal half), y_diag (scores o L) xb (q x q x p), y_off
// C H^T (q x n x p) and the state update (xb o decay)^T B (p x q x n):
// ~37 flops a byte at q = n = 128, p = 64, far above the card's f32
// balance, so it is bound by operations.  In f32 on CUDA cores that is
// 67 TFLOP/s; the kernel runs the four products on the tensor cores in
// TF32 (495 TFLOP/s dense) three times over (below), 165 TFLOP/s of f32
// work.  The reference is f32 and phase 20 holds greedy tokens card
// against CPU, so plain TF32 (about three digits) is not an option.
//
// 3xTF32.  Every operand x of a product is split into two TF32 values,
// hi = x rounded to TF32 and lo = x - hi (truncated to TF32 by the tensor
// cores), and a product a b is summed as al bh + ah bl + ah bh into f32
// accumulators (mma.sync.aligned.m16n8k8 .tf32): the dropped al bl and the
// truncation of lo leave a relative error near 2^-21 a product, f32's own
// order.  The tensor cores keep denormal TF32 inputs on an H100 80GB HBM3
// (a product 2^-130 x 1 comes out exact through ssd_tf32_probe below,
// which only tests/test_torch_gpu.py calls); were they flushed, an operand
// below 2^-126 (a decay exp(csum_i - csum_j) or exp(total - csum_j) deep
// in a long chunk) would move a sum by less than 2^-126 times the other
// factor, far inside the tolerance's absolute 3e-4.  exp(csum_i)
// scales y_off's rows after the product, on CUDA cores.  The build has no
// --use_fast_math and the kernels call expf, so denormal exps stay exact.
//
// The chunk kernel (q >= 2).  Grid (p tiles of PT = 64 columns (32 when
// p <= 32), h, b), 8 warps.  A block walks its chunks in order carrying its
// p tile of H, so there is no global scratch and no cross-block protocol
// (the Mamba-2 decomposition into parallel chunk states, a pass over them
// and a parallel y_off would write b h (s/q) p n floats of scratch, 67 MB at
// s = 2048).  p is not split further at p = 64: a chunk's B and C rows
// alone are 132 KB of shared memory at q = n = 128, so a second block per
// SM never fits, and two p tiles would mean two waves of 128 blocks and the
// scores computed twice.  Each warp owns a "strip" of 16 rows of the chunk
// (the MMA's 16 rows; q <= 128 gives at most 8 strips) for y, and the n
// columns 8 (w + 8u).. of the state update, whose H stays in the warp's
// registers across chunks.  Strip r has 2r + 2 score tiles (the causal
// triangle), so the longest four strips go to warps 0-3 (one a scheduler)
// and the next four to warps 7, 6, 5, 4: each scheduler's pair of warps
// gets the same number of tiles.  Per chunk:
//   (1) warp 0 scans dA (4 rows a lane, then a warp-level scan, in f64)
//       and stages csum, exp(csum) and dt exp(total - csum) once; every
//       warp runs
//       y_off = C_strip H^T from H in shared memory, while the chunk's B
//       and x rows are still in flight; one barrier;
//   (2) rows of y_off are scaled by exp(csum_i) and the scores of the
//       strip are built four n8 tiles at a time and a last pair, with no
//       branch inside a block, so the tiles' MMA chains interleave (a guard
//       per tile put each tile's three dependent MMAs in a basic block of
//       its own: the score product took half the kernel's time); each
//       score tile is masked (j > i set to 0 by a select: above the
//       diagonal exp() may be inf, and inf * 0 is NaN, so no such term is
//       formed into an operand) and decayed in registers and feeds y_diag
//       directly as the A operand: the C fragment of an m16n8 tile holds
//       columns 2t, 2t+1 of the tile where an A fragment wants t, t+4, so
//       the k order of that product is permuted (k' = t <-> j = 2t,
//       k' = t + 4 <-> j = 2t + 1) and x's rows are read in the same order;
//   (3) the warp issues the next chunk's C rows of its own strip (only it
//       reads them; warp 0 also the next dt) with cp.async, runs its state
//       tiles and writes its H tiles to shared memory; a second barrier;
//   (4) the next chunk's B and x rows are issued (cp.async) and waited for
//       only after that chunk's y_off.
// Shared memory at q = n = 128, p = 64 is 206,864 bytes (B and C rows, the
// x tile, H, dt for two chunks, csum in f64 and two more q-long vectors),
// one block per SM; rows are padded to n + 4 and PT + 4 floats, so every fragment
// load of a warp hits 32 banks.  Rows past q, columns past n and p are zero
// in shared memory, so ragged tiles add nothing.  Any q from 2 to 128 and
// any n up to 256 (within the shared memory a block may have) work.
//
// The scan in f64.  The decays are exponentials of differences of the
// cumulative sum, csum_i - csum_j and total - csum_j, and csum reaches
// ~-100 at the end of a 128-row chunk (the test distributions), where an
// f32 ulp is 7.6e-6: in f32 every difference carries that much error into
// its exp, whatever the order of the sums (a warp's tree order in f32 put
// y and the state further from an f64 evaluation than the plain version's
// sequential cumsum; chip_smoke.py phase 16 prints both against f64).
// Warp 0 sums the f32 dA_j in f64 and the kernel takes the differences in
// f64; each is then rounded to f32 for expf, which moves e^x by at most
// |x| e^x 2^-24, below 2^-24 for every x <= 0.
//
// The row kernel (q == 1, a prime prompt length above the chunk).  The
// chunked arithmetic at q = 1 is the recurrence H_t = exp(dA_t) H_{t-1} +
// xb_t (x) B_t, y_t = (C_t . B_t) xb_t + exp(dA_t) (C_t . H_{t-1}) (the
// reference's grouping).  Grid (p tiles of 64, h, b), 8 warps; warp w owns
// 8 rows e of H and lane l its columns k = l + 32 i, all in registers: f32
// FMAs on CUDA cores, nothing to gain from a 1-row MMA.  A row's
// C_t . H_{t-1} is reduced over n by a reduce-scatter of the warp's 8
// partial sums (9 shuffles).  B, C, x and dt rows are staged 32 rows at a
// time through two cp.async stages, one barrier pair each 32 rows and none
// a row.
//
// Not done yet (later work): wgmma with a producer warp and a TMA ring
// (mma.sync m16n8k8 issues from registers: every operand is loaded from
// shared memory and split by the same warp that multiplies); sharing the
// scores C B^T across the heads of a group (they do not depend on the
// head: ~30% of the products at Mamba-2's shape are recomputed for each of
// its 32 heads); more parallelism in the row kernel (p tiles of 32 for two
// blocks an SM, or two rows a step around its per-row shuffle chain).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kMaxChunk = 128;  // 8 strips of 16 rows, one a warp
constexpr int kMaxState = 256;  // n the kernels take (NU <= 4, KI <= 8)
constexpr int kRowTile = 32;    // rows a stage of the row kernel
constexpr int kRowP = 64;       // p columns a row-kernel block (8 warps x 8)

__host__ __device__ constexpr int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// p columns a chunk-kernel block owns.
__host__ __device__ constexpr int tile_p(int P) { return P <= 32 ? 32 : 64; }

// Shared floats of the chunk kernel: B and C rows (qp x (np + 4)), the x
// tile (qp x (PT + 4)), H (PT x (np + 4)), dt (two chunks), csum (f64),
// exp(csum) and dt exp(total - csum) (qp each) and the chunk's total (f64).
__host__ __device__ constexpr int chunk_smem_floats(int q, int pt, int n) {
  return 2 * round_up(q, 16) * (round_up(n, 8) + 4) +
         round_up(q, 16) * (pt + 4) + pt * (round_up(n, 8) + 4) +
         6 * round_up(q, 16) + 4;
}

// Columns of n a lane of the row kernel owns: n <= 32 KI.
__host__ __device__ constexpr int row_ki(int n) {
  return n <= 32 ? 1 : n <= 64 ? 2 : n <= 128 ? 4 : 8;
}

// Shared floats of the row kernel: two stages of kRowTile rows of B and C
// (32 KI each), x (kRowP) and dt.
__host__ __device__ constexpr int row_smem_floats(int ki) {
  return 2 * kRowTile * (2 * 32 * ki + kRowP + 1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo.  hi is x rounded to TF32 (to nearest, ties away from zero:
// half a TF32 ulp added and the 13 low bits cleared, two integer operations
// at full rate, where cvt.rna.tf32.f32 runs on the conversion unit at a
// quarter of it); lo = x - hi is exact in f32 and enters the MMA as it is:
// the tensor cores read a TF32 operand's top 19 bits, so lo is truncated
// there, by at most 2^-21 of x.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An m16n8k8 A fragment (a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4] for lane 4g + t) and a B fragment (b0 = B[t][g],
// b1 = B[t+4][g]), each split into hi and lo parts.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float v0, float v1, float v2,
                                      float v3) {
    split(v0, hi[0], lo[0]);
    split(v1, hi[1], lo[1]);
    split(v2, hi[2], lo[2]);
    split(v3, hi[3], lo[3]);
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float v0, float v1) {
    split(v0, hi[0], lo[0]);
    split(v1, hi[1], lo[1]);
  }
};

// d += a b in 3xTF32: the two cross terms first, al bl dropped.
__device__ __forceinline__ void mma3(float* d, const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Rows [r0, r1) of B or C (group grp) for the chunk starting at t0 into
// dst (row stride ls), spread over the threads idx, idx + step, ...
__device__ __forceinline__ void load_bc(float* dst, int ls,
                                        const float* __restrict__ src,
                                        size_t row0, int G, int N, int r0,
                                        int r1, int idx, int step,
                                        bool vec) {
  if (vec) {
    const int nv = N / 4;
    for (int e = idx; e < (r1 - r0) * nv; e += step) {
      const int r = r0 + e / nv, k = (e % nv) * 4;
      cp_async16(dst + r * ls + k, src + (row0 + r) * G * N + k);
    }
  } else {
    for (int e = idx; e < (r1 - r0) * N; e += step) {
      const int r = r0 + e / N, k = e % N;
      cp_async4(dst + r * ls + k, src + (row0 + r) * G * N + k);
    }
  }
}

// The x tile (q rows of columns [p0, p0 + cols)) of one (batch, head) for
// the chunk whose first row is row0 = b S + t0.
__device__ __forceinline__ void load_x(float* xs, int xstride,
                                       const float* __restrict__ x,
                                       size_t row0, int H, int hd, int P,
                                       int p0, int cols, int q, int tid,
                                       int step, bool vec) {
  if (vec) {
    const int nv = cols / 4;
    for (int e = tid; e < q * nv; e += step) {
      const int r = e / nv, c = (e % nv) * 4;
      cp_async16(xs + r * xstride + c, x + ((row0 + r) * H + hd) * P + p0 + c);
    }
  } else {
    for (int e = tid; e < q * cols; e += step) {
      const int r = e / cols, c = e % cols;
      cp_async4(xs + r * xstride + c, x + ((row0 + r) * H + hd) * P + p0 + c);
    }
  }
}

// dt of one (batch, head) for the q rows from row0 = b S + t0.
__device__ __forceinline__ void load_dt(float* dts,
                                        const float* __restrict__ dt,
                                        size_t row0, int H, int hd, int q,
                                        int idx, int step) {
  for (int r = idx; r < q; r += step)
    cp_async4(dts + r, dt + (row0 + r) * H + hd);
}

// y_diag of a strip (rows r0 = i0 + g and r1 = r0 + 8 of this lane) from
// NT score tiles starting at column tile jt0: the scores C_strip B^T over
// nk k steps, masked (j > i set to 0 by a select, before exp could be
// inf) and decayed (exp(csum_i - csum_j) dt_j) in registers, then, as A
// fragments with the k order permuted (k' = t <-> j = 2t, k' = t + 4 <->
// j = 2t + 1: the C fragment's columns), times x's rows j0 and j0 + 1.
template <int NT, int PT>
__device__ __forceinline__ void score_block(
    float (&acc)[PT / 8][4], const float* crow, const float* Bs,
    const float* Xs, const double* cs, const float* dts, int ls, int nk,
    int jt0, int g, int t, int r0, int r1, double ci0, double ci1) {
  constexpr int XS = PT + 4;
  float s[NT][4];
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) s[u][v] = 0.f;
  const float* bcol = Bs + (jt0 * 8 + g) * ls + t;
  for (int ks = 0; ks < nk; ++ks) {
    const float* cr = crow + ks * 8;
    FragA fa;
    fa.set(cr[0], cr[8 * ls], cr[4], cr[8 * ls + 4]);
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const float* br = bcol + u * 8 * ls + ks * 8;
      FragB fb;
      fb.set(br[0], br[4]);
      mma3(s[u], fa, fb);
    }
  }
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int j0 = (jt0 + u) * 8 + 2 * t, j1 = j0 + 1;
    const double cj0 = cs[j0], cj1 = cs[j1];
    const float d0 = dts[j0], d1 = dts[j1];
    const float m00 =
        j0 <= r0 ? s[u][0] * expf(static_cast<float>(ci0 - cj0)) * d0 : 0.f;
    const float m01 =
        j1 <= r0 ? s[u][1] * expf(static_cast<float>(ci0 - cj1)) * d1 : 0.f;
    const float m10 =
        j0 <= r1 ? s[u][2] * expf(static_cast<float>(ci1 - cj0)) * d0 : 0.f;
    const float m11 =
        j1 <= r1 ? s[u][3] * expf(static_cast<float>(ci1 - cj1)) * d1 : 0.f;
    FragA fm;
    fm.set(m00, m10, m01, m11);
#pragma unroll
    for (int nt = 0; nt < PT / 8; ++nt) {
      const float* xr = Xs + j0 * XS + nt * 8 + g;
      FragB fb;
      fb.set(xr[0], xr[XS]);
      mma3(acc[nt], fm, fb);
    }
  }
}

// grid (ceil(P / PT), H, batch); kThreads; chunk_smem_floats(q, PT, N)
// floats of dynamic shared memory.  NU: n tiles of 8 a warp owns in the
// state update, ceil(round_up(N, 8) / 64).
template <int PT, int NU>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ state, int S, int H, int G, int P,
                 int N, int q, int vec_bc, int vec_x) {
  extern __shared__ __align__(16) float smem[];
  constexpr int XS = PT + 4;
  const int qp = round_up(q, 16);
  const int np = round_up(N, 8);
  const int ls = np + 4;
  float* Bs = smem;            // [qp][ls]
  float* Cs = Bs + qp * ls;    // [qp][ls]
  float* Xs = Cs + qp * ls;    // [qp][XS]  x (not yet times dt)
  float* Hs = Xs + qp * XS;    // [PT][ls]  H before this chunk
  float* dtb = Hs + PT * ls;   // [2][qp] dt of chunks c (c & 1) and c + 1
  double* cs = reinterpret_cast<double*>(dtb + 2 * qp);  // [qp] csum, f64
  float* ecs = reinterpret_cast<float*>(cs + qp);  // [qp] exp(csum)
  float* wts = ecs + qp;       // [qp] dt exp(total - csum) (rows past q: 0)
  double* tot = reinterpret_cast<double*>(wts + qp);  // [1] total = csum_last

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * PT, hd = blockIdx.y, b = blockIdx.z;
  const int grp = hd / (H / G);
  const int cols = min(PT, P - p0);
  const float a_h = A[hd];
  const int nk = np / 8;                 // k steps over n
  // This warp's strip: the longest four (most score tiles) on warps 0-3,
  // one a scheduler, the next four on warps 7, 6, 5, 4, so that the two
  // warps of a scheduler (w and w + 4) share out the causal triangle evenly.
  const int strips = qp / 16;
  const int strip = warp < 4 ? strips - 1 - warp : strips - 12 + warp;
  const bool has_strip = strip >= 0;
  const int i0 = strip * 16;
  const int jsteps = (q + 7) / 8;        // k steps over the chunk's rows
  const float* Bg = B + grp * N;
  const float* Cg = C + grp * N;
  const int nchunks = S / q;

  for (int i = tid; i < chunk_smem_floats(q, PT, N); i += kThreads)
    smem[i] = 0.f;
  __syncthreads();
  // Two copy groups a chunk, in this order: a warp's own C rows (and warp
  // 0's dt) for chunk c, then everyone's B and x rows for chunk c.
  const size_t brow = static_cast<size_t>(b) * S;
  if (nchunks > 0 && has_strip)
    load_bc(Cs, ls, Cg, brow, G, N, i0, min(i0 + 16, q), lane, 32, vec_bc);
  if (nchunks > 0 && warp == 0) load_dt(dtb, dt, brow, H, hd, q, lane, 32);
  cp_async_commit();
  if (nchunks > 0) {
    load_bc(Bs, ls, Bg, brow, G, N, 0, q, tid, kThreads, vec_bc);
    load_x(Xs, XS, x, brow, H, hd, P, p0, cols, q, tid, kThreads, vec_x);
  }
  cp_async_commit();

  float hacc[PT / 16][NU][4];  // this warp's state tiles, across chunks
#pragma unroll
  for (int mt = 0; mt < PT / 16; ++mt)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) hacc[mt][u][v] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const size_t row0 = brow + static_cast<size_t>(c) * q;
    const float* dts = dtb + (c & 1) * qp;

    // (1) The scan (warp 0) and y_off = C_strip H^T (every warp), while
    // this chunk's B and x rows are still in flight.
    cp_async_wait<1>();  // this lane's C rows (and dt) of chunk c
    __syncwarp();
    if (warp == 0) {
      double v[4], run = 0.0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = lane * 4 + u;
        run += j < q ? static_cast<double>(dts[j] * a_h) : 0.0;
        v[u] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const double total = __shfl_sync(0xffffffffu, incl, 31);
      const double excl = incl - run;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = lane * 4 + u;
        if (j < qp) {
          const double cj = excl + v[u];
          cs[j] = cj;
          ecs[j] = expf(static_cast<float>(cj));
          wts[j] = j < q ? dts[j] * expf(static_cast<float>(total - cj)) : 0.f;
        }
      }
      if (lane == 0) tot[0] = total;
    }
    float acc[PT / 8][4];
#pragma unroll
    for (int nt = 0; nt < PT / 8; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;
    const float* crow = Cs + (i0 + g) * ls + t;
    if (has_strip) {
      for (int ks = 0; ks < nk; ++ks) {
        const float* cr = crow + ks * 8;
        FragA fa;
        fa.set(cr[0], cr[8 * ls], cr[4], cr[8 * ls + 4]);
#pragma unroll
        for (int nt = 0; nt < PT / 8; ++nt) {
          const float* hr = Hs + (nt * 8 + g) * ls + ks * 8 + t;
          FragB fb;
          fb.set(hr[0], hr[4]);
          mma3(acc[nt], fa, fb);
        }
      }
    }
    cp_async_wait<0>();  // B and x rows of chunk c
    __syncthreads();     // every copy and the scan are visible
    const double total = tot[0];

    // (2) y = exp(csum_i) y_off + (scores o L) xb for the strip.
    if (has_strip) {
      const int r0 = i0 + g, r1 = i0 + g + 8;
      const float e0 = ecs[r0], e1 = ecs[r1];
      const double ci0 = cs[r0], ci1 = cs[r1];
#pragma unroll
      for (int nt = 0; nt < PT / 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
      // Score tiles 0 .. 2 strip + 1 (those with a column j <= i), four
      // at a time and a last pair: no branch inside a block, so the tiles'
      // MMA chains interleave.
      const int jt_end = 2 * strip + 2;
      int jb = 0;
      for (; jb + 4 <= jt_end; jb += 4)
        score_block<4, PT>(acc, crow, Bs, Xs, cs, dts, ls, nk, jb, g, t, r0,
                           r1, ci0, ci1);
      if (jb < jt_end)
        score_block<2, PT>(acc, crow, Bs, Xs, cs, dts, ls, nk, jb, g, t, r0,
                           r1, ci0, ci1);
#pragma unroll
      for (int nt = 0; nt < PT / 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (r0 < q) {
          float* yr = y + ((row0 + r0) * H + hd) * P + p0;
          if (col < cols) yr[col] = acc[nt][0];
          if (col + 1 < cols) yr[col + 1] = acc[nt][1];
        }
        if (r1 < q) {
          float* yr = y + ((row0 + r1) * H + hd) * P + p0;
          if (col < cols) yr[col] = acc[nt][2];
          if (col + 1 < cols) yr[col + 1] = acc[nt][3];
        }
      }
      // (3) The next chunk's C rows of this strip (only this warp reads
      // them) and, on warp 0, its dt (the other buffer, last read in chunk
      // c - 1).
      __syncwarp();
      if (c + 1 < nchunks) {
        load_bc(Cs, ls, Cg, row0 + q, G, N, i0, min(i0 + 16, q), lane, 32,
                vec_bc);
        if (warp == 0)
          load_dt(dtb + ((c + 1) & 1) * qp, dt, row0 + q, H, hd, q, lane, 32);
      }
    }
    cp_async_commit();

    // The state update: H = exp(total) H + (xb o exp(total - csum))^T B.
    const float decay = expf(static_cast<float>(total));
#pragma unroll
    for (int mt = 0; mt < PT / 16; ++mt)
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) hacc[mt][u][v] *= decay;
    for (int ks = 0; ks < jsteps; ++ks) {
      const int j0 = ks * 8 + 2 * t;  // k' = t <-> j0, k' = t + 4 <-> j0 + 1
      const float w0 = wts[j0], w1 = wts[j0 + 1];
      FragA fa[PT / 16];
#pragma unroll
      for (int mt = 0; mt < PT / 16; ++mt) {
        const float* xr = Xs + j0 * XS + mt * 16 + g;
        fa[mt].set(xr[0] * w0, xr[8] * w0, xr[XS] * w1, xr[XS + 8] * w1);
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        // No branch (the MMA chains interleave): a tile past n repeats the
        // last one and is never stored.
        const int nt = min(warp + 8 * u, nk - 1);
        const float* br = Bs + j0 * ls + nt * 8 + g;
        FragB fb;
        fb.set(br[0], br[ls]);
#pragma unroll
        for (int mt = 0; mt < PT / 16; ++mt) mma3(hacc[mt][u], fa[mt], fb);
      }
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int nt = warp + 8 * u;
      if (nt < nk) {
#pragma unroll
        for (int mt = 0; mt < PT / 16; ++mt) {
          float* hr = Hs + (mt * 16 + g) * ls + nt * 8 + 2 * t;
          hr[0] = hacc[mt][u][0];
          hr[1] = hacc[mt][u][1];
          hr[8 * ls] = hacc[mt][u][2];
          hr[8 * ls + 1] = hacc[mt][u][3];
        }
      }
    }
    __syncthreads();  // B, x and the scan are consumed; H is written

    // (4) The next chunk's B and x rows, waited for after its y_off.
    if (c + 1 < nchunks) {
      load_bc(Bs, ls, Bg, row0 + q, G, N, 0, q, tid, kThreads, vec_bc);
      load_x(Xs, XS, x, row0 + q, H, hd, P, p0, cols, q, tid, kThreads,
             vec_x);
    }
    cp_async_commit();
  }

  float* st = state + (static_cast<size_t>(b) * H + hd) * P * N;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int nt = warp + 8 * u;
    if (nt < nk) {
      const int k = nt * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < PT / 16; ++mt) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int e = mt * 16 + g + (v >> 1) * 8, kk = k + (v & 1);
          if (e < cols && kk < N)
            st[static_cast<size_t>(p0 + e) * N + kk] = hacc[mt][u][v];
        }
      }
    }
  }
}

// grid (ceil(P / kRowP), H, batch); kThreads; row_smem_floats(KI) floats
// of dynamic shared memory.  The scan at q = 1; N <= 32 KI.
template <int KI>
__global__ void __launch_bounds__(kThreads)
ssd_row_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ C, float* __restrict__ y,
               float* __restrict__ state, int S, int H, int G, int P, int N,
               int vec_bc, int vec_x) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NK = 32 * KI;
  constexpr int kStage = kRowTile * (2 * NK + kRowP + 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * kRowP, hd = blockIdx.y, b = blockIdx.z;
  const int grp = hd / (H / G);
  const int cols = min(kRowP, P - p0);
  const float a_h = A[hd];
  const float* Bg = B + grp * N;
  const float* Cg = C + grp * N;
  const size_t brow = static_cast<size_t>(b) * S;

  for (int i = tid; i < 2 * kStage; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  // Stage st: B [kRowTile][NK], C [kRowTile][NK], x [kRowTile][kRowP], dt.
  auto issue = [&](int tile, int st) {
    float* bs = smem + st * kStage;
    float* cs = bs + kRowTile * NK;
    float* xs = cs + kRowTile * NK;
    float* ds = xs + kRowTile * kRowP;
    const int t0 = tile * kRowTile, rows = min(kRowTile, S - t0);
    load_bc(bs, NK, Bg, brow + t0, G, N, 0, rows, tid, kThreads, vec_bc);
    load_bc(cs, NK, Cg, brow + t0, G, N, 0, rows, tid, kThreads, vec_bc);
    load_x(xs, kRowP, x, brow + t0, H, hd, P, p0, cols, rows, tid, kThreads,
           vec_x);
    load_dt(ds, dt, brow + t0, H, hd, rows, tid, kThreads);
  };

  float h[8][KI];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < KI; ++i) h[m][i] = 0.f;
  // The lane's row of the reduce-scatter: e = 8 warp + 4 b4 + 2 b3 + b2.
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  const int esel = warp * 8 + (b4 ? 4 : 0) + (b3 ? 2 : 0) + (b2 ? 1 : 0);

  const int ntiles = (S + kRowTile - 1) / kRowTile;
  if (ntiles > 0) issue(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < ntiles) issue(tile + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* bs = smem + st * kStage;
    const float* cs = bs + kRowTile * NK;
    const float* xs = cs + kRowTile * NK;
    const float* ds = xs + kRowTile * kRowP;
    const int t0 = tile * kRowTile, rows = min(kRowTile, S - t0);
    for (int r = 0; r < rows; ++r) {
      const float dtv = ds[r];
      const float decay = expf(dtv * a_h);
      float bk[KI], ck[KI], cb = 0.f;
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        bk[i] = bs[r * NK + lane + 32 * i];
        ck[i] = cs[r * NK + lane + 32 * i];
        cb = fmaf(ck[i], bk[i], cb);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        cb += __shfl_xor_sync(0xffffffffu, cb, off);
      const float4 xa = *reinterpret_cast<const float4*>(xs + r * kRowP +
                                                         warp * 8);
      const float4 xc = *reinterpret_cast<const float4*>(xs + r * kRowP +
                                                         warp * 8 + 4);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
      float part[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < KI; ++i) s = fmaf(ck[i], h[m][i], s);
        part[m] = s;
      }
      // Reduce-scatter the 8 partial sums over the 32 lanes.
      float r4[4], r2[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r4[i] = (b4 ? part[i + 4] : part[i]) +
                __shfl_xor_sync(0xffffffffu, b4 ? part[i] : part[i + 4], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        r2[i] = (b3 ? r4[i + 2] : r4[i]) +
                __shfl_xor_sync(0xffffffffu, b3 ? r4[i] : r4[i + 2], 8);
      float ch = (b2 ? r2[1] : r2[0]) +
                 __shfl_xor_sync(0xffffffffu, b2 ? r2[0] : r2[1], 4);
      ch += __shfl_xor_sync(0xffffffffu, ch, 2);
      ch += __shfl_xor_sync(0xffffffffu, ch, 1);
      if ((lane & 3) == 0 && esel < cols) {
        const float xb = xs[r * kRowP + esel] * dtv;
        y[((brow + t0 + r) * H + hd) * P + p0 + esel] = cb * xb + decay * ch;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float xb = xv[m] * dtv;
#pragma unroll
        for (int i = 0; i < KI; ++i) h[m][i] = fmaf(h[m][i], decay, xb * bk[i]);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  float* st = state + (static_cast<size_t>(b) * H + hd) * P * N;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int e = warp * 8 + m;
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const int k = lane + 32 * i;
      if (e < cols && k < N) st[static_cast<size_t>(p0 + e) * N + k] = h[m][i];
    }
  }
}

// One warp: d (16x8) = a (16x8) b (8x8), all row-major f32, through the
// chunk kernel's fragments: in 3xTF32 with split != 0, else one TF32
// product of tf32(a) and tf32(b).  Not on the path: a card test reads the
// fragment layout and the tensor cores' treatment of denormals through it.
__global__ void tf32_probe_kernel(const float* a, const float* b, float* d,
                                  int split3) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  FragA fa;
  fa.set(a[g * 8 + t], a[(g + 8) * 8 + t], a[g * 8 + t + 4],
         a[(g + 8) * 8 + t + 4]);
  FragB fb;
  fb.set(b[t * 8 + g], b[(t + 4) * 8 + g]);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (split3) {
    mma3(acc, fa, fb);
  } else {
    mma_tf32(acc, fa.hi, fb.hi);
  }
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// The most dynamic shared memory each kernel instance was opted into.
struct Opted {
  const void* fn;
  int bytes;
};
Opted g_opted[16];
int g_nopted = 0;

// Raise fn's dynamic shared-memory limit to bytes if it is lower (once an
// instance); returns the error of the attempt, cleared from the runtime.
cudaError_t opt_in(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int i = 0;
  while (i < g_nopted && g_opted[i].fn != fn) ++i;
  if (i < g_nopted && g_opted[i].bytes >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // returned here; keep it from the next launch's check
    return err;
  }
  if (i == g_nopted && g_nopted < 16) ++g_nopted;
  if (i < 16) g_opted[i] = {fn, bytes};
  return cudaSuccess;
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, float*, float*, int, int,
                        int, int, int, int, int, int);
using RowKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, float*, int,
                           int, int, int, int, int, int);

Kernel chunk_kernel(int pt, int nu) {
  if (pt == 32) {
    if (nu == 1) return &ssd_chunk_kernel<32, 1>;
    if (nu == 2) return &ssd_chunk_kernel<32, 2>;
    return &ssd_chunk_kernel<32, 4>;
  }
  if (nu == 1) return &ssd_chunk_kernel<64, 1>;
  if (nu == 2) return &ssd_chunk_kernel<64, 2>;
  return &ssd_chunk_kernel<64, 4>;
}

RowKernel row_kernel(int ki) {
  if (ki == 1) return &ssd_row_kernel<1>;
  if (ki == 2) return &ssd_row_kernel<2>;
  if (ki == 4) return &ssd_row_kernel<4>;
  return &ssd_row_kernel<8>;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Dynamic shared bytes a block of the call's kernel asks for: the row
// kernel at q == 1, else the chunk kernel.
extern "C" int ssd_smem_bytes(int q, int P, int N) {
  if (q == 1) return static_cast<int>(sizeof(float)) * row_smem_floats(row_ki(N));
  return static_cast<int>(sizeof(float)) * chunk_smem_floats(q, tile_p(P), N);
}

// x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,g,n), y (b,s,h,p) and state
// (b,h,p,n), all f32 and contiguous on the current device; q divides s,
// 1 <= q <= 128, 1 <= n <= 256 and g divides h (the wrapper checks).
// Returns cudaGetLastError() after the launch, or, with nothing launched,
// the error of raising the shared-memory limit when the plan does not fit.
extern "C" int ssd(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* state,
                   int batch, int S, int H, int G, int P, int N, int q,
                   void* stream) {
  if (batch == 0 || H == 0 || P == 0) return 0;
  if (q < 1 || q > kMaxChunk || S % q || G < 1 || H % G || N < 1 ||
      N > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_bc = N % 4 == 0 && aligned16(B) && aligned16(C);
  const int vec_x = P % 4 == 0 && aligned16(x);
  const int smem = ssd_smem_bytes(q, P, N);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  const auto* bf = static_cast<const float*>(B);
  const auto* cf = static_cast<const float*>(C);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(state);
  if (q == 1) {
    const RowKernel k = row_kernel(row_ki(N));
    const cudaError_t err = opt_in(reinterpret_cast<const void*>(k), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((P + kRowP - 1) / kRowP, H, batch);
    k<<<grid, kThreads, smem, s>>>(xf, dtf, af, bf, cf, yf, sf, S, H, G, P,
                                   N, vec_bc, vec_x);
  } else {
    const int pt = tile_p(P), np = round_up(N, 8);
    const int nu = np <= 64 ? 1 : np <= 128 ? 2 : 4;
    const Kernel k = chunk_kernel(pt, nu);
    const cudaError_t err = opt_in(reinterpret_cast<const void*>(k), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((P + pt - 1) / pt, H, batch);
    k<<<grid, kThreads, smem, s>>>(xf, dtf, af, bf, cf, yf, sf, S, H, G, P,
                                   N, q, vec_bc, vec_x);
  }
  return static_cast<int>(cudaGetLastError());
}

// d (16x8) = a (16x8) b (8x8), row-major f32 on the device, by one warp
// through the chunk kernel's MMA fragments (3xTF32 with split3 != 0, one
// TF32 product otherwise), for tests/test_torch_gpu.py only: the wrapper
// does not bind it.  Returns cudaGetLastError().
extern "C" int ssd_tf32_probe(const void* a, const void* b, void* d,
                              int split3, void* stream) {
  tf32_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(d), split3);
  return static_cast<int>(cudaGetLastError());
}
