// One-token GQA decode attention for Hopper (sm_90a): the machinery shared
// by swa_decode.cu (dense, ring and windowed caches) and paged_decode.cu
// (block-paged pools).
//
// Split-K (flash-decoding).  The rows one (row b, KV head n) attends are
// cut into S runs of R rows; block (s, n, b) scores run s and writes a
// partial (m, l, acc[G][D]) in f32: the running max, the softmax
// denominator and the unnormalised output.  A second kernel, launched from
// the same C function on the same stream, merges the S partials of each
// (b, n) as a log-sum-exp and writes the output in q's dtype.  The second
// kernel was chosen over "the last block to finish combines" (an atomic
// counter): it keeps no state between calls, so a CUDA graph can capture
// and replay the call any number of times, and its launch costs about a
// microsecond inside a graph.  With S == 1 the split kernel normalises and
// writes the output itself and no combine is launched.  S and R come from
// the shapes alone (the wrapper's plan), never from pos, so the host never
// reads pos.  A run past the row's attended rows writes the empty partial
// (m = -1e30, l = 0, acc = 0), which the merge weighs by exp(-1e30 - M):
// exactly 0 next to a real score, and 1 with l = 0 when every partial is
// empty or all-masked, so it never adds to the denominator.
//
// Pipelined loads in the cache's own type.  K and V rows of a chunk (64
// rows, 32 at D > 128) are copied into shared memory with 16-byte
// cp.async copies, two stages deep: chunk i+1's copies are in flight while
// chunk i is scored.  Each row is copied through its own address (the
// caller's row map: a ring slot a % W, or a pool row found through the
// page table), which a TMA box could not express.  Rows are padded by 16
// bytes, so that the 8 rows one MMA fragment reads start in 8 different
// bank quads.  Rows past the run are zero-filled (cp.async with a source
// size of 0), so no uninitialised value reaches an FMA.
//
// Tensor cores for both products in bf16.  The G <= 16 query groups of a
// head are the 16 rows of mma.sync.aligned.m16n8k16 (bf16 operands, f32
// accumulation; rows past G are zero and never stored).  For QK^T each
// warp owns two n8 tiles of the chunk's rows; a product of two bf16 values
// is exact in f32, so the scores differ from the plain version only in
// summation order.  For PV each warp owns n8 tiles of D and reads V with
// ldmatrix.trans; p (f32) is split into two bf16 parts, hi = bf16(p) and
// lo = bf16(p - hi), and both are multiplied, so p keeps about 16 bits
// (|p - hi - lo| <= 2^-17 p: a relative error below 1e-5 in the output,
// against the bf16 output's own rounding of 2^-9).  wgmma needs 64 rows of
// A, which one query token with G <= 16 cannot fill; mma.sync is the
// Hopper tensor-core instruction that fits.  In f32 (the card-vs-CPU
// parity path) both products are f32 FMAs on CUDA cores, no TF32.  The
// head dim is a template parameter (multiples of 32 up to 256), so every
// loop over it has a fixed trip count: with D a runtime value both
// products of a chunk ran markedly slower on the card (the cause was not
// isolated).
//
// The softmax runs on every group at once (8-32 lanes a group) between the
// two products; ps holds the chunk's f32 scores, then its probabilities.
//
// The all-masked row.  A row whose visited rows are all masked (a dense
// row with no valid slot visits every slot) has every score at -1e30:
// from the running max of -1e30, exp(s - m) is 1 for each row, so the
// partials carry l = their row count and acc = the sum of V, and the merge
// gives the mean of V, as the reference's softmax over an all-masked row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

// The includer names the namespace (DECODE_ATTN_NS), one per library:
// two libraries loaded in one process then never bind to each other's
// kernels or shared-memory records.
#ifndef DECODE_ATTN_NS
#error "define DECODE_ATTN_NS, a namespace unique to the library"
#endif
namespace DECODE_ATTN_NS {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;  // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // the MMA's rows: G <= 16 query groups
constexpr int kStages = 2;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes from global to shared memory, asynchronously; with src_bytes 0
// the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), f32 sums.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows of a chunk: 64, or 32 when a row is longer than 128 features.
constexpr __host__ __device__ int chunk_rows(int D) {
  return D <= 128 ? 64 : 32;
}

// Elements of a padded shared row (16 bytes of padding).
constexpr __host__ __device__ int padded(int D, int itemsize) {
  return D + 16 / itemsize;
}

// Dynamic shared memory of the split kernel: K and V stages, q's 16 rows
// (all in the cache's type), the chunk's scores (f32) and 16 running maxes,
// denominators and rescale factors.
constexpr __host__ __device__ int smem_bytes(int D, int itemsize) {
  const int chunk = chunk_rows(D);
  const int dp = padded(D, itemsize);
  return 2 * kStages * chunk * dp * itemsize + kRows * dp * itemsize +
         kRows * (chunk + 4) * 4 + 3 * kRows * 4;
}

// Shared-memory layout of a split block: K and V stages, q's 16 rows, the
// chunk's scores and the 16 running maxes, denominators and factors.
template <typename T, int D>
struct Smem {
  static constexpr int chunk = chunk_rows(D);
  static constexpr int dp = padded(D, sizeof(T));
  static constexpr int pstride = chunk + 4;
  T* ks;      // [stage][chunk][dp]
  T* vs;      // [stage][chunk][dp]
  T* qs;      // [16][dp]
  float* ps;  // [16][pstride]
  float* m;
  float* l;
  float* alpha;
  __device__ explicit Smem(char* smem)
      : ks(reinterpret_cast<T*>(smem)),
        vs(ks + kStages * chunk * dp),
        qs(vs + kStages * chunk * dp),
        ps(reinterpret_cast<float*>(qs + kRows * dp)),
        m(ps + kRows * pstride),
        l(m + kRows),
        alpha(l + kRows) {}
};

// Starts the copy of q's G rows (G x D of T at qbn) into shared memory as
// its own cp.async group, and zeroes rows G..15.  Called first, before pos
// is read, so that q's round trip overlaps pos's.
template <typename T, int D>
__device__ void stage_q(const T* __restrict__ qbn, int G, char* smem) {
  constexpr int kVec = 16 / sizeof(T);
  const Smem<T, D> sm(smem);
  constexpr int vpr = D / kVec;
  for (int i = threadIdx.x; i < kRows * vpr; i += kThreads) {
    const int g = i / vpr;
    const int col = (i - g * vpr) * kVec;
    T* dst = sm.qs + g * sm.dp + col;
    if (g < G)
      cp_async16(dst, qbn + g * D + col, 16);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
}

// Attends visited rows [r0, r0 + nrows) of one (row, KV head) and writes
// its partial (ml = {m, l} per group, acc = G x D), or, with out != null,
// the normalised output.  map.offset(r) is visited row r's element offset
// from kb/vb; map.valid(r) whether it is attended.  Block-uniform nrows;
// nrows <= 0 writes the empty partial.  stage_q must have been called.
template <typename T, int D, class Map>
__device__ void attend(const T* __restrict__ kb, const T* __restrict__ vb,
                       const Map& map, int r0, int nrows, int G, float scale,
                       T* out, float* ml, float* part, char* smem) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr bool kMma = sizeof(T) == 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // MMA fragment row
  const int tig = lane & 3;   // MMA fragment column pair
  using Sm = Smem<T, D>;
  const Sm sm(smem);
  constexpr int chunk = Sm::chunk;
  constexpr int dp = Sm::dp;
  constexpr int pstride = Sm::pstride;
  float* ps = sm.ps;

  if (nrows <= 0) {
    for (int i = tid; i < G * D; i += kThreads) {
      if (out)
        out[i] = from_f32<T>(0.f);
      else
        part[i] = 0.f;
    }
    if (!out && tid < G) {
      ml[2 * tid] = kNeg;
      ml[2 * tid + 1] = 0.f;
    }
    cp_async_wait<0>();  // q's copy: nothing is left in flight at exit
    return;
  }

  if (tid < kRows) {
    sm.m[tid] = kNeg;
    sm.l[tid] = 0.f;
    sm.alpha[tid] = 0.f;
  }
  // Rows G..15 of p feed only the MMA rows that are never stored; keep
  // them finite.
  for (int i = G * pstride + tid; i < kRows * pstride; i += kThreads)
    ps[i] = 0.f;

  // PV accumulators.  bf16: the MMA's C fragments of n8 tiles warp,
  // warp+4, ... of D (rows gid and gid+8 of the 16 groups).  f32: two
  // features (2*dpair) of groups gset, gset+gstride, ...
  constexpr int kTiles = (D / 8 + kWarps - 1) / kWarps;
  float cf[kMma ? kTiles : 1][4];
  constexpr int npairs = D / 2;
  constexpr int gstride = kThreads / npairs > 0 ? kThreads / npairs : 1;
  constexpr int kPer = kMma ? 1 : (kRows + gstride - 1) / gstride;
  const int dpair = tid % npairs;
  const int gset = tid / npairs;
  float2 acc[kPer];
#pragma unroll
  for (int j = 0; j < (kMma ? kTiles : 1); ++j)
    cf[j][0] = cf[j][1] = cf[j][2] = cf[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = make_float2(0.f, 0.f);

  // Thread tid copies column `col` of rows lrow, lrow + rpp, ...
  constexpr int vpr = D / kVec;
  constexpr int rpp = kThreads / vpr;
  const int lrow = tid / vpr;
  const int col = (tid - lrow * vpr) * kVec;
  const int nchunks = (nrows + chunk - 1) / chunk;
  auto load_chunk = [&](int c, int stage) {
    T* kd = sm.ks + stage * chunk * dp;
    T* vd = sm.vs + stage * chunk * dp;
    const int c0 = c * chunk;
    for (int r = lrow; lrow < rpp && r < chunk; r += rpp) {
      const bool in = c0 + r < nrows;
      const size_t off = in ? map.offset(r0 + c0 + r) + col : 0;
      cp_async16(kd + r * dp + col, kb + off, in ? 16 : 0);
      cp_async16(vd + r * dp + col, vb + off, in ? 16 : 0);
    }
    cp_async_commit();
  };

  load_chunk(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int stage = c & 1;
    if (c + 1 < nchunks) {
      load_chunk(c + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and q, at c = 0) is in shared memory
    const T* kc = sm.ks + stage * chunk * dp;
    const T* vc = sm.vs + stage * chunk * dp;
    const int c0 = c * chunk;
    const int crows = min(chunk, nrows - c0);

    // Scores of the chunk, scaled and masked, into ps[g][r].
    if constexpr (kMma) {
      const __nv_bfloat16* qa =
          reinterpret_cast<const __nv_bfloat16*>(sm.qs) + gid * dp + tig * 2;
      const __nv_bfloat16* qb8 = qa + 8 * dp;
      // A warp owns n8 tiles warp and warp+4 (a chunk has at most 8):
      // two accumulators in flight, or, with one tile, its even and odd
      // k-steps in two.
      const int ntile = (crows + 7) / 8;
      const int t0 = warp;
      const int t1 = warp + kWarps;
      const bool two = t1 < ntile;
      const __nv_bfloat16* kt =
          reinterpret_cast<const __nv_bfloat16*>(kc) + gid * dp + tig * 2;
      const __nv_bfloat16* k0r = kt + t0 * 8 * dp;
      const __nv_bfloat16* k1r = kt + (two ? t1 : t0) * 8 * dp;
      float s0[4] = {0.f, 0.f, 0.f, 0.f};
      float s1[4] = {0.f, 0.f, 0.f, 0.f};
      if (t0 < ntile) {
        if (two) {
#pragma unroll
          for (int kk = 0; kk < D; kk += 16) {
            const uint32_t a[4] = {ld32(qa + kk), ld32(qb8 + kk),
                                   ld32(qa + kk + 8), ld32(qb8 + kk + 8)};
            const uint32_t b0[2] = {ld32(k0r + kk), ld32(k0r + kk + 8)};
            const uint32_t b1[2] = {ld32(k1r + kk), ld32(k1r + kk + 8)};
            mma_bf16(s0, a, b0);
            mma_bf16(s1, a, b1);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < D; kk += 32) {
            const uint32_t a0[4] = {ld32(qa + kk), ld32(qb8 + kk),
                                    ld32(qa + kk + 8), ld32(qb8 + kk + 8)};
            const uint32_t a1[4] = {ld32(qa + kk + 16), ld32(qb8 + kk + 16),
                                    ld32(qa + kk + 24), ld32(qb8 + kk + 24)};
            const uint32_t b0[2] = {ld32(k0r + kk), ld32(k0r + kk + 8)};
            const uint32_t b1[2] = {ld32(k0r + kk + 16), ld32(k0r + kk + 24)};
            mma_bf16(s0, a0, b0);
            mma_bf16(s1, a1, b1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s0[e] += s1[e];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = h ? t1 : t0;
        const float* sc = h ? s1 : s0;
        if (h ? !two : t0 >= ntile) continue;
        const int col = t * 8 + tig * 2;
        const bool v0 = map.valid(r0 + c0 + col);
        const bool v1 = map.valid(r0 + c0 + col + 1);
        if (gid < G)
          *reinterpret_cast<float2*>(ps + gid * pstride + col) =
              make_float2(v0 ? sc[0] * scale : kNeg,
                          v1 ? sc[1] * scale : kNeg);
        if (gid + 8 < G)
          *reinterpret_cast<float2*>(ps + (gid + 8) * pstride + col) =
              make_float2(v0 ? sc[2] * scale : kNeg,
                          v1 ? sc[3] * scale : kNeg);
      }
    } else {
      const float* qf = reinterpret_cast<const float*>(sm.qs);
      const float* kf = reinterpret_cast<const float*>(kc);
      for (int i = tid; i < G * crows; i += kThreads) {
        const int g = i / crows;
        const int r = i - g * crows;
        const float4* qv = reinterpret_cast<const float4*>(qf + g * dp);
        const float4* kv = reinterpret_cast<const float4*>(kf + r * dp);
        float s = 0.f;
#pragma unroll 8
        for (int e = 0; e < D / 4; ++e) {
          const float4 x = qv[e];
          const float4 y = kv[e];
          s = fmaf(x.x, y.x, s);
          s = fmaf(x.y, y.y, s);
          s = fmaf(x.z, y.z, s);
          s = fmaf(x.w, y.w, s);
        }
        ps[g * pstride + r] = map.valid(r0 + c0 + r) ? s * scale : kNeg;
      }
    }
    __syncthreads();

    // Online softmax, every group at once: warp w owns groups w, w+4, ...,
    // each on L = 32, 16 or 8 of its lanes; p = 0 past crows.
    {
      const int gpw = (G + kWarps - 1) / kWarps;
      const int L = gpw == 1 ? 32 : gpw == 2 ? 16 : 8;
      const int sl = lane & (L - 1);
      const int g = warp + kWarps * (lane / L);
      const bool gv = g < G;
      float* pg = ps + (gv ? g : 0) * pstride;
      float mloc = kNeg;
      if (gv)
        for (int r = sl; r < crows; r += L) mloc = fmaxf(mloc, pg[r]);
      for (int off = L / 2; off > 0; off >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      const float m_old = gv ? sm.m[g] : kNeg;
      const float m_new = fmaxf(m_old, mloc);
      float lsum = 0.f;
      if (gv)
        for (int r = sl; r < chunk; r += L) {
          const float p = r < crows ? expf(pg[r] - m_new) : 0.f;
          pg[r] = p;
          lsum += p;
        }
      for (int off = L / 2; off > 0; off >>= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      if (gv && sl == 0) {
        const float alpha = expf(m_old - m_new);
        sm.alpha[g] = alpha;
        sm.l[g] = sm.l[g] * alpha + lsum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p V over the chunk (past crows: p = 0, V = 0).
    if constexpr (kMma) {
      // p = hi + lo, two bf16 parts (p - hi - lo is below 2^-16 p), so
      // two MMAs carry p to about 16 bits; V is exact in bf16.
      const float al0 = sm.alpha[gid];
      const float al8 = sm.alpha[gid + 8];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        cf[j][0] *= al0;
        cf[j][1] *= al0;
        cf[j][2] *= al8;
        cf[j][3] *= al8;
      }
      const __nv_bfloat16* vt = reinterpret_cast<const __nv_bfloat16*>(vc);
      for (int k0 = 0; k0 < crows; k0 += 16) {
        uint32_t hi[4], lo[4];
        const float* pr = ps + gid * pstride + k0 + tig * 2;
        const float2 f[4] = {
            *reinterpret_cast<const float2*>(pr),
            *reinterpret_cast<const float2*>(pr + 8 * pstride),
            *reinterpret_cast<const float2*>(pr + 8),
            *reinterpret_cast<const float2*>(pr + 8 * pstride + 8)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h = __float22bfloat162_rn(f[e]);
          const float2 hf = __bfloat1622float2(h);
          const __nv_bfloat162 l =
              __float22bfloat162_rn(make_float2(f[e].x - hf.x, f[e].y - hf.y));
          hi[e] = *reinterpret_cast<const uint32_t*>(&h);
          lo[e] = *reinterpret_cast<const uint32_t*>(&l);
        }
        const unsigned vrow = static_cast<unsigned>(__cvta_generic_to_shared(
            vt + (k0 + (lane & 15)) * dp));
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          const int nt = warp + j * kWarps;
          if (nt < D / 8) {
            uint32_t b[2];
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, "
                "[%2];\n"
                : "=r"(b[0]), "=r"(b[1])
                : "r"(vrow + nt * 16));
            mma_bf16(cf[j], hi, b);
            mma_bf16(cf[j], lo, b);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int g = gset + j * gstride;
        if (g < G && gset < gstride) {
          const float al = sm.alpha[g];
          float2 a = make_float2(acc[j].x * al, acc[j].y * al);
          const float* pg = ps + g * pstride;
          const float* vf = reinterpret_cast<const float*>(vc) + 2 * dpair;
          for (int r = 0; r < crows; ++r) {
            const float p = pg[r];
            const float2 v = *reinterpret_cast<const float2*>(vf + r * dp);
            a.x = fmaf(p, v.x, a.x);
            a.y = fmaf(p, v.y, a.y);
          }
          acc[j] = a;
        }
      }
    }
    __syncthreads();  // the stage and ps are free for the next chunk
  }

  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int nt = warp + j * kWarps;
      if (nt < D / 8) {
        const int col = nt * 8 + tig * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int g = gid + 8 * h;
          if (g < G) {
            if (out) {
              const float dn = fmaxf(sm.l[g], 1e-30f);
              out[g * D + col] = from_f32<T>(cf[j][2 * h] / dn);
              out[g * D + col + 1] = from_f32<T>(cf[j][2 * h + 1] / dn);
            } else {
              *reinterpret_cast<float2*>(part + g * D + col) =
                  make_float2(cf[j][2 * h], cf[j][2 * h + 1]);
            }
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int g = gset + j * gstride;
      if (g < G && gset < gstride) {
        const int o = g * D + 2 * dpair;
        if (out) {
          const float dn = fmaxf(sm.l[g], 1e-30f);
          out[o] = from_f32<T>(acc[j].x / dn);
          out[o + 1] = from_f32<T>(acc[j].y / dn);
        } else {
          *reinterpret_cast<float2*>(part + o) = acc[j];
        }
      }
    }
  }
  if (!out && tid < G) {
    ml[2 * tid] = sm.m[tid];
    ml[2 * tid + 1] = sm.l[tid];
  }
}

// Where block (s, n, b) of a grid (S, N, B) writes: with S == 1 the
// output rows of (b, n) (out), else its partial in `part`, which holds the
// (B*N, S, G, D) sums and then the (B*N, S, G, 2) maxes and denominators.
template <typename T>
struct Dest {
  T* out;
  float* ml;
  float* acc;
};
template <typename T>
__device__ inline Dest<T> block_dest(float* part, T* out, int G, int D) {
  const int S = gridDim.x;
  const size_t bn = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  if (S == 1) return {out + bn * G * D, nullptr, nullptr};
  const size_t blk = bn * S + blockIdx.x;
  const size_t acc_floats =
      static_cast<size_t>(gridDim.z) * gridDim.y * S * G * D;
  return {nullptr, part + acc_floats + blk * G * 2, part + blk * G * D};
}

// Merges the S partials: out = sum_s acc_s exp(m_s - M) / sum_s l_s
// exp(m_s - M), M = max m_s.  Eight consecutive threads share four
// outputs: thread k of the eight merges splits k, k+8, ... online, and
// three shuffles merge the eight states, so a thread waits on ceil(S/8)
// round trips to L2.  acc holds (B*N, S, G, D) floats, ml (B*N, S, G, 2);
// total4 = B*N*G*D / 4.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
                   T* __restrict__ out, int S, int G, int D, int total4) {
  constexpr int kSub = 8;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int i4 = t / kSub;
  const int sub = t % kSub;
  const bool live = i4 < total4;
  const int e = 4 * (live ? i4 : 0);
  const int gd = G * D;
  const int bn = e / gd;
  const int i = e - bn * gd;
  const float2* mlb = reinterpret_cast<const float2*>(ml) +
                      static_cast<size_t>(bn) * S * G + i / D;
  const float4* accb = reinterpret_cast<const float4*>(
      acc + static_cast<size_t>(bn) * S * gd + i);
  const int sstride = gd / 4;
  float m = kNeg, l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = sub; live && s < S; s += kSub) {
    const float2 x = mlb[s * G];
    const float4 a = accb[s * sstride];
    const float m_new = fmaxf(m, x.x);
    const float f = expf(m - m_new);
    const float w = expf(x.x - m_new);
    m = m_new;
    l = fmaf(w, x.y, l * f);
    o = make_float4(fmaf(w, a.x, o.x * f), fmaf(w, a.y, o.y * f),
                    fmaf(w, a.z, o.z * f), fmaf(w, a.w, o.w * f));
  }
#pragma unroll
  for (int off = 1; off < kSub; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float4 o2 = make_float4(__shfl_xor_sync(0xffffffffu, o.x, off),
                                  __shfl_xor_sync(0xffffffffu, o.y, off),
                                  __shfl_xor_sync(0xffffffffu, o.z, off),
                                  __shfl_xor_sync(0xffffffffu, o.w, off));
    const float m_new = fmaxf(m, m2);
    const float f = expf(m - m_new);
    const float f2 = expf(m2 - m_new);
    m = m_new;
    l = l * f + l2 * f2;
    o = make_float4(o.x * f + o2.x * f2, o.y * f + o2.y * f2,
                    o.z * f + o2.z * f2, o.w * f + o2.w * f2);
  }
  if (!live || sub != 0) return;
  const float dn = fmaxf(l, 1e-30f);
  T* ob = out + e;
  ob[0] = from_f32<T>(o.x / dn);
  ob[1] = from_f32<T>(o.y / dn);
  ob[2] = from_f32<T>(o.z / dn);
  ob[3] = from_f32<T>(o.w / dn);
}

// Raises a kernel's dynamic shared-memory limit to `bytes` once (before
// any graph capture: the first call of each plan runs eagerly).  Returns
// the CUDA error, with the sticky error cleared.
template <typename K>
inline cudaError_t opt_in(K kernel, int bytes, int* opted) {
  if (bytes <= *opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  *opted = bytes;
  return cudaSuccess;
}

// The dynamic shared memory the split kernel Split may use so far.
template <auto Split>
int opted_bytes = 48 * 1024;

// Launches Split (grid (S, N, B)) and, with S > 1, the combine.  `part`
// holds B*N*S*G*(D+2) floats (unused with S == 1).
template <typename T, int D, auto Split, typename... Args>
inline int launch(int B, int N, int G, int S, float* part, T* out,
                  cudaStream_t stream, Args... args) {
  constexpr int smem = smem_bytes(D, sizeof(T));
  cudaError_t err = opt_in(Split, smem, &opted_bytes<Split>);
  if (err != cudaSuccess) return static_cast<int>(err);
  Split<<<dim3(S, N, B), kThreads, smem, stream>>>(args..., part, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const size_t acc_floats = static_cast<size_t>(B) * N * S * G * D;
  const int total4 = B * N * G * D / 4;
  const int blocks = (8 * total4 + kThreads - 1) / kThreads;
  combine_kernel<T><<<blocks, kThreads, 0, stream>>>(
      part, part + acc_floats, out, S, G, D, total4);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(std::integral_constant<int, D>{}) for the head dims the kernels
// are built for (multiples of 32 up to 256).
template <typename F>
inline int dispatch_d(int D, F&& f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 160: return f(std::integral_constant<int, 160>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 224: return f(std::integral_constant<int, 224>{});
    case 256: return f(std::integral_constant<int, 256>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace DECODE_ATTN_NS

// Dynamic shared memory (bytes) one split block asks for: the wrapper's
// plan computes the same (a card test holds them equal).
extern "C" int decode_attn_smem_bytes(int D, int is_bf16) {
  return DECODE_ATTN_NS::smem_bytes(D, is_bf16 ? 2 : 4);
}
