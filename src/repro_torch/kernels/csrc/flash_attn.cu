// Full-sequence GQA attention for Hopper (sm_90a): a fused, tiled,
// online-softmax forward and its backward (FlashAttention-2's algorithm),
// plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves
// src/repro/nn/attention.py::attend_full to XLA.  The port's plain version
// (kernels/ref.py::attend_full_ref, a loop over query chunks) writes every
// score chunk to device memory several times (a bf16 product, its f32
// copy, the masked copy, the softmax, its bf16 cast) and computes whole key
// rows where the causal mask throws half away: about half of a
// Granite-3-2B Phase-2 step and of a Qwen3-14B prefill on the H100.
//
// q (B, S, H, D), k and v (B, T, N, D), contiguous, GQA head h = n G + g;
// query row i sits at position q_offset + i, key j at j; row i keeps key j
// when j <= its position (causal) and j > its position - window (window >
// 0).  The forward writes O (B, S, H, D) and the per-row log-sum-exp
// (B, H, S) f32 of the scaled, masked scores; the backward takes dO, O and
// the log-sum-exp and writes dq, dk, dv.
//
// What bounds it on an H100: the QK^T and PV products (989 TFLOP/s of
// bf16 tensor cores).  q, k and v are read about once a block's tile and
// the output written once; at 2,048 positions the products, not the
// bytes, set the least time.  What the design does about that:
//
// * No (S, T) tensor reaches device memory.  A forward block holds 128
//   query rows of one head (64 past D 128; a warp owns one or two 16-row
//   MMA tiles) and walks the key blocks they attend through a two-stage
//   cp.async ring in shared memory; the scores
//   stay in the MMA's f32 accumulators, the running max and sum in f32
//   registers, and the output accumulator is rescaled as it goes and
//   written once, normalised.
// * Key blocks the mask removes entirely are never loaded (causal, a
//   sliding window, and q_offset for a query block after a prefix of keys,
//   T >= S); of those visited, only the blocks on the mask's edges are
//   masked, in registers (key_segments; query_segments for the dK/dV
//   block's query blocks).  flash_attn.py computes the same ranges in
//   Python for the CPU emulation.
// * bf16 products on the tensor cores with mma.sync m16n8k16 (f32
//   accumulation), operands from shared memory with ldmatrix (rows padded
//   by 16 bytes, so the eight rows of a fragment start in eight bank
//   quads).  The scores stay f32 into the softmax; P is rounded to bf16
//   for PV, as the plain version rounds its probabilities.  mma.sync, not
//   wgmma: its 16-row warp tiles keep the FA-2 layout (each warp owns its
//   rows' softmax with no cross-warp exchange) and need no shared-memory
//   descriptors.  Fed by ldmatrix, its ceiling is the shared memory's
//   bandwidth (each warp reads the whole K and V tile), so a warp owns
//   two 16-row tiles where the registers allow and every fragment it
//   reads feeds two products.
// * The backward: a pre-pass for delta = rowsum(dO * O); one block a (row,
//   kv head, key block) accumulates dK and dV over the group's G query
//   heads and every query block it attends, in registers; one block a
//   (row, query head, query block) accumulates dQ over its key blocks.
//   Every sum is taken inside one block, so there is no float atomic and a
//   gradient repeats bit for bit.  P is recomputed from the log-sum-exp.
// * f32 inputs (the card-vs-CPU parity path, not a speed path) compute in
//   full IEEE f32 on the CUDA cores, never TF32: eight lanes a row, each
//   owning a quarter-warp-interleaved slice of the head dim.
//
// The padded head dim (FLASH_D_PAD, a multiple of 32 up to 256) is this
// library's one template parameter: the build makes one library a padded
// head dim (kernels/flash_attn.py loads it), so only the head dims a
// process uses are compiled.  Tiles are compile-time constants of it
// (flash_attn_plan reports them; the wrapper's plan() holds the same).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#ifndef FLASH_D_PAD
#error "define FLASH_D_PAD, the padded head dim of this library"
#endif

namespace {

constexpr int kDp = FLASH_D_PAD;
static_assert(kDp % 32 == 0 && kDp >= 32 && kDp <= 256,
              "FLASH_D_PAD is a multiple of 32 up to 256");

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps a block
constexpr int kLd = kDp + 8;    // a bf16 tile's padded row (16 bytes)
constexpr float kNeg = -1e30f;  // a masked score, in log2 units
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bf16 tiles.  A warp of the forward owns kFwdMt 16-row MMA tiles of
// query rows: two up to D 128, so that every K and V fragment read from
// shared memory feeds two MMAs (shared-memory bandwidth, not the tensor
// cores, bounds mma.sync tiles fed by ldmatrix), one past it, where the
// f32 output accumulator alone takes D / 2 registers a thread and a tile.
// Key blocks of 64, 32 where the accumulators leave fewer registers.
// dQ: two tiles a warp up to D 64.  dK/dV: 16 key rows a warp; past D 128
// two warps share them, each accumulating half of the head dim.
constexpr int kFwdMt = kDp <= 128 ? 2 : 1;
constexpr int kFwdM = 4 * 16 * kFwdMt;
constexpr int kFwdN = kDp <= 64 ? 64 : 32;
constexpr int kKvSplit = kDp <= 128 ? 1 : 2;
constexpr int kKvN = 64 / kKvSplit;
constexpr int kKvM = kDp <= 64 ? 64 : 32;
constexpr int kDqMt = kDp <= 64 ? 2 : 1;
constexpr int kDqM = 4 * 16 * kDqMt;
constexpr int kDqN = kDp <= 64 ? 32 : kDp <= 128 ? 64 : 32;

constexpr int kFwdSmem = (kFwdM + 4 * kFwdN) * kLd * 2;
constexpr int kKvSmem = (2 * kKvN + 4 * kKvM) * kLd * 2 + 4 * kKvM * 4;
constexpr int kDqSmem = (2 * kDqM + 4 * kDqN) * kLd * 2;

// f32 tiles: 16 rows a block (8 lanes a row), 32 streamed rows a tile.
constexpr int kLanes = 8;
constexpr int kRowsF = kThreads / kLanes;
constexpr int kTileF = 32;
constexpr int kChunksF = kDp / (4 * kLanes);  // float4s a lane
constexpr int kFwdSmemF = 2 * kTileF * kDp * 4;
constexpr int kKvSmemF = 2 * kTileF * kDp * 4 + 2 * kTileF * 4;
constexpr int kDqSmemF = 2 * kTileF * kDp * 4;

// -- the block ranges -------------------------------------------------------

struct Segs {
  int a, b, c, d;  // visit [a, d) in block steps; [b, c) unmasked
};

__device__ __forceinline__ int ceil_to(int x, int m) {
  return (x + m - 1) / m * m;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The key blocks (of bn) the query rows [m0, m0 + bm) visit: [a, b) the
// window's edge, [b, c) blocks every valid row attends whole, [c, d) the
// causal diagonal and T's ragged end (flash_attn.py::key_segments).
__device__ Segs key_segments(int m0, int S, int T, int q_offset, int causal,
                             int window, int bm, int bn) {
  const int p_lo = q_offset + m0;
  const int p_hi = q_offset + min(m0 + bm, S) - 1;
  const int lo = window > 0 ? max(p_lo - window + 1, 0) : 0;
  const int a = lo / bn * bn;
  const int d = causal ? min(T, p_hi + 1) : T;
  const int full_lo = window > 0 ? ceil_to(max(p_hi - window + 1, 0), bn) : 0;
  const int full_hi = (causal ? min(T, p_lo + 1) : T) / bn * bn;
  const int b = clampi(full_lo, a, d);
  return {a, b, clampi(full_hi, b, d), d};
}

// The query blocks (of bm) the key rows [n0, n0 + bn) are attended from:
// [a, b) the causal diagonal, [b, c) blocks whose rows all attend every key
// of the block, [c, d) the window's far edge and S's ragged end
// (flash_attn.py::query_segments).
__device__ Segs query_segments(int n0, int S, int T, int q_offset,
                               int causal, int window, int bm, int bn) {
  const int n_last = min(n0 + bn, T) - 1;
  const int m_lo = causal ? max(n0 - q_offset, 0) : 0;
  const int a = m_lo / bm * bm;
  const int d = max(window > 0 ? min(S, n_last + window - q_offset) : S, a);
  const int full_lo = causal ? ceil_to(max(n0 + bn - 1 - q_offset, 0), bm) : 0;
  int full_hi = (window > 0 ? max(min(S, n0 + window - q_offset), 0) : S) /
                bm * bm;
  if (n0 + bn > T) full_hi = 0;
  const int b = clampi(full_lo, a, d);
  return {a, b, clampi(full_hi, b, d), d};
}

// Query row `row` keeps key `col`.
__device__ __forceinline__ bool keep(int row, int col, int S, int T,
                                     int q_offset, int causal, int window) {
  const int pos = q_offset + row;
  return row < S && col < T && (!causal || col <= pos) &&
         (window <= 0 || col > pos - window);
}

// -- copies and tensor-core fragments ---------------------------------------

// 16 bytes from global to shared memory, asynchronously; with src_bytes 0
// the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying rows [r0, r0 + R) of a matrix whose row r is the D
// elements at src + r * stride into dst[R][LD]; rows at or past `rows` and
// the columns from D to kDp are zero-filled.  D is a multiple of 16 bytes.
template <typename T, int R, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t stride,
                                          int r0, int rows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kDp / kVec;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * kVec;
    const bool in = r0 + r < rows && c < D;
    cp_async16(dst + r * LD + c,
               in ? src + static_cast<size_t>(r0 + r) * stride + c : src,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A lane's ldmatrix address for the A operand: 16 rows from row0 of a
// [rows][kLd] tile (add 2 * kk bytes for the columns kk..kk+15).
__device__ __forceinline__ uint32_t a_addr(const bf16* tile, int row0,
                                           int lane) {
  return smem_u32(tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                  (lane >> 4) * 8);
}
// For a B operand whose n index runs along the tile's rows (K for QK^T):
// two n8 tiles, rows row0..row0+15.
__device__ __forceinline__ uint32_t b_addr(const bf16* tile, int row0,
                                           int lane) {
  return smem_u32(tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                  ((lane >> 3) & 1) * 8);
}
// For a B operand whose k index runs along the tile's rows (V for PV):
// k rows row0..row0+15, two n8 tiles of columns (add 2 * col0 bytes).
__device__ __forceinline__ uint32_t bt_addr(const bf16* tile, int row0,
                                            int lane) {
  return smem_u32(tile + (row0 + (lane & 15)) * kLd + (lane >> 4) * 8);
}

// acc (MT tiles of 16 x NR, NR/8 C fragments each) += A (16 MT x kDp,
// the MT tiles from a_base down) B^T, with B's NR rows in a [NR][kLd]
// tile: a warp's scores against a block of keys.  Each B fragment feeds MT
// MMAs.
template <int MT, int NR>
__device__ __forceinline__ void gemm_nt(float (*acc)[NR / 8][4],
                                        uint32_t a_base, uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < kDp; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], a_base + (mt * 16 * kLd + kk) * 2);
#pragma unroll
    for (int np = 0; np < NR / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_base + (np * 16 * kLd + kk) * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b + 2);
      }
    }
  }
}

// acc (MT tiles of 16 x NC) += P (MT tiles of 16 x KR, the C fragments of
// a gemm_nt, rounded to bf16) V, with V's KR rows of NC columns in a
// [KR][kLd] tile from b_base.  Each V fragment feeds MT MMAs.
template <int MT, int KR, int NC>
__device__ __forceinline__ void gemm_pv(float (*acc)[NC / 8][4],
                                        float (*p)[KR / 8][4],
                                        uint32_t b_base) {
#pragma unroll
  for (int j = 0; j < KR / 16; ++j) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(p[mt][2 * j][0], p[mt][2 * j][1]);
      a[mt][1] = pack_bf16(p[mt][2 * j][2], p[mt][2 * j][3]);
      a[mt][2] = pack_bf16(p[mt][2 * j + 1][0], p[mt][2 * j + 1][1]);
      a[mt][3] = pack_bf16(p[mt][2 * j + 1][2], p[mt][2 * j + 1][3]);
    }
#pragma unroll
    for (int dt = 0; dt < NC / 16; ++dt) {
      uint32_t b[4];
      ldsm_x4_t(b, b_base + (j * 16 * kLd + dt * 16) * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * dt], a[mt], b);
        mma_bf16(acc[mt][2 * dt + 1], a[mt], b + 2);
      }
    }
  }
}

// Stores a warp's MT tiles of 16 x NC f32 fragments (rows row0.., columns
// col0..) of a matrix with row stride `stride` as bf16, the thread's row
// i = 2 mt + r (rows row0 + 16 mt + lane / 4 + 8 r) scaled by scale[i];
// rows at or past `rows` and columns at or past D are skipped.
template <int MT, int NC>
__device__ __forceinline__ void store_frags(bf16* dst, size_t stride,
                                            float (*acc)[NC / 8][4],
                                            int row0, int rows, int col0,
                                            int D, const float* scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * mt + (lane >> 2) + 8 * r;
      if (row >= rows) continue;
      const float sc = scale[2 * mt + r];
      bf16* out = dst + static_cast<size_t>(row) * stride;
#pragma unroll
      for (int t = 0; t < NC / 8; ++t) {
        const int col = col0 + t * 8 + (lane & 3) * 2;
        if (col < D)
          *reinterpret_cast<uint32_t*>(out + col) =
              pack_bf16(acc[mt][t][2 * r] * sc, acc[mt][t][2 * r + 1] * sc);
      }
    }
}

// -- bf16 kernels -------------------------------------------------------------

// grid (B*H, ceil(S / kFwdM)), the heaviest causal query blocks first;
// kFwdSmem dynamic shared bytes.
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int S, int T, int H, int N,
                          int D, int q_offset, int causal, int window,
                          float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kFwdM][kLd]
  bf16* ks = qs + kFwdM * kLd;               // [2][kFwdN][kLd]
  bf16* vs = ks + 2 * kFwdN * kLd;           // [2][kFwdN][kLd]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n = h / (H / N);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kFwdM;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(N) * D;
  const size_t q0 = static_cast<size_t>(b) * S * qstride +
                    static_cast<size_t>(h) * D;
  const size_t kv0 = static_cast<size_t>(b) * T * kstride +
                     static_cast<size_t>(n) * D;
  const bf16* kg = k + kv0;
  const bf16* vg = v + kv0;

  load_tile<bf16, kFwdM, kLd>(qs, q + q0, qstride, m0, S, D);
  cp_async_commit();
  const Segs sg =
      key_segments(m0, S, T, q_offset, causal, window, kFwdM, kFwdN);
  if (sg.a < sg.d) {
    load_tile<bf16, kFwdN, kLd>(ks, kg, kstride, sg.a, T, D);
    load_tile<bf16, kFwdN, kLd>(vs, vg, kstride, sg.a, T, D);
  }
  cp_async_commit();

  // The thread's rows: i = 2 mt + r is row wrow + 16 mt + gid + 8 r of
  // the block.
  constexpr int kR = 2 * kFwdMt;
  float oacc[kFwdMt][kDp / 8][4] = {};
  float mrow[kR], lrow[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    mrow[i] = kNeg;
    lrow[i] = 0.f;
  }
  const int wrow = warp * 16 * kFwdMt;
  const int row0 = m0 + wrow + gid;
  const uint32_t qa = a_addr(qs, wrow, lane);
  int stage = 0;
  for (int n0 = sg.a; n0 < sg.d; n0 += kFwdN, stage ^= 1) {
    if (n0 + kFwdN < sg.d) {
      const int nx = (stage ^ 1) * kFwdN * kLd;
      load_tile<bf16, kFwdN, kLd>(ks + nx, kg, kstride, n0 + kFwdN, T, D);
      load_tile<bf16, kFwdN, kLd>(vs + nx, vg, kstride, n0 + kFwdN, T, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // q (first pass) and this key block are in place
    const bf16* kt = ks + stage * kFwdN * kLd;
    const bf16* vt = vs + stage * kFwdN * kLd;
    float s[kFwdMt][kFwdN / 8][4] = {};
    gemm_nt<kFwdMt, kFwdN>(s, qa, b_addr(kt, 0, lane));
    const bool masked = n0 < sg.b || n0 >= sg.c;
    float mx[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) mx[i] = kNeg;
#pragma unroll
    for (int mt = 0; mt < kFwdMt; ++mt)
#pragma unroll
      for (int t = 0; t < kFwdN / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * mt + (e >> 1);
          float x = s[mt][t][e] * scale_log2;
          if (masked && !keep(row0 + 16 * mt + (e >> 1) * 8,
                              n0 + t * 8 + tig * 2 + (e & 1), S, T, q_offset,
                              causal, window))
            x = kNeg;
          s[mt][t][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(mrow[i], mx[i]);
      alpha[i] = ex2(mrow[i] - m_new);
      mrow[i] = m_new;
      lrow[i] *= alpha[i];
    }
#pragma unroll
    for (int mt = 0; mt < kFwdMt; ++mt) {
#pragma unroll
      for (int t = 0; t < kFwdN / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * mt + (e >> 1);
          const float p = ex2(s[mt][t][e] - mrow[i]);
          s[mt][t][e] = p;
          lrow[i] += p;
        }
#pragma unroll
      for (int t = 0; t < kDp / 8; ++t) {
        oacc[mt][t][0] *= alpha[2 * mt];
        oacc[mt][t][1] *= alpha[2 * mt];
        oacc[mt][t][2] *= alpha[2 * mt + 1];
        oacc[mt][t][3] *= alpha[2 * mt + 1];
      }
    }
    gemm_pv<kFwdMt, kFwdN, kDp>(oacc, s, bt_addr(vt, 0, lane));
    __syncthreads();  // this stage is free for the block after next
  }

  float inv[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
    inv[i] = lrow[i] > 0.f ? 1.f / lrow[i] : 0.f;
    const int row = row0 + 16 * (i >> 1) + 8 * (i & 1);
    if (tig == 0 && row < S)
      lse[static_cast<size_t>(bh) * S + row] =
          (mrow[i] + log2f(lrow[i])) * kLn2;
  }
  store_frags<kFwdMt, kDp>(o + q0, qstride, oacc, m0 + wrow, S, 0, D, inv);
}

// delta = rowsum(dO * O) in f32, one warp a (b, s, h) row of D, 16-byte
// loads (D is a multiple of 16 bytes); written (B, H, S).
template <typename T>
__global__ void __launch_bounds__(256)
    flash_attn_bwd_delta_kernel(const T* __restrict__ o,
                                const T* __restrict__ dout,
                                float* __restrict__ delta, int S, int H,
                                int D, long long rows) {
  constexpr int kVec = 16 / sizeof(T);
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* a = o + r * D;
  const T* g = dout + r * D;
  float acc = 0.f;
  for (int c = lane * kVec; c < D; c += 32 * kVec) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + c);
    const uint4 y = *reinterpret_cast<const uint4*>(g + c);
    const T* xs = reinterpret_cast<const T*>(&x);
    const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc = fmaf(to_f32(xs[e]), to_f32(ys[e]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(r % H);
    const long long bs = r / H;
    const int s = static_cast<int>(bs % S);
    const long long b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

// grid (B*N, ceil(T / kKvN)); kKvSmem dynamic shared bytes.  Warp w owns
// key rows 16 (w / kKvSplit).. and head-dim slice w % kKvSplit of dK, dV.
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkdv_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int S, int T, int H, int N, int D,
                               int q_offset, int causal, int window,
                               float scale_log2, float sm_scale) {
  constexpr int kDw = kDp / kKvSplit;
  extern __shared__ __align__(16) char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [kKvN][kLd]
  bf16* vs = ks + kKvN * kLd;                // [kKvN][kLd]
  bf16* qs = vs + kKvN * kLd;                // [2][kKvM][kLd]
  bf16* dos = qs + 2 * kKvM * kLd;           // [2][kKvM][kLd]
  float* ls = reinterpret_cast<float*>(dos + 2 * kKvM * kLd);  // [2][kKvM]
  float* dls = ls + 2 * kKvM;                                  // [2][kKvM]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int kw = warp / kKvSplit;
  const int col0 = (warp % kKvSplit) * kDw;
  const int bn = blockIdx.x;
  const int b = bn / N;
  const int n = bn - b * N;
  const int G = H / N;
  const int n0 = blockIdx.y * kKvN;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(N) * D;
  const size_t kv0 = static_cast<size_t>(b) * T * kstride +
                     static_cast<size_t>(n) * D;

  load_tile<bf16, kKvN, kLd>(ks, k + kv0, kstride, n0, T, D);
  load_tile<bf16, kKvN, kLd>(vs, v + kv0, kstride, n0, T, D);
  cp_async_commit();
  const Segs sg =
      query_segments(n0, S, T, q_offset, causal, window, kKvM, kKvN);
  const int nq = sg.d > sg.a ? (sg.d - sg.a + kKvM - 1) / kKvM : 0;
  const int items = G * nq;
  // Item i: query head n G + i / nq, query block a + (i % nq) kKvM.
  auto load_item = [&](int i, int st) {
    const int h = n * G + i / nq;
    const int m0 = sg.a + (i % nq) * kKvM;
    const size_t q0 = static_cast<size_t>(b) * S * qstride +
                      static_cast<size_t>(h) * D;
    load_tile<bf16, kKvM, kLd>(qs + st * kKvM * kLd, q + q0, qstride, m0, S,
                               D);
    load_tile<bf16, kKvM, kLd>(dos + st * kKvM * kLd, dout + q0, qstride, m0,
                               S, D);
    const size_t r0 = (static_cast<size_t>(b) * H + h) * S;
    for (int i2 = threadIdx.x; i2 < kKvM; i2 += kThreads) {
      const int row = m0 + i2;
      ls[st * kKvM + i2] = row < S ? lse[r0 + row] * kLog2e : 0.f;
      dls[st * kKvM + i2] = row < S ? delta[r0 + row] : 0.f;
    }
  };
  if (items > 0) load_item(0, 0);
  cp_async_commit();

  float dka[1][kDw / 8][4] = {};
  float dva[1][kDw / 8][4] = {};
  const uint32_t ka = a_addr(ks, kw * 16, lane);
  const uint32_t va = a_addr(vs, kw * 16, lane);
  const int key0 = n0 + kw * 16 + gid;
  int stage = 0;
  for (int i = 0; i < items; ++i, stage ^= 1) {
    if (i + 1 < items) {
      load_item(i + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // k, v (first pass) and this query block are in place
    const int m0 = sg.a + (i % nq) * kKvM;
    const bool masked = m0 < sg.b || m0 >= sg.c;
    const bf16* qt = qs + stage * kKvM * kLd;
    const bf16* dot = dos + stage * kKvM * kLd;
    const float* lt = ls + stage * kKvM;
    const float* dlt = dls + stage * kKvM;
    float s[1][kKvM / 8][4] = {};
    float dp[1][kKvM / 8][4] = {};
    gemm_nt<1, kKvM>(s, ka, b_addr(qt, 0, lane));    // S^T = K Q^T
    gemm_nt<1, kKvM>(dp, va, b_addr(dot, 0, lane));  // dP^T = V dO^T
#pragma unroll
    for (int t = 0; t < kKvM / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = t * 8 + tig * 2 + (e & 1);
        float p = ex2(s[0][t][e] * scale_log2 - lt[c]);
        if (masked && !keep(m0 + c, key0 + (e >> 1) * 8, S, T, q_offset,
                            causal, window))
          p = 0.f;
        s[0][t][e] = p;
        dp[0][t][e] = p * (dp[0][t][e] - dlt[c]);
      }
    gemm_pv<1, kKvM, kDw>(dva, s, bt_addr(dot, 0, lane) + col0 * 2);  // P^T dO
    gemm_pv<1, kKvM, kDw>(dka, dp, bt_addr(qt, 0, lane) + col0 * 2);  // dS^T Q
    __syncthreads();  // this stage is free for the item after next
  }
  const float scales[4] = {sm_scale, sm_scale, 1.f, 1.f};
  store_frags<1, kDw>(dk + kv0, kstride, dka, n0 + kw * 16, T, col0, D,
                      scales);
  store_frags<1, kDw>(dv + kv0, kstride, dva, n0 + kw * 16, T, col0, D,
                      scales + 2);
}

// grid (B*H, ceil(S / kDqM)), the heaviest causal query blocks first;
// kDqSmem dynamic shared bytes.
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int S, int T, int H,
                             int N, int D, int q_offset, int causal,
                             int window, float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kDqM][kLd]
  bf16* dos = qs + kDqM * kLd;               // [kDqM][kLd]
  bf16* ks = dos + kDqM * kLd;               // [2][kDqN][kLd]
  bf16* vs = ks + 2 * kDqN * kLd;            // [2][kDqN][kLd]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n = h / (H / N);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kDqM;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(N) * D;
  const size_t q0 = static_cast<size_t>(b) * S * qstride +
                    static_cast<size_t>(h) * D;
  const size_t kv0 = static_cast<size_t>(b) * T * kstride +
                     static_cast<size_t>(n) * D;
  const bf16* kg = k + kv0;
  const bf16* vg = v + kv0;

  load_tile<bf16, kDqM, kLd>(qs, q + q0, qstride, m0, S, D);
  load_tile<bf16, kDqM, kLd>(dos, dout + q0, qstride, m0, S, D);
  cp_async_commit();
  const Segs sg = key_segments(m0, S, T, q_offset, causal, window, kDqM, kDqN);
  if (sg.a < sg.d) {
    load_tile<bf16, kDqN, kLd>(ks, kg, kstride, sg.a, T, D);
    load_tile<bf16, kDqN, kLd>(vs, vg, kstride, sg.a, T, D);
  }
  cp_async_commit();

  // The thread's rows: i = 2 mt + r is row wrow + 16 mt + gid + 8 r of
  // the block.
  constexpr int kR = 2 * kDqMt;
  const int wrow = warp * 16 * kDqMt;
  const int row0 = m0 + wrow + gid;
  float lse2[kR], dl[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = row0 + 16 * (i >> 1) + 8 * (i & 1);
    const size_t at = static_cast<size_t>(bh) * S + row;
    lse2[i] = row < S ? lse[at] * kLog2e : 0.f;
    dl[i] = row < S ? delta[at] : 0.f;
  }
  float dqa[kDqMt][kDp / 8][4] = {};
  const uint32_t qa = a_addr(qs, wrow, lane);
  const uint32_t doa = a_addr(dos, wrow, lane);
  int stage = 0;
  for (int n0 = sg.a; n0 < sg.d; n0 += kDqN, stage ^= 1) {
    if (n0 + kDqN < sg.d) {
      const int nx = (stage ^ 1) * kDqN * kLd;
      load_tile<bf16, kDqN, kLd>(ks + nx, kg, kstride, n0 + kDqN, T, D);
      load_tile<bf16, kDqN, kLd>(vs + nx, vg, kstride, n0 + kDqN, T, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // q, dO (first pass) and this key block are in place
    const bf16* kt = ks + stage * kDqN * kLd;
    const bf16* vt = vs + stage * kDqN * kLd;
    const bool masked = n0 < sg.b || n0 >= sg.c;
    float s[kDqMt][kDqN / 8][4] = {};
    float dp[kDqMt][kDqN / 8][4] = {};
    gemm_nt<kDqMt, kDqN>(s, qa, b_addr(kt, 0, lane));   // S = Q K^T
    gemm_nt<kDqMt, kDqN>(dp, doa, b_addr(vt, 0, lane));  // dP = dO V^T
#pragma unroll
    for (int mt = 0; mt < kDqMt; ++mt)
#pragma unroll
      for (int t = 0; t < kDqN / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * mt + (e >> 1);
          float p = ex2(s[mt][t][e] * scale_log2 - lse2[i]);
          if (masked && !keep(row0 + 16 * mt + (e >> 1) * 8,
                              n0 + t * 8 + tig * 2 + (e & 1), S, T, q_offset,
                              causal, window))
            p = 0.f;
          s[mt][t][e] = p * (dp[mt][t][e] - dl[i]);
        }
    gemm_pv<kDqMt, kDqN, kDp>(dqa, s, bt_addr(kt, 0, lane));  // dS K
    __syncthreads();  // this stage is free for the block after next
  }
  float scales[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) scales[i] = sm_scale;
  store_frags<kDqMt, kDp>(dq + q0, qstride, dqa, m0 + wrow, S, 0, D, scales);
}

// -- f32 kernels (IEEE f32 on the CUDA cores) ---------------------------------

// A lane's slice of a row: float4s l8, l8 + 8, ... (so that the eight
// lanes of a row read 128 consecutive bytes of a shared row at once).
__device__ __forceinline__ void load_row(float4* x, const float* row, int D,
                                         bool in) {
  const int l8 = threadIdx.x & (kLanes - 1);
#pragma unroll
  for (int i = 0; i < kChunksF; ++i) {
    const int c = (l8 + kLanes * i) * 4;
    x[i] = in && c < D ? *reinterpret_cast<const float4*>(row + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The dot product of a lane's slice x with row r of a [*][kDp] tile,
// summed over the row's eight lanes.
__device__ __forceinline__ float dot_row(const float4* x, const float* tile,
                                         int r) {
  const int l8 = threadIdx.x & (kLanes - 1);
  const float4* y = reinterpret_cast<const float4*>(tile + r * kDp) + l8;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChunksF; ++i) {
    const float4 w = y[kLanes * i];
    s = fmaf(x[i].x, w.x, s);
    s = fmaf(x[i].y, w.y, s);
    s = fmaf(x[i].z, w.z, s);
    s = fmaf(x[i].w, w.w, s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  return s;
}

// acc += p * row r of a [*][kDp] tile (the lane's slice).
__device__ __forceinline__ void axpy_row(float4* acc, float p,
                                         const float* tile, int r) {
  const int l8 = threadIdx.x & (kLanes - 1);
  const float4* y = reinterpret_cast<const float4*>(tile + r * kDp) + l8;
#pragma unroll
  for (int i = 0; i < kChunksF; ++i) {
    const float4 w = y[kLanes * i];
    acc[i].x = fmaf(p, w.x, acc[i].x);
    acc[i].y = fmaf(p, w.y, acc[i].y);
    acc[i].z = fmaf(p, w.z, acc[i].z);
    acc[i].w = fmaf(p, w.w, acc[i].w);
  }
}

__device__ __forceinline__ void store_row(float* row, const float4* x, int D,
                                          float scale) {
  const int l8 = threadIdx.x & (kLanes - 1);
#pragma unroll
  for (int i = 0; i < kChunksF; ++i) {
    const int c = (l8 + kLanes * i) * 4;
    if (c < D)
      *reinterpret_cast<float4*>(row + c) =
          make_float4(x[i].x * scale, x[i].y * scale, x[i].z * scale,
                      x[i].w * scale);
  }
}

// grid (B*H, ceil(S / kRowsF)); kFwdSmemF dynamic shared bytes.
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ o, float* __restrict__ lse,
                              int S, int T, int H, int N, int D, int q_offset,
                              int causal, int window, float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [kTileF][kDp]
  float* vs = ks + kTileF * kDp;               // [kTileF][kDp]
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n = h / (H / N);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kRowsF;
  const int row = m0 + threadIdx.x / kLanes;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(N) * D;
  const size_t q0 = static_cast<size_t>(b) * S * qstride +
                    static_cast<size_t>(h) * D;
  const size_t kv0 = static_cast<size_t>(b) * T * kstride +
                     static_cast<size_t>(n) * D;
  float4 qv[kChunksF], acc[kChunksF];
  load_row(qv, q + q0 + static_cast<size_t>(row) * qstride, D, row < S);
#pragma unroll
  for (int i = 0; i < kChunksF; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNeg, l = 0.f;
  const Segs sg =
      key_segments(m0, S, T, q_offset, causal, window, kRowsF, kTileF);
  for (int n0 = sg.a; n0 < sg.d; n0 += kTileF) {
    __syncthreads();  // the previous tile is read
    load_tile<float, kTileF, kDp>(ks, k + kv0, kstride, n0, T, D);
    load_tile<float, kTileF, kDp>(vs, v + kv0, kstride, n0, T, D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[kTileF];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      const float x = dot_row(qv, ks, j) * scale_log2;
      sc[j] = keep(row, n0 + j, S, T, q_offset, causal, window) ? x : kNeg;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kChunksF; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      const float p = exp2f(sc[j] - m);
      l += p;
      axpy_row(acc, p, vs, j);
    }
  }
  if (row < S) {
    store_row(o + q0 + static_cast<size_t>(row) * qstride, acc, D,
              l > 0.f ? 1.f / l : 0.f);
    if ((threadIdx.x & (kLanes - 1)) == 0)
      lse[static_cast<size_t>(bh) * S + row] = (m + log2f(l)) * kLn2;
  }
}

// grid (B*N, ceil(T / kRowsF)); kKvSmemF dynamic shared bytes.
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   float* __restrict__ dk,
                                   float* __restrict__ dv, int S, int T,
                                   int H, int N, int D, int q_offset,
                                   int causal, int window, float scale_log2,
                                   float sm_scale) {
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kTileF][kDp]
  float* dos = qs + kTileF * kDp;              // [kTileF][kDp]
  float* ls = dos + kTileF * kDp;              // [kTileF]
  float* dls = ls + kTileF;                    // [kTileF]
  const int bn = blockIdx.x;
  const int b = bn / N;
  const int n = bn - b * N;
  const int G = H / N;
  const int n0 = blockIdx.y * kRowsF;
  const int key = n0 + threadIdx.x / kLanes;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(N) * D;
  const size_t kv0 = static_cast<size_t>(b) * T * kstride +
                     static_cast<size_t>(n) * D;
  const size_t krow = kv0 + static_cast<size_t>(key) * kstride;
  float4 kv[kChunksF], vv[kChunksF], dka[kChunksF], dva[kChunksF];
  load_row(kv, k + krow, D, key < T);
  load_row(vv, v + krow, D, key < T);
#pragma unroll
  for (int i = 0; i < kChunksF; ++i)
    dka[i] = dva[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const Segs sg =
      query_segments(n0, S, T, q_offset, causal, window, kTileF, kRowsF);
  for (int g = 0; g < G; ++g) {
    const int h = n * G + g;
    const size_t q0 = static_cast<size_t>(b) * S * qstride +
                      static_cast<size_t>(h) * D;
    const size_t r0 = (static_cast<size_t>(b) * H + h) * S;
    for (int m0 = sg.a; m0 < sg.d; m0 += kTileF) {
      __syncthreads();  // the previous tile is read
      load_tile<float, kTileF, kDp>(qs, q + q0, qstride, m0, S, D);
      load_tile<float, kTileF, kDp>(dos, dout + q0, qstride, m0, S, D);
      cp_async_commit();
      for (int i = threadIdx.x; i < kTileF; i += kThreads) {
        const int row = m0 + i;
        ls[i] = row < S ? lse[r0 + row] * kLog2e : 0.f;
        dls[i] = row < S ? delta[r0 + row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kTileF; ++i) {
        const float s = dot_row(kv, qs, i);
        const float dp = dot_row(vv, dos, i);
        const float p =
            keep(m0 + i, key, S, T, q_offset, causal, window)
                ? exp2f(s * scale_log2 - ls[i])
                : 0.f;
        axpy_row(dva, p, dos, i);
        axpy_row(dka, p * (dp - dls[i]), qs, i);
      }
    }
  }
  if (key < T) {
    store_row(dk + krow, dka, D, sm_scale);
    store_row(dv + krow, dva, D, 1.f);
  }
}

// grid (B*H, ceil(S / kRowsF)); kDqSmemF dynamic shared bytes.
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_f32_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dq, int S, int T, int H,
                                 int N, int D, int q_offset, int causal,
                                 int window, float scale_log2,
                                 float sm_scale) {
  extern __shared__ __align__(16) char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [kTileF][kDp]
  float* vs = ks + kTileF * kDp;               // [kTileF][kDp]
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n = h / (H / N);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kRowsF;
  const int row = m0 + threadIdx.x / kLanes;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(N) * D;
  const size_t qrow = static_cast<size_t>(b) * S * qstride +
                      static_cast<size_t>(h) * D +
                      static_cast<size_t>(row) * qstride;
  const size_t kv0 = static_cast<size_t>(b) * T * kstride +
                     static_cast<size_t>(n) * D;
  float4 qv[kChunksF], dov[kChunksF], dqa[kChunksF];
  load_row(qv, q + qrow, D, row < S);
  load_row(dov, dout + qrow, D, row < S);
#pragma unroll
  for (int i = 0; i < kChunksF; ++i) dqa[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t at = static_cast<size_t>(bh) * S + row;
  const float lse2 = row < S ? lse[at] * kLog2e : 0.f;
  const float dl = row < S ? delta[at] : 0.f;
  const Segs sg =
      key_segments(m0, S, T, q_offset, causal, window, kRowsF, kTileF);
  for (int n0 = sg.a; n0 < sg.d; n0 += kTileF) {
    __syncthreads();  // the previous tile is read
    load_tile<float, kTileF, kDp>(ks, k + kv0, kstride, n0, T, D);
    load_tile<float, kTileF, kDp>(vs, v + kv0, kstride, n0, T, D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTileF; ++j) {
      const float s = dot_row(qv, ks, j);
      const float dp = dot_row(dov, vs, j);
      const float p = keep(row, n0 + j, S, T, q_offset, causal, window)
                          ? exp2f(s * scale_log2 - lse2)
                          : 0.f;
      axpy_row(dqa, p * (dp - dl), ks, j);
    }
  }
  if (row < S) store_row(dq + qrow, dqa, D, sm_scale);
}

// -- launches -------------------------------------------------------------------

// The dynamic shared memory Kernel has been allowed so far (above 48 KB
// it needs an opt-in; the first call of each kernel runs before any graph
// capture, eagerly).
template <auto Kernel>
int opted_bytes = 48 * 1024;

template <auto Kernel, typename... Args>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t stream,
                   Args... args) {
  if (smem > opted_bytes<Kernel>) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    opted_bytes<Kernel> = smem;
  }
  Kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

int blocks(int rows, int tile) { return (rows + tile - 1) / tile; }

}  // namespace

// The tiles this library runs (flash_attn.py::plan holds the same; a card
// test compares them): out[0] = FLASH_D_PAD, then for bf16 and then for
// f32 the forward's (query rows, key rows, shared bytes), the dK/dV
// kernel's (query rows, key rows, shared bytes) and the dQ kernel's.
extern "C" void flash_attn_plan(int* out) {
  const int plan[19] = {kDp,    kFwdM,  kFwdN,  kFwdSmem,  kKvM,
                        kKvN,   kKvSmem, kDqM,  kDqN,      kDqSmem,
                        kRowsF, kTileF, kFwdSmemF, kTileF, kRowsF,
                        kKvSmemF, kRowsF, kTileF, kDqSmemF};
  for (int i = 0; i < 19; ++i) out[i] = plan[i];
}

// q (B,S,H,D), k/v (B,T,N,D), o (B,S,H,D) of one dtype (f32 or bf16), lse
// (B,H,S) f32; contiguous, 16-byte aligned, on the current device.  D <=
// FLASH_D_PAD is a multiple of 16 bytes; H a multiple of N; window <= 0
// means none; every query row keeps at least one key (the wrapper checks).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int S, int T, int H, int N, int D,
                         int q_offset, int causal, int window, int is_bf16,
                         float scale_log2, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return launch<flash_attn_fwd_kernel>(
        dim3(B * H, blocks(S, kFwdM)), kThreads, kFwdSmem, st,
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), l, S, T, H, N, D,
        q_offset, causal, window, scale_log2);
  return launch<flash_attn_fwd_f32_kernel>(
      dim3(B * H, blocks(S, kRowsF)), kThreads, kFwdSmemF, st,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), l, S, T, H, N, D,
      q_offset, causal, window, scale_log2);
}

// The gradients of flash_fwd's O given dout (O's shape and dtype), from q,
// k, v, o and the lse it wrote: delta (B,H,S) f32 is scratch; dq, dk, dv
// take q's, k's and v's shapes.  Three launches on one stream: delta, dK/dV,
// dQ.  Returns the first CUDA error (0 on success).
extern "C" int flash_bwd(const void* dout, const void* q, const void* k,
                         const void* v, const void* o, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int B,
                         int S, int T, int H, int N, int D, int q_offset,
                         int causal, int window, int is_bf16, float scale_log2,
                         float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const long long rows = static_cast<long long>(B) * S * H;
  const dim3 delta_grid(static_cast<unsigned>((rows + 7) / 8));
  cudaError_t err;
  if (is_bf16) {
    using T_ = bf16;
    const T_* q_ = static_cast<const T_*>(q);
    const T_* k_ = static_cast<const T_*>(k);
    const T_* v_ = static_cast<const T_*>(v);
    const T_* do_ = static_cast<const T_*>(dout);
    err = launch<flash_attn_bwd_delta_kernel<T_>>(
        delta_grid, 256, 0, st, static_cast<const T_*>(o), do_, dl, S, H, D,
        rows);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch<flash_attn_bwd_dkdv_kernel>(
        dim3(B * N, blocks(T, kKvN)), kThreads, kKvSmem, st, q_, k_, v_, do_,
        l, static_cast<const float*>(dl), static_cast<T_*>(dk),
        static_cast<T_*>(dv), S, T, H, N, D, q_offset, causal, window,
        scale_log2, sm_scale);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch<flash_attn_bwd_dq_kernel>(
        dim3(B * H, blocks(S, kDqM)), kThreads, kDqSmem, st, q_, k_, v_, do_,
        l, static_cast<const float*>(dl), static_cast<T_*>(dq), S, T, H, N, D,
        q_offset, causal, window, scale_log2, sm_scale));
  }
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  err = launch<flash_attn_bwd_delta_kernel<float>>(
      delta_grid, 256, 0, st, static_cast<const float*>(o), do_, dl, S, H, D,
      rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch<flash_attn_bwd_dkdv_f32_kernel>(
      dim3(B * N, blocks(T, kRowsF)), kThreads, kKvSmemF, st, q_, k_, v_, do_,
      l, static_cast<const float*>(dl), static_cast<float*>(dk),
      static_cast<float*>(dv), S, T, H, N, D, q_offset, causal, window,
      scale_log2, sm_scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch<flash_attn_bwd_dq_f32_kernel>(
      dim3(B * H, blocks(S, kRowsF)), kThreads, kDqSmemF, st, q_, k_, v_, do_,
      l, static_cast<const float*>(dl), static_cast<float*>(dq), S, T, H, N, D,
      q_offset, causal, window, scale_log2, sm_scale));
}
