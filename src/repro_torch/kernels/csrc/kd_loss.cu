// Fused buffered-KD loss for Hopper (sm_90a): forward statistics and the
// student gradient, plain C interface.
//
// Replaces the TPU kernels src/repro/kernels/kd_loss.py::kd_stats_fwd
// (bodies _fwd_kernel/_fwd_body/_online_update), ::kd_grad_bwd
// (_bwd_kernel/_bwd_body), ::kd_quant_stats_fwd (_quant_fwd_kernel/
// _dequant_tile) and ::kd_quant_grad_bwd (_quant_bwd_kernel).  For rows of student logits s, teacher logits t
// and (optionally) buffer logits b over a vocabulary of V, the forward
// computes in one pass, without materialising any softmax, the 11 stats of
// a row
//
//   [lse_s, s_y, lse_st, lse_tt, E_t[t/tau], E_t[s/tau],
//    lse_bt, E_b[b/tau], E_b[s/tau], 0, 0]
//
// (lse of s, s/tau, t/tau, b/tau; E_t and E_b weight by softmax(t/tau) and
// softmax(b/tau)); the loss CE + tau^2 KL(t||s) [+ tau^2 KL(b||s)] is
// assembled from them in PyTorch.  The backward writes
//
//   ds = g*mean_scale*[softmax(s) - onehot(y) + tau*(softmax(s/tau) -
//        softmax(t/tau)) (+ tau*(softmax(s/tau) - softmax(b/tau)))]
//
// in s's dtype.  Math is f32 for f32 and bf16 inputs, with the accurate
// expf/logf (the library is built without --use_fast_math); labels are
// int64.
//
// Bound on an H100: bytes.  Per logit the forward does four exponentials
// and a few multiply-adds against 4 (or 2) bytes read per tensor, about 10
// operations a byte, under the card's f32 balance of ~20; the backward is
// the same.  The least time is the logits read once (and ds written once)
// over 3.35 TB/s.  The quant pair reads 1 byte of teacher per logit and
// adds one FMA, so it is more bytes-bound still, with a lower bound.  In
// bf16 the forward also nears the issue rate: ~56 SASS instructions a logit
// (four accurate expf of ~9 each) put its issue floor near the bytes bound.
//
// Forward design.  The TPU grid (row blocks, vocab tiles) runs its vocab
// axis in order and carries the online (max, denominator, numerators)
// state in VMEM scratch from tile to tile.  Here each thread carries that
// state in registers over tiles of its own columns and the threads of a
// row merge at the end.  A tile is updated as the TPU's _online_update
// does (push_tile): the tile's max first, one rescale of the running sums
// (none on a fresh state), then exp(x - m) and the weighted numerators
// summed over the tile without a branch: four expf a logit with a buffer,
// three without, plus four a tile, and no divergence.  The streams s and
// s/tau share one max, and b/tau takes the max of raw b: for tau > 0,
// max(x / tau) = max(x) / tau exactly, rounding being monotone (the
// wrapper rejects tau <= 0); their exponents are one FMA, exp(fma(x, 1/tau,
// -m)), and the numerators weighted by s/tau and b/tau are summed with raw
// s and b and scaled by 1/tau once (write_stats).  Slots past the row's end
// hold 0 and are skipped by a select, never given -1e30: a row's real
// -1e30 pad columns count as the plain version counts them (a row of
// nothing but pad has d = V).  Maxes start at -1e30 as on the TPU.  A merge
// (warp_merge) takes the max of each stream across the warp in one
// redux.sync (floats mapped onto ordered ints), rescales each lane's sums
// once to it, then adds the sums by xor shuffles; a + b == b + a, so every
// lane ends with the same state.
// Two paths, chosen by the wrapper's plan (kernels/kd_loss.py::plan) from
// the shapes alone, never the values, so a CUDA graph replays the wrapper;
// the plan names the path and the lane's tile, this file checks them and
// refuses a pair it cannot run:
//
// - warp path (V <= WARP_MAX_V = 1,024): one warp a row, kWarpRows = 4 rows
//   a block.
//   Lane l holds columns c0 + l + 32 k, k < K (K the least power of two >=
//   V / 32, at most 8): every warp-wide load reads 32 neighbouring elements
//   whatever the row's alignment, and the next pass's loads are issued
//   before the current pass is reduced.  No shared memory, no barrier.  On
//   a single pass s[y] comes from lane y % 32's registers, else lane 0
//   loads it while the columns are in flight; lane 0 writes the stats.
// - block path (V > WARP_MAX_V): one block of eight warps a row.  Warp w
//   streams chunks w, w + 8, ... of 512 columns (a tile of 16 a lane)
//   through its own ring of kStages = 2 stages in shared memory (the bytes
//   are this file's, ring_bytes), filled with 16-byte
//   cp.async copies while the other stage is reduced; no barrier until the
//   warps merge, then warp 0 merges the eight states.  Each tensor has its
//   own alignment (at V = 49,155 no row of any dtype starts on 16 bytes; at
//   V = 100 f32 rows do, bf16 rows are 8-byte and code rows 4-byte
//   aligned), so each is copied over its own aligned span (Span::stage)
//   and column c lands at the span's skew + c * itemsize; lanes then read
//   their columns from shared memory at any offset, neighbouring lanes on
//   neighbouring elements, free of bank conflicts.  Never a byte outside
//   the tensor is read: the 16-byte word that crosses the tensor's end is
//   copied with cp.async's zero fill, the word that crosses its start (a
//   view with a storage offset) byte by byte.
//
// The choices (f32 with a buffer, device ms from a CUDA graph; NVIDIA H100
// 80GB HBM3, 700.00 W).  The threshold, from chip_smoke.py's path sweep
// (phase 5): the warp path takes V = 1,024 at 512 rows in 0.00474 against
// the block path's 0.00818 and loses little at 128 rows (0.00456 against
// 0.00439); at V = 2,048 the block path wins at 128 rows (0.00453 against
// 0.00692).  The constants, from sweeps an earlier chip_smoke.py ran while
// they were run-time arguments: two stages beat three and four at 512 x
// 49,155 (0.1117, 0.1165, 0.1229; bf16 0.0827, 0.0847, 0.0861), and four
// rows a warp-path block beat 1, 2 and 8 at the FL main path's 128 x 100
// (0.00279 against 0.00287, 0.00281, 0.00303).  The tile of 16 (128
// registers, two blocks an SM) and a chunk's lean staging (one bounds
// check a chunk) came from variants tried on the card whose script is not
// kept.
//
// The backward is elementwise: a 2-D grid of (row, 1024-column chunk)
// blocks whose threads read the row's stats once and write four columns
// each.  Any V is taken; pad columns of -1e30 contribute exactly zero.
//
// The quant pair takes the teacher as a transport payload: int8 codes
// (rows, V) and a per-row f32 affine, t = code * scale[row] + zero[row].
// As on the TPU, the exact and quant kernels share their tile math and
// differ only in the teacher reader: ExactTeacher loads T, QuantTeacher
// loads one int8 code and dequantizes it in registers (scale and zero are
// read once per row), so the f32 teacher never exists in device memory and
// the teacher costs 1 byte per logit instead of 4 (or 2).  The dequant is
// written as fmaf(code, scale, zero): one rounding, where the plain version
// rounds the product and the sum; the difference is in the last bit of t.
// The forward folds 1/tau into the affine (over_tau).  The TPU kernel pads
// codes to its 128-lane tile and masks the pad columns by index; these
// kernels read exactly V columns, so there is nothing to mask.
//
// Not done yet (later work): the backward's launch shape (a 256-thread
// block a 1,024-column chunk, scalar loads) leaves most of a block idle at
// the FL main path's V = 100; several rows a block and staged 16-byte
// loads would serve it as they serve the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kStats = 11;
constexpr int kThreads = 256;  // backward
constexpr int kUnroll = 4;     // backward: columns a thread
constexpr int kBlockThreads = 256;  // forward block path
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kTile = 16;      // forward block path: columns a lane a chunk
constexpr int kChunk = 32 * kTile;  // a warp's chunk of the row
constexpr int kWarpRows = 4;   // forward warp path: rows (warps) a block
constexpr int kStages = 2;     // forward block path: chunks in a warp's ring

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename E>
__device__ __forceinline__ E zero_of() { return E(0); }
// An int8 code in f32, exactly, without the quarter-rate I2F: adding a
// small integer to the bits of 1.5 * 2^23 adds it to the float.
__device__ __forceinline__ float code_to_f32(int8_t x) {
  return __int_as_float(0x4B400000 + static_cast<int>(x)) - 12582912.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Teacher readers: row(r, V) gives the row's reader; of(x) turns a stored
// element (Elem) into the teacher's logit in f32 and Row()(c) reads column
// c of the row; data() is the stored tensor, which the forward stages.
template <typename T>
struct ExactTeacher {
  using Elem = T;
  const T* __restrict__ t;

  struct Row {
    const T* __restrict__ p;
    __device__ __forceinline__ float of(T x) const { return to_f32(x); }
    __device__ __forceinline__ float operator()(int c) const {
      return of(p[c]);
    }
    // t / tau, as the forward uses it.
    __device__ __forceinline__ float over_tau(T x, float inv_tau) const {
      return of(x) * inv_tau;
    }
  };
  __device__ __forceinline__ Row row(int r, int V) const {
    return Row{t + static_cast<int64_t>(r) * V};
  }
  __device__ __forceinline__ const T* data() const { return t; }
};

struct QuantTeacher {
  using Elem = int8_t;
  const int8_t* __restrict__ codes;
  const float* __restrict__ scale;
  const float* __restrict__ zero;

  struct Row {
    const int8_t* __restrict__ p;
    float scale, zero;
    __device__ __forceinline__ float of(int8_t x) const {
      return fmaf(code_to_f32(x), scale, zero);
    }
    __device__ __forceinline__ float operator()(int c) const {
      return of(p[c]);
    }
    // t / tau with 1 / tau folded into the affine (exact for tau a power
    // of two; otherwise within an ulp of of(x) * inv_tau).
    __device__ __forceinline__ float over_tau(int8_t x, float inv_tau) const {
      return fmaf(code_to_f32(x), scale * inv_tau, zero * inv_tau);
    }
  };
  __device__ __forceinline__ Row row(int r, int V) const {
    return Row{codes + static_cast<int64_t>(r) * V, scale[r], zero[r]};
  }
  __device__ __forceinline__ const int8_t* data() const { return codes; }
};

// -- forward: tile math and merge -------------------------------------------

// The running state of a thread (merged: of a row).  s and s/tau share
// their max: m_st = ms * inv_tau.  t/tau carries its denominator and the
// numerators weighted by t/tau (nt0) and by s (nt1); b/tau carries those
// weighted by b (nb0) and s (nb1).  Weights of raw s and b save a multiply
// a logit; write_stats scales those numerators by 1/tau once.
struct RowState {
  float ms, ds, dst;
  float mt, dt, nt0, nt1;
  float mb, db, nb0, nb1;

  __device__ __forceinline__ void init() {
    ms = mt = mb = kNeg;
    ds = dst = dt = nt0 = nt1 = db = nb0 = nb1 = 0.f;
  }
};

// One tile of K columns: xs, tt, xb hold s, t / tau and b in f32 (0 in
// slots past the row's end); with kCheck, in[k] says which slots hold
// columns and the others are skipped by a select.  The maxes of s/tau and
// b/tau are those of s and b times 1/tau (exact for tau > 0), and their
// exponents are one FMA: exp(fma(x, 1/tau, -m)).  kFresh: the state is
// init()'s, so the rescale (of sums that are 0) is skipped.
template <int K, bool kBuffer, bool kCheck, bool kFresh = false>
__device__ __forceinline__ void push_tile(RowState& a, const float (&xs)[K],
                                          const float (&tt)[K],
                                          const float (&xb)[K],
                                          const bool (&in)[K],
                                          float inv_tau) {
  float ms = a.ms, mt = a.mt, mb = kNeg;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool ok = !kCheck || in[k];
    ms = ok ? fmaxf(ms, xs[k]) : ms;
    mt = ok ? fmaxf(mt, tt[k]) : mt;
    if (kBuffer) mb = ok ? fmaxf(mb, xb[k]) : mb;
  }
  mb = fmaxf(a.mb, mb * inv_tau);
  const float mst = ms * inv_tau;
  const float cs = kFresh ? 0.f : expf(a.ms - ms);
  const float cst = kFresh ? 0.f : expf(a.ms * inv_tau - mst);
  const float ct = kFresh ? 0.f : expf(a.mt - mt);
  float es = 0.f, est = 0.f, et = 0.f, et0 = 0.f, et1 = 0.f;
  float eb = 0.f, eb0 = 0.f, eb1 = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool ok = !kCheck || in[k];
    const float e_s = expf(xs[k] - ms);
    const float e_st = expf(fmaf(xs[k], inv_tau, -mst));
    const float e_t = expf(tt[k] - mt);
    const float u_s = ok ? e_s : 0.f, u_st = ok ? e_st : 0.f;
    const float u_t = ok ? e_t : 0.f;
    es += u_s;
    est += u_st;
    et += u_t;
    et0 += u_t * tt[k];
    et1 += u_t * xs[k];
    if (kBuffer) {
      const float e_b = expf(fmaf(xb[k], inv_tau, -mb));
      const float u_b = ok ? e_b : 0.f;
      eb += u_b;
      eb0 += u_b * xb[k];
      eb1 += u_b * xs[k];
    }
  }
  a.ds = a.ds * cs + es;
  a.dst = a.dst * cst + est;
  a.dt = a.dt * ct + et;
  a.nt0 = a.nt0 * ct + et0;
  a.nt1 = a.nt1 * ct + et1;
  a.ms = ms;
  a.mt = mt;
  if (kBuffer) {
    const float cb = kFresh ? 0.f : expf(a.mb - mb);
    a.db = a.db * cb + eb;
    a.nb0 = a.nb0 * cb + eb0;
    a.nb1 = a.nb1 * cb + eb1;
    a.mb = mb;
  }
}

// The warp's largest x in one redux.sync: floats in an order-keeping map
// onto ints (negatives' magnitude bits flipped), which is its own inverse.
__device__ __forceinline__ float warp_max(float x) {
  const int i = __float_as_int(x);
  const int m = __reduce_max_sync(0xffffffffu, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

// Merges the states of each group of `width` lanes (a power of two <= 32):
// the maxes over the warp (lanes outside the groups hold init()'s state,
// so the groups' maxes are the warp's), one rescale of the lane's sums to
// them, then the sums by xor shuffles.  All 32 lanes must call it.
template <bool kBuffer>
__device__ __forceinline__ void warp_merge(RowState& a, float inv_tau,
                                           int width) {
  constexpr unsigned kAll = 0xffffffffu;
  const float ms = warp_max(a.ms), mt = warp_max(a.mt);
  const float mb = kBuffer ? warp_max(a.mb) : a.mb;
  const float cs = expf(a.ms - ms);
  const float cst = expf(a.ms * inv_tau - ms * inv_tau);
  const float ct = expf(a.mt - mt);
  a.ds *= cs;
  a.dst *= cst;
  a.dt *= ct;
  a.nt0 *= ct;
  a.nt1 *= ct;
  a.ms = ms;
  a.mt = mt;
  if (kBuffer) {
    const float cb = expf(a.mb - mb);
    a.db *= cb;
    a.nb0 *= cb;
    a.nb1 *= cb;
    a.mb = mb;
  }
  for (int off = width / 2; off > 0; off >>= 1) {
    a.ds += __shfl_xor_sync(kAll, a.ds, off);
    a.dst += __shfl_xor_sync(kAll, a.dst, off);
    a.dt += __shfl_xor_sync(kAll, a.dt, off);
    a.nt0 += __shfl_xor_sync(kAll, a.nt0, off);
    a.nt1 += __shfl_xor_sync(kAll, a.nt1, off);
    if (kBuffer) {
      a.db += __shfl_xor_sync(kAll, a.db, off);
      a.nb0 += __shfl_xor_sync(kAll, a.nb0, off);
      a.nb1 += __shfl_xor_sync(kAll, a.nb1, off);
    }
  }
}

template <bool kBuffer>
__device__ __forceinline__ void write_stats(float* out, const RowState& a,
                                            float sy, float inv_tau) {
  out[0] = logf(a.ds) + a.ms;
  out[1] = sy;
  out[2] = logf(a.dst) + a.ms * inv_tau;
  out[3] = logf(a.dt) + a.mt;
  out[4] = a.nt0 / a.dt;
  out[5] = a.nt1 * inv_tau / a.dt;
  out[6] = kBuffer ? logf(a.db) + a.mb : 0.f;
  out[7] = kBuffer ? a.nb0 * inv_tau / a.db : 0.f;
  out[8] = kBuffer ? a.nb1 * inv_tau / a.db : 0.f;
  out[9] = 0.f;
  out[10] = 0.f;
}

// -- forward, warp path: one warp a row --------------------------------------

// Lane-strided columns c + 32 k of a pass, as stored (0 past the row).
template <typename T, typename E, int K, bool kBuffer>
struct Pass {
  T s[K], b[K];
  E t[K];

  __device__ __forceinline__ void load(const T* __restrict__ sr,
                                       const E* __restrict__ tp,
                                       const T* __restrict__ br, int c,
                                       int V) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int col = c + 32 * k;
      const bool in = col < V;
      s[k] = in ? sr[col] : zero_of<T>();
      t[k] = in ? tp[col] : zero_of<E>();
      if (kBuffer) b[k] = in ? br[col] : zero_of<T>();
    }
  }
};

// grid ceil(rows / kWarpRows), block 32 kWarpRows: warp w of block x takes
// row x kWarpRows + w.
template <typename T, typename Teacher, bool kBuffer, int K>
__global__ void __launch_bounds__(kWarpRows * 32)
    kd_stats_warp_kernel(const int64_t* __restrict__ labels,
                         const T* __restrict__ s, const Teacher teacher,
                         const T* __restrict__ b, float* __restrict__ stats,
                         int rows, int V, float inv_tau) {
  using E = typename Teacher::Elem;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = static_cast<int64_t>(row) * V;
  const T* sr = s + base;
  const T* br = kBuffer ? b + base : nullptr;
  const int64_t y = labels[row];
  const bool hit = y >= 0 && y < V;
  const auto tr = teacher.row(row, V);

  Pass<T, E, K, kBuffer> cur;
  cur.load(sr, tr.p, br, lane, V);
  // s[y]: on a single pass it is in lane y % 32's registers (slot y / 32);
  // else lane 0 loads it while the columns are in flight.
  float sy = 0.f;
  if (V > 32 * K && lane == 0 && hit) sy = to_f32(sr[y]);

  RowState a;
  a.init();
  for (int c0 = 0; c0 < V; c0 += 32 * K) {
    const bool more = c0 + 32 * K < V;
    Pass<T, E, K, kBuffer> nxt;
    if (more) nxt.load(sr, tr.p, br, c0 + 32 * K + lane, V);
    float xs[K], tt[K], xb[K];
    bool in[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      in[k] = c0 + lane + 32 * k < V;
      xs[k] = in[k] ? to_f32(cur.s[k]) : 0.f;
      tt[k] = in[k] ? tr.over_tau(cur.t[k], inv_tau) : 0.f;
      xb[k] = kBuffer && in[k] ? to_f32(cur.b[k]) : 0.f;
    }
    if (c0 == 0) {
      push_tile<K, kBuffer, true, true>(a, xs, tt, xb, in, inv_tau);
    } else {
      push_tile<K, kBuffer, true>(a, xs, tt, xb, in, inv_tau);
    }
    if (more) cur = nxt;
  }
  if (V <= 32 * K) {
    float mine = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      mine = k == static_cast<int>(y >> 5) ? to_f32(cur.s[k]) : mine;
    mine = __shfl_sync(0xffffffffu, mine, static_cast<int>(y & 31));
    sy = hit ? mine : 0.f;
  }
  warp_merge<kBuffer>(a, inv_tau, 32);
  if (lane == 0)
    write_stats<kBuffer>(stats + static_cast<int64_t>(row) * kStats, a, sy,
                         inv_tau);
}

// -- forward, block path: one block a row, staged through shared memory -----

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
// Copies the first `bytes` (< 16) bytes at src and zero-fills the rest.
__device__ __forceinline__ void cp_async16_part(void* dst, uintptr_t src,
                                                int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared bytes a tensor's chunk takes in a stage: kChunk columns and the
// 16 bytes of its skew.
__host__ __device__ constexpr int region_bytes(int itemsize) {
  return kChunk * itemsize + 16;
}
// A stage of a warp's ring: a chunk of s, the teacher and (with a buffer) b.
__host__ __device__ constexpr int stage_bytes(int itemsize,
                                              int teacher_itemsize,
                                              bool buffer) {
  return region_bytes(itemsize) * (buffer ? 2 : 1) +
         region_bytes(teacher_itemsize);
}
// A block's dynamic shared memory: every warp's ring.
__host__ __device__ constexpr int ring_bytes(int itemsize,
                                             int teacher_itemsize,
                                             bool buffer) {
  return kBlockWarps * kStages * stage_bytes(itemsize, teacher_itemsize,
                                             buffer);
}

// One tensor's row as the block path stages it.
struct Span {
  uintptr_t beg, end;  // the tensor's bytes [beg, end)
  uintptr_t row;       // the row's first byte
  int isz;             // bytes an element
  int off;             // the tensor's region in a stage

  // Copies columns [c0, c0 + n) of the row into the stage, the warp's 32
  // lanes together: word j of the region receives the 16-byte word at
  // floor16(lo) + 16 j (lo the first column's byte), so column c0 + i
  // lands at skew() + i * isz.
  __device__ __forceinline__ void stage(unsigned char* st, int c0, int n,
                                        int lane) const {
    const uintptr_t lo = row + static_cast<uintptr_t>(c0) * isz;
    const uintptr_t a0 = lo & ~static_cast<uintptr_t>(15);
    const int words =
        static_cast<int>((lo + static_cast<uintptr_t>(n) * isz - a0 + 15) >> 4);
    unsigned char* dst = st + off;
    if (a0 >= beg && a0 + 16 * static_cast<uintptr_t>(words) <= end) {
      for (int j = lane; j < words; j += 32)  // inside the tensor
        cp_async16(dst + 16 * j, a0 + 16 * static_cast<uintptr_t>(j));
      return;
    }
    for (int j = lane; j < words; j += 32) {
      const uintptr_t w = a0 + 16 * static_cast<uintptr_t>(j);
      if (w >= beg && w + 16 <= end) {
        cp_async16(dst + 16 * j, w);
      } else if (w >= beg) {  // crosses the tensor's end
        cp_async16_part(dst + 16 * j, w, static_cast<int>(end - w));
      } else {  // crosses the tensor's start
        for (uintptr_t p = beg; p < w + 16 && p < end; ++p)
          dst[16 * j + (p - w)] = *reinterpret_cast<const unsigned char*>(p);
      }
    }
  }
  __device__ __forceinline__ int skew() const {
    return static_cast<int>(row & 15);
  }
  template <typename E>
  __device__ __forceinline__ E at(const unsigned char* st, int i) const {
    return *reinterpret_cast<const E*>(st + off + skew() + i * isz);
  }
};

template <typename X>
__device__ __forceinline__ Span span_of(const X* p, int64_t base,
                                        size_t total, int off) {
  const uintptr_t beg = reinterpret_cast<uintptr_t>(p);
  return Span{beg, beg + total * sizeof(X), beg + base * sizeof(X),
              static_cast<int>(sizeof(X)), off};
}

// Lane l's tile of a staged chunk: columns c0 + l + 32 j.
template <typename T, typename E, bool kBuffer, bool kCheck, typename Row>
__device__ __forceinline__ void push_chunk(RowState& a, const unsigned char* st,
                                           const Span& ss, const Span& ts,
                                           const Span& bs, const Row& tr,
                                           int c0, int V, int lane,
                                           float inv_tau) {
  float xs[kTile], tt[kTile], xb[kTile];
  bool in[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int i = lane + 32 * j;
    in[j] = !kCheck || c0 + i < V;
    xs[j] = in[j] ? to_f32(ss.at<T>(st, i)) : 0.f;
    tt[j] = in[j] ? tr.over_tau(ts.at<E>(st, i), inv_tau) : 0.f;
    xb[j] = kBuffer && in[j] ? to_f32(bs.at<T>(st, i)) : 0.f;
  }
  push_tile<kTile, kBuffer, kCheck>(a, xs, tt, xb, in, inv_tau);
}

// grid rows, block 256; dynamic shared memory ring_bytes(...): a ring of
// kStages stages for each warp.  Warp w streams chunks w, w + 8, w + 16,
// ... of the row through its own ring: no barrier until the warps merge.
template <typename T, typename Teacher, bool kBuffer>
__global__ void __launch_bounds__(kBlockThreads)
    kd_stats_block_kernel(const int64_t* __restrict__ labels,
                          const T* __restrict__ s, const Teacher teacher,
                          const T* __restrict__ b, float* __restrict__ stats,
                          int rows, int V, float inv_tau) {
  using E = typename Teacher::Elem;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ RowState part[kBlockWarps];
  const int tid = threadIdx.x, row = blockIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t base = static_cast<int64_t>(row) * V;
  const size_t total = static_cast<size_t>(rows) * V;
  const int64_t y = tid == 0 ? labels[row] : -1;
  const auto tr = teacher.row(row, V);
  const Span ss = span_of(s, base, total, 0);
  const Span ts = span_of(teacher.data(), base, total,
                          region_bytes(sizeof(T)));
  const Span bs = kBuffer ? span_of(b, base, total,
                                    region_bytes(sizeof(T)) +
                                        region_bytes(sizeof(E)))
                          : ss;
  constexpr int stride = stage_bytes(sizeof(T), sizeof(E), kBuffer);
  unsigned char* own = ring + warp * kStages * stride;
  const int chunks = (V + kChunk - 1) / kChunk;
  const int mine = chunks > warp ? (chunks - warp - 1) / kBlockWarps + 1 : 0;

  // The warp's i-th chunk (chunk warp + 8 i of the row) into stage `slot`,
  // one commit group a chunk (empty past the last, so the count of groups
  // stays uniform).
  auto issue = [&](int i, int slot) {
    if (i < mine) {
      unsigned char* st = own + slot * stride;
      const int c0 = (warp + kBlockWarps * i) * kChunk;
      const int n = min(kChunk, V - c0);
      ss.stage(st, c0, n, lane);
      ts.stage(st, c0, n, lane);
      if (kBuffer) bs.stage(st, c0, n, lane);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i, i);
  float sy = 0.f;
  if (tid == 0 && y >= 0 && y < V) sy = to_f32(s[base + y]);

  RowState a;
  a.init();
  int slot = 0;  // the stage of chunk i; chunk i + kStages - 1 goes to the
                 // one before it, read last iteration
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();  // this lane's copies of chunk i landed
    __syncwarp();                  // every lane's; chunk i - 1 is read
    issue(i + kStages - 1, slot == 0 ? kStages - 1 : slot - 1);
    const unsigned char* st = own + slot * stride;
    const int c0 = (warp + kBlockWarps * i) * kChunk;
    if (c0 + kChunk <= V) {
      push_chunk<T, E, kBuffer, false>(a, st, ss, ts, bs, tr, c0, V, lane,
                                       inv_tau);
    } else {
      push_chunk<T, E, kBuffer, true>(a, st, ss, ts, bs, tr, c0, V, lane,
                                      inv_tau);
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();  // nothing left in flight at exit

  warp_merge<kBuffer>(a, inv_tau, 32);
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (warp != 0) return;
  if (lane < kBlockWarps) {
    a = part[lane];
  } else {
    a.init();
  }
  warp_merge<kBuffer>(a, inv_tau, kBlockWarps);
  if (lane == 0)
    write_stats<kBuffer>(stats + static_cast<int64_t>(row) * kStats, a, sy,
                         inv_tau);
}

// The forward's path, as kernels/kd_loss.py::plan gives it.
enum Path { kWarpPath = 0, kBlockPath = 1 };

// Raises a block kernel's dynamic shared-memory limit once an instance
// (the first call of each plan runs eagerly, before any graph capture).
template <typename K>
cudaError_t opt_in(K kernel, int bytes, int* opted) {
  if (bytes <= *opted || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  *opted = bytes;
  return cudaSuccess;
}

template <typename T, typename Teacher, bool kBuffer>
int launch_fwd_plan(const int64_t* y, const T* s, const Teacher& teacher,
                    const T* b, float* out, int rows, int V, float inv_tau,
                    int path, int tile, cudaStream_t st) {
  if (path == kWarpPath) {
    const int grid = (rows + kWarpRows - 1) / kWarpRows;
    const int block = 32 * kWarpRows;
    switch (tile) {
      case 1:
        kd_stats_warp_kernel<T, Teacher, kBuffer, 1>
            <<<grid, block, 0, st>>>(y, s, teacher, b, out, rows, V, inv_tau);
        break;
      case 2:
        kd_stats_warp_kernel<T, Teacher, kBuffer, 2>
            <<<grid, block, 0, st>>>(y, s, teacher, b, out, rows, V, inv_tau);
        break;
      case 4:
        kd_stats_warp_kernel<T, Teacher, kBuffer, 4>
            <<<grid, block, 0, st>>>(y, s, teacher, b, out, rows, V, inv_tau);
        break;
      case 8:
        kd_stats_warp_kernel<T, Teacher, kBuffer, 8>
            <<<grid, block, 0, st>>>(y, s, teacher, b, out, rows, V, inv_tau);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  using E = typename Teacher::Elem;
  if (path != kBlockPath || tile != kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = ring_bytes(sizeof(T), sizeof(E), kBuffer);
  static int opted = 0;
  const auto kernel = kd_stats_block_kernel<T, Teacher, kBuffer>;
  const cudaError_t err = opt_in(kernel, smem, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows, kBlockThreads, smem, st>>>(y, s, teacher, b, out, rows, V,
                                            inv_tau);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Teacher>
int launch_fwd(const void* labels, const void* s, const Teacher& teacher,
               const void* b, void* stats, int rows, int V, float inv_tau,
               int path, int tile, cudaStream_t st) {
  const auto* y = static_cast<const int64_t*>(labels);
  const auto* sp = static_cast<const T*>(s);
  const auto* bp = static_cast<const T*>(b);
  auto* out = static_cast<float*>(stats);
  return b != nullptr
             ? launch_fwd_plan<T, Teacher, true>(y, sp, teacher, bp, out, rows,
                                                 V, inv_tau, path, tile, st)
             : launch_fwd_plan<T, Teacher, false>(y, sp, teacher, bp, out,
                                                  rows, V, inv_tau, path, tile,
                                                  st);
}

// -- backward ---------------------------------------------------------------

template <typename T, typename Teacher, bool kBuffer>
__global__ void __launch_bounds__(kThreads)
    kd_grad_kernel(const int64_t* __restrict__ labels,
                   const float* __restrict__ g,
                   const float* __restrict__ stats, const T* __restrict__ s,
                   const Teacher teacher, const T* __restrict__ b,
                   T* __restrict__ ds, int V, float tau, float inv_tau,
                   float mean_scale) {
  const int row = blockIdx.x;
  const float* st = stats + static_cast<int64_t>(row) * kStats;
  const float lse_s = st[0], lse_st = st[2], lse_tt = st[3];
  const float lse_bt = kBuffer ? st[6] : 0.f;
  const float gs = g[row] * mean_scale;
  const int64_t y = labels[row];
  const int64_t base = static_cast<int64_t>(row) * V;
  const auto tr = teacher.row(row, V);
  const int c0 = blockIdx.y * kThreads * kUnroll + threadIdx.x;
  float xs[kUnroll], xt[kUnroll], xb[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int c = c0 + k * kThreads;
    const bool in = c < V;
    xs[k] = in ? to_f32(s[base + c]) : 0.f;
    xt[k] = in ? tr(c) : 0.f;
    if (kBuffer) xb[k] = in ? to_f32(b[base + c]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int c = c0 + k * kThreads;
    if (c >= V) break;
    const float p_s = expf(xs[k] - lse_s);
    const float p_st = expf(xs[k] * inv_tau - lse_st);
    const float p_tt = expf(xt[k] * inv_tau - lse_tt);
    float d = p_s - (c == y ? 1.f : 0.f) + tau * (p_st - p_tt);
    if (kBuffer) d = d + tau * (p_st - expf(xb[k] * inv_tau - lse_bt));
    ds[base + c] = from_f32<T>(gs * d);
  }
}

template <typename T, typename Teacher>
int launch_bwd(const void* labels, const void* g, const void* stats,
               const void* s, const Teacher& teacher, const void* b, void* ds,
               int rows, int V, float tau, float inv_tau, float mean_scale,
               cudaStream_t st) {
  const dim3 grid(rows, (V + kThreads * kUnroll - 1) / (kThreads * kUnroll));
  const auto* y = static_cast<const int64_t*>(labels);
  const auto* gp = static_cast<const float*>(g);
  const auto* sp = static_cast<const float*>(stats);
  const auto* lp = static_cast<const T*>(s);
  const auto* bp = static_cast<const T*>(b);
  auto* out = static_cast<T*>(ds);
  if (b != nullptr) {
    kd_grad_kernel<T, Teacher, true><<<grid, kThreads, 0, st>>>(
        y, gp, sp, lp, teacher, bp, out, V, tau, inv_tau, mean_scale);
  } else {
    kd_grad_kernel<T, Teacher, false><<<grid, kThreads, 0, st>>>(
        y, gp, sp, lp, teacher, bp, out, V, tau, inv_tau, mean_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

QuantTeacher quant_teacher(const void* codes, const void* scale,
                           const void* zero) {
  return QuantTeacher{static_cast<const int8_t*>(codes),
                      static_cast<const float*>(scale),
                      static_cast<const float*>(zero)};
}

}  // namespace

// labels (rows,) int64; s, t and b (rows, V) of one dtype (f32 or bf16),
// b null for plain KD; stats (rows, 11) f32; all contiguous on the current
// device, 1 <= V and rows <= 2^31 - 1, inv_tau > 0 (the wrapper checks).
// path and tile are kernels/kd_loss.py::plan's (path 0: a warp a row, tile
// 1, 2, 4 or 8 columns a lane a pass; path 1: a block a row, tile kTile =
// 16); a pair this file cannot run returns cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
extern "C" int kd_stats_fwd(const void* labels, const void* s, const void* t,
                            const void* b, void* stats, int rows, int V,
                            float inv_tau, int is_bf16, int path, int tile,
                            void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_fwd<__nv_bfloat16>(
                   labels, s,
                   ExactTeacher<__nv_bfloat16>{
                       static_cast<const __nv_bfloat16*>(t)},
                   b, stats, rows, V, inv_tau, path, tile, st)
             : launch_fwd<float>(
                   labels, s, ExactTeacher<float>{static_cast<const float*>(t)},
                   b, stats, rows, V, inv_tau, path, tile, st);
}

// As kd_stats_fwd, plus g (rows,) f32 and the forward's stats; ds (rows, V)
// of s's dtype.  Needs ceil(V / 1024) <= 65535 (the wrapper checks).
extern "C" int kd_grad_bwd(const void* labels, const void* g,
                           const void* stats, const void* s, const void* t,
                           const void* b, void* ds, int rows, int V, float tau,
                           float inv_tau, float mean_scale, int is_bf16,
                           void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_bwd<__nv_bfloat16>(
                   labels, g, stats, s,
                   ExactTeacher<__nv_bfloat16>{
                       static_cast<const __nv_bfloat16*>(t)},
                   b, ds, rows, V, tau, inv_tau, mean_scale, st)
             : launch_bwd<float>(
                   labels, g, stats, s,
                   ExactTeacher<float>{static_cast<const float*>(t)}, b, ds,
                   rows, V, tau, inv_tau, mean_scale, st);
}

// As kd_stats_fwd with the teacher given as codes (rows, V) int8 and
// scale, zero (rows,) f32: t = code * scale[row] + zero[row].
extern "C" int kd_quant_stats_fwd(const void* labels, const void* s,
                                  const void* codes, const void* scale,
                                  const void* zero, const void* b,
                                  void* stats, int rows, int V, float inv_tau,
                                  int is_bf16, int path, int tile,
                                  void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QuantTeacher t = quant_teacher(codes, scale, zero);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(labels, s, t, b, stats, rows, V,
                                             inv_tau, path, tile, st)
                 : launch_fwd<float>(labels, s, t, b, stats, rows, V, inv_tau,
                                     path, tile, st);
}

// As kd_grad_bwd with the teacher given as in kd_quant_stats_fwd.
extern "C" int kd_quant_grad_bwd(const void* labels, const void* g,
                                 const void* stats, const void* s,
                                 const void* codes, const void* scale,
                                 const void* zero, const void* b, void* ds,
                                 int rows, int V, float tau, float inv_tau,
                                 float mean_scale, int is_bf16, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QuantTeacher t = quant_teacher(codes, scale, zero);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(labels, g, stats, s, t, b, ds,
                                             rows, V, tau, inv_tau, mean_scale,
                                             st)
                 : launch_bwd<float>(labels, g, stats, s, t, b, ds, rows, V,
                                     tau, inv_tau, mean_scale, st);
}
