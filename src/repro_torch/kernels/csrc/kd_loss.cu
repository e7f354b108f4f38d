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
// operations a byte, under the card's f32 balance of ~20; the backward
// does the same against one more tensor (ds written).  The least time is
// the logits read once (and ds written once) over 3.35 TB/s.  The quant
// pair reads 1 byte of teacher per logit and adds one FMA, so it is more
// bytes-bound still, with a lower bound.  In bf16 both directions also
// near the issue rate: ~47-56 SASS instructions a logit (four accurate
// expf of ~9 each) put their issue floors near the bytes bound.
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
// Backward design.  The backward is elementwise, and s, the teacher, b and
// ds are contiguous (rows, V) of one shape, so it is one flat pass over the
// n = rows * V logits: a row end inside a vector changes only which row's
// label, g and stats apply.  What bounds it: at an LLM vocabulary the bytes
// (three or four tensors read, ds written), with the bf16 issue floor not
// far under them (four accurate expf a logit with a buffer, ~46-50 SASS
// instructions: kd_sass); at the FL main path's 128 x 100 (12,800 logits,
// 0.00006 ms of bytes) a graph launch and one dependent round trip.  So a
// thread moves 16 bytes a tensor an access (4 f32 or 8 bf16 logits; 4 or 8
// bytes of codes), one vector a thread, kBwdThreads a block: 24,578 blocks
// at 512 x 49,155 in bf16.  Where 16-byte vectors would give the card's SMs
// fewer than kBwdFillThreads threads each (one warp a scheduler) the same
// kernel runs one logit a thread (W = 1): there a thread's serial exps, not
// bytes, set the time.  A thread finds its vector's row with a multiply by
// a magic number (GradArgs::magic) and loads the vector with the row's
// data, and the next row's where the vector crosses a row end, before it
// computes.  A vector inside one row compares its columns with the label
// at a fixed offset; one that crosses steps to the next row there (several
// times when V < W).  Each tensor's base has its own skew: with vectors the
// launch peels a head of scalar elements to s's 16-byte boundary, and the
// body runs on vectors when every tensor is on its own boundary there
// (codes: W bytes; the wrappers allocate ds at s's skew); tensors whose
// skews differ take one logit a thread.  Threads 0 .. 2W - 1 of block 0
// take the head and the tail.  The plan is made on the host from the
// shapes, the SM count and the pointers, so a CUDA graph replays it; no
// byte outside a tensor is read, none outside ds written.  Pad columns of
// -1e30 contribute exactly zero.
//
// The constants, from a backward sweep an earlier chip_smoke.py ran while
// threads a block and vectors a thread were run-time arguments (with
// buffer; NVIDIA H100 80GB HBM3, 700.00 W): one vector a thread beat two
// and four at every swept shape (512 x 49,155 bf16: 0.0692 against 0.0712
// and 0.0891 ms; 128 x 100 f32: 0.00214 against 0.00242 and 0.00324); 64,
// 128 or 256 threads a block moved nothing beyond the run's spread (0.0694,
// 0.0692, 0.0692).  The fill threshold, from the width timing chip_smoke.py
// keeps (phases 5 and 9: planned, one logit a thread, 16-byte vectors):
// one logit a thread beats vectors where vectors leave the card's
// schedulers short (128 x 100 bf16: 0.00202 against 0.00277) and loses
// where they fill it (512 x 1,024 bf16: 0.00440 against 0.00311; 512 x
// 49,155 bf16: 0.1529 against 0.0689); between, at 256 x 256 and 128 x
// 1,000, the two tie within the spread.  Variants tried on the card whose
// code is not kept: loading the vectors before finding the row took more
// registers and was slower at the LLM shape; a cap of 40 registers (12
// blocks an SM) spilled and slowed the quant kernel in f32.  The cap of
// 48 (kBwdMinBlocks, no spill) is kept: uncapped, the quant kernel in bf16
// took 56 and ran slower at the LLM shape, the other instances no faster.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kStats = 11;
constexpr int kBwdThreads = 128;  // backward: threads a block
// backward: blocks an SM the registers must allow (at most 51 a thread, so
// 48: every instance fits without a spill)
constexpr int kBwdMinBlocks = 10;
// backward: 16-byte vectors once they give every SM this many threads
// (one warp a scheduler), else one logit a thread
constexpr int kBwdFillThreads = 128;
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

// Teacher readers: row(r, V) gives the row's reader, whose of(x) turns a
// stored element (Elem) into the teacher's logit in f32 (p: the row's
// first element); data() is the stored tensor, which the forward stages
// and the backward reads flat.
template <typename T>
struct ExactTeacher {
  using Elem = T;
  const T* __restrict__ t;

  struct Row {
    const T* __restrict__ p;
    __device__ __forceinline__ float of(T x) const { return to_f32(x); }
    // t / tau, as the forward uses it.
    __device__ __forceinline__ float over_tau(T x, float inv_tau) const {
      return of(x) * inv_tau;
    }
  };
  __device__ __forceinline__ Row row(int r, int V) const {
    return Row{t + static_cast<int64_t>(r) * V};
  }
  __host__ __device__ __forceinline__ const T* data() const { return t; }
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
    // t / tau with 1 / tau folded into the affine (exact for tau a power
    // of two; otherwise within an ulp of of(x) * inv_tau).
    __device__ __forceinline__ float over_tau(int8_t x, float inv_tau) const {
      return fmaf(code_to_f32(x), scale * inv_tau, zero * inv_tau);
    }
  };
  __device__ __forceinline__ Row row(int r, int V) const {
    return Row{codes + static_cast<int64_t>(r) * V, scale[r], zero[r]};
  }
  __host__ __device__ __forceinline__ const int8_t* data() const {
    return codes;
  }
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

// -- backward: one flat pass -------------------------------------------------

// W elements of X in one register word of W * sizeof(X) bytes (16 down to
// 1), loaded and stored as one access (the address on that boundary).
template <int kBytes>
struct WordOf;
template <>
struct WordOf<1> {
  using type = unsigned char;
};
template <>
struct WordOf<2> {
  using type = unsigned short;
};
template <>
struct WordOf<4> {
  using type = unsigned;
};
template <>
struct WordOf<8> {
  using type = uint2;
};
template <>
struct WordOf<16> {
  using type = uint4;
};
template <typename X, int W>
struct Pack {
  using Word = typename WordOf<static_cast<int>(sizeof(X)) * W>::type;
  Word w;
  __device__ __forceinline__ X operator[](int k) const {
    return reinterpret_cast<const X*>(&w)[k];
  }
  __device__ __forceinline__ X& operator[](int k) {
    return reinterpret_cast<X*>(&w)[k];
  }
};
template <typename X, int W>
__device__ __forceinline__ void load_pack(Pack<X, W>& out,
                                          const X* __restrict__ p) {
  out.w = *reinterpret_cast<const typename Pack<X, W>::Word*>(p);
}
template <typename X, int W>
__device__ __forceinline__ void store_pack(X* __restrict__ p,
                                           const Pack<X, W>& x) {
  *reinterpret_cast<typename Pack<X, W>::Word*>(p) = x.w;
}

// What the backward reads once a row: the label, g * mean_scale, the lse
// columns of the stats (0, 2, 3 and 6) and the teacher's row reader (the
// quant teacher's scale and zero).
template <typename Teacher, bool kBuffer>
struct GradRow {
  int64_t y;
  float gs, lse_s, lse_st, lse_tt, lse_bt;
  typename Teacher::Row tr;
};

template <typename T, typename Teacher, bool kBuffer>
struct GradArgs {
  // floor(i / V) = the high 64 bits of i * magic for i < 2^32 (magic =
  // floor(2^64 / V) + 1, V >= 2; exact, as i (magic - 2^64 / V) < 2^32 / 2^64
  // <= 1 / V); V = 1 takes i itself.
  uint64_t magic;
  const int64_t* __restrict__ labels;
  const float* __restrict__ g;
  const float* __restrict__ stats;
  const T* __restrict__ s;
  Teacher teacher;
  const T* __restrict__ b;
  T* __restrict__ ds;
  int V;
  float tau, inv_tau, mean_scale;

  __device__ __forceinline__ GradRow<Teacher, kBuffer> row(int64_t r) const {
    const float* st = stats + r * kStats;
    return {labels[r], g[r] * mean_scale, st[0], st[2], st[3],
            kBuffer ? st[6] : 0.f, teacher.row(static_cast<int>(r), V)};
  }

  // ds of one logit: s, the teacher and b in f32, hit where its column is
  // the row's label.  Exponents of s/tau, t/tau and b/tau are one FMA.
  __device__ __forceinline__ float grad(float x, float t, float xb, bool hit,
                                        const GradRow<Teacher, kBuffer>& R)
      const {
    const float p_s = expf(x - R.lse_s);
    const float p_st = expf(fmaf(x, inv_tau, -R.lse_st));
    const float p_tt = expf(fmaf(t, inv_tau, -R.lse_tt));
    float d = p_s - (hit ? 1.f : 0.f) + tau * (p_st - p_tt);
    if (kBuffer) d = d + tau * (p_st - expf(fmaf(xb, inv_tau, -R.lse_bt)));
    return R.gs * d;
  }

  // Row and column of flat index i: two 32 x 32-bit products when every
  // index fits in 32 bits (narrow), else a 64-bit division.
  __device__ __forceinline__ void row_col(size_t i, bool narrow, int64_t& r,
                                          int& c) const {
    if (narrow) {
      const uint64_t x = static_cast<uint32_t>(i);
      const uint64_t lo = x * static_cast<uint32_t>(magic);
      const uint64_t hi = x * static_cast<uint32_t>(magic >> 32);
      r = V == 1 ? static_cast<int64_t>(x)
                 : static_cast<int64_t>((hi + (lo >> 32)) >> 32);
    } else {
      r = static_cast<int64_t>(i / static_cast<size_t>(V));
    }
    c = static_cast<int>(i - static_cast<size_t>(r) * V);
  }

  // Flat element i, alone (the peeled head and tail).
  __device__ __forceinline__ void scalar(size_t i, bool narrow) const {
    int64_t r;
    int c;
    row_col(i, narrow, r, c);
    const auto R = row(r);
    ds[i] = from_f32<T>(grad(to_f32(s[i]), R.tr.of(teacher.data()[i]),
                             kBuffer ? to_f32(b[i]) : 0.f, c == R.y, R));
  }
};

// The flat pass over the n = rows * V logits in vectors of W (16 bytes of s,
// or 1), one a thread: elements [0, head) and the tail past head + nvec W
// are scalar (threads of block 0), the nvec vectors between them start on
// W-element boundaries of every tensor.  Thread x of block z takes vector
// z kBwdThreads + x (neighbouring lanes on neighbouring vectors): it finds
// the vector's row, loads the vector with the row's data (and the next
// row's where the vector crosses a row end), then computes and stores it.
template <typename T, typename Teacher, bool kBuffer, int W>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    kd_grad_kernel(const GradArgs<T, Teacher, kBuffer> a, size_t n,
                   size_t head, size_t nvec) {
  using E = typename Teacher::Elem;
  const int V = a.V;
  const bool narrow = n <= 0xffffffffull;
  const size_t v = static_cast<size_t>(blockIdx.x) * kBwdThreads +
                   threadIdx.x;
  const bool ok = v < nvec;
  const size_t i = head + v * W;

  Pack<T, W> xs, xb;
  Pack<E, W> xt;
  GradRow<Teacher, kBuffer> rd, nx;  // the row, the next one
  int64_t r = 0;
  int c = 0;
  if (ok) {
    a.row_col(i, narrow, r, c);
    load_pack(xs, a.s + i);
    load_pack(xt, a.teacher.data() + i);
    if (kBuffer) load_pack(xb, a.b + i);
    rd = a.row(r);
    if (c + W > V) nx = a.row(r + 1);  // the vector crosses
  }
  if (blockIdx.x == 0 && threadIdx.x < 2 * W) {  // the head and the tail
    const int k = threadIdx.x;
    const size_t tail = n - head - nvec * W;
    const size_t e = static_cast<size_t>(k < W ? k : k - W);
    if (k < W ? e < head : e < tail)
      a.scalar(k < W ? e : head + nvec * W + e, narrow);
  }
  if (!ok) return;
  Pack<T, W> out;
  if (c + W <= V) {  // inside one row
    const int64_t yk = rd.y - c;
    const int hit = yk >= 0 && yk < W ? static_cast<int>(yk) : -1;
#pragma unroll
    for (int k = 0; k < W; ++k)
      out[k] = from_f32<T>(a.grad(to_f32(xs[k]), rd.tr.of(xt[k]),
                                  kBuffer ? to_f32(xb[k]) : 0.f, k == hit,
                                  rd));
  } else {  // crosses one row end, or more when V < W: step the row
    auto R = rd;
    int64_t rr = r;
    int cc = c;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (cc == V) {
        cc = 0;
        R = ++rr == r + 1 ? nx : a.row(rr);
      }
      out[k] = from_f32<T>(a.grad(to_f32(xs[k]), R.tr.of(xt[k]),
                                  kBuffer ? to_f32(xb[k]) : 0.f, cc == R.y,
                                  R));
      ++cc;
    }
  }
  store_pack(a.ds + i, out);
}

inline bool on_boundary(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The card's SM count (cached per device).
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

// The launch: one logit a thread while 16-byte vectors would leave the
// card's schedulers short of threads (fewer than kBwdFillThreads an SM),
// else vectors of W = 16 / itemsize after a scalar head that takes s to
// its 16-byte boundary, if every tensor is on its own boundary there
// (teacher elements: W of them); tensors whose skews differ take one logit
// a thread.  Decided from the shapes, the card and the pointers, so a CUDA
// graph replays it.  width: 0 plans, 1 or W overrides the fill choice (for
// tests and timing).
template <typename T, typename Teacher, bool kBuffer>
int launch_bwd_plan(const GradArgs<T, Teacher, kBuffer>& a, int rows,
                    int width, cudaStream_t st) {
  using E = typename Teacher::Elem;
  constexpr int W = 16 / static_cast<int>(sizeof(T));  // logits a vector
  static_assert(kBwdThreads >= 2 * W, "block 0 takes the head and the tail");
  const size_t n = static_cast<size_t>(rows) * a.V;
  if (width == 0)
    width = n / W < static_cast<size_t>(sm_count()) * kBwdFillThreads ? 1 : W;
  if (width != 1 && width != W) return static_cast<int>(cudaErrorInvalidValue);
  size_t head = 0;
  if (width == W) {
    head = (16 - reinterpret_cast<uintptr_t>(a.s) % 16) % 16 / sizeof(T);
    if (head > n) head = n;
    if (!(on_boundary(a.s + head, 16) &&
          on_boundary(a.teacher.data() + head, W * sizeof(E)) &&
          (!kBuffer || on_boundary(a.b + head, 16)) &&
          on_boundary(a.ds + head, 16))) {
      width = 1;
      head = 0;
    }
  }
  const size_t nvec = (n - head) / width;
  const size_t blocks = nvec == 0 ? 1 : (nvec + kBwdThreads - 1) / kBwdThreads;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(blocks);
  if (width == 1)
    kd_grad_kernel<T, Teacher, kBuffer, 1>
        <<<grid, kBwdThreads, 0, st>>>(a, n, head, nvec);
  else
    kd_grad_kernel<T, Teacher, kBuffer, W>
        <<<grid, kBwdThreads, 0, st>>>(a, n, head, nvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Teacher>
int launch_bwd(const void* labels, const void* g, const void* stats,
               const void* s, const Teacher& teacher, const void* b, void* ds,
               int rows, int V, float tau, float inv_tau, float mean_scale,
               int width, cudaStream_t st) {
  const auto* y = static_cast<const int64_t*>(labels);
  const auto* gp = static_cast<const float*>(g);
  const auto* sp = static_cast<const float*>(stats);
  const auto* lp = static_cast<const T*>(s);
  const auto* bp = static_cast<const T*>(b);
  auto* out = static_cast<T*>(ds);
  const uint64_t magic =
      V > 1 ? static_cast<uint64_t>((static_cast<unsigned __int128>(1) << 64) /
                                    static_cast<unsigned>(V)) + 1
            : 0;
  if (b != nullptr)
    return launch_bwd_plan<T, Teacher, true>(
        GradArgs<T, Teacher, true>{magic, y, gp, sp, lp, teacher, bp, out, V,
                                   tau, inv_tau, mean_scale},
        rows, width, st);
  return launch_bwd_plan<T, Teacher, false>(
      GradArgs<T, Teacher, false>{magic, y, gp, sp, lp, teacher, bp, out, V,
                                  tau, inv_tau, mean_scale},
      rows, width, st);
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
// of s's dtype, written once in one flat pass over the rows * V logits.
// width 0 takes launch_bwd_plan's choice; 1 (one logit a thread) or W = 16
// / itemsize (16-byte vectors, which tensors of differing skews still turn
// into one logit a thread) overrides it, for tests and timing; other values
// return cudaErrorInvalidValue.  Views at any storage offset are taken; no
// byte outside s, t, b or ds is touched.
extern "C" int kd_grad_bwd(const void* labels, const void* g,
                           const void* stats, const void* s, const void* t,
                           const void* b, void* ds, int rows, int V, float tau,
                           float inv_tau, float mean_scale, int is_bf16,
                           int width, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_bwd<__nv_bfloat16>(
                   labels, g, stats, s,
                   ExactTeacher<__nv_bfloat16>{
                       static_cast<const __nv_bfloat16*>(t)},
                   b, ds, rows, V, tau, inv_tau, mean_scale, width, st)
             : launch_bwd<float>(
                   labels, g, stats, s,
                   ExactTeacher<float>{static_cast<const float*>(t)}, b, ds,
                   rows, V, tau, inv_tau, mean_scale, width, st);
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
                                 float mean_scale, int is_bf16, int width,
                                 void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QuantTeacher t = quant_teacher(codes, scale, zero);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(labels, g, stats, s, t, b, ds,
                                             rows, V, tau, inv_tau, mean_scale,
                                             width, st)
                 : launch_bwd<float>(labels, g, stats, s, t, b, ds, rows, V,
                                     tau, inv_tau, mean_scale, width, st);
}
