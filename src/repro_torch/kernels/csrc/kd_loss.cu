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
// adds one FMA, so it is more bytes-bound still, with a lower bound.
//
// Design.  The TPU grid (row blocks, vocab tiles) runs its vocab axis in
// order and carries the online (max, denominator, numerators) state in VMEM
// scratch from tile to tile.  Blocks on the GPU run in no order, so the
// forward gives one block to one row: each thread strides over the row's
// columns (neighbouring threads on neighbouring columns, four columns of
// every tensor loaded before any is used) and keeps the four online
// (max, denominator) pairs and the four weighted numerators in registers.
// The threads then merge with the same rescaling rule, by warp shuffles and
// then through shared memory, and one thread writes the row's stats.
// Maxes start at -1e30 as on the TPU, so a thread whose columns are all
// -1e30 pad (or that has none) carries a finite max and a finite state, and
// the merge scales it by exp(-1e30 - m) = 0 without an inf or a NaN.  The
// backward is elementwise: a 2-D grid of (row, 1024-column chunk) blocks
// whose threads read the row's stats once and write four columns each.
// Any V is taken; pad columns of -1e30 contribute exactly zero.
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
// The TPU kernel pads codes to its 128-lane tile and masks the pad columns
// by index; these kernels read exactly V columns, so there is nothing to
// mask.
//
// Not done yet (later work): several rows per block when V is small (the
// FL main path's V = 100 leaves most of a block idle), and 16-byte loads
// where rows are aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kStats = 11;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

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

// One online-logsumexp stream: running max m, denominator d = sum exp(x-m),
// and NW numerators n_i = sum exp(x-m) * w_i.
template <int NW>
struct Online {
  float m, d, n[NW > 0 ? NW : 1];

  __device__ __forceinline__ void init() {
    m = kNeg;
    d = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) n[i] = 0.f;
  }

  __device__ __forceinline__ void push(float x, const float* w) {
    if (x > m) {
      const float scale = expf(m - x);
      d = d * scale + 1.f;
#pragma unroll
      for (int i = 0; i < NW; ++i) n[i] = n[i] * scale + w[i];
      m = x;
    } else {
      const float e = expf(x - m);
      d += e;
#pragma unroll
      for (int i = 0; i < NW; ++i) n[i] += e * w[i];
    }
  }

  // Merge with the state of the lane `off` apart (xor shuffle).
  __device__ __forceinline__ void merge_shfl(int off) {
    Online o;
    o.m = __shfl_xor_sync(0xffffffffu, m, off);
    o.d = __shfl_xor_sync(0xffffffffu, d, off);
#pragma unroll
    for (int i = 0; i < NW; ++i) o.n[i] = __shfl_xor_sync(0xffffffffu, n[i], off);
    merge(o);
  }

  __device__ __forceinline__ void merge(const Online& o) {
    const float mm = fmaxf(m, o.m);
    const float sa = expf(m - mm), sb = expf(o.m - mm);
    d = d * sa + o.d * sb;
#pragma unroll
    for (int i = 0; i < NW; ++i) n[i] = n[i] * sa + o.n[i] * sb;
    m = mm;
  }

  __device__ __forceinline__ float lse() const { return logf(d) + m; }
};

// The per-thread state of a row: s, s/tau, t/tau (weights t/tau, s/tau)
// and b/tau (weights b/tau, s/tau).
struct RowState {
  Online<0> s, st;
  Online<2> tt, bt;

  __device__ __forceinline__ void init() {
    s.init();
    st.init();
    tt.init();
    bt.init();
  }
  __device__ __forceinline__ void merge_shfl(int off, bool with_buffer) {
    s.merge_shfl(off);
    st.merge_shfl(off);
    tt.merge_shfl(off);
    if (with_buffer) bt.merge_shfl(off);
  }
};

// Teacher readers: row(r, V) gives a functor from a column of row r to
// the teacher's logit there, in f32.
template <typename T>
struct ExactTeacher {
  const T* __restrict__ t;

  struct Row {
    const T* __restrict__ p;
    __device__ __forceinline__ float operator()(int c) const {
      return to_f32(p[c]);
    }
  };
  __device__ __forceinline__ Row row(int r, int V) const {
    return Row{t + static_cast<int64_t>(r) * V};
  }
};

struct QuantTeacher {
  const int8_t* __restrict__ codes;
  const float* __restrict__ scale;
  const float* __restrict__ zero;

  struct Row {
    const int8_t* __restrict__ p;
    float scale, zero;
    __device__ __forceinline__ float operator()(int c) const {
      return fmaf(static_cast<float>(p[c]), scale, zero);
    }
  };
  __device__ __forceinline__ Row row(int r, int V) const {
    return Row{codes + static_cast<int64_t>(r) * V, scale[r], zero[r]};
  }
};

template <typename T, typename Teacher, bool kBuffer>
__global__ void __launch_bounds__(kThreads)
    kd_stats_kernel(const int64_t* __restrict__ labels,
                    const T* __restrict__ s, const Teacher teacher,
                    const T* __restrict__ b, float* __restrict__ stats, int V,
                    float inv_tau) {
  const int row = blockIdx.x;
  const int64_t base = static_cast<int64_t>(row) * V;
  const T* sr = s + base;
  const auto tr = teacher.row(row, V);
  const T* br = kBuffer ? b + base : nullptr;

  RowState st;
  st.init();
  for (int c0 = threadIdx.x; c0 < V; c0 += kThreads * kUnroll) {
    float xs[kUnroll], xt[kUnroll], xb[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int c = c0 + k * kThreads;
      const bool in = c < V;
      xs[k] = in ? to_f32(sr[c]) : 0.f;
      xt[k] = in ? tr(c) : 0.f;
      if (kBuffer) xb[k] = in ? to_f32(br[c]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (c0 + k * kThreads >= V) break;
      const float sv = xs[k], sts = xs[k] * inv_tau, tts = xt[k] * inv_tau;
      st.s.push(sv, nullptr);
      st.st.push(sts, nullptr);
      const float wt[2] = {tts, sts};
      st.tt.push(tts, wt);
      if (kBuffer) {
        const float bts = xb[k] * inv_tau;
        const float wb[2] = {bts, sts};
        st.bt.push(bts, wb);
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) st.merge_shfl(off, kBuffer);
  __shared__ RowState part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = st;
  __syncthreads();
  if (warp != 0) return;
  if (lane < kWarps) {
    st = part[lane];
  } else {
    st.init();
  }
  for (int off = 16; off > 0; off >>= 1) st.merge_shfl(off, kBuffer);
  if (lane != 0) return;

  const int64_t y = labels[row];
  const float sy = (y >= 0 && y < V) ? to_f32(sr[y]) : 0.f;
  float* out = stats + static_cast<int64_t>(row) * kStats;
  out[0] = st.s.lse();
  out[1] = sy;
  out[2] = st.st.lse();
  out[3] = st.tt.lse();
  out[4] = st.tt.n[0] / st.tt.d;
  out[5] = st.tt.n[1] / st.tt.d;
  out[6] = kBuffer ? st.bt.lse() : 0.f;
  out[7] = kBuffer ? st.bt.n[0] / st.bt.d : 0.f;
  out[8] = kBuffer ? st.bt.n[1] / st.bt.d : 0.f;
  out[9] = 0.f;
  out[10] = 0.f;
}

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
int launch_fwd(const void* labels, const void* s, const Teacher& teacher,
               const void* b, void* stats, int rows, int V, float inv_tau,
               cudaStream_t st) {
  const auto* y = static_cast<const int64_t*>(labels);
  const auto* sp = static_cast<const T*>(s);
  const auto* bp = static_cast<const T*>(b);
  auto* out = static_cast<float*>(stats);
  if (b != nullptr) {
    kd_stats_kernel<T, Teacher, true><<<rows, kThreads, 0, st>>>(
        y, sp, teacher, bp, out, V, inv_tau);
  } else {
    kd_stats_kernel<T, Teacher, false><<<rows, kThreads, 0, st>>>(
        y, sp, teacher, bp, out, V, inv_tau);
  }
  return static_cast<int>(cudaGetLastError());
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
// device, 1 <= V and rows <= 2^31 - 1 (the wrapper checks).  Returns
// cudaGetLastError() after the launch.
extern "C" int kd_stats_fwd(const void* labels, const void* s, const void* t,
                            const void* b, void* stats, int rows, int V,
                            float inv_tau, int is_bf16, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_fwd<__nv_bfloat16>(
                   labels, s,
                   ExactTeacher<__nv_bfloat16>{
                       static_cast<const __nv_bfloat16*>(t)},
                   b, stats, rows, V, inv_tau, st)
             : launch_fwd<float>(
                   labels, s, ExactTeacher<float>{static_cast<const float*>(t)},
                   b, stats, rows, V, inv_tau, st);
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
                                  int is_bf16, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QuantTeacher t = quant_teacher(codes, scale, zero);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(labels, s, t, b, stats, rows, V,
                                             inv_tau, st)
                 : launch_fwd<float>(labels, s, t, b, stats, rows, V, inv_tau,
                                     st);
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
