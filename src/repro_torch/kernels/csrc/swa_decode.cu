// Dense / ring / sliding-window GQA decode attention for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/swa_decode.py::swa_decode (body
// _kernel).  One query token per row b attends that row's dense cache
// (B, W, N, D) at its own position pos[b].  Cache slot j holds absolute
// position a_j = j, or with a ring buffer a_j = pos - ((pos - j) mod W); a
// slot is valid when 0 <= a_j <= pos and, with a window, a_j > pos - window.
// The softmax is taken online in f32 from QK through PV, as on the TPU.
//
// Bound on an H100: bytes.  Per (row, KV head) the work is 4*G*D flops per
// valid slot against 2*D*sizeof(T) bytes of K/V: 8 flops a byte at G=4 in
// bf16, 32 at RecurrentGemma's G=16 (where the scores go to the tensor
// cores, see decode_attn.cuh).  The least time is (K/V of the valid slots
// of every row and head + q + out) / 3.35 TB/s; at the main path's
// 0.1-17 MB of K/V, launch latency and a few dependent memory round trips
// set the pace long before that.
//
// Design.  The TPU grid (B, N, W/tile) carries the softmax state in VMEM
// scratch across its sequential tile axis; here the rows one (row, head)
// attends are split over S blocks (decode_attn.cuh: split-K, cp.async
// pipeline, mma.sync scores, a combine kernel), so B=1 at W=8192 runs 256
// blocks instead of 8.  Each (row, head) visits its valid ABSOLUTE
// positions a = lo .. hi and reads slot a (a mod W for a ring): lo >= 0
// there, so C's truncating % is a true modulo (the TPU kernel's
// rem(pos - j + 64 W, W) holds only while pos - j > -64 W), taken once;
// a row of the run then steps the slot on and wraps it at most once.
// Only the slots the row attends are read.  Run s covers visited rows [s R,
// (s+1) R); any W works, the last chunk of a run holds fewer rows.  Every
// visited row is valid, unless none is (pos < 0, or a full cache wholly
// outside the window): then the row visits every slot with all scores at
// -1e30 and gets the mean of V, as the reference's softmax gives.

#define DECODE_ATTN_NS swa_attn
#include "decode_attn.cuh"

namespace {

using namespace swa_attn;

// Visited row r (r < W) -> slot start + r, wrapped once past W for a ring
// (start = lo mod W, lo >= 0); all valid or none.
struct DenseRows {
  int start, W;
  bool wrap, valid_all;
  size_t row_stride;
  __device__ size_t offset(int r) const {
    int slot = start + r;
    if (wrap && slot >= W) slot -= W;
    return static_cast<size_t>(slot) * row_stride;
  }
  __device__ bool valid(int) const { return valid_all; }
};

// grid (S, N, B), 128 threads, smem_bytes(D, sizeof(T)).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    swa_split_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                     const T* __restrict__ v_cache,
                     const int* __restrict__ pos_arr, int G, int W,
                     int window, int ring, float scale, int R,
                     float* __restrict__ part, T* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int N = gridDim.y;
  stage_q<T, D>(q + (static_cast<size_t>(b) * N + n) * G * D, G, smem);
  const int pos = pos_arr[b];

  // Valid absolute positions [lo, hi]; with none valid, every slot.
  int lo = ring ? max(pos - W + 1, 0) : 0;
  const int hi = ring ? pos : min(pos, W - 1);
  if (window > 0) lo = max(lo, pos - window + 1);
  int count = hi - lo + 1;
  const bool none_valid = count <= 0;
  if (none_valid) {
    lo = 0;
    count = W;
  }
  const size_t row_stride = static_cast<size_t>(N) * D;
  const bool wrap = ring && !none_valid;
  const DenseRows map{wrap ? lo % W : lo, W, wrap, !none_valid, row_stride};
  const size_t head = static_cast<size_t>(b) * W * row_stride +
                      static_cast<size_t>(n) * D;
  const Dest<T> d = block_dest(part, out, G, D);
  attend<T, D>(k_cache + head,
            v_cache + head, map, s * R, min(R, count - s * R), G, scale,
            d.out, d.ml, d.acc, smem);
}

}  // namespace

// q (B,N,G,D), k_cache/v_cache (B,W,N,D) of one dtype (f32 or bf16), pos
// (B,) int32, out (B,N,G,D) of q's dtype; all contiguous on the current
// device, caches 16-byte aligned.  window <= 0 means no window; ring != 0
// reads the cache as a ring buffer.  The plan (S runs of R rows, S*R >= W)
// comes from the wrapper; part holds B*N*S*G*(D+2) floats when S > 1.
// Needs 1 <= G <= 16, D % 32 == 0 and D <= 256 (the wrapper checks).
// Returns the first CUDA error of the launches (0 on success).
extern "C" int swa_decode(const void* q, const void* k_cache,
                          const void* v_cache, const void* pos, void* out,
                          void* part, int B, int N, int G, int D, int W,
                          int window, int ring, float scale, int is_bf16,
                          int S, int R, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (S < 1 || static_cast<long long>(S) * R < W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  auto run = [&](auto t, auto d) {
    using T = decltype(t);
    constexpr int kD = decltype(d)::value;
    return launch<T, kD, swa_split_kernel<T, kD>>(B, N, G, S, p,
                         static_cast<T*>(out), st, static_cast<const T*>(q),
                         static_cast<const T*>(k_cache),
                         static_cast<const T*>(v_cache),
                         static_cast<const int*>(pos), G, W, window, ring,
                         scale, R);
  };
  return dispatch_d(D, [&](auto d) {
    return is_bf16 ? run(__nv_bfloat16(), d) : run(float(), d);
  });
}
