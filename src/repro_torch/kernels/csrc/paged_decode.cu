// Block-paged GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/swa_decode.py::paged_decode
// (body _paged_kernel).  One query token per slot attends that slot's
// logical pages through its page table; logical page t holds absolute
// positions [t*ps, (t+1)*ps), a row is valid when a <= pos (and
// a > pos - window), and the softmax is taken online in f32.
//
// Bound on an H100: bytes.  Per slot and KV head the work is 4*G*D flops
// per position against 2*D*sizeof(T) bytes of K/V: 8 flops a byte at G=4
// in bf16.  The least time is (K/V of the attended positions of every slot
// and head + q + out + the table entries used) / 3.35 TB/s; at the serving
// shape's 2 MB of K/V, launch latency and a few dependent memory round
// trips set the pace long before that.
//
// Design.  The TPU grid (B, N, PP) carries the softmax state in VMEM
// scratch across its sequential page axis; here a slot's attended rows are
// split over S blocks (decode_attn.cuh: split-K, cp.async pipeline,
// mma.sync scores, a combine kernel).  A slot visits the rows from the
// first page holding a valid position (pos - window + 1, or 0) to pos, so
// its traffic is what it attends, not its whole table: the masked pages
// the TPU kernel also visits contribute exactly nothing there.  Run s
// covers whole pages.  Each row's page id is read from the table in
// global memory (through the read-only cache) when its copy is issued, so
// a block reads only the ids of the pages it visits and the table's length
// is bounded by nothing but its indexing (offsets are size_t).  Page ids
// are clamped into [0, P) so no table entry can read outside the pool; the
// trash page 0 is masked by position like any other.  A slot with pos < 0
// visits nothing and gets zeros (the engine never asks for one).

#define DECODE_ATTN_NS paged_attn
#include "decode_attn.cuh"

namespace {

using namespace paged_attn;

// Visited row r -> absolute position first + r -> pool row
// pt[a / ps] * ps + a % ps; valid when lo <= a <= pos.
struct PagedRows {
  const int* pt_row;
  int first, lo, pos, ps, P;
  size_t row_stride;
  __device__ size_t offset(int r) const {
    const int a = first + r;
    const int t = a / ps;
    const int page = min(max(__ldg(pt_row + t), 0), P - 1);
    return (static_cast<size_t>(page) * ps + (a - t * ps)) * row_stride;
  }
  __device__ bool valid(int r) const {
    const int a = first + r;
    return a >= lo && a <= pos;
  }
};

// grid (S, N, B), 128 threads, smem_bytes(D, sizeof(T)); R a
// multiple of ps.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ pt,
                       const int* __restrict__ pos_arr, int G, int P,
                       int ps, int PP, int window, float scale, int R,
                       float* __restrict__ part, T* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int N = gridDim.y;
  stage_q<T, D>(q + (static_cast<size_t>(b) * N + n) * G * D, G, smem);
  const int pos = pos_arr[b];

  // Visited rows: from the first page holding a valid position to pos.
  const int lo = window > 0 ? max(pos - window + 1, 0) : 0;
  const int first = lo / ps * ps;
  const long long last_row = static_cast<long long>(PP) * ps - 1;
  const int hi = static_cast<int>(min(static_cast<long long>(pos), last_row));
  const int count = pos < 0 ? 0 : hi - first + 1;
  const PagedRows map{pt + static_cast<size_t>(b) * PP, first, lo, pos, ps,
                      P, static_cast<size_t>(N) * D};
  const size_t head = static_cast<size_t>(n) * D;
  const Dest<T> d = block_dest(part, out, G, D);
  attend<T, D>(k_pool + head,
            v_pool + head, map, s * R, min(R, count - s * R), G, scale,
            d.out, d.ml, d.acc, smem);
}

}  // namespace

// q (B,N,G,D), k_pool/v_pool (P,ps,N,D) of one dtype (f32 or bf16), pt
// (B,PP) int32, pos (B,) int32, out (B,N,G,D) of q's dtype; all contiguous
// on the current device, pools 16-byte aligned.  window <= 0 means no
// window.  The plan (S runs of R rows, R a multiple of ps, S*R covering
// every slot's visited rows) comes from the wrapper; part holds
// B*N*S*G*(D+2) floats when S > 1.  Needs 1 <= G <= 16, D % 32 == 0 and
// D <= 256 (the wrapper checks).  Returns the first CUDA error of the
// launches (0 on success).
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* pt,
                            const void* pos, void* out, void* part, int B,
                            int N, int G, int D, int P, int ps, int PP,
                            int window, float scale, int is_bf16, int S,
                            int R, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (S < 1 || R < ps || R % ps) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  auto run = [&](auto t, auto d) {
    using T = decltype(t);
    constexpr int kD = decltype(d)::value;
    return launch<T, kD, paged_split_kernel<T, kD>>(B, N, G, S, p,
                         static_cast<T*>(out), st, static_cast<const T*>(q),
                         static_cast<const T*>(k_pool),
                         static_cast<const T*>(v_pool),
                         static_cast<const int*>(pt),
                         static_cast<const int*>(pos), G, P, ps, PP, window,
                         scale, R);
  };
  return dispatch_d(D, [&](auto d) {
    return is_bf16 ? run(__nv_bfloat16(), d) : run(float(), d);
  });
}
