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
// Bound on an H100: f32 operations.  A chunk does q (q + 1) n (scores,
// j <= i only) + q (q + 1) p (y_diag, the same causal half) + 4 q n p (y_off
// and the state update) flops against 4 q (2n + 2p + 1) bytes: at q = 128,
// n = 128, p = 64 that is ~37 flops a byte, above the card's f32 CUDA-core
// balance (67 TFLOP/s over 3.35 TB/s = 20).  The least time is those flops at 67 TFLOP/s (the
// reference is f32; this kernel runs no tensor cores).
//
// Design.  The TPU grid (b*h, chunks) carries H in VMEM scratch across its
// sequential chunk axis; GPU blocks run in no order, so one block owns one
// (batch, head) and a loop inside it walks the chunks in order, H kept in
// shared memory.  A chunk's B and C rows (q x n), its xb rows (q x p) and
// its csum, exp(csum) and exp(csum_last - csum) are staged in shared
// memory; the q x q score matrix is built in row tiles of kTile rows
// (kTile x q floats), so the whole plan at q = 128, n = 128, p = 64 is
// 215,808 bytes: the kernel opts into more than 48 KB of dynamic shared
// memory with cudaFuncSetAttribute (once, at the first launch that needs
// it).  B, C and H rows are padded to n + 1 floats, so the per-row dot
// products of one warp hit 32 different banks.  B and C are read per group:
// head hd uses group hd / (h / g), with no copy broadcast to heads.
//
// exp above the diagonal.  For j > i, csum_i - csum_j > 0 can overflow to
// inf; those terms are skipped (never computed, never multiplied by a 0/1
// mask, since inf * 0 = NaN).  exp(csum) of a long chunk underflows to
// denormals: the build has no --use_fast_math and the kernel calls expf,
// not __expf, so they stay exact.  Any chunk from 1 to kMaxChunk works
// (a prime sequence length gives q = 1).
//
// Not done yet (later work): tensor cores (the scores and the state update
// are q x n by n x q and p x q by q x n products: wgmma in TF32 would need
// a looser tolerance), register tiling of the products, overlapping the
// next chunk's loads (cp.async/TMA), and more than one block per (batch,
// head) (128 blocks at 4 slots x 32 heads fill 128 of 132 SMs; one slot
// fills 32).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;       // score rows built at a time
constexpr int kMaxChunk = 128;  // the wrapper's limit on q

// Shared floats for chunk q, state (p, n): B, C (q x (n+1)), xb (q x p),
// H (p x (n+1)), the score tile (kTile x q), csum, exp(csum) and
// exp(csum_last - csum) (q each).
__host__ __device__ inline int smem_floats(int q, int p, int n) {
  const int tile = q < kTile ? q : kTile;
  return 2 * q * (n + 1) + q * p + p * (n + 1) + tile * q + 3 * q;
}

// grid (b, h); block kThreads; dynamic shared memory smem_floats(q, p, n).
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ B,
           const float* __restrict__ C, float* __restrict__ y,
           float* __restrict__ state, int S, int H, int G, int P, int N,
           int q) {
  extern __shared__ float smem[];
  const int ns = N + 1;  // padded row stride of B, C and the state
  const int tile = q < kTile ? q : kTile;
  float* Bs = smem;               // [q][N+1]
  float* Cs = Bs + q * ns;        // [q][N+1]
  float* Xs = Cs + q * ns;        // [q][P]   x * dt
  float* Hs = Xs + q * P;         // [P][N+1] carried state
  float* Ss = Hs + P * ns;        // [tile][q] masked, decayed scores
  float* cs = Ss + tile * q;      // [q] csum
  float* dstart = cs + q;         // [q] exp(csum)
  float* dend = dstart + q;       // [q] exp(csum_last - csum)

  const int b = blockIdx.x;
  const int hd = blockIdx.y;
  const int grp = hd / (H / G);
  const int tid = threadIdx.x;
  const float a_h = A[hd];

  for (int i = tid; i < P * ns; i += kThreads) Hs[i] = 0.f;

  const int nchunks = S / q;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * q;
    __syncthreads();  // the previous chunk is consumed
    // Stage B and C rows (group grp) and xb = x * dt (head hd).
    for (int i = tid; i < q * N; i += kThreads) {
      const int r = i / N, k = i - r * N;
      const size_t off =
          ((static_cast<size_t>(b) * S + t0 + r) * G + grp) * N + k;
      Bs[r * ns + k] = B[off];
      Cs[r * ns + k] = C[off];
    }
    for (int i = tid; i < q * P; i += kThreads) {
      const int r = i / P, e = i - r * P;
      const size_t row = (static_cast<size_t>(b) * S + t0 + r) * H + hd;
      Xs[i] = x[row * P + e] * dt[row];
    }
    if (tid == 0) {  // the within-chunk inclusive cumulative sum, in order
      float run = 0.f;
      for (int r = 0; r < q; ++r) {
        run += dt[(static_cast<size_t>(b) * S + t0 + r) * H + hd] * a_h;
        cs[r] = run;
      }
    }
    __syncthreads();
    const float total = cs[q - 1];
    for (int r = tid; r < q; r += kThreads) {
      dstart[r] = expf(cs[r]);
      dend[r] = expf(total - cs[r]);
    }

    // Outputs, kTile rows at a time: scores, then y from them and from H.
    for (int i0 = 0; i0 < q; i0 += tile) {
      const int rows = min(tile, q - i0);
      __syncthreads();  // dstart/dend ready; the previous tile is consumed
      for (int e = tid; e < rows * q; e += kThreads) {
        const int ii = e / q, j = e - ii * q;
        const int i = i0 + ii;
        float s = 0.f;
        if (j <= i) {  // above the diagonal exp() may be inf: never formed
          const float* ci = Cs + i * ns;
          const float* bj = Bs + j * ns;
          for (int k = 0; k < N; ++k) s = fmaf(ci[k], bj[k], s);
          s *= expf(cs[i] - cs[j]);
        }
        Ss[ii * q + j] = s;
      }
      __syncthreads();
      for (int e = tid; e < rows * P; e += kThreads) {
        const int ii = e / P, col = e - ii * P;
        const int i = i0 + ii;
        const float* si = Ss + ii * q;
        float diag = 0.f;
        for (int j = 0; j <= i; ++j) diag = fmaf(si[j], Xs[j * P + col], diag);
        const float* ci = Cs + i * ns;
        const float* hc = Hs + col * ns;
        float off = 0.f;
        for (int k = 0; k < N; ++k) off = fmaf(ci[k], hc[k], off);
        const size_t row = (static_cast<size_t>(b) * S + t0 + i) * H + hd;
        y[row * P + col] = diag + dstart[i] * off;
      }
    }
    __syncthreads();  // every y row has read H

    // State update: H = exp(total) H + sum_j (xb_j exp(total - csum_j)) B_j.
    const float decay = expf(total);
    for (int e = tid; e < P * N; e += kThreads) {
      const int col = e / N, k = e - col * N;
      float acc = 0.f;
      for (int j = 0; j < q; ++j)
        acc = fmaf(Xs[j * P + col] * dend[j], Bs[j * ns + k], acc);
      Hs[col * ns + k] = Hs[col * ns + k] * decay + acc;
    }
  }
  __syncthreads();
  float* st = state + (static_cast<size_t>(b) * H + hd) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int col = e / N, k = e - col * N;
    st[e] = Hs[col * ns + k];
  }
}

int g_smem_opted = 48 * 1024;  // dynamic shared memory the kernel may use

}  // namespace

// x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,g,n), y (b,s,h,p) and state
// (b,h,p,n), all f32 and contiguous on the current device; q divides s,
// 1 <= q <= 128 and g divides h (the wrapper checks).  Returns
// cudaGetLastError() after the launch, or, with nothing launched, the error
// of raising the shared-memory limit when the chunk's plan does not fit.
extern "C" int ssd(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* state,
                   int batch, int S, int H, int G, int P, int N, int q,
                   void* stream) {
  if (batch == 0 || H == 0) return 0;
  if (q < 1 || q > kMaxChunk || S % q || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(q, P, N);
  if (static_cast<int>(smem) > g_smem_opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // returned here; keep it from the next launch's check
      return static_cast<int>(err);
    }
    g_smem_opted = static_cast<int>(smem);
  }
  const dim3 grid(batch, H);
  ssd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(state), S, H, G, P, N, q);
  return static_cast<int>(cudaGetLastError());
}
