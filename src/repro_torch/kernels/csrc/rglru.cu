// RG-LRU linear recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::rglru_pallas (body
// _kernel, :23): h_t = a_t * h_{t-1} + b_t along S from h_{-1} = 0, for
// a, b of shape (B, S, D) in f32; h has a's shape and type.
//
// Bound on an H100: bytes.  Two flops per element against 12 bytes (a and b
// read, h written once); the least time is 12 B S D bytes at 3.35 TB/s.
//
// Design.  The TPU kernel walks sequence chunks in order on its grid, the
// (batch, channel) carry in VMEM; here one thread owns one (batch, channel)
// and walks all of S with the carry in a register, so no state crosses
// blocks.  Neighbouring threads own neighbouring channels, so every load
// and store of a step is coalesced across the block.  The recurrence is a
// serial FMA chain per thread, and B x D threads (16,384 at 4 slots x 4,096
// channels) are too few to hide memory latency by occupancy alone, so the
// step loop is unrolled kUnroll deep: the loads of kUnroll later steps are
// issued before the chain consumes them.  Any D (a ragged last block is
// masked) and any S (a ragged last group of steps is masked).
//
// Not done yet (later work): splitting S across blocks (a chunked scan with
// a second pass that carries each chunk's product of a) when B x D is far
// below what the card needs in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

// grid (ceil(D / kThreads), B); block kThreads.
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ h, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D + d;
  float carry = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const size_t off = base + static_cast<size_t>(t0 + u) * D;
        av[u] = a[off];
        bv[u] = b[off];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        carry = fmaf(av[u], carry, bv[u]);
        h[base + static_cast<size_t>(t0 + u) * D] = carry;
      }
    }
  }
}

}  // namespace

// a, b, h (B,S,D) f32, contiguous on the current device.  Returns
// cudaGetLastError() after the launch.
extern "C" int rglru(const void* a, const void* b, void* h, int batch, int S,
                     int D, void* stream) {
  if (batch == 0 || S == 0 || D == 0) return 0;
  const dim3 grid((D + kThreads - 1) / kThreads, batch);
  rglru_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, D);
  return static_cast<int>(cudaGetLastError());
}
