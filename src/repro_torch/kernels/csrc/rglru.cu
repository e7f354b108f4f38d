// RG-LRU linear recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::rglru_pallas (body
// _kernel, :23): h_t = a_t * h_{t-1} + b_t along S from h_{-1} = 0, for
// a, b of shape (B, S, D) in f32; h has a's shape and type.
//
// What bounds it on an H100: bytes.  Two flops per element against 12
// bytes (a and b read once, h written once); the least time is 12 B S D
// bytes at 3.35 TB/s.  Reaching it takes enough bytes in flight: at
// ~0.8 us of memory latency, 3.35 TB/s needs ~2.7 MB in flight on the
// card, ~20 KB an SM (Little's law).  The recurrence is a serial FMA chain
// per (batch, channel), and B x D chains (16,384 at 4 slots x 4,096
// channels; 4,096 for one slot) are too few to get there by occupancy, so
// each chain has to keep many steps of loads in flight by itself.
//
// Design: one pass, a pipelined ring in shared memory.  A block is one
// warp and owns a slab of 32 channels of one batch row (grid (ceil(D/32),
// B): 512 blocks at 4 x 4,096, 128 at one slot, so narrow slabs fill the
// card's 132 SMs even for a lone arrival).  It streams kSteps x 32 tiles of
// a and b through a kStages-deep ring of cp.async copies: while the lanes
// walk their carries through one tile, the next kStages - 1 tiles (24 KB)
// are in flight, so an SM holding four such warps keeps ~96 KB of loads
// outstanding, and at one slot ~24 KB.  Each lane copies and reads only its
// own channel's words (a warp's 32 four-byte copies of one step are one
// coalesced 128-byte request), so the ring needs no barrier: a lane waits
// for its own copy groups.  h is stored straight from the carry register,
// one coalesced 128-byte store per warp and step, overlapping the next
// tiles' loads.  Any D (lanes past D copy and store nothing) and any S (the
// last tile is short).  No state is kept between calls.
//
// Not done yet (later work): splitting S across blocks (a decoupled
// look-back scan) for batches so small that even 32-channel slabs leave
// SMs idle (D < ~4,000 at one slot).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;   // channels a block: one warp
constexpr int kSteps = 32;   // steps a tile
constexpr int kStages = 4;   // tiles in the ring: kStages - 1 in flight

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

// grid (ceil(D / kLanes), B); block kLanes; 32 KB of static shared memory.
__global__ void __launch_bounds__(kLanes)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ h, int S, int D) {
  __shared__ float ring[kStages][2][kSteps][kLanes];
  const int lane = threadIdx.x;
  const int d = blockIdx.x * kLanes + lane;
  const bool valid = d < D;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D + d;
  const int ntiles = (S + kSteps - 1) / kSteps;

  // Tile i's copies into stage i % kStages, one commit group a tile (empty
  // past the last tile, so the group count stays uniform).
  auto issue = [&](int tile) {
    if (valid && tile < ntiles) {
      const int st = tile % kStages, t0 = tile * kSteps;
      const int rows = min(kSteps, S - t0);
      for (int r = 0; r < rows; ++r) {
        const size_t off = base + static_cast<size_t>(t0 + r) * D;
        cp_async4(&ring[st][0][r][lane], a + off);
        cp_async4(&ring[st][1][r][lane], b + off);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  float carry = 0.f;
  for (int tile = 0; tile < ntiles; ++tile) {
    issue(tile + kStages - 1);  // into the stage consumed last iteration
    cp_async_wait<kStages - 1>();  // this tile's group has landed
    if (!valid) continue;
    const int st = tile % kStages, t0 = tile * kSteps;
    const int rows = min(kSteps, S - t0);
    float* out = h + base + static_cast<size_t>(t0) * D;
    if (rows == kSteps) {
#pragma unroll
      for (int r = 0; r < kSteps; ++r) {
        carry = fmaf(ring[st][0][r][lane], carry, ring[st][1][r][lane]);
        out[static_cast<size_t>(r) * D] = carry;
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        carry = fmaf(ring[st][0][r][lane], carry, ring[st][1][r][lane]);
        out[static_cast<size_t>(r) * D] = carry;
      }
    }
  }
  cp_async_wait<0>();  // nothing left in flight at exit
}

}  // namespace

// a, b, h (B,S,D) f32, contiguous on the current device.  Returns
// cudaGetLastError() after the launch.
extern "C" int rglru(const void* a, const void* b, void* h, int batch, int S,
                     int D, void* stream) {
  if (batch == 0 || S == 0 || D == 0) return 0;
  const dim3 grid((D + kLanes - 1) / kLanes, batch);
  rglru_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, D);
  return static_cast<int>(cudaGetLastError());
}
