// Block-paged GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/swa_decode.py::paged_decode
// (body _paged_kernel).  One query token per slot attends that slot's
// logical pages through its page table; logical page t holds absolute
// positions [t*ps, (t+1)*ps), a row is valid when a <= pos (and
// a > pos - window), and the softmax is taken online over pages in f32.
//
// Bound on an H100: bytes.  Per slot and KV head the work is 4*G*D flops
// per position against 2*D*sizeof(T) bytes of K/V, i.e. under 4 flops a
// byte at G=4, far below the card's ~20 flops/byte f32 CUDA-core balance.
// The least time is therefore (K/V of positions 0..pos of every slot and
// head + q + out) / 3.35 TB/s.
//
// Design.  The TPU grid (B, N, PP) carries the softmax state in VMEM scratch
// across its sequential page axis; blocks on the GPU run in no order, so
// here one block owns one (slot, KV head) and a loop inside it walks the
// slot's pages.  Only pages holding a position <= pos (and, with a window,
// > pos - window) are read, so a slot's traffic is what it attends, not its
// whole table: the masked pages the TPU kernel also visits contribute
// exactly nothing there.  At a few microseconds of work per slot the
// kernel is bound by latency, not by bandwidth, so it cuts the number of
// dependent memory round trips: the slot's page ids are staged in shared
// memory once, and each step of the loop stages a chunk of up to 64 rows
// (several pages) of K and V with 16-byte loads that are all issued before
// any is used.  Rows are kept as f32 in shared memory, padded to D+1
// floats so that the per-row dot products of one warp hit 32 different
// banks.  Warp g owns query group g: each lane scores rows lane, lane+32,
// ..., the warp reduces max and sum with shuffles, and each lane keeps D/32
// output features of the accumulator in registers.  Page ids are clamped
// into [0, P) so no table entry can read outside the pool; the trash page
// 0 is masked by position like any other.
//
// Not done yet (later work): overlapping the next chunk's loads with this
// chunk's math (cp.async/TMA), and splitting a slot's pages over several
// blocks when B*N is far below the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxFeaturesPerLane = 8;  // head_dim <= 256
constexpr int kMaxChunkRows = 64;       // rows staged per loop step
constexpr int kStage = 4;               // 16-byte loads in flight per thread
constexpr int kSmemLimit = 48 * 1024;   // no opt-in to larger carve-outs

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes of T -> floats at dst.
__device__ __forceinline__ void unpack(const uint4& raw, float* dst, float) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* dst,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

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

// Shared floats the kernel needs for a chunk of ch rows.
__host__ __device__ inline int smem_floats(int ch, int D, int G, int PP) {
  return 2 * ch * (D + 1) + G * D + G * ch + PP;
}

// grid (B, N); block 32*max(G, 4) threads; dynamic shared memory
// smem_floats(ch, D, G, PP) floats; ch a multiple of ps.
template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int* __restrict__ pt,
                                    const int* __restrict__ pos_arr,
                                    T* __restrict__ out, int N, int G, int D,
                                    int P, int ps, int PP, int window,
                                    float scale, int ch) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ float smem[];
  const int stride = D + 1;
  float* ks = smem;                  // [ch][D+1]
  float* vs = ks + ch * stride;      // [ch][D+1]
  float* qs = vs + ch * stride;      // [G][D]
  float* probs = qs + G * D;         // [G][ch]
  int* pages = reinterpret_cast<int*>(probs + G * ch);  // [PP]

  const int b = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const bool owns_group = g < G;
  const int nthreads = blockDim.x;
  const int pos = pos_arr[b];
  const int features = D / 32;

  // Pages that can hold a valid row: [first, last].
  int first = 0;
  if (window > 0) {
    const int lo = pos - window + 1;
    first = lo > 0 ? lo / ps : 0;
  }
  int last = pos < 0 ? -1 : pos / ps;
  if (last > PP - 1) last = PP - 1;

  const T* qb = q + (static_cast<size_t>(b) * N + n) * G * D;
  for (int i = tid; i < G * D; i += nthreads) qs[i] = to_f32(qb[i]);
  for (int t = first + tid; t <= last; t += nthreads) {
    const int page = pt[static_cast<size_t>(b) * PP + t];
    pages[t] = page < 0 ? 0 : (page >= P ? P - 1 : page);
  }

  float m = kNeg;
  float denom = 0.f;
  float acc[kMaxFeaturesPerLane];
#pragma unroll
  for (int j = 0; j < kMaxFeaturesPerLane; ++j) acc[j] = 0.f;

  const size_t row_stride = static_cast<size_t>(N) * D;
  const int vecs_per_row = D / kVec;
  const float* qg = qs + g * D;
  float* pg = probs + g * ch;
  const int pages_per_chunk = ch / ps;

  for (int t0 = first; t0 <= last; t0 += pages_per_chunk) {
    const int nrows = min(ch, (last - t0 + 1) * ps);
    const int nvec = nrows * vecs_per_row;
    __syncthreads();  // page ids staged; the previous chunk is consumed
    for (int base = tid; base < nvec; base += kStage * nthreads) {
      uint4 kr[kStage], vr[kStage];
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int i = base + s * nthreads;
        if (i < nvec) {
          const int r = i / vecs_per_row;
          const int c = (i - r * vecs_per_row) * kVec;
          const size_t off =
              (static_cast<size_t>(pages[t0 + r / ps]) * ps + r % ps) *
                  row_stride + static_cast<size_t>(n) * D + c;
          kr[s] = *reinterpret_cast<const uint4*>(k_pool + off);
          vr[s] = *reinterpret_cast<const uint4*>(v_pool + off);
        }
      }
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int i = base + s * nthreads;
        if (i < nvec) {
          const int r = i / vecs_per_row;
          const int c = (i - r * vecs_per_row) * kVec;
          float kf[kVec], vf[kVec];
          unpack(kr[s], kf, T());
          unpack(vr[s], vf, T());
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            ks[r * stride + c + e] = kf[e];
            vs[r * stride + c + e] = vf[e];
          }
        }
      }
    }
    __syncthreads();
    if (!owns_group) continue;

    float mloc = kNeg;
    for (int r = lane; r < nrows; r += 32) {
      const float* kr = ks + r * stride;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s += qg[c] * kr[c];
      s *= scale;
      const int a = t0 * ps + r;
      const bool valid = a <= pos && (window <= 0 || a > pos - window);
      s = valid ? s : kNeg;
      pg[r] = s;
      mloc = fmaxf(mloc, s);
    }
    const float m_new = fmaxf(m, warp_max(mloc));
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
    for (int r = lane; r < nrows; r += 32) {
      const float p = expf(pg[r] - m_new);
      pg[r] = p;
      lsum += p;
    }
    denom = denom * alpha + warp_sum(lsum);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kMaxFeaturesPerLane; ++j) {
      if (j < features) {
        const int c = lane + 32 * j;
        float a = acc[j] * alpha;
        for (int r = 0; r < nrows; ++r) a += pg[r] * vs[r * stride + c];
        acc[j] = a;
      }
    }
    m = m_new;
  }
  if (!owns_group) return;

  T* ob = out + ((static_cast<size_t>(b) * N + n) * G + g) * D;
  const float dn = fmaxf(denom, 1e-30f);
#pragma unroll
  for (int j = 0; j < kMaxFeaturesPerLane; ++j)
    if (j < features) ob[lane + 32 * j] = from_f32<T>(acc[j] / dn);
}

}  // namespace

// q (B,N,G,D), k_pool/v_pool (P,ps,N,D) of one dtype (f32 or bf16), pt
// (B,PP) int32, pos (B,) int32, out (B,N,G,D) of q's dtype; all contiguous
// on the current device, pools 16-byte aligned.  window <= 0 means no
// window.  Needs G <= 16, D % 32 == 0, D <= 256 and one page's rows within
// the 48 KiB of shared memory (the wrapper checks).  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* pt,
                            const void* pos, void* out, int B, int N, int G,
                            int D, int P, int ps, int PP, int window,
                            float scale, int is_bf16, void* stream) {
  if (B == 0 || N == 0) return 0;
  int ch = ps < kMaxChunkRows ? kMaxChunkRows / ps * ps : ps;
  while (ch > ps && 4 * smem_floats(ch, D, G, PP) > kSmemLimit) ch -= ps;
  const size_t smem = sizeof(float) * smem_floats(ch, D, G, PP);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, N);
  const dim3 block(32 * (G < 4 ? 4 : G));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    paged_decode_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(pt), static_cast<const int*>(pos),
        static_cast<__nv_bfloat16*>(out), N, G, D, P, ps, PP, window, scale,
        ch);
  } else {
    paged_decode_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), static_cast<const int*>(pt),
        static_cast<const int*>(pos), static_cast<float*>(out), N, G, D, P,
        ps, PP, window, scale, ch);
  }
  return static_cast<int>(cudaGetLastError());
}
