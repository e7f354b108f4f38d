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
// valid slot against 2*D*sizeof(T) bytes of K/V, under 4 flops a byte at
// G=4, far below the card's f32 CUDA-core balance (~20 flops a byte).  The
// least time is (K/V of the valid slots of every row and head + q + out) /
// 3.35 TB/s.
//
// Design.  The TPU grid (B, N, W/tile) carries the softmax state in VMEM
// scratch across its sequential tile axis; blocks on the GPU run in no
// order, so one block owns one (row, KV head) and a loop inside it walks
// the cache.  The loop runs over the row's valid ABSOLUTE positions
// a = lo .. hi rather than over slots, and reads slot a (or a mod W for a
// ring): a >= 0 there, so C's truncating % is a true modulo, and only the
// slots the row attends are read (for a full cache that is 0..pos, not all
// of W).  Any W works: the last chunk simply holds fewer rows, where the
// TPU wrapper shrinks its tile until it divides W.  Each visited slot's
// mask is computed again in registers from pos[b] with a non-negative
// modulo (the reference's formula); for the valid rows it always holds.
// When no slot is valid (pos < 0, or a full cache entirely outside the
// window) the loop visits every slot with all scores at -1e30: starting
// the running max at -1e30, exp(s - m) is then 1 for every slot and the
// output is the mean of V, exactly as the reference's softmax over an
// all-masked row gives.  Otherwise the first chunk's real scores set the
// max, and nothing masked is ever added.
//
// K and V chunks of up to 64 rows are staged in shared memory as f32 with
// 16-byte loads that are all issued before any is used, rows padded to D+1
// floats so that one warp's per-row dot products hit 32 different banks.
// Warp g owns query group g (GQA head h = n*G + g): each lane scores rows
// lane, lane+32, ..., the warp reduces max and sum with shuffles, and each
// lane keeps D/32 output features of the accumulator in registers.
//
// Not done yet (later work): split-K over W when B*N is far below the 132
// SMs (at B=1, N=8 only 8 SMs stream the cache), overlapping the next
// chunk's loads with this chunk's math (cp.async/TMA), and tensor cores
// (wgmma) for the G x D by D x chunk products.

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
__host__ __device__ inline int smem_floats(int ch, int D, int G) {
  return 2 * ch * (D + 1) + G * D + G * ch;
}

// grid (B, N); block 32*max(G, 4) threads; dynamic shared memory
// smem_floats(ch, D, G) floats.
template <typename T>
__global__ void swa_decode_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k_cache,
                                  const T* __restrict__ v_cache,
                                  const int* __restrict__ pos_arr,
                                  T* __restrict__ out, int N, int G, int D,
                                  int W, int window, int ring, float scale,
                                  int ch) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ float smem[];
  const int stride = D + 1;
  float* ks = smem;                  // [ch][D+1]
  float* vs = ks + ch * stride;      // [ch][D+1]
  float* qs = vs + ch * stride;      // [G][D]
  float* probs = qs + G * D;         // [G][ch]

  const int b = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const bool owns_group = g < G;
  const int nthreads = blockDim.x;
  const int pos = pos_arr[b];
  const int features = D / 32;

  // Valid absolute positions [lo, hi]; visited row r reads slot
  // slot_of(lo + r).  With none valid, visit every slot (all masked).
  int lo = ring ? max(pos - W + 1, 0) : 0;
  const int hi = ring ? pos : min(pos, W - 1);
  if (window > 0) lo = max(lo, pos - window + 1);
  int count = hi - lo + 1;
  const bool none_valid = count <= 0;
  if (none_valid) {
    lo = 0;
    count = W;
  }

  const T* qb = q + (static_cast<size_t>(b) * N + n) * G * D;
  for (int i = tid; i < G * D; i += nthreads) qs[i] = to_f32(qb[i]);

  float m = kNeg;
  float denom = 0.f;
  float acc[kMaxFeaturesPerLane];
#pragma unroll
  for (int j = 0; j < kMaxFeaturesPerLane; ++j) acc[j] = 0.f;

  const size_t row_stride = static_cast<size_t>(N) * D;
  const T* kb = k_cache + static_cast<size_t>(b) * W * row_stride +
                static_cast<size_t>(n) * D;
  const T* vb = v_cache + static_cast<size_t>(b) * W * row_stride +
                static_cast<size_t>(n) * D;
  const int vecs_per_row = D / kVec;
  const float* qg = qs + g * D;
  float* pg = probs + g * ch;

  for (int r0 = 0; r0 < count; r0 += ch) {
    const int nrows = min(ch, count - r0);
    const int nvec = nrows * vecs_per_row;
    __syncthreads();  // q staged; the previous chunk is consumed
    for (int base = tid; base < nvec; base += kStage * nthreads) {
      uint4 kr[kStage], vr[kStage];
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int i = base + s * nthreads;
        if (i < nvec) {
          const int r = i / vecs_per_row;
          const int c = (i - r * vecs_per_row) * kVec;
          const int a = lo + r0 + r;  // >= 0: a plain % is a modulo here
          const int slot = (ring && !none_valid) ? a % W : a;
          const size_t off = static_cast<size_t>(slot) * row_stride + c;
          kr[s] = *reinterpret_cast<const uint4*>(kb + off);
          vr[s] = *reinterpret_cast<const uint4*>(vb + off);
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
      // The slot's absolute position and mask, from pos alone.
      const int a0 = lo + r0 + r;
      const int j = (ring && !none_valid) ? a0 % W : a0;
      int a = j;
      if (ring) {
        int md = (pos - j) % W;
        if (md < 0) md += W;
        a = pos - md;
      }
      const bool valid =
          a >= 0 && a <= pos && (window <= 0 || a > pos - window);
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
    for (int jf = 0; jf < kMaxFeaturesPerLane; ++jf) {
      if (jf < features) {
        const int c = lane + 32 * jf;
        float a = acc[jf] * alpha;
        for (int r = 0; r < nrows; ++r) a += pg[r] * vs[r * stride + c];
        acc[jf] = a;
      }
    }
    m = m_new;
  }
  if (!owns_group) return;

  T* ob = out + ((static_cast<size_t>(b) * N + n) * G + g) * D;
  const float dn = fmaxf(denom, 1e-30f);
#pragma unroll
  for (int jf = 0; jf < kMaxFeaturesPerLane; ++jf)
    if (jf < features) ob[lane + 32 * jf] = from_f32<T>(acc[jf] / dn);
}

}  // namespace

// q (B,N,G,D), k_cache/v_cache (B,W,N,D) of one dtype (f32 or bf16), pos
// (B,) int32, out (B,N,G,D) of q's dtype; all contiguous on the current
// device, caches 16-byte aligned.  window <= 0 means no window; ring != 0
// reads the cache as a ring buffer.  Needs G <= 16 (at 72-80 registers a
// thread, 32 warps do not fit an SM), D % 32 == 0, D <= 256 and q's rows
// within the 48 KiB of shared memory (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int swa_decode(const void* q, const void* k_cache,
                          const void* v_cache, const void* pos, void* out,
                          int B, int N, int G, int D, int W, int window,
                          int ring, float scale, int is_bf16, void* stream) {
  if (B == 0 || N == 0) return 0;
  int ch = kMaxChunkRows;
  while (ch > 1 && 4 * smem_floats(ch, D, G) > kSmemLimit) ch /= 2;
  const size_t smem = sizeof(float) * smem_floats(ch, D, G);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, N);
  const dim3 block(32 * (G < 4 ? 4 : G));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    swa_decode_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_cache),
        static_cast<const __nv_bfloat16*>(v_cache),
        static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), N, G,
        D, W, window, ring, scale, ch);
  } else {
    swa_decode_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_cache),
        static_cast<const float*>(v_cache), static_cast<const int*>(pos),
        static_cast<float*>(out), N, G, D, W, window, ring, scale, ch);
  }
  return static_cast<int>(cudaGetLastError());
}
