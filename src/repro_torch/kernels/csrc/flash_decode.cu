// K5: single-query GQA decode attention against a KV cache, with a valid
// length per slot (flash-decode).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/decode.py:flash_decode_kernel
//   (body _decode_kernel).
//
// q (B, 1, H, hd), k and v (B, S, Hk, hd), all fp32 or all bf16, lengths
// (B,) int32 -> out (B, 1, H, hd) in q's type.  Query head h reads KV head
// h / G (G = H / Hk).  Slot b attends its first min(lengths[b], S) cache
// entries with scale hd^-0.5; the math is fp32 throughout (inputs are
// widened as they are staged), with an online softmax over KV tiles.  A
// slot of length 0 returns zeros.
//
// Bound on an H100: every valid K/V entry is read once and does 4 FLOPs
// per query row and dimension, G <= 8 rows on the main path, so the call
// is bound by bytes: the valid K/V prefix, sum_b len_b * Hk * hd * 2
// tensors * itemsize, over 3.35 TB/s.  The design reads each valid K/V
// tile exactly once per (slot, KV head) and skips tiles past the slot's
// length, so a ragged batch moves only its valid prefix.
//
// Design: one 128-thread block per (slot b, KV head, group of up to 8 of
// its G query rows).  The block walks the valid prefix in tiles of BK
// positions (64 for hd <= 64, 32 for hd <= 128, 16 for hd <= 256): it stages
// the K and V tile in shared memory as fp32 (16-byte vector loads when the
// rows allow), computes the G x BK scores, updates the running max and sum
// of each row (one warp per row), and rescales and accumulates P·V in
// registers.  Known weakness: only B * Hk blocks run (80 at B=16, Hk=5,
// 5 for one long slot), fewer than the 132 SMs, and the loads are not
// overlapped with compute; splitting the KV axis across blocks and
// pipelining the tiles are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // query rows per block
constexpr int kMaxHd = 256;
constexpr int kMaxBk = 64;
constexpr int kKStride = 4160;  // >= BK * (hd + 1) for every hd <= 256
constexpr int kVElems = 4096;   // >= BK * hd
constexpr int kAcc = kRows * kMaxHd / kThreads;
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T as fp32 values.
__device__ __forceinline__ void widen16(const float* src, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage rows s0 .. s0 + bk - 1 of one KV head (row r at src + r * row_stride)
// into dst as fp32 with row stride ld; rows at or past len are zero.
template <typename T, bool kVec>
__device__ void stage_tile(const T* __restrict__ src, size_t row_stride,
                           int s0, int bk, int len, int hd, float* dst, int ld) {
  if (kVec) {
    constexpr int kV = 16 / sizeof(T);
    const int per_row = hd / kV;
    for (int e = threadIdx.x; e < bk * per_row; e += kThreads) {
      const int j = e / per_row;
      const int c = (e - j * per_row) * kV;
      float vals[kV];
      if (s0 + j < len) {
        widen16(src + (size_t)(s0 + j) * row_stride + c, vals);
      } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) vals[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kV; ++i) dst[j * ld + c + i] = vals[i];
    }
  } else {
    for (int e = threadIdx.x; e < bk * hd; e += kThreads) {
      const int j = e / hd;
      const int d = e - j * hd;
      dst[j * ld + d] =
          (s0 + j < len) ? widen(src[(size_t)(s0 + j) * row_stride + d]) : 0.f;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int s, int h, int hk, int hd,
                    float scale) {
  __shared__ float ks[kKStride];
  __shared__ float vs[kVElems];
  __shared__ float qs[kRows * kMaxHd];
  __shared__ float ss[kRows * kMaxBk];
  __shared__ float m_s[kRows];
  __shared__ float l_s[kRows];
  __shared__ float alpha_s[kRows];

  const int g = h / hk;
  const int chunks = (g + kRows - 1) / kRows;
  const int chunk = blockIdx.x % chunks;
  const int kvh = (blockIdx.x / chunks) % hk;
  const int b = blockIdx.x / (chunks * hk);
  const int g0 = chunk * kRows;
  const int gc = min(kRows, g - g0);
  const int head0 = kvh * g + g0;  // first query head of this block
  const int bk = hd <= 64 ? 64 : (hd <= 128 ? 32 : 16);
  const int ldk = hd + 1;  // odd row stride: score reads hit distinct banks
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > s ? s : len);

  const T* qrow = q + ((size_t)b * h + head0) * hd;
  for (int e = tid; e < gc * hd; e += kThreads) qs[e] = widen(qrow[e]) * scale;
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  const size_t row_stride = (size_t)hk * hd;
  const T* kbase = k + (size_t)b * s * row_stride + (size_t)kvh * hd;
  const T* vbase = v + (size_t)b * s * row_stride + (size_t)kvh * hd;

  for (int s0 = 0; s0 < len; s0 += bk) {
    stage_tile<T, kVec>(kbase, row_stride, s0, bk, len, hd, ks, ldk);
    stage_tile<T, kVec>(vbase, row_stride, s0, bk, len, hd, vs, hd);
    __syncthreads();

    // scores of the gc rows against the bk positions, masked past len
    for (int e = tid; e < gc * bk; e += kThreads) {
      const int r = e / bk;
      const int j = e - r * bk;
      const float* qr = qs + r * hd;
      const float* kr = ks + j * ldk;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      ss[r * kMaxBk + j] = (s0 + j < len) ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < gc; r += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, ss[r * kMaxBk + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const float p = expf(ss[r * kMaxBk + j] - m_cur);
        ss[r * kMaxBk + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; thread owns (row, dim) pairs tid + i * 128
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < gc * hd) {
        const int r = e / hd;
        const int d = e - r * hd;
        const float* pr = ss + r * kMaxBk;
        float a = acc[i] * alpha_s[r];
        for (int j = 0; j < bk; ++j) a = fmaf(pr[j], vs[j * hd + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  T* orow = out + ((size_t)b * h + head0) * hd;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < gc * hd) {
      const float l = l_s[e / hd];
      orow[e] = narrow<T>(acc[i] / (l == 0.f ? 1.f : l));  // empty slot -> 0
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int b, int s, int h, int hk, int hd, float scale,
           cudaStream_t stream) {
  const int chunks = (h / hk + kRows - 1) / kRows;
  const dim3 grid(b * hk * chunks);
  const bool vec = (hd * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (vec) {
    flash_decode_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, lengths, ot, s, h, hk, hd, scale);
  } else {
    flash_decode_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, lengths, ot, s, h, hk, hd, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K5 on `stream`.  q (b, 1, h, hd), k and v (b, s, hk, hd), out like
// q, all contiguous and of one type (bf16 if is_bf16 else fp32); lengths
// (b,) int32 on the device.  The caller checks h % hk == 0, 1 <= hd <= 256
// and b, s >= 1.  Returns the cudaError_t of the launch.
int flash_decode(const void* q, const void* k, const void* v,
                 const int* lengths, void* out, int is_bf16, int b, int s,
                 int h, int hk, int hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, lengths, out, b, s, h, hk, hd, scale, st);
  }
  return launch<float>(q, k, v, lengths, out, b, s, h, hk, hd, scale, st);
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
