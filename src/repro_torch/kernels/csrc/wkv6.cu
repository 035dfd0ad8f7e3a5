// K7: the RWKV-6 (Finch) WKV recurrence with data-dependent decay.
//
// Replaces the TPU kernel
//   src/repro/kernels/rwkv6_scan/rwkv6_scan.py:wkv6_kernel (body _kernel).
//
// r, k, v (B, T, H, hd), all fp32 or all bf16; w (B, T, H, hd) fp32 decay
// in (0, 1); u (H, hd) fp32; s0 (B, H, hd, hd) fp32 -> y (B, T, H, hd) in
// r's type and s_out (B, H, hd, hd) fp32.  Per (b, h), from S = s0:
//   y_t = r_t^T (S + diag(u * k_t) v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// all in fp32 (inputs are widened as they are staged); y is rounded once
// to r's type.
//
// Bound on an H100: the function needs 5 hd^2 + 4 hd fp32 operations per
// (b, t, h) (r^T S, the update w_i S_ij + k_i v_j, and the bonus taken as
// (r . (u * k)) v; this kernel spends 7 hd^2, three FMAs and a product per
// element of S, as it adds the bonus u_i k_i v_j element by element), done
// in order over t.  At decode (T = 1) the call is bound by bytes, the fp32
// state read and written once, 2 * B * H * hd^2 * 4 (33.5 MB at B = 16,
// H = hd = 64), over 3.35 TB/s.  At prefill it is bound by the sequential
// dependence over T: only B * H blocks can run (64 for one prompt of
// rwkv6-7b, for 132 SMs), each with hd threads, and every step waits for
// the one before.
//
// Design: one block of hd threads per (b, h).  Thread j owns column j of
// S in hd fp32 registers, for the whole call.  The block stages kChunk
// tokens at a time in shared memory, so one pair of barriers serves
// kChunk steps: for each token and row i one float4 {r_i, u_i k_i, k_i,
// w_i} (one 16-byte broadcast load per row and step) and v_t.  Then each
// step is, for thread j,
//   y_j = sum_i r_i (S_ij + (u_i k_i) v_j),   S_ij <- w_i S_ij + k_i v_j.
// The TPU kernel's sequential grid axis over time chunks becomes the
// loop over chunks inside the block; the loop is bounded by T, so the
// Pallas padding of T (w = 1, k = 0) is not carried over.
//
// Known weakness (a later perf_opt): at prefill 64 blocks of 2 warps leave
// most of the card idle and each step is a chain of hd dependent FMAs per
// thread.  The chunked form (intra-chunk products r K^T and P V on tensor
// cores, the state carried between chunks) and more than one block per
// head (a split of the value columns) would fill it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // tokens staged per pair of barriers

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

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int t_len, int h) {
  __shared__ float4 rkw[kChunk][HD];  // {r_i, u_i k_i, k_i, w_i}
  __shared__ float vs[kChunk][HD];

  const int j = threadIdx.x;
  const int bh = blockIdx.x;  // b * h + head
  const int b = bh / h;
  const int head = bh - b * h;
  const float u_j = u[head * HD + j];

  // column j of S
  float s[HD];
  const float* s_in = s0 + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s_in[i * HD + j];

  // token t of this (b, head) starts at base + t * row
  const size_t row = (size_t)h * HD;
  const size_t base = ((size_t)b * t_len * h + head) * HD;

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int tc = min(kChunk, t_len - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = 0; e < tc; ++e) {
      const size_t idx = base + (size_t)(t0 + e) * row + j;
      const float kj = widen(k[idx]);
      rkw[e][j] = make_float4(widen(r[idx]), u_j * kj, kj, w[idx]);
      vs[e][j] = widen(v[idx]);
    }
    __syncthreads();
    for (int e = 0; e < tc; ++e) {
      const float vj = vs[e][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float4 q = rkw[e][i];
        acc = fmaf(q.x, fmaf(q.y, vj, s[i]), acc);
        s[i] = fmaf(q.w, s[i], q.z * vj);
      }
      y[base + (size_t)(t0 + e) * row + j] = narrow<T>(acc);
    }
  }

  float* s_dst = s_out + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) s_dst[i * HD + j] = s[i];
}

template <typename T, int HD>
int launch_hd(const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, void* y, float* s_out, int b,
              int t, int h, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<b * h, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, t, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out, int b,
           int t, int h, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8:
      return launch_hd<T, 8>(r, k, v, w, u, s0, y, s_out, b, t, h, stream);
    case 16:
      return launch_hd<T, 16>(r, k, v, w, u, s0, y, s_out, b, t, h, stream);
    case 32:
      return launch_hd<T, 32>(r, k, v, w, u, s0, y, s_out, b, t, h, stream);
    case 64:
      return launch_hd<T, 64>(r, k, v, w, u, s0, y, s_out, b, t, h, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches K7 on `stream`.  r, k, v and y (b, t, h, hd) of one type (bf16
// if is_bf16 else fp32), w (b, t, h, hd), u (h, hd), s0 and s_out
// (b, h, hd, hd) fp32, all contiguous.  The caller checks hd in
// {8, 16, 32, 64} and b, t, h >= 1.  Returns the cudaError_t of the launch.
int wkv6(const void* r, const void* k, const void* v, const float* w,
         const float* u, const float* s0, void* y, float* s_out, int is_bf16,
         int b, int t, int h, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, b, t, h, hd, st);
  }
  return launch<float>(r, k, v, w, u, s0, y, s_out, b, t, h, hd, st);
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
