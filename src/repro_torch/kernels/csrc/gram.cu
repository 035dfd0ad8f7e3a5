// K2: the eq.-(14) normalise step fused into the Gram product L = S^T S.
//
// Replaces the TPU kernel
//   src/repro/kernels/gram/gram.py:normalized_gram_kernel
//   (body _norm_gram_body).
//
// Takes the distance matrix S0 from K1 (row stride ld >= c; only its
// leading c x c block is read) and the scalars lo and rng = max(hi - lo,
// 1e-30), both read from device memory so that no host round trip sits
// between the two launches.  Every S0 element is normalised as it is
// loaded, S = 1 - (S0 - lo) / rng, rows r >= c are zero, and
// L[i, j] = sum_r S[r, i] S[r, j] is written as a (c, c) fp32 matrix.  With
// round_bf16 set (bf16 profiles) S is rounded to bf16 before the product,
// as the TPU kernel feeds bf16 to its matrix unit; the product of two bf16
// values is exact in fp32 and the sum is kept in fp32.
//
// Bound on an H100 at the main-path shape (c=100): 2 MFLOP and 80 KB of
// traffic, far below a microsecond of either; what bounds the call is
// launch latency.  The simple design keeps S out of device memory, so the
// whole normalise-and-Gram chain is this one launch.
//
// Design: each 256-thread block owns one 64x64 tile of L and walks the
// rows r < c in slices of 16, staging S[r, i-tile] and S[r, j-tile] in
// shared memory (both reads are contiguous along a row of S0), with a 4x4
// fp32 register micro-tile per thread.  wgmma and TMA are left for a later
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kSlice = 16;
constexpr int kThreads = 16;
constexpr int kMicro = kTile / kThreads;
constexpr int kBlock = kThreads * kThreads;

template <bool kRoundBf16>
__device__ __forceinline__ float similarity(float s0, float lo, float rng) {
  const float s = 1.f - (s0 - lo) / rng;
  if (kRoundBf16) return __bfloat162float(__float2bfloat16(s));
  return s;
}

template <bool kRoundBf16>
__global__ void __launch_bounds__(kBlock)
normalized_gram_kernel(const float* __restrict__ s0, int ld, int c,
                       const float* __restrict__ lo_ptr,
                       const float* __restrict__ rng_ptr,
                       float* __restrict__ out) {
  __shared__ float as[kSlice][kTile];
  __shared__ float bs[kSlice][kTile];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const float lo = *lo_ptr;
  const float rng = *rng_ptr;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int m = 0; m < kMicro; ++m)
#pragma unroll
    for (int n = 0; n < kMicro; ++n) acc[m][n] = 0.f;

  for (int r0 = 0; r0 < c; r0 += kSlice) {
#pragma unroll
    for (int l = 0; l < kTile * kSlice / kBlock; ++l) {
      const int e = tid + l * kBlock;
      const int rr = e / kTile;
      const int x = e % kTile;
      const int r = r0 + rr;
      const int gi = i0 + x;
      const int gj = j0 + x;
      // rows r >= c are zero, so the ragged edge adds nothing to L
      as[rr][x] = (r < c && gi < c)
                      ? similarity<kRoundBf16>(s0[(size_t)r * ld + gi], lo, rng)
                      : 0.f;
      bs[rr][x] = (r < c && gj < c)
                      ? similarity<kRoundBf16>(s0[(size_t)r * ld + gj], lo, rng)
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kSlice; ++rr) {
      float a[kMicro];
      float b[kMicro];
#pragma unroll
      for (int m = 0; m < kMicro; ++m) a[m] = as[rr][ty + m * kThreads];
#pragma unroll
      for (int n = 0; n < kMicro; ++n) b[n] = bs[rr][tx + n * kThreads];
#pragma unroll
      for (int m = 0; m < kMicro; ++m)
#pragma unroll
        for (int n = 0; n < kMicro; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kMicro; ++m) {
    const int i = i0 + ty + m * kThreads;
#pragma unroll
    for (int n = 0; n < kMicro; ++n) {
      const int j = j0 + tx + n * kThreads;
      if (i < c && j < c) out[(size_t)i * c + j] = acc[m][n];
    }
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream`.  Returns the cudaError_t of the launch.
int gram_normalized(const float* s0, int ld, int c, const float* lo,
                    const float* rng, int round_bf16, float* out,
                    void* stream) {
  const int g = (c + kTile - 1) / kTile;
  const dim3 grid(g, g);
  const dim3 block(kThreads, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (round_bf16) {
    normalized_gram_kernel<true><<<grid, block, 0, s>>>(s0, ld, c, lo, rng, out);
  } else {
    normalized_gram_kernel<false><<<grid, block, 0, s>>>(s0, ld, c, lo, rng, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
