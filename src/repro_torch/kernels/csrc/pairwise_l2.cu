// K1: pairwise L2 distances with the eq.-(14) sqrt epilogue and masked
// per-tile min/max, and K3: clamped squared L2 distances, for profiles
// F (C, Q).  One tile loop, two epilogues chosen at compile time.
//
// Replaces the TPU kernels
//   K1  src/repro/kernels/pairwise_l2/pairwise_l2.py:pairwise_dists_stats_kernel
//       (body _stats_kernel)
//   K3  src/repro/kernels/pairwise_l2/pairwise_l2.py:pairwise_sq_dists_kernel
//       (body _kernel)
//
// K1 computes S0[i, j] = sqrt(sum_k (f_ik - f_jk)^2), with S0[i, i] = 0 by
// global index, written as an unpadded (C, C) fp32 matrix, and for each
// 64x64 output tile the min and max of S0 over the real C x C region,
// written to tile_min / tile_max (grid_m x grid_n).  The caller reduces
// those to the scalars lo / hi on the device.
//
// K3 computes D2[i, j] = sum_k (f_ik - f_jk)^2 clamped at 0, with
// D2[i, i] = 0 by global index, written as an unpadded (C, C) fp32 matrix:
// the squared sum itself, not K1's distance squared again (sqrt then
// square loses bits and is another function).  K3 accumulates in fp64 and
// rounds once: the fp32 inputs (and bf16 ones, upcast) are exact in fp64,
// so each element is the correctly rounded fp32 of the exact sum, never
// further from an fp64 reference than any fp32 computation of it.  A
// sequential fp32 sum over Q, as K1 takes, grows its error with Q and on
// spread-out inputs ends further from fp64 than the plain chain's blocked
// GEMM; on FC-1 profiles both direct sums beat the plain chain (below).
//
// Bound on an H100 at the main-path shape (C=100, Q=128): the least work
// is 1.3 MFLOP (one triangle of distances) and 0.09 MB of traffic, each
// well under a microsecond; what bounds the call is launch latency.  The
// simple design does about that what it can: one launch computes
// distances and epilogue together (and, for K1, the stats), so no
// intermediate goes back to device memory and K1 needs no second pass over
// S0 for the normalisation scalars.  At C in the thousands K3 is bound by
// its C^2 Q fp64 FMAs on the CUDA cores, at half the fp32 rate.
//
// Design: each 256-thread block owns one 64x64 output tile and walks Q in
// slices of 16, staging the A rows and B rows of the slice in shared memory
// (fp32; bf16 profiles are upcast as they are loaded, as the TPU kernels
// do).  Each thread keeps a 4x4 register micro-tile of sum (a - b)^2, in
// fp32 for K1 and fp64 for K3.  The TPU kernels expand |a|^2 + |b|^2 -
// 2 a.b instead; on profiles that lie close together relative to their
// norms, as FC-1 profiles do, that expansion cancels in fp32, while the
// direct sum loses nothing to cancellation (and its diagonal is exactly 0)
// for one more operation per term.  wgmma and TMA are left for a later
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;                 // output tile edge
constexpr int kSlice = 16;                // Q columns staged per step
constexpr int kThreads = 16;              // 16 x 16 threads per block
constexpr int kMicro = kTile / kThreads;  // 4 x 4 outputs per thread
constexpr int kBlock = kThreads * kThreads;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc + (a - b)^2 in Acc (float for K1, double for K3)
template <typename Acc>
__device__ __forceinline__ Acc add_sq(float a, float b, Acc acc) {
  if constexpr (std::is_same<Acc, float>::value) {
    const float d = a - b;
    return fmaf(d, d, acc);
  } else {
    const double d = static_cast<double>(a) - static_cast<double>(b);
    return fma(d, d, acc);
  }
}

// kStats: K1's epilogue (sqrt, tile min/max), accumulating in fp32;
// otherwise K3's (clamp), accumulating in fp64.
template <typename T, bool kStats>
__global__ void __launch_bounds__(kBlock)
pairwise_kernel(const T* __restrict__ f, int c, int q,
                float* __restrict__ out,
                float* __restrict__ tile_min,
                float* __restrict__ tile_max) {
  __shared__ float as[kSlice][kTile + 1];
  __shared__ float bs[kSlice][kTile + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  using Acc = typename std::conditional<kStats, float, double>::type;
  Acc acc[kMicro][kMicro];
#pragma unroll
  for (int m = 0; m < kMicro; ++m)
#pragma unroll
    for (int n = 0; n < kMicro; ++n) acc[m][n] = 0;

  for (int k0 = 0; k0 < q; k0 += kSlice) {
    // stage F[row0:row0+64, k0:k0+16] and F[col0:col0+64, k0:k0+16],
    // zero-filled past C and Q so the ragged edge adds nothing
#pragma unroll
    for (int l = 0; l < kTile * kSlice / kBlock; ++l) {
      const int e = tid + l * kBlock;
      const int r = e / kSlice;
      const int kk = e % kSlice;
      const int gk = k0 + kk;
      const int ga = row0 + r;
      const int gb = col0 + r;
      as[kk][r] = (ga < c && gk < q) ? to_f32(f[(size_t)ga * q + gk]) : 0.f;
      bs[kk][r] = (gb < c && gk < q) ? to_f32(f[(size_t)gb * q + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      float a[kMicro];
      float b[kMicro];
#pragma unroll
      for (int m = 0; m < kMicro; ++m) a[m] = as[kk][ty + m * kThreads];
#pragma unroll
      for (int n = 0; n < kMicro; ++n) b[n] = bs[kk][tx + n * kThreads];
#pragma unroll
      for (int m = 0; m < kMicro; ++m)
#pragma unroll
        for (int n = 0; n < kMicro; ++n) acc[m][n] = add_sq(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

  if constexpr (!kStats) {
    // K3's epilogue: pin the diagonal by global index, clamp at 0 (a sum of
    // squares is never below it, so only the TPU kernel's expansion needs
    // the clamp; a NaN passes through as it does there)
#pragma unroll
    for (int m = 0; m < kMicro; ++m) {
      const int i = row0 + ty + m * kThreads;
#pragma unroll
      for (int n = 0; n < kMicro; ++n) {
        const int j = col0 + tx + n * kThreads;
        if (i < c && j < c) {
          const double v = acc[m][n];
          out[(size_t)i * c + j] = (i == j || v < 0.0) ? 0.f : static_cast<float>(v);
        }
      }
    }
  } else {
    // K1's epilogue: pin the diagonal by global index -> sqrt, and the min/max
    // of the real region (a sum of squares needs no clamp at 0)
    __shared__ float warp_min[kBlock / 32];
    __shared__ float warp_max[kBlock / 32];
    float lo = INFINITY;
    float hi = -INFINITY;
#pragma unroll
    for (int m = 0; m < kMicro; ++m) {
      const int i = row0 + ty + m * kThreads;
#pragma unroll
      for (int n = 0; n < kMicro; ++n) {
        const int j = col0 + tx + n * kThreads;
        const float v = (i == j) ? 0.f : sqrtf(acc[m][n]);
        if (i < c && j < c) {
          out[(size_t)i * c + j] = v;
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (tid % 32 == 0) {
      warp_min[tid / 32] = lo;
      warp_max[tid / 32] = hi;
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int w = 1; w < kBlock / 32; ++w) {
        lo = fminf(lo, warp_min[w]);
        hi = fmaxf(hi, warp_max[w]);
      }
      const int t = blockIdx.y * gridDim.x + blockIdx.x;
      tile_min[t] = lo;
      tile_max[t] = hi;
    }
  }
}

}  // namespace

extern "C" {

// Number of 64-wide tiles along each side of the (c, c) output: the
// tile_min / tile_max buffers hold tiles * tiles floats.
int pairwise_l2_tiles(int c) { return (c + kTile - 1) / kTile; }

// Launches K1 on `stream`; f is (c, q) row-major fp32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1).  Returns the cudaError_t of the launch.
int pairwise_l2_dists_stats(const void* f, int is_bf16, int c, int q,
                            float* s0, float* tile_min, float* tile_max,
                            void* stream) {
  const int g = pairwise_l2_tiles(c);
  const dim3 grid(g, g);
  const dim3 block(kThreads, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    pairwise_kernel<__nv_bfloat16, true><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(f), c, q, s0, tile_min, tile_max);
  } else {
    pairwise_kernel<float, true><<<grid, block, 0, s>>>(
        static_cast<const float*>(f), c, q, s0, tile_min, tile_max);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K3 on `stream`; f as for K1, d2 is (c, c) fp32.  Returns the
// cudaError_t of the launch.
int pairwise_l2_sq_dists(const void* f, int is_bf16, int c, int q, float* d2,
                         void* stream) {
  const int g = pairwise_l2_tiles(c);
  const dim3 grid(g, g);
  const dim3 block(kThreads, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    pairwise_kernel<__nv_bfloat16, false><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(f), c, q, d2, nullptr, nullptr);
  } else {
    pairwise_kernel<float, false><<<grid, block, 0, s>>>(
        static_cast<const float*>(f), c, q, d2, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pairwise_l2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
