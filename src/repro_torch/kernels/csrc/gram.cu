// K4: the Gram product X^T X, and K2: the eq.-(14) normalise step fused
// into the Gram product L = S^T S.  Two tiled loops, two loads.
//
// Replaces the TPU kernels
//   K4  src/repro/kernels/gram/gram.py:gram_kernel (body _gram_body)
//   K2  src/repro/kernels/gram/gram.py:normalized_gram_kernel
//       (body _norm_gram_body)
//
// K4 takes X (m, n), fp32 or bf16, row stride ld >= n, and writes
// G[i, j] = sum_r X[r, i] X[r, j] as an (n, n) fp32 matrix.  bf16 values
// are upcast as they are loaded: the product of two bf16 values is exact
// in fp32 and the sum is fp32, as the TPU kernel's matrix unit gives with
// preferred_element_type=float32.
//
// K2 takes the distance matrix S0 from K1 (row stride ld >= c; only its
// leading c x c block is read) and the scalars lo and rng = max(hi - lo,
// 1e-30), both read from device memory so that no host round trip sits
// between the two launches.  Every S0 element is normalised once as it is
// loaded, S = 1 - (S0 - lo) / rng, and L = S^T S is written as a (c, c)
// fp32 matrix: K2 is K4 with a normalising load.  The quotient is the
// correctly rounded one, as the plain version's division gives, from 1/rng
// formed once per thread and one FMA correction (Markstein).  With
// round_bf16 set (bf16 profiles) S is rounded to bf16 before the product,
// as the TPU kernel feeds bf16 to its matrix unit; the sum is kept in fp32.
//
// Bound on an H100: at the main-path shape (c=100) K2 is 2 MFLOP and 80 KB
// of traffic, far below a microsecond of either; what bounds the call is
// latency: the launch, the host's work before it, and the depth of each
// block's serial loop.  At (m, n) in the thousands K4 is bound by its
// n^2 m fp32 FMAs on the CUDA cores.
//
// Design, n <= 128 (K2's path and K4's stage-wise path): latency first.
// Only the upper triangle's 16 x 16 output tiles are launched, one
// 256-thread block each (28 blocks at n = 100, against 4 of the 64 x 64
// loop), one output per thread; each block stages 64-row slices of its two
// column strips (one strip on the diagonal) and writes its tile and the
// mirror image, so the result is exactly symmetric.  Larger n: each
// 256-thread block owns one 64 x 64 output tile and walks the rows in
// slices of 16 with a 4 x 4 fp32 register micro-tile per thread (both
// triangles; G[i, j] and G[j, i] sum the same products in the same order,
// so this result is exactly symmetric too).  In both, rows past m and
// columns past n are masked to 0 in the load, so the ragged edge adds
// nothing and nothing is padded in device memory.  Tensor cores (a 3xTF32
// SYRK for K4's large shapes) are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kSlice = 16;
constexpr int kThreads = 16;
constexpr int kMicro = kTile / kThreads;
constexpr int kBlock = kThreads * kThreads;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// K4's load: X[r, col] upcast to fp32.
template <typename T>
struct PlainLoad {
  const T* x;
  int ld;
  __device__ void init() {}
  __device__ float operator()(int r, int col) const {
    return to_f32(x[(size_t)r * ld + col]);
  }
};

// K2's load: the eq.-(14) similarity of S0[r, col], rounded to bf16 when
// kRoundBf16; init() reads lo and rng once per thread.
template <bool kRoundBf16>
struct NormalizedLoad {
  const float* s0;
  int ld;
  const float* lo_ptr;
  const float* rng_ptr;
  float lo;
  float rng;
  float inv;
  __device__ void init() {
    lo = *lo_ptr;
    rng = *rng_ptr;
    inv = 1.f / rng;
  }
  __device__ float operator()(int r, int col) const {
    // (S0 - lo) / rng, correctly rounded: q = d * inv, then q += (d - q rng) inv
    const float d = s0[(size_t)r * ld + col] - lo;
    const float q = d * inv;
    const float s = 1.f - fmaf(fmaf(-q, rng, d), inv, q);
    if (kRoundBf16) return __bfloat162float(__float2bfloat16(s));
    return s;
  }
};

template <typename Load>
__global__ void __launch_bounds__(kBlock)
gram_kernel(Load load, int m, int n, float* __restrict__ out) {
  __shared__ float as[kSlice][kTile];
  __shared__ float bs[kSlice][kTile];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  load.init();

  float acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.f;

  for (int r0 = 0; r0 < m; r0 += kSlice) {
#pragma unroll
    for (int l = 0; l < kTile * kSlice / kBlock; ++l) {
      const int e = tid + l * kBlock;
      const int rr = e / kTile;
      const int x = e % kTile;
      const int r = r0 + rr;
      const int gi = i0 + x;
      const int gj = j0 + x;
      // rows r >= m and columns >= n are zero, so the ragged edge adds
      // nothing to the product
      as[rr][x] = (r < m && gi < n) ? load(r, gi) : 0.f;
      bs[rr][x] = (r < m && gj < n) ? load(r, gj) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kSlice; ++rr) {
      float a[kMicro];
      float b[kMicro];
#pragma unroll
      for (int t = 0; t < kMicro; ++t) a[t] = as[rr][ty + t * kThreads];
#pragma unroll
      for (int t = 0; t < kMicro; ++t) b[t] = bs[rr][tx + t * kThreads];
#pragma unroll
      for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < kMicro; ++u) {
    const int i = i0 + ty + u * kThreads;
#pragma unroll
    for (int v = 0; v < kMicro; ++v) {
      const int j = j0 + tx + v * kThreads;
      if (i < n && j < n) out[(size_t)i * n + j] = acc[u][v];
    }
  }
}

constexpr int kSmallN = 128;   // the latency-shaped loop takes n <= kSmallN
constexpr int kSyrkTile = 16;  // its output tiles: one output per thread
constexpr int kSyrkSlice = 64; // rows staged per slice

template <typename Load>
__global__ void __launch_bounds__(kSyrkTile * kSyrkTile)
gram_syrk_kernel(Load load, int m, int n, float* __restrict__ out) {
  __shared__ float as[kSyrkSlice][kSyrkTile];
  __shared__ float bs[kSyrkSlice][kSyrkTile];

  // block p -> upper-triangle tile (ti, tj), ti <= tj, row by row
  const int tiles = (n + kSyrkTile - 1) / kSyrkTile;
  int p = blockIdx.x;
  int ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const bool diag = ti == tj;
  const int i0 = ti * kSyrkTile;
  const int j0 = tj * kSyrkTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kSyrkTile + tx;
  const float(*bsrc)[kSyrkTile] = diag ? as : bs;
  load.init();

  float acc = 0.f;
  for (int r0 = 0; r0 < m; r0 += kSyrkSlice) {
#pragma unroll
    for (int l = 0; l < kSyrkSlice * kSyrkTile / (kSyrkTile * kSyrkTile); ++l) {
      const int e = tid + l * kSyrkTile * kSyrkTile;
      const int rr = e / kSyrkTile;
      const int x = e % kSyrkTile;
      const int r = r0 + rr;
      as[rr][x] = (r < m && i0 + x < n) ? load(r, i0 + x) : 0.f;
      if (!diag) bs[rr][x] = (r < m && j0 + x < n) ? load(r, j0 + x) : 0.f;
    }
    __syncthreads();
    const int rows = min(kSyrkSlice, m - r0);
    for (int rr = 0; rr < rows; ++rr) acc = fmaf(as[rr][ty], bsrc[rr][tx], acc);
    __syncthreads();
  }

  const int i = i0 + ty;
  const int j = j0 + tx;
  if (i < n && j < n && (!diag || i <= j)) {
    out[(size_t)i * n + j] = acc;
    out[(size_t)j * n + i] = acc;
  }
}

template <typename Load>
int launch(const Load& load, int m, int n, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kSmallN) {
    const int t = (n + kSyrkTile - 1) / kSyrkTile;
    gram_syrk_kernel<Load><<<t * (t + 1) / 2, dim3(kSyrkTile, kSyrkTile), 0, st>>>(load, m, n, out);
  } else {
    const int g = (n + kTile - 1) / kTile;
    gram_kernel<Load><<<dim3(g, g), dim3(kThreads, kThreads), 0, st>>>(load, m, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K4 on `stream`: x is (m, n) fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1) with row stride ld, out is (n, n) fp32.  Returns the
// cudaError_t of the launch.
int gram_plain(const void* x, int is_bf16, int m, int n, int ld, float* out,
               void* stream) {
  if (is_bf16) {
    return launch(PlainLoad<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(x), ld},
                  m, n, out, stream);
  }
  return launch(PlainLoad<float>{static_cast<const float*>(x), ld}, m, n, out, stream);
}

// Launches K2 on `stream`.  Returns the cudaError_t of the launch.
int gram_normalized(const float* s0, int ld, int c, const float* lo,
                    const float* rng, int round_bf16, float* out,
                    void* stream) {
  if (round_bf16) {
    return launch(NormalizedLoad<true>{s0, ld, lo, rng, 0.f, 0.f}, c, c, out, stream);
  }
  return launch(NormalizedLoad<false>{s0, ld, lo, rng, 0.f, 0.f}, c, c, out, stream);
}

const char* gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
