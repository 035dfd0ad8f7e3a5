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
// n(n+1)m FLOPs of one triangle: bf16 products at the tensor cores' 989
// TFLOP/s, or fp32 at the smaller of the CUDA cores' 67 TFLOP/s for
// n(n+1)m and TF32's 495 TFLOP/s for the three products of 3xTF32.
//
// Design, n <= 128 (K2's path and K4's stage-wise path): latency first.
// Only the upper triangle's 16 x 16 output tiles are launched, one
// 256-thread block each (28 blocks at n = 100), one output per thread;
// each block stages 64-row slices of its two column strips (one strip on
// the diagonal) and writes its tile and the mirror image, so the result is
// exactly symmetric.  Rows past m and columns past n are masked to 0 in
// the load, so the ragged edge adds nothing and nothing is padded in
// device memory.  K2 takes this loop at every c (no path of it takes c >
// 128).
//
// K4 for n > 128: a SYRK on the tensor cores (gram_tc_kernel).  Only the
// upper triangle's 128 x 128 output tiles are launched; each 256-thread
// block takes one tile and one slice of the rows, eight warps of 64 x 32
// with mma.sync m16n8 fragments, fed from a 3-stage ring of shared memory
// (102 KB; two blocks an SM) filled by 16-byte cp.async (ordinary loads
// for rows that are not 16-byte aligned).  A diagonal tile loads its one column strip once.  A first
// version with 64 x 64 tiles, each X element fetched from L2 twice as
// often, was held by those loads at about x.T @ x's time at (4096, 1024).
// At 128 x 128 the fp32 path is held by its products, three mma.sync per
// pair of TF32 fragments: a probe without them ran in under half the time,
// one without loads in nearly all of it.  Three versions of the fp32 path
// on wgmma (K-major TF32 operands split into shared memory; one of them
// warp-specialised; not kept) were no faster or only slightly, and less
// accurate: the split of X into TF32 halves could not keep up with the
// tensor cores.  The rows are cut into ks slices so that the waves of
// resident blocks times the rows of a slice, plus the slices' reduction,
// is least (tc_plan).  With ks > 1 each block writes its tile's partial to
// a workspace the wrapper allocates, and gram_reduce_kernel adds the ks
// partials in slice order (no atomics: the same bits on every run).  Every
// tile is stored where row <= column and mirrored, so the result is
// exactly symmetric.
// - bf16 X: bf16 products on the tensor cores with fp32 accumulators
//   (m16n8k16, operands by ldmatrix.trans from the [row][column] tiles),
//   the TPU kernel's own arithmetic: exact products, fp32 sums.
// - fp32 X: 3xTF32 (m16n8k8).  Each element is split as x = hi + lo
//   exactly, hi = x with its 13 low mantissa bits cleared; the tensor
//   cores read lo as TF32, dropping its own 13 low bits, and the sum takes
//   lo.hi, hi.lo and hi.hi; the lo.lo term (2^-22 of a product) is
//   dropped.  That leaves about 2^-21 of each product against the fp32
//   product, far inside the fp32 bound K4 is held to
//   (tests/test_torch_kernels.py emulates it on the CPU).  Clearing bits
//   costs one instruction where cvt.rna.tf32 costs several, and the
//   split runs on every fragment element.
// In both, the tensor cores sum only a few rows (fp32: the three products
// of 8 rows; bf16: one stage's 64 rows) into a fresh fragment, which is
// then added to the running fp32 sum on the CUDA cores, rounded to
// nearest: the tensor cores' own accumulation rounds toward zero, and over
// thousands of rows of positive terms (the diagonal) that bias adds up
// past the fp32 bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Upper-triangle tile p (row by row) of a t x t grid of tiles.
__device__ __forceinline__ void upper_tile(int p, int t, int& ti, int& tj) {
  ti = 0;
  while (p >= t - ti) {
    p -= t - ti;
    ++ti;
  }
  tj = ti + p;
}

constexpr int kSmallN = 128;   // K4 takes the latency-shaped loop for n <= kSmallN
constexpr int kSyrkTile = 16;  // its output tiles: one output per thread
constexpr int kSyrkSlice = 64; // rows staged per slice

template <typename Load>
__global__ void __launch_bounds__(kSyrkTile * kSyrkTile)
gram_syrk_kernel(Load load, int m, int n, float* __restrict__ out) {
  __shared__ float as[kSyrkSlice][kSyrkTile];
  __shared__ float bs[kSyrkSlice][kSyrkTile];

  int ti, tj;
  upper_tile(blockIdx.x, (n + kSyrkTile - 1) / kSyrkTile, ti, tj);
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

// ------------------------------------------------ K4, n > 128: tensor cores

constexpr int kTcTile = 128;     // output tile (rows and columns)
constexpr int kTcThreads = 256;  // eight warps of 64 x 32
constexpr int kTcStages = 3;
constexpr int kTcPad = 8;        // row padding (elements): conflict-free fragment reads
constexpr int kTcLd = kTcTile + kTcPad;
constexpr int kTcMaxSlices = 64;

template <typename T>
struct TcShape {
  static constexpr int kBk = 128 / sizeof(T);  // rows per stage: 32 fp32, 64 bf16
  static constexpr int kStrip = kBk * kTcLd;   // elements of one column strip
  static constexpr int kSmem = kTcStages * 2 * kStrip * sizeof(T);
  static constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  // 16-byte chunks of one strip's stage, per thread
  static constexpr int kChunks = kBk * (kTcTile / kPer) / kTcThreads;
};

__device__ __forceinline__ void tc_cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) { return __float2bfloat16(0.f); }

// Rows r0 .. r0 + kBk - 1 (below r_end) of columns c0 .. c0 + 127 (below
// n) into dst[row][column]; the rest is zero.  By 16-byte cp.async where
// the rows are 16-byte aligned (async16), else by ordinary loads.
template <typename T>
__device__ __forceinline__ void tc_stage(const T* __restrict__ x, int ld, int r0, int r_end,
                                         int c0, int n, bool async16, T* dst) {
  using S = TcShape<T>;
  if (async16) {
    constexpr int kRowChunks = kTcTile / S::kPer;
#pragma unroll
    for (int l = 0; l < S::kChunks; ++l) {
      const int e = threadIdx.x + l * kTcThreads;
      const int rr = e / kRowChunks;
      const int c = (e - rr * kRowChunks) * S::kPer;
      const int cols = min(S::kPer, n - (c0 + c));
      const bool ok = r0 + rr < r_end && cols > 0;
      const T* src = ok ? x + (size_t)(r0 + rr) * ld + c0 + c : x;
      tc_cp_async16(dst + rr * kTcLd + c, src, ok ? cols * (int)sizeof(T) : 0);
    }
  } else {
    for (int e = threadIdx.x; e < S::kBk * kTcTile; e += kTcThreads) {
      const int rr = e / kTcTile;
      const int c = e - rr * kTcTile;
      dst[rr * kTcLd + c] = (r0 + rr < r_end && c0 + c < n)
                                ? x[(size_t)(r0 + rr) * ld + c0 + c]
                                : zero_of(T());
    }
  }
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float* d, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// x = hi + lo exactly, hi = x with its 13 low mantissa bits cleared (a
// TF32 value); the tensor cores read lo as TF32 too, dropping its own 13
// low bits (2^-21 of x at most).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// One stage's products added to the warp's 64 x 32 sums: acc[4 mt + nt]
// for m16 tiles mt (rows wm + 16 mt) and n8 tiles nt (columns wn + 8 nt).
// a[rr][i] = X[r0 + rr, i0 + i], b[rr][j] = X[r0 + rr, j0 + j].  fp32:
// the three products of every 8 rows go into a fresh fragment (the first
// takes a zero accumulator), which is added to acc on the CUDA cores.
__device__ __forceinline__ void tc_products(const float* a, const float* b, int wm, int wn,
                                            float (*acc)[4]) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < TcShape<float>::kBk; kk += 8) {
    unsigned ahi[4][4], alo[4][4], bhi[4][2], blo[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int i = wm + 16 * mt + gid;
      split_tf32(a[(kk + tig) * kTcLd + i], ahi[mt][0], alo[mt][0]);
      split_tf32(a[(kk + tig) * kTcLd + i + 8], ahi[mt][1], alo[mt][1]);
      split_tf32(a[(kk + tig + 4) * kTcLd + i], ahi[mt][2], alo[mt][2]);
      split_tf32(a[(kk + tig + 4) * kTcLd + i + 8], ahi[mt][3], alo[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = wn + 8 * nt + gid;
      split_tf32(b[(kk + tig) * kTcLd + j], bhi[nt][0], blo[nt][0]);
      split_tf32(b[(kk + tig + 4) * kTcLd + j], bhi[nt][1], blo[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float p[4];
        mma_tf32_zero(p, alo[mt], bhi[nt]);
        mma_tf32(p, ahi[mt], blo[nt]);
        mma_tf32(p, ahi[mt], bhi[nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt * 4 + nt][e] += p[e];
      }
  }
}

__device__ __forceinline__ void tc_products(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                            int wm, int wn, float (*acc)[4]) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;  // the 8 x 8 matrix this lane addresses
  const int r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < TcShape<__nv_bfloat16>::kBk; kk += 16) {
    unsigned af[4][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      // matrices: (rows kk.., cols i..), (kk.., i + 8..), (kk + 8.., i..), (kk + 8.., i + 8..)
      const int row = kk + r + (mi >> 1) * 8;
      const int col = wm + 16 * mt + (mi & 1) * 8;
      ldmatrix_x4_trans(af[mt], a + row * kTcLd + col);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      // matrices: (kk.., j..), (kk + 8.., j..), (kk.., j + 8..), (kk + 8.., j + 8..)
      const int row = kk + r + (mi & 1) * 8;
      const int col = wn + 16 * np + (mi >> 1) * 8;
      unsigned t[4];
      ldmatrix_x4_trans(t, b + row * kTcLd + col);
      bf[2 * np][0] = t[0];
      bf[2 * np][1] = t[1];
      bf[2 * np + 1][0] = t[2];
      bf[2 * np + 1][1] = t[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt * 4 + nt], af[mt], bf[nt]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
gram_tc_kernel(const T* __restrict__ x, int m, int n, int ld, int rows_per, bool async16,
               float* __restrict__ out, float* __restrict__ ws) {
  using S = TcShape<T>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* smem = reinterpret_cast<T*>(tc_smem);

  const int t = (n + kTcTile - 1) / kTcTile;
  const int tiles = t * (t + 1) / 2;
  const int tile = blockIdx.x % tiles;
  const int slice = blockIdx.x / tiles;
  int ti, tj;
  upper_tile(tile, t, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kTcTile;
  const int j0 = tj * kTcTile;
  const int r_begin = slice * rows_per;
  const int r_end = min(m, r_begin + rows_per);
  const int nk = (r_end - r_begin + S::kBk - 1) / S::kBk;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  float acc[16][4];
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) {
      T* st = smem + s * 2 * S::kStrip;
      tc_stage<T>(x, ld, r_begin + s * S::kBk, r_end, i0, n, async16, st);
      if (!diag) tc_stage<T>(x, ld, r_begin + s * S::kBk, r_end, j0, n, async16, st + S::kStrip);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = 0; k < nk; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kTcStages - 2));
    __syncthreads();  // stage k is in; every warp is done with stage k - 1
    const int kn = k + kTcStages - 1;
    if (kn < nk) {
      T* st = smem + (kn % kTcStages) * 2 * S::kStrip;
      tc_stage<T>(x, ld, r_begin + kn * S::kBk, r_end, i0, n, async16, st);
      if (!diag) tc_stage<T>(x, ld, r_begin + kn * S::kBk, r_end, j0, n, async16, st + S::kStrip);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const T* a = smem + (k % kTcStages) * 2 * S::kStrip;
    if constexpr (sizeof(T) == 4) {
      tc_products(a, diag ? a : a + S::kStrip, wm, wn, acc);
    } else {  // bf16: the stage's products in a fresh fragment, then added
      float part[16][4];
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[q][e] = 0.f;
      tc_products(a, diag ? a : a + S::kStrip, wm, wn, part);
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] += part[q][e];
    }
  }

  // c0, c1: row gid, columns 2 tig, 2 tig + 1; c2, c3: row gid + 8
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  float* part = ws == nullptr ? nullptr : ws + ((size_t)slice * tiles + tile) * kTcTile * kTcTile;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = wm + 16 * mt + gid + (e >> 1) * 8;
        const int jj = wn + 8 * nt + 2 * tig + (e & 1);
        const float val = acc[mt * 4 + nt][e];
        if (part != nullptr) {
          part[ii * kTcTile + jj] = val;
        } else {
          const int i = i0 + ii;
          const int j = j0 + jj;
          if (i < n && j < n && i <= j) {
            out[(size_t)i * n + j] = val;
            out[(size_t)j * n + i] = val;
          }
        }
      }
}

// One 256-thread block per 64 x 64 quarter of an upper tile: the sum of
// its ks partials in slice order, stored where i <= j and mirrored.
__global__ void __launch_bounds__(256)
gram_reduce_kernel(const float* __restrict__ ws, int n, int ks, float* __restrict__ out) {
  constexpr int kQ = kTcTile / 2;
  __shared__ float sum[kQ][kQ + 1];
  const int t = (n + kTcTile - 1) / kTcTile;
  const int tiles = t * (t + 1) / 2;
  const int tile = blockIdx.x >> 2;
  const int quarter = blockIdx.x & 3;
  int ti, tj;
  upper_tile(tile, t, ti, tj);
  const int qi = (quarter >> 1) * kQ;
  const int qj = (quarter & 1) * kQ;
  const int i0 = ti * kTcTile + qi;
  const int j0 = tj * kTcTile + qj;
  if (i0 > j0 + kQ - 1) return;  // the lower quarter of a diagonal tile
  for (int e = threadIdx.x; e < kQ * kQ; e += 256) {
    const int a = e / kQ;
    const int b = e % kQ;
    const size_t at = (size_t)(qi + a) * kTcTile + qj + b;
    float acc = 0.f;
    for (int p = 0; p < ks; ++p) acc += ws[((size_t)p * tiles + tile) * kTcTile * kTcTile + at];
    sum[a][b] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kQ * kQ; e += 256) {
    const int a = e / kQ;
    const int b = e % kQ;
    // G[i0 + a, j0 + b] from sum[a][b]; its mirror G[j0 + a, i0 + b] from
    // sum[b][a]; each only from the upper part (row <= column)
    if (i0 + a < n && j0 + b < n && i0 + a <= j0 + b) out[(size_t)(i0 + a) * n + j0 + b] = sum[a][b];
    if (j0 + a < n && i0 + b < n && i0 + b <= j0 + a) out[(size_t)(j0 + a) * n + i0 + b] = sum[b][a];
  }
}

struct TcDevice {
  int sms = 0;
  int fp32_blocks = 0;  // resident blocks per SM of each instantiation
  int bf16_blocks = 0;
};

// The SM count and each kernel's occupancy, once per process; also lifts
// the kernels' dynamic shared-memory limit to their ring's size.
const TcDevice& tc_device() {
  static TcDevice d;
  if (d.sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(gram_tc_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         TcShape<float>::kSmem);
    cudaFuncSetAttribute(gram_tc_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         TcShape<__nv_bfloat16>::kSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.fp32_blocks, gram_tc_kernel<float>,
                                                  kTcThreads, TcShape<float>::kSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.bf16_blocks, gram_tc_kernel<__nv_bfloat16>,
                                                  kTcThreads, TcShape<__nv_bfloat16>::kSmem);
    if (d.sms <= 0) d.sms = 132;
    if (d.fp32_blocks <= 0) d.fp32_blocks = 1;
    if (d.bf16_blocks <= 0) d.bf16_blocks = 1;
  }
  return d;
}

// Row slices of the tensor-core SYRK: the ks (and rows per slice, whole
// stages) that minimise the longest SM's work in stages, waves of
// resident blocks times stages per slice, plus the reduction's share (a
// 128 x 128 fp32 partial per tile and slice, written and read back: about
// two stages' loads), preferring fewer slices unless more cut that by
// over 5%.
void tc_plan(int m, int n, bool bf16, int* ks, int* rows_per) {
  const TcDevice& d = tc_device();
  const int bk = bf16 ? TcShape<__nv_bfloat16>::kBk : TcShape<float>::kBk;
  const long slots = (long)d.sms * (bf16 ? d.bf16_blocks : d.fp32_blocks);
  const int t = (n + kTcTile - 1) / kTcTile;
  const long tiles = (long)t * (t + 1) / 2;
  const int stages = (m + bk - 1) / bk;
  long best = -1;
  for (int k = 1; k <= kTcMaxSlices && k <= stages; ++k) {
    const int per = (stages + k - 1) / k;  // stages per slice
    const int used = (stages + per - 1) / per;
    if (used != k) continue;
    const long span = (tiles * k + slots - 1) / slots * per + (2 * tiles * k + slots - 1) / slots;
    if (best < 0 || span * 100 < best * 95) {
      best = span;
      *ks = k;
      *rows_per = per * bk;
    }
  }
}

template <typename T>
int launch_tc(const T* x, int m, int n, int ld, float* out, float* ws, cudaStream_t st) {
  int ks, rows_per;
  tc_plan(m, n, sizeof(T) == 2, &ks, &rows_per);
  const int t = (n + kTcTile - 1) / kTcTile;
  const int tiles = t * (t + 1) / 2;
  const bool async16 =
      ((size_t)ld * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  gram_tc_kernel<T><<<tiles * ks, kTcThreads, TcShape<T>::kSmem, st>>>(
      x, m, n, ld, rows_per, async16, out, ks > 1 ? ws : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ks == 1) return static_cast<int>(err);
  gram_reduce_kernel<<<tiles * 4, 256, 0, st>>>(ws, n, ks, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Load>
int launch(const Load& load, int m, int n, float* out, void* stream) {
  const int t = (n + kSyrkTile - 1) / kSyrkTile;
  gram_syrk_kernel<Load><<<t * (t + 1) / 2, dim3(kSyrkTile, kSyrkTile), 0,
                           static_cast<cudaStream_t>(stream)>>>(load, m, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The fp32 workspace K4 needs at (m, n), in elements: the tensor-core
// SYRK's row-slice partials when n > 128 and it takes more than one slice,
// else 0.
long long gram_workspace(int m, int n, int is_bf16) {
  if (n <= kSmallN) return 0;
  int ks, rows_per;
  tc_plan(m, n, is_bf16 != 0, &ks, &rows_per);
  if (ks == 1) return 0;
  const long long t = (n + kTcTile - 1) / kTcTile;
  return (long long)ks * (t * (t + 1) / 2) * kTcTile * kTcTile;
}

// Launches K4 on `stream`: x is (m, n) fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1) with row stride ld, out is (n, n) fp32, ws as
// gram_workspace says.  n <= 128 takes the 16 x 16 upper-triangle loop
// that K2 shares; larger n the tensor-core SYRK (and, with several row
// slices, its reduction).  Returns the cudaError_t of the launches.
int gram_plain(const void* x, int is_bf16, int m, int n, int ld, float* out, float* ws,
               void* stream) {
  if (n > kSmallN) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16) return launch_tc(static_cast<const __nv_bfloat16*>(x), m, n, ld, out, ws, st);
    return launch_tc(static_cast<const float*>(x), m, n, ld, out, ws, st);
  }
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
