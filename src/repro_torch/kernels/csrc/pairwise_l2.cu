// K1: pairwise L2 distances with the eq.-(14) sqrt epilogue and the min,
// max and range of the result, and K3: clamped squared L2 distances, for
// profiles F (C, Q).  One tile loop, two epilogues chosen at compile time.
//
// Replaces the TPU kernels
//   K1  src/repro/kernels/pairwise_l2/pairwise_l2.py:pairwise_dists_stats_kernel
//       (body _stats_kernel)
//   K3  src/repro/kernels/pairwise_l2/pairwise_l2.py:pairwise_sq_dists_kernel
//       (body _kernel)
//
// Both sum D[i, j] = sum_k (f_ik - f_jk)^2 in fp64 and round once: the fp32
// inputs (and bf16 ones, upcast as they are loaded) are exact in fp64, the
// difference of two of them is exact in fp64 (for exponents within 29 of
// each other), and a sum of squares never cancels, so each element lies
// within about Q fp64 ulps of the exact sum before its one rounding to
// fp32.  A sequential fp32 sum grows its error with Q and on spread-out
// inputs ends further from fp64 than the plain chain's blocked GEMM.
//
// K3 writes D2[i, j] = D[i, j] clamped at 0, D2[i, i] = 0 by global index,
// as an unpadded (C, C) fp32 matrix.  K1 writes S0 = sqrtf(D2) (so S0 is
// the fp32 square root of K3's D2 bit for bit) and, in the same launch,
// stats[0..2] = lo, hi, max(hi - lo, 1e-30): the min and max of S0 over
// the real C x C region and the range eq. (14) divides by, the same bits
// as torch.clamp_min(hi - lo, 1e-30).  K2 reads lo and the range from
// there, so the profiles -> DPP-kernel pipeline is two launches.
//
// Bound on an H100: at the paths' shapes (C = 100, Q = 128 ... 4,096; C =
// 10, Q = 960) the least work is at most 41 MFLOP (one triangle of dot
// products: 0.62 us at the fp32 rate) and 1.7 MB (0.5 us), while a call
// takes microseconds, so what bounds it is latency: how many SMs share the
// work, how long each waits on its loads, the cluster's barriers and the
// launch.  At C in the thousands the kernels are bound by their C^2 Q / 2
// fp64 subtractions and FMAs on the CUDA cores (64 fp64 lanes an SM).
//
// Design:
// - Output tiles T x T (T = 16 at C <= 128, 32 at C <= 1,024, else 64),
//   the upper triangle of the tile grid only, walked row by row.  Each
//   tile writes (i, j) and (j, i) from the one value, so D2 and S0 are
//   exactly symmetric; a diagonal tile reads one operand for both sides.
// - Q split over the S blocks of a thread-block cluster (S in {1, 2, 4,
//   8}, pairwise_l2_plan): rank r sums its own range [r Q / S, (r + 1) Q
//   / S) into a shared-memory partial; after cluster.sync() rank 0 adds
//   the peers' partials, read through distributed shared memory, in rank
//   order, and runs the epilogue; a second cluster.sync() keeps the peers'
//   shared memory alive until it has.  S is the smallest that gives the
//   grid one wave of the 132 SMs, with at least 32 terms a rank.
// - A block of 256 threads: G groups, each holding an M x M register
//   micro-tile of the whole T x T tile (T = 16: 4 groups of 64 threads,
//   2 x 2; T = 32: 1 group, 2 x 2; T = 64: 1 group, 4 x 4).  Group g sums
//   the terms k = lo + g, lo + g + G, ... of its rank's range [lo, hi) in
//   increasing k; the G partials are added in group order.  Every order of
//   addition is fixed by the plan, so a result is the same bits on every
//   call: no float atomics and no global workspace for partials.
// - Slices of 1,024 / T columns of both operand rows are staged as fp64 in
//   shared memory (two stages; rows padded to an odd number of doubles, so
//   neither the stores nor the column reads conflict), the next slice's
//   global loads in flight while the current one is summed.  (Two slices'
//   loads in flight measured no faster.)
// - K1's statistics: each tile's rank-0 block reduces its tile's min and
//   max as it stores them; the last tile to take a ticket (an acq_rel
//   fetch_add on a counter: the release publishes the tile's stats, the
//   acquire sees every other tile's) reduces all the tiles', writes
//   stats[0..2] and resets the ticket to 0 for the next launch on its
//   stream.  (Taking the ticket before the stores, to overlap its round
//   trips with them, measured slower; __threadfence and a relaxed
//   atomicAdd measured 6% slower at C = 100.)

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSms = 132;       // the H100 SXM's SMs: the plan aims at one wave
constexpr int kMinRange = 32;   // fewest terms of Q a rank sums
constexpr int kMaxRanks = 8;    // the largest portable cluster

// Per tile edge T: M (micro-tile edge), E (threads along a group's edge),
// G (groups), K (columns a slice stages), LD (padded staged row, doubles).
template <int T>
struct Cfg {
  static constexpr int M = T == 64 ? 4 : 2;
  static constexpr int E = T / M;
  static constexpr int G = kThreads / (E * E);
  static constexpr int K = 1024 / T;
  static constexpr int LD = K + 1;
  static constexpr int kPer = T * K / kThreads;  // elements a thread loads per operand
  static constexpr int kStage = 2 * T * LD;      // doubles of one stage (A and B rows)
  static constexpr int kPart = T * (T + 1);      // the tile's partial, rows padded
  static constexpr int kSmem = 2 * kStage;
  static_assert(G * E * E == kThreads && K % G == 0, "tile shape");
  static_assert(kPart + (G > 1 ? G * T * T : 0) <= kSmem, "partials fit the staging area");
};

struct Plan {
  int tile;   // T
  int ranks;  // S, the cluster's blocks; rank r sums [r Q / S, (r + 1) Q / S)
  int tiles;  // upper-triangle tiles
};

Plan make_plan(int c, int q) {
  Plan p;
  p.tile = c <= 128 ? 16 : (c <= 1024 ? 32 : 64);
  const int t = (c + p.tile - 1) / p.tile;
  p.tiles = t * (t + 1) / 2;
  p.ranks = 1;
  while (p.ranks < kMaxRanks && p.tiles * p.ranks < kSms && q / (2 * p.ranks) >= kMinRange)
    p.ranks *= 2;
  return p;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Upper-triangle tile p (row by row) of a t x t grid of tiles.
__device__ __forceinline__ void upper_tile(int p, int t, int& ti, int& tj) {
  ti = 0;
  while (p >= t - ti) {
    p -= t - ti;
    ++ti;
  }
  tj = ti + p;
}

// The block's min and max of (lo, hi); every thread gets the result.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float wlo[kThreads / 32];
  __shared__ float whi[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int tid = threadIdx.x;
  __syncthreads();  // an earlier call's readers are done with wlo / whi
  if (tid % 32 == 0) {
    wlo[tid / 32] = lo;
    whi[tid / 32] = hi;
  }
  __syncthreads();
  lo = wlo[0];
  hi = whi[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    lo = fminf(lo, wlo[w]);
    hi = fmaxf(hi, whi[w]);
  }
}

// One element of the output from its fp64 sum: K3 clamps, K1 takes the
// fp32 square root of the same rounded value; the diagonal is 0.
template <bool kStats>
__device__ __forceinline__ float finish(double v, int i, int j) {
  const float d2 = (i == j || v < 0.0) ? 0.f : static_cast<float>(v);
  return kStats ? sqrtf(d2) : d2;
}

// kStats: K1's epilogue (sqrt, statistics); otherwise K3's (clamp).
// stats: K1's [lo, hi, range, tile_min[tiles], tile_max[tiles]].
template <int T, typename In, bool kStats>
__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const In* __restrict__ f, int c, int q, int ranks,
                float* __restrict__ out, float* __restrict__ stats,
                unsigned int* __restrict__ ticket) {
  using C = Cfg<T>;
  constexpr int M = C::M, E = C::E, G = C::G, K = C::K, LD = C::LD;
  __shared__ double smem[C::kSmem];

  const int tid = threadIdx.x;
  const int tiles_per_side = (c + T - 1) / T;
  const int tile = blockIdx.x / ranks;
  const int rank = ranks > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  int ti, tj;
  upper_tile(tile, tiles_per_side, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * T;
  const int j0 = tj * T;
  const int lo = rank * q / ranks;
  const int hi = (rank + 1) * q / ranks;
  const int slices = hi > lo ? (hi - lo + K - 1) / K : 0;

  // this thread's group and its place in the group's E x E grid
  const int g = tid / (E * E);
  const int ty = (tid % (E * E)) / E;
  const int tx = tid % E;

  // F[i0 : i0 + T, k0 : k0 + K] and F[j0 : j0 + T, ...], zero past C and
  // past the rank's range, so the ragged edges add (0 - 0)^2 = 0 exactly
  float pa[C::kPer];
  float pb[C::kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < C::kPer; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / K;
      const int k = k0 + e % K;
      const bool in_k = k < hi;
      pa[l] = (in_k && i0 + r < c) ? to_f32(f[(size_t)(i0 + r) * q + k]) : 0.f;
      if (!diag) pb[l] = (in_k && j0 + r < c) ? to_f32(f[(size_t)(j0 + r) * q + k]) : 0.f;
    }
  };
  auto stash = [&](double* st) {
#pragma unroll
    for (int l = 0; l < C::kPer; ++l) {
      const int e = tid + l * kThreads;
      st[(e / K) * LD + e % K] = static_cast<double>(pa[l]);
      if (!diag) st[T * LD + (e / K) * LD + e % K] = static_cast<double>(pb[l]);
    }
  };

  double acc[M][M];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < M; ++n) acc[m][n] = 0.0;

  if (slices > 0) fetch(lo);
  for (int s = 0; s < slices; ++s) {
    double* st = smem + (s & 1) * C::kStage;
    stash(st);
    __syncthreads();
    if (s + 1 < slices) fetch(lo + (s + 1) * K);  // in flight while this slice is summed
    const double* as = st;
    const double* bs = diag ? st : st + T * LD;
#pragma unroll 4
    for (int kk = g; kk < K; kk += G) {
      double a[M];
      double b[M];
#pragma unroll
      for (int m = 0; m < M; ++m) a[m] = as[(ty + m * E) * LD + kk];
#pragma unroll
      for (int n = 0; n < M; ++n) b[n] = bs[(tx + n * E) * LD + kk];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < M; ++n) {
          const double d = a[m] - b[n];
          acc[m][n] = fma(d, d, acc[m][n]);
        }
    }
  }
  __syncthreads();  // the staging area becomes the partials

  // the block's partial of the tile, in part[row * (T + 1) + col]: the
  // groups' partials added in group order
  double* part = smem;
  if (G > 1) {
    double* red = smem + C::kPart;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < M; ++n) red[g * T * T + (ty + m * E) * T + tx + n * E] = acc[m][n];
    __syncthreads();
    for (int o = tid; o < T * T; o += kThreads) {
      double v = red[o];
#pragma unroll
      for (int h = 1; h < G; ++h) v += red[h * T * T + o];
      part[(o / T) * (T + 1) + o % T] = v;
    }
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < M; ++n) part[(ty + m * E) * (T + 1) + tx + n * E] = acc[m][n];
  }

  if (ranks > 1) {
    // rank 0 adds the peers' partials in rank order through distributed
    // shared memory; the second sync keeps them alive until it has
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int o = tid; o < T * T; o += kThreads) {
        const int at = (o / T) * (T + 1) + o % T;
        double peer[kMaxRanks];  // every remote load in flight before the sum
#pragma unroll
        for (int r = 1; r < kMaxRanks; ++r)
          if (r < ranks) peer[r] = cluster.map_shared_rank(part, r)[at];
        double v = part[at];
#pragma unroll
        for (int r = 1; r < kMaxRanks; ++r)
          if (r < ranks) v += peer[r];
        part[at] = v;
      }
    }
    cluster.sync();
    if (rank != 0) return;
  } else {
    __syncthreads();
  }

  // the epilogue: the tile's rows as they are (coalesced along a row), then
  // its mirror, read down part's columns; a diagonal tile keeps row <= col
  float tlo = INFINITY;
  float thi = -INFINITY;
  for (int o = tid; o < T * T; o += kThreads) {
    const int r = o / T;
    const int col = o % T;
    const int i = i0 + r;
    const int j = j0 + col;
    if (i < c && j < c && (!diag || r <= col)) {
      const float v = finish<kStats>(part[r * (T + 1) + col], i, j);
      out[(size_t)i * c + j] = v;
      if (kStats) {
        tlo = fminf(tlo, v);
        thi = fmaxf(thi, v);
      }
    }
  }
  for (int o = tid; o < T * T; o += kThreads) {
    const int r = o % T;    // the source element's tile row ...
    const int col = o / T;  // ... and column: out[j0 + col, i0 + r]
    const int i = i0 + r;
    const int j = j0 + col;
    if (i < c && j < c && (!diag || r < col))
      out[(size_t)j * c + i] = finish<kStats>(part[r * (T + 1) + col], i, j);
  }

  if constexpr (kStats) {
    const int tiles = gridDim.x / ranks;
    __shared__ bool last;
    block_minmax(tlo, thi);
    if (tid == 0) {
      stats[3 + tile] = tlo;
      stats[3 + tiles + tile] = thi;
      // release: the tile's stats are visible before its ticket; acquire:
      // the last tile sees every other tile's
      cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t(*ticket);
      last = t.fetch_add(1u, cuda::memory_order_acq_rel) == static_cast<unsigned int>(tiles - 1);
    }
    __syncthreads();
    if (last) {  // the last tile's block reduces every tile's stats
      float l = INFINITY;
      float h = -INFINITY;
      for (int t = tid; t < tiles; t += kThreads) {
        l = fminf(l, __ldcg(stats + 3 + t));
        h = fmaxf(h, __ldcg(stats + 3 + tiles + t));
      }
      block_minmax(l, h);
      if (tid == 0) {
        const float d = h - l;
        stats[0] = l;
        stats[1] = h;
        stats[2] = d < 1e-30f ? 1e-30f : d;  // clamp_min: a NaN passes through
        *ticket = 0u;
      }
    }
  }
}

template <int T, typename In, bool kStats>
cudaError_t launch_tile(const Plan& p, const void* f, int c, int q, float* out,
                        float* stats, unsigned int* ticket, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles * p.ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, pairwise_kernel<T, In, kStats>, static_cast<const In*>(f), c, q,
                            p.ranks, out, stats, ticket);
}

template <typename In, bool kStats>
cudaError_t launch(const void* f, int c, int q, float* out, float* stats,
                   unsigned int* ticket, cudaStream_t s) {
  const Plan p = make_plan(c, q);
  switch (p.tile) {
    case 16: return launch_tile<16, In, kStats>(p, f, c, q, out, stats, ticket, s);
    case 32: return launch_tile<32, In, kStats>(p, f, c, q, out, stats, ticket, s);
    default: return launch_tile<64, In, kStats>(p, f, c, q, out, stats, ticket, s);
  }
}

}  // namespace

extern "C" {

// The launch a (c, q) call takes: out = {tile edge T, ranks S, upper-triangle
// tiles}.  Returns the number of blocks, tiles * S.
int pairwise_l2_plan(int c, int q, int* out) {
  const Plan p = make_plan(c, q);
  out[0] = p.tile;
  out[1] = p.ranks;
  out[2] = p.tiles;
  return p.tiles * p.ranks;
}

// Launches K1 on `stream`; f is (c, q) row-major fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); s0 is (c, c) fp32; stats holds 3 + 2 * tiles fp32 (tiles
// from pairwise_l2_plan); ticket is one unsigned int, 0 before the launch
// and 0 again after it, used by no other launch in flight.  Returns the
// cudaError_t of the launch.
int pairwise_l2_dists_stats(const void* f, int is_bf16, int c, int q, float* s0,
                            float* stats, void* ticket, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* t = static_cast<unsigned int*>(ticket);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16, true>(f, c, q, s0, stats, t, s)
                                  : launch<float, true>(f, c, q, s0, stats, t, s));
}

// Launches K3 on `stream`; f as for K1, d2 is (c, c) fp32.  Returns the
// cudaError_t of the launch.
int pairwise_l2_sq_dists(const void* f, int is_bf16, int c, int q, float* d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16, false>(f, c, q, d2, nullptr, nullptr, s)
                                  : launch<float, false>(f, c, q, d2, nullptr, nullptr, s));
}

const char* pairwise_l2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
