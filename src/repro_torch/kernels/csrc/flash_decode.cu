// K5: single-query GQA decode attention against a KV cache, with a valid
// length per slot (flash-decode).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/decode.py:flash_decode_kernel
//   (body _decode_kernel, pallas_call at :104).
//
// q (B, 1, H, hd), k and v (B, S, Hk, hd), all fp32 or all bf16, lengths
// (B,) int32 -> out (B, 1, H, hd) in q's type.  Query head h reads KV head
// h / G (G = H / Hk).  Slot b attends its first min(max(lengths[b], 0), S)
// cache entries with scale hd^-0.5; the math is fp32 throughout and the
// output is rounded once to q's type.  A slot of length 0 returns zeros.
//
// Bound on an H100: every valid K/V entry is read once and does 4 FLOPs per
// query row and dimension, with G <= 8 rows on the main path, so the call is
// bound by bytes: the valid K/V prefix, sum_b len_b * Hk * hd * 2 tensors *
// itemsize, over 3.35 TB/s.  At (B=16, S=4096, 15/5 heads, hd 64, bf16) that
// is 84 MB against 252 MFLOP.  CUDA cores, not tensor cores: at most 8 query
// rows share a KV head on the main path (3 for smollm-360m), so a wgmma tile
// of 64 rows would sit at least 87% idle, and the FMAs are far under the
// bytes' time anyway.
//
// Design: the KV axis is split across blocks, and each block keeps its
// loads in flight.
// - Split.  The host knows B, Hk and S (the lengths live on the device) and
//   cuts S into `ns` splits of whole tiles so that B * Hk * (row groups) *
//   ns blocks fill at least two waves of the SMs (4 splits of 64 positions
//   at the serving shape B=16, S=256: 320 blocks; 57 splits of 576 at B=1,
//   S=32768).  One 128-thread block takes one (slot, KV head, group of up
//   to 8 of its G query rows, split).  A block whose split starts at or
//   past its slot's length writes an empty partial (m = -inf, l = 0) and
//   exits.  With one split the block normalises and writes the output
//   itself; otherwise it writes its partial (row max m, in log2 units, row
//   sum l and the unnormalised fp32 acc) to a workspace the wrapper
//   allocates, and a second small kernel, flash_decode_merge, combines the
//   splits of each (slot, query head) with the log-sum-exp rescale
//   (skipping empty partials; a row whose every split is empty gives
//   zeros).  Both launches come from one call of the entry point.
// - Loads in flight.  K and V tiles are staged in their own type (bf16
//   stays bf16, widened where it is used) by 16-byte cp.async into a ring
//   of 3 stages of 8 KB each per tensor (48 KB), two tiles ahead of the
//   one in use; one barrier per tile frees a stage for its refill.  Rows
//   past the split or the length, and the columns of a row past hd, are
//   zero-filled by the copy and never read from device memory.  Rows
//   whose size or start is not a multiple of 16 bytes take ordinary loads
//   into the same layout.
// - No barrier between phases.  A tile row holds LP * 8 elements (LP, the
//   lanes per position, is the power of two >= hd / 8); LP lanes share
//   one position, each holding 8 of its dimensions (bf16: one 16-byte
//   chunk; fp32: two chunks LP apart, so a warp's reads stay contiguous)
//   of q for all of the block's rows in registers, pre-scaled by hd^-0.5 *
//   log2(e).  Each group of LP lanes takes kPos positions of every tile
//   (interleaved across groups), reduces its dot products over its LP
//   lanes with xor shuffles, and keeps its own online softmax (m, l) and
//   P.V accumulator for its dimensions.  The groups' partial results are
//   merged once, at the end of the split: by shuffles within a warp, then
//   across the four warps through shared memory.
//
// Known weakness: the score's shuffle reduction repeats each exp2 on every
// lane of a position group (LP-fold, 8 at hd 64), and a group with G < 8
// rows runs padded rows when G is 5 to 7 (rows are kept in registers in
// groups of 1, 2, 3, 4 or 8).  With one short split per block at the
// serving shape the call is bound by its two launches' latency, not by
// either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kTileBytes = 8192;  // one K (or V) tile of one stage
constexpr int kSmemBytes = kStages * 2 * kTileBytes;
constexpr int kMaxRows = 8;
constexpr int kWaves = 2;  // blocks >= kWaves * SMs where the split allows
constexpr float kLog2e = 1.4426950408889634f;

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

// 16 bytes, or zeros when src_bytes is 0, from device to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The lane's 8 dimensions of one staged row: bf16 chunk li (dims 8li ..
// 8li + 7); fp32 chunks li and LP + li (dims 4li .. 4li + 3 and 4(LP + li)
// .. 4(LP + li) + 3).
__device__ __forceinline__ void read_lane(const __nv_bfloat16* row, int li, int lp, float* out) {
  const uint4 x = reinterpret_cast<const uint4*>(row)[li];
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void read_lane(const float* row, int li, int lp, float* out) {
  const float4 a = reinterpret_cast<const float4*>(row)[li];
  const float4 b = reinterpret_cast<const float4*>(row)[lp + li];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// The dimension of the lane's element e (0 .. 7), as read_lane lays it out.
template <typename T>
__device__ __forceinline__ int lane_dim(int li, int lp, int e) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  return ((e / kPer) * lp + li) * kPer + e % kPer;
}

// Stage positions s0 .. s0 + bk - 1 of one KV head (position p at base + p
// * row_stride) into dst (row length row_len elements); positions at or
// past lim, and columns at or past hd, are zero.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base, size_t row_stride,
                                           int s0, int bk, int lim, int hd, int row_len,
                                           bool vec, T* dst) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int row_chunks = row_len / kPer;
    const int valid_chunks = hd / kPer;
    for (int e = threadIdx.x; e < bk * row_chunks; e += kThreads) {
      const int j = e / row_chunks;
      const int c = e - j * row_chunks;
      const bool ok = s0 + j < lim && c < valid_chunks;
      const T* src = ok ? base + (size_t)(s0 + j) * row_stride + c * kPer : base;
      cp_async16(dst + j * row_len + c * kPer, src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < bk * row_len; e += kThreads) {
      const int j = e / row_len;
      const int d = e - j * row_len;
      dst[j * row_len + d] = (s0 + j < lim && d < hd)
                                 ? base[(size_t)(s0 + j) * row_stride + d]
                                 : narrow<T>(0.f);
    }
  }
}

// Merge (m_b, l_b, acc_b) into (m_a, l_a, acc_a); m in log2 units, -inf
// with l = 0 for an empty part.
__device__ __forceinline__ void merge_into(float& m, float& l, float* acc, float mo, float lo,
                                           const float* acco) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;  // both empty
  const float a = exp2f(m - mn);
  const float b = exp2f(mo - mn);
  l = l * a + lo * b;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = acc[e] * a + acco[e] * b;
  m = mn;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, float* __restrict__ ws, int nb, int s, int h,
                   int hk, int hd, int chunks, int ns, int split_len, int lp_log2,
                   int vec, float scale2) {
  constexpr int kPos = 8 / sizeof(T);  // positions per lane group per tile
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  constexpr int kTileElems = kTileBytes / sizeof(T);

  int idx = blockIdx.x;
  const int split = idx % ns;
  idx /= ns;
  const int chunk = idx % chunks;
  idx /= chunks;
  const int kvh = idx % hk;
  const int b = idx / hk;
  const int g = h / hk;
  const int g0 = chunk * R;
  const int gc = min(R, g - g0);
  const int head0 = kvh * g + g0;  // first query head of this block

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lp = 1 << lp_log2;
  const int li = lane & (lp - 1);  // lane within its position group
  const int grp = tid >> lp_log2;  // position group within the block
  const int groups = kThreads >> lp_log2;
  const int bk = kPos * groups;
  const int row_len = lp * 8;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > s ? s : len);
  const int s_begin = split * split_len;
  const int lim = min(min(s_begin + split_len, s), len);
  const size_t rows_total = (size_t)nb * h;

  if (lim <= s_begin) {  // an empty split
    if (ns == 1) {
      for (int e = tid; e < gc * hd; e += kThreads) {
        out[((size_t)b * h + head0) * hd + e] = narrow<T>(0.f);
      }
    } else if (tid < gc) {
      const size_t row = (size_t)b * h + head0 + tid;
      ws[(row * ns + split) * 2] = -INFINITY;
      ws[(row * ns + split) * 2 + 1] = 0.f;
    }
    return;
  }

  float qr[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = lane_dim<T>(li, lp, e);
      qr[r][e] = (r < gc && d < hd)
                     ? widen(q[((size_t)b * h + head0 + r) * hd + d]) * scale2
                     : 0.f;
    }
  }

  const size_t row_stride = (size_t)hk * hd;
  const T* kbase = k + (size_t)b * s * row_stride + (size_t)kvh * hd;
  const T* vbase = v + (size_t)b * s * row_stride + (size_t)kvh * hd;
  T* tiles = reinterpret_cast<T*>(smem);
  const int nt = (lim - s_begin + bk - 1) / bk;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) {
      T* ks = tiles + t * 2 * kTileElems;
      stage_tile<T>(kbase, row_stride, s_begin + t * bk, bk, lim, hd, row_len, vec, ks);
      stage_tile<T>(vbase, row_stride, s_begin + t * bk, bk, lim, hd, row_len, vec,
                    ks + kTileElems);
    }
    cp_async_commit();
  }

  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    const int tn = t + kStages - 1;
    if (tn < nt) {
      T* ks = tiles + (tn % kStages) * 2 * kTileElems;
      stage_tile<T>(kbase, row_stride, s_begin + tn * bk, bk, lim, hd, row_len, vec, ks);
      stage_tile<T>(vbase, row_stride, s_begin + tn * bk, bk, lim, hd, row_len, vec,
                    ks + kTileElems);
    }
    cp_async_commit();

    const T* ks = tiles + (t % kStages) * 2 * kTileElems;
    const T* vs = ks + kTileElems;
    const int s0 = s_begin + t * bk;
    float sc[R][kPos];
#pragma unroll
    for (int i = 0; i < kPos; ++i) {
      float kf[8];
      read_lane(ks + (i * groups + grp) * row_len, li, lp, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qr[r][e], kf[e], dot);
        sc[r][i] = dot;
      }
    }
    for (int o = 1; o < lp; o <<= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < kPos; ++i) sc[r][i] += __shfl_xor_sync(0xffffffffu, sc[r][i], o);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int i = 0; i < kPos; ++i) {
        if (s0 + i * groups + grp < lim) mt = fmaxf(mt, sc[r][i]);
      }
      const float mn = fmaxf(m[r], mt);
      if (mn == -INFINITY) {  // no valid position of this group yet
#pragma unroll
        for (int i = 0; i < kPos; ++i) sc[r][i] = 0.f;
        continue;
      }
      const float alpha = exp2f(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPos; ++i) {
        const float p = (s0 + i * groups + grp < lim) ? exp2f(sc[r][i] - mn) : 0.f;
        sc[r][i] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kPos; ++i) {
      float vf[8];
      read_lane(vs + (i * groups + grp) * row_len, li, lp, vf);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(sc[r][i], vf[e], acc[r][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the reduction below

  // merge the position groups of each warp (lanes lp apart) ...
  for (int o = lp; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acco[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acco[e] = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      merge_into(m[r], l[r], acc[r], mo, lo, acco);
    }
  }
  // ... then the four warps, through shared memory
  float* red = reinterpret_cast<float*>(smem);  // [warp][row][row_len]
  float* red_m = red + kWarps * R * row_len;    // [warp][row]
  float* red_l = red_m + kWarps * R;
  if (lane < lp) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * R + r) * row_len + lane_dim<T>(li, lp, e)] = acc[r][e];
      if (lane == 0) {
        red_m[warp * R + r] = m[r];
        red_l[warp * R + r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < gc * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * R + r]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp2f(red_m[w * R + r] - mx);
        lsum = fmaf(red_l[w * R + r], f, lsum);
        a = fmaf(red[(w * R + r) * row_len + d], f, a);
      }
    }
    const size_t row = (size_t)b * h + head0 + r;
    if (ns == 1) {
      out[row * hd + d] = narrow<T>(lsum > 0.f ? a / lsum : 0.f);
    } else {
      ws[rows_total * ns * 2 + (row * ns + split) * hd + d] = a;
      if (d == 0) {
        ws[(row * ns + split) * 2] = mx;
        ws[(row * ns + split) * 2 + 1] = lsum;
      }
    }
  }
}

// One block per (slot, query head): the log-sum-exp merge of its ns
// partials, skipping empty ones (l = 0); zeros when every one is empty.
template <typename T>
__global__ void flash_decode_merge(const float* __restrict__ ws, T* __restrict__ out,
                                   int rows, int ns, int hd) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = ws + row * ns * 2;
  const float* acc = ws + (size_t)rows * ns * 2 + row * ns * hd;
  float mx = -INFINITY;
  for (int i = 0; i < ns; ++i) {
    if (ml[2 * i + 1] > 0.f) mx = fmaxf(mx, ml[2 * i]);
  }
  float lsum = 0.f, a = 0.f;
  for (int i = 0; i < ns; ++i) {
    const float li = ml[2 * i + 1];
    if (li > 0.f) {
      const float f = exp2f(ml[2 * i] - mx);
      lsum = fmaf(li, f, lsum);
      if (d < hd) a = fmaf(acc[(size_t)i * hd + d], f, a);
    }
  }
  if (d < hd) out[row * hd + d] = narrow<T>(lsum > 0.f ? a / lsum : 0.f);
}

// The launch geometry both entry points share.
struct Plan {
  int rows;       // query rows per block (R)
  int chunks;     // row groups per KV head
  int lp_log2;    // log2 of the lanes per position
  int bk;         // positions per tile
  int ns;         // splits of the KV axis
  int split_len;  // positions per split (whole tiles)
};

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

Plan plan(int b, int s, int h, int hk, int hd, int esize) {
  Plan p;
  const int g = h / hk;
  p.rows = g <= 4 ? g : kMaxRows;
  p.chunks = (g + p.rows - 1) / p.rows;
  p.lp_log2 = 0;
  while ((8 << p.lp_log2) < hd) ++p.lp_log2;
  p.bk = (8 / esize) * (kThreads >> p.lp_log2);
  const int nt = (s + p.bk - 1) / p.bk;
  const long pairs = (long)b * hk * p.chunks;
  const long want = (long)kWaves * sm_count();
  const int target = (int)((want + pairs - 1) / pairs);
  const int per = target <= 1 ? nt : (nt / target > 1 ? nt / target : 1);
  p.ns = (nt + per - 1) / per;
  p.split_len = per * p.bk;
  return p;
}

template <typename T, int R>
void launch_split(const Plan& p, dim3 grid, const void* q, const void* k, const void* v,
                  const int* lengths, void* out, float* ws, int b, int s, int h, int hk,
                  int hd, int vec, float scale2, cudaStream_t st) {
  flash_decode_split<T, R><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), ws, b, s, h, hk, hd, p.chunks, p.ns, p.split_len, p.lp_log2, vec,
      scale2);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           float* ws, int b, int s, int h, int hk, int hd, float scale, cudaStream_t st) {
  const Plan p = plan(b, s, h, hk, hd, sizeof(T));
  const dim3 grid((unsigned)((long)b * hk * p.chunks * p.ns));
  const int vec = (hd * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const float scale2 = scale * kLog2e;
  switch (p.rows) {
    case 1: launch_split<T, 1>(p, grid, q, k, v, lengths, out, ws, b, s, h, hk, hd, vec, scale2, st); break;
    case 2: launch_split<T, 2>(p, grid, q, k, v, lengths, out, ws, b, s, h, hk, hd, vec, scale2, st); break;
    case 3: launch_split<T, 3>(p, grid, q, k, v, lengths, out, ws, b, s, h, hk, hd, vec, scale2, st); break;
    case 4: launch_split<T, 4>(p, grid, q, k, v, lengths, out, ws, b, s, h, hk, hd, vec, scale2, st); break;
    default: launch_split<T, kMaxRows>(p, grid, q, k, v, lengths, out, ws, b, s, h, hk, hd, vec, scale2, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.ns == 1) return static_cast<int>(err);
  const int threads = (hd + 31) / 32 * 32;
  flash_decode_merge<T><<<b * h, threads, 0, st>>>(ws, static_cast<T*>(out), b * h, p.ns, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K5's split of the KV axis at this shape: returns the number of splits
// and writes the positions per split (whole tiles) to *split_len.  The
// wrapper's workspace holds b * h * splits * (hd + 2) fp32 values when
// splits > 1 (none is read when splits == 1).
int flash_decode_plan(int b, int s, int h, int hk, int hd, int is_bf16, int* split_len) {
  const Plan p = plan(b, s, h, hk, hd, is_bf16 ? 2 : 4);
  *split_len = p.split_len;
  return p.ns;
}

// Launches K5 on `stream`: the split kernel and, with more than one split,
// the merge kernel.  q (b, 1, h, hd), k and v (b, s, hk, hd), out like q,
// all contiguous and of one type (bf16 if is_bf16 else fp32); lengths (b,)
// int32 on the device; ws as flash_decode_plan says.  The caller checks
// h % hk == 0, 1 <= hd <= 256 and b, s >= 1.  Returns the cudaError_t of
// the launches.
int flash_decode(const void* q, const void* k, const void* v, const int* lengths, void* out,
                 void* ws, int is_bf16, int b, int s, int h, int hk, int hd, float scale,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, lengths, out, w, b, s, h, hk, hd, scale, st);
  }
  return launch<float>(q, k, v, lengths, out, w, b, s, h, hk, hd, scale, st);
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
