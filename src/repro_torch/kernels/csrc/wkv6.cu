// K7: the RWKV-6 (Finch) WKV recurrence with data-dependent decay.
//
// Replaces the TPU kernel
//   src/repro/kernels/rwkv6_scan/rwkv6_scan.py:wkv6_kernel (body _kernel).
//
// r, k, v (B, T, H, hd), all fp32 or all bf16; w (B, T, H, hd) fp32 decay
// in [0, 1]; u (H, hd) fp32; s0 (B, H, hd, hd) fp32 -> y (B, T, H, hd) in
// r's type and s_out (B, H, hd, hd) fp32.  Per (b, h), from S = s0:
//   y_t = r_t^T (S + diag(u * k_t) v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// all in fp32 (inputs are widened as they are staged); y is rounded once
// to r's type.
//
// Bound on an H100: the recurrence needs 5 hd^2 + 4 hd fp32 operations per
// (b, t, h) (r^T S, the update w_i S_ij + k_i v_j, and the bonus taken as
// (r . (u * k)) v) on the CUDA cores; the chunked form below moves its two
// products, 4 hd^2 FLOPs per (b, t, h), to the tensor cores, as 3xTF32
// (five or six TF32 products' worth).  The bytes are r, k, v, w and y once
// and the fp32 state read and written once.  At decode (T = 1) the call is
// bound by the state's bytes, 2 * B * H * hd^2 * 4 (33.5 MB at B = 16, H =
// hd = 64), over 3.35 TB/s; at rwkv6-7b's prefill (bf16, hd 64) by bytes
// too, but what holds a kernel there is the dependence over T.
//
// Two designs, chosen by shape alone (wkv6_plan):
//
// Recurrent (T < kL, and hd = 8 at any T): one block of hd threads per
// (b, h).  Thread j owns column j of S in hd fp32 registers for the whole
// call.  The block stages kChunk tokens at a time in shared memory (per
// token and row i one float4 {r_i, u_i k_i, k_i, w_i}, and v_t), so one
// pair of barriers serves kChunk steps, each
//   y_j = sum_i r_i (S_ij + (u_i k_i) v_j),   S_ij <- w_i S_ij + k_i v_j.
// At decode this reaches 0.69 of its bytes' bound; at prefill it left most
// of the card idle (B * H blocks of 2 warps, each step a chain of hd
// dependent FMAs), which the chunked design replaces.
//
// Chunked (T >= kL, hd in {16, 32, 64}): chunks of kL = 16 tokens.
// Within a chunk of tokens 0 .. kL - 1 (a last, partial chunk is padded
// with r = k = v = 0, w = 1, which leaves y and S as they are):
//   P_t = prod_{m<t} w_m     (prefix, from the chunk's start; P_kL = D)
//   r~_t = r_t * P_t,  k~_s = k_s * prod_{s<m<kL} w_m     (suffix)
//   A_ts = sum_i r_ti k_si prod_{s<m<t} w_mi  (s < t),   A_tt = sum_i r_ti u_i k_ti
//   y = R~ S + A V,   S <- diag(D) S + K~^T V.
// - Every decay factor is a running product of w, never exp of a
//   cumulative log: w is exactly 0 where the model clamps its exponent at
//   8, and exp(cw_t - a) exp(a - cw_s) would give inf * 0 there, while a
//   log sum also loses ulp(|sum log w|) of relative accuracy.  All the
//   products are <= 1, round like the recurrence's own, and give exactly
//   0 where it does.
// - wkv6_chunked_kernel runs the chunks in order, one 128-thread block per
//   (b, h, slice of VS value columns); the slices are the fewest that give
//   one wave of blocks where hd allows (VS >= 8): 4 slices of 16 at one
//   prompt of rwkv6-7b (256 blocks), 1 at 16 prompts (1,024 blocks) or at
//   (4, 2048).  It carries its hd x VS columns of S in fp32 registers (the
//   mma accumulator layout) from chunk to chunk, and stages r, k, w, its
//   slice of v (and the chunk's A) by 16-byte cp.async into a ring of
//   three buffers, two chunks ahead.  Per chunk: S to shared memory, the
//   prefix and suffix products (a thread per channel and direction) and,
//   with one slice, A; a barrier; then R~ S + A V and K~^T V on the tensor
//   cores (mma.sync m16n8k8 TF32).  Each product loads and splits its
//   fragments for a group of k-steps first and then issues the k-steps'
//   independent mma chains, so that the tensor cores' latency overlaps;
//   with two y tiles (VS = 16) warps 2 and 3 take the upper half of R~ S's
//   k-steps and hand their partial sums to warps 0 and 1 through shared
//   memory and a named barrier.
// - A (`triangle`): a half warp takes two columns (s, kL - 1 - s), kL - 1
//   steps in all, each lane hd / 16 channels of k_s times its running
//   product of w; the steps' partials meet across the 16 lanes in one
//   reduce-scatter (15 shuffles).  A does not depend on S.  With more than
//   one slice every slice block would form the same A, which took about
//   half of each chunk's time there (a clock64 probe, not kept), so the
//   wrapper's one call launches wkv6_triangle_kernel first: A of every
//   chunk into a workspace, all chunks at once (consecutive chunks of one
//   (b, h) grouped so that about kTriBlocks blocks an SM remain, the next
//   chunk's r, k and w staged by cp.async while one computes).  With one
//   slice the chunks' kernel forms A from the staged chunk itself, and r,
//   k and w are read once.
// What holds it now: at one prompt the chunks' dependent chain, in which
// the tensor-core products (three mma.sync each) and the prefix products
// take most of a chunk; at 16 prompts the rate at which mma.sync issues
// 3xTF32's products and their fragments' loads and splits (chip_smoke.py
// prints the two kernels' times where there are two).  wgmma's TF32 rate
// is the next step.
//
// Precision of the chunked products, against the bounds the kernel is held
// to (S within 1e-5 of its head's largest |S|; bf16 y within 2^-7 |y| +
// 2^-8 of its row's largest |y|; fp32 inputs within 5e-4, the JAX sweep's
// bound; the state hand-off within 1e-4).  One TF32 pass (2^-11) misses
// the S bound, so every fp32 operand is split exactly into x = hi + lo, hi
// = x with its 13 low mantissa bits cleared, and each product takes lo.hi
// + hi.lo + hi.hi (lo.lo, 2^-20 of the product, dropped; the tensor cores
// read lo as TF32 too, dropping up to 2^-20 of x).  That leaves about
// 2^-21 of each product.  v in bf16 is exact in TF32 and takes no lo, so
// K~^T V and A V on bf16 v are two products, on fp32 v three.  The
// tensor cores' accumulation rounds toward zero, so each k-step of 8 goes
// into a fresh fragment, which is added to the fp32 sum on the CUDA cores:
// no bias builds up over hd or over the chunks.  A (fp32) is split like
// R~ for A V.  S's update is one fmaf per
// element, D S + (K~^T V); its error per chunk is ~2^-21 of the chunk's
// |K~^T V| terms, which the decay then shrinks, so S stays well inside
// 1e-5 of its head's max (tests/test_torch_rwkv.py emulates this rounding
// on the CPU and holds it to fp64 at that bound, at the slowest decays
// too, where the plain recurrence's own rounding grows most).  y's error,
// ~2^-21 of sum_i |r~_i S_ij|, is far inside both y bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kChunk = 32;  // recurrent kernel: tokens staged per pair of barriers

constexpr int kL = 16;        // chunked kernel: tokens per chunk
constexpr int kThreads = 128;  // chunked kernel: four warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;     // chunked kernel: chunks staged, two ahead of the one in use
constexpr int kWaves = 1;      // blocks >= kWaves * SMs where the slices allow
constexpr int kTriBlocks = 8;  // the chunked design's first kernel: blocks per SM

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

// ------------------------------------------------------------ recurrent

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

// -------------------------------------------------------------- chunked

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

// x = hi + lo exactly, hi = x with its 13 low mantissa bits cleared (a
// TF32 value); the tensor cores read lo as TF32 too.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d = a b, from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float* d, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row strides (elements) of the shared arrays, padded so that the mma
// fragment reads are free of bank conflicts: the A fragments of rt and a
// read rows gid at columns tig (stride = 4, 12, 20 or 28 mod 32 words);
// the transposed A of kt and the B of st and v read rows tig at columns
// gid (stride = 8 or 24 mod 32 words).
template <typename T, int HD, int VS>
struct ChunkShape {
  static constexpr int kRt = HD + 4;
  static constexpr int kKt = HD + 8;
  static constexpr int kSt = VS % 32 == 8 ? VS + 16 : VS + 8;
  static constexpr int kV = VS + 16 / (int)sizeof(T);
  static constexpr int kA = kL + 4;
  // one stage: r, k (kL x HD of T), w (kL x HD fp32), v (kL x kV of T) and
  // the chunk's A (kL x kA fp32)
  static constexpr int kRBytes = kL * HD * (int)sizeof(T);
  static constexpr int kWBytes = kL * HD * 4;
  static constexpr int kVBytes = kL * kV * (int)sizeof(T);
  static constexpr int kABytes = kL * kA * 4;
  static constexpr int kStage = 2 * kRBytes + kWBytes + kVBytes + kABytes;
  // shared floats past the stages: r~, k~, D, S, and the y partial sums
  // handed between warps
  static constexpr int kSmem =
      kStages * kStage + 4 * (kL * kRt + kL * kKt + HD + HD * kSt + kWarps * 32 * 4);
  // S's m16n8 tiles: kMW warps along its HD / 16 row tiles, kNW along its
  // VS / 8 column tiles, kNT column tiles a warp
  static constexpr int kMW = HD / 16 < kWarps ? HD / 16 : kWarps;
  static constexpr int kNW = kWarps / kMW;
  static constexpr int kNT = (VS / 8 + kNW - 1) / kNW;
  static constexpr int kYTiles = VS / 8;  // m16n8 tiles of a chunk's y
  static constexpr int kYPer = (kYTiles + kWarps - 1) / kWarps;
  // two y tiles (VS = 16): warps 2 and 3 take the upper half of R~ S's
  // k-steps of tiles 0 and 1 and hand their partial sums to warps 0 and 1
  static constexpr bool kSplitK = 2 * kYTiles == kWarps;
};

template <typename T, int HD, int VS>
struct Stage {
  T* r;
  T* k;
  float* w;
  T* v;
  float* a;
  __device__ Stage(char* p) {
    using C = ChunkShape<T, HD, VS>;
    r = reinterpret_cast<T*>(p);
    k = reinterpret_cast<T*>(p + C::kRBytes);
    w = reinterpret_cast<float*>(p + 2 * C::kRBytes);
    v = reinterpret_cast<T*>(p + 2 * C::kRBytes + C::kWBytes);
    a = reinterpret_cast<float*>(p + 2 * C::kRBytes + C::kWBytes + C::kVBytes);
  }
};

// Stage kL tokens of r, k and w of one (b, head), token t at off + t *
// row, into sr, sk (kL x HD of T) and sw (kL x HD fp32); tokens t >= valid
// are r = k = 0, w = 1.  By 16-byte cp.async where every row starts
// 16-byte aligned (vec), else by ordinary loads.  Each thread's share of
// the pieces is known at compile time.
template <typename T, int HD>
__device__ __forceinline__ void stage_rkw(const T* __restrict__ r, const T* __restrict__ k,
                                          const float* __restrict__ w, size_t off, int row,
                                          int valid, bool vec, T* sr, T* sk, float* sw) {
  const int tid = threadIdx.x;
  r += off;
  k += off;
  w += off;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kRowPieces = HD / kPer;
    constexpr int kRPieces = kL * kRowPieces;
#pragma unroll
    for (int m = 0; m < (kRPieces + kThreads - 1) / kThreads; ++m) {
      const int e = tid + m * kThreads;
      if (kRPieces % kThreads == 0 || e < kRPieces) {
        const int t = e / kRowPieces;
        const int c = (e % kRowPieces) * kPer;
        const bool ok = t < valid;
        const int src = ok ? t * row + c : 0;
        cp_async16(sr + t * HD + c, r + src, ok ? 16 : 0);
        cp_async16(sk + t * HD + c, k + src, ok ? 16 : 0);
      }
    }
    constexpr int kWRowPieces = HD / 4;
    constexpr int kWPieces = kL * kWRowPieces;
#pragma unroll
    for (int m = 0; m < (kWPieces + kThreads - 1) / kThreads; ++m) {
      const int e = tid + m * kThreads;
      if (kWPieces % kThreads == 0 || e < kWPieces) {
        const int t = e / kWRowPieces;
        const int c = (e % kWRowPieces) * 4;
        float* dst = sw + t * HD + c;
        if (t < valid) {
          cp_async16(dst, w + t * row + c, 16);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(1.f, 1.f, 1.f, 1.f);
        }
      }
    }
  } else {
    for (int e = tid; e < kL * HD; e += kThreads) {
      const int t = e / HD;
      const int i = e % HD;
      const bool ok = t < valid;
      sr[e] = ok ? r[t * row + i] : narrow<T>(0.f);
      sk[e] = ok ? k[t * row + i] : narrow<T>(0.f);
      sw[e] = ok ? w[t * row + i] : 1.f;
    }
  }
}

// Stage one chunk of one (b, head), token t at off + t * row: r, k and w
// whole, v's columns j0 .. j0 + VS - 1, and the chunk's A from a (kL x kL).
// Tokens t >= valid are r = k = v = 0, w = 1.  By 16-byte cp.async where
// every row starts 16-byte aligned (vec), else by ordinary loads.  Each
// thread's share of the pieces is known at compile time.
template <typename T, int HD, int VS>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ r, const T* __restrict__ k,
                                            const T* __restrict__ v, const float* __restrict__ w,
                                            const float* __restrict__ a, size_t off, int row,
                                            int valid, int j0, bool vec,
                                            const Stage<T, HD, VS>& st) {
  using C = ChunkShape<T, HD, VS>;
  const int tid = threadIdx.x;
  r += off;
  k += off;
  v += off + j0;
  w += off;
  constexpr int kAPieces = kL * kL / 4;
#pragma unroll
  for (int m = 0; m < (kAPieces + kThreads - 1) / kThreads; ++m) {
    const int e = tid + m * kThreads;
    if (a != nullptr && e < kAPieces) {
      cp_async16(st.a + (e / 4) * C::kA + (e % 4) * 4, a + e * 4, 16);
    }
  }
  stage_rkw<T, HD>(r, k, w, 0, row, valid, vec, st.r, st.k, st.w);
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kVRowPieces = VS / kPer;
    constexpr int kVPieces = kL * kVRowPieces;
#pragma unroll
    for (int m = 0; m < (kVPieces + kThreads - 1) / kThreads; ++m) {
      const int e = tid + m * kThreads;
      if (kVPieces % kThreads == 0 || e < kVPieces) {
        const int t = e / kVRowPieces;
        const int c = (e % kVRowPieces) * kPer;
        const bool ok = t < valid;
        cp_async16(st.v + t * C::kV + c, v + (ok ? t * row + c : 0), ok ? 16 : 0);
      }
    }
  } else {
    for (int e = tid; e < kL * VS; e += kThreads) {
      const int t = e / VS;
      const int j = e % VS;
      st.v[t * C::kV + j] = t < valid ? v[t * row + j] : narrow<T>(0.f);
    }
  }
}

// N contiguous staged elements, widened to fp32, in one shared load.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  if (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(x.x << 16); out[1] = __uint_as_float(x.x & 0xffff0000u);
    out[2] = __uint_as_float(x.y << 16); out[3] = __uint_as_float(x.y & 0xffff0000u);
  } else if (N == 2) {
    const unsigned x = *reinterpret_cast<const unsigned*>(p);
    out[0] = __uint_as_float(x << 16); out[1] = __uint_as_float(x & 0xffff0000u);
  } else {
    out[0] = widen(p[0]);
  }
}

// The sum over the 16 lanes of a half warp.
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// One level of a sum over the lanes of a half warp that leaves each lane
// with one of the 2M values' sums: the lanes whose bit M is set keep
// values M .. 2M - 1, the others 0 .. M - 1; each sends its partner (lane
// l ^ M) the half it does not keep and adds the half it receives, into
// v[0 .. M - 1].  After levels 8, 4, 2 and 1, lane l holds the sum of v[l].
template <int M>
__device__ __forceinline__ void scatter_level(float* v, int l) {
  const bool upper = l & M;
#pragma unroll
  for (int e = 0; e < M; ++e) {
    const float send = upper ? v[e] : v[e + M];
    const float keep = upper ? v[e + M] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// A of one chunk from its staged r, k and w (kL x HD, row t at t * HD),
// into am (kL x ld_a; only s <= t is written: the caller keeps s > t at 0).
// A_ts = sum_i r_ti (k_si prod_{s<m<t} w_mi) for s < t and the bonus
// sum_i r_ti u_i k_ti for s = t.  A half warp takes the columns sa = pair
// and sb = kL - 1 - pair, kL - 1 steps in all: steps 0 .. na - 1 column sa
// at t = sa + 1 + step, the rest column sb at t = step + 1; kp carries k_s
// times its running product of w, each lane kCpg contiguous channels (uc:
// their u); the steps' partials meet across the half warp's lanes in one
// scatter, lane l ending with step l's sum.
template <typename T, int HD>
__device__ __forceinline__ void triangle(const T* rs, const T* ks, const float* ws,
                                         const float* uc, float* am, int ld_a) {
  constexpr int kCpg = HD / 16;
  const int lane = threadIdx.x & 31;
  const int pair = 2 * (threadIdx.x >> 5) + (lane >> 4);
  const int ch = (lane & 15) * kCpg;
  const int sa = pair;
  const int sb = kL - 1 - pair;
  const int na = kL - 1 - sa;  // >= kL / 2: steps below kL / 2 are all column sa
  float kp[kCpg], kb[kCpg], ra[kCpg], rb[kCpg], col[kL];
  load_row<kCpg>(ks + sa * HD + ch, kp);
  load_row<kCpg>(ks + sb * HD + ch, kb);
  load_row<kCpg>(rs + sa * HD + ch, ra);
  load_row<kCpg>(rs + sb * HD + ch, rb);
  float da = 0.f, db = 0.f;
#pragma unroll
  for (int c = 0; c < kCpg; ++c) {
    da = fmaf(ra[c] * uc[c], kp[c], da);
    db = fmaf(rb[c] * uc[c], kb[c], db);
  }
#pragma unroll
  for (int step = 0; step < kL - 1; ++step) {
    const int t = step < na ? sa + 1 + step : step + 1;
    float rv[kCpg], wv[kCpg];
    load_row<kCpg>(rs + t * HD + ch, rv);
    load_row<kCpg>(ws + t * HD + ch, wv);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kCpg; ++c) {
      if (step >= kL / 2 && step == na) kp[c] = kb[c];
      acc = fmaf(rv[c], kp[c], acc);
      kp[c] *= wv[c];
    }
    col[step] = acc;
  }
  col[kL - 1] = 0.f;
  const int l = lane & 15;
  scatter_level<8>(col, l);
  scatter_level<4>(col, l);
  scatter_level<2>(col, l);
  scatter_level<1>(col, l);
  da = sum16(da);
  db = sum16(db);
  if (l < kL - 1) {
    am[(l < na ? sa + 1 + l : l + 1) * ld_a + (l < na ? sa : sb)] = col[0];
  } else {
    am[sa * ld_a + sa] = da;
    am[sb * ld_a + sb] = db;
  }
}

// The first kernel of the chunked design: A of every chunk.  A depends on
// the chunk's r, k and w alone, not on S, so the chunks are independent:
// one 128-thread block takes `group` consecutive chunks of one (b, head)
// (the host picks group so that the blocks fill the card), stages the
// next chunk's r, k and w by cp.async while it computes one, and writes
// each chunk's A as kL x kL fp32 to a, 0 above the diagonal.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_triangle_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const float* __restrict__ w, const float* __restrict__ u,
                     float* __restrict__ a, int t_len, int h, int chunks, int group, int vec) {
  constexpr int kCpg = HD / 16;
  constexpr int kRB = kL * HD * (int)sizeof(T);
  constexpr int kWB = kL * HD * 4;
  __shared__ __align__(16) char bufs[2][2 * kRB + kWB];
  __shared__ float am[kL * kL];

  const int tid = threadIdx.x;
  const int groups = (chunks + group - 1) / group;
  const int bh = blockIdx.x / groups;  // b * h + head
  const int c0 = (blockIdx.x % groups) * group;
  const int c1 = min(chunks, c0 + group);
  const int b = bh / h;
  const int head = bh - b * h;
  const int row = h * HD;
  const size_t base = ((size_t)b * t_len * h + head) * HD;
  float uc[kCpg];
#pragma unroll
  for (int c = 0; c < kCpg; ++c) uc[c] = u[head * HD + ((tid & 15) * kCpg) + c];
  for (int e = tid; e < kL * kL; e += kThreads) am[e] = 0.f;

  auto stage = [&](int c) {
    char* p = bufs[(c - c0) & 1];
    stage_rkw<T, HD>(r, k, w, base + (size_t)c * kL * row, row, t_len - c * kL, vec,
                     reinterpret_cast<T*>(p), reinterpret_cast<T*>(p + kRB),
                     reinterpret_cast<float*>(p + 2 * kRB));
  };
  stage(c0);
  cp_async_commit();
  for (int c = c0; c < c1; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c staged; the last chunk's A stored
    if (c + 1 < c1) stage(c + 1);
    cp_async_commit();
    const char* p = bufs[(c - c0) & 1];
    triangle<T, HD>(reinterpret_cast<const T*>(p), reinterpret_cast<const T*>(p + kRB),
                    reinterpret_cast<const float*>(p + 2 * kRB), uc, am, kL);
    __syncthreads();
    float* dst = a + ((size_t)bh * chunks + c) * kL * kL;
    for (int e = tid; e < kL * kL; e += kThreads) dst[e] = am[e];
  }
}

// mma fragments of a 16 x 8 (A) or 8 x 8 (B) block of a shared array with
// row stride ld, split into TF32 hi and lo.  A row-major: A[m][k] = p[m *
// ld + k]; A transposed: A[m][k] = p[k * ld + m]; B: B[k][n] = p[k * ld +
// n], exact (hi only) for bf16.
__device__ __forceinline__ void frag_a(const float* p, int ld, unsigned* hi, unsigned* lo) {
  const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  split_tf32(p[gid * ld + tig], hi[0], lo[0]);
  split_tf32(p[(gid + 8) * ld + tig], hi[1], lo[1]);
  split_tf32(p[gid * ld + tig + 4], hi[2], lo[2]);
  split_tf32(p[(gid + 8) * ld + tig + 4], hi[3], lo[3]);
}
__device__ __forceinline__ void frag_at(const float* p, int ld, unsigned* hi, unsigned* lo) {
  const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  split_tf32(p[tig * ld + gid], hi[0], lo[0]);
  split_tf32(p[tig * ld + gid + 8], hi[1], lo[1]);
  split_tf32(p[(tig + 4) * ld + gid], hi[2], lo[2]);
  split_tf32(p[(tig + 4) * ld + gid + 8], hi[3], lo[3]);
}
__device__ __forceinline__ void frag_b(const float* p, int ld, unsigned* hi, unsigned* lo) {
  const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  split_tf32(p[tig * ld + gid], hi[0], lo[0]);
  split_tf32(p[(tig + 4) * ld + gid], hi[1], lo[1]);
}
__device__ __forceinline__ void frag_b(const __nv_bfloat16* p, int ld, unsigned* hi, unsigned*) {
  const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  hi[0] = __float_as_uint(widen(p[tig * ld + gid]));
  hi[1] = __float_as_uint(widen(p[(tig + 4) * ld + gid]));
}

// The prefix and suffix products of w over one staged chunk, channel by
// channel: threads 0 .. HD - 1 write r~_t = r_t * prod_{m<t} w_m to rt and
// D = prod_m w_m to dec, threads HD .. 2 HD - 1 write k~_s = k_s *
// prod_{m>s} w_m to kt.  All loads come first: the stores may not be moved
// above them.
template <typename T, int HD, typename S>
__device__ __forceinline__ void decay(const S& cur, float* rt, float* kt, float* dec, int ld_rt,
                                      int ld_kt) {
  const int tid = threadIdx.x;
  if (tid < HD) {
    float x[kL], wv[kL];
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      x[t] = widen(cur.r[t * HD + tid]);
      wv[t] = cur.w[t * HD + tid];
    }
    float p = 1.f;
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      x[t] *= p;
      p *= wv[t];
    }
#pragma unroll
    for (int t = 0; t < kL; ++t) rt[t * ld_rt + tid] = x[t];
    dec[tid] = p;
  } else if (tid < 2 * HD) {
    const int i = tid - HD;
    float x[kL], wv[kL];
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      x[t] = widen(cur.k[t * HD + i]);
      wv[t] = cur.w[t * HD + i];
    }
    float p = 1.f;
#pragma unroll
    for (int t = kL - 1; t >= 0; --t) {
      x[t] *= p;
      p *= wv[t];
    }
#pragma unroll
    for (int t = 0; t < kL; ++t) kt[t * ld_kt + i] = x[t];
  }
}

// Named barriers over `count` threads (id 0 is __syncthreads'), with
// the ordering of shared memory that bar gives.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// acc[e] += R~ S over R~ S's k-steps [Q0, Q1) and, with kWithAV, A V, for
// the NT y tiles of n8 columns nt[e].  The k-steps go in groups of kGroup:
// a group's fragments are loaded and split first (each A fragment once
// for the NT tiles), then each k-step's lo.hi + hi.lo + hi.hi goes into
// its own fresh fragment, the group's chains issued side by side so that
// the tensor cores' latency overlaps, and the fragments are added on the
// CUDA cores.
template <typename T, int Q0, int Q1, bool kWithAV, int NT>
__device__ __forceinline__ void y_partial(const float* rt, const float* st, const float* a,
                                          const T* v, int ld_rt, int ld_st, int ld_a, int ld_v,
                                          const int* nt, float (*acc)[4]) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kKs = Q1 - Q0;
  constexpr int kK = kKs + (kWithAV ? kL / 8 : 0);
  constexpr int kGroup = 4;
#pragma unroll
  for (int g0 = 0; g0 < kK; g0 += kGroup) {
    constexpr int kMax = kGroup;
    unsigned ahi[kMax][4], alo[kMax][4], bhi[kMax][NT][2], blo[kMax][NT][2];
    float d[kMax][NT][4];
#pragma unroll
    for (int g = 0; g < kMax; ++g) {
      const int q = g0 + g;
      if (q < kK) {
        if (q < kKs) {
          frag_a(rt + 8 * (Q0 + q), ld_rt, ahi[g], alo[g]);
        } else {
          frag_a(a + 8 * (q - kKs), ld_a, ahi[g], alo[g]);
        }
#pragma unroll
        for (int e = 0; e < NT; ++e) {
          if (q < kKs) {
            frag_b(st + 8 * (Q0 + q) * ld_st + nt[e] * 8, ld_st, bhi[g][e], blo[g][e]);
          } else {
            frag_b(v + 8 * (q - kKs) * ld_v + nt[e] * 8, ld_v, bhi[g][e], blo[g][e]);
          }
          mma_tf32_zero(d[g][e], alo[g], bhi[g][e]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMax; ++g) {
      const int q = g0 + g;
      if (q < kK && (q < kKs || !kBf16)) {  // bf16 v is exact: no lo
#pragma unroll
        for (int e = 0; e < NT; ++e) mma_tf32(d[g][e], ahi[g], blo[g][e]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMax; ++g) {
      if (g0 + g < kK) {
#pragma unroll
        for (int e = 0; e < NT; ++e) {
          mma_tf32(d[g][e], ahi[g], bhi[g][e]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[e][c] += d[g][e][c];
        }
      }
    }
  }
}

// The second kernel of the chunked design: the chunks in order, S carried
// from one to the next (see the header).
template <typename T, int HD, int VS>
__global__ void __launch_bounds__(kThreads)
wkv6_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ a, const float* __restrict__ u,
                    const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
                    int t_len, int h, int vec) {
  using C = ChunkShape<T, HD, VS>;
  using St = Stage<T, HD, VS>;
  constexpr bool kBf16 = sizeof(T) == 2;  // bf16 v is exact in TF32
  constexpr int kSlices = HD / VS;
  extern __shared__ __align__(16) char smem[];
  float* rt = reinterpret_cast<float*>(smem + kStages * C::kStage);  // r~ [kL][kRt]
  float* kt = rt + kL * C::kRt;                                       // k~ [kL][kKt]
  float* dec = kt + kL * C::kKt;                                      // D  [HD]
  float* st = dec + HD;                                               // S  [HD][kSt]
  float* yp = st + HD * C::kSt;  // y partial sums handed between warps [warp][lane][4]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int slice = blockIdx.x % kSlices;
  const int bh = blockIdx.x / kSlices;  // b * h + head
  const int b = bh / h;
  const int head = bh - b * h;
  const int j0 = slice * VS;
  const int row = h * HD;
  const size_t base = ((size_t)b * t_len * h + head) * HD;
  const int chunks = (t_len + kL - 1) / kL;
  // A from the first kernel, or (a null) formed here from each staged chunk
  const bool inline_a = a == nullptr;
  const float* a_bh = inline_a ? nullptr : a + (size_t)bh * chunks * kL * kL;
  float uc[HD / 16];
  if (inline_a) {
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) uc[c] = u[head * HD + (tid & 15) * (HD / 16) + c];
    for (int e = tid; e < kStages * kL * C::kA; e += kThreads) {
      St(smem + (e / (kL * C::kA)) * C::kStage).a[e % (kL * C::kA)] = 0.f;
    }
  }

  // the first kStages - 1 chunks in flight, one commit group each
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) {
      stage_chunk<T, HD, VS>(r, k, v, w, inline_a ? nullptr : a_bh + c * kL * kL, base + (size_t)c * kL * row, row,
                             t_len - c * kL, j0, vec, St(smem + c * C::kStage));
    }
    cp_async_commit();
  }

  // S: this warp's m16 rows m0 .. m0 + 15 and n8 column tiles nt = warp /
  // kMW + kNW e; sreg[e] holds rows m0 + gid, + 8 at columns 8 nt + 2 tig, + 1
  const int m0 = (warp % C::kMW) * 16;
  float sreg[C::kNT][4];
  const float* s_in = s0 + (size_t)bh * HD * HD + j0;
#pragma unroll
  for (int e = 0; e < C::kNT; ++e) {
    const int nt = warp / C::kMW + C::kNW * e;
    if (nt < VS / 8) {
      const int i0 = m0 + gid;
      const int j = nt * 8 + 2 * tig;
      sreg[e][0] = s_in[i0 * HD + j];
      sreg[e][1] = s_in[i0 * HD + j + 1];
      sreg[e][2] = s_in[(i0 + 8) * HD + j];
      sreg[e][3] = s_in[(i0 + 8) * HD + j + 1];
    }
  }

  for (int ci = 0; ci < chunks; ++ci) {
    const St cur(smem + (ci % kStages) * C::kStage);
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ci staged; every thread is done with chunk ci - 1
    const int next = ci + kStages - 1;
    if (next < chunks) {
      stage_chunk<T, HD, VS>(r, k, v, w, inline_a ? nullptr : a_bh + next * kL * kL, base + (size_t)next * kL * row,
                             row, t_len - next * kL, j0, vec,
                             St(smem + (next % kStages) * C::kStage));
    }
    cp_async_commit();

    // S to shared memory, for the y product
#pragma unroll
    for (int e = 0; e < C::kNT; ++e) {
      const int nt = warp / C::kMW + C::kNW * e;
      if (nt < VS / 8) {
        const int i0 = m0 + gid;
        const int j = nt * 8 + 2 * tig;
        *reinterpret_cast<float2*>(st + i0 * C::kSt + j) = make_float2(sreg[e][0], sreg[e][1]);
        *reinterpret_cast<float2*>(st + (i0 + 8) * C::kSt + j) = make_float2(sreg[e][2], sreg[e][3]);
      }
    }
    decay<T, HD>(cur, rt, kt, dec, C::kRt, C::kKt);
    if (inline_a) triangle<T, HD>(cur.r, cur.k, cur.w, uc, cur.a, C::kA);
    __syncthreads();  // r~, k~, D, S (and A) in shared memory

    // y = R~ S + A V: this warp's n8 tiles nt = warp + kWarps e of the
    // chunk's kL x VS (with kSplitK, half of one tile's R~ S k-steps)
    if (C::kSplitK || warp < C::kYTiles) {
      constexpr int kKs = HD / 8;  // k-steps of R~ S
      constexpr int kNY = C::kSplitK ? 1 : C::kYPer;
      int nt[kNY];
#pragma unroll
      for (int e = 0; e < kNY; ++e) {
        nt[e] = C::kSplitK ? warp % C::kYTiles : warp + kWarps * e;
      }
      float acc[kNY][4] = {};
      if (C::kSplitK && warp >= C::kYTiles) {
        y_partial<T, kKs / 2, kKs, false, kNY>(rt, st, cur.a, cur.v, C::kRt, C::kSt, C::kA, C::kV,
                                               nt, acc);
        *reinterpret_cast<float4*>(yp + (warp * 32 + lane) * 4) =
            make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
        named_arrive(1 + nt[0], 64);
      } else {
        y_partial<T, 0, C::kSplitK ? kKs / 2 : kKs, true, kNY>(rt, st, cur.a, cur.v, C::kRt,
                                                                C::kSt, C::kA, C::kV, nt, acc);
        if (C::kSplitK) {
          named_sync(1 + nt[0], 64);
          const float4 o = *reinterpret_cast<const float4*>(yp + ((warp + C::kYTiles) * 32 + lane) * 4);
          acc[0][0] += o.x;
          acc[0][1] += o.y;
          acc[0][2] += o.z;
          acc[0][3] += o.w;
        }
#pragma unroll
        for (int e = 0; e < kNY; ++e) {
          if (C::kSplitK || warp + kWarps * e < C::kYTiles) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int t = ci * kL + gid + 8 * half;
              if (t < t_len) {
                T* dst = y + base + (size_t)t * row + j0 + nt[e] * 8 + 2 * tig;
                dst[0] = narrow<T>(acc[e][2 * half]);
                dst[1] = narrow<T>(acc[e][2 * half + 1]);
              }
            }
          }
        }
      }
    }

    // S <- diag(D) S + K~^T V on this warp's tiles: the fragments first,
    // then the tiles' independent mma chains
    {
      constexpr int kKa = kL / 8;
      unsigned khi[kKa][4], klo[kKa][4];
#pragma unroll
      for (int q = 0; q < kKa; ++q) frag_at(kt + 8 * q * C::kKt + m0, C::kKt, khi[q], klo[q]);
      unsigned vhi[C::kNT][kKa][2], vlo[C::kNT][kKa][2];
      float d[C::kNT][kKa][4];
#pragma unroll
      for (int e = 0; e < C::kNT; ++e) {
        const int nt = warp / C::kMW + C::kNW * e;
        if (nt < VS / 8) {
#pragma unroll
          for (int q = 0; q < kKa; ++q) {
            frag_b(cur.v + 8 * q * C::kV + nt * 8, C::kV, vhi[e][q], vlo[e][q]);
            mma_tf32_zero(d[e][q], klo[q], vhi[e][q]);
          }
        }
      }
      if (!kBf16) {
#pragma unroll
        for (int e = 0; e < C::kNT; ++e) {
          if (warp / C::kMW + C::kNW * e < VS / 8) {
#pragma unroll
            for (int q = 0; q < kKa; ++q) mma_tf32(d[e][q], khi[q], vlo[e][q]);
          }
        }
      }
      const float d0 = dec[m0 + gid];
      const float d1 = dec[m0 + gid + 8];
#pragma unroll
      for (int e = 0; e < C::kNT; ++e) {
        if (warp / C::kMW + C::kNW * e < VS / 8) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < kKa; ++q) {
            mma_tf32(d[e][q], khi[q], vhi[e][q]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] += d[e][q][c];
          }
          sreg[e][0] = fmaf(d0, sreg[e][0], acc[0]);
          sreg[e][1] = fmaf(d0, sreg[e][1], acc[1]);
          sreg[e][2] = fmaf(d1, sreg[e][2], acc[2]);
          sreg[e][3] = fmaf(d1, sreg[e][3], acc[3]);
        }
      }
    }
  }

  float* s_dst = s_out + (size_t)bh * HD * HD + j0;
#pragma unroll
  for (int e = 0; e < C::kNT; ++e) {
    const int nt = warp / C::kMW + C::kNW * e;
    if (nt < VS / 8) {
      const int i0 = m0 + gid;
      const int j = nt * 8 + 2 * tig;
      s_dst[i0 * HD + j] = sreg[e][0];
      s_dst[i0 * HD + j + 1] = sreg[e][1];
      s_dst[(i0 + 8) * HD + j] = sreg[e][2];
      s_dst[(i0 + 8) * HD + j + 1] = sreg[e][3];
    }
  }
}

// ------------------------------------------------------------ launchers

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

// The design at this shape: 0 for the recurrent kernel, else the number
// of value slices of the chunked one, the fewest (1, 2 or 4, with VS =
// hd / slices >= 8) that give kWaves * SMs blocks.
int plan(int b, int t, int h, int hd) {
  if (t < kL || hd < 16) return 0;
  const long pairs = (long)b * h;
  const long want = (long)kWaves * sm_count();
  const int most = hd / 8 < 4 ? hd / 8 : 4;
  int slices = 1;
  while (slices < most && pairs * slices < want) slices *= 2;
  return slices;
}

// Bytes of the chunked design's workspace (A of every chunk), 0 for the
// recurrent one.
long long workspace(int b, int t, int h, int hd) {
  if (plan(b, t, h, hd) < 2) return 0;  // one slice forms A in the chunks' kernel
  return (long long)b * h * ((t + kL - 1) / kL) * kL * kL * 4;
}

template <typename T, int HD>
int launch_recurrent(const void* r, const void* k, const void* v, const float* w,
                     const float* u, const float* s0, void* y, float* s_out, int b,
                     int t, int h, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<b * h, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, t, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int VS>
int launch_chunked(const void* r, const void* k, const void* v, const float* w,
                   const float* u, const float* s0, void* y, float* s_out, float* ws, int b,
                   int t, int h, cudaStream_t stream) {
  using C = ChunkShape<T, HD, VS>;
  const int vec = ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  cudaError_t e;
  if (VS < HD) {
    // A of every chunk, once for the slices: consecutive chunks of one
    // (b, h) grouped so that about kTriBlocks blocks per SM remain
    const int chunks = (t + kL - 1) / kL;
    const long units = (long)b * h * chunks;
    const long want = (long)kTriBlocks * sm_count();
    const int group = units > want ? (int)std::min<long>((units + want - 1) / want, chunks) : 1;
    const int groups = (chunks + group - 1) / group;
    wkv6_triangle_kernel<T, HD><<<b * h * groups, kThreads, 0, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), w, u, ws, t, h, chunks, group, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto kernel = wkv6_chunked_kernel<T, HD, VS>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<b * h * (HD / VS), kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w,
      VS < HD ? ws : nullptr, u, s0, static_cast<T*>(y), s_out, t, h, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(int slices, const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, void* y, float* s_out, float* ws, int b, int t,
              int h, cudaStream_t st) {
  switch (slices) {
    case 0:
      return launch_recurrent<T, HD>(r, k, v, w, u, s0, y, s_out, b, t, h, st);
    case 1:
      return launch_chunked<T, HD, HD>(r, k, v, w, u, s0, y, s_out, ws, b, t, h, st);
    case 2:
      return launch_chunked<T, HD, HD / 2>(r, k, v, w, u, s0, y, s_out, ws, b, t, h, st);
    default:  // four slices (plan gives hd = 16 at most two)
      return launch_chunked<T, HD, (HD / 4 >= 8 ? HD / 4 : 8)>(r, k, v, w, u, s0, y, s_out, ws,
                                                                b, t, h, st);
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out, float* ws, int b,
           int t, int h, int hd, cudaStream_t stream) {
  const int slices = plan(b, t, h, hd);
  switch (hd) {
    case 8:
      return launch_recurrent<T, 8>(r, k, v, w, u, s0, y, s_out, b, t, h, stream);
    case 16:
      return launch_hd<T, 16>(slices, r, k, v, w, u, s0, y, s_out, ws, b, t, h, stream);
    case 32:
      return launch_hd<T, 32>(slices, r, k, v, w, u, s0, y, s_out, ws, b, t, h, stream);
    case 64:
      return launch_hd<T, 64>(slices, r, k, v, w, u, s0, y, s_out, ws, b, t, h, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K7's design at this shape: 0 for the recurrent kernel (T < 16 or hd =
// 8), else the number of value slices (blocks per (b, h)) of the chunked
// kernel.
int wkv6_plan(int b, int t, int h, int hd) { return plan(b, t, h, hd); }

// Bytes of the workspace wkv6 needs at this shape (0 for the recurrent
// design).
long long wkv6_workspace(int b, int t, int h, int hd) { return workspace(b, t, h, hd); }

// Launches K7 on `stream`, the design wkv6_plan names: the recurrent
// kernel, or the chunked design's two kernels (A of every chunk into ws,
// then the chunks in order).  r, k, v and y (b, t, h, hd) of one type
// (bf16 if is_bf16 else fp32), w (b, t, h, hd), u (h, hd), s0 and s_out
// (b, h, hd, hd) fp32, all contiguous; ws fp32, 16-byte aligned, of
// wkv6_workspace bytes.  The caller checks hd in {8, 16, 32, 64} and b, t,
// h >= 1.  Returns the cudaError_t of the launches.
int wkv6(const void* r, const void* k, const void* v, const float* w,
         const float* u, const float* s0, void* y, float* s_out, float* ws, int is_bf16,
         int b, int t, int h, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, ws, b, t, h, hd, st);
  }
  return launch<float>(r, k, v, w, u, s0, y, s_out, ws, b, t, h, hd, st);
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
