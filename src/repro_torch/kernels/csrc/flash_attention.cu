// K6: causal GQA flash attention, forward only, with an optional sliding
// window.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:flash_attention_kernel
//   (body _kernel, pallas_call at :119).
//
// q (B, S, H, hd), k and v (B, S, Hk, hd), all fp32 or all bf16 and
// contiguous -> out (B, S, H, hd) in q's type.  Query head h reads KV head
// h / G (G = H / Hk); no KV head is repeated in memory.  Position i attends
// positions j <= i (and j > i - window with a window), with scale hd^-0.5.
// A row with no valid key divides by 1 (the Pallas kernel's l == 0 rule).
// The entry point picks one of two kernels by the inputs' type.
//
// Bound on an H100: each of q, k, v and out crosses device memory once
// (2 * B * S * (H + Hk) * hd * itemsize bytes) against 4 * B * H * hd
// FLOPs per attended (query, key) pair.  At the LM client path's refresh
// shape (B=16, S=512, 15/5 heads, hd 64, bf16) that is 42 MB, 12.5 us at
// 3.35 TB/s, against 8.1 GFLOP, 8.2 us at the bf16 tensor-core peak:
// bound by bytes, with the products close behind.  What holds the bf16
// kernel above that is its CUDA-core work between the two products: per
// score an ex2 on the quarter-rate pipe, the FMA, max and sum of the
// online softmax, and the hi/lo split of P; and each block's start-up (its
// q tile and first K/V tile in flight before any product), which a block
// of 64 rows amortises over only the KV tiles up to its diagonal.
//
// bf16 (the LM path's refresh): wgmma on the tensor cores, fed by TMA.
// One 128-thread block (one warpgroup) takes one (batch row, query head,
// tile of 64 query rows) and walks the KV tiles of 64 positions from the
// window's first to the diagonal; the last query tiles (most KV tiles) are
// scheduled first; at hd 64 three blocks share an SM.  Thread 0 issues every
// copy, predicated inside the PTX so that the warpgroup never diverges: q
// once, then each K/V tile into a ring of 3 stages of shared memory.  An
// mbarrier per stage counts the copy's bytes; a named barrier of the
// warpgroup frees a stage for its refill.  A 4-D tensor map per tensor
// over (hd, heads, S, B) with boxes of (64, 1, 64, 1) in the 128-byte
// swizzle gives the tiles; its out-of-bounds fill zeroes positions >= S and
// hd's padding to 64, 128 or 256 columns (one box per 64 columns), and
// never reads the next head or batch row.  S = Q K^T is wgmma m64n64k16
// with both operands K-major in shared memory; the fp32 scores are masked,
// and the online softmax folds hd^-0.5 * log2(e) into one FMA per score
// before ex2, reducing its row max over the four lanes that share a row.
// The S accumulator's layout is already that of wgmma's A operand in
// registers, so P V is a second wgmma with P from registers and V from
// shared memory (MN-major, transposed-B).  P is carried as two bf16 halves,
// hi = P rounded to bf16 and lo = P - hi cut to bf16, two products into the
// same fp32 O: rounding P to bf16 alone (2^-9 of each term) broke the
// card's bound at hd 8, where a row's largest output is small against the
// terms; hi + lo holds P to 2^-17.  O stays in fp32 registers and is
// divided by the row sum l (taken from the fp32 P) once at the end.
//
// fp32 (the JAX tests' shapes, held to 1e-5): the products run as fp32 FMAs
// on the CUDA cores, which TF32 tensor cores could not match.  One
// 256-thread block per (batch row, query head, 64 query rows); thread
// (ty, tx) of a 16 x 16 layout owns query rows 4ty .. 4ty + 3, their
// scores against KV columns tx * C .. tx * C + C - 1 of the tile (C = BK /
// 16) and their outputs in columns 64c + 4tx .. 64c + 4tx + 3.  q is
// staged transposed and pre-scaled once; each KV tile of BK positions (64
// for hd <= 128, 32 for hd <= 256) is staged k transposed and v row-major,
// so every shared-memory read in the inner loops is a 16-byte vector that
// is conflict-free or broadcast; the probabilities pass through shared
// memory within a warp to the P.V product.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
// error codes beside cudaError_t's (all below 10000)
constexpr int kNoEncoder = 10000;      // the driver has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 20000;   // + the CUresult of a failed encode

__device__ __forceinline__ bool attends(int qp, int kp, int s, int window) {
  return kp <= qp && kp < s && (window <= 0 || kp > qp - window);
}

// ------------------------------------------------------------ fp32 path

constexpr int kThreads = 256;
constexpr int kBq = 64;        // query rows per block: 16 row groups x 4 rows
constexpr int kQld = kBq + 4;  // row stride (floats) of q^T and p^T in shared memory

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__host__ __device__ constexpr int kv_ld(int bk) { return bk + 4; }

// Dynamic shared memory of one fp32 block, in bytes.
__host__ __device__ constexpr size_t smem_bytes(int hd, int bk) {
  return sizeof(float) * ((size_t)hd * kQld + (size_t)hd * kv_ld(bk) +
                          (size_t)bk * hd + (size_t)bk * kQld);
}

template <int kHdMax, int kBk>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int s,
                       int h, int hk, int hd, int window, float scale) {
  constexpr int kCols = kBk / 16;       // score columns per thread
  constexpr int kKld = kv_ld(kBk);
  constexpr int kChunks = kHdMax / 64;  // 4-wide output column chunks per thread
  static_assert(kCols == 2 || kCols == 4, "BK must be 32 or 64");

  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [hd][kQld]  q^T * scale
  float* kt = qt + hd * kQld;                   // [hd][kKld]  k^T of the tile
  float* vs = kt + hd * kKld;                   // [kBk][hd]   v of the tile
  float* ps = vs + kBk * hd;                    // [kBk][kQld] p^T of the tile

  const int n_qt = (s + kBq - 1) / kBq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBq;  // longest rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int r0 = ty * 4;
  const int d4 = hd / 4;

  const size_t q_row = (size_t)h * hd;  // elements between positions of q and out
  const size_t kv_row = (size_t)hk * hd;
  const float* qb = q + (size_t)b * s * q_row + (size_t)head * hd;
  const float* kb = k + (size_t)b * s * kv_row + (size_t)kvh * hd;
  const float* vb = v + (size_t)b * s * kv_row + (size_t)kvh * hd;
  float* ob = out + (size_t)b * s * q_row + (size_t)head * hd;

  // q^T, scaled in fp32; rows past s are zero
  for (int e = tid; e < kBq * d4; e += kThreads) {
    const int r = e % kBq;
    const int c = (e / kBq) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < s) load4(qb + (size_t)(q0 + r) * q_row + c, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) qt[(c + i) * kQld + r] = x[i] * scale;
  }

  float m[4], l[4], acc[4][kChunks][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][ch][i] = 0.f;
  }

  const int q_last = min(q0 + kBq, s) - 1;
  const int tile_end = q_last / kBk;  // the diagonal tile
  const int tile_begin = window > 0 ? max(0, q0 - window + 1) / kBk : 0;

  for (int tile = tile_begin; tile <= tile_end; ++tile) {
    const int k0 = tile * kBk;
    __syncthreads();  // the previous tile's K/V (and the q staging) are done
    // k^T: consecutive threads take consecutive positions, so the
    // transposing writes hit distinct banks
    for (int e = tid; e < kBk * d4; e += kThreads) {
      const int j = e % kBk;
      const int c = (e / kBk) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < s) load4(kb + (size_t)(k0 + j) * kv_row + c, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) kt[(c + i) * kKld + j] = x[i];
    }
    // v row-major: consecutive threads take consecutive 4-element chunks
    for (int e = tid; e < kBk * d4; e += kThreads) {
      const int j = e / d4;
      const int c = (e % d4) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < s) load4(vb + (size_t)(k0 + j) * kv_row + c, x);
      store4(vs + j * hd + c, x);
    }
    __syncthreads();

    // scores of rows r0 .. r0 + 3 against columns tx * kCols ..
    float sc[4][kCols];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) sc[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kQld + r0);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      float kc[kCols];
      if constexpr (kCols == 4) {
        const float4 x = *reinterpret_cast<const float4*>(kt + d * kKld + tx * 4);
        kc[0] = x.x;
        kc[1] = x.y;
        kc[2] = x.z;
        kc[3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(kt + d * kKld + tx * 2);
        kc[0] = x.x;
        kc[1] = x.y;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) sc[r][c] = fmaf(qr[r], kc[c], sc[r][c]);
    }

    // online softmax; the 16 lanes of row group ty hold a row's columns
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + r0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (attends(qp, k0 + tx * kCols + c, s, window)) mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p =
            attends(qp, k0 + tx * kCols + c, s, window) ? expf(sc[r][c] - m_new) : 0.f;
        sc[r][c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][ch][i] *= alpha;
    }

    // p^T: only the 16 lanes of this row group read these four columns
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      *reinterpret_cast<float4*>(ps + (tx * kCols + c) * kQld + r0) =
          make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
    }
    __syncwarp();

    // acc += P V
    for (int j = 0; j < kBk; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + j * kQld + r0);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int col = ch * 64 + tx * 4;
        if (col < hd) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + j * hd + col);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][ch][0] = fmaf(pr[r], vv.x, acc[r][ch][0]);
            acc[r][ch][1] = fmaf(pr[r], vv.y, acc[r][ch][1]);
            acc[r][ch][2] = fmaf(pr[r], vv.z, acc[r][ch][2]);
            acc[r][ch][3] = fmaf(pr[r], vv.w, acc[r][ch][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= s) continue;
    const float den = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int col = ch * 64 + tx * 4;
      if (col < hd) {
        const float o[4] = {acc[r][ch][0] / den, acc[r][ch][1] / den,
                            acc[r][ch][2] / den, acc[r][ch][3] / den};
        store4(ob + (size_t)qp * q_row + col, o);
      }
    }
  }
}
// ------------------------------------------- bf16 path (wgmma + TMA)

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kBq = 64;           // query rows per block
constexpr int kBk = 64;           // KV positions per tile
constexpr int kThreads = 128;     // one warpgroup
constexpr int kChunk = 64;        // hd columns per 128-byte swizzled row
constexpr uint32_t kTileBytes = kBk * kChunk * sizeof(bf16);  // one [64][64] tile, 8 KB
static_assert(kBq == kBk, "q and K/V tiles share kTileBytes");

__host__ __device__ constexpr size_t smem_bytes(int chunks, int stages) {
  // q, then `stages` x (k, v), each `chunks` tiles; 1 KB to align the base
  // for the 128-byte swizzle; an mbarrier for q and one per stage
  return (size_t)(1 + 2 * stages) * chunks * kTileBytes + 1024 + 8 * (1 + stages);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
// Arrives on the barrier and adds `bytes` to its transaction count, in
// the threads with `issue` set: a predicate inside the PTX, so that the
// warpgroup takes no divergent branch (ptxas serialises wgmma around one).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes, bool issue) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
               "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes), "r"((int)issue) : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bar`'s transaction count; issued by the threads with
// `issue` set, predicated as above.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3, bool issue) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"((int)issue) : "memory");
}

// The warpgroup's named barrier: all 128 threads are past their last read
// of a stage before thread 0 refills it.
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle (the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start address, the
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // at most N groups still pending
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving accesses of a register that a wgmma reads
// or writes across the fence, the issue or the wait of that wgmma (left
// to itself it sinks their producers past the fence and then serialises
// the wgmma with injected fences).
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// d (64 x 64, fp32, this thread's 32) (+)= A (64 x 16) * B (16 x 64), A and
// B from shared memory through descriptors; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, bf16, from registers in the mma.m16n8k16 A
// layout per warp) * B (16 x 64), B from shared memory, MN-major
// (transposed: its 64 columns contiguous).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// (x, y) as two bf16 pairs: hi = (x, y) rounded to bf16 (one conversion)
// and lo = (x, y) - hi (exact in fp32) cut to bf16 (integer work), so that
// hi + lo holds x and y to 2^-17 relative
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const uint32_t hx = hi << 16, hy = hi & 0xffff0000u;  // x low half, y high
  lo = __byte_perm(__float_as_uint(x - __uint_as_float(hx)),
                   __float_as_uint(y - __uint_as_float(hy)), 0x7632);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One warpgroup, 64 query rows: warp w owns rows 16w .. 16w + 15.  Thread
// (warp w, lane = 4g + t) holds rows g and g + 8 of its warp's 16 and, of
// each 8-column accumulator tile j, columns 2t and 2t + 1: acc[4j],
// acc[4j + 1] row g, acc[4j + 2], acc[4j + 3] row g + 8 (the wgmma m64nN
// accumulator layout).  Thread 0 also issues every TMA copy.
template <int kChunks, int kStages>
__global__ void __launch_bounds__(kThreads)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                             int s, int h, int hk, int hd, int window, float scale_log2) {
  static_assert(kStages >= 2, "a K/V tile is copied while the one before it is read");
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kChunks * kTileBytes;
  const uint32_t v_s = k_s + kStages * kChunks * kTileBytes;
  const uint32_t q_full = v_s + kStages * kChunks * kTileBytes;
  const uint32_t full = q_full + 8;  // full[st] = full + 8 st

  const int n_qt = (s + kBq - 1) / kBq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBq;  // longest rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int q_last = min(q0 + kBq, s) - 1;
  const int tile_begin = window > 0 ? max(0, q0 - window + 1) / kBk : 0;
  const int n = q_last / kBk - tile_begin + 1;  // KV tiles, up to the diagonal one

  // tile i of this block goes to stage i % kStages, its (i / kStages)-th
  // use; thread 0 issues the copies
  const bool issuer = threadIdx.x == 0;
  const CUtensorMap* map_k = &tm_k;  // in the parameter space, where TMA reads it
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int i) {
    const uint32_t st = i % kStages, bar = full + 8 * st;
    mbar_expect_tx(bar, 2 * kChunks * kTileBytes, issuer);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint32_t off = (st * kChunks + c) * kTileBytes;
      tma_load(k_s + off, map_k, bar, c * kChunk, kvh, (tile_begin + i) * kBk, b, issuer);
      tma_load(v_s + off, map_v, bar, c * kChunk, kvh, (tile_begin + i) * kBk, b, issuer);
    }
  };
  if (issuer) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  mbar_expect_tx(q_full, kChunks * kTileBytes, issuer);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    tma_load(q_s + c * kTileBytes, &tm_q, q_full, c * kChunk, head, q0, b, issuer);
  for (int i = 0; i < min(n, kStages); ++i) load_kv(i);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int r_lo = q0 + warp * 16;  // this warp's first row
  const int rows[2] = {r_lo + (lane >> 2), r_lo + (lane >> 2) + 8};

  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[c][r] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums

  // the online softmax of tile i's scores in sc, in log2 units with the
  // scale folded into one FMA per score: masks, updates m and l, leaves the
  // unnormalised P in sc and O's rescale for tile i in alpha
  float alpha[2] = {1.f, 1.f};
  auto softmax = [&](int i, float (&sc)[32]) {
    const int k0 = (tile_begin + i) * kBk;
    if (k0 + kBk - 1 > r_lo || k0 + kBk > s || (window > 0 && k0 <= r_lo + 15 - window)) {
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (!attends(rows[(r >> 1) & 1], k0 + (r >> 2) * 8 + 2 * t + (r & 1), s, window))
          sc[r] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int r = 0; r < 32; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
    float neg[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_use = mx[rr] == -INFINITY ? 0.f : mx[rr];  // no valid key yet
      alpha[rr] = ex2((m[rr] - m_use) * scale_log2);
      neg[rr] = -m_use * scale_log2;
      m[rr] = mx[rr];
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      sc[r] = ex2(fmaf(sc[r], scale_log2, neg[(r >> 1) & 1]));
      l[(r >> 1) & 1] += sc[r];
    }
  };

  // P = hi + lo, two bf16 A operands: of the 16 keys of step kc, a[r]
  // holds the pair sc[8 kc + 2r], sc[8 kc + 2r + 1]
  float sc[32];
  uint32_t hi[4][4], lo[4][4];
  auto split = [&] {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1], hi[kc][r], lo[kc][r]);
  };

  // Step i issues tile i's S = Q K^T (both K-major; a 16-deep step is 32
  // bytes along the swizzled row) and tile i - 1's O = alpha O + P V (V
  // MN-major, its hd columns contiguous; a 16-deep step is 16 rows of 128
  // bytes) back to back, with O rescaled before either, then waits for
  // both and runs tile i's softmax.  The products of one warpgroup overlap
  // the softmax of the other two blocks on the SM.  (Running the softmax
  // while the P V is in flight, as FlashAttention-3 does, made ptxas
  // serialise every wgmma, C7514, and was slower.)
  for (int i = 0; i <= n; ++i) {
    if (i == 0) mbar_wait(q_full, 0);
    if (i < n) mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= alpha[0];
        o[c][4 * j + 1] *= alpha[0];
        o[c][4 * j + 2] *= alpha[1];
        o[c][4 * j + 3] *= alpha[1];
      }
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int r = 0; r < 32; ++r) fence_operand(o[c][r]);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        fence_operand(hi[kc][r]);
        fence_operand(lo[kc][r]);
      }
#pragma unroll
    for (int r = 0; r < 32; ++r) fence_operand(sc[r]);
    wgmma_fence();
    if (i < n) {
      const uint32_t kt = k_s + (i % kStages) * kChunks * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 4 * kChunks; ++kk) {  // the first step overwrites sc
        const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
        wgmma_ss(sc, desc(q_s + off, 16, 1024), desc(kt + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    }
    if (i > 0) {
      const uint32_t vt = v_s + ((i - 1) % kStages) * kChunks * kTileBytes;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const uint64_t dv = desc(vt + c * kTileBytes + kc * 2048, kTileBytes, 1024);
          wgmma_rs_tb(o[c], hi[kc], dv);
          wgmma_rs_tb(o[c], lo[kc], dv);
        }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int r = 0; r < 32; ++r) fence_operand(o[c][r]);
    if (i < n) {
#pragma unroll
      for (int r = 0; r < 32; ++r) fence_operand(sc[r]);
      softmax(i, sc);
    }
    // tile i - 1's stage is free: refill it with tile i - 1 + kStages
    if (i > 0 && i - 1 + kStages < n) {
      warpgroup_sync();
      load_kv(i - 1 + kStages);
    }
    if (i < n) split();
  }

  // O / l, once per row
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
  }
  const size_t q_row = (size_t)h * hd;
  bf16* ob = out + (size_t)b * s * q_row + (size_t)head * hd;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * kChunk + j * 8 + 2 * t;
      if (col >= hd) break;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (rows[rr] < s)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rows[rr] * q_row + col) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * rr] * inv[rr], o[c][4 * j + 2 * rr + 1] * inv[rr]);
    }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link to the driver; null when the driver lacks it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The map of a (b, s, heads, hd) bf16 tensor as 4-D (hd, heads, s, b),
// boxes of (64, 1, rows, 1) in the 128-byte swizzle.  Coordinates past an
// edge (hd's padding, positions >= s) read as zeros and never reach the
// next head or batch row.
int tensor_map(CUtensorMap* map, const void* ptr, int b, int s, int heads, int hd, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)s * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int kChunks, int kStages>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s, int h, int hk,
           int hd, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, b, s, h, hd, kBq);
  if (!err) err = tensor_map(&tk, k, b, s, hk, hd, kBk);
  if (!err) err = tensor_map(&tv, v, b, s, hk, hd, kBk);
  if (err) return err;
  auto kernel = flash_attention_wgmma_kernel<kChunks, kStages>;
  const size_t bytes = smem_bytes(kChunks, kStages);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s + kBq - 1) / kBq, h, b);
  kernel<<<grid, kThreads, bytes, stream>>>(tq, tk, tv, static_cast<bf16*>(out), s, h, hk, hd,
                                            window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------------ launchers

template <int kHdMax, int kBk>
int launch_fp32(const void* q, const void* k, const void* v, void* out, int b,
                int s, int h, int hk, int hd, int window, float scale,
                cudaStream_t stream) {
  auto kernel = flash_attention_kernel<kHdMax, kBk>;
  const size_t bytes = smem_bytes(hd, kBk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBq - 1) / kBq, h, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), s, h, hk, hd, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K6 on `stream`.  q and out (b, s, h, hd), k and v (b, s, hk, hd),
// all contiguous, 16-byte aligned and of one type: bf16 (is_bf16, the
// tensor-core kernel) or fp32 (the CUDA-core kernel).  window <= 0 means no
// window.  The caller checks h % hk == 0, hd % 8 == 0, 8 <= hd <= 256,
// b, s >= 1 and b, h <= 65535.  Returns the cudaError_t of the launch.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int is_bf16, int b, int s, int h, int hk, int hd,
                    int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd <= 64) return wg::launch<1, 3>(q, k, v, out, b, s, h, hk, hd, window, scale, st);
    if (hd <= 128) return wg::launch<2, 3>(q, k, v, out, b, s, h, hk, hd, window, scale, st);
    return wg::launch<4, 3>(q, k, v, out, b, s, h, hk, hd, window, scale, st);
  }
  if (hd <= 64) return launch_fp32<64, 64>(q, k, v, out, b, s, h, hk, hd, window, scale, st);
  if (hd <= 128) return launch_fp32<128, 64>(q, k, v, out, b, s, h, hk, hd, window, scale, st);
  return launch_fp32<256, 32>(q, k, v, out, b, s, h, hk, hd, window, scale, st);
}

const char* flash_attention_error_string(int err) {
  if (err == kNoEncoder) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled failed (CUresult = err - 20000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
