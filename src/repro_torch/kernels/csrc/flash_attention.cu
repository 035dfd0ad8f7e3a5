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
// positions j <= i (and j > i - window with a window), with scale hd^-0.5
// applied to q in fp32.  All math is fp32 (inputs are widened as they are
// staged), with an online softmax over KV tiles; the output is rounded once.
// A row with no valid key divides by 1 (the Pallas kernel's l == 0 rule).
//
// Bound on an H100: each of q, k, v and out crosses device memory once
// (2 * B * S * (H + Hk) * hd * itemsize bytes) against 2 * B * H * hd *
// S * (S + 1) causal FLOPs.  At the LM client path's refresh shape (B=16,
// S=512, 15/5 heads, hd 64, bf16) that is 42 MB, 12.5 us at 3.35 TB/s,
// against 8.1 GFLOP, 8.2 us at the bf16 tensor-core peak: bound by bytes.
// This kernel does its products with fp32 FMAs on the CUDA cores (67
// TFLOP/s peak), so in practice it is bound by those FMAs, near 0.12 ms at
// that shape.  What the design does about the bound: every block reads its
// q tile once and each K/V tile once per block from L2 (the whole K/V of
// the refresh shape, 10 MB, stays in the 50 MB L2), skips every tile above
// the diagonal or wholly outside the window, and keeps the scores, the
// probabilities and the accumulator on chip.  Tensor cores (mma.sync /
// wgmma), TMA and pipelined loads are left for a later change.
//
// Design: the TPU grid (B, H, S/bq, S/bk) runs its KV axis in order and
// carries (m, l, acc) in VMEM across it.  Here one 256-thread block takes
// one (batch row, query head, tile of 64 query rows) and walks the KV
// tiles itself, from the window's first tile to the diagonal tile; the
// blocks of the last query tiles, which have the most KV tiles, are
// scheduled first.  Thread (ty, tx) of a 16 x 16 layout owns query rows
// 4ty .. 4ty + 3: it computes their scores against KV columns tx * C ..
// tx * C + C - 1 of the tile (C = BK / 16) and their outputs in columns
// 64c + 4tx .. 64c + 4tx + 3.  q is staged transposed and pre-scaled once;
// each KV tile of BK positions (64 for hd <= 128, 32 for hd <= 256, sized
// to the shared memory) is staged as fp32, k transposed and v row-major,
// so every shared-memory read in the inner loops is a 16-byte vector that
// is conflict-free or broadcast.  The row max and row sum of the online
// softmax reduce over the 16 lanes of a row group with shuffles; m and l
// live in registers; the probabilities go through shared memory (only
// within a warp) to the P.V product, whose sums stay in registers.  A
// ragged S is masked here: positions past S are staged as zeros and never
// attended, and rows past S are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBq = 64;        // query rows per block: 16 row groups x 4 rows
constexpr int kQld = kBq + 4;  // row stride (floats) of q^T and p^T in shared memory
constexpr float kNegInf = -1.0e30f;

// 4 consecutive elements of T as fp32 (8 bytes of bf16, 16 bytes of fp32).
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const unsigned int*>(&a);
  x.y = *reinterpret_cast<const unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}

__host__ __device__ constexpr int kv_ld(int bk) { return bk + 4; }

// Dynamic shared memory of one block, in bytes.
__host__ __device__ constexpr size_t smem_bytes(int hd, int bk) {
  return sizeof(float) * ((size_t)hd * kQld + (size_t)hd * kv_ld(bk) +
                          (size_t)bk * hd + (size_t)bk * kQld);
}

__device__ __forceinline__ bool attends(int qp, int kp, int s, int window) {
  return kp <= qp && kp < s && (window <= 0 || kp > qp - window);
}

template <typename T, int kHdMax, int kBk>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s,
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
  const T* qb = q + (size_t)b * s * q_row + (size_t)head * hd;
  const T* kb = k + (size_t)b * s * kv_row + (size_t)kvh * hd;
  const T* vb = v + (size_t)b * s * kv_row + (size_t)kvh * hd;
  T* ob = out + (size_t)b * s * q_row + (size_t)head * hd;

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

template <typename T, int kHdMax, int kBk>
int launch_tiles(const void* q, const void* k, const void* v, void* out, int b,
                 int s, int h, int hk, int hd, int window, float scale,
                 cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, kHdMax, kBk>;
  const size_t bytes = smem_bytes(hd, kBk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBq - 1) / kBq, h, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, h, hk, hd, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s,
           int h, int hk, int hd, int window, float scale, cudaStream_t stream) {
  if (hd <= 64) return launch_tiles<T, 64, 64>(q, k, v, out, b, s, h, hk, hd, window, scale, stream);
  if (hd <= 128) return launch_tiles<T, 128, 64>(q, k, v, out, b, s, h, hk, hd, window, scale, stream);
  return launch_tiles<T, 256, 32>(q, k, v, out, b, s, h, hk, hd, window, scale, stream);
}

}  // namespace

extern "C" {

// Launches K6 on `stream`.  q and out (b, s, h, hd), k and v (b, s, hk, hd),
// all contiguous, 16-byte aligned and of one type (bf16 if is_bf16 else
// fp32).  window <= 0 means no window.  The caller checks h % hk == 0,
// hd % 8 == 0, 8 <= hd <= 256, b, s >= 1 and b, h <= 65535.  Returns the
// cudaError_t of the launch.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int is_bf16, int b, int s, int h, int hk, int hd,
                    int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, out, b, s, h, hk, hd, window, scale, st);
  }
  return launch<float>(q, k, v, out, b, s, h, hk, hd, window, scale, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
