// flash attention for Hopper (sm_90a): causal or full GQA attention with
// an online softmax, one pass over K/V per query block.
//
// Replaces the TPU kernel `flash_attention` / `_flash_body` in
// src/repro/kernels/flash_attention/kernel.py:31-112. That kernel runs a
// grid (B, H, nq, nk) whose kv axis is sequential, carrying the f32
// accumulator and the running max m and sum l in VMEM scratch across kv
// steps; it skips kv blocks above the causal diagonal and maps query head
// h to kv head h // (H / KV). This file computes the same function:
//
//   s = (q k^T) * (1/sqrt(D))  in f32, -1e30 above the diagonal (causal)
//   m' = max(m, rowmax s);  a = exp(m - m');  p = exp(s - m')
//   l  = l a + rowsum p;   acc = acc a + round_to_v_dtype(p) v
//   o  = acc / max(l, 1e-30), stored in q's dtype
//
// Bound: operations. Per query block the kernel does 4 D flops per
// (query, key) pair and reads each K/V tile once from device memory; at
// the path's shapes (D = 128) that is far above the card's
// operations-per-byte line, so the arithmetic sets the pace.
//
// Design: one CTA of 256 threads per (query block of 64 rows, head,
// batch). The TPU kernel's sequential kv grid axis becomes a loop inside
// the CTA, and the causal skip is that loop's upper bound, not a mask.
// Q, and each 64-row K/V tile in turn, are staged in shared memory as
// f32 (rows padded to D+1 floats so the column reads hit distinct banks);
// the scores' 64x64 tile is spread 4x4 per thread (threads as 16 x 16),
// the row max and row sum reduce over the 16 threads of a row group by
// warp shuffles, and p goes through shared memory to the P.V product.
// m, l and each thread's 4 x D/16 slice of the accumulator stay in f32
// registers. All arithmetic is IEEE f32 with FMA, never TF32, for both
// f32 and bf16 inputs: plain FMA and no tensor cores yet (wgmma, TMA and
// warp specialisation are later work). Any S: the ragged edge is masked.
// Tensors are addressed through (batch, head, seq) strides with the head
// dimension contiguous, so the (B, S, H, D) layout of the model and the
// (B, H, S, D) layout of the kernel API both run without a transpose.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // keys per K/V tile
constexpr int kThreads = 256;     // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kBK * (D + 1) + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int group, int S,
          int causal, float scale, long long qb, long long qh, long long qs,
          long long kb, long long kh, long long ks, long long ob,
          long long oh, long long os) {
  constexpr int LD = D + 1;       // padded f32 row of Q, K and V
  constexpr int PLD = kBK + 1;    // padded f32 row of P
  constexpr int DC = D / 16;      // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;               // kBQ x LD
  float* sK = sQ + kBQ * LD;      // kBK x LD
  float* sV = sK + kBK * LD;      // kBK x LD
  float* sP = sV + kBK * LD;      // kBQ x PLD

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qp = q + b * qb + h * qh;
  const T* kp = k + b * kb + (h / group) * kh;
  const T* vp = v + b * kb + (h / group) * kh;
  T* op = o + b * ob + h * oh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * LD + c] =
        (q0 + r < S) ? to_f(qp[(long long)(q0 + r) * qs + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (S + kBK - 1) / kBK;
  // causal: tiles strictly above the block's diagonal do no work
  const int nk = causal ? min(n_tiles, (q0 + kBQ - 1) / kBK + 1) : n_tiles;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kBK;
    __syncthreads();              // the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const long long off = (long long)(k0 + r) * ks + c;
      sK[r * LD + c] = in ? to_f(kp[off]) : 0.f;
      sV[r * LD + c] = in ? to_f(vp[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if ((causal && kpos > qpos) || kpos >= S) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        // p.astype(v.dtype) before the P.V product, as the TPU kernel
        sP[(ty * 4 + i) * PLD + tx + 16 * j] = to_f(from_f<T>(p));
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      op[(long long)r * os + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int causal, long long qb,
                   long long qh, long long qs, long long kb, long long kh,
                   long long ks, long long ob, long long oh, long long os,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / KV, S, causal,
      scale, qb, qh, qs, kb, kh, ks, ob, oh, os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v,
                   void* o, int B, int H, int KV, int S, int causal,
                   long long qb, long long qh, long long qs, long long kb,
                   long long kh, long long ks, long long ob, long long oh,
                   long long os, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, S, causal, qb, qh, qs, kb,
                           kh, ks, ob, oh, os, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, S, causal, qb, qh, qs, kb,
                           kh, ks, ob, oh, os, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, S, causal, qb, qh, qs, kb,
                            kh, ks, ob, oh, os, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, S, D) at strides (qb, qh, qs); k and v: (B, KV, S, D) at
// strides (kb, kh, ks); o: like q at strides (ob, oh, os); the last
// dimension contiguous in all four. dtype 0: float32, 1: bfloat16.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KV, int S, int D, int causal,
                                   long long qb, long long qh, long long qs,
                                   long long kb, long long kh, long long ks,
                                   long long ob, long long oh, long long os,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || S <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)by_dim<float>(D, q, k, v, o, B, H, KV, S, causal, qb, qh,
                                qs, kb, kh, ks, ob, oh, os, st);
    case 1:
      return (int)by_dim<__nv_bfloat16>(D, q, k, v, o, B, H, KV, S, causal,
                                        qb, qh, qs, kb, kh, ks, ob, oh, os,
                                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
