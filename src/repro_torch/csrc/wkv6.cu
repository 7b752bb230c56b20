// WKV6 for Hopper (sm_90a): the RWKV-6 "Finch" linear recurrence with a
// data-dependent per-channel decay, from a zero state.
//
// Replaces the TPU kernel `wkv6` / `_wkv6_body` in
// src/repro/kernels/rwkv6/kernel.py:33-101. That kernel walks the
// sequence in chunks of L tokens on a grid (B, H, n_chunks) whose chunk
// axis is sequential, carrying the f32 n x n state in VMEM scratch. This
// file computes the same function, per (b, h) and token t:
//
//   o_t[j]    = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j]  <- S[i][j] w_t[i] + k_t[i] v_t[j]
//
// with o in f32 and every operation in IEEE f32 (r, k and v may be bf16
// or f32; w and u are f32).
//
// Bound: operations, by a little: 5 n^2 f32 flops per token and head
// against 14 bytes per element read or written (bf16 r, k, v; f32 w and
// o). At the path's shapes neither comes near the card's rates; what
// sets the time is the chain of S tokens that each depend on the last.
//
// Design: the exact recurrence, one CTA per (b, h) with one thread per
// state column j. The in-kernel loop over tokens replaces the Pallas grid
// carry. Each thread keeps S[:, j] (n floats) in registers; r_t, k_t and
// w_t are broadcast through shared memory, double-buffered so one barrier
// per token suffices, and token t+1's inputs are loaded from device
// memory while token t is computed. The sum over i runs in four partial
// sums so that consecutive FMAs do not wait on each other. The chunked
// form of the TPU kernel (k / P overflows f32 beyond L = 32) is not used:
// the exact form has no such limit. Grid B*H CTAs of n threads: 160 CTAs
// at B=4, H=40 on 132 SMs, 40 at B=1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, float* __restrict__ o, int S,
         long long ib, long long ih, long long is, long long ob,
         long long oh, long long os) {
  __shared__ float sr[2][N], sk[2][N], sw[2][N], su[N];
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long in0 = b * ib + h * ih + j;
  float* out = o + b * ob + h * oh + j;
  su[j] = u[h * N + j];

  float st[N];
#pragma unroll
  for (int i = 0; i < N; ++i) st[i] = 0.f;

  float rn = to_f(r[in0]), kn = to_f(k[in0]), vn = to_f(v[in0]);
  float wn = w[in0];
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
    const float vj = vn;
    // buf was last read two tokens ago, before the previous barrier
    __syncthreads();
    if (t + 1 < S) {
      const long long off = in0 + (long long)(t + 1) * is;
      rn = to_f(r[off]);
      kn = to_f(k[off]);
      vn = to_f(v[off]);
      wn = w[off];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float kv = sk[buf][i] * vj;
      acc[i & 3] = fmaf(sr[buf][i], fmaf(su[i], kv, st[i]), acc[i & 3]);
      st[i] = fmaf(st[i], sw[buf][i], kv);
    }
    out[(long long)t * os] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* o, int B, int H,
                   int S, long long ib, long long ih, long long is,
                   long long ob, long long oh, long long os,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_fwd<T, N><<<grid, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(o), S, ib, ih, is,
      ob, oh, os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_size(int N, const void* r, const void* k, const void* v,
                    const void* w, const void* u, void* o, int B, int H,
                    int S, long long ib, long long ih, long long is,
                    long long ob, long long oh, long long os,
                    cudaStream_t st) {
  switch (N) {
    case 8:
      return launch<T, 8>(r, k, v, w, u, o, B, H, S, ib, ih, is, ob, oh, os,
                          st);
    case 16:
      return launch<T, 16>(r, k, v, w, u, o, B, H, S, ib, ih, is, ob, oh,
                           os, st);
    case 32:
      return launch<T, 32>(r, k, v, w, u, o, B, H, S, ib, ih, is, ob, oh,
                           os, st);
    case 64:
      return launch<T, 64>(r, k, v, w, u, o, B, H, S, ib, ih, is, ob, oh,
                           os, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v (dtype 0: float32, 1: bfloat16) and w (float32): (B, H, S, N)
// at the shared strides (ib, ih, is); u: (H, N) float32, contiguous; o:
// (B, H, S, N) float32 at strides (ob, oh, os); the last dimension
// contiguous everywhere. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* o, int dtype,
                        int B, int H, int S, int N, long long ib,
                        long long ih, long long is, long long ob,
                        long long oh, long long os, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)by_size<float>(N, r, k, v, w, u, o, B, H, S, ib, ih, is,
                                 ob, oh, os, st);
    case 1:
      return (int)by_size<__nv_bfloat16>(N, r, k, v, w, u, o, B, H, S, ib,
                                         ih, is, ob, oh, os, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
