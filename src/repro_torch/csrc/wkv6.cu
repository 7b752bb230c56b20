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
// sets the time is the chain of S tokens that each depend on the last:
// each warp walks all S tokens, so the time is the instructions a warp
// issues per token times the cycles it takes per instruction, and that
// grows once a scheduler holds more than one warp.
//
// Design: the exact recurrence (the chunked form of the TPU kernel is not
// used: its k / P overflows f32 beyond L = 32, and tensor cores in TF32
// cannot hold rel < 1e-4). The columns j of the state are independent, so
// each (b, h) is split over G = n / kCols CTAs of kCols columns each
// (grid (G, H, B): 320 CTAs of one warp at B=1, H=40, n=64, at most one
// warp per scheduler). Within a CTA each thread carries kColsPerThread
// columns, which share its loads and conversions of r, k and w, over
// n / kRowGroups rows, keeping that slice of S in registers; the
// per-thread sum of a column runs in four partial sums so that
// consecutive FMAs do not wait on each other. The inputs are staged a
// chunk of kChunk tokens at a time: cp.async copies r, k, w (all n rows)
// and v (this CTA's columns) of the next chunk into shared memory while
// this chunk is computed, double-buffered, with one barrier per chunk,
// and each token's inputs are read into registers while the token before
// is computed. A thread's partial of o_t[j] goes to shared memory, so no
// token waits on a reduction across threads: after the chunk's barrier
// the row groups' partials are added in the order of a xor butterfly,
// ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)), and the outputs
// stored as whole rows of the CTA's columns. Both layouts (BHSN and
// BSHN) are read and written through the strides, with no transposes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;                     // state columns per CTA
constexpr int kColsPerThread = 2;            // columns a thread carries
constexpr int kRowGroups = 8;                // threads per column
constexpr int kChunk = 32;                   // tokens staged per chunk
constexpr int kThreads = kCols / kColsPerThread * kRowGroups;

// two bf16 in a u32 (little-endian) as f32: the low one, the high one
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// P consecutive values from shared memory (aligned to their size) as f32
template <int P>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int q = 0; q < P; q += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + q);
      x[q] = f.x; x[q + 1] = f.y; x[q + 2] = f.z; x[q + 3] = f.w;
    }
  } else if constexpr (P == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x; x[1] = f.y;
  } else {
    x[0] = p[0];
  }
}

template <int P>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p,
                                          float (&x)[P]) {
  if constexpr (P % 8 == 0) {
#pragma unroll
    for (int q = 0; q < P; q += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + q);
      x[q] = bf_lo(v.x); x[q + 1] = bf_hi(v.x);
      x[q + 2] = bf_lo(v.y); x[q + 3] = bf_hi(v.y);
      x[q + 4] = bf_lo(v.z); x[q + 5] = bf_hi(v.z);
      x[q + 6] = bf_lo(v.w); x[q + 7] = bf_hi(v.w);
    }
  } else if constexpr (P == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = bf_lo(v.x); x[1] = bf_hi(v.x);
    x[2] = bf_lo(v.y); x[3] = bf_hi(v.y);
  } else if constexpr (P == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    x[0] = bf_lo(v); x[1] = bf_hi(v);
  } else {
    x[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One chunk buffer in shared memory, in bytes: r, k, w of kChunk tokens
// (all n rows), v of kChunk tokens (this CTA's kCols columns), and each
// thread's partial of o for kChunk tokens.
template <typename T, int N>
struct Stage {
  static constexpr int kR = 0;
  static constexpr int kK = kR + kChunk * N * (int)sizeof(T);
  static constexpr int kW = kK + kChunk * N * (int)sizeof(T);
  static constexpr int kV = kW + kChunk * N * 4;
  static constexpr int kP = kV + kChunk * kCols * (int)sizeof(T);
  static constexpr int kBytes = kP + kChunk * kRowGroups * kCols * 4;
};

template <typename T, int N>
constexpr int smem_bytes() {
  return 2 * Stage<T, N>::kBytes;
}

// Copy tokens [t0, t0 + nt) of r, k, w (whole rows) and v (columns
// [j0, j0 + kCols)) into the stage at `buf`, 16 B per cp.async.
template <typename T, int N>
__device__ __forceinline__ void stage_in(
    uint8_t* buf, const T* r, const T* k, const T* v, const float* w,
    long long in0, long long is, int j0, int t0, int nt, int tid) {
  using St = Stage<T, N>;
  constexpr int kRow = N * (int)sizeof(T) / 16;     // pieces per r, k row
  constexpr int kWRow = N * 4 / 16;                 // pieces per w row
  constexpr int kVRow = kCols * (int)sizeof(T) / 16;
  for (int p = tid; p < nt * kRow; p += kThreads) {
    const int tt = p / kRow, c = p % kRow;
    const long long g = in0 + (long long)(t0 + tt) * is;
    cp_async16(buf + St::kR + tt * N * sizeof(T) + 16 * c,
               reinterpret_cast<const uint8_t*>(r + g) + 16 * c);
    cp_async16(buf + St::kK + tt * N * sizeof(T) + 16 * c,
               reinterpret_cast<const uint8_t*>(k + g) + 16 * c);
  }
  for (int p = tid; p < nt * kWRow; p += kThreads) {
    const int tt = p / kWRow, c = p % kWRow;
    const long long g = in0 + (long long)(t0 + tt) * is;
    cp_async16(buf + St::kW + tt * N * 4 + 16 * c,
               reinterpret_cast<const uint8_t*>(w + g) + 16 * c);
  }
  for (int p = tid; p < nt * kVRow; p += kThreads) {
    const int tt = p / kVRow, c = p % kVRow;
    const long long g = in0 + (long long)(t0 + tt) * is + j0;
    cp_async16(buf + St::kV + tt * kCols * sizeof(T) + 16 * c,
               reinterpret_cast<const uint8_t*>(v + g) + 16 * c);
  }
  cp_async_commit();
}

// Reduce and store the outputs of tokens [t0, t0 + nt): four columns of a
// token per thread and pass, one 16 B store each. The partials of a
// token lie as [row group][column]; the row groups' partials of a column
// are added in the order of a xor butterfly (xor 4, 2, 1 for 8 groups).
template <typename T, int N>
__device__ __forceinline__ void stage_out(const uint8_t* buf, float* out,
                                          long long os, int t0, int nt,
                                          int tid) {
  constexpr int kPieces = kCols / 4;
  const float* sp = reinterpret_cast<const float*>(buf + Stage<T, N>::kP);
  for (int p = tid; p < nt * kPieces; p += kThreads) {
    const int tt = p / kPieces, c = 4 * (p % kPieces);
    float4 x[kRowGroups];
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g)
      x[g] = *reinterpret_cast<const float4*>(
          sp + (tt * kRowGroups + g) * kCols + c);
#pragma unroll
    for (int off = kRowGroups / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < off; ++g) {
        x[g].x = x[g].x + x[g + off].x;
        x[g].y = x[g].y + x[g + off].y;
        x[g].z = x[g].z + x[g + off].z;
        x[g].w = x[g].w + x[g + off].w;
      }
    }
    *reinterpret_cast<float4*>(out + (long long)(t0 + tt) * os + c) = x[0];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, float* __restrict__ o, int S,
         long long ib, long long ih, long long is, long long ob,
         long long oh, long long os) {
  constexpr int P = N / kRowGroups;            // rows per thread
  constexpr int Q = kColsPerThread;
  static_assert(Q == 2, "the partials are stored as one float2");
  using St = Stage<T, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int col = tid / kRowGroups * Q;        // first column in the CTA
  const int rg = tid % kRowGroups;             // row group: rows rg*P + q
  const int j0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in0 = b * ib + h * ih;
  float* out = o + b * ob + h * oh + j0;

  float uu[P], st[Q][P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    uu[q] = u[h * N + rg * P + q];
#pragma unroll
    for (int e = 0; e < Q; ++e) st[e][q] = 0.f;
  }

  const int nch = (S + kChunk - 1) / kChunk;
  stage_in<T, N>(smem, r, k, v, w, in0, is, j0, 0, min(kChunk, S), tid);
  for (int c = 0; c < nch; ++c) {
    uint8_t* buf = smem + (c & 1) * St::kBytes;
    const int t0 = c * kChunk;
    const int nt = min(kChunk, S - t0);
    cp_async_wait_all();
    // chunk c is in `buf` for every thread, and every thread is done with
    // chunk c - 1: its inputs may be overwritten, its outputs stored
    __syncthreads();
    if (c + 1 < nch)
      stage_in<T, N>(smem + ((c + 1) & 1) * St::kBytes, r, k, v, w, in0, is,
                     j0, t0 + kChunk, min(kChunk, S - t0 - kChunk), tid);
    if (c > 0)
      stage_out<T, N>(smem + ((c - 1) & 1) * St::kBytes, out, os,
                      t0 - kChunk, kChunk, tid);
    const T* sr = reinterpret_cast<const T*>(buf + St::kR) + rg * P;
    const T* sk = reinterpret_cast<const T*>(buf + St::kK) + rg * P;
    const float* sw = reinterpret_cast<const float*>(buf + St::kW) + rg * P;
    const T* sv = reinterpret_cast<const T*>(buf + St::kV) + col;
    // this thread's partials: token tt at [tt][rg][col .. col + Q)
    float* sp = reinterpret_cast<float*>(buf + St::kP) + rg * kCols + col;
    // token tt's inputs are loaded from shared memory while token tt - 1
    // is computed: a load is never issued behind a store of the partials
    float rr[P], kk[P], ww[P], vv[Q];
    load_rows<P>(sr, rr);
    load_rows<P>(sk, kk);
    load_rows<P>(sw, ww);
    load_rows<Q>(sv, vv);
#pragma unroll 2
    for (int tt = 0; tt < nt; ++tt) {
      const int tn = min(tt + 1, nt - 1);
      float rn[P], kn[P], wn[P], vn[Q];
      load_rows<P>(sr + tn * N, rn);
      load_rows<P>(sk + tn * N, kn);
      load_rows<P>(sw + tn * N, wn);
      load_rows<Q>(sv + tn * kCols, vn);
      float y[Q];
#pragma unroll
      for (int e = 0; e < Q; ++e) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float kv = kk[q] * vv[e];
          acc[q & 3] = fmaf(rr[q], fmaf(uu[q], kv, st[e][q]), acc[q & 3]);
          st[e][q] = fmaf(st[e][q], ww[q], kv);
        }
        y[e] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      *reinterpret_cast<float2*>(sp + tt * kRowGroups * kCols) =
          make_float2(y[0], y[1]);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        rr[q] = rn[q];
        kk[q] = kn[q];
        ww[q] = wn[q];
      }
#pragma unroll
      for (int e = 0; e < Q; ++e) vv[e] = vn[e];
    }
  }
  __syncthreads();
  const int tl = (nch - 1) * kChunk;
  stage_out<T, N>(smem + ((nch - 1) & 1) * St::kBytes, out, os, tl, S - tl,
                  tid);
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* o, int B, int H,
                   int S, long long ib, long long ih, long long is,
                   long long ob, long long oh, long long os,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, N>();
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_fwd<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(N / kCols, H, B);
  wkv6_fwd<T, N><<<grid, kThreads, smem, stream>>>(
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

template <typename T>
int smem_by_size(int N) {
  switch (N) {
    case 8: return smem_bytes<T, 8>();
    case 16: return smem_bytes<T, 16>();
    case 32: return smem_bytes<T, 32>();
    case 64: return smem_bytes<T, 64>();
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// The backward: wkv6_bwd. The TPU package has no Pallas backward (it
// differentiates the jnp oracle with lax.scan); this is the gradient of
// the forward above, for training on the card. With S_t the state after
// token t (S_-1 = 0), G_t = dL/dS_t (G_{S-1} = 0), do_t = dL/do_t and
// a_t = sum_m v_t[m] do_t[m], going backwards over t:
//
//   dr_t[n] = sum_m S_{t-1}[n][m] do_t[m]          + u[n] k_t[n] a_t
//   dk_t[n] = sum_m G_t[n][m] v_t[m]               + r_t[n] u[n] a_t
//   dv_t[m] = sum_n (r_t[n] u[n] k_t[n]) do_t[m] + k_t[n] G_t[n][m]
//   dw_t[n] = sum_m G_t[n][m] S_{t-1}[n][m]
//   du[n]   = sum_{b,t} r_t[n] k_t[n] a_t
//   G_{t-1}[n][m] = w_t[n] G_t[n][m] + r_t[n] do_t[m]
//
// all in IEEE f32. Bound: like the forward, the chain of S tokens; the
// backward walks it three times (states forward, then a chunk's states
// again and the reverse walk), with ~3x the forward's work per token.
//
// Design: three kernels on one stream, no atomics, every sum in a fixed
// order (a restart under deterministic algorithms is bitwise):
//  1. wkv6_bwd_main, the forward's grid (N / kCols column groups, H, B) of
//     one warp and its thread layout (a thread: kColsPerThread columns x
//     N / kRowGroups rows of S, and of G, in registers). The columns m of
//     S and of G are independent, so each CTA walks its own columns:
//     first forward over the whole sequence, writing the state at each
//     chunk's start to a workspace (its own slice; it reads it back
//     itself); then over the chunks in reverse: the chunk's start state
//     from the workspace, the states before each of its tokens into
//     shared memory, and the reverse walk over them with G in registers.
//     dv needs only the CTA's columns: the 8 row groups' partials are
//     added with a xor butterfly over the lanes and stored. dr, dk and dw
//     sum over all columns: a CTA adds its 4 column pairs (xor 8, 16) and
//     stores the sum over its columns as one partial per column group
//     (without the u a_t terms, which need all of a_t). Inputs arrive a
//     chunk at a time by cp.async into two shared buffers, as in the
//     forward.
//  2. wkv6_bwd_reduce, grid (chunks, H, B) of N threads: a_t of each
//     token from v and do (a sum over m in order), then dr, dk and dw as
//     the column groups' partials added in order g = 0, 1, ... plus the
//     u a_t terms, and each thread's partial of du over the chunk.
//  3. wkv6_bwd_du, grid H of N threads: du as the sum of those partials
//     in (b, chunk) order.

// One chunk buffer of the backward in shared memory, in bytes: r, k, w of
// kChunk tokens (all N rows), v and do of kChunk tokens (this CTA's kCols
// columns; do in f32).
template <typename T, int N>
struct BStage {
  static constexpr int kR = 0;
  static constexpr int kK = kR + kChunk * N * (int)sizeof(T);
  static constexpr int kW = kK + kChunk * N * (int)sizeof(T);
  static constexpr int kV = kW + kChunk * N * 4;
  static constexpr int kD = kV + kChunk * kCols * (int)sizeof(T);
  static constexpr int kBytes = kD + kChunk * kCols * 4;
};

// two chunk buffers, then the states before each token of a chunk: kChunk
// x (N x kCols) f32, each token's as [column][row][thread] of the
// threads' slices
template <typename T, int N>
constexpr int bwd_smem_bytes() {
  return 2 * BStage<T, N>::kBytes + kChunk * N * kCols * 4;
}

// the workspace in floats: the chunk start states (B, H, G, chunks, N x
// kCols), the partials of dr, dk, dw (3, G, B, H, S, N), and the partials
// of du (B, chunks, H, N)
__host__ __device__ inline long long bwd_ckpt_floats(int B, int H, int S,
                                                     int N) {
  const int nch = (S + kChunk - 1) / kChunk;
  return (long long)B * H * (N / kCols) * nch * kCols * N;
}
__host__ __device__ inline long long bwd_part_floats(int B, int H, int S,
                                                     int N) {
  return 3LL * (N / kCols) * B * H * S * N;
}
__host__ __device__ inline long long bwd_du_floats(int B, int H, int S,
                                                   int N) {
  const int nch = (S + kChunk - 1) / kChunk;
  return (long long)B * nch * H * N;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);    // round to nearest even, as torch's .to
}

// Copy tokens [t0, t0 + nt) of r, k, w (whole rows) and of v and do
// (columns [j0, j0 + kCols)) into the backward's stage at `buf`.
template <typename T, int N>
__device__ __forceinline__ void bstage_in(
    uint8_t* buf, const T* r, const T* k, const T* v, const float* w,
    const float* dout, long long in0, long long is, int j0, int t0, int nt,
    int tid) {
  using St = BStage<T, N>;
  constexpr int kRow = N * (int)sizeof(T) / 16;
  constexpr int kWRow = N * 4 / 16;
  constexpr int kVRow = kCols * (int)sizeof(T) / 16;
  constexpr int kDRow = kCols * 4 / 16;
  for (int p = tid; p < nt * kRow; p += kThreads) {
    const int tt = p / kRow, c = p % kRow;
    const long long g = in0 + (long long)(t0 + tt) * is;
    cp_async16(buf + St::kR + tt * N * sizeof(T) + 16 * c,
               reinterpret_cast<const uint8_t*>(r + g) + 16 * c);
    cp_async16(buf + St::kK + tt * N * sizeof(T) + 16 * c,
               reinterpret_cast<const uint8_t*>(k + g) + 16 * c);
  }
  for (int p = tid; p < nt * kWRow; p += kThreads) {
    const int tt = p / kWRow, c = p % kWRow;
    const long long g = in0 + (long long)(t0 + tt) * is;
    cp_async16(buf + St::kW + tt * N * 4 + 16 * c,
               reinterpret_cast<const uint8_t*>(w + g) + 16 * c);
  }
  for (int p = tid; p < nt * kVRow; p += kThreads) {
    const int tt = p / kVRow, c = p % kVRow;
    const long long g = in0 + (long long)(t0 + tt) * is + j0;
    cp_async16(buf + St::kV + tt * kCols * sizeof(T) + 16 * c,
               reinterpret_cast<const uint8_t*>(v + g) + 16 * c);
  }
  for (int p = tid; p < nt * kDRow; p += kThreads) {
    const int tt = p / kDRow, c = p % kDRow;
    const long long g = in0 + (long long)(t0 + tt) * is + j0;
    cp_async16(buf + St::kD + tt * kCols * 4 + 16 * c,
               reinterpret_cast<const uint8_t*>(dout + g) + 16 * c);
  }
  cp_async_commit();
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_main(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ dout,
              T* __restrict__ dv, float* __restrict__ ckpt,
              float* __restrict__ part, int B, int H, int S, long long ib,
              long long ih, long long is) {
  constexpr int P = N / kRowGroups;            // rows per thread
  constexpr int Q = kColsPerThread;
  constexpr int G = N / kCols;                 // column groups
  constexpr int kSlice = P * Q * kThreads;     // = N x kCols floats
  static_assert(Q == 2, "a thread's columns are read as one pair");
  using St = BStage<T, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* states = reinterpret_cast<float*>(smem + 2 * St::kBytes);
  const int tid = threadIdx.x;
  const int pair = tid / kRowGroups;           // column pair: lanes 8 apart
  const int col = pair * Q;                    // first column in the CTA
  const int rg = tid % kRowGroups;             // row group: rows rg*P + q
  const int g = blockIdx.x;
  const int j0 = g * kCols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in0 = b * ib + h * ih;
  const int nch = (S + kChunk - 1) / kChunk;
  float* my_ckpt =
      ckpt + ((((long long)b * H + h) * G + g) * nch) * kSlice + tid;
  const long long plane = (long long)G * B * H * S * N;
  // this CTA's partials of dr (plane 0), dk (1) and dw (2) at token t,
  // row n: part[q * plane + (((g * B + b) * H + h) * S + t) * N + n]
  float* my_part = part + (((long long)g * B + b) * H + h) * S * N;

  float uu[P], st[Q][P], gr[Q][P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    uu[q] = u[h * N + rg * P + q];
#pragma unroll
    for (int e = 0; e < Q; ++e) st[e][q] = gr[e][q] = 0.f;
  }

  // 2 nch steps: chunks 0 .. nch-1 forward, then nch-1 .. 0 in reverse
  const int steps = 2 * nch;
  auto chunk_of = [nch](int i) { return i < nch ? i : 2 * nch - 1 - i; };
  bstage_in<T, N>(smem, r, k, v, w, dout, in0, is, j0, 0, min(kChunk, S),
                  tid);
  for (int i = 0; i < steps; ++i) {
    const uint8_t* buf = smem + (i & 1) * St::kBytes;
    const int c = chunk_of(i);
    const int t0 = c * kChunk;
    const int nt = min(kChunk, S - t0);
    cp_async_wait_all();
    // step i's chunk is in `buf` for every thread, and every thread is
    // done with step i - 1's buffer, which the next copy overwrites
    __syncthreads();
    if (i + 1 < steps) {
      const int cn = chunk_of(i + 1);
      bstage_in<T, N>(smem + ((i + 1) & 1) * St::kBytes, r, k, v, w, dout,
                      in0, is, j0, cn * kChunk,
                      min(kChunk, S - cn * kChunk), tid);
    }
    const T* sr = reinterpret_cast<const T*>(buf + St::kR) + rg * P;
    const T* sk = reinterpret_cast<const T*>(buf + St::kK) + rg * P;
    const float* sw = reinterpret_cast<const float*>(buf + St::kW) + rg * P;
    const T* sv = reinterpret_cast<const T*>(buf + St::kV) + col;
    const float* sd = reinterpret_cast<const float*>(buf + St::kD) + col;
    float* ck = my_ckpt + (long long)c * kSlice;
    if (i < nch) {
      // forward: the state before chunk c, then through its tokens (the
      // last chunk's end state is never read)
#pragma unroll
      for (int e = 0; e < Q; ++e)
#pragma unroll
        for (int q = 0; q < P; ++q)
          ck[(e * P + q) * kThreads] = st[e][q];
      if (c + 1 == nch) continue;
      for (int tt = 0; tt < nt; ++tt) {
        float kk[P], ww[P], vv[Q];
        load_rows<P>(sk + tt * N, kk);
        load_rows<P>(sw + tt * N, ww);
        load_rows<Q>(sv + tt * kCols, vv);
#pragma unroll
        for (int e = 0; e < Q; ++e)
#pragma unroll
          for (int q = 0; q < P; ++q)
            st[e][q] = fmaf(st[e][q], ww[q], kk[q] * vv[e]);
      }
      continue;
    }
    // reverse over chunk c: the states before each of its tokens
#pragma unroll
    for (int e = 0; e < Q; ++e)
#pragma unroll
      for (int q = 0; q < P; ++q) st[e][q] = ck[(e * P + q) * kThreads];
    for (int tt = 0; tt < nt; ++tt) {
      float kk[P], ww[P], vv[Q];
      load_rows<P>(sk + tt * N, kk);
      load_rows<P>(sw + tt * N, ww);
      load_rows<Q>(sv + tt * kCols, vv);
      float* sp = states + tt * kSlice + tid;
#pragma unroll
      for (int e = 0; e < Q; ++e)
#pragma unroll
        for (int q = 0; q < P; ++q) {
          sp[(e * P + q) * kThreads] = st[e][q];
          st[e][q] = fmaf(st[e][q], ww[q], kk[q] * vv[e]);
        }
    }
    // (each thread reads back only the slots it wrote: no barrier)
    for (int tt = nt - 1; tt >= 0; --tt) {
      const long long t = t0 + tt;
      float rr[P], kk[P], ww[P], vv[Q], dd[Q];
      load_rows<P>(sr + tt * N, rr);
      load_rows<P>(sk + tt * N, kk);
      load_rows<P>(sw + tt * N, ww);
      load_rows<Q>(sv + tt * kCols, vv);
      load_rows<Q>(sd + tt * kCols, dd);
      const float* sp = states + tt * kSlice + tid;
      float ruk = 0.f;                         // this thread's rows
#pragma unroll
      for (int q = 0; q < P; ++q) ruk = fmaf(rr[q] * uu[q], kk[q], ruk);
      float pr[P], pk[P], pw[P], pv[Q];
#pragma unroll
      for (int q = 0; q < P; ++q) pr[q] = pk[q] = pw[q] = 0.f;
#pragma unroll
      for (int e = 0; e < Q; ++e) {
        pv[e] = ruk * dd[e];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float sprev = sp[(e * P + q) * kThreads];
          const float gq = gr[e][q];
          pr[q] = fmaf(sprev, dd[e], pr[q]);
          pk[q] = fmaf(gq, vv[e], pk[q]);
          pw[q] = fmaf(gq, sprev, pw[q]);
          pv[e] = fmaf(kk[q], gq, pv[e]);
          gr[e][q] = fmaf(ww[q], gq, rr[q] * dd[e]);
        }
      }
      // dv: the 8 row groups of a column are lanes pair*8 .. pair*8 + 7
#pragma unroll
      for (int e = 0; e < Q; ++e)
#pragma unroll
        for (int off = 1; off < kRowGroups; off <<= 1)
          pv[e] += __shfl_xor_sync(0xffffffffu, pv[e], off);
      // dr, dk, dw over the CTA's columns: the pairs are lanes 8 apart
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int off = kRowGroups; off < kThreads; off <<= 1) {
          pr[q] += __shfl_xor_sync(0xffffffffu, pr[q], off);
          pk[q] += __shfl_xor_sync(0xffffffffu, pk[q], off);
          pw[q] += __shfl_xor_sync(0xffffffffu, pw[q], off);
        }
      }
      if (rg == 0) {
        T* dvp = dv + in0 + t * is + j0 + col;
#pragma unroll
        for (int e = 0; e < Q; ++e) dvp[e] = from_f32<T>(pv[e]);
      }
      // pair 0 stores dr's partial, 1 dk's, 2 dw's (each array indexed
      // by constants only, so that it stays in registers)
      float* dst = my_part + pair * plane + t * N + rg * P;
      if (pair == 0) {
#pragma unroll
        for (int q = 0; q < P; ++q) dst[q] = pr[q];
      } else if (pair == 1) {
#pragma unroll
        for (int q = 0; q < P; ++q) dst[q] = pk[q];
      } else if (pair == 2) {
#pragma unroll
        for (int q = 0; q < P; ++q) dst[q] = pw[q];
      }
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_bwd_reduce(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ u,
                const float* __restrict__ dout,
                const float* __restrict__ part, T* __restrict__ dr,
                T* __restrict__ dk, float* __restrict__ dw,
                float* __restrict__ du_part, int B, int H, int S,
                long long ib, long long ih, long long is) {
  constexpr int G = N / kCols;
  __shared__ float vd[kChunk][N];
  __shared__ float a[kChunk];
  const int n = threadIdx.x;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nch = gridDim.x;
  const int t0 = c * kChunk;
  const int nt = min(kChunk, S - t0);
  const long long in0 = b * ib + h * ih + n;
  for (int tt = 0; tt < nt; ++tt) {
    const long long gi = in0 + (t0 + tt) * is;
    vd[tt][n] = to_f32(v[gi]) * dout[gi];
  }
  __syncthreads();
  for (int tt = n; tt < nt; tt += N) {
    float s = 0.f;
#pragma unroll 8
    for (int m = 0; m < N; ++m) s += vd[tt][m];
    a[tt] = s;
  }
  __syncthreads();
  const float un = u[h * N + n];
  const long long plane = (long long)G * B * H * S * N;
  const long long gstride = (long long)B * H * S * N;
  float acc = 0.f;
  for (int tt = 0; tt < nt; ++tt) {
    const long long t = t0 + tt;
    const long long gi = in0 + t * is;
    const long long pi = (((long long)b * H + h) * S + t) * N + n;
    const float rn = to_f32(r[gi]), kn = to_f32(k[gi]), at = a[tt];
    float sr = 0.f, sk = 0.f, sw = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      sr += part[pi + gg * gstride];
      sk += part[plane + pi + gg * gstride];
      sw += part[2 * plane + pi + gg * gstride];
    }
    dr[gi] = from_f32<T>(fmaf(un * kn, at, sr));
    dk[gi] = from_f32<T>(fmaf(rn * un, at, sk));
    dw[gi] = sw;
    acc = fmaf(rn * kn, at, acc);
  }
  du_part[(((long long)b * nch + c) * H + h) * N + n] = acc;
}

template <int N>
__global__ void __launch_bounds__(N)
wkv6_bwd_du(const float* __restrict__ du_part, float* __restrict__ du,
            int B, int H, int nch) {
  const int h = blockIdx.x;
  const int n = threadIdx.x;
  float s = 0.f;
  for (int bc = 0; bc < B * nch; ++bc)
    s += du_part[((long long)bc * H + h) * N + n];
  du[h * N + n] = s;
}

template <typename T, int N>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* dout,
                       void* dr, void* dk, void* dv, void* dw, void* du,
                       void* ws, int B, int H, int S, long long ib,
                       long long ih, long long is, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<T, N>();
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_bwd_main<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int nch = (S + kChunk - 1) / kChunk;
  float* ckpt = static_cast<float*>(ws);
  float* part = ckpt + bwd_ckpt_floats(B, H, S, N);
  float* du_part = part + bwd_part_floats(B, H, S, N);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* ut = static_cast<const float*>(u);
  const float* dt = static_cast<const float*>(dout);
  wkv6_bwd_main<T, N><<<dim3(N / kCols, H, B), kThreads, smem, stream>>>(
      rt, kt, vt, static_cast<const float*>(w), ut, dt, static_cast<T*>(dv),
      ckpt, part, B, H, S, ib, ih, is);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wkv6_bwd_reduce<T, N><<<dim3(nch, H, B), N, 0, stream>>>(
      rt, kt, vt, ut, dt, part, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<float*>(dw), du_part, B, H, S, ib, ih, is);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wkv6_bwd_du<N><<<H, N, 0, stream>>>(du_part, static_cast<float*>(du), B,
                                      H, nch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_by_size(int N, const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* dout,
                        void* dr, void* dk, void* dv, void* dw, void* du,
                        void* ws, int B, int H, int S, long long ib,
                        long long ih, long long is, cudaStream_t st) {
  switch (N) {
    case 8:
      return launch_bwd<T, 8>(r, k, v, w, u, dout, dr, dk, dv, dw, du, ws,
                              B, H, S, ib, ih, is, st);
    case 16:
      return launch_bwd<T, 16>(r, k, v, w, u, dout, dr, dk, dv, dw, du, ws,
                               B, H, S, ib, ih, is, st);
    case 32:
      return launch_bwd<T, 32>(r, k, v, w, u, dout, dr, dk, dv, dw, du, ws,
                               B, H, S, ib, ih, is, st);
    case 64:
      return launch_bwd<T, 64>(r, k, v, w, u, dout, dr, dk, dv, dw, du, ws,
                               B, H, S, ib, ih, is, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd_smem_by_size(int N) {
  switch (N) {
    case 8: return bwd_smem_bytes<T, 8>();
    case 16: return bwd_smem_bytes<T, 16>();
    case 32: return bwd_smem_bytes<T, 32>();
    case 64: return bwd_smem_bytes<T, 64>();
    default: return -1;
  }
}

}  // namespace

// r, k, v (dtype 0: float32, 1: bfloat16) and w (float32): (B, H, S, N)
// at the shared strides (ib, ih, is); u: (H, N) float32, contiguous; o:
// (B, H, S, N) float32 at strides (ob, oh, os); the last dimension
// contiguous everywhere, every pointer and every stride in bytes a
// multiple of 16. Launches on `stream` and returns the launch's error.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* o, int dtype,
                        int B, int H, int S, int N, long long ib,
                        long long ih, long long is, long long ob,
                        long long oh, long long os, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535)
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

// The launch wkv6_fwd makes for (dtype, B, H, N): out = {grid x, grid y,
// grid z, threads per CTA, dynamic shared memory in bytes, tokens per
// chunk, columns per CTA, threads per column}. Returns a CUDA error code.
extern "C" int wkv6_plan(int dtype, int B, int H, int N, int* out) {
  const int smem = dtype == 0   ? smem_by_size<float>(N)
                   : dtype == 1 ? smem_by_size<__nv_bfloat16>(N)
                                : -1;
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const int plan[8] = {N / kCols, H,     B,     kThreads,
                       smem,      kChunk, kCols, kRowGroups};
  for (int i = 0; i < 8; ++i) out[i] = plan[i];
  return 0;
}

// The gradients of wkv6_fwd: r, k, v (dtype 0: float32, 1: bfloat16), w
// and dout (float32): (B, H, S, N) at the shared strides (ib, ih, is), as
// are the outputs dr, dk, dv (r's dtype) and dw (float32); u: (H, N) and
// du (H, N) float32, contiguous; ws: the workspace of wkv6_bwd_plan's
// bytes, 16-byte aligned. The last dimension contiguous everywhere, every
// pointer and every stride in bytes a multiple of 16. Launches three
// kernels on `stream` and returns the first launch error.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* dout,
                        void* dr, void* dk, void* dv, void* dw, void* du,
                        void* ws, int dtype, int B, int H, int S, int N,
                        long long ib, long long ih, long long is,
                        void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)bwd_by_size<float>(N, r, k, v, w, u, dout, dr, dk, dv, dw,
                                     du, ws, B, H, S, ib, ih, is, st);
    case 1:
      return (int)bwd_by_size<__nv_bfloat16>(N, r, k, v, w, u, dout, dr, dk,
                                             dv, dw, du, ws, B, H, S, ib, ih,
                                             is, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The launches wkv6_bwd makes for (dtype, B, H, S, N): out = {main grid x,
// y, z, threads, dynamic shared memory in bytes, reduce grid x (chunks),
// reduce threads, du grid, workspace bytes (as two ints: low 31 bits,
// then the rest)}. Returns a CUDA error code.
extern "C" int wkv6_bwd_plan(int dtype, int B, int H, int S, int N,
                             int* out) {
  const int smem = dtype == 0   ? bwd_smem_by_size<float>(N)
                   : dtype == 1 ? bwd_smem_by_size<__nv_bfloat16>(N)
                                : -1;
  if (smem < 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const long long ws = 4 * (bwd_ckpt_floats(B, H, S, N) +
                            bwd_part_floats(B, H, S, N) +
                            bwd_du_floats(B, H, S, N));
  const int plan[10] = {N / kCols, H, B, kThreads, smem,
                        (S + kChunk - 1) / kChunk, N, H,
                        (int)(ws & 0x7fffffff), (int)(ws >> 31)};
  for (int i = 0; i < 10; ++i) out[i] = plan[i];
  return 0;
}
