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
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
// The backward: wkv6_bwd. The TPU package has no Pallas backward: it takes
// the gradient of its `wkv6` (src/repro/kernels/rwkv6/kernel.py:78) by
// jax.vjp through the jnp oracle (ref.wkv6_ref, a lax.scan). This is the
// gradient of the forward above, for training on the card. With S_t the
// state after token t (S_-1 = 0), G_t = dL/dS_t (G_{S-1} = 0), do_t =
// dL/do_t and a_t = sum_m v_t[m] do_t[m], going backwards over t:
//
//   dr_t[n] = sum_m S_{t-1}[n][m] do_t[m]          + u[n] k_t[n] a_t
//   dk_t[n] = sum_m G_t[n][m] v_t[m]               + r_t[n] u[n] a_t
//   dv_t[m] = sum_n (r_t[n] u[n] k_t[n]) do_t[m] + k_t[n] G_t[n][m]
//   dw_t[n] = sum_m G_t[n][m] S_{t-1}[n][m]
//   du[n]   = sum_{b,t} r_t[n] k_t[n] a_t
//   G_{t-1}[n][m] = w_t[n] G_t[n][m] + r_t[n] do_t[m]
//
// all in IEEE f32. Bound: operations (f32 FMAs, ~14 n^2 a token and head)
// and shared memory: each token's partial sums (dr, dk, dw over a
// thread's columns, dv over its rows) cross the CTA through it. A walk
// over tokens is a chain, so the card fills only if many walks run at
// once: a walk per (b, h) and column group over all S tokens gives 320
// one-warp walks at rwkv6-3b's (1, 40, 4096, 64), fewer than the card's
// 528 schedulers.
//
// Design. The decay is diagonal, so a chunk c of kChunk tokens [t0, t1)
// maps the state and G exactly:
//   S_{t1-1} = D_c o S_{t0-1} + S_c^0,   G_{t0-1} = D_c o G_{t1-1} + G_c^0
// with D_c[n] = prod_{t in c} w_t[n] scaling row n, and S_c^0, G_c^0 the
// chunk's own walks from zero (products of w only: nothing is divided, so
// nothing overflows). Four kernels on one stream, no atomics, every sum in
// a fixed order (a restart under deterministic algorithms is bitwise):
//  1. wkv6_bwd_local, grid (row groups x chunks, H, B): each chunk's D_c,
//     and S_c^0 and G_c^0 at the CTA's rows as sums of products (k_t
//     times the decay after t, r_t times the decay before it), into the
//     workspace, with a_t and du's partial over the chunk (many small
//     CTAs an SM hide these short serial sums).
//  2. wkv6_bwd_carry, one thread per (b, h, row, 4 columns), serial in the
//     chunk: S's walk forward and G's backward over the chunks, turning
//     S_c^0 into chunk c's start state and G_c^0 into its end G, in place.
//  3. wkv6_bwd_chunk, the same tiles: from its start state a CTA walks its
//     chunk forward keeping the states before each kSub-token sub-chunk;
//     then per sub-chunk, last first, it recomputes the sub-chunk's
//     states into registers and walks back from the G the walk has
//     reached (the chunk's end G first), writing the gradients.
//  4. wkv6_bwd_du: du as the sum of the chunks' partials in (b, chunk)
//     order.
// The state is split by rows: a CTA holds kR rows (16, or n below 16) and
// all n columns, so dr, dk, dw and a_t are complete inside it; only dv (a
// sum over rows) crosses CTAs, and the n / kR row groups of a chunk form
// a thread-block cluster that adds their dv in rank order through
// distributed shared memory. A thread holds a 2 x 4 tile of S and of G,
// and the states of its sub-chunk, in registers. Each token's partial
// sums go to shared memory; after a sub-chunk the CTA adds them in
// column-quad and row-pair order, so no token waits on a sum across
// threads. Inputs arrive a chunk at a time by cp.async; both layouts are
// read and written through the strides. At (1, 40, 4096, 64) that is
// 20480 CTAs of 4 warps (4 row groups x 128 chunks x 40 heads), each
// walking 32 tokens, and a workspace of 0.17 GB (the chunks' start
// states and end Gs, 84 MB each).

constexpr int kSub = 8;                      // tokens whose states are held
constexpr int kSubs = kChunk / kSub;         // sub-chunks a chunk
constexpr int kRT = 2;                       // state rows a thread
constexpr int kCT = 4;                       // state columns a thread
constexpr int kCarryThreads = 128;
constexpr int kCarryBatch = 16;              // chunks loaded at once

// The CTA tile of the backward for head size N.
template <int N>
struct BTile {
  static constexpr int kR = N < 16 ? N : 16;          // rows per CTA
  static constexpr int kGroups = N / kR;              // CTAs of a cluster
  static constexpr int kRP = kR / kRT;                // row pairs
  static constexpr int kCQ = N / kCT;                 // column quads
  static constexpr int kTile = kRP * kCQ;             // threads holding state
  static constexpr int kThreads = kTile < 32 ? 32 : kTile;
  // a plane of a token's partials: one entry per thread, and one of
  // padding after every 16, so that the sums over a row pair's column
  // quads fall on different banks
  static constexpr int kStride = kTile + kTile / 16;
};

__device__ __forceinline__ int slot_pos(int tid) { return tid + tid / 16; }

// The backward's shared memory in bytes: r, k (T) and w (f32) of kChunk
// tokens at the CTA's rows, v (T) and do (f32) at all N columns, a_t;
// then for the chunk kernel u at the CTA's rows and kSub tokens' partials
// (dr, dk, dw: three planes of kStride float2; dv: one plane of kStride
// float4), for the local kernel k and r times their tokens' decay
// products (kChunk x kR f32 each).
template <typename T, int N>
struct BSmem {
  using Tl = BTile<N>;
  static constexpr int oR = 0;
  static constexpr int oK = oR + kChunk * Tl::kR * (int)sizeof(T);
  static constexpr int oW = oK + kChunk * Tl::kR * (int)sizeof(T);
  static constexpr int oV = oW + kChunk * Tl::kR * 4;
  static constexpr int oD = oV + kChunk * N * (int)sizeof(T);
  static constexpr int oA = oD + kChunk * N * 4;
  static constexpr int oU = oA + kChunk * 4;
  static constexpr int oP2 = oU + Tl::kR * 4;
  static constexpr int oP4 = oP2 + kSub * 3 * Tl::kStride * 8;
  static constexpr int kBytes = oP4 + kSub * Tl::kStride * 16;
  static constexpr int oKt = oU;
  static constexpr int oRt = oKt + kChunk * Tl::kR * 4;
  static constexpr int kLocal = oRt + kChunk * Tl::kR * 4;
};

// the workspace in floats: chunk start states and chunk end Gs (each
// (B, H, chunks, N, N)), the chunks' decays (B, H, chunks, N), a_t (B, H,
// chunks, kChunk), and the partials of du (B, chunks, H, N)
__host__ __device__ inline long long bwd_state_floats(int B, int H, int S,
                                                      int N) {
  const int nch = (S + kChunk - 1) / kChunk;
  return (long long)B * H * nch * N * N;
}
__host__ __device__ inline long long bwd_row_floats(int B, int H, int S,
                                                    int N) {
  const int nch = (S + kChunk - 1) / kChunk;
  return (long long)B * H * nch * N;
}
__host__ __device__ inline long long bwd_token_floats(int B, int H, int S) {
  const int nch = (S + kChunk - 1) / kChunk;
  return (long long)B * H * nch * kChunk;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// values to consecutive elements (aligned to their count)
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  // round to nearest even, as torch's .to
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void store2(float* p, float2 x) {
  *reinterpret_cast<float2*>(p) = x;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 x) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x.x, x.y);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// Copy chunk [t0, t0 + nt) of r, k, w (rows [n0, n0 + kR)) and of v and
// do (all N columns) into the backward's stage and, where given, the
// chunk's a_t and u's rows (`ur`: u at row n0) after it.
template <typename T, int N>
__device__ __forceinline__ void bstage_in(
    uint8_t* sm, const T* r, const T* k, const T* v, const float* w,
    const float* dout, const float* a, const float* ur, long long in0,
    long long is, int n0, int t0, int nt, int tid) {
  using Tl = BTile<N>;
  using Sm = BSmem<T, N>;
  constexpr int kRow = Tl::kR * (int)sizeof(T) / 16;
  constexpr int kWRow = Tl::kR * 4 / 16;
  constexpr int kVRow = N * (int)sizeof(T) / 16;
  constexpr int kDRow = N * 4 / 16;
  for (int p = tid; p < nt * kRow; p += Tl::kThreads) {
    const int tt = p / kRow, c = p % kRow;
    const long long g = in0 + (long long)(t0 + tt) * is + n0;
    cp_async16(sm + Sm::oR + tt * Tl::kR * sizeof(T) + 16 * c,
               reinterpret_cast<const uint8_t*>(r + g) + 16 * c);
    cp_async16(sm + Sm::oK + tt * Tl::kR * sizeof(T) + 16 * c,
               reinterpret_cast<const uint8_t*>(k + g) + 16 * c);
  }
  for (int p = tid; p < nt * kWRow; p += Tl::kThreads) {
    const int tt = p / kWRow, c = p % kWRow;
    const long long g = in0 + (long long)(t0 + tt) * is + n0;
    cp_async16(sm + Sm::oW + tt * Tl::kR * 4 + 16 * c,
               reinterpret_cast<const uint8_t*>(w + g) + 16 * c);
  }
  for (int p = tid; p < nt * kVRow; p += Tl::kThreads) {
    const int tt = p / kVRow, c = p % kVRow;
    const long long g = in0 + (long long)(t0 + tt) * is;
    cp_async16(sm + Sm::oV + tt * N * sizeof(T) + 16 * c,
               reinterpret_cast<const uint8_t*>(v + g) + 16 * c);
  }
  for (int p = tid; p < nt * kDRow; p += Tl::kThreads) {
    const int tt = p / kDRow, c = p % kDRow;
    const long long g = in0 + (long long)(t0 + tt) * is;
    cp_async16(sm + Sm::oD + tt * N * 4 + 16 * c,
               reinterpret_cast<const uint8_t*>(dout + g) + 16 * c);
  }
  if (a != nullptr && tid < kChunk / 4)
    cp_async16(sm + Sm::oA + 16 * tid, a + 4 * tid);
  if (ur != nullptr && tid < Tl::kR / 4)
    cp_async16(sm + Sm::oU + 16 * tid, ur + 4 * tid);
  cp_async_commit();
}

// One token's inputs at a thread's rows (r, k, w) and columns (v, do)
struct TokenIn {
  float r[kRT], k[kRT], w[kRT], v[kCT], d[kCT];
};

// k, w and v of token tt of the stage (what a step of S needs)
template <typename T, int N>
__device__ __forceinline__ void step_in(TokenIn& x, const T* sk,
                                        const float* sw, const T* sv,
                                        int tt) {
  load_rows<kRT>(sk + tt * BTile<N>::kR, x.k);
  load_rows<kRT>(sw + tt * BTile<N>::kR, x.w);
  load_rows<kCT>(sv + tt * N, x.v);
}

// S <- S o w + k v^T on a thread's tile
__device__ __forceinline__ void state_step(float (&st)[kRT][kCT],
                                           const TokenIn& x) {
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < kCT; ++j)
      st[i][j] = fmaf(st[i][j], x.w[i], x.k[i] * x.v[j]);
}

// a thread's tile of a (N x N) state in the workspace
__device__ __forceinline__ void tile_load(const float* p, int N,
                                          float (&x)[kRT][kCT]) {
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const float4 f = *reinterpret_cast<const float4*>(p + i * N);
    x[i][0] = f.x; x[i][1] = f.y; x[i][2] = f.z; x[i][3] = f.w;
  }
}
__device__ __forceinline__ void tile_store(float* p, int N,
                                           float (&x)[kRT][kCT]) {
#pragma unroll
  for (int i = 0; i < kRT; ++i)
    *reinterpret_cast<float4*>(p + i * N) =
        make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
}

// 1. Each chunk's decay D_c, and its walks from zero: S_c^0 forward and
// G_c^0 backward, at the CTA's rows, as sums of products (k_t times the
// decay after t, r_t times the decay before it: one FMA an element and
// token); a_t of the chunk's tokens (written by row group 0) and du's
// partial over the chunk at the CTA's rows.
template <typename T, int N>
__global__ void __launch_bounds__(BTile<N>::kThreads)
wkv6_bwd_local(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ dout, float* __restrict__ ws_s,
               float* __restrict__ ws_g, float* __restrict__ ws_d,
               float* __restrict__ ws_a, float* __restrict__ du_part,
               int H, int S, long long ib, long long ih, long long is) {
  using Tl = BTile<N>;
  using Sm = BSmem<T, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int grp = blockIdx.x % Tl::kGroups, c = blockIdx.x / Tl::kGroups;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nch = (S + kChunk - 1) / kChunk;
  const int t0 = c * kChunk, nt = min(kChunk, S - t0);
  const int n0 = grp * Tl::kR;
  const long long in0 = b * ib + h * ih;
  bstage_in<T, N>(smem, r, k, v, w, dout, nullptr, nullptr, in0, is, n0,
                  t0, nt, tid);
  cp_async_wait_all();
  __syncthreads();
  const T* sr_all = reinterpret_cast<const T*>(smem + Sm::oR);
  const T* sk_all = reinterpret_cast<const T*>(smem + Sm::oK);
  const T* sv_all = reinterpret_cast<const T*>(smem + Sm::oV);
  const float* sd_all = reinterpret_cast<const float*>(smem + Sm::oD);
  const float* sw_all = reinterpret_cast<const float*>(smem + Sm::oW);
  float* sa = reinterpret_cast<float*>(smem + Sm::oA);
  float* skt = reinterpret_cast<float*>(smem + Sm::oKt);
  float* srt = reinterpret_cast<float*>(smem + Sm::oRt);
  // a_t: a thread of the last warp per token, over the columns from
  // column t on (so that the threads of a warp read different banks), in
  // that order
  const int ta = tid - (Tl::kThreads - 32);
  if (ta >= 0 && ta < nt) {
    float p = 0.f;
#pragma unroll 8
    for (int j = 0; j < N; ++j) {
      const int m = (j + ta) & (N - 1);
      p = fmaf(to_f32(sv_all[ta * N + m]), sd_all[ta * N + m], p);
    }
    sa[ta] = p;
    if (grp == 0)
      ws_a[(((long long)b * H + h) * nch + c) * kChunk + ta] = p;
  }
  // per row: k_t times the decay after t (the chunk's decay D_c when t
  // runs past the start), r_t times the decay before t
  if (tid < Tl::kR) {
    float p = 1.f;
    for (int tt = nt - 1; tt >= 0; --tt) {
      skt[tt * Tl::kR + tid] = to_f32(sk_all[tt * Tl::kR + tid]) * p;
      p *= sw_all[tt * Tl::kR + tid];
    }
    ws_d[(((long long)b * H + h) * nch + c) * N + n0 + tid] = p;
    p = 1.f;
    for (int tt = 0; tt < nt; ++tt) {
      srt[tt * Tl::kR + tid] = to_f32(sr_all[tt * Tl::kR + tid]) * p;
      p *= sw_all[tt * Tl::kR + tid];
    }
  }
  __syncthreads();
  // du's partial over the chunk, per row of the CTA: tokens t = 4i + e
  // into four sums e, added as (0 + 1) + (2 + 3)
  if (tid < Tl::kR) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t4 = 0; t4 < nt; t4 += 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = t4 + e;
        if (tt < nt)
          acc[e] = fmaf(to_f32(sr_all[tt * Tl::kR + tid]) *
                            to_f32(sk_all[tt * Tl::kR + tid]),
                        sa[tt], acc[e]);
      }
    }
    du_part[(((long long)b * nch + c) * H + h) * N + n0 + tid] =
        (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  // S_c^0 = sum_t (k_t o decay after t) v_t^T and G_c^0 = sum_t (r_t o
  // decay before t) do_t^T, in token order: the walks from zero unrolled
  if (tid < Tl::kTile) {
    const int rl = tid / Tl::kCQ * kRT, col = tid % Tl::kCQ * kCT;
    const T* sv = sv_all + col;
    const float* sd = sd_all + col;
    float st[kRT][kCT], gr[kRT][kCT];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kCT; ++j) st[i][j] = gr[i][j] = 0.f;
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      float kt[kRT], rt[kRT], vv[kCT], dd[kCT];
      load_rows<kRT>(skt + tt * Tl::kR + rl, kt);
      load_rows<kRT>(srt + tt * Tl::kR + rl, rt);
      load_rows<kCT>(sv + tt * N, vv);
      load_rows<kCT>(sd + tt * N, dd);
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
          st[i][j] = fmaf(kt[i], vv[j], st[i][j]);
          gr[i][j] = fmaf(rt[i], dd[j], gr[i][j]);
        }
    }
    const long long tile = (((long long)b * H + h) * nch + c) * N * N +
                           (long long)(n0 + rl) * N + col;
    tile_store(ws_s + tile, N, st);
    tile_store(ws_g + tile, N, gr);
  }
}

// 2. The carry, in place: chunk c's S_c^0 becomes its start state (S's
// walk forward, grid y = 0) and its G_c^0 its end G (G's walk backward,
// grid y = 1), run <- D_c o run + x. A thread owns 4 columns of one row of
// one (b, h) and walks the chunks in order, issuing kCarryBatch chunks'
// loads before their sums.
template <int N>
__global__ void __launch_bounds__(kCarryThreads)
wkv6_bwd_carry(float* __restrict__ ws_s, float* __restrict__ ws_g,
               const float* __restrict__ ws_d, int BH, int nch) {
  constexpr int kQ = N * N / 4;                // float4 of a state
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= (long long)BH * kQ) return;
  const int bh = (int)(i / kQ), e = (int)(i % kQ), n = e / (N / 4);
  const bool fwd = blockIdx.y == 0;
  float4* x = reinterpret_cast<float4*>(fwd ? ws_s : ws_g) +
              (long long)bh * nch * kQ + e;
  const float* dec = ws_d + (long long)bh * nch * N + n;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nch; c0 += kCarryBatch) {
    const int cnt = min(kCarryBatch, nch - c0);
    float4 xs[kCarryBatch];
    float ds[kCarryBatch];
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      if (q < cnt) {
        const int c = fwd ? c0 + q : nch - 1 - c0 - q;
        xs[q] = x[(long long)c * kQ];
        ds[q] = dec[(long long)c * N];
      }
    }
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      if (q < cnt) {
        const int c = fwd ? c0 + q : nch - 1 - c0 - q;
        x[(long long)c * kQ] = run;
        run = make_float4(fmaf(ds[q], run.x, xs[q].x),
                          fmaf(ds[q], run.y, xs[q].y),
                          fmaf(ds[q], run.z, xs[q].z),
                          fmaf(ds[q], run.w, xs[q].w));
      }
    }
  }
}

// 3. The gradients of one chunk at the CTA's rows (see the note above).
template <typename T, int N>
__global__ void __launch_bounds__(BTile<N>::kThreads)
wkv6_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ dout,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, const float* __restrict__ ws_s,
               const float* __restrict__ ws_g,
               const float* __restrict__ ws_a, int H, int S, long long ib,
               long long ih, long long is) {
  using Tl = BTile<N>;
  using Sm = BSmem<T, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int grp = blockIdx.x % Tl::kGroups, c = blockIdx.x / Tl::kGroups;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nch = (S + kChunk - 1) / kChunk;
  const int t0 = c * kChunk, nt = min(kChunk, S - t0);
  const int n0 = grp * Tl::kR;
  const long long in0 = b * ib + h * ih;
  bstage_in<T, N>(smem, r, k, v, w, dout,
                  ws_a + (((long long)b * H + h) * nch + c) * kChunk,
                  u + h * N + n0, in0, is, n0, t0, nt, tid);
  const T* sr_all = reinterpret_cast<const T*>(smem + Sm::oR);
  const T* sk_all = reinterpret_cast<const T*>(smem + Sm::oK);
  // do, and each token's dv partial of the CTA once the token is done
  float* sd_all = reinterpret_cast<float*>(smem + Sm::oD);
  const float* sa = reinterpret_cast<const float*>(smem + Sm::oA);
  float2* part2 = reinterpret_cast<float2*>(smem + Sm::oP2);
  float4* part4 = reinterpret_cast<float4*>(smem + Sm::oP4);
  const bool act = tid < Tl::kTile;
  const int rl = act ? tid / Tl::kCQ * kRT : 0;
  const int col = act ? tid % Tl::kCQ * kCT : 0;
  const long long tile = (((long long)b * H + h) * nch + c) * N * N +
                         (long long)(n0 + rl) * N + col;
  // the start state and the end G come in while the stage does
  float uu[kRT], cp[kSubs][kRT][kCT], gr[kRT][kCT];
  tile_load(ws_s + tile, N, cp[0]);
  tile_load(ws_g + tile, N, gr);
  load_rows<kRT>(u + h * N + n0 + rl, uu);
  cp_async_wait_all();
  __syncthreads();
  const T* sr = sr_all + rl;
  const T* sk = sk_all + rl;
  const float* sw = reinterpret_cast<const float*>(smem + Sm::oW) + rl;
  const T* sv = reinterpret_cast<const T*>(smem + Sm::oV) + col;
  const float* sd = sd_all + col;
  const int nsub = (nt + kSub - 1) / kSub;
  // the states before each sub-chunk, from the chunk's start state
  if (act) {
#pragma unroll
    for (int j = 1; j < kSubs; ++j) {
      if (j < nsub) {
#pragma unroll
        for (int i = 0; i < kRT; ++i)
#pragma unroll
          for (int q = 0; q < kCT; ++q) cp[j][i][q] = cp[j - 1][i][q];
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          TokenIn x;
          step_in<T, N>(x, sk, sw, sv, (j - 1) * kSub + s);
          state_step(cp[j], x);
        }
      }
    }
  }
  const int my = slot_pos(tid);
#pragma unroll
  for (int j = kSubs - 1; j >= 0; --j) {
    if (j >= nsub) continue;
    const int tlo = j * kSub, ns = min(kSub, nt - tlo);
    if (act) {
      // the states before each token of the sub-chunk, in registers
      float hist[kSub][kRT][kCT];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int q = 0; q < kCT; ++q) hist[0][i][q] = cp[j][i][q];
#pragma unroll
      for (int s = 1; s < kSub; ++s) {
        if (s < ns) {
#pragma unroll
          for (int i = 0; i < kRT; ++i)
#pragma unroll
            for (int q = 0; q < kCT; ++q) hist[s][i][q] = hist[s - 1][i][q];
          TokenIn x;
          step_in<T, N>(x, sk, sw, sv, tlo + s - 1);
          state_step(hist[s], x);
        }
      }
      // the reverse walk from the G reached; token s's partials to its
      // slot
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        if (s < ns) {
          const int tt = tlo + s;
          TokenIn x;
          step_in<T, N>(x, sk, sw, sv, tt);
          load_rows<kRT>(sr + tt * Tl::kR, x.r);
          load_rows<kCT>(sd + tt * N, x.d);
          float ruk = 0.f;                     // this thread's rows
#pragma unroll
          for (int i = 0; i < kRT; ++i)
            ruk = fmaf(x.r[i] * uu[i], x.k[i], ruk);
          float pr[kRT], pk[kRT], pw[kRT], pv[kCT];
#pragma unroll
          for (int q = 0; q < kCT; ++q) pv[q] = ruk * x.d[q];
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            pr[i] = pk[i] = pw[i] = 0.f;
#pragma unroll
            for (int q = 0; q < kCT; ++q) {
              const float g = gr[i][q], sp = hist[s][i][q];
              pr[i] = fmaf(sp, x.d[q], pr[i]);
              pk[i] = fmaf(g, x.v[q], pk[i]);
              pw[i] = fmaf(g, sp, pw[i]);
              pv[q] = fmaf(x.k[i], g, pv[q]);
              gr[i][q] = fmaf(x.w[i], g, x.r[i] * x.d[q]);
            }
          }
          float2* p2 = part2 + s * 3 * Tl::kStride + my;
          p2[0] = make_float2(pr[0], pr[1]);
          p2[Tl::kStride] = make_float2(pk[0], pk[1]);
          p2[2 * Tl::kStride] = make_float2(pw[0], pw[1]);
          part4[s * Tl::kStride + my] = make_float4(pv[0], pv[1], pv[2],
                                                    pv[3]);
        }
      }
    }
    __syncthreads();                           // the sub-chunk's partials
    // dr, dk, dw of 2 rows and a token: the row pair's column quads in
    // order, then the u a_t terms
    for (int x = tid; x < ns * Tl::kRP * 3; x += Tl::kThreads) {
      const int rp = x % Tl::kRP, q = x / Tl::kRP % 3;
      const int s = x / (Tl::kRP * 3);
      const float2* p = part2 + (s * 3 + q) * Tl::kStride;
      float2 acc = p[slot_pos(rp * Tl::kCQ)];
#pragma unroll
      for (int cq = 1; cq < Tl::kCQ; ++cq)
        acc = add2(acc, p[slot_pos(rp * Tl::kCQ + cq)]);
      const int tt = tlo + s, nl = rp * kRT;
      const long long gi = in0 + (long long)(t0 + tt) * is + n0 + nl;
      if (q == 2) {
        store2(dw + gi, acc);
        continue;
      }
      float un[kRT], xn[kRT];
      load_rows<kRT>(reinterpret_cast<const float*>(smem + Sm::oU) + nl, un);
      // dr: u k a_t; dk: r u a_t
      load_rows<kRT>((q == 0 ? sk_all : sr_all) + tt * Tl::kR + nl, xn);
      const float at = sa[tt];
      acc = make_float2(fmaf(un[0] * xn[0], at, acc.x),
                        fmaf(un[1] * xn[1], at, acc.y));
      store2((q == 0 ? dr : dk) + gi, acc);
    }
    // the CTA's dv of 4 columns and a token: its row pairs in order,
    // into the token's do (no longer read)
    for (int x = tid; x < ns * Tl::kCQ; x += Tl::kThreads) {
      const int s = x / Tl::kCQ, cq = x % Tl::kCQ;
      const float4* p = part4 + s * Tl::kStride;
      float4 acc = p[slot_pos(cq)];
#pragma unroll
      for (int rp = 1; rp < Tl::kRP; ++rp)
        acc = add4(acc, p[slot_pos(rp * Tl::kCQ + cq)]);
      store4(sd_all + (tlo + s) * N + cq * kCT, acc);
    }
    __syncthreads();                           // the slots are free again
  }
  // dv: the cluster's row groups in rank order, each CTA N / kGroups of
  // the columns
  constexpr int kDvCols = N / Tl::kGroups;
  constexpr int kDvQuads = kDvCols / 4;
  if constexpr (Tl::kGroups > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                            // every CTA's dv is written
    for (int x = tid; x < nt * kDvQuads; x += Tl::kThreads) {
      const int s = x / kDvQuads, cc = grp * kDvCols + x % kDvQuads * 4;
      float4 acc = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(sd_all + s * N + cc, 0));
#pragma unroll
      for (int g = 1; g < Tl::kGroups; ++g)
        acc = add4(acc, *reinterpret_cast<const float4*>(
                            cluster.map_shared_rank(sd_all + s * N + cc, g)));
      store4(dv + in0 + (long long)(t0 + s) * is + cc, acc);
    }
    cluster.sync();                            // no CTA leaves while read
  } else {
    for (int x = tid; x < nt * kDvQuads; x += Tl::kThreads) {
      const int s = x / kDvQuads, cc = x % kDvQuads * 4;
      store4(dv + in0 + (long long)(t0 + s) * is + cc,
             *reinterpret_cast<const float4*>(sd_all + s * N + cc));
    }
  }
}

// 4. du as the sum of the chunks' partials in (b, chunk) order.
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
  using Tl = BTile<N>;
  using Sm = BSmem<T, N>;
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_bwd_chunk<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sm::kBytes);
  if (e != cudaSuccess) return e;
  const int nch = (S + kChunk - 1) / kChunk;
  float* ws_s = static_cast<float*>(ws);
  float* ws_g = ws_s + bwd_state_floats(B, H, S, N);
  float* ws_d = ws_g + bwd_state_floats(B, H, S, N);
  float* ws_a = ws_d + bwd_row_floats(B, H, S, N);
  float* du_part = ws_a + bwd_token_floats(B, H, S);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* wt = static_cast<const float*>(w);
  const float* dt = static_cast<const float*>(dout);
  const dim3 grid(Tl::kGroups * nch, H, B);
  wkv6_bwd_local<T, N><<<grid, Tl::kThreads, Sm::kLocal, stream>>>(
      rt, kt, vt, wt, dt, ws_s, ws_g, ws_d, ws_a, du_part, H, S, ib, ih,
      is);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long quads = (long long)B * H * N * N / 4;
  wkv6_bwd_carry<N><<<dim3((unsigned)((quads + kCarryThreads - 1) /
                                      kCarryThreads), 2),
                      kCarryThreads, 0, stream>>>(ws_s, ws_g, ws_d, B * H,
                                                  nch);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Tl::kThreads);
  cfg.dynamicSmemBytes = Sm::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)Tl::kGroups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = Tl::kGroups > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, wkv6_bwd_chunk<T, N>, rt, kt, vt, wt,
                         static_cast<const float*>(u), dt,
                         static_cast<T*>(dr), static_cast<T*>(dk),
                         static_cast<T*>(dv), static_cast<float*>(dw),
                         static_cast<const float*>(ws_s),
                         static_cast<const float*>(ws_g),
                         static_cast<const float*>(ws_a), H, S, ib, ih, is);
  if (e != cudaSuccess) return e;
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

// {chunk kernel's dynamic shared memory, local kernel's, threads a CTA,
// CTAs a cluster} for (T, N)
template <typename T, int N>
void bwd_shape(int* out) {
  out[0] = BSmem<T, N>::kBytes;
  out[1] = BSmem<T, N>::kLocal;
  out[2] = BTile<N>::kThreads;
  out[3] = BTile<N>::kGroups;
}

template <typename T>
int bwd_shape_by_size(int N, int* out) {
  switch (N) {
    case 8: bwd_shape<T, 8>(out); return 0;
    case 16: bwd_shape<T, 16>(out); return 0;
    case 32: bwd_shape<T, 32>(out); return 0;
    case 64: bwd_shape<T, 64>(out); return 0;
    default: return -1;
  }
}

// CTAs an SM holds of the local, carry and chunk kernels for (T, N), as
// the runtime reckons them from registers, shared memory and threads
template <typename T, int N>
cudaError_t bwd_occupancy(int* out) {
  using Sm = BSmem<T, N>;
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_bwd_chunk<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sm::kBytes);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], wkv6_bwd_local<T, N>, BTile<N>::kThreads, Sm::kLocal);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], wkv6_bwd_carry<N>, kCarryThreads, 0);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], wkv6_bwd_chunk<T, N>, BTile<N>::kThreads, Sm::kBytes);
}

template <typename T>
cudaError_t bwd_occupancy_by_size(int N, int* out) {
  switch (N) {
    case 8: return bwd_occupancy<T, 8>(out);
    case 16: return bwd_occupancy<T, 16>(out);
    case 32: return bwd_occupancy<T, 32>(out);
    case 64: return bwd_occupancy<T, 64>(out);
    default: return cudaErrorInvalidValue;
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
// pointer and every stride in bytes a multiple of 16. Launches four
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

// The launches wkv6_bwd makes for (dtype, B, H, S, N): out = {local and
// chunk kernels' grid x (row groups x chunks), y (H), z (B), CTAs a
// cluster (row groups), threads a CTA, the chunk kernel's dynamic shared
// memory in bytes, the local kernel's, the carry's grid x (its y is 2)
// and threads, the du kernel's grid, workspace bytes (as two ints: low 31
// bits, then the rest)}. Returns a CUDA error code.
extern "C" int wkv6_bwd_plan(int dtype, int B, int H, int S, int N,
                             int* out) {
  int shape[4];
  const int rc = dtype == 0   ? bwd_shape_by_size<float>(N, shape)
                 : dtype == 1 ? bwd_shape_by_size<__nv_bfloat16>(N, shape)
                              : -1;
  if (rc < 0 || B <= 0 || H <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int nch = (S + kChunk - 1) / kChunk;
  const long long ws = 4 * (2 * bwd_state_floats(B, H, S, N) +
                            2 * bwd_row_floats(B, H, S, N) +
                            bwd_token_floats(B, H, S));
  const long long quads = (long long)B * H * N * N / 4;
  const int plan[12] = {shape[3] * nch, H, B, shape[3], shape[2], shape[0],
                        shape[1],
                        (int)((quads + kCarryThreads - 1) / kCarryThreads),
                        kCarryThreads, H, (int)(ws & 0x7fffffff),
                        (int)(ws >> 31)};
  for (int i = 0; i < 12; ++i) out[i] = plan[i];
  return 0;
}

// CTAs an SM holds of wkv6_bwd's local, carry and chunk kernels for
// (dtype, N), as the runtime reckons them from each kernel's registers,
// shared memory and threads: out = {local, carry, chunk}. Returns a CUDA
// error code.
extern "C" int wkv6_bwd_occupancy(int dtype, int N, int* out) {
  switch (dtype) {
    case 0: return (int)bwd_occupancy_by_size<float>(N, out);
    case 1: return (int)bwd_occupancy_by_size<__nv_bfloat16>(N, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
