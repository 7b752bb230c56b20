// The Mamba-1 selective scan for Hopper (sm_90a), in f32, per batch row b,
// channel d and state n, from a given state h (or zeros):
//
//   h[d][n] <- exp(A[d][n] dt_t[d]) h[d][n] + (dt_t[d] u_t[d]) B_t[n]
//   y_t[d]   = sum_n C_t[n] h[d][n]
//
// and the state after the last token.
//
// Replaces no TPU kernel: the JAX package computes this scan in jnp
// (src/repro/models/blocks.py, `_selective_scan`: an associative scan
// inside 64-token chunks), outside any Pallas kernel. The port's plain
// version (kernels/selective_scan/ops.py, `selective_scan_ref`) keeps that
// structure in torch ops; on the card it moved ~3.5 GB of (chunk, d_in, N)
// f32 terms through HBM in ~45 launches a 64-token chunk.
//
// Bound: the exponentials and the bytes. At (b, S, d_in, N) =
// (1, 8192, 8192, 16), a Jamba2-Mini layer's prefill, the scan reads u and
// dt (f32, 268 MB each), writes y (268 MB) and reads B and C (1 MB): ~0.81
// GB, 0.24 ms at 3.35 TB/s; it takes 1.07e9 exponentials, 0.26 ms on the
// SFUs at 16 a clock an SM (132 SMs, 1.98 GHz); its ~7.6 GFLOP of f32 FMAs
// take 0.11 ms. Nothing of the (S, d_in, N) terms needs to reach HBM.
//
// Design: one pass, the exact recurrence in sequence. A thread carries
// kStates = 4 states of one channel in registers, so N / 4 neighbouring lanes
// hold a channel and a CTA of kThreads holds kThreads / (N / 4) channels (32
// at N = 16); the grid runs over (channel blocks, batch): 256 CTAs of 4 warps
// at the cell's shape, about 2 an SM. The terms exp(A dt) and dt u B are
// computed where they are used and never stored. Each CTA walks the sequence
// in tiles of kTile tokens: cp.async copies the next tile's u and dt at its
// channels, and its B and C, into shared memory (4-byte copies, zero-filled
// past S and d_in, so any d_in works) while this tile is computed, double-
// buffered, two barriers a tile. The exponential is exp2f of dt * (A log2 e),
// the accurate library function (no fast math): one SFU op and three FP32
// ones, against eight for expf. Two warps a scheduler hide little latency, so
// a thread takes kSub = 16 tokens at once: their 64 exponentials and (dt u) B
// terms first, which depend on no state, then the 16 steps of the recurrence
// (one dependent FMA a state and token), then the lanes' partials of y summed
// across the channel's lanes by halving with __shfl_xor_sync (12 shuffles for
// 16 tokens at N = 16, against 32 one token at a time), each lane storing the
// totals of 16 / (N / 4) tokens; the last S mod 16 tokens go one at a time (a
// predicate on each store costs 6 %). On an H100 this takes 0.61 ms at the
// shape above, against 0.95 one token at a time and 0.65 eight at a time:
// about 145 cycles a token an SM, where its 42 instructions a thread and
// token would issue in 84 and shared memory needs ~92 to hand each lane its
// 10 values a token (dt, u and 4 each of B and C; an LDS.128 takes 4 cycles a
// warp). Two states a thread, twice the warps, took 0.74-0.85 ms (more
// instructions a state). The only difference from the plain version is the
// order of rounding (sequential, one fused multiply-add per state, where the
// plain version multiplies and adds in a doubling tree) and exp2f for exp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                // threads per CTA
constexpr int kStates = 4;                   // states a thread carries
constexpr int kTile = 64;                    // tokens staged per tile
constexpr int kSub = 16;                     // tokens computed together
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// p[i]: a lane's partial of y at token i of kSub. Sums the partials of the
// channel's lanes by halving, lane bit kBit first: each round a lane keeps
// half of its tokens and adds its partner's partials of them, so that lane
// g ends with the totals of tokens g kSub / kLanes + i in p[i], i < kSub /
// kLanes: kSub - kSub / kLanes shuffles in all.
template <int kBit, int kKeep>
__device__ __forceinline__ void lane_sums(float (&p)[kSub], int g) {
  if constexpr (kBit >= 1) {
    const bool hi = g & kBit;
#pragma unroll
    for (int i = 0; i < kKeep; ++i) {
      const float keep = hi ? p[i + kKeep] : p[i];
      const float send = hi ? p[i] : p[i + kKeep];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, kBit);
    }
    lane_sums<kBit / 2, kKeep / 2>(p, g);
  }
}

template <int N>
struct Shape {
  static constexpr int kLanes = N / kStates;           // lanes a channel
  static constexpr int kChannels = kThreads / kLanes;  // channels a CTA
  static_assert(kSub % kLanes == 0, "a lane ends with whole tokens' sums");
  static_assert(kTile % kSub == 0, "a tile holds whole groups of tokens");
  // floats of one stage: u and dt at the channels, B and C
  static constexpr int kStage = kTile * (2 * kChannels + 2 * N);
  static constexpr int kSmemBytes = 2 * kStage * 4;
};

// u, dt, y: (batch, S, D); B, C: (batch, S, N); A: (D, N); h0 (or null),
// h_out: (batch, D, N); all f32 and contiguous.
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
    selective_scan_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ A,
                          const float* __restrict__ h0, float* __restrict__ y,
                          float* __restrict__ h_out, int S, int D) {
  using Sh = Shape<N>;
  constexpr int kLanes = Sh::kLanes, kCh = Sh::kChannels;
  constexpr int kRowStep = kThreads / kCh;     // rows a copy round covers
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int c = tid / kLanes;                  // the thread's channel
  const int g = tid % kLanes;                  // its group of states
  const int d0 = blockIdx.x * kCh;
  const bool live = d0 + c < D;
  const long long b = blockIdx.y;
  const float* ub = u + b * S * D;
  const float* dtb = dt + b * S * D;
  const float* Bb = Bm + b * S * N;
  const float* Cb = Cm + b * S * N;
  float* yb = y + b * S * D + d0 + c;

  float a2[kStates], h[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const long long i = (long long)(d0 + c) * N + g * kStates + k;
    a2[k] = live ? A[i] * kLog2e : 0.f;
    h[k] = live && h0 != nullptr ? h0[b * D * N + i] : 0.f;
  }

  // this thread's copies: u and dt at channel d0 + cc, rows r0 + k
  // kRowStep; B and C elements tid + k kThreads of the tile
  const int cc = tid % kCh, r0 = tid / kCh;
  const bool col_ok = d0 + cc < D;
  auto load_tile = [&](int stage, int t0) {
    float* su = smem + stage * Sh::kStage;
    float* sdt = su + kTile * kCh;
    float* sB = sdt + kTile * kCh;
    float* sC = sB + kTile * N;
#pragma unroll 4
    for (int r = r0; r < kTile; r += kRowStep) {
      const bool ok = col_ok && t0 + r < S;
      const long long off = ok ? (long long)(t0 + r) * D + d0 + cc : 0;
      cp_async4(su + r * kCh + cc, ub + off, ok);
      cp_async4(sdt + r * kCh + cc, dtb + off, ok);
    }
#pragma unroll 4
    for (int i = tid; i < kTile * N; i += kThreads) {
      const bool ok = t0 + i / N < S;
      const long long off = ok ? (long long)t0 * N + i : 0;
      cp_async4(sB + i, Bb + off, ok);
      cp_async4(sC + i, Cb + off, ok);
    }
    cp_async_commit();
  };

  const int tiles = (S + kTile - 1) / kTile;
  load_tile(0, 0);
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      load_tile((j + 1) & 1, (j + 1) * kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* su = smem + (j & 1) * Sh::kStage;
    const float* sdt = su + kTile * kCh;
    const float* sB = sdt + kTile * kCh;
    const float* sC = sB + kTile * N;
    const int t0 = j * kTile;
    const int len = min(kTile, S - t0);
    float* yt = yb + (long long)t0 * D;
    int r = 0;
    for (; r + kSub <= len; r += kSub) {
      // kSub tokens at once: their exponentials and inputs first (no
      // dependence between tokens), then the recurrence, then the sums
      float dA[kSub][kStates], dBu[kSub][kStates], p[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float dtv = sdt[(r + i) * kCh + c];
        const float dtu = dtv * su[(r + i) * kCh + c];
        const float4 Bv = *reinterpret_cast<const float4*>(
            sB + (r + i) * N + g * kStates);
        const float Bk[kStates] = {Bv.x, Bv.y, Bv.z, Bv.w};
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          dA[i][k] = exp2f(dtv * a2[k]);
          dBu[i][k] = dtu * Bk[k];
        }
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float4 Cv = *reinterpret_cast<const float4*>(
            sC + (r + i) * N + g * kStates);
#pragma unroll
        for (int k = 0; k < kStates; ++k)
          h[k] = fmaf(dA[i][k], h[k], dBu[i][k]);
        p[i] = Cv.x * h[0];
        p[i] = fmaf(Cv.y, h[1], p[i]);
        p[i] = fmaf(Cv.z, h[2], p[i]);
        p[i] = fmaf(Cv.w, h[3], p[i]);
      }
      lane_sums<kLanes / 2, kSub / 2>(p, g);
      if (live) {
#pragma unroll
        for (int i = 0; i < kSub / kLanes; ++i)
          yt[(long long)(r + g * (kSub / kLanes) + i) * D] = p[i];
      }
    }
    for (; r < len; ++r) {                     // the sequence's last tokens
      const float dtv = sdt[r * kCh + c];
      const float dtu = dtv * su[r * kCh + c];
      const float4 Bv =
          *reinterpret_cast<const float4*>(sB + r * N + g * kStates);
      const float4 Cv =
          *reinterpret_cast<const float4*>(sC + r * N + g * kStates);
      h[0] = fmaf(exp2f(dtv * a2[0]), h[0], dtu * Bv.x);
      h[1] = fmaf(exp2f(dtv * a2[1]), h[1], dtu * Bv.y);
      h[2] = fmaf(exp2f(dtv * a2[2]), h[2], dtu * Bv.z);
      h[3] = fmaf(exp2f(dtv * a2[3]), h[3], dtu * Bv.w);
      float q = Cv.x * h[0];
      q = fmaf(Cv.y, h[1], q);
      q = fmaf(Cv.z, h[2], q);
      q = fmaf(Cv.w, h[3], q);
#pragma unroll
      for (int m = 1; m < kLanes; m <<= 1)
        q += __shfl_xor_sync(0xffffffffu, q, m);
      if (g == 0 && live) yt[(long long)r * D] = q;
    }
    __syncthreads();                           // before the refill
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kStates; ++k)
      h_out[b * D * N + (long long)(d0 + c) * N + g * kStates + k] = h[k];
  }
}

template <int N>
cudaError_t launch(const void* u, const void* dt, const void* Bm,
                   const void* Cm, const void* A, const void* h0, void* y,
                   void* h_out, int batch, int S, int D, cudaStream_t st) {
  using Sh = Shape<N>;
  auto kern = selective_scan_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((D + Sh::kChannels - 1) / Sh::kChannels, batch);
  kern<<<grid, kThreads, Sh::kSmemBytes, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), S, D);
  return cudaGetLastError();
}

}  // namespace

// The scan of the file's head: u, dt, y (batch, S, D); B, C (batch, S, N);
// A (D, N); h0 (batch, D, N) or null for zeros; h_out (batch, D, N), the
// state after the last token. All f32, contiguous, 4-byte aligned; N 4 or
// 16. Launches one kernel on `stream`; returns a CUDA error code.
extern "C" int selective_scan_fwd(const void* u, const void* dt,
                                  const void* Bm, const void* Cm,
                                  const void* A, const void* h0, void* y,
                                  void* h_out, int batch, int S, int D, int N,
                                  void* stream) {
  if (batch <= 0 || S <= 0 || D <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4:
      return (int)launch<4>(u, dt, Bm, Cm, A, h0, y, h_out, batch, S, D,
                            st);
    case 16:
      return (int)launch<16>(u, dt, Bm, Cm, A, h0, y, h_out, batch, S, D,
                             st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch selective_scan_fwd makes for (batch, D, N): out = {grid x,
// grid y, threads per CTA, dynamic shared memory in bytes, tokens a tile,
// channels a CTA}. Returns a CUDA error code.
extern "C" int selective_scan_plan(int batch, int D, int N, int* out) {
  int ch, smem;
  switch (N) {
    case 4: ch = Shape<4>::kChannels; smem = Shape<4>::kSmemBytes; break;
    case 16: ch = Shape<16>::kChannels; smem = Shape<16>::kSmemBytes; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (batch <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int plan[6] = {(D + ch - 1) / ch, batch, kThreads, smem, kTile, ch};
  for (int i = 0; i < 6; ++i) out[i] = plan[i];
  return 0;
}
