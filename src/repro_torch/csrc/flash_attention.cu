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
// operations-per-byte line, so the arithmetic sets the pace: the tensor
// cores for bf16, the FMA pipes for f32.
//
// Two kernels, chosen by dtype (dispatch, not fallback: each dtype has
// exactly one kernel, and a launch that cannot run returns an error):
//
// bf16: `flash_fwd_bf16`, built for the tensor cores. One CTA of three
// warpgroups per (128-query block, head, batch). Warpgroup 0 is the
// producer: it gives back registers (setmaxnreg 40), and one thread
// issues TMA copies of the Q block once and of each 128-key K and V tile
// into a ring of two stages, with a full and an empty mbarrier per stage,
// so the next tile's loads overlap this tile's math. Warpgroups 1 and 2
// are consumers of 64 query rows each (setmaxnreg 232). Per tile each
// runs S = Q K^T as wgmma m64n128k16 from shared memory (K is K-major as
// it lies, keys x D), the online softmax on the accumulator's registers
// (each row lives on the 4 threads of a quad: two shuffles reduce it;
// exp2 of the f32-scaled scores folded with log2 e), converts p to bf16
// pairs in registers (the TPU kernel's p.astype(v.dtype)) and runs
// O += P V as a second wgmma with A from those registers and B the V
// tile read MN-major through the descriptor's transpose bit, so V is
// never transposed. m, l and O never leave registers. Shared memory is
// 128-byte swizzled (64-byte for D = 32, whose rows are 64 B): the TMA
// maps, the wgmma descriptors and the epilogue's stores agree on it; a
// D = 128 row is two 64-column boxes. The causal skip is the kv loop's
// bound and only the last (diagonal or ragged) tile is masked; the grid
// hands out the longest causal query blocks first, so the triangle
// leaves no long tail. Rows past S are zero-filled by TMA on load and
// clipped by the TMA store of the epilogue, which goes through the
// consumer's own rows of the Q tile in shared memory. Later work on this
// kernel: softmax overlapped with the next tile's Q K^T inside a
// warpgroup, ping-pong scheduling of the two consumers, persistent CTAs.
//
// f32: `flash_fwd_f32`, IEEE FMA, never TF32 (f32 inputs hold 1e-5).
// One CTA of 256 threads per (64-query block, head, batch); Q and each
// 64-row K/V tile staged in shared memory as f32 (rows padded to D+1),
// the scores' 64x64 tile spread 4x4 per thread, p through shared memory
// to the P.V product, m, l and the accumulator in registers.
//
// Any S: the ragged edge is masked. Tensors are addressed through
// (batch, head, seq) strides with the head dimension contiguous, so the
// (B, S, H, D) layout of the model and the (B, H, S, D) layout of the
// kernel API both run without a transpose; the bf16 kernel's TMA maps
// need those strides and the base pointers to be multiples of 16 bytes.
#include <cuda.h>          // CUtensorMap and its enums only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: IEEE FMA
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // keys per K/V tile
constexpr int kThreads = 256;     // 16 x 16: ty owns 4 rows, tx 4 columns

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
constexpr size_t smem_f32() {
  return sizeof(float) * (3 * kBK * (D + 1) + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int group,
              int S, int causal, float scale, long long qb, long long qh,
              long long qs, long long kb, long long kh, long long ks,
              long long vb, long long vh, long long vs, long long ob,
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
  const float* qp = q + b * qb + h * qh;
  const float* kp = k + b * kb + (h / group) * kh;
  const float* vp = v + b * vb + (h / group) * vh;
  float* op = o + b * ob + h * oh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * LD + c] = (q0 + r < S) ? qp[(long long)(q0 + r) * qs + c] : 0.f;
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
      sK[r * LD + c] = in ? kp[(long long)(k0 + r) * ks + c] : 0.f;
      sV[r * LD + c] = in ? vp[(long long)(k0 + r) * vs + c] : 0.f;
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
        sP[(ty * 4 + i) * PLD + tx + 16 * j] = p;
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
      op[(long long)r * os + tx + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kTQ = 128;              // query rows per CTA (2 x 64)
constexpr int kTK = 128;              // keys per K/V tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kWG = 128;              // threads of a warpgroup
constexpr int kTmaThreads = 3 * kWG;  // producer + two consumers
constexpr int kConsumers = 2 * kWG;

// Shared memory of one CTA. A 128-row tile (Q, K or V) is kBoxes boxes
// of 128 rows x kSwizzle bytes, each as TMA writes it with that swizzle.
template <int D>
struct Tile {
  static constexpr int kSwizzle = D == 32 ? 64 : 128;  // bytes of a box row
  static constexpr int kBoxCols = kSwizzle / 2;        // bf16 columns
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kBox = kTK * kSwizzle;
  static constexpr int kBytes = kBoxes * kBox;
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;  // wgmma
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBytes;
  static constexpr int kV = kK + kStages * kBytes;
  static constexpr int kBar = kV + kStages * kBytes;
  // Q full; per stage K full, V full, K/V empty; + slack to align to 1 KB
  static constexpr int kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one box of a 4-D tensor map (D, S, heads, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(row), "r"(head),
      "r"(batch), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int d, int row,
                                          int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units) and the swizzle mode
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// the byte a TMA box with this swizzle puts at `off` (from a 1 KB line)
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return SW == 128 ? off ^ (((off >> 7) & 7) << 4)
                   : off ^ (((off >> 7) & 3) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pin accumulator registers at this point of the program, so the
// compiler moves no access to them across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D(64 x 128) (+)= A(64 x 16) B(16 x 128); A and B from shared memory,
// both K-major; scale_d 0 ignores D's old value
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x N) += A(64 x 16) B(16 x N) for N = 32, 64, 128; A from
// registers (four bf16 pairs in the accumulator's fragment order), B
// from shared memory, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (D == 32)
    wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, int B, int H,
               int group, int S, int causal, float scale_log2) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle lines are 1 KB
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sq = base + T::kQ, sk = base + T::kK, sv = base + T::kV;
  const uint32_t bar_q = base + T::kBar;
  const uint32_t bar_k = bar_q + 8;                 // + 8 s
  const uint32_t bar_v = bar_k + 8 * kStages;       // + 8 s
  const uint32_t bar_e = bar_v + 8 * kStages;       // + 8 s

  // the longest causal query blocks (the last ones) are handed out first
  const int nq = (S + kTQ - 1) / kTQ;
  const int hb = blockIdx.x % (H * B);
  const int slot = blockIdx.x / (H * B);
  const int qb = causal ? nq - 1 - slot : slot;
  const int h = hb % H, b = hb / H;
  const int q0 = qb * kTQ;
  const int n_kv = (S + kTK - 1) / kTK;
  // causal: tiles strictly above the block's diagonal do no work
  const int nk = causal ? min(n_kv, qb + 1) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, T::kBytes);
      for (int i = 0; i < T::kBoxes; ++i)
        tma_load(sq + i * T::kBox, &tq, bar_q, i * T::kBoxCols, q0, h, b);
      const int kvh = h / group;
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        mbar_wait(bar_e + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, T::kBytes);
        for (int i = 0; i < T::kBoxes; ++i)
          tma_load(sk + s * T::kBytes + i * T::kBox, &tk, bar_k + 8 * s,
                   i * T::kBoxCols, t * kTK, kvh, b);
        mbar_expect_tx(bar_v + 8 * s, T::kBytes);
        for (int i = 0; i < T::kBoxes; ++i)
          tma_load(sv + s * T::kBytes + i * T::kBox, &tv, bar_v + 8 * s,
                   i * T::kBoxCols, t * kTK, kvh, b);
      }
    }
  } else {
    // consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / kWG - 1;
    const int tid = threadIdx.x % kWG;
    const int warp = tid / 32, lane = tid % 32;
    // accumulator layout: element 4j+e of a thread is row r0 + 8 (e / 2)
    // of the tile, column 8j + c0 + (e % 2)
    const int r0 = 64 * wg + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t qa = sq + wg * 64 * T::kSwizzle;
    constexpr int kPerBox = T::kBoxCols / 16;  // k16 steps in one box

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows r0, r0+8
    mbar_wait(bar_q, 0);

    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      const uint32_t kt = sk + s * T::kBytes, vt = sv + s * T::kBytes;

      // S = Q K^T
      float sc[kTK / 2];
      mbar_wait(bar_k + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / kPerBox) * T::kBox + (kk % kPerBox) * 32;
        wgmma_ss_n128(
            sc, smem_desc(qa + off, 16, 8 * T::kSwizzle, T::kLayout),
            smem_desc(kt + off, 16, 8 * T::kSwizzle, T::kLayout), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      // the diagonal (causal) or ragged (keys >= S) tile is the last one
      const int k0 = t * kTK;
      if (t == nk - 1 && (causal || k0 + kTK > S)) {
#pragma unroll
        for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + c0 + (e & 1);
            const int qp = q0 + r0 + 8 * (e >> 1);
            if (kp >= S || (causal && kp > qp)) sc[4 * j + e] = kNegInf;
          }
      }

      // online softmax: each row lives on the 4 threads of a quad
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < kTK / 8; ++j) {
        x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, w));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, w));
      }
      // exp(s/sqrt(D) - m) as exp2 of the scores scaled by log2(e)/sqrt(D)
      const float a0 = exp2f((m0 - x0) * scale_log2);
      const float a1 = exp2f((m1 - x1) * scale_log2);
      m0 = x0;
      m1 = x1;
      const float b0 = x0 * scale_log2, b1 = x1 * scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kTK / 8; ++j) {
        sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, -b0));
        sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, -b0));
        sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, -b1));
        sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, -b1));
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;          // this thread's share; quad-summed last
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
      // p rounded to bf16: k16 step kk of P.V takes pairs 4kk .. 4kk+3
      uint32_t pa[kTK / 4];
#pragma unroll
      for (int i = 0; i < kTK / 4; ++i)
        pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

      // O += P V
      mbar_wait(bar_v + 8 * s, phase);
      pin(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)
        wgmma_rs<D>(o, pa + 4 * kk,
                    smem_desc(vt + kk * 16 * T::kSwizzle, T::kBox,
                              8 * T::kSwizzle, T::kLayout));
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      mbar_arrive(bar_e + 8 * s);   // this thread is done with stage s
    }

    // epilogue: o / max(l, 1e-30) in bf16, staged in this warpgroup's
    // rows of the Q tile (swizzled as TMA reads it) and stored by TMA,
    // which drops the rows past S
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, w);
      l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + c0;
      const uint32_t col = (c / T::kBoxCols) * T::kBox + (c % T::kBoxCols) * 2;
      *reinterpret_cast<uint32_t*>(
          gbase + T::kQ + swizzle<T::kSwizzle>(col + r0 * T::kSwizzle)) =
          pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
      *reinterpret_cast<uint32_t*>(
          gbase + T::kQ +
          swizzle<T::kSwizzle>(col + (r0 + 8) * T::kSwizzle)) =
          pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWG) : "memory");
    if (tid == 0) {
      for (int i = 0; i < T::kBoxes; ++i)
        tma_store(&to, qa + i * T::kBox, i * T::kBoxCols, q0 + 64 * wg, h,
                  b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links without -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a TMA map of a bf16 tensor as (D, S, heads, batch) at (seq, head,
// batch) strides in elements, boxes of `rows` rows and one swizzle span
bool tensor_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
                int B, long long sb, long long sh, long long ss, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int sw = D == 32 ? 64 : 128;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)sw / 2, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool is_sm90() {
  int dev = 0, major = 0, minor = 0;
  return cudaGetDevice(&dev) == cudaSuccess &&
         cudaDeviceGetAttribute(&major, cudaDevAttrComputeCapabilityMajor,
                                dev) == cudaSuccess &&
         cudaDeviceGetAttribute(&minor, cudaDevAttrComputeCapabilityMinor,
                                dev) == cudaSuccess &&
         major == 9 && minor == 0;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, KV, S, causal;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_f32(const Args& a) {
  if (a.H > 65535 || a.B > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_f32<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.H / a.KV,
      a.S, a.causal, scale, a.qb, a.qh, a.qs, a.kb, a.kh, a.ks, a.vb, a.vh,
      a.vs, a.ob, a.oh, a.os);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  if (!is_sm90()) return cudaErrorNoKernelImageForDevice;
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map(&mq, a.q, D, a.S, a.H, a.B, a.qb, a.qh, a.qs, kTQ) ||
      !tensor_map(&mk, a.k, D, a.S, a.KV, a.B, a.kb, a.kh, a.ks, kTK) ||
      !tensor_map(&mv, a.v, D, a.S, a.KV, a.B, a.vb, a.vh, a.vs, kTK) ||
      !tensor_map(&mo, a.o, D, a.S, a.H, a.B, a.ob, a.oh, a.os, 64))
    return cudaErrorInvalidValue;
  const int smem = Tile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.S + kTQ - 1) / kTQ) * a.H * a.B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_fwd_bf16<D><<<(unsigned)blocks, kTmaThreads, smem, a.stream>>>(
      mq, mk, mv, mo, a.B, a.H, a.H / a.KV, a.S, a.causal, scale_log2);
  return cudaGetLastError();
}

cudaError_t by_dim(int dtype, int D, const Args& a) {
  switch (dtype * 1000 + D) {
    case 32: return launch_f32<32>(a);
    case 64: return launch_f32<64>(a);
    case 128: return launch_f32<128>(a);
    case 1032: return launch_bf16<32>(a);
    case 1064: return launch_bf16<64>(a);
    case 1128: return launch_bf16<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, S, D) at strides (qb, qh, qs); k and v: (B, KV, S, D) at
// strides (kb, kh, ks) and (vb, vh, vs); o: like q at strides (ob, oh,
// os); the last dimension contiguous in all four. dtype 0: float32 (FMA
// kernel), 1: bfloat16 (wgmma kernel: sm_90 only, 16-byte aligned
// pointers and strides). Launches on `stream` and returns
// cudaGetLastError() of the launch, or the error that kept it from
// launching.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KV, int S, int D, int causal,
                                   long long qb, long long qh, long long qs,
                                   long long kb, long long kh, long long ks,
                                   long long vb, long long vh, long long vs,
                                   long long ob, long long oh, long long os,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || S <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  o,  B,  H,  KV, S,  causal, qb, qh, qs,
               kb, kh, ks, vb, vh, vs, ob, oh, os,
               static_cast<cudaStream_t>(stream)};
  return (int)by_dim(dtype, D, a);
}

// dynamic shared memory of one CTA of the kernel for (dtype, D), or -1
extern "C" int flash_attention_smem(int dtype, int D) {
  switch (dtype * 1000 + D) {
    case 32: return (int)smem_f32<32>();
    case 64: return (int)smem_f32<64>();
    case 128: return (int)smem_f32<128>();
    case 1032: return Tile<32>::kSmem;
    case 1064: return Tile<64>::kSmem;
    case 1128: return Tile<128>::kSmem;
    default: return -1;
  }
}
