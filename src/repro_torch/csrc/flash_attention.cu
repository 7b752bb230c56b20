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
// cores for bf16 (989 TFLOP/s); for f32 the function's flops over the FMA
// pipes' 67 TFLOP/s (2.05 ms at B=1 H=32 S=4096 causal), and for the
// split-TF32 kernel below three times those flops over the 495 TFLOP/s of
// TF32 (0.833 ms there).
//
// Two kernels, chosen by dtype (dispatch, not fallback: each dtype has
// exactly one kernel, and a launch that cannot run returns an error); both
// are sm_90a only:
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
// f32: `flash_fwd_f32`, on the tensor cores in three TF32 products (the
// split of CUTLASS's OpMultiplyAddFastF32): each f32 operand x becomes
// hi = rna_tf32(x) and lo = rna_tf32(x - hi), so x = hi + lo to within
// 2^-22 |x|, and each product is a_hi b_hi + a_hi b_lo + a_lo b_hi, the
// dropped a_lo b_lo being another 2^-22 -- the order of an f32 FMA sum
// over D = 128. The tensor cores add into an f32 accumulator without
// IEEE rounding (they truncate; over all 4096 keys of one accumulator
// P V erred 14x an FMA sum on the card), so the kernel bounds how many
// such adds any value takes: S as hi.hi (D / 8 adds) in one accumulator
// and the small hi.lo + lo.hi in another, joined by one IEEE add; P V of
// each 32-key tile in a fresh accumulator (12 adds) added to the running
// output in IEEE f32. f32 outputs hold 1e-5 of the plain version.
// One CTA of two warpgroups per (64-query block, head, batch), 197 KB of
// shared memory at D = 128 (Q hi and lo 64 KB; two stages of K hi, K lo,
// V^T hi and V^T lo, 64 KB each), so one CTA per SM. 64 KB more for a
// second math warpgroup's Q, or the 64 registers Q hi would take in
// registers beside the fresh P V accumulator, do not fit.
// - A splitting warpgroup loads each 32-key K and V tile with 16-byte
//   loads into one of two register sets (tile t + 1's loads are issued
//   before tile t is split, so they land while it splits; the values
//   must pass through registers to be split, so there is no landing
//   buffer), waits for the stage to drain, splits and stores K as it
//   lies and V transposed -- tf32 wgmma reads only K-major operands --
//   with each group of 8 keys permuted (keys 2i, 2i + 1 to columns i,
//   i + 4) so that the S accumulator's registers are P's A fragment as
//   they lie. A warp's V load takes 8 keys x 64 B (coalesced; its
//   transposed stores then meet 2-way bank conflicts). A full and an
//   empty mbarrier per stage.
// - A math warpgroup splits its Q block once, then per tile runs
//   S = Q K^T as 3 x D / 8 wgmma m64n32k8 from shared memory (their
//   descriptors rebuilt per tile, not held in registers), the online
//   softmax on the accumulator (exp2 with the scale folded with log2 e,
//   as bf16), splits p in registers and runs P V as 12 wgmma m64nDk8
//   with A from those registers. m, l and the output stay in registers.
// Against the FMA kernel it replaces: no scalar shared loads (wgmma reads
// the swizzled tiles itself), loading and splitting overlap the math
// through the two stages, p never goes through shared memory, the four
// math warps keep asynchronous wgmma in flight instead of small register
// tiles, the longest causal blocks go first, and the tensor cores'
// 495 TFLOP/s replace the FMA pipes' 67. The causal skip is the loop's
// bound; only the tiles on the diagonal and the ragged one are masked.
// Rows and keys past S are loaded as zeros and never stored. Not done:
// S of tile t + 1 issued over tile t's softmax (ptxas serialised the
// wgmma and spilled, both times it was tried).
//
// Any S: the ragged edge is masked. Tensors are addressed through
// (batch, head, seq) strides with the head dimension contiguous, so the
// (B, S, H, D) layout of the model and the (B, H, S, D) layout of the
// kernel API both run without a transpose; the bf16 kernel's TMA maps
// and the f32 kernel's 16-byte loads need those strides and the base
// pointers to be multiples of 16 bytes.
#include <cuda.h>          // CUtensorMap and its enums only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// The work of CTA `cta` in a grid of ceil(S / rows) H B CTAs: the batch,
// head and block of `rows` queries it runs, and how many `keys`-wide K/V
// tiles that block reads. Causal, the longest query blocks (the last
// ones) are handed out first, and tiles strictly above the block's
// diagonal do no work. Both kernels and flash_attention_order use it.
struct CtaWork {
  int b, h, qblock, kv_tiles;
};

__host__ __device__ __forceinline__ CtaWork cta_work(int cta, int B, int H,
                                                     int S, int causal,
                                                     int rows, int keys) {
  const int nq = (S + rows - 1) / rows, n_kv = (S + keys - 1) / keys;
  const int hb = cta % (H * B), slot = cta / (H * B);
  const int qblock = causal ? nq - 1 - slot : slot;
  const int last = (qblock * rows + rows - 1) / keys + 1;
  return {hb / H, hb % H, qblock, causal && last < n_kv ? last : n_kv};
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

  const CtaWork work = cta_work(blockIdx.x, B, H, S, causal, kTQ, kTK);
  const int h = work.h, b = work.b, q0 = work.qblock * kTQ;
  const int nk = work.kv_tiles;

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
// f32: three TF32 products on wgmma, fed by a splitting warpgroup
// ---------------------------------------------------------------------------

constexpr int kFQ = 64;               // query rows per CTA: one math warpgroup
constexpr int kFK = 32;               // keys per stage: one 128 B row of f32
constexpr int kFThreads = 2 * kWG;    // splitter + math

// Shared memory of one CTA. Every tile is a K-major f32 wgmma operand in
// boxes of 32 columns (128 B rows, 128-byte swizzle, 8-row groups 1 KB
// apart), hi and lo apart: Q (64 rows x D, D / 32 boxes) once; per stage K
// (32 keys x D, D / 32 boxes) and V^T (D rows x 32 keys, one box).
template <int D>
struct F32Tile {
  static constexpr int kQBox = kFQ * 128;  // one box of Q
  static constexpr int kKBox = kFK * 128;  // one box of K
  static constexpr int kQ = kFQ * D * 4;   // Q hi or lo
  static constexpr int kT = kFK * D * 4;   // K or V^T, hi or lo
  static constexpr int kQhi = 0;
  static constexpr int kQlo = kQ;
  static constexpr int kStage = 4 * kT;    // K hi, K lo, V^T hi, V^T lo
  static constexpr int kKV = 2 * kQ;       // stage s at kKV + s kStage
  static constexpr int kBar = kKV + kStages * kStage;
  // per stage a full and an empty barrier; + slack to align to 1 KB
  static constexpr int kSmem = kBar + 16 * kStages + 1024;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to within 2^-22 |x|, both tf32 rounded to nearest, ties
// away from zero: hi by cvt.rna (a NaN stays a NaN), lo by the same
// rounding done on its bits -- add half of the low 13 bits' range, clear
// them -- which costs less than a second cvt; x - hi is finite and small
// wherever x is finite, so the carry cannot reach the sign bit
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// byte offset of f32 (row, col) in a K-major tile of ROWS rows
template <int ROWS>
__device__ __forceinline__ uint32_t kmajor(int row, int col) {
  return (col / 32) * (ROWS * 128) + swizzle<128>(row * 128 + (col % 32) * 4);
}

__device__ __forceinline__ uint64_t f32_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024, 1);
}

// D(64 x 32) (+)= A(64 x 8) B(8 x 32) in tf32, A and B from shared memory
__device__ __forceinline__ void tf32_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x N) (+)= A(64 x 8) B(8 x N) in tf32 for N = 32, 64, 128; A from
// registers (rows r, r + 8 at columns c, c + 4), B from shared memory
__device__ __forceinline__ void tf32_rs_n32(float (&d)[16], const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_rs_n64(float (&d)[32], const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_rs_n128(float (&d)[64],
                                             const uint32_t* a, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void tf32_rs(float (&d)[D / 2], const uint32_t* a,
                                        uint64_t db, int scale_d) {
  if constexpr (D == 32)
    tf32_rs_n32(d, a, db, scale_d);
  else if constexpr (D == 64)
    tf32_rs_n64(d, a, db, scale_d);
  else
    tf32_rs_n128(d, a, db, scale_d);
}

// issue S = Q K^T of the stage at kt: hi.hi into sc, hi.lo + lo.hi into
// sx, 3 x D / 8 wgmma m64n32k8 from shared memory, as one commit group
template <int D>
__device__ __forceinline__ void f32_scores(float (&sc)[kFK / 2],
                                           float (&sx)[kFK / 2],
                                           uint32_t base, uint32_t kt) {
  using T = F32Tile<D>;
  // rebuilt per call: 2 x D / 8 descriptors of Q held across the tile
  // loop would take 4 D / 8 registers
  asm volatile("" : "+r"(base));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t qo = (kk / 4) * T::kQBox + (kk % 4) * 32;
    const uint32_t ko = (kk / 4) * T::kKBox + (kk % 4) * 32;
    const uint64_t qa = f32_desc(base + T::kQhi + qo);
    const uint64_t kh = f32_desc(kt + ko);
    tf32_ss_n32(sc, qa, kh, kk > 0);
    tf32_ss_n32(sx, qa, f32_desc(kt + T::kT + ko), kk > 0);
    tf32_ss_n32(sx, f32_desc(base + T::kQlo + qo), kh, 1);
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kFThreads, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int B,
              int H, int group, int S, int causal, float scale_log2,
              long long qb, long long qh, long long qs, long long kb,
              long long kh, long long ks, long long vb, long long vh,
              long long vs, long long ob, long long oh, long long os) {
  using T = F32Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle lines are 1 KB
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + T::kBar;           // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 s

  const CtaWork work = cta_work(blockIdx.x, B, H, S, causal, kFQ, kFK);
  const int h = work.h, b = work.b, q0 = work.qblock * kFQ;
  const int nk = work.kv_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, kWG);
      mbar_init(bar_empty + 8 * s, kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int kVec = D / 4;                  // float4 in a row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if (threadIdx.x < kWG) {
    // splitter: loads each 32-key tile of K and V into registers with
    // 16-byte loads (tile t + 1's issued before tile t is split, into the
    // other of two register sets, so they land while it splits), splits
    // it into tf32 hi and lo, and stores K as it lies and V transposed.
    // Warp w loads V's keys 8w .. 8w + 7, 64 B of each row per load; key
    // 8w + j goes to V^T column 8w + j / 2 (j even) or 8w + 4 + j / 2 (j
    // odd): the columns where the tf32 A fragment of P holds the
    // accumulator's columns j and j + 1.
    const float* kp = k + b * kb + (h / group) * kh;
    const float* vp = v + b * vb + (h / group) * vh;
    const int vq = lane / 4, vc = lane % 4;
    const int vcol = 8 * warp + (vq & 1) * 4 + vq / 2;
    constexpr int kPer = kFK * kVec / kWG;     // float4 of K, and of V
    auto load = [&](int t, float4 (&kd)[kPer], float4 (&vd)[kPer]) {
      const int k0 = t * kFK;
      const int key = k0 + 8 * warp + vq;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + kWG * i;
        const int row = k0 + idx / kVec;
        kd[i] = row < S ? ldg4(kp + row * ks + 4 * (idx % kVec)) : zero;
        vd[i] = key < S ? ldg4(vp + key * vs + 16 * i + 4 * vc) : zero;
      }
    };
    auto store = [&](int t, const float4 (&kd)[kPer],
                     const float4 (&vd)[kPer]) {
      const int s = t % kStages;
      mbar_wait(bar_empty + 8 * s, ((t / kStages) & 1) ^ 1);
      uint8_t* const st = gbase + T::kKV + s * T::kStage;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + kWG * i;
        const uint32_t off = kmajor<kFK>(idx / kVec, 4 * (idx % kVec));
        uint4 hi, lo;
        split4(kd[i], hi, lo);
        *reinterpret_cast<uint4*>(st + off) = hi;
        *reinterpret_cast<uint4*>(st + T::kT + off) = lo;
        split4(vd[i], hi, lo);
        const uint32_t hs[4] = {hi.x, hi.y, hi.z, hi.w};
        const uint32_t ls[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 16 * i + 4 * vc + e;
          const uint32_t vo = swizzle<128>(d * 128 + vcol * 4);
          *reinterpret_cast<uint32_t*>(st + 2 * T::kT + vo) = hs[e];
          *reinterpret_cast<uint32_t*>(st + 3 * T::kT + vo) = ls[e];
        }
      }
      // the generic-proxy stores become visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bar_full + 8 * s);
    };
    float4 ka[kPer], va[kPer], kn[kPer], vn[kPer];
    load(0, ka, va);
    for (int t = 0; t < nk; t += 2) {
      if (t + 1 < nk) load(t + 1, kn, vn);
      store(t, ka, va);
      if (t + 1 < nk) {
        if (t + 2 < nk) load(t + 2, ka, va);
        store(t + 1, kn, vn);
      }
    }
  } else {
    // math: Q split into hi and lo once, then per tile S and P V
    const float* qp = q + b * qb + h * qh;
    for (int i = tid; i < kFQ * kVec; i += kWG) {
      const int row = i / kVec, c = 4 * (i % kVec);
      const float4 x = q0 + row < S ? ldg4(qp + (q0 + row) * qs + c) : zero;
      uint4 hi, lo;
      split4(x, hi, lo);
      const uint32_t off = kmajor<kFQ>(row, c);
      *reinterpret_cast<uint4*>(gbase + T::kQhi + off) = hi;
      *reinterpret_cast<uint4*>(gbase + T::kQlo + off) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWG) : "memory");

    // accumulator layout: element 4j+e of a thread is row r0 + 8 (e / 2)
    // of the tile, column 8j + c0 + (e % 2)
    const int r0 = 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int row0 = q0 + r0, row1 = row0 + 8;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows r0, r0+8

    // per tile: S as hi.hi in one accumulator and hi.lo + lo.hi in
    // another, so the small terms' truncation in the tensor core's adds
    // stays small and the two meet in one IEEE add; the online softmax;
    // P V
    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages;
      const uint32_t kt = base + T::kKV + s * T::kStage;
      const uint32_t vhi = kt + 2 * T::kT, vlo = kt + 3 * T::kT;
      float sc[kFK / 2], sx[kFK / 2];
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
      f32_scores<D>(sc, sx, base, kt);
      wgmma_wait_all();
      pin(sc);
      pin(sx);
#pragma unroll
      for (int i = 0; i < kFK / 2; ++i) sc[i] += sx[i];

      // the diagonal tiles (causal) and the ragged one (keys >= S)
      const int k0 = t * kFK;
      if ((causal && k0 + kFK - 1 > q0) || k0 + kFK > S) {
#pragma unroll
        for (int j = 0; j < kFK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + c0 + (e & 1);
            const int qpos = (e >> 1) ? row1 : row0;
            if (kpos >= S || (causal && kpos > qpos)) sc[4 * j + e] = kNegInf;
          }
      }

      // online softmax: each row lives on the 4 threads of a quad
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < kFK / 8; ++j) {
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
      for (int j = 0; j < kFK / 8; ++j) {
        sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, -b0));
        sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, -b0));
        sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, -b1));
        sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, -b1));
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;          // this thread's share; quad-summed last
      l1 = l1 * a1 + sum1;
      // p split into tf32 hi and lo in the A fragment's order: k8 step j
      // takes accumulator columns 8j + c0 and 8j + c0 + 1 as its columns
      // c0 / 2 and c0 / 2 + 4 (V^T's columns were permuted to match)
      uint32_t ph[kFK / 2], pl[kFK / 2];
#pragma unroll
      for (int j = 0; j < kFK / 8; ++j) {
        split_tf32(sc[4 * j], ph[4 * j], pl[4 * j]);
        split_tf32(sc[4 * j + 2], ph[4 * j + 1], pl[4 * j + 1]);
        split_tf32(sc[4 * j + 1], ph[4 * j + 2], pl[4 * j + 2]);
        split_tf32(sc[4 * j + 3], ph[4 * j + 3], pl[4 * j + 3]);
      }

      // this tile's P V in a fresh accumulator (12 tensor-core adds),
      // added to the running output in IEEE f32
      float pv[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFK / 8; ++kk) {
        const uint64_t vh_d = f32_desc(vhi + kk * 32);
        tf32_rs<D>(pv, ph + 4 * kk, vh_d, kk > 0);
        tf32_rs<D>(pv, ph + 4 * kk, f32_desc(vlo + kk * 32), 1);
        tf32_rs<D>(pv, pl + 4 * kk, vh_d, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(pv);
      mbar_arrive(bar_empty + 8 * s);   // this thread is done with stage s
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        acc[i] = fmaf(acc[i], (i & 2) ? a1 : a0, pv[i]);
    }

    // epilogue: acc / max(l, 1e-30) straight to device memory
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, w);
      l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    float* const op = o + b * ob + h * oh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + c0;
      if (row0 < S)
        *reinterpret_cast<float2*>(op + row0 * os + c) =
            make_float2(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      if (row1 < S)
        *reinterpret_cast<float2*>(op + row1 * os + c) =
            make_float2(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
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

// The launch flash_attention_fwd makes for (dtype, B, H, S, D): both
// the launch and flash_attention_plan take their numbers from here.
struct Plan {
  long long ctas;
  int threads, smem, rows, keys, stages, load, math;
};

bool plan_of(int dtype, int B, int H, int S, int D, Plan* p) {
  int smem = -1;
  switch (dtype * 1000 + D) {
    case 32: smem = F32Tile<32>::kSmem; break;
    case 64: smem = F32Tile<64>::kSmem; break;
    case 128: smem = F32Tile<128>::kSmem; break;
    case 1032: smem = Tile<32>::kSmem; break;
    case 1064: smem = Tile<64>::kSmem; break;
    case 1128: smem = Tile<128>::kSmem; break;
    default: return false;
  }
  const bool f32 = dtype == 0;
  const int rows = f32 ? kFQ : kTQ;
  *p = {(long long)((S + rows - 1) / rows) * H * B,
        f32 ? kFThreads : kTmaThreads,
        smem,
        rows,
        f32 ? kFK : kTK,
        kStages,
        1,
        f32 ? 1 : 2};
  return true;
}

template <int D>
cudaError_t launch_f32(const Args& a, const Plan& p) {
  if (!is_sm90()) return cudaErrorNoKernelImageForDevice;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_fwd_f32<D><<<(unsigned)p.ctas, p.threads, p.smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.B, a.H,
      a.H / a.KV, a.S, a.causal, scale_log2, a.qb, a.qh, a.qs, a.kb, a.kh,
      a.ks, a.vb, a.vh, a.vs, a.ob, a.oh, a.os);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a, const Plan& p) {
  if (!is_sm90()) return cudaErrorNoKernelImageForDevice;
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map(&mq, a.q, D, a.S, a.H, a.B, a.qb, a.qh, a.qs, kTQ) ||
      !tensor_map(&mk, a.k, D, a.S, a.KV, a.B, a.kb, a.kh, a.ks, kTK) ||
      !tensor_map(&mv, a.v, D, a.S, a.KV, a.B, a.vb, a.vh, a.vs, kTK) ||
      !tensor_map(&mo, a.o, D, a.S, a.H, a.B, a.ob, a.oh, a.os, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_fwd_bf16<D><<<(unsigned)p.ctas, p.threads, p.smem, a.stream>>>(
      mq, mk, mv, mo, a.B, a.H, a.H / a.KV, a.S, a.causal, scale_log2);
  return cudaGetLastError();
}

cudaError_t by_dim(int dtype, int D, const Args& a) {
  Plan p;
  if (!plan_of(dtype, a.B, a.H, a.S, D, &p) || p.ctas > INT_MAX)
    return cudaErrorInvalidValue;
  switch (dtype * 1000 + D) {
    case 32: return launch_f32<32>(a, p);
    case 64: return launch_f32<64>(a, p);
    case 128: return launch_f32<128>(a, p);
    case 1032: return launch_bf16<32>(a, p);
    case 1064: return launch_bf16<64>(a, p);
    case 1128: return launch_bf16<128>(a, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, S, D) at strides (qb, qh, qs); k and v: (B, KV, S, D) at
// strides (kb, kh, ks) and (vb, vh, vs); o: like q at strides (ob, oh,
// os); the last dimension contiguous in all four. dtype 0: float32, 1:
// bfloat16 (both wgmma kernels: sm_90 only, 16-byte aligned pointers and
// strides). Launches on `stream` and returns
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

// The launch flash_attention_fwd makes for (dtype, B, H, S, D), as
// out[8] = {CTAs, threads per CTA, dynamic shared bytes, query rows per
// CTA, keys per K/V stage, stages, loading warpgroups, math warpgroups};
// returns 0, or cudaErrorInvalidValue for a dtype or D it has no kernel
// for, or a grid past INT_MAX CTAs.
extern "C" int flash_attention_plan(int dtype, int B, int H, int S, int D,
                                    int* out) {
  Plan p;
  if (!plan_of(dtype, B, H, S, D, &p) || p.ctas > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int plan[8] = {(int)p.ctas, p.threads, p.smem,  p.rows,
                       p.keys,      p.stages,  p.load, p.math};
  for (int i = 0; i < 8; ++i) out[i] = plan[i];
  return 0;
}

// The work of each CTA of that launch, as the kernel computes it:
// out[4 i .. 4 i + 3] = {batch, head, query block, K/V tiles read} of CTA
// i, for every CTA of the grid flash_attention_plan gives. Returns 0, or
// cudaErrorInvalidValue as flash_attention_plan does.
extern "C" int flash_attention_order(int dtype, int B, int H, int S, int D,
                                     int causal, int* out) {
  Plan p;
  if (!plan_of(dtype, B, H, S, D, &p) || p.ctas > INT_MAX)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < (int)p.ctas; ++i) {
    const CtaWork w = cta_work(i, B, H, S, causal, p.rows, p.keys);
    const int cta[4] = {w.b, w.h, w.qblock, w.kv_tiles};
    for (int j = 0; j < 4; ++j) out[4 * i + j] = cta[j];
  }
  return 0;
}
