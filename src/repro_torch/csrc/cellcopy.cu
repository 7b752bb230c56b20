// cellcopy for Hopper (sm_90a): cell-granular byte copy with a per-cell
// wrapping u32 checksum.
//
// Replaces the TPU kernel `cellcopy` / `_cellcopy_body` in
// src/repro/kernels/cellcopy/kernel.py:30-64. That kernel copies
// (n_cells, words) int32 cells one VMEM block per grid step and writes
// each cell's wrapping u32 sum of its words, the validity word a consumer
// checks. This file computes the same function on any byte range:
//
//   dst[0:n] = src[0:n]
//   sums[c]  = sum mod 2^32 of the little-endian u32 words of
//              src[c*cell_bytes : (c+1)*cell_bytes], counted from the
//              message start, with the ragged tail zero-padded
//
// which is exactly what ops.copy_message gives on a zero-padded message.
// dst and src may be device memory or host memory mapped into the GPU
// (the shared pool, cudaHostRegisterMapped), at any byte alignment.
//
// Bound: bytes. The kernel reads n bytes and writes n bytes and adds one
// integer per 4 bytes. Against the mapped pool the bound is the PCIe link
// (pool -> device or device -> pool); device to device it is HBM.
//
// Design: one CTA per block of `block_cells` cells, cells handled in
// turn. Per cell: byte copies up to the first 16 B-aligned destination
// address (head), then 16 B vector stores to aligned destinations. A
// source that is not aligned like the destination is read as aligned
// 16 B vectors; each thread takes its neighbour's vector by warp shuffle
// and funnel-shifts the 16 bytes it needs out of the 32. The last
// partial vector (tail) is copied byte by byte. The checksum is an
// integer sum: a word stored at message offset o contributes
// rotl(word, 8*(o%4)), since byte j of the message carries weight
// 2^(8*(j%4)). Each thread sums in a register, the CTA reduces with warp
// shuffles and one partial per warp in shared memory, and warp 0 writes
// the cell's sum. No TMA or bulk copies yet: simple and right first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t weigh(uint32_t word, uint32_t phase) {
  // rotate left by 8*phase bits: byte k moves to byte (k+phase)%4
  return __funnelshift_l(word, word, 8u * phase);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__global__ void __launch_bounds__(kThreads)
cellcopy_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                long long nbytes, long long cell_bytes, long long n_cells,
                long long block_cells, uint32_t* __restrict__ sums) {
  __shared__ uint32_t partial[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long c0 = (long long)blockIdx.x * block_cells;
  const long long c1 = min(c0 + block_cells, n_cells);
  for (long long c = c0; c < c1; ++c) {
    const long long s = c * cell_bytes;
    const long long len = min(cell_bytes, nbytes - s);
    uint8_t* d = dst + s;
    const uint8_t* p = src + s;
    uint32_t acc = 0;
    long long head = (16 - ((uintptr_t)d & 15)) & 15;
    if (head > len) head = len;
    if (t < head) {
      const uint32_t b = p[t];
      d[t] = (uint8_t)b;
      acc += b << (8 * ((s + t) & 3));
    }
    const long long nvec = (len - head) >> 4;
    uint8_t* da = d + head;                      // 16 B-aligned
    const uint8_t* pa = p + head;
    const uint32_t m = (uint32_t)((uintptr_t)pa & 15);
    const uint8_t* pb = pa - m;                  // 16 B-aligned
    const uint32_t q = m >> 2, r = 8u * (m & 3);
    const uint32_t phase = (uint32_t)((s + head) & 3);
    for (long long base = 0; base < nvec; base += kThreads) {
      const long long i = base + t;
      const bool valid = i < nvec;
      uint4 a = valid ? load16(pb + 16 * i) : make_uint4(0, 0, 0, 0);
      uint4 out = a;
      if (m) {                                   // uniform per cell
        uint4 b;
        b.x = __shfl_down_sync(0xffffffffu, a.x, 1);
        b.y = __shfl_down_sync(0xffffffffu, a.y, 1);
        b.z = __shfl_down_sync(0xffffffffu, a.z, 1);
        b.w = __shfl_down_sync(0xffffffffu, a.w, 1);
        if (valid && (lane == 31 || i + 1 >= nvec)) {
          // the bytes we need end inside this aligned block, so the
          // load stays within a page that holds source bytes
          b = load16(pb + 16 * (i + 1));
        }
        uint32_t x0, x1, x2, x3, x4;
        switch (q) {
          case 0: x0 = a.x; x1 = a.y; x2 = a.z; x3 = a.w; x4 = b.x; break;
          case 1: x0 = a.y; x1 = a.z; x2 = a.w; x3 = b.x; x4 = b.y; break;
          case 2: x0 = a.z; x1 = a.w; x2 = b.x; x3 = b.y; x4 = b.z; break;
          default: x0 = a.w; x1 = b.x; x2 = b.y; x3 = b.z; x4 = b.w; break;
        }
        out.x = __funnelshift_r(x0, x1, r);
        out.y = __funnelshift_r(x1, x2, r);
        out.z = __funnelshift_r(x2, x3, r);
        out.w = __funnelshift_r(x3, x4, r);
      }
      if (valid) {
        *reinterpret_cast<uint4*>(da + 16 * i) = out;
        acc += weigh(out.x, phase) + weigh(out.y, phase) +
               weigh(out.z, phase) + weigh(out.w, phase);
      }
    }
    const long long tail0 = head + 16 * nvec;
    if (t < len - tail0) {
      const long long j = tail0 + t;
      const uint32_t b = p[j];
      d[j] = (uint8_t)b;
      acc += b << (8 * ((s + j) & 3));
    }
    acc = warp_sum(acc);
    if (lane == 0) partial[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      uint32_t v = lane < kWarps ? partial[lane] : 0u;
      v = warp_sum(v);
      if (lane == 0) sums[c] = v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch.
int cellcopy_bytes(void* dst, const void* src, long long nbytes,
                   long long cell_bytes, long long block_cells, void* sums,
                   void* stream) {
  if (nbytes <= 0) return 0;
  if (cell_bytes <= 0 || block_cells <= 0) return (int)cudaErrorInvalidValue;
  const long long n_cells = (nbytes + cell_bytes - 1) / cell_bytes;
  const long long grid = (n_cells + block_cells - 1) / block_cells;
  cellcopy_kernel<<<(unsigned int)grid, kThreads, 0,
                    (cudaStream_t)stream>>>(
      (uint8_t*)dst, (const uint8_t*)src, nbytes, cell_bytes, n_cells,
      block_cells, (uint32_t*)sums);
  return (int)cudaGetLastError();
}

// Pin a host range (the shared pool) and map it into the GPU's address
// space for every context.
int pool_host_register(void* ptr, long long nbytes) {
  return (int)cudaHostRegister(
      ptr, (size_t)nbytes, cudaHostRegisterMapped | cudaHostRegisterPortable);
}

int pool_host_unregister(void* ptr) {
  return (int)cudaHostUnregister(ptr);
}

// Device address of pinned, mapped host memory.
int pool_device_pointer(void** out, void* host) {
  return (int)cudaHostGetDevicePointer(out, host, 0);
}

}  // extern "C"
