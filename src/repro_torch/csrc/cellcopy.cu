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
// Design: one cell is split across the K CTAs of a thread-block cluster
// (K = ceil(cell / 4 KiB), at most 8: a 16 KiB cell takes 4 CTAs of 256
// threads, one 16 B vector a thread), so the grid follows the bytes and
// not the cells. A cell's bytes are a head up to the first 16 B-aligned
// destination address, whole 16 B vectors to aligned destinations, and a
// tail shorter than a vector. The vectors are cut into K slices on those
// aligned boundaries; the first CTA also copies the head, the last the
// tail. Each thread issues every 16 B load of its share (up to kUnroll
// vectors) before its first shift or store, so a read from the mapped
// pool costs one PCIe round trip per slice. A source that is not aligned
// like its destination is read as aligned 16 B vectors; each thread takes
// its neighbour's vector by warp shuffle (lane 31, and the last vector of
// a slice, load their own) and funnel-shifts the 16 bytes it needs out of
// the 32. The checksum is an integer sum: a word stored at message offset
// o contributes rotl(word, 8*(o%4)), since byte j of the message carries
// weight 2^(8*(j%4)). Each CTA reduces its slice with warp shuffles and
// one partial per warp, writes its partial into rank 0's shared memory
// (distributed shared memory), and after one cluster barrier rank 0 adds
// the K partials and writes the cell's sum: no atomics, no memset of the
// sums and no second launch. No TMA bulk copies yet.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                     // 16 B loads in flight a thread
constexpr long long kSliceBytes = 16LL * kThreads;   // one vector a thread
constexpr int kMaxCluster = 8;                 // the portable cluster size

// CTAs per cell: one per 4 KiB of the longest cell, 1 to 8
int cluster_size(long long nbytes, long long cell_bytes) {
  const long long len = cell_bytes < nbytes ? cell_bytes : nbytes;
  const long long k = (len + kSliceBytes - 1) / kSliceBytes;
  return (int)(k < 1 ? 1 : k > kMaxCluster ? kMaxCluster : k);
}

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

// The 16 bytes at byte offset m = 4q + r/8 of the 32 bytes a:b.
__device__ __forceinline__ uint4 funnel(uint4 a, uint4 b, uint32_t q,
                                        uint32_t r) {
  uint32_t x0, x1, x2, x3, x4;
  switch (q) {
    case 0: x0 = a.x; x1 = a.y; x2 = a.z; x3 = a.w; x4 = b.x; break;
    case 1: x0 = a.y; x1 = a.z; x2 = a.w; x3 = b.x; x4 = b.y; break;
    case 2: x0 = a.z; x1 = a.w; x2 = b.x; x3 = b.y; x4 = b.z; break;
    default: x0 = a.w; x1 = b.x; x2 = b.y; x3 = b.z; x4 = b.w; break;
  }
  return make_uint4(__funnelshift_r(x0, x1, r), __funnelshift_r(x1, x2, r),
                    __funnelshift_r(x2, x3, r), __funnelshift_r(x3, x4, r));
}

// Grid: n_cells * K CTAs in clusters of K; cluster c copies cell c.
__global__ void __launch_bounds__(kThreads)
cellcopy_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                long long nbytes, long long cell_bytes, int K,
                uint32_t* __restrict__ sums) {
  __shared__ uint32_t warp_part[kWarps];
  __shared__ uint32_t cta_part[kMaxCluster];   // rank 0's: one per CTA
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const unsigned int c = blockIdx.x / (unsigned int)K;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long s = (long long)c * cell_bytes;
  // cell_bytes < 2^31 (checked at launch): offsets in a cell fit an int
  const int len = (int)min(cell_bytes, nbytes - s);
  uint8_t* d = dst + s;
  const uint8_t* p = src + s;
  const int head = min((int)((16 - ((uintptr_t)d & 15)) & 15), len);
  const int nvec = (len - head) >> 4;
  const int tail0 = head + 16 * nvec;
  // this CTA's slice of the cell's vectors
  const int per = (nvec + K - 1) / K;
  const int v0 = min(rank * per, nvec);
  const int v1 = min(v0 + per, nvec);
  // the head and tail bytes are loaded before the vectors and stored
  // after them, so that all of a thread's loads are in flight together
  const bool in_head = rank == 0 && t < head;
  const bool in_tail = rank == K - 1 && t < len - tail0;
  const uint32_t head_byte = in_head ? p[t] : 0u;
  const uint32_t tail_byte = in_tail ? p[tail0 + t] : 0u;
  uint32_t acc = 0;
  uint8_t* da = d + head;                        // 16 B-aligned
  const uint8_t* pa = p + head;
  const uint32_t m = (uint32_t)((uintptr_t)pa & 15);
  const uint8_t* pb = pa - m;                    // 16 B-aligned
  const uint32_t q = m >> 2, r = 8u * (m & 3);
  const uint32_t phase = (uint32_t)((s + head) & 3);
  for (int base = v0; base < v1; base += kThreads * kUnroll) {
    uint4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + t;
      a[u] = i < v1 ? load16(pb + 16 * (long long)i)
                    : make_uint4(0, 0, 0, 0);
    }
    if (m) {                                     // uniform per cell
      uint4 b[kUnroll];
      bool own[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // the bytes this vector needs end inside aligned block i + 1,
        // so the load stays within a page that holds source bytes
        const int i = base + u * kThreads + t;
        own[u] = i < v1 && (lane == 31 || i + 1 >= v1);
        b[u] = own[u] ? load16(pb + 16 * (long long)(i + 1))
                      : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        uint4 n;
        n.x = __shfl_down_sync(0xffffffffu, a[u].x, 1);
        n.y = __shfl_down_sync(0xffffffffu, a[u].y, 1);
        n.z = __shfl_down_sync(0xffffffffu, a[u].z, 1);
        n.w = __shfl_down_sync(0xffffffffu, a[u].w, 1);
        a[u] = funnel(a[u], own[u] ? b[u] : n, q, r);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + t;
      if (i < v1) {
        *reinterpret_cast<uint4*>(da + 16 * (long long)i) = a[u];
        acc += weigh(a[u].x, phase) + weigh(a[u].y, phase) +
               weigh(a[u].z, phase) + weigh(a[u].w, phase);
      }
    }
  }
  if (in_head) {
    d[t] = (uint8_t)head_byte;
    acc += head_byte << (8 * ((s + t) & 3));
  }
  if (in_tail) {
    d[tail0 + t] = (uint8_t)tail_byte;
    acc += tail_byte << (8 * ((s + tail0 + t) & 3));
  }
  acc = warp_sum(acc);
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (t == 0) {
    uint32_t v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += warp_part[w];
    *cluster.map_shared_rank(&cta_part[rank], 0) = v;
  }
  cluster.sync();                  // every partial is in rank 0's memory
  if (rank == 0 && t == 0) {
    uint32_t v = 0;
    for (int i = 0; i < K; ++i) v += cta_part[i];
    sums[c] = v;
  }
}

}  // namespace

extern "C" {

// The launch the kernel gets for (nbytes, cell_bytes): out[0] the grid
// (CTAs), out[1] the cluster size K, out[2] threads per CTA, out[3] the
// CTA's static shared memory in bytes. Returns a CUDA error code.
int cellcopy_plan(long long nbytes, long long cell_bytes, long long* out) {
  if (nbytes <= 0 || cell_bytes <= 0 || cell_bytes >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long n_cells = (nbytes + cell_bytes - 1) / cell_bytes;
  const int K = cluster_size(nbytes, cell_bytes);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, cellcopy_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = n_cells * K;
  out[1] = K;
  out[2] = kThreads;
  out[3] = (long long)attr.sharedSizeBytes;
  return 0;
}

// Launch on `stream`; returns the launch's error code. `block_cells` is
// only checked: the CTA layout follows the bytes (cellcopy_plan).
int cellcopy_bytes(void* dst, const void* src, long long nbytes,
                   long long cell_bytes, long long block_cells, void* sums,
                   void* stream) {
  if (nbytes <= 0) return 0;
  if (cell_bytes <= 0 || cell_bytes >= (1LL << 31) || block_cells <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n_cells = (nbytes + cell_bytes - 1) / cell_bytes;
  const int K = cluster_size(nbytes, cell_bytes);
  const long long grid = n_cells * K;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, cellcopy_kernel, (uint8_t*)dst, (const uint8_t*)src, nbytes,
      cell_bytes, K, (uint32_t*)sums);
  if (e != cudaSuccess) return (int)e;
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
