// Other forms of the Karp-Rabin break-mask kernel, for timing beside the
// port's kernel (mumemto_tpu_torch/kernels/csrc/kr_mask.cu, which
// tools/kr_mask_ab_cuda.py launches from the port's own library). This file
// stands alone. Same C interface as kr_break_mask, plus the variant number:
//
//   0  the first version of the port's kernel: one position per thread, w
//      64-bit `% p` Horner steps, a 64-bit `% mod`, byte loads and stores;
//   1  the linear form h = (sum_j t[k-j] * c_j) mod p with c_j = 256^j mod p
//      in constant memory, 16 positions per thread, one `% p` per position;
//      w <= kLinearMaxW here (each term is below 2^39, so a sum of up to
//      2^24 terms fits a uint64; a larger w would reduce every 2^24 terms);
//   2  a probe that writes a wrong mask and is only timed: the port's loads
//      (a thread's own two 16-byte chunks and the one before them), its
//      16-byte stores and its count, with no hashing in between.

#include <cstdint>
#include <cuda_runtime.h>

namespace ab {

constexpr int kThreads = 256;
constexpr uint64_t kPrime = 1999999973u;

template <int kBlock>
__device__ __forceinline__ int block_sum(int hits) {
  __shared__ int warp_sums[kBlock / 32];
  hits = __reduce_add_sync(0xffffffffu, hits);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = hits;
  __syncthreads();
  int v = 0;
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sums[lane] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
  }
  return v;  // the block's sum in thread 0
}

// ---- 0: the first version ------------------------------------------------

__global__ void first_kernel(const uint8_t* __restrict__ ext,
                             uint8_t* __restrict__ mask,
                             int32_t* __restrict__ count, int64_t ne,
                             int64_t n_real, int w, int mod) {
  extern __shared__ uint8_t tile1[];  // kThreads + w - 1 chars
  const int64_t block_start = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t base = block_start - (w - 1);
  const int span = kThreads + w - 1;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int64_t pos = base + i;
    tile1[i] = (pos >= 1 && pos < ne) ? ext[pos] : 0;
  }
  __syncthreads();
  const int64_t k = block_start + threadIdx.x;
  bool hit = false;
  if (k < ne) {
    uint64_t h = 0;
    const uint8_t* win = tile1 + threadIdx.x;
    for (int j = 0; j < w; ++j) h = (h * 256 + win[j]) % kPrime;
    hit = (h % static_cast<uint64_t>(mod) == 0) && k >= w && k <= n_real;
    mask[k] = hit ? 1 : 0;
  }
  const int v = block_sum<kThreads>(hit ? 1 : 0);
  if (threadIdx.x == 0 && v != 0) atomicAdd(count, v);
}

int launch_first(const uint8_t* ext, uint8_t* mask, int32_t* count, int64_t ne,
                 int64_t n_real, int w, int mod, cudaStream_t stream) {
  if (w > 48 * 1024 - kThreads + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (ne + kThreads - 1) / kThreads;
  first_kernel<<<static_cast<unsigned>(blocks), kThreads,
                 static_cast<size_t>(kThreads + w - 1), stream>>>(
      ext, mask, count, ne, n_real, w, mod);
  return static_cast<int>(cudaGetLastError());
}

// ---- 1: the linear form --------------------------------------------------

constexpr int kRun = 16;
constexpr int kTile = kThreads * kRun;
constexpr int kLinearMaxW = 1024;
__constant__ uint32_t linear_coef[kLinearMaxW];  // 256^j mod p

// 16 ext chars at pos (a multiple of 16, maybe negative): zeros outside
// [0, ne), and ext[0] as 0; ext is 16-byte aligned
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ ext,
                                        int64_t pos, int64_t ne) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (pos < 0 || pos >= ne) return v;
  if (pos + 16 <= ne) {
    v = __ldg(reinterpret_cast<const uint4*>(ext + pos));
  } else {
    uint32_t words[4] = {0u, 0u, 0u, 0u};
    for (int b = 0; pos + b < ne; ++b) {
      words[b >> 2] |= static_cast<uint32_t>(ext[pos + b]) << (8 * (b & 3));
    }
    v = make_uint4(words[0], words[1], words[2], words[3]);
  }
  if (pos == 0) v.x &= 0xffffff00u;
  return v;
}

// h % mod == 0 as multiply, rotate, compare, as in the port's kernel: with
// mod = 2^shift * odd, inv = odd^-1 mod 2^32 and limit = (2^32 - 1) / mod
struct Divisor {
  uint32_t inv;
  uint32_t limit;
  int shift;
};

inline Divisor make_divisor(uint32_t mod) {
  Divisor d;
  d.shift = 0;
  uint32_t odd = mod;
  while ((odd & 1u) == 0) {
    odd >>= 1;
    ++d.shift;
  }
  d.inv = odd;
  for (int i = 0; i < 5; ++i) d.inv *= 2u - odd * d.inv;
  d.limit = 0xffffffffu / mod;
  return d;
}

__device__ __forceinline__ bool divides(const Divisor& d, uint32_t h) {
  const uint32_t x = h * d.inv;
  return __funnelshift_r(x, x, d.shift) <= d.limit;
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&words)[4], int i) {
  return __byte_perm(words[i >> 2], 0u, 0x4440u | (i & 3));
}

// kRun mask bytes at k0: one 16-byte store, or bytes at the end of the array
__device__ __forceinline__ void store16(uint8_t* __restrict__ mask, int64_t k0,
                                        int64_t ne, const uint32_t (&m)[4]) {
  if (k0 + kRun <= ne) {
    *reinterpret_cast<uint4*>(mask + k0) = make_uint4(m[0], m[1], m[2], m[3]);
  } else {
    for (int i = 0; k0 + i < ne; ++i) {
      mask[k0 + i] = static_cast<uint8_t>(byte_of(m, i));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
linear_kernel(const uint8_t* __restrict__ ext, uint8_t* __restrict__ mask,
              int32_t* __restrict__ count, int64_t ne, int64_t n_real, int w,
              int halo, Divisor div) {
  extern __shared__ uint4 tile[];
  const int tid = threadIdx.x;
  const int64_t block_start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t k0 = block_start + static_cast<int64_t>(tid) * kRun;
  const int halo_chunks = halo >> 4;
  for (int c = tid; c < halo_chunks; c += kThreads) {
    tile[c] = load16(ext, block_start - halo + 16 * static_cast<int64_t>(c), ne);
  }
  const uint4 own = load16(ext, k0, ne);
  tile[halo_chunks + tid] = own;
  __syncthreads();

  const int64_t lo = w;
  const int64_t hi = n_real < ne - 1 ? n_real : ne - 1;
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  if (k0 <= hi && k0 + kRun > lo) {
    const uint8_t* tile8 = reinterpret_cast<const uint8_t*>(tile);
    const int at = halo + tid * kRun;  // tile offset of position k0
    uint32_t win[4] = {own.x, own.y, own.z, own.w};  // chars k0-j .. k0-j+15
    uint64_t acc[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = 0;
    for (int j = 0; j < w; ++j) {
      const uint32_t c = linear_coef[j];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        acc[i] += static_cast<uint64_t>(byte_of(win, i)) * c;
      }
      // slide the window one char back
      win[3] = __funnelshift_l(win[2], win[3], 8);
      win[2] = __funnelshift_l(win[1], win[2], 8);
      win[1] = __funnelshift_l(win[0], win[1], 8);
      win[0] = (win[0] << 8) | tile8[at - j - 1];
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const uint32_t h = static_cast<uint32_t>(acc[i] % kPrime);
      const bool ok = k0 + i >= lo && k0 + i <= hi;
      if (ok && divides(div, h)) m[i >> 2] |= 1u << (8 * (i & 3));
    }
  }
  if (k0 < ne) store16(mask, k0, ne, m);
  const int v = block_sum<kThreads>(__popc(m[0]) + __popc(m[1]) +
                                    __popc(m[2]) + __popc(m[3]));
  if (tid == 0 && v != 0) atomicAdd(count, v);
}

int launch_linear(const uint8_t* ext, uint8_t* mask, int32_t* count, int64_t ne,
                  int64_t n_real, int w, int mod, cudaStream_t stream) {
  if (w > kLinearMaxW) return static_cast<int>(cudaErrorInvalidValue);
  static int coef_w = 0;  // the table is uploaded when w changes
  if (w != coef_w) {
    uint32_t coef[kLinearMaxW];
    uint64_t pw = 1;
    for (int j = 0; j < w; ++j) {
      coef[j] = static_cast<uint32_t>(pw);
      pw = pw * 256 % kPrime;
    }
    // pageable source: the copy has been staged when the call returns
    const cudaError_t rc = cudaMemcpyToSymbolAsync(
        linear_coef, coef, sizeof(uint32_t) * w, 0, cudaMemcpyHostToDevice,
        stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    coef_w = w;
  }
  const int64_t blocks = (ne + kTile - 1) / kTile;
  const int halo = (w + 15) / 16 * 16;
  linear_kernel<<<static_cast<unsigned>(blocks), kThreads,
                  static_cast<size_t>(halo + kTile), stream>>>(
      ext, mask, count, ne, n_real, w, halo,
      make_divisor(static_cast<uint32_t>(mod)));
  return static_cast<int>(cudaGetLastError());
}

// ---- 2: the probe: loads, stores and count, no hashing ---------------------

constexpr int kProbeThreads = 128;  // the port's block
constexpr int kProbeRun = 32;       // and its positions per thread

__global__ void __launch_bounds__(kProbeThreads)
probe_kernel(const uint8_t* __restrict__ ext, uint8_t* __restrict__ mask,
             int32_t* __restrict__ count, int64_t ne) {
  const int64_t k0 = (static_cast<int64_t>(blockIdx.x) * kProbeThreads +
                      threadIdx.x) * kProbeRun;
  const uint4 before = load16(ext, k0 - 16, ne);
  const uint4 a = load16(ext, k0, ne);
  const uint4 b = load16(ext, k0 + 16, ne);
  const uint32_t ma[4] = {(a.x ^ before.x) & 0x01010101u,
                          (a.y ^ before.y) & 0x01010101u,
                          (a.z ^ before.z) & 0x01010101u,
                          (a.w ^ before.w) & 0x01010101u};
  const uint32_t mb[4] = {(b.x ^ a.x) & 0x01010101u, (b.y ^ a.y) & 0x01010101u,
                          (b.z ^ a.z) & 0x01010101u, (b.w ^ a.w) & 0x01010101u};
  if (k0 < ne) store16(mask, k0, ne, ma);
  if (k0 + 16 < ne) store16(mask, k0 + 16, ne, mb);
  int hits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) hits += __popc(ma[i]) + __popc(mb[i]);
  const int v = block_sum<kProbeThreads>(hits);
  if (threadIdx.x == 0 && v != 0) atomicAdd(count, v);
}

int launch_probe(const uint8_t* ext, uint8_t* mask, int32_t* count, int64_t ne,
                 cudaStream_t stream) {
  constexpr int kProbeTile = kProbeThreads * kProbeRun;
  const int64_t blocks = (ne + kProbeTile - 1) / kProbeTile;
  probe_kernel<<<static_cast<unsigned>(blocks), kProbeThreads, 0, stream>>>(
      ext, mask, count, ne);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ab

// Zeroes the count on the stream, then launches the variant. ext and mask
// must be 16-byte aligned.
extern "C" int kr_break_mask_variant(int variant, const void* ext, void* mask,
                                     void* count, int64_t ne, int64_t n_real,
                                     int w, int mod, void* stream) {
  if (ne <= 0 || ne > (int64_t{1} << 36) || w < 1 || mod < 1 ||
      reinterpret_cast<uintptr_t>(ext) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mask) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  const uint8_t* ext8 = static_cast<const uint8_t*>(ext);
  uint8_t* mask8 = static_cast<uint8_t*>(mask);
  int32_t* count32 = static_cast<int32_t*>(count);
  const cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int32_t), on);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  switch (variant) {
    case 0:
      return ab::launch_first(ext8, mask8, count32, ne, n_real, w, mod, on);
    case 1:
      return ab::launch_linear(ext8, mask8, count32, ne, n_real, w, mod, on);
    case 2:
      return ab::launch_probe(ext8, mask8, count32, ne, on);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
