// Karp-Rabin phrase-break mask for the prefix-free parse, for sm_90a.
//
// Replaces the Pallas TPU kernel mumemto_tpu/ops/pallas_kernels.py
// (_break_mask_kernel / break_mask_pallas) and its XLA twin
// mumemto_tpu/ops/pfp.py::_break_mask. Same values:
//
//   h[k]    = sum_{j<w} t[k-j] * 256^j  mod 1999999973
//             (t = ext with ext[0] forced to 0, t[<0] = 0)
//   mask[k] = h[k] % mod == 0  &&  k >= w  &&  k <= n_real
//   count   = number of set mask entries
//
// One thread per ext position. A block stages its tile plus the (w-1)
// chars before it in shared memory, so every char is read from device
// memory about once. The hash is w 64-bit Horner steps
// h = (h*256 + c) % p from the oldest char to the newest; h*256 + c stays
// below 2^40, so the value is exact and equals the TPU's two-limb uint32
// form. The break count is a warp ballot, a block sum in shared memory and
// one atomicAdd per block into an int32 the caller zeroed.
//
// What bounds it: the traffic is 2 bytes per position (read ext, write
// the mask), so its floor is memory bandwidth, and the tile makes each
// byte be read once with coalesced loads and stores. On top of that sit w
// 64-bit modulo steps per position, which the card emulates in several
// instructions each: on an H100 SXM (700 W) the kernel takes 0.23 ms at
// ne = 2^24, about 4% of the HBM peak, so at w = 10 the modulo arithmetic,
// not memory, sets its time. Fewer reductions (one per three Horner steps
// keeps h below 2^55) would be the first step to make it faster.
//
// C interface (bound with ctypes): kr_break_mask returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it cannot take.
// It launches on the given stream, allocates nothing and does not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kPrime = 1999999973ULL;

__global__ void kr_break_mask_kernel(const uint8_t* __restrict__ ext,
                                     uint8_t* __restrict__ mask,
                                     int32_t* __restrict__ count,
                                     int64_t ne, int64_t n_real, int w,
                                     int mod) {
  extern __shared__ uint8_t tile[];  // kThreads + w - 1 chars
  const int64_t block_start = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t base = block_start - (w - 1);  // ext position of tile[0]
  const int span = kThreads + w - 1;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int64_t pos = base + i;
    // ext[0] is the phrase-decoration Dollar, never hashed; positions
    // before the start hash as 0 (the reference's zeroed window)
    tile[i] = (pos >= 1 && pos < ne) ? ext[pos] : 0;
  }
  __syncthreads();

  const int64_t k = block_start + threadIdx.x;
  bool hit = false;
  if (k < ne) {
    uint64_t h = 0;
    const uint8_t* win = tile + threadIdx.x;  // win[w-1] is position k
    for (int j = 0; j < w; ++j) {
      h = (h * 256 + win[j]) % kPrime;
    }
    hit = (h % static_cast<uint64_t>(mod) == 0) && k >= w && k <= n_real;
    mask[k] = hit ? 1 : 0;
  }

  __shared__ int warp_sums[kThreads / 32];
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0 && v != 0) atomicAdd(count, v);
  }
}

}  // namespace

extern "C" int kr_break_mask_max_w() {
  // the tile lives in static-launch dynamic shared memory (<= 48 KiB
  // without an opt-in attribute)
  return 48 * 1024 - kThreads + 1;
}

extern "C" int kr_break_mask(const void* ext, void* mask, void* count,
                             int64_t ne, int64_t n_real, int w, int mod,
                             void* stream) {
  if (ne <= 0 || w < 1 || w > kr_break_mask_max_w() || mod < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (ne + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kThreads + w - 1);
  kr_break_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ext), static_cast<uint8_t*>(mask),
      static_cast<int32_t*>(count), ne, n_real, w, mod);
  return static_cast<int>(cudaGetLastError());
}
