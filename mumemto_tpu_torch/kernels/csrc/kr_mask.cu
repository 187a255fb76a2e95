// Karp-Rabin phrase-break mask for the prefix-free parse, for sm_90a.
//
// Replaces the Pallas TPU kernel mumemto_tpu/ops/pallas_kernels.py
// (_break_mask_kernel / break_mask_pallas) and its XLA twin
// mumemto_tpu/ops/pfp.py::_break_mask. Same values, for every w >= 1 and
// mod >= 1:
//
//   h[k]    = sum_{j<w} t[k-j] * 256^j  mod p,  p = 1999999973
//             (t = ext with ext[0] forced to 0, t[<0] = 0)
//   mask[k] = h[k] % mod == 0  &&  k >= w  &&  k <= n_real
//   count   = number of set mask entries
//
// What bounds it. The function moves 2 bytes per position (ext read once,
// mask written once): 0.0100 ms at ne = 2^24 and 0.0401 ms at 2^26 on an
// H100's 3.35 TB/s. The first version of this kernel (one position per
// thread, w dependent 64-bit `% p` steps, a 64-bit `% mod` by a runtime
// divisor, byte-wide loads and stores) took 0.2311 ms and 0.9080 ms
// (NVIDIA H100 80GB HBM3, 700.00 W): 4% of that bound, set by about a
// hundred dependent integer instructions per byte and not by memory. This
// version takes 0.0211 ms and 0.0654 ms on the same card through its C
// launcher on preallocated outputs (47% and 61% of the bound;
// tools/kr_mask_ab_cuda.py, cold L2, w = 10, mod = 100). Through the
// wrapper kr_mask.break_mask, which the parse calls and which also
// allocates the mask and the count, back-to-back calls take 0.0201-0.0312
// ms at ne = 2^24 (32-50% of the bound: the wrapper's 18-31 us of host
// time a call shows there) and 0.0640-0.0659 ms at 2^26 (61-63%;
// chip_smoke.py phase 4). What is left above the bound at 2^26 is the
// issue rate of the ~18 instructions per position (8 FP64, ~10 integer:
// 2^26 positions fill about 71 thousand clocks of the issue slots of 132
// SMs, 0.036 ms at the 1.98 GHz boost clock), at 2^24 also the launch and
// the memset of the count; not device memory.
//
// What the design does about it.
//  * One reduction per position, whatever w is. A thread owns kRun
//    consecutive positions (32 as built). It hashes the window that ends
//    just before its run once (w Horner steps) and then rolls:
//        h' = (256*h + t_in + t_out * (p - 256^w mod p)) mod p
//    which is two multiply-adds and one reduction, all below 2^40.
//  * The arithmetic runs on the FP64 pipe, which on this card is as wide as
//    the INT32 pipe (64 lanes per SM) and otherwise idle, so hashing and
//    the integer work around it (byte extraction, the `% mod` test, mask
//    packing) issue side by side; the same kernel in 64-bit integers with
//    a multiply-high reduction was slower when tried. Integers below 2^53
//    are exact in a double: the reduction is q = floor(x * (1/p rounded
//    up)) by one fma rounded down onto 2^52, then r = fma(-q, p, x), exact
//    for x < 2^51.
//  * `h % mod == 0` is a 32-bit multiply, a rotate and a compare: with
//    mod = 2^e * d (d odd), h is a multiple of mod iff
//    rotr(h * d^-1 mod 2^32, e) <= floor((2^32 - 1) / mod). The launcher
//    computes d^-1, e and the limit once per launch; exact for every
//    mod in [1, 2^31 - 1] and h < 2^32.
//  * 16-byte traffic over a grid as wide as the data. For w <= 16 (the
//    parse's w is 10) a thread loads its own 16-byte chunks and the one
//    before them straight from device memory, so no thread waits for
//    another; the chars that leave its windows are those chunks shifted by
//    16 - w bytes, one funnel shift a word (the shift is the same for the
//    whole launch). For a larger w the block first stages its chars and
//    the w before them in shared memory, 16 bytes a thread, and reads the
//    same chunks from there (0.0245 ms and 0.0757 ms at w = 17). The
//    mask leaves as one 16-byte store per chunk. A pointer that is not
//    16-byte aligned and the last partial chunk of an ne that is no
//    multiple of 16 take byte loads and stores instead.
//  * The count is a popcount per thread, a warp reduction, a block sum in
//    shared memory and one atomicAdd per block into an int32 that the
//    launcher zeroes on the stream first (cudaMemsetAsync, ~0.0011 ms).
// The linear form h = (sum_j t[k-j] * (256^j mod p)) mod p, w multiply-adds
// and one reduction per position, was built too and takes 0.0568 ms and
// 0.2059 ms (tools/kr_mask_ab.cu): the rolling form won. TMA, wgmma and clusters have nothing to
// offer a 1-D byte stream with a (w-1)-char halo: plain 16-byte loads over
// a grid as wide as the data reach 89% of the HBM peak on this card
// (add_one.cu).
//
// C interface (bound with ctypes): kr_break_mask returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it cannot take.
// It launches on the given stream, allocates nothing and does not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace kr {

constexpr uint32_t kPrime = 1999999973u;
// a block's dynamic shared memory on sm_90: 227 KiB less 1 KiB left for the
// kernel's static shared memory and the system's
constexpr int kMaxSmem = 226 * 1024;
// A thread owns kRun consecutive positions, a block kThreads * kRun.
constexpr int kChunks = 2;  // 16-byte chunks per thread
constexpr int kRun = 16 * kChunks;
constexpr int kWords = 4 * kChunks;
constexpr int kThreads = 128;
constexpr int kTile = kThreads * kRun;
// the largest w whose halo fits in shared memory beside the block's chars
constexpr int kMaxW = ((kMaxSmem - kTile) / 16) * 16;

// h % mod == 0 as multiply, rotate, compare (see the note above)
struct Divisor {
  uint32_t inv;    // inverse of mod's odd part modulo 2^32
  uint32_t limit;  // floor((2^32 - 1) / mod)
  int shift;       // trailing zero bits of mod
};

inline Divisor make_divisor(uint32_t mod) {
  Divisor d;
  d.shift = 0;
  uint32_t odd = mod;
  while ((odd & 1u) == 0) {
    odd >>= 1;
    ++d.shift;
  }
  uint32_t inv = odd;  // Newton: 3 correct bits double five times
  for (int i = 0; i < 5; ++i) inv *= 2u - odd * inv;
  d.inv = inv;
  d.limit = 0xffffffffu / mod;
  return d;
}

__device__ __forceinline__ bool divides(const Divisor& d, uint32_t h) {
  const uint32_t x = h * d.inv;
  return __funnelshift_r(x, x, d.shift) <= d.limit;
}

// 256^w mod p on the host
inline uint32_t pow256_mod(int w) {
  uint64_t r = 1, b = 256;
  for (uint32_t e = static_cast<uint32_t>(w); e != 0; e >>= 1) {
    if (e & 1u) r = r * b % kPrime;
    b = b * b % kPrime;
  }
  return static_cast<uint32_t>(r);
}

__device__ __forceinline__ uint32_t byte_at(uint32_t word, int b) {
  return __byte_perm(word, 0u, 0x4440u | b);
}

// The hash arithmetic on the FP64 pipe. A state is an integer in [0, p)
// held in a double.
struct Roll {
  static constexpr double kTwo52 = 4503599627370496.0;
  static constexpr double kInvPUp = 0x1.12e0bec0af660p-31;  // least double >= 1/p

  static __device__ __forceinline__ double from_byte(uint32_t b) {
    return __hiloint2double(0x43300000, static_cast<int>(b)) - kTwo52;
  }
  // x mod p for an integer 0 <= x < 2^51
  static __device__ __forceinline__ double reduce(double x) {
    const double q = __fma_rd(x, kInvPUp, kTwo52) - kTwo52;
    return fma(-q, static_cast<double>(kPrime), x);
  }
  // Horner step j of the opening window: two steps stay below 2^47
  static __device__ __forceinline__ double open(double h, uint32_t byte, int j) {
    h = fma(h, 256.0, from_byte(byte));
    return (j & 1) ? reduce(h) : h;
  }
  // byte b of in_word enters the window, byte b of out_word leaves it
  static __device__ __forceinline__ double roll(double h, uint32_t in_word,
                                                uint32_t out_word, int b,
                                                double neg_pow) {
    const double y = fma(from_byte(byte_at(out_word, b)), neg_pow,
                         from_byte(byte_at(in_word, b)));
    return reduce(fma(h, 256.0, y));
  }
  static __device__ __forceinline__ uint32_t value(double h) {
    return static_cast<uint32_t>(__double2loint(h + kTwo52));
  }
};

// 16 ext chars at pos (a multiple of 16, maybe negative): zeros outside
// [0, ne), and ext[0] (the phrase-decoration Dollar, never hashed) as 0
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ ext,
                                        int64_t pos, int64_t ne, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (pos < 0 || pos >= ne) return v;
  if (vec && pos + 16 <= ne) {
    v = __ldg(reinterpret_cast<const uint4*>(ext + pos));
  } else {
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (pos + b < ne) {
        words[b >> 2] |= static_cast<uint32_t>(ext[pos + b]) << (8 * (b & 3));
      }
    }
    v = make_uint4(words[0], words[1], words[2], words[3]);
  }
  if (pos == 0) v.x &= 0xffffff00u;
  return v;
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&words)[kWords],
                                            int i) {
  return byte_at(words[i >> 2], i & 3);
}

// The kRun chars that start `shift` bytes into raw (shift < 16).
// shift is the same for every thread of a launch, so the switch does not
// diverge, and every case indexes raw with constants.
__device__ __forceinline__ void shifted(const uint32_t (&raw)[kWords + 4],
                                        int shift, uint32_t (&out)[kWords]) {
  const int sh = (shift & 3) * 8;
  switch (shift >> 2) {
#define KR_SHIFTED_CASE(k)                                            \
  case k:                                                             \
    _Pragma("unroll") for (int i = 0; i < kWords; ++i) {              \
      out[i] = __funnelshift_r(raw[i + k], raw[i + k + 1], sh);       \
    }                                                                 \
    break;
    KR_SHIFTED_CASE(0)
    KR_SHIFTED_CASE(1)
    KR_SHIFTED_CASE(2)
    KR_SHIFTED_CASE(3)
#undef KR_SHIFTED_CASE
  }
}

// With kStaged the block first copies its chars and the halo before them
// (w rounded up to a multiple of 16) into shared memory, neighbouring
// threads neighbouring chunks; without it (w <= 16 only) a thread loads
// its own chunks and the one before them straight from device memory, and
// no thread waits for another.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
break_mask_kernel(const uint8_t* __restrict__ ext, uint8_t* __restrict__ mask,
                  int32_t* __restrict__ count, int64_t ne, int64_t n_real,
                  int w, int halo, double neg_pow, Divisor div, bool vec_load,
                  bool vec_store) {
  extern __shared__ uint4 tile[];  // kStaged: halo / 16 + kThreads * kChunks
  const int tid = threadIdx.x;
  const int64_t block_start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t k0 = block_start + static_cast<int64_t>(tid) * kRun;
  const int halo_chunks = halo >> 4;
  if (kStaged) {
    for (int c = tid; c < halo_chunks + kThreads * kChunks; c += kThreads) {
      tile[c] = load16(ext, block_start - halo + 16 * static_cast<int64_t>(c),
                       ne, vec_load);
    }
    __syncthreads();
  }

  // positions that can break: w <= k <= n_real (and k < ne)
  const int64_t lo = w;
  const int64_t hi = n_real < ne - 1 ? n_real : ne - 1;
  uint32_t m[kWords];  // one mask byte per position
#pragma unroll
  for (int i = 0; i < kWords; ++i) m[i] = 0u;
  if (k0 <= hi && k0 + kRun > lo) {
    // in: the run's own chars. out: the chars at k0 - w .. k0 - w + kRun -
    // 1, which leave the windows as the run advances; its first w open the
    // run. raw: the kChunks + 1 aligned chunks that hold out.
    uint32_t in_w[kWords];
    uint32_t raw[kWords + 4];
    uint32_t out_w[kWords];
    const int a = halo - w + tid * kRun;  // tile offset of position k0 - w
#pragma unroll
    for (int c = 0; c <= kChunks; ++c) {
      const uint4 r = kStaged ? tile[(a >> 4) + c]
                              : load16(ext, k0 + 16 * (c - 1), ne, vec_load);
      raw[4 * c] = r.x;
      raw[4 * c + 1] = r.y;
      raw[4 * c + 2] = r.z;
      raw[4 * c + 3] = r.w;
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (kStaged) {
        const uint4 v = tile[halo_chunks + tid * kChunks + c];
        in_w[4 * c] = v.x;
        in_w[4 * c + 1] = v.y;
        in_w[4 * c + 2] = v.z;
        in_w[4 * c + 3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) in_w[4 * c + i] = raw[4 * c + 4 + i];
      }
    }
    shifted(raw, a & 15, out_w);
    double h = 0.0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j >= w) break;
      h = Roll::open(h, byte_of(out_w, j), j);
    }
    if (kStaged) {
      const uint8_t* tile8 = reinterpret_cast<const uint8_t*>(tile);
      for (int j = kRun; j < w; ++j) h = Roll::open(h, tile8[a + j], j);
    }
    h = Roll::reduce(h);
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      h = Roll::roll(h, in_w[i >> 2], out_w[i >> 2], i & 3, neg_pow);
      if (divides(div, Roll::value(h))) m[i >> 2] |= 1u << (8 * (i & 3));
    }
    if (k0 < lo || k0 + kRun - 1 > hi) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (k0 + i < lo || k0 + i > hi) m[i >> 2] &= ~(0xffu << (8 * (i & 3)));
      }
    }
  }
  if (k0 < ne) {
    if (vec_store && k0 + kRun <= ne) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        *reinterpret_cast<uint4*>(mask + k0 + 16 * c) =
            make_uint4(m[4 * c], m[4 * c + 1], m[4 * c + 2], m[4 * c + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (k0 + i < ne) mask[k0 + i] = static_cast<uint8_t>(byte_of(m, i));
      }
    }
  }

  __shared__ int warp_sums[kThreads / 32];
  int hits = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) hits += __popc(m[i]);
  hits = __reduce_add_sync(0xffffffffu, hits);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) warp_sums[warp] = hits;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kThreads / 32 ? warp_sums[lane] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0 && v != 0) atomicAdd(count, v);
  }
}

}  // namespace kr

extern "C" int kr_break_mask_max_w() { return kr::kMaxW; }

// Zeroes the count on the stream, then launches the kernel: without shared
// memory where w allows it (w <= 16), staged otherwise.
extern "C" int kr_break_mask(const void* ext, void* mask, void* count,
                             int64_t ne, int64_t n_real, int w, int mod,
                             void* stream) {
  using namespace kr;
  if (ne <= 0 || w < 1 || w > kMaxW || mod < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (ne + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int32_t), on);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const uint8_t* ext8 = static_cast<const uint8_t*>(ext);
  uint8_t* mask8 = static_cast<uint8_t*>(mask);
  int32_t* count32 = static_cast<int32_t*>(count);
  const double neg_pow =
      static_cast<double>((kPrime - pow256_mod(w)) % kPrime);
  const Divisor div = make_divisor(static_cast<uint32_t>(mod));
  const bool vec_load = reinterpret_cast<uintptr_t>(ext) % 16 == 0;
  const bool vec_store = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const int halo = (w + 15) / 16 * 16;
  if (w <= 16) {
    break_mask_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, on>>>(
        ext8, mask8, count32, ne, n_real, w, halo, neg_pow, div, vec_load,
        vec_store);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(halo + kTile);
  if (smem > 48 * 1024) {  // above 48 KiB only by opting in
    rc = cudaFuncSetAttribute(break_mask_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  break_mask_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem, on>>>(
      ext8, mask8, count32, ne, n_real, w, halo, neg_pow, div, vec_load,
      vec_store);
  return static_cast<int>(cudaGetLastError());
}
