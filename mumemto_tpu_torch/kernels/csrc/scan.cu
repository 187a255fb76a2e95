// Running maximum or minimum of a 1-D int32 or int64 array, forward or
// reverse, values only, for sm_90a.
//
//   forward:  out[i] = op(x[0], ..., x[i])
//   reverse:  out[i] = op(x[i], ..., x[n-1])      op = max or min
//
// Replaces no Pallas kernel: the JAX package computes these scans with
// jax.lax.cummax / cummin. It was added because the port's first form,
// torch.cummax / cummin(x, 0).values, runs on one block for a 1-D input:
// PyTorch's launcher gives an input of one row a grid of ceil(rows / 32)
// blocks of 16 x 32 threads, which then walks up to 2^28 elements 32 at a
// time, and it writes an int64 index array that every caller throws away.
//
// What bounds it. The scan reads each element once and writes it once:
// 8 bytes an int32 element, 2 GiB at 2^28, 0.64 ms at the H100's 3.35 TB/s.
// This kernel takes 1.07 ms there (60% of the bound), torch.cummax 737 ms
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 4b). Nothing but the
// bytes is needed, so the design is one pass over memory:
//  * A block scans one tile of 32 KiB (8192 int32 or 4096 int64), 128
//    bytes a thread as 8 loads of 16 bytes; lane l of a warp takes the
//    l-th 16 bytes of each 512-byte run, so every load instruction of a
//    warp reads 512 contiguous bytes. The tile is scanned in registers:
//    within a thread's 16 bytes, then across the warp's lanes by shuffles
//    (a run at a time, carrying each run's total into the next), then
//    across the block's 8 warps through shared memory.
//  * Tiles are chained by Merrill & Garland's decoupled look-back
//    (single-pass parallel prefix scan, NVIDIA NVR-2016-002): each tile
//    publishes its aggregate as soon as it has it, and its inclusive
//    prefix once it knows it, in a status word per tile. A warp looks
//    back over 32 predecessors at a time, waits until each has published
//    something, combines them, and stops at the first window that holds
//    an inclusive prefix. Max and min are idempotent, so the window may
//    combine tiles that the prefix it found already covers: no lane has
//    to be cut off at the nearest prefix. A tile takes its place in the
//    scan order from an atomic ticket, so a block only ever waits on
//    blocks that started before it, which are resident.
//  * The status words are published with st.release and read with
//    ld.acquire at gpu scope, each value before its flag.
//  * The reverse scan walks the same 16-byte-aligned tiles from the last
//    one (which holds the ragged end) and scans each backwards, so no
//    flipped copy is made.
// The identity, the dtype's least (max) or greatest (min) value, fills the
// positions past n of the last tile. A pointer that is not 16-byte aligned,
// and the 16 bytes that hold n's end, take element loads and stores.
//
// C interface (bound with ctypes): running_scan returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it cannot take.
// It zeroes the ticket and the flags of its status buffer on the stream
// (running_scan_status_words gives the buffer's size), launches on the
// given stream, allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;  // 16-byte loads a thread
constexpr int kTileBytes = kThreads * kVecs * 16;
constexpr unsigned kAll = 0xffffffffu;

// a tile's status flag
constexpr int kNone = 0;       // nothing published yet
constexpr int kAggregate = 1;  // the tile's own aggregate
constexpr int kPrefix = 2;     // op over this tile and every one before it

// The status buffer, in 8-byte words: [ticket][flags: one int a tile]
// [aggregates: one word a tile][prefixes: one word a tile]. Values are
// kept as int64 words whatever the dtype.
__host__ __device__ inline int64_t flag_words(int64_t tiles) {
  return (tiles + 1) / 2;
}
inline int64_t status_words(int64_t tiles) {
  return 1 + flag_words(tiles) + 2 * tiles;
}

template <typename T>
struct Limits;
template <>
struct Limits<int32_t> {
  static constexpr int32_t lo = INT32_MIN, hi = INT32_MAX;
};
template <>
struct Limits<int64_t> {
  static constexpr int64_t lo = INT64_MIN, hi = INT64_MAX;
};

template <typename T, bool kMin>
struct Op {
  static constexpr T identity = kMin ? Limits<T>::hi : Limits<T>::lo;
  static __device__ __forceinline__ T apply(T a, T b) {
    return kMin ? (b < a ? b : a) : (b > a ? b : a);
  }
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int64_t load_relaxed(const int64_t* p) {
  int64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(int64_t* p, int64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// 16 bytes of T
template <typename T>
union Vec {
  static constexpr int n = 16 / sizeof(T);
  int4 raw;
  T e[n];
};

template <typename T, bool kMin, bool kReverse>
__global__ void __launch_bounds__(kThreads)
running_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t n,
               int64_t tiles, int64_t* __restrict__ status, bool vec) {
  using O = Op<T, kMin>;
  constexpr int kN = Vec<T>::n;          // elements a 16-byte load
  constexpr int kRun = 32 * kN;          // elements a warp's load
  constexpr int kWarpItems = kVecs * kRun;
  constexpr int64_t kTile = kWarps * kWarpItems;
  static_assert(kTile * static_cast<int64_t>(sizeof(T)) == kTileBytes, "tile");

  unsigned int* ticket = reinterpret_cast<unsigned int*>(status);
  int* flags = reinterpret_cast<int*>(status + 1);
  int64_t* aggregates = status + 1 + flag_words(tiles);
  int64_t* prefixes = aggregates + tiles;

  __shared__ int64_t s_order;
  __shared__ T s_warp[kWarps];
  __shared__ T s_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_order = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t order = s_order;  // this tile's place in the scan order
  const int64_t tile = kReverse ? tiles - 1 - order : order;
  const int64_t base = tile * kTile + static_cast<int64_t>(warp) * kWarpItems +
                       static_cast<int64_t>(lane) * kN;

  Vec<T> v[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t at = base + j * kRun;
    if (vec && at + kN <= n) {
      v[j].raw = __ldg(reinterpret_cast<const int4*>(in + at));
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        v[j].e[e] = at + e < n ? in[at + e] : O::identity;
      }
    }
  }

  // Within a thread's 16 bytes, then across the lanes of each run in scan
  // order, each run starting from the total of the runs before it.
  T carry = O::identity;
#pragma unroll
  for (int jj = 0; jj < kVecs; ++jj) {
    const int j = kReverse ? kVecs - 1 - jj : jj;
#pragma unroll
    for (int ee = 1; ee < kN; ++ee) {
      const int e = kReverse ? kN - 1 - ee : ee;
      const int prev = kReverse ? e + 1 : e - 1;
      v[j].e[e] = O::apply(v[j].e[prev], v[j].e[e]);
    }
    T x = v[j].e[kReverse ? 0 : kN - 1];  // the thread's total
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = kReverse ? __shfl_down_sync(kAll, x, d)
                           : __shfl_up_sync(kAll, x, d);
      if (kReverse ? lane + d < 32 : lane >= d) x = O::apply(x, y);
    }
    T before = kReverse ? __shfl_down_sync(kAll, x, 1)
                        : __shfl_up_sync(kAll, x, 1);
    if (lane == (kReverse ? 31 : 0)) before = O::identity;
    before = O::apply(carry, before);
#pragma unroll
    for (int e = 0; e < kN; ++e) v[j].e[e] = O::apply(before, v[j].e[e]);
    carry = O::apply(carry, __shfl_sync(kAll, x, kReverse ? 0 : 31));
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();

  T warp_before = O::identity;  // the warps before this one in scan order
  T tile_total = O::identity;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T a = s_warp[w];
    tile_total = O::apply(tile_total, a);
    if (kReverse ? w > warp : w < warp) warp_before = O::apply(warp_before, a);
  }

  if (warp == 0) {
    T before = O::identity;  // every tile before this one in scan order
    if (order > 0) {
      if (lane == 0) {
        store_relaxed(aggregates + order, static_cast<int64_t>(tile_total));
        store_release(flags + order, kAggregate);
      }
      for (int64_t end = order;; end -= 32) {
        const int64_t p = end - 1 - lane;  // a predecessor in scan order
        int f;
        do {
          f = p >= 0 ? load_acquire(flags + p) : kPrefix;
        } while (__any_sync(kAll, f == kNone));
        T got = O::identity;
        if (p >= 0) {
          got = static_cast<T>(
              load_relaxed((f == kPrefix ? prefixes : aggregates) + p));
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          got = O::apply(got, __shfl_xor_sync(kAll, got, d));
        }
        before = O::apply(before, got);
        if (__any_sync(kAll, f == kPrefix)) break;
      }
    }
    if (lane == 0) {
      store_relaxed(prefixes + order,
                    static_cast<int64_t>(O::apply(before, tile_total)));
      store_release(flags + order, kPrefix);
      s_prefix = before;
    }
  }
  __syncthreads();

  const T head = O::apply(s_prefix, warp_before);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t at = base + j * kRun;
#pragma unroll
    for (int e = 0; e < kN; ++e) v[j].e[e] = O::apply(head, v[j].e[e]);
    if (vec && at + kN <= n) {
      *reinterpret_cast<int4*>(out + at) = v[j].raw;
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        if (at + e < n) out[at + e] = v[j].e[e];
      }
    }
  }
}

inline int64_t tiles_of(int64_t n, int elem_bytes) {
  const int64_t tile = kTileBytes / elem_bytes;
  return (n + tile - 1) / tile;
}

template <typename T, bool kMin, bool kReverse>
cudaError_t launch(const void* in, void* out, int64_t n, int64_t tiles,
                   int64_t* status, bool vec, cudaStream_t on) {
  running_kernel<T, kMin, kReverse>
      <<<static_cast<unsigned>(tiles), kThreads, 0, on>>>(
          static_cast<const T*>(in), static_cast<T*>(out), n, tiles, status,
          vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* in, void* out, int64_t n, int64_t tiles,
                     int64_t* status, bool vec, bool is_min, bool reverse,
                     cudaStream_t on) {
  if (is_min) {
    return reverse ? launch<T, true, true>(in, out, n, tiles, status, vec, on)
                   : launch<T, true, false>(in, out, n, tiles, status, vec, on);
  }
  return reverse ? launch<T, false, true>(in, out, n, tiles, status, vec, on)
                 : launch<T, false, false>(in, out, n, tiles, status, vec, on);
}

}  // namespace scan

// int64 words of the status buffer running_scan needs for n elements of
// elem_bytes (4 or 8) each; 0 for arguments it cannot take.
extern "C" int64_t running_scan_status_words(int64_t n, int elem_bytes) {
  if (n <= 0 || (elem_bytes != 4 && elem_bytes != 8)) return 0;
  return scan::status_words(scan::tiles_of(n, elem_bytes));
}

// out = the running max (is_min 0) or min (is_min 1) of in, from the first
// element (reverse 0) or from the last (reverse 1); in and out hold n
// elements of elem_bytes (4: int32, 8: int64) and must not overlap; status
// holds running_scan_status_words(n, elem_bytes) words.
extern "C" int running_scan(const void* in, void* out, void* status,
                            int64_t n, int elem_bytes, int is_min,
                            int reverse, void* stream) {
  using namespace scan;
  if (n <= 0 || (elem_bytes != 4 && elem_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = tiles_of(n, elem_bytes);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  int64_t* words = static_cast<int64_t*>(status);
  // the ticket and the flags start at zero
  cudaError_t rc = cudaMemsetAsync(
      words, 0, static_cast<size_t>(1 + flag_words(tiles)) * 8, on);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const bool vec = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  rc = elem_bytes == 4
           ? dispatch<int32_t>(in, out, n, tiles, words, vec, is_min != 0,
                               reverse != 0, on)
           : dispatch<int64_t>(in, out, n, tiles, words, vec, is_min != 0,
                               reverse != 0, on);
  return static_cast<int>(rc);
}
