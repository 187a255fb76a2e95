// The phrase records of a prefix-free parse, ranked on the card: a
// fingerprint of each record's bytes, a byte-for-byte check of each record
// against the head of its fingerprint run, and the last step of the MSD
// refinement (rank the members of each group still tied after the rounds by
// direct byte comparison), for sm_90a.
//
// A record is the byte span ext[st[r] .. st[r] + ln[r] - 1] of the parse's
// text; records overlap by w bytes and most of them repeat (20 haplotypes
// of one genome give ~20 copies of each phrase). ops/pfp.sort_phrases
// gives every record the dense rank of its phrase in unsigned-byte
// lexicographic order, a proper prefix first (memcmp over the shorter
// length, then the shorter first), and each phrase its smallest record
// index. It dedupes by fingerprint (phrase_fingerprint, a sort by
// (fingerprint, length), phrase_verify), refines the distinct phrases by
// rounds of 7-byte keys in PyTorch, and finishes the groups still tied
// after a fixed number of rounds with phrase_tail_rank.
//
// Replaces no Pallas kernel: the JAX package sorts the records on the host
// (native/mumemto_native.cc's std::sort with a memcmp comparator), where
// each of ~55 M comparisons of two equal ~100-byte phrases at random places
// of a 264 MB text waits on memory latency (2.5 s a call at 20 x 6.6 Mbp on
// the host, with the card idle). The bytes are already on the card.
//
// What bounds them. phrase_fingerprint and phrase_verify read each record's
// bytes once (~1.1 x the text, as records overlap by w), and write 8 bytes
// or nothing a record: bound by bytes, ~0.1 ms for 264 MB at 3.35 TB/s.
// The fingerprint takes 1.8 ms there and the check 0.6 ms (2.6 M records,
// NVIDIA H100 80GB HBM3 at 700 W): the check stops at a record's first
// difference, and the fingerprint's two modular products a byte keep it
// far from the bound, 0.1% of a mum call.
// A warp takes one record at a time and its 32 lanes read 32 consecutive
// bytes per load, so each load of a warp is one 32-byte sector. The
// fingerprint is two polynomial hashes, sum over i of byte_i * B^i, modulo
// the primes 2^31 - 1 and 2^31 - 19, reduced by shifts and adds (no
// division), each product one 32 x 32 -> 64-bit multiply; lane l takes the
// bytes i = l (mod 32) with its own power of B, the lanes' sums are added
// by shuffles. (Four loads a lane in flight made it slower: 2.40 against
// 1.82 ms at 2.6 M records on an H100.) phrase_tail_rank sorts each group
// in one block by merging runs of 1, 2, 4, ... members, a warp placing one
// member by a binary search of the other run, each comparison 32 bytes per
// step with a ballot for the first difference: O(g log^2 g) comparisons
// for a group of g members (distinct phrases sharing a long prefix), then
// one comparison a member with its neighbour for the ties.
//
// C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it cannot take; it launches on the given stream, allocates
// nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace phrases {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int64_t kMaxBlocks = 16384;

// the two hashes of the fingerprint: modulus 2^31 - C and base B
constexpr uint64_t kM31 = 0x7fffffffULL;
constexpr uint64_t kC1 = 1, kB1 = 911382323ULL;
constexpr uint64_t kC2 = 19, kB2 = 972663749ULL;

// x mod (2^31 - C) for any 64-bit x, with C < 2^6
template <uint64_t C>
__device__ __forceinline__ uint64_t reduce(uint64_t x) {
  constexpr uint64_t p = (1ULL << 31) - C;
  x = (x & kM31) + C * (x >> 31);  // < 2^31 + C * 2^33
  x = (x & kM31) + C * (x >> 31);  // < 2^31 + C * 2^9
  return x >= p ? x - p : x;
}

// a * b for a, b < 2^32: one 32 x 32 -> 64-bit multiply
__device__ __forceinline__ uint64_t wide(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>(static_cast<uint32_t>(a)) *
         static_cast<uint32_t>(b);
}

template <uint64_t C>
__device__ __forceinline__ uint64_t mulmod(uint64_t a, uint64_t b) {
  return reduce<C>(wide(a, b));  // a, b < 2^31
}

template <uint64_t C>
__device__ uint64_t power(uint64_t b, int e) {
  uint64_t r = 1;
  for (int i = 0; i < e; ++i) r = mulmod<C>(r, b);
  return r;
}

// fp[r] = (h1 << 31) | h2, h_k = sum_i ext[st[r] + i] * B_k^i mod (2^31 - C_k)
__global__ void __launch_bounds__(kThreads)
fingerprint_kernel(const uint8_t* __restrict__ ext,
                   const int32_t* __restrict__ st,
                   const int32_t* __restrict__ ln, int64_t m,
                   int64_t* __restrict__ fp) {
  const int lane = threadIdx.x & 31;
  // this lane's first power and the step between its bytes, once a warp
  const uint64_t first1 = power<kC1>(kB1, lane);
  const uint64_t first2 = power<kC2>(kB2, lane);
  const uint64_t step1 = power<kC1>(kB1, 32);
  const uint64_t step2 = power<kC2>(kB2, 32);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       r < m; r += warps) {
    const uint8_t* p = ext + st[r];
    const int32_t n = ln[r];
    uint64_t h1 = 0, h2 = 0, pw1 = first1, pw2 = first2;
    for (int32_t i = lane; i < n; i += 32) {
      const uint64_t b = p[i];
      h1 = reduce<kC1>(h1 + wide(b, pw1));
      h2 = reduce<kC2>(h2 + wide(b, pw2));
      pw1 = mulmod<kC1>(pw1, step1);
      pw2 = mulmod<kC2>(pw2, step2);
    }
    // 32 sums below 2^31 each: no overflow before the last reduction
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      h1 += __shfl_xor_sync(kAll, h1, off);
      h2 += __shfl_xor_sync(kAll, h2, off);
    }
    if (lane == 0) {
      fp[r] = static_cast<int64_t>((reduce<kC1>(h1) << 31) | reduce<kC2>(h2));
    }
  }
}

// bad += the records order[i] whose bytes differ from head[i]'s (same
// length: a run shares its length)
__global__ void __launch_bounds__(kThreads)
verify_kernel(const uint8_t* __restrict__ ext, const int32_t* __restrict__ st,
              const int32_t* __restrict__ ln,
              const int32_t* __restrict__ order,
              const int32_t* __restrict__ head, int64_t m,
              int32_t* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       i < m; i += warps) {
    const int32_t a = order[i], h = head[i];
    if (a == h) continue;
    const uint8_t* pa = ext + st[a];
    const uint8_t* ph = ext + st[h];
    const int32_t n = ln[a];
    bool differs = false;
    for (int32_t j = 0; j < n && !differs; j += 32) {
      const int32_t k = j + lane;
      differs = __any_sync(kAll, k < n && pa[k] != ph[k]);
    }
    if (differs && lane == 0) atomicAdd(bad, 1);
  }
}

// -1, 0 or 1 as record a's bytes from depth d on compare with b's, by
// memcmp over the shorter remainder, then the shorter first; all lanes of
// the warp get the answer
__device__ int compare(const uint8_t* __restrict__ ext,
                       const int32_t* __restrict__ st,
                       const int32_t* __restrict__ ln, int32_t a, int32_t b,
                       int64_t d, int lane) {
  const int64_t la = ln[a] - d, lb = ln[b] - d;
  const int64_t n = la < lb ? la : lb;
  const uint8_t* pa = ext + st[a] + d;
  const uint8_t* pb = ext + st[b] + d;
  for (int64_t j = 0; j < n; j += 32) {
    const int64_t k = j + lane;
    const int x = k < n ? pa[k] : 0;
    const int y = k < n ? pb[k] : 0;
    const unsigned diff = __ballot_sync(kAll, x != y);
    if (diff) {
      const int at = __ffs(diff) - 1;
      const int sx = __shfl_sync(kAll, x, at);
      const int sy = __shfl_sync(kAll, y, at);
      return sx < sy ? -1 : 1;
    }
  }
  return la < lb ? -1 : (la > lb ? 1 : 0);
}

// Group g holds the S-positions active[starts[g] .. starts[g + 1] - 1],
// tied through depth d and sharing bucket[active[starts[g]]] (the final
// position of the group's first member). The block sorts the group's
// members (their indices i in the group, member i being record
// rec[active[starts[g] + i]]) by their bytes from d on, stably: runs of
// width 1, 2, 4, ... are merged pairwise, member x of a left run going to
// its index plus the number of the right run's members smaller than x,
// member y of a right run to its index plus the number of the left run's
// members not greater than y. Each member's bucket becomes the base plus
// the sorted position of the first member equal to it, so equal members
// keep one bucket. buf holds 2 x members int32: two buffers, each indexed
// like active.
__global__ void __launch_bounds__(kThreads)
tail_kernel(const uint8_t* __restrict__ ext, const int32_t* __restrict__ st,
            const int32_t* __restrict__ ln, const int32_t* __restrict__ rec,
            const int32_t* __restrict__ active,
            const int32_t* __restrict__ starts, int64_t d, int64_t members,
            int32_t* __restrict__ bucket, int32_t* __restrict__ buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s = starts[blockIdx.x];
  const int64_t g = starts[blockIdx.x + 1] - s;
  const int32_t* grp = active + s;
  const int32_t base = bucket[grp[0]];
  int32_t* src = buf + s;
  int32_t* dst = buf + members + s;
  for (int64_t t = threadIdx.x; t < g; t += kThreads) {
    src[t] = static_cast<int32_t>(t);
  }
  __syncthreads();
  for (int64_t width = 1; width < g; width <<= 1) {
    for (int64_t t = warp; t < g; t += kWarps) {
      const int64_t lo = t / (2 * width) * (2 * width);
      const int64_t mid = lo + width < g ? lo + width : g;
      const int64_t hi = lo + 2 * width < g ? lo + 2 * width : g;
      const int32_t x = src[t];
      const int32_t rx = rec[grp[x]];
      const bool left = t < mid;
      // left: the right run's members < x; right: the left run's <= x
      int64_t a = left ? mid : lo, b = left ? hi : mid;
      while (a < b) {
        const int64_t m = (a + b) >> 1;
        const int c = compare(ext, st, ln, rec[grp[src[m]]], rx, d, lane);
        if (c < 0 || (!left && c == 0)) {
          a = m + 1;
        } else {
          b = m;
        }
      }
      if (lane == 0) dst[left ? t + a - mid : t - mid + a] = x;
    }
    __syncthreads();
    int32_t* swap = src;
    src = dst;
    dst = swap;
  }
  // dst[t] = 1 where sorted member t differs from member t - 1
  for (int64_t t = warp; t < g; t += kWarps) {
    const int c = t == 0 ? 1 : compare(ext, st, ln, rec[grp[src[t - 1]]],
                                       rec[grp[src[t]]], d, lane);
    if (lane == 0) dst[t] = c != 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t first = 0;
    for (int64_t t = 0; t < g; ++t) {
      if (dst[t]) first = static_cast<int32_t>(t);
      bucket[grp[src[t]]] = base + first;
    }
  }
}

inline unsigned blocks_for(int64_t items) {
  const int64_t b = (items + kWarps - 1) / kWarps;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace phrases

// fp[r] for the m records (st, ln) of ext: int64 fingerprints, each
// below 2^62.
extern "C" int phrase_fingerprint(const void* ext, const void* st,
                                  const void* ln, int64_t m, void* fp,
                                  void* stream) {
  using namespace phrases;
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fingerprint_kernel<<<blocks_for(m), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ext), static_cast<const int32_t*>(st),
      static_cast<const int32_t*>(ln), m, static_cast<int64_t*>(fp));
  return static_cast<int>(cudaGetLastError());
}

// *bad (an int32 the call zeroes on the stream) = the number of the m
// sorted records order[i] whose bytes differ from those of head[i].
extern "C" int phrase_verify(const void* ext, const void* st, const void* ln,
                             const void* order, const void* head, int64_t m,
                             void* bad, void* stream) {
  using namespace phrases;
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(bad, 0, sizeof(int32_t), on);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  verify_kernel<<<blocks_for(m), kThreads, 0, on>>>(
      static_cast<const uint8_t*>(ext), static_cast<const int32_t*>(st),
      static_cast<const int32_t*>(ln), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(head), m, static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// The groups' buckets from depth d on: one block a group, `groups` groups
// whose members' S-positions are active[starts[g] .. starts[g + 1] - 1],
// `members` = starts[groups] in all; scratch holds 2 x members int32.
extern "C" int phrase_tail_rank(const void* ext, const void* st,
                                const void* ln, const void* rec,
                                const void* active, const void* starts,
                                int64_t groups, int64_t members, int64_t d,
                                void* bucket, void* scratch, void* stream) {
  using namespace phrases;
  if (groups <= 0 || groups > 0x7fffffffLL || members <= 0 ||
      members > 0x7fffffffLL || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tail_kernel<<<static_cast<unsigned>(groups), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ext), static_cast<const int32_t*>(st),
      static_cast<const int32_t*>(ln), static_cast<const int32_t*>(rec),
      static_cast<const int32_t*>(active),
      static_cast<const int32_t*>(starts), d, members,
      static_cast<int32_t*>(bucket), static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
