// The text of a .mems file, written on the card: one line a multi-MEM,
//
//   L \t p1,p2,...,pk \t d1,d2,...,dk \t s1,s2,...,sk \n
//
// (mem_finder.hpp:210-263: the match length, each occurrence's position,
// document and strand), all lines into one byte buffer, for sm_90a.
//
// The inputs are the compacted (m, W) match windows after the engine's
// position pass (engine._emit_mems): L (m) int64 lengths, tpos (m, W) int64
// positions already through the '-' transform, docs (m, W) int32 document
// ids, neg (m, W) uint8 strands (1 = '-'), nv (m) int64 occurrences a line
// (row r's occurrences are its first nv[r] columns, nv[r] >= 1), and
// line_off (m + 1) int64, the exclusive scan of the lines' byte lengths,
// which sizes the buffer. Values print in decimal, signed ('-' first when
// negative: a '-'-strand position can be, see the engine).
//
// Replaces no Pallas kernel: the JAX package formats the lines on the host
// with numpy string arrays (np.char.mod per occurrence, object-array joins):
// 2.2-2.7 s of a 3.6 s call at 10 x 3.6 Mbp with -f 3 on an NVIDIA H100
// host while the card idles, for ~11 MB of text. This kernel writes them in
// 0.080 ms there (92,000 lines, 11.4 MB; 10% of the bound below, 700 W).
//
// What bounds it. Bytes: each line's text is written once and each
// occurrence's window entries are read once (tpos 8, docs 4, neg 1 bytes;
// L, nv and two offsets 32 bytes a line), ~25 MB at 0.92 M occurrences,
// ~7.5 us at 3.35 TB/s. The design is the simple one that takes any width:
// a warp a line, lanes owning occurrences 32 at a time. Each lane counts
// its value's decimal width, an inclusive warp scan of the widths (each
// with its separator) places the lanes' text one after the other, and each
// lane writes its digits from the last one back. A line's three columns go
// one after the other, each chunk of 32 starting where the warp total of
// the one before ended; the strands take two bytes an occurrence and need
// no scan. The lines are independent, so nothing crosses warps.
//
// C interface (bound with ctypes): mem_render returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it cannot take;
// it launches on the given stream, allocates nothing and does not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace memtext {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint64_t magnitude(int64_t x) {
  return x < 0 ? 0ull - static_cast<uint64_t>(x) : static_cast<uint64_t>(x);
}

// bytes of x's decimal text: its digits (1 for 0, at most 19 for an int64)
// and a '-' when negative
__device__ __forceinline__ int width(int64_t x) {
  const uint64_t v = magnitude(x);
  int w = 1;
  uint64_t t = 10;
  while (w < 19 && v >= t) {
    ++w;
    t *= 10;
  }
  return w + (x < 0);
}

// x's decimal text into p[0 .. w - 1], w = width(x)
__device__ __forceinline__ void put(uint8_t* p, int64_t x, int w) {
  uint64_t v = magnitude(x);
  uint8_t* q = p + w;
  do {
    *--q = static_cast<uint8_t>('0' + v % 10);
    v /= 10;
  } while (v);
  if (x < 0) *--q = '-';
}

// One column of a line at p: the values vals[0 .. k - 1], each followed by
// ',' and the last by `last`; returns its bytes. Called by a whole warp.
template <typename T>
__device__ int64_t column(uint8_t* p, const T* vals, int64_t k, uint8_t last,
                          int lane) {
  int64_t base = 0;
  for (int64_t j0 = 0; j0 < k; j0 += 32) {
    const int64_t j = j0 + lane;
    const bool on = j < k;
    const int64_t x = on ? static_cast<int64_t>(vals[j]) : 0;
    const int w = on ? width(x) : 0;
    int end = on ? w + 1 : 0;  // inclusive scan of the text and separator
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, end, d);
      if (lane >= d) end += y;
    }
    if (on) {
      uint8_t* q = p + base + end - w - 1;
      put(q, x, w);
      q[w] = j == k - 1 ? last : ',';
    }
    base += __shfl_sync(kAll, end, 31);
  }
  return base;
}

__global__ void __launch_bounds__(kThreads)
render_kernel(const int64_t* __restrict__ L, const int64_t* __restrict__ tpos,
              const int32_t* __restrict__ docs,
              const uint8_t* __restrict__ neg, const int64_t* __restrict__ nv,
              const int64_t* __restrict__ line_off, int64_t m, int64_t W,
              uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;  // the whole warp: a warp is one row
  const int64_t k = nv[row];
  uint8_t* p = out + line_off[row];
  const int64_t len = L[row];
  const int wl = width(len);
  if (lane == 0) {
    put(p, len, wl);
    p[wl] = '\t';
  }
  p += wl + 1;
  p += column(p, tpos + row * W, k, '\t', lane);
  p += column(p, docs + row * W, k, '\t', lane);
  const uint8_t* s = neg + row * W;
  for (int64_t j = lane; j < k; j += 32) {
    p[2 * j] = s[j] ? '-' : '+';
    p[2 * j + 1] = j == k - 1 ? '\n' : ',';
  }
}

}  // namespace memtext

// The m lines of the windows into out (line_off[m] bytes).
extern "C" int mem_render(const void* L, const void* tpos, const void* docs,
                          const void* neg, const void* nv,
                          const void* line_off, int64_t m, int64_t W,
                          void* out, void* stream) {
  using namespace memtext;
  const int64_t blocks = (m + kWarps - 1) / kWarps;
  if (m <= 0 || W <= 0 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  render_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(L), static_cast<const int64_t*>(tpos),
      static_cast<const int32_t*>(docs), static_cast<const uint8_t*>(neg),
      static_cast<const int64_t*>(nv), static_cast<const int64_t*>(line_off),
      m, W, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
