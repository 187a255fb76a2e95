// Byte-presence set of a byte string, for sm_90a: flags[v] = 1 when the
// byte value v occurs in data[0 .. n), else 0, for v in 0 .. 255.
//
// Replaces no Pallas kernel. The JAX package takes a text's alphabet on
// the host (mumemto_tpu/ops/pfp.py::_alphabet, a presence mask over a
// uint16 view), and so did the port until its text was uploaded before
// anything else read it: ops/pfp.build_pfp and the engine's direct backend
// now take the alphabet of the text where it already lies, on the card,
// and read back 256 bytes instead of scattering the whole text into a
// 65,536-entry mask on one host core (0.45 s for 264 M characters).
//
// What bounds it. The function reads each byte once and writes 256: at
// the benchmark's largest text (264 MB) that is 0.079 ms at an H100's
// 3.35 TB/s. Marking a byte costs an extract and a one-byte store to
// shared memory, 16 stores per 16-byte load; an SM takes one warp's
// stores a clock, 32 bytes, while device memory delivers it about 14.5
// bytes a clock (3.35 TB/s over 132 SMs at 1.755 GHz). So memory, not the
// stores, bounds it, as long as enough loads are in flight.
//
// What the design does about it.
//  * 16-byte loads over a grid-stride loop, four in flight per thread,
//    neighbouring threads on neighbouring 16-byte words. The grid is capped
//    at kBlocksPerSm blocks an SM (full occupancy): each block ends by
//    writing what it found to the 256 output bytes, so fewer blocks mean
//    fewer writes to those few bytes, all of them in two or three sectors
//    of L2.
//  * The set is 256 bytes of shared memory that every thread of the block
//    writes with plain one-byte stores. Stores of the same value 1 may race
//    and need no atomics; a text's letters lie in distinct 32-bit words
//    (and so distinct banks), so a warp's 32 stores rarely conflict.
//  * At the end each of 256 threads copies one flag to the output when it
//    is set: a block writes as many bytes as it found values. The launcher
//    zeroes the output on the stream first (cudaMemsetAsync).
//  * A pointer that is not 16-byte aligned (ext[1:] is not) is read from
//    its first 16-byte boundary on; the bytes before it and the last
//    n % 16 after the vectors are marked one by one by the first threads
//    of block 0. Lengths and offsets are int64: a text of 2^31 bytes or
//    more is one launch.
//
// C interface (bound with ctypes): byte_presence returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it cannot take.
// It launches on the given stream, allocates nothing and does not
// synchronise; for n = 0 it only zeroes the flags.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;  // 2048 threads: an SM's full occupancy
constexpr int kUnroll = 4;       // 16-byte loads in flight per thread

__device__ __forceinline__ void mark_word(uint8_t* seen, uint32_t w) {
  seen[w & 0xffu] = 1;
  seen[(w >> 8) & 0xffu] = 1;
  seen[(w >> 16) & 0xffu] = 1;
  seen[w >> 24] = 1;
}

__device__ __forceinline__ void mark(uint8_t* seen, uint4 v) {
  mark_word(seen, v.x);
  mark_word(seen, v.y);
  mark_word(seen, v.z);
  mark_word(seen, v.w);
}

// data + head is 16-byte aligned; vectors 16-byte words follow it, then
// tail single bytes
__global__ void __launch_bounds__(kThreads)
byte_presence_kernel(const uint8_t* __restrict__ data, int head,
                     int64_t vectors, int tail, uint8_t* __restrict__ flags) {
  __shared__ __align__(16) uint8_t seen[256];
  const int tid = threadIdx.x;
  if (tid < 64) reinterpret_cast<uint32_t*>(seen)[tid] = 0u;
  __syncthreads();

  const uint4* vec = reinterpret_cast<const uint4*>(data + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  for (; i + (kUnroll - 1) * stride < vectors; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(vec + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) mark(seen, v[u]);
  }
  for (; i < vectors; i += stride) mark(seen, __ldg(vec + i));
  if (blockIdx.x == 0) {
    if (tid < head) seen[data[tid]] = 1;
    if (tid < tail) seen[data[head + 16 * vectors + tid]] = 1;
  }
  __syncthreads();
  if (tid < 256 && seen[tid]) flags[tid] = 1;
}

}  // namespace

extern "C" int byte_presence(const void* data, int64_t n, void* flags,
                             void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(flags, 0, 256, on);
  if (rc != cudaSuccess || n == 0) return static_cast<int>(rc);
  const uint8_t* bytes = static_cast<const uint8_t*>(data);
  const int64_t to_boundary =
      (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(bytes) % 16)) %
      16;
  const int head = static_cast<int>(n < to_boundary ? n : to_boundary);
  const int64_t vectors = (n - head) / 16;
  const int tail = static_cast<int>(n - head - 16 * vectors);
  int dev = 0, sms = 0;
  rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t wanted = (vectors + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int64_t blocks = wanted < 1 ? 1 : (wanted < cap ? wanted : cap);
  byte_presence_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, on>>>(
      bytes, head, vectors, tail, static_cast<uint8_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}
