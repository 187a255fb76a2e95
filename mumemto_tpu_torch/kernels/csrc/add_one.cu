// Toolchain probe kernel: out[i] = x[i] + 1 over int32, for sm_90a.
//
// Replaces the Pallas TPU probe tools/mosaic_probe.py (`add_one`, the
// kernel inside its CHILD string), which checked that Mosaic could compile
// and run a kernel at all. Here it checks the port's own route: nvcc ->
// shared library -> ctypes -> a launch on PyTorch's current stream, the
// same route kernels/kr_mask.py takes.
//
// What bounds it on an H100: at the probe's (8, 128) tile (4 KiB) the host
// launch path sets its time, so the C entry point does no more than pick a
// body and launch it; the Python wrapper keeps its own per-call work small
// (kernels/build.py). At a large n it is a copy, 8 bytes of HBM traffic
// per element, so the body is shaped for the memory path: each thread
// moves 16 bytes (one int4) and neighbouring threads touch neighbouring
// 16-byte words, one int4 per thread over a grid as wide as the data. A
// grid capped at 4-32 resident blocks per SM with a grid-stride loop (1-8
// int4 in flight per thread, with and without streaming cache hints)
// measured 3.5-8% slower at 2^26 elements on the H100 (PERF.md), so the
// grid is not capped. A scalar tail covers n % 4, and a scalar body covers
// a pointer that is not 16-byte aligned (a contiguous view such as x[1:]
// is 4-byte aligned). Shared memory, wgmma and TMA have nothing to offer
// an elementwise add: every byte is read once and written once, with no
// reuse to stage.
//
// C interface (bound with ctypes): add_one_i32 returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it cannot take.
// It launches on the given stream, allocates nothing and does not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// unsigned add: wraps at INT32_MAX like torch's int32 x + 1
__device__ __forceinline__ int32_t inc(int32_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) + 1u);
}

__global__ void add_one_vec4(const int4* __restrict__ x,
                             int4* __restrict__ out, int64_t n4,
                             const int32_t* __restrict__ x_tail,
                             int32_t* __restrict__ out_tail, int tail) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n4) {
    int4 v = x[i];
    v.x = inc(v.x);
    v.y = inc(v.y);
    v.z = inc(v.z);
    v.w = inc(v.w);
    out[i] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    out_tail[threadIdx.x] = inc(x_tail[threadIdx.x]);
  }
}

__global__ void add_one_scalar(const int32_t* __restrict__ x,
                               int32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = inc(x[i]);
}

// one thread per item, at least one block
unsigned grid_for(int64_t items) {
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" int add_one_i32(const void* x, void* out, int64_t n,
                           void* stream) {
  // grid_for(n) blocks must fit gridDim.x
  if (n <= 0 || n > (int64_t{1} << 38)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* oi = static_cast<int32_t*>(out);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15u) == 0;
  if (aligned) {
    const int64_t n4 = n / 4;
    const int tail = static_cast<int>(n - 4 * n4);
    add_one_vec4<<<grid_for(n4), kThreads, 0, s>>>(
        reinterpret_cast<const int4*>(xi), reinterpret_cast<int4*>(oi), n4,
        xi + 4 * n4, oi + 4 * n4, tail);
  } else {
    add_one_scalar<<<grid_for(n), kThreads, 0, s>>>(
        xi, oi, n);
  }
  return static_cast<int>(cudaGetLastError());
}
