// Toolchain probe kernel: out[i] = x[i] + 1 over int32, for sm_90a.
//
// Replaces the Pallas TPU probe tools/mosaic_probe.py (`add_one`, the
// kernel inside its CHILD string), which checked that Mosaic could compile
// and run a kernel at all. Here it checks the port's own route: nvcc ->
// shared library -> ctypes -> a launch on PyTorch's current stream, the
// same route kernels/kr_mask.py takes.
//
// One thread per element over a grid-stride loop. What bounds it: at the
// probe's (8, 128) tile it is one launch of 4 KiB, so the launch itself
// sets its time; at any size it is a copy (8 bytes per element), bounded
// by memory bandwidth.
//
// C interface (bound with ctypes): add_one_i32 returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it cannot take.
// It launches on the given stream, allocates nothing and does not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 65535;

__global__ void add_one_kernel(const int32_t* __restrict__ x,
                               int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    // unsigned add: wraps at INT32_MAX like torch's int32 x + 1
    out[i] = static_cast<int32_t>(static_cast<uint32_t>(x[i]) + 1u);
  }
}

}  // namespace

extern "C" int add_one_i32(const void* x, void* out, int64_t n,
                           void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  add_one_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
