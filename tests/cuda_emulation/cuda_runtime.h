// A host stand-in for <cuda_runtime.h>, enough to compile the port's
// csrc/*.cu with g++ and run a kernel's index logic on the CPU: a block is
// run as one std::thread per CUDA thread, __syncthreads() is a
// std::barrier, shared memory is one array poisoned with NaN before each
// block (a read of an unstaged word shows), and the asynchronous copies of
// common.cuh are done at once, with their alignment rules checked. Blocks
// run one after the other. It shows wrong indices, masks and ragged edges,
// not races or asynchrony. See harness.cpp.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <thread>
#include <vector>

#define EKF_HOST_EMULATION
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
using std::min;

struct uint3_ { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ gridDim;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
// A card of two SMs that hold one block each: a launcher that sizes its
// grid to the resident blocks (K7) walks each block over several groups.
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2;
  return 0;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, const void*, int, size_t) {
  *n = 1;
  return 0;
}

// The block's dynamic shared memory: every kernel declares it as
// `extern __shared__ float sm[]` inside the sources' unnamed namespace.
namespace { alignas(16) float sm[57 * 1024]; }

inline std::barrier<>* g_barrier;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }

// Kernels are launched by pointer: harness.cpp registers a caller for each.
inline std::map<const void*, std::function<void(void**)>> g_kernels;
inline long g_blocks = 0;

inline cudaError_t cudaLaunchKernel(const void* fn, dim3 grid, dim3 block,
                                    void** args, size_t smem, cudaStream_t) {
  const auto it = g_kernels.find(fn);
  if (it == g_kernels.end() || smem > sizeof(sm)) return 98;
  gridDim = {grid.x, grid.y, grid.z};
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        for (size_t i = 0; i < smem / 4; ++i) sm[i] = NAN;
        std::barrier<> bar(block.x);
        g_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([&, t] {
            threadIdx = {t, 0, 0};
            blockIdx = {bx, by, bz};
            it->second(args);
          });
        for (auto& th : threads) th.join();
        ++g_blocks;
      }
  return 0;
}

// The asynchronous copies of common.cuh, done at once.
inline void cp_async4(float* dst, const float* src, bool ok) {
  *dst = ok ? *src : 0.f;
}
inline void cp_async_wait_all() {}
inline void mbar_init(unsigned long long* mbar, int) { *mbar = 0; }
inline void mbar_arrive_expect(unsigned long long*, unsigned) {}
inline void mbar_wait(unsigned long long*) {}
inline void bulk_copy(void* dst, const void* src, unsigned bytes,
                      unsigned long long*) {
  if ((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src) | bytes) &
      15) {
    printf("bulk_copy: address or size not a multiple of 16\n");
    abort();
  }
  memcpy(dst, src, bytes);
}
