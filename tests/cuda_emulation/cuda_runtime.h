// A host stand-in for <cuda_runtime.h>, enough to compile the port's
// csrc/*.cu with g++ and run a kernel's index logic on the CPU: a block is
// run as one host thread per CUDA thread (the threads kept from block to
// block), __syncthreads() is a std::barrier and __syncwarp() one of the
// warp's 32 threads, shared memory is one array poisoned with NaN before
// each block (a read of an unstaged word shows), and the asynchronous
// copies of common.cuh are done at once, with their alignment rules
// checked. Blocks run one after the other. It shows wrong indices, masks
// and ragged edges, not races or asynchrony. See harness.cpp.
#pragma once
#include <algorithm>
#include <barrier>
#include <condition_variable>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
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
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
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

// A warp: a barrier of its threads (those with the same threadIdx.x / 32)
// and two sets of exchange slots, used in turn, so that one barrier a vote
// suffices (a thread writes the next set only after every thread of the
// warp has arrived at the barrier that ends the reads of that set's
// previous use). Every thread of the warp must take part in every warp
// primitive, as on the card with a full mask; the masks are not read.
struct Warp {
  std::barrier<>* bar;
  unsigned size;                      // threads: 32 but in a ragged last warp
  unsigned long long slot[2][32];
};
inline std::vector<Warp>* g_warps;
inline thread_local unsigned g_turn;
inline Warp& this_warp() { return (*g_warps)[threadIdx.x / 32]; }
inline void __syncwarp(unsigned = 0xffffffffu) {
  this_warp().bar->arrive_and_wait();
}
inline int __all_sync(unsigned, int pred) {
  Warp& w = this_warp();
  unsigned long long* s = w.slot[g_turn++ & 1];
  s[threadIdx.x % 32] = pred != 0;
  w.bar->arrive_and_wait();
  int all = 1;
  for (unsigned k = 0; k < this_warp().size; ++k) all = all && s[k] != 0;
  return all;
}
// IEEE product and sum, never fused (the card's __fmul_rn, __fadd_rn).
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, 4);
  return i;
}
inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}

// Kernels are launched by pointer: harness.cpp registers a caller for each.
inline std::map<const void*, std::function<void(void**)>> g_kernels;
inline long g_blocks = 0;

// The host threads that run a block's CUDA threads, all at once, kept from
// one block to the next (starting a block's threads anew costs more than
// most blocks' work under AddressSanitizer).
class BlockThreads {
 public:
  // fn(t) on thread t for t < n; returns when every call has.
  void run(unsigned n, const std::function<void(unsigned)>& fn) {
    while (threads_.size() < n) {
      const unsigned id = threads_.size();
      threads_.emplace_back([this, id] { serve(id); });
    }
    {
      std::lock_guard<std::mutex> lock(m_);
      fn_ = &fn;
      n_ = pending_ = n;
      ++round_;
    }
    start_.notify_all();
    std::unique_lock<std::mutex> lock(m_);
    finished_.wait(lock, [this] { return pending_ == 0; });
  }
  ~BlockThreads() {
    {
      std::lock_guard<std::mutex> lock(m_);
      stop_ = true;
      ++round_;
    }
    start_.notify_all();
    for (auto& t : threads_) t.join();
  }

 private:
  void serve(unsigned id) {
    unsigned long seen = 0;
    for (;;) {
      const std::function<void(unsigned)>* fn;
      {
        std::unique_lock<std::mutex> lock(m_);
        start_.wait(lock, [&] { return round_ != seen; });
        seen = round_;
        if (stop_) return;
        if (id >= n_) continue;
        fn = fn_;
      }
      (*fn)(id);
      std::lock_guard<std::mutex> lock(m_);
      if (--pending_ == 0) finished_.notify_one();
    }
  }
  std::vector<std::thread> threads_;
  std::mutex m_;
  std::condition_variable start_, finished_;
  const std::function<void(unsigned)>* fn_ = nullptr;
  unsigned n_ = 0, pending_ = 0;
  unsigned long round_ = 0;
  bool stop_ = false;
};
inline BlockThreads g_threads;

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
        std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
        std::vector<Warp> warps;
        for (unsigned w = 0; w < (block.x + 31) / 32; ++w) {
          const unsigned n = std::min(32u, block.x - 32 * w);
          warp_bars.push_back(std::make_unique<std::barrier<>>(n));
          warps.push_back({warp_bars.back().get(), n, {}});
        }
        g_warps = &warps;
        g_threads.run(block.x, [&](unsigned t) {
          threadIdx = {t, 0, 0};
          blockIdx = {bx, by, bz};
          g_turn = 0;
          it->second(args);
        });
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
