// K7 — the correlation numerator of the NCC matcher for Hopper (sm_90a).
// Replaces ekf_slam_tpu/ops/pallas_kernels.py ncc_corr (_ncc_corr_kernel):
// for N (window, zero-mean template) pairs,
//   out[n][oy][ox] = Σ_{dy,dx} win[n][oy+dy][ox+dx] · tm[n][dy][dx],
// win (N, W2, W2), tm (N, t, t), out (N, R2, R2), R2 = W2 − t + 1, all f32
// row-major. The image path calls it once a frame for all B·CAP (window,
// template) pairs of the batch.
//
// Bound on the H100 at the pixels-bench size (N = 3,200 = B 32 · CAP 100,
// W2 = 37, t = 13, R2 = 25): 2·N·R2²·t² = 676 MFLOP, 10.1 µs at the
// 67 TFLOP/s f32 peak, against 27.7 MB moved (each input read once, the
// output written once), 8.3 µs at 3.35 TB/s — so the operations bound it,
// barely. What the design does about that: each block stages one pair's
// window (5.5 KB) and template in shared memory once, so device memory is
// read once per pair and every one of the t² taps of every offset is an
// FMA on shared-memory operands; the template tap is the same address for
// the whole warp (a broadcast). Each thread owns offsets tid, tid + NT, …
// of the pair's R2² and runs the t² FMA chain in dy-major, dx-minor order
// (the Pallas kernel's order), so results are deterministic. Ragged edges
// are masked by index; nothing is padded. f32 on CUDA cores: no TF32, no
// tensor cores. Two shared-memory loads per FMA bound this simple form
// well above the FMA peak; register blocking of neighbouring offsets (to
// reuse window values across taps) is the later step that makes it fast.
//
// Plain C ABI (bound with ctypes): the launcher returns the cudaError_t of
// its launch and launches on the caller's stream.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(NT)
    k7_kernel(const float* __restrict__ win, const float* __restrict__ tm,
              float* __restrict__ out, int W2, int t) {
  extern __shared__ __align__(16) float sm[];
  const int n = blockIdx.x;
  const int R2 = W2 - t + 1;
  const int nw = W2 * W2, nt = t * t;
  win += static_cast<size_t>(n) * nw;
  tm += static_cast<size_t>(n) * nt;
  out += static_cast<size_t>(n) * R2 * R2;

  float* sw = sm;                             // W2 x W2 window
  float* st = sm + up4(nw);                   // t x t template
  for (int i = threadIdx.x; i < nw; i += NT) sw[i] = win[i];
  for (int i = threadIdx.x; i < nt; i += NT) st[i] = tm[i];
  __syncthreads();

  for (int o = threadIdx.x; o < R2 * R2; o += NT) {
    const int oy = o / R2, ox = o % R2;
    const float* w0 = sw + oy * W2 + ox;
    float acc = 0.f;
    for (int dy = 0; dy < t; ++dy) {
      const float* wr = w0 + dy * W2;
      const float* tr = st + dy * t;
      for (int dx = 0; dx < t; ++dx) acc = fmaf(wr[dx], tr[dx], acc);
    }
    out[o] = acc;
  }
}

}  // namespace

extern "C" {

// K7. win (N,W2,W2); tm (N,t,t); out (N,R2,R2). Contiguous row-major f32.
// 1 <= t <= W2, and the window and template must fit one block's shared
// memory (W2 up to ~230); else cudaErrorInvalidValue.
cudaError_t ekf_k7_ncc_corr(const float* win, const float* tm, float* out,
                            int N, int W2, int t, void* stream) {
  if (N < 1 || t < 1 || t > W2) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (up4(W2 * W2) + t * t);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  void* args[] = {&win, &tm, &out, &W2, &t};
  return launch(reinterpret_cast<const void*>(k7_kernel), dim3(N), smem,
                args, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
