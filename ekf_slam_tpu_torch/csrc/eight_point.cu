// eight_point_fit — the 8-point RANSAC's batched eigensolver for Hopper
// (sm_90a).
// Replaces no Pallas kernel: it stands for XLA's eigh + svd in
// ekf_slam_tpu/models/loopclosure.py:181-194 (_eight_point), which the
// port had taken to torch.linalg.eigh + torch.linalg.svd (cuSOLVER's
// batched syevj / gesvdj). Both check their convergence flag on the host,
// so a frame that calls them cannot be captured into a CUDA graph, and
// both raise on a NaN matrix where JAX returns NaN. For each of N
// matrices M (9 x 9, f32, row-major):
//   f  = the unit eigenvector of the smallest eigenvalue of ½(M + Mᵀ);
//   F  = f reshaped row-major to 3 x 3;
//   F₂ = F·(I − v₃v₃ᵀ) = F − (F·v₃)·v₃ᵀ, v₃ F's right singular vector of
//        its smallest singular value: JAX's (U * S.at[2].set(0)) @ Vt,
//        which does not depend on the signs an SVD picks (F₂ does follow
//        f's sign, the solver's choice, as it does in JAX);
//   a non-finite M gives an all-NaN F₂.
//
// Bound on the H100 at the loop path's size (N = B·top_k·NH = 4·7·64 =
// 1,792): the function reads 81 and writes 9 floats a matrix, 0.65 MB,
// 0.19 µs at 3.35 TB/s; its arithmetic (one Jacobi sweep, the least it
// needs, ~4,300 flops a matrix: chip_smoke.FLOPS) is 7.7 MFLOP, 0.11 µs at
// 67 TFLOP/s. Neither binds in practice: each matrix is a chain of some
// 300 dependent plane rotations, so the kernel is latency-bound.
//
// What the design does about it:
// - One thread a matrix, the whole solve in registers: the upper triangle
//   of ½(M + Mᵀ) (45 floats) and the accumulated rotations (81), every
//   loop over indices fully unrolled so that no index is dynamic. Cyclic
//   Jacobi sweeps (36 rotations in row order) until the off-diagonal mass
//   falls below 2⁻²⁴ of the matrix's Frobenius norm (the test runs inside
//   the kernel, once a sweep), at most EP_SWEEPS sweeps. Jacobi's rotations
//   are orthogonal and each eigenvector comes out with an error of the
//   order of ε·‖M‖ / (its eigengap): no tridiagonal reduction, no pivoting,
//   the same few instructions for every matrix.
// - M is scaled by a power of two first (exact), so no square over- or
//   underflows in the norms whatever M's scale.
// - v₃ from a one-sided (Hestenes) Jacobi on F's columns, not from an
//   eigensolve of FᵀF, which would square F's condition number: the
//   columns of F·W are made orthogonal by plane rotations W, and v₃ is the
//   column of W whose column of F·W is shortest.
// - Blocks of EP_THREADS = 32 threads, 56 blocks at N = 1,792, so each
//   SM runs one warp: the rotations' dependency chains, not the issue rate
//   or the memory, set the time. A block stages its 32 matrices through
//   shared memory so that device memory is read and written coalesced (an
//   odd stride of 81 and of 9 floats a thread: no bank conflict).
// Deterministic: a fixed order of rotations, no atomics.
//
// Plain C ABI (bound with ctypes): the launcher returns the cudaError_t of
// its launch and launches on the caller's stream.

#include "common.cuh"

namespace {

constexpr int EP_THREADS = 32;                   // matrices (threads) a block
constexpr int EP_SMEM = EP_THREADS * 81 * 4;     // a block's staged M
constexpr int EP_SWEEPS = 16;                    // cap of the 9 x 9 sweeps
constexpr int EP_SWEEPS3 = 10;                   // cap of the 3 x 3 sweeps
// Jacobi stops once Σ_{i≠j} a_ij² ≤ EP_OFF2 · ‖a‖²_F (off ≤ 2⁻²⁴·‖a‖_F).
constexpr float EP_OFF2 = 3.5527137e-15f;        // 2⁻⁴⁸
// The one-sided Jacobi leaves a column pair once |g_i·g_j| ≤ EP_ORTHO ·
// ‖g_i‖·‖g_j‖ (a few f32 roundings: a tighter test would chase rounding).
constexpr float EP_ORTHO = 4.7683716e-07f;       // 2⁻²¹
constexpr float EP_FLT_MAX = 3.40282347e+38f;

// Index of (i, j) in the packed upper triangle of a symmetric 9 x 9.
__host__ __device__ constexpr int ep_at(int i, int j) {
  return i <= j ? i * (17 - i) / 2 + j : j * (17 - j) / 2 + i;
}

// (c, s, t) of the plane rotation that zeroes the (p, q) entry: t = tan θ is
// the smaller root of t² + 2·τ·t − 1 = 0 (Golub and Van Loan's
// sym.schur2; a huge τ gives t = 0, no rotation).
__device__ __forceinline__ void ep_cs(float tau, float& c, float& s,
                                      float& t) {
  t = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
  c = 1.f / sqrtf(1.f + t * t);
  s = t * c;
}

// One Jacobi rotation of the symmetric a (packed) in the (p, q) plane,
// accumulated into the columns of v (row-major 9 x 9): a ← Jᵀ·a·J, v ← v·J.
__device__ __forceinline__ void ep_rotate(float (&a)[45], float (&v)[81],
                                          int p, int q) {
  const float apq = a[ep_at(p, q)];
  if (apq == 0.f) return;
  const float app = a[ep_at(p, p)], aqq = a[ep_at(q, q)];
  float c, s, t;
  ep_cs((aqq - app) / (2.f * apq), c, s, t);
  a[ep_at(p, p)] = app - t * apq;
  a[ep_at(q, q)] = aqq + t * apq;
  a[ep_at(p, q)] = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == p || k == q) continue;
    const float akp = a[ep_at(k, p)], akq = a[ep_at(k, q)];
    a[ep_at(k, p)] = c * akp - s * akq;
    a[ep_at(k, q)] = s * akp + c * akq;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float vkp = v[9 * k + p], vkq = v[9 * k + q];
    v[9 * k + p] = c * vkp - s * vkq;
    v[9 * k + q] = s * vkp + c * vkq;
  }
}

// The unit eigenvector f of the smallest eigenvalue of the symmetric a
// (packed; overwritten by its diagonalized form): cyclic Jacobi, then the
// column of the rotations at the smallest diagonal entry (the first of
// equal ones).
__device__ __forceinline__ void ep_smallest_eigvec(float (&a)[45],
                                                   float (&f)[9]) {
  float v[81];
#pragma unroll
  for (int i = 0; i < 81; ++i) v[i] = i % 10 == 0 ? 1.f : 0.f;
  float fro2 = 0.f;             // ‖a‖²_F: the rotations leave it unchanged
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = i; j < 9; ++j)
      fro2 += (i == j ? 1.f : 2.f) * a[ep_at(i, j)] * a[ep_at(i, j)];
  const float tol2 = EP_OFF2 * fro2;
#pragma unroll 1
  for (int sweep = 0; sweep < EP_SWEEPS; ++sweep) {
    float off2 = 0.f;
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = p + 1; q < 9; ++q) off2 += a[ep_at(p, q)] * a[ep_at(p, q)];
    if (2.f * off2 <= tol2) break;
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = p + 1; q < 9; ++q) ep_rotate(a, v, p, q);
  }
  float best = a[ep_at(0, 0)];
#pragma unroll
  for (int i = 0; i < 9; ++i) f[i] = v[9 * i];
#pragma unroll
  for (int j = 1; j < 9; ++j) {
    const float d = a[ep_at(j, j)];
    if (d < best) {
      best = d;
#pragma unroll
      for (int i = 0; i < 9; ++i) f[i] = v[9 * i + j];
    }
  }
}

// F₂ = F − (F·v₃)·v₃ᵀ for F = f (row-major 3 x 3): one-sided Jacobi on
// the columns of G = F·W from W = I, v₃ the column of W at the shortest
// column of G (the first of equal ones).
__device__ __forceinline__ void ep_rank2(const float (&f)[9], float (&F2)[9]) {
  float g[9], w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    g[i] = f[i];
    w[i] = i % 4 == 0 ? 1.f : 0.f;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < EP_SWEEPS3; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = i + 1; j < 3; ++j) {
        float al = 0.f, be = 0.f, ga = 0.f;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          al += g[3 * r + i] * g[3 * r + i];
          be += g[3 * r + j] * g[3 * r + j];
          ga += g[3 * r + i] * g[3 * r + j];
        }
        if (!(fabsf(ga) > EP_ORTHO * sqrtf(al * be))) continue;
        rotated = true;
        float c, s, t;
        ep_cs((be - al) / (2.f * ga), c, s, t);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float gi = g[3 * r + i], gj = g[3 * r + j];
          g[3 * r + i] = c * gi - s * gj;
          g[3 * r + j] = s * gi + c * gj;
          const float wi = w[3 * r + i], wj = w[3 * r + j];
          w[3 * r + i] = c * wi - s * wj;
          w[3 * r + j] = s * wi + c * wj;
        }
      }
    if (!rotated) break;
  }
  float v[3], best = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float n = g[j] * g[j] + g[3 + j] * g[3 + j] + g[6 + j] * g[6 + j];
    if (j == 0 || n < best) {
      best = n;
#pragma unroll
      for (int r = 0; r < 3; ++r) v[r] = w[3 * r + j];
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float u =
        f[3 * r] * v[0] + f[3 * r + 1] * v[1] + f[3 * r + 2] * v[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) F2[3 * r + c] = f[3 * r + c] - u * v[c];
  }
}

// One matrix m (row-major 9 x 9) to its F₂, and the eigenvector f it came
// from; F₂ (and f) all NaN for a non-finite m.
__device__ __forceinline__ void ep_fit(const float* m, float (&F2)[9],
                                       float (&f)[9]) {
  bool finite = true;
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 81; ++i) {
    const float x = fabsf(m[i]);
    finite = finite && x <= EP_FLT_MAX;
    amax = x > amax ? x : amax;
  }
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 9; ++i) F2[i] = f[i] = __uint_as_float(0x7fc00000u);
    return;
  }
  int e = 0;
  frexpf(amax, &e);
  const float sc = amax > 0.f ? ldexpf(1.f, -e) : 1.f;   // |m|·sc < 1
  float a[45];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = i; j < 9; ++j)
      a[ep_at(i, j)] = 0.5f * (m[9 * i + j] * sc + m[9 * j + i] * sc);
  ep_smallest_eigvec(a, f);
  ep_rank2(f, F2);
}

__global__ void __launch_bounds__(EP_THREADS)
    ep_kernel(const float* __restrict__ M, float* __restrict__ F2,
              float* __restrict__ fv, int N) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * EP_THREADS;
  const int nb = min(EP_THREADS, N - n0);
  const float* src = M + static_cast<size_t>(n0) * 81;
  for (int i = t; i < nb * 81; i += EP_THREADS) sm[i] = src[i];
  __syncthreads();
  float out[9], f[9];
  if (t < nb) {
    ep_fit(sm + 81 * t, out, f);
    if (fv != nullptr) {                // the eigenvectors, for a check
      float* dst = fv + (static_cast<size_t>(n0) + t) * 9;
#pragma unroll
      for (int i = 0; i < 9; ++i) dst[i] = f[i];
    }
  }
  __syncthreads();
  if (t < nb) {
#pragma unroll
    for (int i = 0; i < 9; ++i) sm[9 * t + i] = out[i];
  }
  __syncthreads();
  float* dst = F2 + static_cast<size_t>(n0) * 9;
  for (int i = t; i < nb * 9; i += EP_THREADS) dst[i] = sm[i];
}

}  // namespace

extern "C" {

// eight_point_fit. M (N,9,9) and F2 (N,3,3), contiguous row-major f32;
// f (N,9), the eigenvector each F2 came from, or null (not written).
// N >= 1, else cudaErrorInvalidValue.
cudaError_t ekf_eight_point_fit(const float* M, float* F2, float* f, int N,
                                void* stream) {
  if (N < 1) return cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(ep_kernel);
  void* args[] = {&M, &F2, &f, &N};
  return launch(fn, dim3((N + EP_THREADS - 1) / EP_THREADS), EP_SMEM, args,
                static_cast<cudaStream_t>(stream), EP_THREADS);
}

}  // extern "C"
