// Covariance kernels of the unfused SLAM step for Hopper (sm_90a): K4, the
// folded update tail's apply, and K6, the dense products on P. (K5, the
// update tail of the pallas_update route, is a mode of K3 in fused_cov.cu.)
//
// P (B, D, D) row-major f32, D = 13 + 6·CAP (613 at CAP 100); the ragged
// edge (D is odd) is masked by index and nothing past D is read. Every sum
// is a sequential fmaf chain in a fixed order: deterministic results, no
// atomics. f32 on CUDA cores: no TF32, no tensor cores, no TMA. Thread
// layout and helpers: common.cuh.
//
// Plain C ABI (bound with ctypes): each launcher returns the cudaError_t of
// its launch and launches on the caller's stream.

#include "common.cuh"

namespace {

// K4 — replaces ekf_slam_tpu/ops/pallas_kernels.py corr_apply_cols
// (_corr_sym_cols_kernel): the folded update tail's one-pass apply,
//   P⁺ = ½(P + Pᵀ) + ½(A·Bᵀ + B·Aᵀ),   A, B (D, R),
// entry by entry 0.5f·(P[r][c] + P[c][r]) + 0.5f·(s1 + s2) with
// s1 = Σ_k A[r][k]·B[c][k] and s2 = Σ_k B[r][k]·A[c][k] (pair_sums). s1 of
// entry (r, c) is s2 of entry (c, r), product for product in the same
// order, so P⁺ is bitwise symmetric, as the Pallas kernel's is.
// Bound on the H100: P is read twice (the tile and its transposed twin,
// the second mostly from L2) and written once, 1.5 MB each per instance
// at D = 613 — 576 MB at B = 128, 0.17 ms at 3.35 TB/s. The symmetric
// output needs its sums for one triangle only, 2·D(D+1)·R flops: R =
// 2·(2M) + 8 = 264 at the bench config's compact update (2M = 128 rows;
// 408 for a full-width update at CAP 100) makes 199 MFLOP per instance,
// 25 GFLOP per call at B = 128 (0.38 ms at the 67 TFLOP/s f32 peak),
// above the memory time. The simple design: one block per output tile
// (j, i, b), R looped in MC-wide chunks staged through shared memory (any
// R), the twin tile staged once for a coalesced read. It computes both
// triangles, twice the flops; halving the sums by mirroring is a later
// step.
__global__ void __launch_bounds__(NT)
    k4_kernel(const float* __restrict__ P, const float* __restrict__ A,
              const float* __restrict__ Bf, float* __restrict__ Pout, int D,
              int R) {
  extern __shared__ __align__(16) float sm[];
  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int i0 = i * TILE, j0 = j * TILE;
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  A += static_cast<size_t>(b) * D * R;
  Bf += static_cast<size_t>(b) * D * R;

  float* sPt = sm;                            // TILE x LD: tile (j, i) of P
  float* sAi = sPt + up4(TILE * LD);          // MC x LDT (transposed)
  float* sBi = sAi + MC * LDT;
  float* sAj = sBi + MC * LDT;                // TILE x LD
  float* sBj = sAj + up4(TILE * LD);

  stage(sPt, LD, P, D, j0, i0, TILE, TILE, D, D);
  float s1[RPT], s2[RPT];
  pair_sums(A, Bf, D, R, i0, j0, sAi, sBi, sAj, sBj, s1, s2);
  __syncthreads();
  const Tid t = tid();
  const int gj = j0 + t.tx;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int gi = i0 + t.r0 + q;
    if (gi < D && gj < D) {
      const float pij = P[static_cast<size_t>(gi) * D + gj];
      const float pji = sPt[t.tx * LD + t.r0 + q];
      Pout[static_cast<size_t>(gi) * D + gj] =
          0.5f * (pij + pji) + 0.5f * (s1[q] + s2[q]);
    }
  }
}

constexpr int NC = MAX_CG * TILE;             // K6 column chunk: 256

// K6 — replaces ekf_slam_tpu/ops/pallas_kernels.py f32_matmul_big
// (_mm_kernel): C = A·B in full f32 for a large A (M x K, the covariance
// P) and a narrow B (K x N): update_gain's P·Hᵀ (N = 2M = 128, or 2·CAP
// = 200 full width) and RANSAC's P·G (N = NHYP = 64).
// Bound on the H100: A is 1.5 MB per instance at D = 613, 192 MB at
// B = 128 (0.06 ms at 3.35 TB/s); the product is 2·D²·N flops, 96 MFLOP
// per instance at N = 128 (12 GFLOP per call, ≥ 0.18 ms at the f32 peak),
// so the FMA loop bounds it. The simple design: one block owns one
// (32-row stripe of A, instance) and loops over the contraction in
// 32-wide tiles, the stripe's output rows for up to 256 columns in
// registers (accumulate_pht), so each A tile is read once and every
// output row is written by its own block: no atomics. Wider N loops over
// 256-column chunks (A is then read once per chunk).
__global__ void __launch_bounds__(NT)
    k6_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
              float* __restrict__ C, int M, int K, int N) {
  extern __shared__ __align__(16) float sm[];
  const int i0 = blockIdx.x * TILE, b = blockIdx.y;
  A += static_cast<size_t>(b) * M * K;
  Bm += static_cast<size_t>(b) * K * N;
  C += static_cast<size_t>(b) * M * N;

  float* sAt = sm;                            // TILE x LDT: A tile, [k][row]
  float* sB = sAt + TILE * LDT;               // TILE x nc: B rows, [k][col]
  const Tid t = tid();
  for (int c0 = 0; c0 < N; c0 += NC) {
    const int nc = min(NC, N - c0);
    float acc[RPT][MAX_CG];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int cg = 0; cg < MAX_CG; ++cg) acc[q][cg] = 0.f;
    for (int k0 = 0; k0 < K; k0 += TILE) {
      stage(sAt, LDT, A, K, i0, k0, TILE, TILE, M, K, true);
      stage(sB, nc, Bm + c0, N, k0, 0, TILE, nc, K, nc);
      __syncthreads();
      accumulate_pht(acc, sAt, sB, nc, min(TILE, K - k0));
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int gi = i0 + t.r0 + q;
#pragma unroll
      for (int cg = 0; cg < MAX_CG; ++cg) {
        const int c = t.tx + TILE * cg;
        if (gi < M && c < nc)
          C[static_cast<size_t>(gi) * N + c0 + c] = acc[q][cg];
      }
    }
  }
}

}  // namespace

extern "C" {

// K4. P, Pout (B,D,D); A, B (B,D,R), any R >= 1. Contiguous row-major f32.
cudaError_t ekf_k4_corr_apply_cols(const float* P, const float* A,
                                   const float* B, float* Pout, int Bn, int D,
                                   int R, void* stream) {
  if (R < 1 || D < 1) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (3 * up4(TILE * LD) + 2 * MC * LDT);
  void* args[] = {&P, &A, &B, &Pout, &D, &R};
  const int nt = (D + TILE - 1) / TILE;
  return launch(reinterpret_cast<const void*>(k4_kernel), dim3(nt, nt, Bn),
                smem, args, static_cast<cudaStream_t>(stream));
}

// K6. A (B,M,K); B (B,K,N); C (B,M,N), any N >= 1. Contiguous row-major f32.
cudaError_t ekf_k6_matmul_big(const float* A, const float* B, float* C,
                              int Bn, int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (TILE * LDT + TILE * NC);
  void* args[] = {&A, &B, &C, &M, &K, &N};
  return launch(reinterpret_cast<const void*>(k6_kernel),
                dim3((M + TILE - 1) / TILE, Bn), smem, args,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
