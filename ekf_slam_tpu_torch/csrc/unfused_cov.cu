// Covariance kernels of the unfused SLAM step for Hopper (sm_90a): K4, the
// folded update tail's apply for column factors, K8, the same apply for the
// row-form update's row factors, and K6, the dense products on P. (K5, the
// update tail of the pallas_update route, is a mode of K3 in fused_cov.cu.)
//
// P (B, D, D) row-major, D = 13 + 6·CAP (613 at CAP 100); the ragged edge (D
// is odd) is masked by index and nothing past D is read. P is stored in f32
// or in bf16 (FilterConfig.p_storage, the fast mode): each kernel is
// instantiated for both, reads P in its storage type and upcasts, and K4 /
// K8 round their output once to P's type. Every other operand and every
// sum is f32: a sequential fmaf chain in a fixed order, deterministic, no
// atomics, on CUDA cores: no TF32, no tensor cores, no TMA. Thread layout
// and helpers: common.cuh.
//
// Plain C ABI (bound with ctypes): each launcher returns the cudaError_t of
// its launch and launches on the caller's stream; `p_bf16` picks the
// instantiation for a bf16 P.

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
// above the memory time (a bf16 P halves the bytes). The simple design:
// one block per output tile (j, i, b), R looped in MC-wide chunks staged
// through shared memory (any R), the twin tile staged once for a coalesced
// read. It computes both triangles, twice the flops; halving the sums by
// mirroring is a later step.
template <typename PT>
__global__ void __launch_bounds__(NT)
    k4_kernel(const PT* __restrict__ P, const float* __restrict__ A,
              const float* __restrict__ Bf, PT* __restrict__ Pout, int D,
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
      const float pij = to_f32(P[static_cast<size_t>(gi) * D + gj]);
      const float pji = sPt[t.tx * LD + t.r0 + q];
      store(Pout + static_cast<size_t>(gi) * D + gj,
            0.5f * (pij + pji) + 0.5f * (s1[q] + s2[q]));
    }
  }
}

// K8 — replaces ekf_slam_tpu/ops/pallas_kernels.py corr_apply
// (_corr_kernel, _corr_expr_kernel, _corr_sym_kernel): the row-form
// update's folded tail apply (ekf.update_rows), At, Bt (R, D) the factors
// of the rank-R correction AtᵀBt (R = 2M + 8 rows: 56 at the fast mode's
// M = 24). Per entry, with s1 = Σ_k At[k][r]·Bt[k][c]
// and s2 = Σ_k Bt[k][r]·At[k][c] (pair_sums_rows):
//   mode 0 "none"  P[r][c] + s1
//   mode 1 "expr"  P[r][c] + 0.5f·(s1 + s2)          (the default)
//   mode 2 "full"  0.5f·(P[r][c] + P[c][r]) + 0.5f·(s1 + s2)
// s1 of (r, c) is s2 of (c, r), so the correction is bitwise symmetric
// ("expr" keeps P's own asymmetry, "full" none), as the Pallas kernel's
// mirrored _corr_dot makes it. P is read in its storage type, the sum
// rounded once to it.
// Bound on the H100 at the fast mode (B = 128, D = 613, R = 56, bf16 P):
// the symmetric correction needs 4·R flops an entry over D(D+1)/2 entries,
// 5.4 GFLOP a call (0.081 ms at 67 TFLOP/s); P read and written in bf16
// plus the factors is 227 MB (0.068 ms), so the operations bind. The simple
// design is K4's: one block per output tile (j, i, b), R looped in MC-wide
// chunks, the transposed twin tile staged only in mode 2; both triangles
// computed, twice the bound's flops.
template <typename PT>
__global__ void __launch_bounds__(NT)
    k8_kernel(const PT* __restrict__ P, const float* __restrict__ At,
              const float* __restrict__ Bt, PT* __restrict__ Pout, int D,
              int R, int mode) {
  extern __shared__ __align__(16) float sm[];
  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int i0 = i * TILE, j0 = j * TILE;
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  At += static_cast<size_t>(b) * R * D;
  Bt += static_cast<size_t>(b) * R * D;

  float* sPt = sm;                            // TILE x LD: tile (j, i) of P
  float* sAi = sPt + up4(TILE * LD);          // four MC x LDT: [k][row/col]
  float* sBi = sAi + MC * LDT;
  float* sAj = sBi + MC * LDT;
  float* sBj = sAj + MC * LDT;

  if (mode == 2) stage(sPt, LD, P, D, j0, i0, TILE, TILE, D, D);
  float s1[RPT], s2[RPT];
  pair_sums_rows(At, Bt, D, R, i0, j0, sAi, sBi, sAj, sBj, s1, s2);
  __syncthreads();
  const Tid t = tid();
  const int gj = j0 + t.tx;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int gi = i0 + t.r0 + q;
    if (gi < D && gj < D) {
      const float pij = to_f32(P[static_cast<size_t>(gi) * D + gj]);
      float v;
      if (mode == 0)
        v = pij + s1[q];
      else if (mode == 1)
        v = pij + 0.5f * (s1[q] + s2[q]);
      else
        v = 0.5f * (pij + sPt[t.tx * LD + t.r0 + q]) + 0.5f * (s1[q] + s2[q]);
      store(Pout + static_cast<size_t>(gi) * D + gj, v);
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
template <typename AT>
__global__ void __launch_bounds__(NT)
    k6_kernel(const AT* __restrict__ A, const float* __restrict__ Bm,
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

// K4. P, Pout (B,D,D), f32 or (p_bf16) bf16; A, B (B,D,R) f32, any R >= 1.
// Contiguous row-major.
cudaError_t ekf_k4_corr_apply_cols(const void* P, const float* A,
                                   const float* B, void* Pout, int Bn, int D,
                                   int R, int p_bf16, void* stream) {
  if (R < 1 || D < 1) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (3 * up4(TILE * LD) + 2 * MC * LDT);
  void* args[] = {&P, &A, &B, &Pout, &D, &R};
  const int nt = (D + TILE - 1) / TILE;
  const void* fn = p_bf16
      ? reinterpret_cast<const void*>(k4_kernel<__nv_bfloat16>)
      : reinterpret_cast<const void*>(k4_kernel<float>);
  return launch(fn, dim3(nt, nt, Bn), smem, args,
                static_cast<cudaStream_t>(stream));
}

// K6. A (B,M,K), f32 or (a_bf16) bf16; B (B,K,N) and C (B,M,N) f32, any
// N >= 1. Contiguous row-major.
cudaError_t ekf_k6_matmul_big(const void* A, const float* B, float* C,
                              int Bn, int M, int K, int N, int a_bf16,
                              void* stream) {
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (TILE * LDT + TILE * NC);
  void* args[] = {&A, &B, &C, &M, &K, &N};
  const void* fn = a_bf16
      ? reinterpret_cast<const void*>(k6_kernel<__nv_bfloat16>)
      : reinterpret_cast<const void*>(k6_kernel<float>);
  return launch(fn, dim3((M + TILE - 1) / TILE, Bn), smem, args,
                static_cast<cudaStream_t>(stream));
}

// K8. P, Pout (B,D,D), f32 or (p_bf16) bf16; At, Bt (B,R,D) f32, any
// R >= 1; mode 0 none, 1 expr, 2 full. Contiguous row-major.
cudaError_t ekf_k8_corr_apply(const void* P, const float* At,
                              const float* Bt, void* Pout, int Bn, int D,
                              int R, int mode, int p_bf16, void* stream) {
  if (R < 1 || D < 1 || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (up4(TILE * LD) + 4 * MC * LDT);
  void* args[] = {&P, &At, &Bt, &Pout, &D, &R, &mode};
  const int nt = (D + TILE - 1) / TILE;
  const void* fn = p_bf16
      ? reinterpret_cast<const void*>(k8_kernel<__nv_bfloat16>)
      : reinterpret_cast<const void*>(k8_kernel<float>);
  return launch(fn, dim3(nt, nt, Bn), smem, args,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
