// Fused covariance kernels of the SLAM step for Hopper (sm_90a): K1, K2, K3
// of the fused step, and K5, the unfused step's update tail, as a mode of
// K3.
//
// Each kernel is one streamed pass over the covariance P of every filter
// instance: P (B, D, D) row-major f32, D = 13 + 6·CAP (613 at CAP 100).
// A block owns a TILE x TILE output tile or a TILE-row stripe of tiles;
// the ragged edge (D is odd) is masked by index and nothing past D is read.
// Every contraction is summed in a fixed order with fmaf, so the result is
// deterministic and the (i,j) and (j,i) tiles of the symmetric downdate
// are float-exact mirrors. f32 on CUDA cores: no TF32, no tensor cores.
// Shared-memory bandwidth, not the FMA units, bounds this simple design
// (thread layout: common.cuh).
//
// Plain C ABI (bound with ctypes): each launcher returns the cudaError_t of
// its launch and launches on the caller's stream.

#include "common.cuh"

namespace {

// Symmetric downdate of tile (i0, j0): v = P − ½(K_i·PHt_jᵀ + PHt_i·K_jᵀ)
// over the 2M columns of K and PHt (D x M2), any M2 (pair_sums chunks it).
__device__ void downdate_tile(const float* P, const float* K,
                              const float* PHt, int D, int M2, int i0, int j0,
                              float* sKi, float* sPi, float* sKj, float* sPj,
                              float (&v)[RPT]) {
  const Tid t = tid();
  float a[RPT], b[RPT];
  pair_sums(K, PHt, D, M2, i0, j0, sKi, sPi, sKj, sPj, a, b);
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int gi = i0 + t.r0 + q, gj = j0 + t.tx;
    v[q] = (gi < D && gj < D)
               ? P[static_cast<size_t>(gi) * D + gj] - 0.5f * (a[q] + b[q])
               : 0.f;
  }
}

// rows 0:n of the smem tile <- J·rows (J n x n, row-major, ld 16).
__device__ void stripe_rows(float* sT, const float* sJ, int n) {
  const Tid t = tid();
  float nv[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = t.r0 + q;
    float s = 0.f;
    if (r < n)
      for (int k = 0; k < n; ++k) s = fmaf(sJ[r * 16 + k], sT[k * LD + t.tx], s);
    nv[q] = s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < RPT; ++q)
    if (t.r0 + q < n) sT[(t.r0 + q) * LD + t.tx] = nv[q];
  __syncthreads();
}

// cols 0:n of the smem tile <- cols·Jᵀ.
__device__ void stripe_cols(float* sT, const float* sJ, int n) {
  const Tid t = tid();
  float nv[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    float s = 0.f;
    if (t.tx < n)
      for (int k = 0; k < n; ++k)
        s = fmaf(sT[(t.r0 + q) * LD + k], sJ[t.tx * 16 + k], s);
    nv[q] = s;
  }
  __syncthreads();
  if (t.tx < n) {
#pragma unroll
    for (int q = 0; q < RPT; ++q) sT[(t.r0 + q) * LD + t.tx] = nv[q];
  }
  __syncthreads();
}

// sECt[l][rr] = Σ_k E_i[k][rr]·C[k][l]: the left factor E_iᵀC of the EᵀCE
// term for row block i, stored [l][row]. sE (r x TILE), sC (r x r).
__device__ void left_factor(float* sECt, const float* sE, const float* sC,
                            int r) {
  for (int idx = threadIdx.x; idx < TILE * r; idx += NT) {
    const int l = idx / TILE, rr = idx % TILE;
    float s = 0.f;
    for (int k = 0; k < r; ++k) s = fmaf(sE[k * TILE + rr], sC[k * r + l], s);
    sECt[l * TILE + rr] = s;
  }
}

// Masked tile plus the rank-r symmetric add of tile (i, j):
// keep_i keep_j ∘ v + (E_iᵀU_j + U_iᵀE_j) + (E_iᵀC)·E_j. Row-side
// operands sEi, sUi, sECt are [k][row], column-side sEj, sUj [k][col].
__device__ void keep_lowrank(float (&v)[RPT], const float* keep, int D,
                             int i0, int j0, const float* sEi,
                             const float* sUi, const float* sEj,
                             const float* sUj, const float* sECt, int r) {
  const Tid t = tid();
  const int gj = j0 + t.tx;
  float d1[RPT] = {0.f, 0.f, 0.f, 0.f};
  float d2[RPT] = {0.f, 0.f, 0.f, 0.f};
  float d3[RPT] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < r; ++k) {
    const float4 ei = ld4(sEi + k * TILE + t.r0);
    const float4 ui = ld4(sUi + k * TILE + t.r0);
    const float4 ci = ld4(sECt + k * TILE + t.r0);
    const float ej = sEj[k * TILE + t.tx];
    const float uj = sUj[k * TILE + t.tx];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      d1[q] = fmaf(at(ei, q), uj, d1[q]);
      d2[q] = fmaf(at(ui, q), ej, d2[q]);
      d3[q] = fmaf(at(ci, q), ej, d3[q]);
    }
  }
  const bool kj = gj < D && keep[gj] > 0.f;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int gi = i0 + t.r0 + q;
    if (gi >= D || gj >= D) {
      v[q] = 0.f;
      continue;
    }
    const float base = (kj && keep[gi] > 0.f) ? v[q] : 0.f;
    v[q] = base + (d1[q] + d2[q]) + d3[q];
  }
}

// Store the final tile to global memory and its transpose to sTt.
__device__ void store_tile(float* out, const float* sT, float* sTt, int D,
                           int i0, int j0) {
  const Tid t = tid();
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int gi = i0 + t.r0 + q, gj = j0 + t.tx;
    const float v = sT[(t.r0 + q) * LD + t.tx];
    if (gi < D && gj < D) out[static_cast<size_t>(gi) * D + gj] = v;
    if (sTt) sTt[t.tx * LDT + t.r0 + q] = v;
  }
}

__device__ void store_pht(float* PHt, const float (&acc)[RPT][MAX_CG], int D,
                          int R, int i0) {
  const Tid t = tid();
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int gi = i0 + t.r0 + q;
#pragma unroll
    for (int cg = 0; cg < MAX_CG; ++cg) {
      const int c = t.tx + TILE * cg;
      if (gi < D && c < R) PHt[static_cast<size_t>(gi) * R + c] = acc[q][cg];
    }
  }
}

__device__ void put_tile(float* sT, const float (&v)[RPT]) {
  const Tid t = tid();
#pragma unroll
  for (int q = 0; q < RPT; ++q) sT[(t.r0 + q) * LD + t.tx] = v[q];
}

// K1 — replaces ekf_slam_tpu/ops/pallas_kernels.py fused_manage_predict_pht
// (_k1_kernel): map management + EKF predict + prior gain columns,
//   P⁻ = Lp·(keep∘P + E6ᵀU6 + U6ᵀE6 + E6ᵀC66E6)·Lpᵀ + Q̃,  PHt = P⁻·Ht,
// Lp = diag(F13, I). Bound on the H100: one read and one write of P per
// instance (1.5 MB each at D = 613) plus the (D, 2·CAP) product, whose
// 2·D²·2CAP flops make this kernel compute-bound on CUDA cores. The Pallas
// grid carried PHt across its sequential j axis; here one block owns the
// TILE-row stripe i of one instance and loops over j itself, keeping the
// stripe's PHt rows in registers — deterministic, no atomics. Hopper
// blocks run in no order, so nothing crosses blocks.
__global__ void __launch_bounds__(NT)
    k1_kernel(const float* __restrict__ P, const float* __restrict__ keep,
              const float* __restrict__ E, const float* __restrict__ U,
              const float* __restrict__ C, const float* __restrict__ F16,
              const float* __restrict__ Q16, const float* __restrict__ Ht,
              float* __restrict__ Pout, float* __restrict__ PHt, int D, int R,
              int r) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, i = blockIdx.x, i0 = i * TILE;
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  keep += static_cast<size_t>(b) * D;
  E += static_cast<size_t>(b) * r * D;
  U += static_cast<size_t>(b) * r * D;
  C += static_cast<size_t>(b) * r * r;
  F16 += b * 256;
  Q16 += b * 256;
  Ht += static_cast<size_t>(b) * D * R;
  PHt += static_cast<size_t>(b) * D * R;

  float* sT = sm;                             // TILE x LD
  float* sTt = sT + up4(TILE * LD);           // TILE x LDT (transposed)
  float* sF = sTt + TILE * LDT;               // 16 x 16
  float* sQ = sF + 256;                       // 16 x 16
  float* sEi = sQ + 256;                      // r x TILE (x4)
  float* sUi = sEi + r * TILE;
  float* sEj = sUi + r * TILE;
  float* sUj = sEj + r * TILE;
  float* sECt = sUj + r * TILE;               // r x TILE
  float* sC = sECt + r * TILE;                // r x r
  float* sHt = sC + up4(r * r);               // TILE x R

  stage(sF, 16, F16, 16, 0, 0, 16, 16, 16, 16);
  stage(sQ, 16, Q16, 16, 0, 0, 16, 16, 16, 16);
  stage(sC, r, C, r, 0, 0, r, r, r, r);
  stage(sEi, TILE, E, D, 0, i0, r, TILE, r, D);
  stage(sUi, TILE, U, D, 0, i0, r, TILE, r, D);
  __syncthreads();
  left_factor(sECt, sEi, sC, r);

  float acc[RPT][MAX_CG];
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int cg = 0; cg < MAX_CG; ++cg) acc[q][cg] = 0.f;

  const Tid t = tid();
  const int nt = (D + TILE - 1) / TILE;
  for (int j = 0; j < nt; ++j) {
    const int j0 = j * TILE;
    stage(sEj, TILE, E, D, 0, j0, r, TILE, r, D);
    stage(sUj, TILE, U, D, 0, j0, r, TILE, r, D);
    stage(sHt, R, Ht, R, j0, 0, TILE, R, D, R);
    __syncthreads();
    float v[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int gi = i0 + t.r0 + q, gj = j0 + t.tx;
      v[q] = (gi < D && gj < D) ? P[static_cast<size_t>(gi) * D + gj] : 0.f;
    }
    keep_lowrank(v, keep, D, i0, j0, sEi, sUi, sEj, sUj, sECt, r);
    put_tile(sT, v);
    __syncthreads();
    if (i == 0) stripe_rows(sT, sF, 16);
    if (j == 0) stripe_cols(sT, sF, 16);
    if (i == 0 && j == 0) {
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int rr = t.r0 + q;
        if (rr < 16 && t.tx < 16) sT[rr * LD + t.tx] += sQ[rr * 16 + t.tx];
      }
    }
    store_tile(Pout, sT, sTt, D, i0, j0);
    __syncthreads();
    accumulate_pht(acc, sTt, sHt, R, min(TILE, D - j0));
    __syncthreads();
  }
  store_pht(PHt, acc, D, R, i0);
}

// K2 — replaces ekf_slam_tpu/ops/pallas_kernels.py fused_update_tail_pht
// (_tail_pht_kernel): the LI-update covariance tail and the posterior gain
// columns, P_li = T·sym(P − K·PHtᵀ)·Tᵀ (T = I ⊕ normJac(q) on dims 3:7,
// passed as J8 = I₈ with Jq4 at 3:7), PHt2 = P_li·Ht2. Bound on the H100:
// one read and one write of P per instance (1.5 MB each at D = 613) plus
// the 2M-deep downdate and the (D, 2·CAP) product, both compute on CUDA
// cores. Same stripe-per-block design as K1 for the P·Hᵀ reduction; the
// downdate reads K and PHt in 32-column chunks through shared memory.
__global__ void __launch_bounds__(NT)
    k2_kernel(const float* __restrict__ P, const float* __restrict__ K,
              const float* __restrict__ PHt, const float* __restrict__ J8,
              const float* __restrict__ Ht, float* __restrict__ Pout,
              float* __restrict__ PHt2, int D, int M2, int R) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, i = blockIdx.x, i0 = i * TILE;
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  K += static_cast<size_t>(b) * D * M2;
  PHt += static_cast<size_t>(b) * D * M2;
  J8 += b * 64;
  Ht += static_cast<size_t>(b) * D * R;
  PHt2 += static_cast<size_t>(b) * D * R;

  float* sT = sm;                             // TILE x LD
  float* sTt = sT + up4(TILE * LD);           // TILE x LDT
  float* sKi = sTt + TILE * LDT;              // MC x LDT (transposed)
  float* sPi = sKi + MC * LDT;
  float* sKj = sPi + MC * LDT;                // TILE x LD
  float* sPj = sKj + up4(TILE * LD);
  float* sJ = sPj + up4(TILE * LD);           // 8 x 8 at ld 16
  float* sHt = sJ + 128;                      // TILE x R

  stage(sJ, 16, J8, 8, 0, 0, 8, 8, 8, 8);

  float acc[RPT][MAX_CG];
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int cg = 0; cg < MAX_CG; ++cg) acc[q][cg] = 0.f;

  const int nt = (D + TILE - 1) / TILE;
  for (int j = 0; j < nt; ++j) {
    const int j0 = j * TILE;
    stage(sHt, R, Ht, R, j0, 0, TILE, R, D, R);
    float v[RPT];
    downdate_tile(P, K, PHt, D, M2, i0, j0, sKi, sPi, sKj, sPj, v);
    put_tile(sT, v);
    __syncthreads();
    if (i == 0) stripe_rows(sT, sJ, 8);
    if (j == 0) stripe_cols(sT, sJ, 8);
    store_tile(Pout, sT, sTt, D, i0, j0);
    __syncthreads();
    accumulate_pht(acc, sTt, sHt, R, min(TILE, D - j0));
    __syncthreads();
  }
  store_pht(PHt2, acc, D, R, i0);
}

// K3 — replaces ekf_slam_tpu/ops/pallas_kernels.py fused_update_tail_add
// (_tail_add_kernel): K2's tail, then the batched feature-init growth,
//   P' = keepN∘P⁺ + ENᵀUN + UNᵀEN + ENᵀ·CN·EN  (EN, UN (6K, D), CN (6K, 6K)).
// Bound on the H100: one read and one write of P per instance (1.5 MB each
// at D = 613) plus the 2M-deep downdate and the rank-6K add on CUDA cores.
// No cross-tile reduction: one block per output tile (j, i, b).
//
// With r = 0 this kernel is K5 — it replaces pallas_kernels.py
// fused_update_tail (_kernel): the update tail alone,
//   P⁺ = T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ,  T = I ⊕ Jq4 on dims 3:7,
// downdate, then the J8 rows in tile row 0, then the J8 columns in tile
// column 0 (the Pallas order). K5 is K3 without the feature add, so it
// runs as a mode of K3 rather than as a copy of its tail: one code path
// for the tail of both steps. Bound on the H100: one read and one write
// of P per instance (1.5 MB each at D = 613; 192 MB each way at B = 128)
// and 2·D(D+1)·M2 flops of downdate for its symmetric output (96 MFLOP
// per instance at 2M = 128; this kernel sums both triangles, twice that)
// on CUDA cores; the design reads each P entry once and keeps the K / PHt
// chunks in shared memory, so the FMA loop over shared memory bounds it.
__global__ void __launch_bounds__(NT)
    k3_kernel(const float* __restrict__ P, const float* __restrict__ K,
              const float* __restrict__ PHt, const float* __restrict__ J8,
              const float* __restrict__ keep, const float* __restrict__ E,
              const float* __restrict__ U, const float* __restrict__ C,
              float* __restrict__ Pout, int D, int M2, int r) {
  extern __shared__ __align__(16) float sm[];
  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int i0 = i * TILE, j0 = j * TILE;
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  K += static_cast<size_t>(b) * D * M2;
  PHt += static_cast<size_t>(b) * D * M2;
  J8 += b * 64;
  if (r > 0) {                                // K5 passes no add operands
    keep += static_cast<size_t>(b) * D;
    E += static_cast<size_t>(b) * r * D;
    U += static_cast<size_t>(b) * r * D;
    C += static_cast<size_t>(b) * r * r;
  }

  float* sT = sm;                             // TILE x LD
  float* sKi = sT + up4(TILE * LD);           // MC x LDT (transposed)
  float* sPi = sKi + MC * LDT;
  float* sKj = sPi + MC * LDT;                // TILE x LD
  float* sPj = sKj + up4(TILE * LD);
  float* sJ = sPj + up4(TILE * LD);           // 8 x 8 at ld 16
  float* sEi = sJ + 128;                      // r x TILE (x4)
  float* sUi = sEi + r * TILE;
  float* sEj = sUi + r * TILE;
  float* sUj = sEj + r * TILE;
  float* sECt = sUj + r * TILE;               // r x TILE
  float* sC = sECt + r * TILE;                // r x r

  stage(sJ, 16, J8, 8, 0, 0, 8, 8, 8, 8);
  stage(sC, r, C, r, 0, 0, r, r, r, r);
  stage(sEi, TILE, E, D, 0, i0, r, TILE, r, D);
  stage(sUi, TILE, U, D, 0, i0, r, TILE, r, D);
  stage(sEj, TILE, E, D, 0, j0, r, TILE, r, D);
  stage(sUj, TILE, U, D, 0, j0, r, TILE, r, D);
  __syncthreads();
  left_factor(sECt, sEi, sC, r);

  float v[RPT];
  downdate_tile(P, K, PHt, D, M2, i0, j0, sKi, sPi, sKj, sPj, v);
  put_tile(sT, v);
  __syncthreads();
  if (i == 0) stripe_rows(sT, sJ, 8);
  if (j == 0) stripe_cols(sT, sJ, 8);
  const Tid t = tid();
#pragma unroll
  for (int q = 0; q < RPT; ++q) v[q] = sT[(t.r0 + q) * LD + t.tx];
  if (r > 0) {
    keep_lowrank(v, keep, D, i0, j0, sEi, sUi, sEj, sUj, sECt, r);
    put_tile(sT, v);
  }
  store_tile(Pout, sT, nullptr, D, i0, j0);
}

}  // namespace

extern "C" {

// All matrices are contiguous row-major f32 with a leading instance axis B:
// P, Pout (B,D,D); keep (B,D); E, U (B,r,D); C (B,r,r); F16, Q16 (B,16,16);
// Ht (B,D,R); PHt (B,D,R). Requires R <= 256.
cudaError_t ekf_k1_manage_predict_pht(const float* P, const float* keep,
                                      const float* E, const float* U,
                                      const float* C, const float* F16,
                                      const float* Q16, const float* Ht,
                                      float* Pout, float* PHt, int B, int D,
                                      int R, int r, void* stream) {
  if (R > MAX_CG * TILE || r < 1) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (up4(TILE * LD) + TILE * LDT + 512 + 5 * r * TILE +
                       up4(r * r) + TILE * R);
  void* args[] = {&P, &keep, &E, &U, &C, &F16, &Q16, &Ht, &Pout, &PHt,
                  &D, &R, &r};
  const int nt = (D + TILE - 1) / TILE;
  return launch(reinterpret_cast<const void*>(k1_kernel), dim3(nt, B), smem,
                args, static_cast<cudaStream_t>(stream));
}

// P, Pout (B,D,D); K, PHt (B,D,M2); J8 (B,8,8); Ht (B,D,R); PHt2 (B,D,R).
// Requires R <= 256.
cudaError_t ekf_k2_update_tail_pht(const float* P, const float* K,
                                   const float* PHt, const float* J8,
                                   const float* Ht, float* Pout, float* PHt2,
                                   int B, int D, int M2, int R, void* stream) {
  if (R > MAX_CG * TILE) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (3 * up4(TILE * LD) + TILE * LDT + 2 * MC * LDT + 128 +
                       TILE * R);
  void* args[] = {&P, &K, &PHt, &J8, &Ht, &Pout, &PHt2, &D, &M2, &R};
  const int nt = (D + TILE - 1) / TILE;
  return launch(reinterpret_cast<const void*>(k2_kernel), dim3(nt, B), smem,
                args, static_cast<cudaStream_t>(stream));
}

// P, Pout (B,D,D); K, PHt (B,D,M2); J8 (B,8,8); keep (B,D); E, U (B,r,D);
// C (B,r,r). Requires 1 <= r <= 128, the rank the Pallas kernel takes.
cudaError_t ekf_k3_update_tail_add(const float* P, const float* K,
                                   const float* PHt, const float* J8,
                                   const float* keep, const float* E,
                                   const float* U, const float* C,
                                   float* Pout, int B, int D, int M2, int r,
                                   void* stream) {
  if (r < 1 || r > 128) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (3 * up4(TILE * LD) + 2 * MC * LDT + 128 +
                       5 * r * TILE + r * r);
  void* args[] = {&P, &K, &PHt, &J8, &keep, &E, &U, &C, &Pout, &D, &M2, &r};
  const int nt = (D + TILE - 1) / TILE;
  return launch(reinterpret_cast<const void*>(k3_kernel), dim3(nt, nt, B),
                smem, args, static_cast<cudaStream_t>(stream));
}

// K5, the update tail alone: k3_kernel with r = 0. P, Pout (B,D,D);
// K, PHt (B,D,M2), any M2 >= 1; J8 (B,8,8).
cudaError_t ekf_k5_update_tail(const float* P, const float* K,
                               const float* PHt, const float* J8, float* Pout,
                               int B, int D, int M2, void* stream) {
  if (M2 < 1) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (3 * up4(TILE * LD) + 2 * MC * LDT + 128);
  const float* none = nullptr;
  int r = 0;
  void* args[] = {&P, &K, &PHt, &J8, &none, &none, &none, &none, &Pout,
                  &D, &M2, &r};
  const int nt = (D + TILE - 1) / TILE;
  return launch(reinterpret_cast<const void*>(k3_kernel), dim3(nt, nt, B),
                smem, args, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
