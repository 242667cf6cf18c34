// Fused covariance kernels of the SLAM step for Hopper (sm_90a): K1, K2, K3
// of the fused step, and K5, the unfused step's update tail, as a mode of
// K3.
//
// Each kernel is one streamed pass over the covariance P of every filter
// instance: P (B, D, D) row-major f32, D = 13 + 6·CAP (613 at CAP 100); the
// ragged edge (D is odd) is masked by index and nothing past D is read.
// Every contraction is summed in a fixed order with fmaf, so the result is
// deterministic. f32 on CUDA cores: no TF32, no tensor cores, no atomics.
// K1 and K2 own a 32-row stripe of tiles a block and stand on common.cuh's
// 32 x 32 tile helpers, which shared-memory bandwidth, not the FMA units,
// bounds. K3 / K5 own a pair of 64 x 64 tiles a block and stand on its
// register-blocked panel product and mirrored epilogue.
//
// Plain C ABI (bound with ctypes): each launcher returns the cudaError_t of
// its launch(es) and launches on the caller's stream.

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
    sTt[t.tx * LDT + t.r0 + q] = v;
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
//   P' = keepN∘(T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ) + ENᵀUN + UNᵀEN + ENᵀ·CN·EN
// (K, PHt (D, M2); T = I ⊕ Jq4 on dims 3:7, passed as J8 = I₈ with Jq4 at
// 3:7; EN, UN (r, D), CN (r, r), r = 6K <= 128).
// With r = 0 this kernel is K5 — it replaces pallas_kernels.py
// fused_update_tail (_kernel): the update tail alone,
//   P⁺ = T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ,
// K3 without the keep mask and the add: one code path for the tail of both
// steps.
// Bound on the H100 (B = 128, D = 613): the symmetric output needs 4·M2
// flops an entry of one triangle for the downdate (12.3 GFLOP a call at
// M2 = 128: 0.18 ms at 67 TFLOP/s) and, in K3, 6·r more for the add (plus
// r·r·D for CN·EN; 21.6 GFLOP in all at r = 60); P read and written once
// is 385 MB (0.11 ms at 3.35 TB/s), so the FMA units bind.
// Design, per tile pair (i, j), i <= j, of 64 x 64 tiles (55 blocks of 64
// threads an instance at D = 613), the two tiles of P fetched by bulk
// copies under the first product (PTile):
//  (a) downdate: S1 = [K | PHt]_i · [PHt | K]_jᵀ, one chain over 2·M2
//      (panel_product, column-form factors staged [k][row] by a
//      two-source ColPanel), then in place in P's tiles in shared memory
//      t(i, j) = P(i, j) − ½·S1 and t(j, i) = P(j, i) − ½·S1ᵀ, each entry
//      from its own entry of P, as the Pallas kernel reads it (P enters
//      symmetric there, which the mirror does not need); a diagonal tile
//      takes S1's lower entries from its upper ones;
//  (b) on the pairs of tile row 0, the renorm stripe: rows 0:8 of tile
//      (0, j) <- J8·rows, columns 0:8 of tile (j, 0) <- columns·J8ᵀ — the
//      same products in the same order, so the two stay mirrors; on
//      (0, 0) rows, then columns (the Pallas order), then the 8 x 8
//      corner's lower entries from its upper ones, since rows-then-columns
//      rounds J8·t·J8ᵀ asymmetrically (the rest of the tile mirrors as the
//      twin pairs do; with an asymmetric P the corner's lower entries are
//      the only ones that differ from the reference's);
//  (c) K3 only: the keep mask, then the rank-2r add S2 = X2ᵀY2 with
//      X2 = [EN; V], Y2 = [V; EN] (row form, RowPanel as in K8) and
//      V = UN + ½·CN·EN, formed by k3v_kernel first: ENᵀV + VᵀEN is
//      ENᵀUN + UNᵀEN + ENᵀ·sym(CN)·EN, the reference's add for a symmetric
//      CN. mapman.add_params builds CN as dy·P11·dyᵀ + noise by an einsum,
//      which does not sum entry (k, l) and entry (l, k) in the same order:
//      CN is symmetric to its last bits, not bitwise. The kernel adds the
//      symmetric part of CN, so its output stays bitwise symmetric; the
//      antisymmetric part it leaves out is rounding of CN's entries
//      (tests/test_torch_kernel_schedules.py states its size);
//  (d) the mirrored store of both tiles (store_tile_pair): out(i, j) =
//      t(i, j) + S2, out(j, i) = t(j, i) + S2ᵀ, coalesced.
// With these rules the output is bitwise symmetric wherever P is.
using G3 = Blocking<PT_TILE, PT_TILE, 8, 8>;
using Col3 = ColPanel<float, PT_TILE, G3::THREADS, 2>;
using Row3 = RowPanel<PT_TILE, G3::THREADS>;
static_assert(G3::THREADS == PT_TILE, "the tile passes: a thread a column");

constexpr int V_THREADS = 256;
constexpr int V_KB = 8;                       // rows of V a thread's pass

// Shared memory of k3v_kernel: EN's 64 columns (rp x 64) and CN (a
// multiple of V_KB rows x rp), rp = r rounded up to 4, padded with zeros.
__host__ __device__ constexpr int k3v_floats(int r) {
  return up4(r) * PT_TILE + (r + V_KB - 1) / V_KB * V_KB * up4(r);
}

// V = UN + ½·CN·EN (r, D) of each instance, the prologue of K3's add
// (0.56 GFLOP a call at r = 60, B = 128). A block takes 64 columns of one
// instance: EN's columns and CN staged in shared memory, padded with
// zeros; thread (c, k mod 4) keeps column c and V_KB rows of V a pass, so
// a 16-byte broadcast of CN's row feeds four FMAs and a load of EN eight.
// Each V[k][c] is one fmaf chain over l in order.
__global__ void __launch_bounds__(V_THREADS)
    k3v_kernel(const float* __restrict__ E, const float* __restrict__ U,
               const float* __restrict__ C, float* __restrict__ V, int D,
               int r) {
  extern __shared__ __align__(16) float sm[];
  const int c0 = blockIdx.x * PT_TILE, b = blockIdx.y, rp = up4(r);
  const int rows = (r + V_KB - 1) / V_KB * V_KB;
  const size_t off = static_cast<size_t>(b) * r * D;
  E += off;
  U += off;
  V += off;
  C += static_cast<size_t>(b) * r * r;
  float* sE = sm;                             // rp x PT_TILE
  float* sCN = sm + rp * PT_TILE;             // rows x rp
  for (int idx = threadIdx.x; idx < rp * PT_TILE; idx += V_THREADS) {
    const int l = idx / PT_TILE, c = c0 + idx % PT_TILE;
    sE[idx] = l < r && c < D ? E[static_cast<size_t>(l) * D + c] : 0.f;
  }
  for (int idx = threadIdx.x; idx < rows * rp; idx += V_THREADS) {
    const int k = idx / rp, l = idx % rp;
    sCN[idx] = k < r && l < r ? C[k * r + l] : 0.f;
  }
  __syncthreads();
  const int c = static_cast<int>(threadIdx.x) % PT_TILE;
  if (c0 + c >= D) return;
  for (int k0 = static_cast<int>(threadIdx.x) / PT_TILE * V_KB; k0 < r;
       k0 += V_KB * (V_THREADS / PT_TILE)) {
    float s[V_KB];
#pragma unroll
    for (int kk = 0; kk < V_KB; ++kk) s[kk] = 0.f;
    for (int l = 0; l < rp; l += 4) {
      const float e0 = sE[l * PT_TILE + c], e1 = sE[(l + 1) * PT_TILE + c],
                  e2 = sE[(l + 2) * PT_TILE + c], e3 = sE[(l + 3) * PT_TILE + c];
#pragma unroll
      for (int kk = 0; kk < V_KB; ++kk) {
        const float4 cn = ld4(sCN + (k0 + kk) * rp + l);
        s[kk] = fmaf(cn.x, e0, s[kk]);
        s[kk] = fmaf(cn.y, e1, s[kk]);
        s[kk] = fmaf(cn.z, e2, s[kk]);
        s[kk] = fmaf(cn.w, e3, s[kk]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < V_KB; ++kk)
      if (k0 + kk < r) {
        const size_t at = static_cast<size_t>(k0 + kk) * D + c0 + c;
        V[at] = U[at] + 0.5f * s[kk];
      }
  }
}

// (a) t = P − ½·S in place in P's tiles: tile (i0, j0) from S, its twin
// (j0, i0) from Sᵀ; without a twin (a diagonal tile) S[min(r,c)][max(r,c)].
__device__ void downdate_pair(const PTile<float>& tij,
                              const PTile<float>& tji, const float* sC,
                              bool twin) {
  const int c = threadIdx.x;
  for (int a = 0; a < PT_TILE; ++a)
    tij.ref(a, c) -= 0.5f * sC[!twin && a > c ? c * LDC + a : a * LDC + c];
  if (twin)
    for (int a = 0; a < PT_TILE; ++a) tji.ref(a, c) -= 0.5f * sC[c * LDC + a];
}

// (b) the renorm stripe of a pair of tile row 0 (sJ: J8 row-major). A
// thread keeps column t of tile (0, j0) and row t of tile (j0, 0).
__device__ void renorm_stripe(const PTile<float>& tij,
                              const PTile<float>& tji, const float* sJ,
                              bool twin) {
  const int t = threadIdx.x;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = tij.at(k, t);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s = fmaf(sJ[r * 8 + k], v[k], s);
    tij.ref(r, t) = s;
  }
  if (!twin) __syncthreads();            // (0, 0): rows, then columns
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = tji.at(t, k);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s = fmaf(v[k], sJ[c * 8 + k], s);
    tji.ref(t, c) = s;
  }
  if (!twin) {
    __syncthreads();
    if (t < 8)
      for (int a = t + 1; a < 8; ++a) tij.ref(a, t) = tij.ref(t, a);
  }
  __syncthreads();
}

// (c) keep_i keep_j ∘ t on both tiles.
__device__ void keep_pair(const PTile<float>& tij, const PTile<float>& tji,
                          const float* keep, int D, int i0, int j0,
                          bool twin) {
  const int c = threadIdx.x;
  const bool kj = j0 + c < D && keep[j0 + c] > 0.f;
  const bool ki = i0 + c < D && keep[i0 + c] > 0.f;
  for (int a = 0; a < PT_TILE; ++a) {
    if (!(kj && i0 + a < D && keep[i0 + a] > 0.f)) tij.ref(a, c) = 0.f;
    if (twin && !(ki && j0 + a < D && keep[j0 + a] > 0.f))
      tji.ref(a, c) = 0.f;
  }
}

__device__ __forceinline__ void put_acc(float* sC,
                                        const float (&acc)[G3::TM][G3::TN]) {
#pragma unroll
  for (int q = 0; q < G3::TM; ++q)
#pragma unroll
    for (int p = 0; p < G3::TN; ++p)
      sC[G3::row(q) * LDC + G3::col(p)] = acc[q][p];
}

constexpr size_t k3_smem() {
  static_assert(ring_floats<Col3, Col3>() <= PT_TILE * LDC &&
                    ring_floats<Row3, Row3>() <= PT_TILE * LDC,
                "the accumulator tile lies over the ring");
  return sizeof(float) * (up4(PT_TILE * LDC) + 64) +
         2 * PTile<float>::BYTES + sizeof(unsigned long long);
}

__global__ void __launch_bounds__(G3::THREADS, G3::MIN_BLOCKS)
    k3_kernel(const float* __restrict__ P, const float* __restrict__ K,
              const float* __restrict__ PHt, const float* __restrict__ J8,
              const float* __restrict__ keep, const float* __restrict__ E,
              const float* __restrict__ V, float* __restrict__ Pout, int D,
              int M2, int r) {
  extern __shared__ __align__(16) float sm[];
  const int nt = (D + PT_TILE - 1) / PT_TILE, b = blockIdx.y;
  int i, j;
  pair_of(blockIdx.x, nt, i, j);
  const int i0 = i * PT_TILE, j0 = j * PT_TILE;
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  K += static_cast<size_t>(b) * D * M2;
  PHt += static_cast<size_t>(b) * D * M2;
  J8 += b * 64;
  if (r > 0) {                                // K5 passes no add operands
    keep += static_cast<size_t>(b) * D;
    E += static_cast<size_t>(b) * r * D;
    V += static_cast<size_t>(b) * r * D;
  }

  float* sC = sm;                             // PT_TILE x LDC, over the ring
  float* sJ = sm + up4(PT_TILE * LDC);        // 8 x 8
  char* raw_ij = reinterpret_cast<char*>(sJ + 64);
  char* raw_ji = raw_ij + PTile<float>::BYTES;
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(raw_ji + PTile<float>::BYTES);
  const bool twin = i0 != j0;
  if (threadIdx.x == 0) mbar_init(mbar, G3::THREADS);
  sJ[threadIdx.x] = J8[threadIdx.x];
  __syncthreads();
  unsigned bytes = PTile<float>::fetch<G3::THREADS>(raw_ij, P, D, i0, j0,
                                                     mbar);
  if (twin)
    bytes += PTile<float>::fetch<G3::THREADS>(raw_ji, P, D, j0, i0, mbar);
  mbar_arrive_expect(mbar, bytes);
  const PTile<float> tij(raw_ij, P, D, i0, j0);
  const PTile<float> tji(twin ? raw_ji : raw_ij, P, D, j0, i0);

  float acc[G3::TM][G3::TN];
  const int tiles = (M2 + BK - 1) / BK;       // of one factor's M2 columns
  Col3 lx(K, PHt, tiles, M2, i0, D, M2), ly(PHt, K, tiles, M2, j0, D, M2);
  panel_product<G3>(acc, sm, 2 * tiles, lx, ly);
  put_acc(sC, acc);
  mbar_wait(mbar);
  __syncthreads();
  downdate_pair(tij, tji, sC, twin);
  __syncthreads();
  if (i == 0) renorm_stripe(tij, tji, sJ, twin);
  if (r > 0) {
    keep_pair(tij, tji, keep, D, i0, j0, twin);
    const int tiles2 = (r + BK - 1) / BK;     // of one factor's r rows
    Row3 ex(E, V, tiles2, r, D, i0, D), ey(V, E, tiles2, r, D, j0, D);
    panel_product<G3>(acc, sm, 2 * tiles2, ex, ey);
  } else {
#pragma unroll
    for (int q = 0; q < G3::TM; ++q)
#pragma unroll
      for (int p = 0; p < G3::TN; ++p) acc[q][p] = 0.f;
  }
  put_acc(sC, acc);
  __syncthreads();
  store_tile_pair<float, G3::THREADS>(Pout, D, i0, j0, sC, tij, tji, 1.f,
                                      true, false);
}

cudaError_t k3_launch(const float* P, const float* K, const float* PHt,
                      const float* J8, const float* keep, const float* E,
                      const float* V, float* Pout, int B, int D, int M2,
                      int r, cudaStream_t stream) {
  void* args[] = {&P, &K, &PHt, &J8, &keep, &E, &V, &Pout, &D, &M2, &r};
  const int nt = (D + PT_TILE - 1) / PT_TILE;
  return launch(reinterpret_cast<const void*>(k3_kernel),
                dim3(nt * (nt + 1) / 2, B), k3_smem(), args, stream,
                G3::THREADS);
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

// P, Pout (B,D,D); K, PHt (B,D,M2), any M2 >= 1; J8 (B,8,8); keep (B,D);
// E, U (B,r,D); C (B,r,r); V (B,r,D), the caller's scratch for
// V = U + ½·C·E. Requires 1 <= r <= 128, the rank the Pallas kernel takes,
// and D >= 8, the renorm stripe's rows. Two launches: k3v_kernel, then
// k3_kernel.
cudaError_t ekf_k3_update_tail_add(const float* P, const float* K,
                                   const float* PHt, const float* J8,
                                   const float* keep, const float* E,
                                   const float* U, const float* C, float* V,
                                   float* Pout, int B, int D, int M2, int r,
                                   void* stream) {
  if (r < 1 || r > 128 || M2 < 1 || D < 8 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&E, &U, &C, &V, &D, &r};
  const cudaError_t err = launch(
      reinterpret_cast<const void*>(k3v_kernel),
      dim3((D + PT_TILE - 1) / PT_TILE, B), sizeof(float) * k3v_floats(r),
      args, s, V_THREADS);
  if (err != cudaSuccess) return err;
  return k3_launch(P, K, PHt, J8, keep, E, V, Pout, B, D, M2, r, s);
}

// K5, the update tail alone: k3_kernel with r = 0. P, Pout (B,D,D);
// K, PHt (B,D,M2), any M2 >= 1; J8 (B,8,8); D >= 8.
cudaError_t ekf_k5_update_tail(const float* P, const float* K,
                               const float* PHt, const float* J8, float* Pout,
                               int B, int D, int M2, void* stream) {
  if (M2 < 1 || D < 8 || B > 65535) return cudaErrorInvalidValue;
  return k3_launch(P, K, PHt, J8, nullptr, nullptr, nullptr, Pout, B, D, M2,
                   0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
