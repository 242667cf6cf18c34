// Fused covariance kernels of the SLAM step for Hopper (sm_90a): K1, K2 and
// K3 of the fused step, and K5, the unfused step's update tail, as a mode of
// K3.
//
// Each is a pass over the 64 x 64 tile pairs (i, j), i <= j, of the
// covariance P of every filter instance — P (B, D, D) row-major f32,
// D = 13 + 6·CAP (613 at CAP 100: 55 pairs an instance) — one block of 64
// threads a pair: P's two tiles are fetched by bulk copies under a
// register-blocked panel product (common.cuh), transformed in place in
// shared memory, and written to both triangles by the mirrored epilogue,
// each pair computed once. K1 and K2 then form P_new·Ht with K6's panel
// product (unfused_cov.cu), which reads the P just written. The ragged edge
// (D is odd) is masked by index and nothing past D is read. Every sum is an
// fmaf chain in a fixed order: f32 on CUDA cores, deterministic, no TF32,
// no tensor cores, no atomics.
//
// Plain C ABI (bound with ctypes): each launcher launches on the caller's
// stream and returns the first cudaError_t of its launches that is not
// cudaSuccess.

#include "common.cuh"

namespace {

// K3 — replaces ekf_slam_tpu/ops/pallas_kernels.py fused_update_tail_add
// (_tail_add_kernel): K2's tail, then the batched feature-init growth,
//   P' = keepN∘(T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ) + ENᵀUN + UNᵀEN + ENᵀ·CN·EN
// (K, PHt (D, M2); T = I ⊕ Jq4 on dims 3:7, passed as J8 = I₈ with Jq4 at
// 3:7; EN, UN (r, D), CN (r, r), r = 6K <= 128).
// With r = 0 this kernel is K5 — it replaces pallas_kernels.py
// fused_update_tail (_kernel): the update tail alone,
//   P⁺ = T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ,
// K3 without the keep mask and the add: one code path for the tail of both
// steps, and the first launch of K2.
// Bound on the H100 (B = 128, D = 613): the symmetric output needs 4·M2
// flops an entry of one triangle for the downdate (12.3 GFLOP a call at
// M2 = 128: 0.18 ms at 67 TFLOP/s) and, in K3, 4·r more for the add as
// [EN; V]ᵀ[V; EN] (plus 2·r·r·D for V; 18.7 GFLOP in all at r = 60, 0.28
// ms); P read and written once
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
// A tile-pair block's shared memory (~52 KB) allows four blocks an SM, so
// k3_kernel and k1p_kernel take the registers four allow (255): K3 and K5
// run 2% faster than with G3's 128 (kernel_variants fused_pair_regs_128).
constexpr int PAIR_BLOCKS = 4;
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
// (0.56 GFLOP a call at r = 60, B = 128) and of K1's (r = 6). A block takes
// 64 columns of one instance: EN's columns and CN staged in shared memory,
// padded with zeros; thread (c, k mod 4) keeps column c and V_KB rows of V
// a pass, so a 16-byte broadcast of CN's row feeds four FMAs and a load of
// EN eight. Each V[k][c] is one fmaf chain over l in order.
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

cudaError_t v_launch(const float* E, const float* U, const float* C,
                     float* V, int B, int D, int r, cudaStream_t stream) {
  void* args[] = {&E, &U, &C, &V, &D, &r};
  return launch(reinterpret_cast<const void*>(k3v_kernel),
                dim3((D + PT_TILE - 1) / PT_TILE, B),
                sizeof(float) * k3v_floats(r), args, stream, V_THREADS);
}

// t += scale·S in place in P's tiles: tile (i0, j0) from S, its twin
// (j0, i0) from Sᵀ; without a twin (a diagonal tile) S[min(r,c)][max(r,c)].
// K3's downdate (scale −½) and K1's add (scale 1).
__device__ __forceinline__ void add_pair(const PTile<float>& tij, const PTile<float>& tji,
                         const float* sC, float scale, bool twin) {
  const int c = threadIdx.x;
  for (int a = 0; a < PT_TILE; ++a)
    tij.ref(a, c) += scale * sC[!twin && a > c ? c * LDC + a : a * LDC + c];
  if (twin)
    for (int a = 0; a < PT_TILE; ++a) tji.ref(a, c) += scale * sC[c * LDC + a];
}

// The stripe transform of a pair of tile row 0, J (W x W, row-major in
// shared memory) on dims 0:W: rows 0:W of tile (0, j0) <- J·rows, columns
// 0:W of tile (j0, 0) <- columns·Jᵀ, the same products in the same order,
// so the two stay mirrors. A thread keeps column t of tile (0, j0) and row
// t of tile (j0, 0). On (0, 0) (no twin) rows, then columns (the Pallas
// order), then the W x W corner's lower entries from its upper ones. K3's
// renorm stripe (W = 8, J8) and K1's predict stripe (W = 16, F16).
template <int W>
__device__ __forceinline__ void stripe_pair(const PTile<float>& tij, const PTile<float>& tji,
                            const float* sJ, bool twin) {
  const int t = threadIdx.x;
  float v[W];
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = tij.at(k, t);
#pragma unroll
  for (int r = 0; r < W; ++r) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) s = fmaf(sJ[r * W + k], v[k], s);
    tij.ref(r, t) = s;
  }
  if (!twin) __syncthreads();            // (0, 0): rows, then columns
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = tji.at(t, k);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) s = fmaf(v[k], sJ[c * W + k], s);
    tji.ref(t, c) = s;
  }
  if (!twin) {
    __syncthreads();
    if (t < W)
      for (int a = t + 1; a < W; ++a) tij.ref(a, t) = tij.ref(t, a);
  }
  __syncthreads();
}

// keep_i keep_j ∘ t on both tiles (0 past D).
__device__ __forceinline__ void keep_pair(const PTile<float>& tij, const PTile<float>& tji,
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

// Shared memory of a tile-pair kernel: the accumulator tile (over the
// ring), `extra` floats of small operands, P's two tiles, the mbarrier.
constexpr size_t pair_smem(int extra) {
  static_assert(ring_floats<Col3, Col3>() <= PT_TILE * LDC &&
                    ring_floats<Row3, Row3>() <= PT_TILE * LDC,
                "the accumulator tile lies over the ring");
  return sizeof(float) * (up4(PT_TILE * LDC) + extra) +
         2 * PTile<float>::BYTES + sizeof(unsigned long long);
}

__global__ void __launch_bounds__(G3::THREADS, PAIR_BLOCKS)
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
  add_pair(tij, tji, sC, -0.5f, twin);
  __syncthreads();
  if (i == 0) stripe_pair<8>(tij, tji, sJ, twin);
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
                dim3(nt * (nt + 1) / 2, B), pair_smem(64), args, stream,
                G3::THREADS);
}

// K1 — replaces ekf_slam_tpu/ops/pallas_kernels.py fused_manage_predict_pht
// (_k1_kernel): map management + EKF predict + the prior gain columns,
//   P⁻ = Lp·(keep∘P + E6ᵀU6 + U6ᵀE6 + E6ᵀC66E6)·Lpᵀ + Q̃,  PHt = P⁻·Ht,
// Lp = diag(F13, I), passed as F16 = F13 ⊕ I₃ (the predict stripe is 16
// wide, identity on 13:16); Q̃ is Q13 on the camera block, passed as Q16
// zero-padded; E6, U6 (r, D), C66 (r, r), r = 6 at the call site (E6 holds
// one-hot rows); Ht (D, R), R = 2·CAP = 200 at the bench.
// K2 — replaces pallas_kernels.py fused_update_tail_pht (_tail_pht_kernel):
// the LI-update tail and the posterior gain columns,
//   P_li = T·sym(P − K·PHtᵀ)·Tᵀ,  PHt2 = P_li·Ht2,
// T = I ⊕ Jq4 on dims 3:7 (J8 as for K3), K, PHt (D, M2), any M2; P enters
// symmetric, the Pallas kernel's precondition.
// Bound on the H100 (B = 128, D = 613, R = 200): the product's 2·D²·R
// flops (19.24 GFLOP: 0.29 ms at 67 TFLOP/s) are most of each kernel's
// operations (K1 19.88 GFLOP in all; K2 31.58 with its downdate); P read
// and written once is 385 MB (0.115 ms at 3.35 TB/s). The FMA units bind.
// Design: each is a tile-pair pass that writes the new P, then K6's panel
// product PHt = P_new·Ht (ekf_k6_matmul_big: two 128-column chunks at
// R = 200), which reads the P just written back (192 MB, ~0.06 ms). The
// Pallas kernels carried PHt's sum across their sequential j axis; on
// Hopper one pass would need either a block
// that owns a row stripe and so computes both triangles (the downdate
// twice) or a reduction across blocks (atomics, not deterministic; or a
// workspace of partial sums, ~0.7 GB at B = 128).
//  K2's pass is k3_kernel with r = 0 (K5), unchanged.
//  K1's pass is k1p_kernel, after k3v_kernel has formed V = U6 + ½·C66·E6,
//  per tile pair: (a) the bulk copies of P's two tiles land under the
//  add's product S2 = [E6; V]ᵀ[V; E6] = E6ᵀU6 + U6ᵀE6 + E6ᵀ·sym(C66)·E6
//  (as K3's (c)); (b) the keep mask in place; (c) on the pairs of tile row
//  0, S2 added in place (the Pallas order: add, then stripe, then Q̃), then
//  the predict stripe with F16 (stripe_pair<16>: on (0, 0) the 16 x 16
//  corner's lower entries from its upper ones), then + Q16 on (0, 0);
//  (d) the mirrored store, which adds S2 on the other pairs (one rounding
//  either way) and adds nothing (scale 0) where it is in the tiles. The
//  output is bitwise symmetric wherever P and C66 are, except in the
//  13 x 13 corner where Q13 is not.
__global__ void __launch_bounds__(G3::THREADS, PAIR_BLOCKS)
    k1p_kernel(const float* __restrict__ P, const float* __restrict__ keep,
               const float* __restrict__ E, const float* __restrict__ V,
               const float* __restrict__ F16, const float* __restrict__ Q16,
               float* __restrict__ Pout, int D, int r) {
  extern __shared__ __align__(16) float sm[];
  const int nt = (D + PT_TILE - 1) / PT_TILE, b = blockIdx.y;
  int i, j;
  pair_of(blockIdx.x, nt, i, j);
  const int i0 = i * PT_TILE, j0 = j * PT_TILE;
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  keep += static_cast<size_t>(b) * D;
  E += static_cast<size_t>(b) * r * D;
  V += static_cast<size_t>(b) * r * D;
  F16 += b * 256;
  Q16 += b * 256;

  float* sC = sm;                             // PT_TILE x LDC, over the ring
  float* sF = sm + up4(PT_TILE * LDC);        // 16 x 16
  float* sQ = sF + 256;                       // 16 x 16
  char* raw_ij = reinterpret_cast<char*>(sQ + 256);
  char* raw_ji = raw_ij + PTile<float>::BYTES;
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(raw_ji + PTile<float>::BYTES);
  const bool twin = i0 != j0;
  if (threadIdx.x == 0) mbar_init(mbar, G3::THREADS);
  for (int k = threadIdx.x; k < 256; k += G3::THREADS) {
    sF[k] = F16[k];
    sQ[k] = Q16[k];
  }
  __syncthreads();
  unsigned bytes = PTile<float>::fetch<G3::THREADS>(raw_ij, P, D, i0, j0,
                                                     mbar);
  if (twin)
    bytes += PTile<float>::fetch<G3::THREADS>(raw_ji, P, D, j0, i0, mbar);
  mbar_arrive_expect(mbar, bytes);
  const PTile<float> tij(raw_ij, P, D, i0, j0);
  const PTile<float> tji(twin ? raw_ji : raw_ij, P, D, j0, i0);

  float acc[G3::TM][G3::TN];
  const int tiles = (r + BK - 1) / BK;        // of one factor's r rows
  Row3 ex(E, V, tiles, r, D, i0, D), ey(V, E, tiles, r, D, j0, D);
  panel_product<G3>(acc, sm, 2 * tiles, ex, ey);
  put_acc(sC, acc);
  mbar_wait(mbar);
  __syncthreads();
  keep_pair(tij, tji, keep, D, i0, j0, twin);
  if (i == 0) {
    add_pair(tij, tji, sC, 1.f, twin);        // each thread its own column
    __syncthreads();
    stripe_pair<16>(tij, tji, sF, twin);
    if (!twin) {
      if (threadIdx.x < 16)
        for (int a = 0; a < 16; ++a)
          tij.ref(a, threadIdx.x) += sQ[a * 16 + threadIdx.x];
      __syncthreads();
    }
  }
  store_tile_pair<float, G3::THREADS>(Pout, D, i0, j0, sC, tij, tji,
                                      i == 0 ? 0.f : 1.f, true, false);
}

}  // namespace

extern "C" {

// K1. All matrices are contiguous row-major f32 with a leading instance
// axis B: P, Pout (B,D,D); keep (B,D); E, U (B,r,D); C (B,r,r); F16, Q16
// (B,16,16); Ht, PHt (B,D,R), any R >= 1; V (B,r,D), the caller's scratch
// for V = U + ½·C·E. Requires 1 <= r <= 128 and D >= 16, the predict
// stripe's rows. Three launches: k3v_kernel, k1p_kernel, K6's product.
cudaError_t ekf_k1_manage_predict_pht(const float* P, const float* keep,
                                      const float* E, const float* U,
                                      const float* C, const float* F16,
                                      const float* Q16, const float* Ht,
                                      float* V, float* Pout, float* PHt,
                                      int B, int D, int R, int r,
                                      void* stream) {
  if (r < 1 || r > 128 || R < 1 || D < 16 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = v_launch(E, U, C, V, B, D, r, s);
  if (err != cudaSuccess) return err;
  void* args[] = {&P, &keep, &E, &V, &F16, &Q16, &Pout, &D, &r};
  const int nt = (D + PT_TILE - 1) / PT_TILE;
  err = launch(reinterpret_cast<const void*>(k1p_kernel),
               dim3(nt * (nt + 1) / 2, B), pair_smem(512), args, s,
               G3::THREADS);
  if (err != cudaSuccess) return err;
  return ekf_k6_matmul_big(Pout, Ht, PHt, B, D, D, R, 0, stream);
}

// K2. P, Pout (B,D,D); K, PHt (B,D,M2), any M2 >= 1; J8 (B,8,8); Ht, PHt2
// (B,D,R), any R >= 1; D >= 8, the renorm stripe's rows. Two launches:
// k3_kernel with r = 0 (K5), then K6's product.
cudaError_t ekf_k2_update_tail_pht(const float* P, const float* K,
                                   const float* PHt, const float* J8,
                                   const float* Ht, float* Pout, float* PHt2,
                                   int B, int D, int M2, int R, void* stream) {
  if (M2 < 1 || R < 1 || D < 8 || B > 65535) return cudaErrorInvalidValue;
  const cudaError_t err =
      k3_launch(P, K, PHt, J8, nullptr, nullptr, nullptr, Pout, B, D, M2, 0,
                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return ekf_k6_matmul_big(Pout, Ht, PHt2, B, D, D, R, 0, stream);
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
  const cudaError_t err = v_launch(E, U, C, V, B, D, r, s);
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
