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
// atomics, on CUDA cores: no TF32, no tensor cores, no TMA tensor map
// (P's rows are 2,452 or 1,226 bytes at D = 613, not multiples of 16). K4
// stands on the 32 x 32 tile helpers of common.cuh; K6 and K8 on its
// register-blocked panel product (8 x 8 micro-tiles, a two-stage ring in
// shared memory whose loads overlap the multiply) and K8 on its mirrored
// epilogue, its tiles of P fetched by bulk copies of the 16-byte lines that
// cover each row.
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
// M = 24). With S = AtᵀBt + BtᵀAt:
//   mode 0 "none"  P + AtᵀBt
//   mode 1 "expr"  P + ½·S                            (the default)
//   mode 2 "full"  ½(P + Pᵀ) + ½·S
// P is read in its storage type, the sum rounded once to it.
// Bound on the H100 at the fast mode (B = 128, D = 613, R = 56, bf16 P):
// the symmetric correction needs 4·R flops an entry over D(D+1)/2 entries,
// 5.4 GFLOP a call (0.081 ms at 67 TFLOP/s); P read and written in bf16
// plus the factors is 227 MB (0.068 ms), so the operations bind.
// Design: S is one product over the concatenated contraction, S = XᵀY with
// X = [At; Bt], Y = [Bt; At] (2R rows), so one accumulator an entry
// (panel_product, 8 x 8 micro-tiles). One block of 64 threads per tile PAIR
// (i <= j) of 64 x 64 tiles — 55 blocks an instance at D = 613 — computes
// S(i, j) once and writes out(i, j) and out(j, i) = … + ½·S(i, j)ᵀ
// (store_tile_pair): the bound's flop count (plus the diagonal tiles' lower
// halves), and the correction is bitwise symmetric by construction off the
// diagonal. On a diagonal tile the single chain sums entry (r, c) and
// entry (c, r) in different orders, so its lower entries are taken from its
// upper ones. The two tiles of P are fetched into shared memory by bulk
// copies started before the product and awaited after it (PTile), so the
// epilogue waits on no global load; "full" averages P(i, j) with P(j, i)ᵀ
// from the same two tiles, each read once. "none" is not symmetric: all D²
// tiles, contraction R, X = At, Y = Bt, no mirroring. Any R: the
// contraction streams through the ring in BK-deep tiles, each factor padded
// to whole tiles with rows of zeros.
using G8 = Blocking<PT_TILE, PT_TILE, 8, 8>;
using Panel8 = RowPanel<PT_TILE, G8::THREADS>;

template <typename PT>
__global__ void __launch_bounds__(G8::THREADS, G8::MIN_BLOCKS)
    k8_kernel(const PT* __restrict__ P, const float* __restrict__ At,
              const float* __restrict__ Bt, PT* __restrict__ Pout, int D,
              int R, int mode) {
  extern __shared__ __align__(16) float sm[];
  const int nt = (D + PT_TILE - 1) / PT_TILE, b = blockIdx.y;
  int i, j;
  if (mode == 0) {
    i = blockIdx.x / nt, j = blockIdx.x % nt;
  } else {                              // pair index -> (i, j), i <= j
    int p = blockIdx.x;
    for (i = 0; p >= nt - i; ++i) p -= nt - i;
    j = i + p;
  }
  const int i0 = i * PT_TILE, j0 = j * PT_TILE;
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  At += static_cast<size_t>(b) * R * D;
  Bt += static_cast<size_t>(b) * R * D;

  float* sC = sm;                       // PT_TILE x LDC, over the ring
  char* raw_ij = reinterpret_cast<char*>(sm + up4(PT_TILE * LDC));
  char* raw_ji = raw_ij + PTile<PT>::BYTES;
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(raw_ji + PTile<PT>::BYTES);
  const bool twin = mode != 0 && i0 != j0;
  if (threadIdx.x == 0) mbar_init(mbar, G8::THREADS);
  __syncthreads();
  unsigned bytes = PTile<PT>::template fetch<G8::THREADS>(raw_ij, P, D, i0,
                                                          j0, mbar);
  if (twin)
    bytes += PTile<PT>::template fetch<G8::THREADS>(raw_ji, P, D, j0, i0,
                                                    mbar);
  mbar_arrive_expect(mbar, bytes);
  const PTile<PT> pij(raw_ij, P, D, i0, j0);
  const PTile<PT> pji(twin ? raw_ji : raw_ij, P, D, j0, i0);

  const int tiles = (R + BK - 1) / BK;   // of one factor's R rows
  Panel8 lx(At, Bt, tiles, R, D, i0, D), ly(Bt, At, tiles, R, D, j0, D);
  float acc[G8::TM][G8::TN];
  panel_product<G8>(acc, sm, mode == 0 ? tiles : 2 * tiles, lx, ly);
#pragma unroll
  for (int q = 0; q < G8::TM; ++q)
#pragma unroll
    for (int p = 0; p < G8::TN; ++p)
      sC[G8::row(q) * LDC + G8::col(p)] = acc[q][p];
  mbar_wait(mbar);
  __syncthreads();
  store_tile_pair<PT, G8::THREADS>(Pout, D, i0, j0, sC, pij, pji,
                                   mode == 0 ? 1.f : 0.5f, mode != 0,
                                   mode == 2);
}

// K6 — replaces ekf_slam_tpu/ops/pallas_kernels.py f32_matmul_big
// (_mm_kernel): C = A·B in full f32 for a large A (M x K, the covariance
// P, f32 or bf16) and a narrow B (K x N): update_gain's P·Hᵀ (N = 2M =
// 128, 48 in the fast mode, or 2·CAP = 200 full width) and RANSAC's P·G
// (N = NHYP = 64).
// Bound on the H100: A is 1.5 MB per instance at D = 613, 192 MB at
// B = 128 (0.06 ms at 3.35 TB/s); the product is 2·D²·N flops, 96 MFLOP
// per instance at N = 128 (12 GFLOP per call, >= 0.18 ms at the f32 peak),
// so the FMA loop bounds it.
// Design: a block owns a 64-row stripe of A and BN columns of B and runs
// panel_product over the contraction: A's tile is staged transposed
// ([k][row], ColPanel) and B's straight (RowPanel), the next tile's loads
// in flight while this one is multiplied, every thread an 8 x 8
// micro-tile. BN is 64 for N <= 64 (N = 48 runs with a quarter of its
// columns zeros: no slower on the card than a 48-column blocking of 8 x 4
// micro-tiles), else 128; wider N takes a grid axis of 128-column chunks
// (A is then read once a chunk, from L2). Every output
// entry is written by one thread: no atomics. C's rows are stored 16 bytes
// at a time when N is a multiple of 4 and C is 16-byte aligned (`vec`),
// else by element. At D = 613, B = 128 the grid is 10 x 128 = 1,280 blocks
// of 64 or 128 threads: 1.2 to 1.6 (N <= 64) or 2.4 (N = 128) waves on 132
// SMs, the last one thin. The 64-column blocking is left all the registers
// ptxas asks for (about 150, six blocks an SM), which it turns into deeper
// prefetch of the shared-memory operands; the others keep 128.
template <int BN>
using G6 = Blocking<64, BN, 8, 8, BN == 64 ? 255 : 128>;

template <typename AT, int BN>
__global__ void __launch_bounds__(G6<BN>::THREADS,
                                  G6<BN>::MIN_BLOCKS)
    k6_kernel(const AT* __restrict__ A, const float* __restrict__ Bm,
              float* __restrict__ C, int M, int K, int N, int vec) {
  using G = G6<BN>;
  constexpr int BM = G::BM;
  extern __shared__ __align__(16) float sm[];
  const int i0 = blockIdx.x * BM, c0 = blockIdx.y * BN, b = blockIdx.z;
  A += static_cast<size_t>(b) * M * K;
  Bm += static_cast<size_t>(b) * K * N;
  C += static_cast<size_t>(b) * M * N;

  const int tiles = (K + BK - 1) / BK;
  ColPanel<AT, BM, G::THREADS> la(A, K, i0, M, K);
  RowPanel<BN, G::THREADS> lb(Bm, Bm, tiles, K, N, c0, N);
  float acc[G::TM][G::TN];
  panel_product<G>(acc, sm, tiles, la, lb);
#pragma unroll
  for (int q = 0; q < G::TM; ++q) {
    const int gi = i0 + G::row(q);
    if (gi >= M) continue;
    float* crow = C + static_cast<size_t>(gi) * N;
#pragma unroll
    for (int g = 0; g < G::TN / 4; ++g) {
      const int gc = c0 + G::col(4 * g);
      if (vec) {
        if (gc < N)
          *reinterpret_cast<float4*>(crow + gc) =
              make_float4(acc[q][4 * g], acc[q][4 * g + 1], acc[q][4 * g + 2],
                          acc[q][4 * g + 3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (gc + p < N) crow[gc + p] = acc[q][4 * g + p];
      }
    }
  }
}

template <typename AT, int BN>
cudaError_t k6_launch(const void* A, const float* B, float* C, int Bn, int M,
                      int K, int N, cudaStream_t stream) {
  using G = G6<BN>;
  constexpr int BM = G::BM;
  constexpr size_t smem =
      sizeof(float) * ring_floats<ColPanel<AT, BM, G::THREADS>,
                                  RowPanel<BN, G::THREADS>>();
  int vec = N % 4 == 0 && reinterpret_cast<size_t>(C) % 16 == 0;
  void* args[] = {&A, &B, &C, &M, &K, &N, &vec};
  return launch(reinterpret_cast<const void*>(k6_kernel<AT, BN>),
                dim3((M + BM - 1) / BM, (N + BN - 1) / BN, Bn), smem, args,
                stream, G::THREADS);
}

template <typename AT>
cudaError_t k6_dispatch(const void* A, const float* B, float* C, int Bn,
                        int M, int K, int N, cudaStream_t stream) {
  if (N <= 64) return k6_launch<AT, 64>(A, B, C, Bn, M, K, N, stream);
  return k6_launch<AT, 128>(A, B, C, Bn, M, K, N, stream);
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
  if (M < 1 || K < 1 || N < 1 || Bn > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_bf16 ? k6_dispatch<__nv_bfloat16>(A, B, C, Bn, M, K, N, s)
                : k6_dispatch<float>(A, B, C, Bn, M, K, N, s);
}

// K8. P, Pout (B,D,D), f32 or (p_bf16) bf16; At, Bt (B,R,D) f32, any
// R >= 1; mode 0 none, 1 expr, 2 full. Contiguous row-major.
cudaError_t ekf_k8_corr_apply(const void* P, const float* At,
                              const float* Bt, void* Pout, int Bn, int D,
                              int R, int mode, int p_bf16, void* stream) {
  if (R < 1 || D < 1 || mode < 0 || mode > 2 || Bn > 65535)
    return cudaErrorInvalidValue;
  static_assert(ring_floats<Panel8, Panel8>() <= PT_TILE * LDC,
                "the accumulator tile lies over the ring");
  const size_t smem =
      sizeof(float) * up4(PT_TILE * LDC) + sizeof(unsigned long long) +
      2 * (p_bf16 ? PTile<__nv_bfloat16>::BYTES : PTile<float>::BYTES);
  void* args[] = {&P, &At, &Bt, &Pout, &D, &R, &mode};
  const int nt = (D + PT_TILE - 1) / PT_TILE;
  const void* fn = p_bf16
      ? reinterpret_cast<const void*>(k8_kernel<__nv_bfloat16>)
      : reinterpret_cast<const void*>(k8_kernel<float>);
  return launch(fn, dim3(mode == 0 ? nt * nt : nt * (nt + 1) / 2, Bn), smem,
                args, static_cast<cudaStream_t>(stream), G8::THREADS);
}

}  // extern "C"
