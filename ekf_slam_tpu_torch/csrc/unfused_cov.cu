// Covariance kernels of the unfused SLAM step for Hopper (sm_90a): K4, the
// folded update tail's apply for column factors, K8, the same apply for the
// row-form update's row factors (and its row-slab form, the tail of the
// row-sharded step), and K6, the dense products on P. (K5, the
// update tail of the pallas_update route, is a mode of K3 in fused_cov.cu.)
//
// P (B, D, D) row-major, D = 13 + 6·CAP (613 at CAP 100); the ragged edge (D
// is odd) is masked by index and nothing past D is read. P is stored in f32
// or in bf16 (FilterConfig.p_storage, the fast mode): each kernel is
// instantiated for both, reads P in its storage type and upcasts, and K4 /
// K8 round their output once to P's type. Every other operand and every
// sum is f32: a sequential fmaf chain in a fixed order, deterministic, no
// atomics, on CUDA cores: no TF32, no tensor cores, no TMA tensor map
// (P's rows are 2,452 or 1,226 bytes at D = 613, not multiples of 16). All
// three stand on common.cuh's register-blocked panel product (8 x 8
// micro-tiles, a two-stage ring in shared memory whose loads overlap the
// multiply), K4 and K8 also on its mirrored epilogue, their tiles of P
// fetched by bulk copies of the 16-byte lines that cover each row.
//
// Plain C ABI (bound with ctypes): each launcher returns the cudaError_t of
// its launch and launches on the caller's stream; `p_bf16` picks the
// instantiation for a bf16 P.

#include "common.cuh"

namespace {

// The covariance tails of the unfused step: K4, the column-form factors'
// apply, and K8, the row-form factors' apply, on one body.
//
// K4 — replaces ekf_slam_tpu/ops/pallas_kernels.py corr_apply_cols
// (_corr_apply_cols_single, _corr_sym_cols_kernel): the folded update
// tail's one-pass apply,
//   P⁺ = ½(P + Pᵀ) + ½(A·Bᵀ + B·Aᵀ),   A, B (D, R),
// bitwise symmetric, as the Pallas kernel's output is.
// Bound on the H100: the symmetric output needs its sums for one triangle
// only, 4·R flops an entry over D(D+1)/2 entries: R = 2·(2M) + 8 = 264 at
// the bench config's compact update (2M = 128 rows; 408 for a full-width
// update at CAP 100, 104 in the fast mode) makes 25.4 GFLOP a call at
// B = 128, D = 613 (0.38 ms at the 67 TFLOP/s f32 peak), above the 550 MB
// of P read and written and the factors read (0.16 ms at 3.35 TB/s; a
// bf16 P halves P's bytes), so the FMA units bind.
//
// K8 — replaces ekf_slam_tpu/ops/pallas_kernels.py corr_apply
// (_corr_kernel, _corr_expr_kernel, _corr_sym_kernel): the row-form
// update's folded tail apply (ekf.update_rows), At, Bt (R, D) the factors
// of the rank-R correction AtᵀBt (R = 2M + 8 rows: 56 at the fast mode's
// M = 24). With S = AtᵀBt + BtᵀAt:
//   mode 0 "none"  P + AtᵀBt
//   mode 1 "expr"  P + ½·S                            (the default)
//   mode 2 "full"  ½(P + Pᵀ) + ½·S                    (K4's function)
// Bound on the H100 at the fast mode (B = 128, D = 613, R = 56, bf16 P):
// 4·R flops an entry over D(D+1)/2 entries, 5.4 GFLOP a call (0.081 ms at
// 67 TFLOP/s); P read and written in bf16 plus the factors is 227 MB
// (0.068 ms), so the operations bind.
//
// Design (both): S is one product over the concatenated contraction,
// S = X·Yᵀ with X = [A | B], Y = [B | A] (K4: 2R columns of the (D, R)
// factors) or X = [At; Bt]ᵀ, Y = [Bt; At]ᵀ (K8: 2R rows of the (R, D)
// factors), so one accumulator an entry (panel_product, 8 x 8
// micro-tiles). One block of 64 threads per tile PAIR (i <= j) of 64 x 64
// tiles — 55 blocks an instance at D = 613 — computes S(i, j) once and
// writes out(i, j) and out(j, i) = … + ½·S(i, j)ᵀ (store_tile_pair): the
// bound's flop count (plus the diagonal tiles' lower halves and the ragged
// last tile: 1.197x at D = 613), and the correction is bitwise symmetric
// by construction off the diagonal. On a diagonal tile the single chain
// sums entry (r, c) and entry (c, r) in different orders, so its lower
// entries are taken from its upper ones. The two tiles of P are fetched
// into shared memory by bulk copies started before the product and awaited
// after it (PTile), so the epilogue waits on no global load; "full"
// averages P(i, j) with P(j, i)ᵀ from the same two tiles, each read once.
// K8's "none" is not symmetric: all D² tiles, contraction R, X = At,
// Y = Bt, no mirroring. The loaders differ by the factors' layout: K8's
// factor rows are the contraction, staged as they lie (RowPanel); K4's
// factor rows are the output's rows and the contraction is contiguous, so
// both sides stage transposed, [k][row] (ColPanel with two sources). Any
// R: the contraction streams through the ring in BK-deep tiles, each
// factor padded to whole tiles with zeros.
using G8 = Blocking<PT_TILE, PT_TILE, 8, 8>;
using Panel8 = RowPanel<PT_TILE, G8::THREADS>;
using Col8 = ColPanel<float, PT_TILE, G8::THREADS, 2>;

// Shared memory of corr_pair: the accumulator tile (over the ring of
// either loader pair), P's two tiles, the mbarrier.
template <typename PT>
constexpr size_t corr_smem() {
  static_assert(ring_floats<Panel8, Panel8>() <= PT_TILE * LDC &&
                    ring_floats<Col8, Col8>() <= PT_TILE * LDC,
                "the accumulator tile lies over the ring");
  return sizeof(float) * up4(PT_TILE * LDC) + 2 * PTile<PT>::BYTES +
         sizeof(unsigned long long);
}

// Tile pair (i0, j0) of one instance: out = P + scale·X_i·Y_jᵀ in `mode`
// (0 none: tile (i0, j0) alone, scale 1; 1 expr; 2 full: scale ½ and the
// (j0, i0) tile mirrored), the product over `ntiles` BK-deep tiles of the
// loaders lx, ly.
template <typename PT, typename LX, typename LY>
__device__ __forceinline__ void corr_pair(const PT* __restrict__ P,
                                          PT* __restrict__ Pout, int D,
                                          int i0, int j0, int mode,
                                          int ntiles, LX& lx, LY& ly) {
  extern __shared__ __align__(16) float sm[];
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

  float acc[G8::TM][G8::TN];
  panel_product<G8>(acc, sm, ntiles, lx, ly);
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

template <typename PT>
__global__ void __launch_bounds__(G8::THREADS, G8::MIN_BLOCKS)
    k4_kernel(const PT* __restrict__ P, const float* __restrict__ A,
              const float* __restrict__ Bf, PT* __restrict__ Pout, int D,
              int R) {
  const int nt = (D + PT_TILE - 1) / PT_TILE, b = blockIdx.y;
  int i, j;
  pair_of(blockIdx.x, nt, i, j);
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  A += static_cast<size_t>(b) * D * R;
  Bf += static_cast<size_t>(b) * D * R;
  const int tiles = (R + BK - 1) / BK;   // of one factor's R columns
  Col8 lx(A, Bf, tiles, R, i * PT_TILE, D, R);
  Col8 ly(Bf, A, tiles, R, j * PT_TILE, D, R);
  corr_pair(P, Pout, D, i * PT_TILE, j * PT_TILE, 2, 2 * tiles, lx, ly);
}

template <typename PT>
__global__ void __launch_bounds__(G8::THREADS, G8::MIN_BLOCKS)
    k8_kernel(const PT* __restrict__ P, const float* __restrict__ At,
              const float* __restrict__ Bt, PT* __restrict__ Pout, int D,
              int R, int mode) {
  const int nt = (D + PT_TILE - 1) / PT_TILE, b = blockIdx.y;
  int i, j;
  if (mode == 0)
    i = blockIdx.x / nt, j = blockIdx.x % nt;
  else
    pair_of(blockIdx.x, nt, i, j);
  const size_t DD = static_cast<size_t>(D) * D;
  P += b * DD;
  Pout += b * DD;
  At += static_cast<size_t>(b) * R * D;
  Bt += static_cast<size_t>(b) * R * D;
  const int tiles = (R + BK - 1) / BK;   // of one factor's R rows
  Panel8 lx(At, Bt, tiles, R, D, i * PT_TILE, D);
  Panel8 ly(Bt, At, tiles, R, D, j * PT_TILE, D);
  corr_pair(P, Pout, D, i * PT_TILE, j * PT_TILE, mode,
            mode == 0 ? tiles : 2 * tiles, lx, ly);
}

// K8's row-slab form — the tail of the row-sharded step
// (parallel/sharded_filter.py), which holds P's rows r0 .. r0+Dl−1 on one
// rank: out = P_s + At[:, r0:r0+Dl]ᵀ·Bt, mode "none" on the slab P_s
// (Dl, Dc) of a P whose columns are Dc; At, Bt (R, Dc) are the whole
// factors (Bt gathered from every rank), and the slab reads At's columns
// r0 .. r0+Dl−1 where they lie. Each entry is K8 "none"'s fmaf chain over
// the same R rows in the same order, added to P once, so the slab equals
// rows r0 .. of K8 "none" bit for bit. Bound at the sim config split two
// ways (B = 128, Dl = 307, Dc = 614, R = 264, f32): 2·R flops an entry,
// 12.7 GFLOP (0.19 ms at 67 TFLOP/s) against 317 MB of slab read and
// written and factors read (0.09 ms at 3.35 TB/s): the operations bind. Design, simple on purpose:
// one block of 64 threads a 64 x 64 output tile, panel_product over R
// with both factors staged as they lie (RowPanel), then each thread adds
// its 8 x 8 micro-tile to P read from global memory and stores it; no
// tile pairs, no mirror, no bulk copies (PTile assumes a square P).
template <typename PT>
__global__ void __launch_bounds__(G8::THREADS, G8::MIN_BLOCKS)
    k8s_kernel(const PT* __restrict__ P, const float* __restrict__ At,
               const float* __restrict__ Bt, PT* __restrict__ Pout, int Dl,
               int Dc, int R, int r0) {
  extern __shared__ __align__(16) float sm[];
  const int ntc = (Dc + PT_TILE - 1) / PT_TILE, b = blockIdx.y;
  const int i0 = (blockIdx.x / ntc) * PT_TILE;
  const int j0 = (blockIdx.x % ntc) * PT_TILE;
  const size_t slab = static_cast<size_t>(Dl) * Dc;
  P += b * slab;
  Pout += b * slab;
  At += static_cast<size_t>(b) * R * Dc;
  Bt += static_cast<size_t>(b) * R * Dc;
  const int tiles = (R + BK - 1) / BK;
  Panel8 lx(At, At, tiles, R, Dc, r0 + i0, r0 + Dl);
  Panel8 ly(Bt, Bt, tiles, R, Dc, j0, Dc);
  float acc[G8::TM][G8::TN];
  panel_product<G8>(acc, sm, tiles, lx, ly);
#pragma unroll
  for (int q = 0; q < G8::TM; ++q) {
    const int gi = i0 + G8::row(q);
    if (gi >= Dl) continue;
#pragma unroll
    for (int p = 0; p < G8::TN; ++p) {
      const int gj = j0 + G8::col(p);
      if (gj >= Dc) continue;
      const size_t n = static_cast<size_t>(gi) * Dc + gj;
      store(Pout + n, to_f32(P[n]) + acc[q][p]);
    }
  }
}

// K6 — replaces ekf_slam_tpu/ops/pallas_kernels.py f32_matmul_big
// (_mm_kernel): C = A·B in full f32 for a large A (M x K, the covariance
// P, f32 or bf16) and a narrow B (K x N): update_gain's P·Hᵀ (N = 2M =
// 128, 48 in the fast mode, or 2·CAP = 200 full width) and RANSAC's P·G
// (N = NHYP = 64). Its launcher is also the P·Hᵀ half of K1 and K2
// (fused_cov.cu): P_new·Ht with N = 2·CAP = 200.
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
// (A is then read once a chunk, from L2): K1's and K2's N = 200 runs as two
// chunks, 28% of the columns padding, yet measured faster on an H100 than
// one 224-column chunk of 224 threads (two blocks an SM) or two 104-column
// chunks of 8 x 4 micro-tiles (PERF.md §6). Every output
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
  if (R < 1 || D < 1 || Bn > 65535) return cudaErrorInvalidValue;
  void* args[] = {&P, &A, &B, &Pout, &D, &R};
  const int nt = (D + PT_TILE - 1) / PT_TILE;
  const void* fn = p_bf16
      ? reinterpret_cast<const void*>(k4_kernel<__nv_bfloat16>)
      : reinterpret_cast<const void*>(k4_kernel<float>);
  return launch(fn, dim3(nt * (nt + 1) / 2, Bn),
                p_bf16 ? corr_smem<__nv_bfloat16>() : corr_smem<float>(),
                args, static_cast<cudaStream_t>(stream), G8::THREADS);
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
  void* args[] = {&P, &At, &Bt, &Pout, &D, &R, &mode};
  const int nt = (D + PT_TILE - 1) / PT_TILE;
  const void* fn = p_bf16
      ? reinterpret_cast<const void*>(k8_kernel<__nv_bfloat16>)
      : reinterpret_cast<const void*>(k8_kernel<float>);
  return launch(fn, dim3(mode == 0 ? nt * nt : nt * (nt + 1) / 2, Bn),
                p_bf16 ? corr_smem<__nv_bfloat16>() : corr_smem<float>(),
                args, static_cast<cudaStream_t>(stream), G8::THREADS);
}

// K8's row-slab form. P, Pout (B,Dl,Dc), f32 or (p_bf16) bf16; At, Bt
// (B,R,Dc) f32, any R >= 1; the slab's rows are r0 .. r0+Dl−1 of a P with
// Dc columns (r0 + Dl <= Dc). Contiguous row-major.
cudaError_t ekf_k8_corr_apply_rows(const void* P, const float* At,
                                   const float* Bt, void* Pout, int Bn,
                                   int Dl, int Dc, int R, int r0, int p_bf16,
                                   void* stream) {
  if (R < 1 || Dl < 1 || r0 < 0 || r0 + Dl > Dc || Bn > 65535)
    return cudaErrorInvalidValue;
  void* args[] = {&P, &At, &Bt, &Pout, &Dl, &Dc, &R, &r0};
  const int ntr = (Dl + PT_TILE - 1) / PT_TILE;
  const int ntc = (Dc + PT_TILE - 1) / PT_TILE;
  const void* fn = p_bf16
      ? reinterpret_cast<const void*>(k8s_kernel<__nv_bfloat16>)
      : reinterpret_cast<const void*>(k8s_kernel<float>);
  return launch(fn, dim3(ntr * ntc, Bn),
                sizeof(float) * ring_floats<Panel8, Panel8>(), args,
                static_cast<cudaStream_t>(stream), G8::THREADS);
}

}  // extern "C"
