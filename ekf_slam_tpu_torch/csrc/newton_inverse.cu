// spd_inverse_newton — the Newton gain's SPD inverse for Hopper (sm_90a).
// Replaces no Pallas kernel: it stands for XLA's matmuls in
// ekf_slam_tpu/filter/ekf.py:599 (_spd_inverse_newton), which the port ran
// as batched torch.matmul calls (cuBLAS), about 93 launches a solve with
// every intermediate in device memory. For each of B matrices S (n x n,
// f32, row-major), the same function as the plain version
// (ops/kernels.spd_inverse_newton_plain):
//   d   = diag(S), each entry that is not > 0 replaced by 1;
//   rsd = 1/√d;  λ̂ = max_i Σ_j (|S_ij|·rsd_i)·rsd_j (NaN if any row is);
//   X₀  = (I / d) / λ̂  (column j of I divided by d_j, then by λ̂);
//   20 times: X ← X·(2I − S·X).
//
// Bound on the H100 at the sim cell's size (B = 1,024, n = 128): 40
// products of 2n³ an instance, 171.8 GFLOP, 2.56 ms at 67 TFLOP/s in f32
// FFMA; S read and W written, 134 MB, 0.04 ms. The work is arithmetic.
//
// What the design does about it:
// - One block an instance. S, X and T = 2I − S·X live in dynamic shared
//   memory for all 20 iterations (3·NP·(NP + 4)·4 bytes: 198 KB at
//   NP = 128, one block an SM; 52 KB at NP = 64, four), so nothing but S
//   and the result touches device memory.
// - The padded size NP is the block's: 128 for 64 < n ≤ 128 (256 threads),
//   64 for n ≤ 64 (64 threads). Rows and columns from n to NP are zeros
//   and stay zeros (every store is masked to i, j < n), so the products'
//   padded terms add exact zeros, whatever S holds.
// - Each product C = A·B (S·X, then X·T) runs over all NP x NP outputs,
//   8 x 8 a thread: rows ty + (NP/8)·q, columns 4·tx + j + (NP/2)·g. The
//   32 lanes of a warp are 4 rows (ty) x 8 column groups (tx). A is read
//   as it is stored, row-major, four k at a time: one 16-byte load a row
//   of the micro-tile, 8 lanes sharing each (a broadcast), the warp's 4
//   rows on 4 distinct bank groups (the row pitch NP + 4 is 4 mod 32
//   floats with (NP + 4)/4 odd). B is read a k row at a time: two 16-byte
//   loads, the 8 column groups 128 consecutive bytes, shared by the 4
//   rows. That is 4 shared-memory wavefronts a k step against 64 FFMAs a
//   thread, so the products are bound by the rate FFMAs start at.
// - Every output is one ascending-k fmaf chain: no tensor cores, no TF32,
//   no split of the contraction, no atomics. Two launches give the same
//   bits; an instance gives the same bits alone as in any batch.
// - The preconditioner runs in the block before the loop: a thread a row
//   for the Gershgorin sums (products and sums rounded one by one, in
//   ascending j), then a thread a column takes their maximum from shared
//   memory with NaN carried through (fmaxf would drop it) and forms its
//   column's diagonal and off-diagonal entry of X₀. S is staged with 16
//   loads in flight a thread: with one block an SM, no other block hides
//   a load's latency.
// Three __syncthreads an iteration: after T is stored, after X·T is read,
// after X is stored.
//
// Plain C ABI (bound with ctypes): the launcher returns the cudaError_t of
// its launch and launches on the caller's stream.

#include "common.cuh"

namespace {

constexpr int NSI_ITERS = 20;
constexpr int NSI_MAX_N = 128;

template <int NP>
struct NsiShape {
  static constexpr int LD = NP + 4;               // row pitch, floats
  static constexpr int TYN = NP / 8, TXN = NP / 8;   // threads down, across
  static constexpr int THREADS = TYN * TXN;        // 64 or 256
  static constexpr int MAT = NP * LD;              // floats a matrix
  static constexpr int PER = NP * NP / THREADS;    // entries a thread: 64
  static constexpr int UNROLL = NP == 128 ? 8 : 2;   // k chunks unrolled
  static constexpr int SMEM = 3 * MAT * 4;         // S, X, T
  static_assert(TXN % 8 == 0 && THREADS % 32 == 0 && (LD / 4) % 2 == 1,
                "warps of 4 x 8 lanes; 4 rows on 4 bank groups");
};

// acc[q][4g + j] = Σ_{k < 4·nk4} A[ty + TYN·q][k] · Bm[k][4·tx + j + 4·TXN·g]
// for this thread's micro-tile, each entry one fmaf chain in k order. A and
// Bm are NP x NP in shared memory at pitch LD; columns (A) and rows (Bm)
// from n to 4·nk4 hold zeros.
template <int NP>
__device__ __forceinline__ void nsi_product(float (&acc)[8][8],
                                            const float* __restrict__ A,
                                            const float* __restrict__ Bm,
                                            int nk4, int ty, int tx) {
  using G = NsiShape<NP>;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[q][p] = 0.f;
  const float* a0 = A + ty * G::LD;
  const float* b0 = Bm + 4 * tx;
#pragma unroll G::UNROLL
  for (int kc = 0; kc < nk4; ++kc) {
    float a[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = ld4(a0 + q * G::TYN * G::LD + 4 * kc);
      a[q][0] = v.x, a[q][1] = v.y, a[q][2] = v.z, a[q][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* br = b0 + (4 * kc + kk) * G::LD;
      const float4 u0 = ld4(br), u1 = ld4(br + 4 * G::TXN);
      const float b[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int p = 0; p < 8; ++p)
          acc[q][p] = fmaf(a[q][kk], b[p], acc[q][p]);
    }
  }
}

// The micro-tile into C (shared, pitch LD): entry (r, c) gets
// (r == c ? diag : 0) − acc for diag_sub, else acc; zero outside n x n.
template <int NP>
__device__ __forceinline__ void nsi_store(float* C, const float (&acc)[8][8],
                                          int n, int ty, int tx,
                                          bool diag_sub, float diag) {
  using G = NsiShape<NP>;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = ty + G::TYN * q;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c0 = 4 * tx + 4 * G::TXN * g;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j;
        const float x = acc[q][4 * g + j];
        const float y = diag_sub ? (r == c ? diag : 0.f) - x : x;
        v[j] = r < n && c < n ? y : 0.f;
      }
      *reinterpret_cast<float4*>(C + r * G::LD + c0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(NsiShape<NP>::THREADS, 1)
    nsi_kernel(const float* __restrict__ S, float* __restrict__ W, int n) {
  using G = NsiShape<NP>;
  extern __shared__ __align__(16) float sm[];
  float* Ss = sm;
  float* Xs = sm + G::MAT;
  float* Ts = sm + 2 * G::MAT;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int ty = 4 * (warp / (G::TXN / 8)) + lane / 8;
  const int tx = 8 * (warp % (G::TXN / 8)) + lane % 8;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* Sb = S + blockIdx.x * nn;

  // S into shared memory, zeros past n x n: 16 loads in flight a thread
  // before their stores (one block an SM has no other to hide them).
#pragma unroll 1
  for (int e0 = 0; e0 < G::PER; e0 += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = tid + (e0 + u) * G::THREADS;
      const int r = e / NP, c = e % NP;
      v[u] = r < n && c < n ? Sb[r * n + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = tid + (e0 + u) * G::THREADS;
      Ss[(e / NP) * G::LD + e % NP] = v[u];
    }
  }
  __syncthreads();
  // The preconditioner, its vectors in T's space: rsd, the row sums, and
  // X₀'s diagonal and off-diagonal entry of each column.
  float* rsd = Ts;
  float* rows = Ts + G::LD;
  float* x0d = Ts + 2 * G::LD;
  float* x0o = Ts + 3 * G::LD;
  if (tid < n) {
    const float s = Ss[tid * G::LD + tid];
    rsd[tid] = 1.f / sqrtf(s > 0.f ? s : 1.f);
  }
  __syncthreads();
  if (tid < n) {
    const float ri = rsd[tid];
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j)
      sum = __fadd_rn(sum, __fmul_rn(__fmul_rn(fabsf(Ss[tid * G::LD + j]),
                                               ri), rsd[j]));
    rows[tid] = sum;
  }
  __syncthreads();
  if (tid < n) {
    float lam = rows[0];
    bool nan = lam != lam;
#pragma unroll 8
    for (int i = 1; i < n; ++i) {
      const float v = rows[i];
      nan = nan || v != v;
      lam = v > lam ? v : lam;
    }
    if (nan) lam = __uint_as_float(0x7fc00000u);
    const float s = Ss[tid * G::LD + tid];
    const float d = s > 0.f ? s : 1.f;
    x0d[tid] = (1.f / d) / lam;
    x0o[tid] = (0.f / d) / lam;
  }
  __syncthreads();
#pragma unroll 16
  for (int u = 0; u < G::PER; ++u) {
    const int e = tid + u * G::THREADS;
    const int r = e / NP, c = e % NP;
    Xs[r * G::LD + c] = r < n && c < n ? (r == c ? x0d[c] : x0o[c]) : 0.f;
  }
  __syncthreads();                      // X₀ stored; its vectors read

  const int nk4 = (n + 3) / 4;
  float acc[8][8];
#pragma unroll 1
  for (int it = 0; it < NSI_ITERS; ++it) {
    nsi_product<NP>(acc, Ss, Xs, nk4, ty, tx);      // S·X
    nsi_store<NP>(Ts, acc, n, ty, tx, true, 2.f);   // T = 2I − S·X
    __syncthreads();
    nsi_product<NP>(acc, Xs, Ts, nk4, ty, tx);      // X·T
    __syncthreads();                                 // every read of X done
    nsi_store<NP>(Xs, acc, n, ty, tx, false, 0.f);
    __syncthreads();
  }
  float* Wb = W + blockIdx.x * nn;
#pragma unroll 16
  for (int u = 0; u < G::PER; ++u) {
    const int e = tid + u * G::THREADS;
    const int r = e / NP, c = e % NP;
    if (r < n && c < n) Wb[r * n + c] = Xs[r * G::LD + c];
  }
}

}  // namespace

extern "C" {

// spd_inverse_newton. S and W (B,n,n), contiguous row-major f32. B >= 1
// and 1 <= n <= 128, else cudaErrorInvalidValue. n <= 64 runs the 64-wide
// block, n > 64 the 128-wide one.
cudaError_t ekf_spd_inverse_newton(const float* S, float* W, int B, int n,
                                   void* stream) {
  if (B < 1 || n < 1 || n > NSI_MAX_N) return cudaErrorInvalidValue;
  void* args[] = {&S, &W, &n};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 64)
    return launch(reinterpret_cast<const void*>(nsi_kernel<64>), dim3(B),
                  NsiShape<64>::SMEM, args, st, NsiShape<64>::THREADS);
  return launch(reinterpret_cast<const void*>(nsi_kernel<128>), dim3(B),
                NsiShape<128>::SMEM, args, st, NsiShape<128>::THREADS);
}

}  // extern "C"
