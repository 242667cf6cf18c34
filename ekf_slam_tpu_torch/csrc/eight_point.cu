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
// 67 TFLOP/s. Neither binds in practice: each matrix is a chain of
// dependent plane rotations (four to six sweeps of 36), so the kernel is
// latency-bound.
//
// What the design does about it:
// - Nine lanes a matrix, three matrices a warp (lanes 27-31 take part in
//   the warp's barriers and votes and keep nothing), one warp a block:
//   N = 1,792 gives 598 warps, ~4.5 an SM, N = 448 150. Lane i of a
//   matrix rewrites row i of the symmetric a = ½(M + Mᵀ) (scaled), which
//   lives in shared memory (rows 12 floats apart: three conflict-free
//   16-byte loads a row), and holds row i of the rotations V in registers.
// - A parallel (round-robin) Jacobi order: the nine indices padded to ten,
//   a sweep is nine rounds, and in round r index r sits out while every
//   other x is paired with (2r − x) mod 9: four disjoint rotations a round,
//   each pair once a sweep, 36 a sweep as in the cyclic order. The four
//   rotations of a round are computed at once, so a matrix waits on ~50
//   rounds where one thread a matrix waited on ~190 rotations in turn.
// - A round: each lane loads its row and its partner's, and computes its
//   pair's (c, s, t) from a_pp, a_qq and a_pq, the lower index as p (ep_rot:
//   scaled, then the special-function unit's reciprocal square root and
//   reciprocal, ~120 cycles where IEEE divides and square roots took
//   ~500). The pair's two lanes do so from the same values in the same
//   order (a stays bitwise symmetric, below), so they agree bit for bit.
//   Each lane publishes (c, σ) of its index (σ = −s for p, +s for q; 1, 0
//   for the index that sits out), __syncwarp, then rewrites its row from
//   the old rows' 2 x 2 blocks: a'_ij = (c_i·c_j)·a_ij + (σ_i·σ_j)·a_i'j' +
//   ((c_i·σ_j)·a_ij' + (σ_i·c_j)·a_i'j), i' and j' the partners, each
//   product and sum rounded on its own (no fused multiply-add), which
//   gives a'_ji the same bits; a'_pp = a_pp − t·a_pq, a'_qq = a_qq +
//   t·a_pq, a'_pq = 0 (Golub and Van Loan's sym.schur2). V's rows rotate
//   in registers: v'_x = c_x·v_x + σ_x·v_x'. The new row is stored, then
//   __syncwarp: two barriers a round, no atomics.
// - The convergence test once a sweep: Σ_{i≠j} a_ij² ≤ 2⁻⁴⁸·‖a‖²_F
//   (off ≤ 2⁻²⁴·‖a‖_F), each row's sum published and the nine added in
//   one order, at most EP_SWEEPS sweeps. A matrix that has converged is
//   frozen (its lanes go on through the rounds and store nothing) until
//   every matrix of the warp has, so a matrix's result depends neither on
//   its neighbours, nor on its place in the batch, nor on N.
// - M is scaled by a power of two first (exact), so no square over- or
//   underflows in the norms whatever M's scale. Jacobi's rotations are
//   orthogonal and each eigenvector comes out with an error of the order
//   of ε·‖M‖ / (its eigengap): no tridiagonal reduction, no pivoting.
// - f is V's column at the smallest diagonal entry (the first of equal
//   ones). v₃ from a one-sided (Hestenes) Jacobi on F's columns, not from
//   an eigensolve of FᵀF, which would square F's condition number: the
//   columns of F·W are made orthogonal by plane rotations W, and v₃ is the
//   column of W whose column of F·W is shortest. This 3 x 3 solve is cheap
//   and runs on each of the matrix's lanes alike.
// - A warp stages its three matrices through shared memory, every load in
//   flight before the first store, so that device memory is read
//   coalesced (243 consecutive floats), and lane i writes entry i of its
//   matrix's F₂ and f (27 consecutive floats a warp).
// Deterministic: a fixed order of rotations and of every sum, no atomics.
// Its time by parts on an H100 80GB HBM3 at 700 W (kernel_variants' ep_*
// variants, N = 1,792): a fixed ~3 µs (launch, staging, scaling, the
// 3 x 3 solve, stores), then ~2.6 µs a sweep, of which the rotations
// ~0.3: the round's two exchanges and its row update set the time.
//
// Plain C ABI (bound with ctypes): the launcher returns the cudaError_t of
// its launch and launches on the caller's stream.

#include "common.cuh"

namespace {

constexpr int EP_THREADS = 32;                   // a block: one warp
constexpr int EP_MATS = 3;                       // matrices a warp
constexpr int EP_GROUPS = 4;                     // the three, and lanes 27-31
constexpr int EP_STAGE = (EP_MATS * 81 + EP_THREADS - 1) / EP_THREADS;
constexpr int EP_ROW = 12;                       // a row of a: three float4
// Shared memory: the staged M of the three matrices (row-major, 243
// floats); then a region of each group: a's rows (nine at EP_ROW
// strides, 16-byte aligned: conflict-free 16-byte loads), the published
// (c, σ) of each index, three reduction slots of nine (the row maxima,
// norms and off-diagonal sums; the finite flags, then the diagonal; the
// eigenvector).
constexpr int EP_M = 0;
constexpr int EP_A = 256;
constexpr int EP_CS = EP_A + EP_GROUPS * 9 * EP_ROW;
constexpr int EP_R1 = EP_CS + EP_GROUPS * 18;
constexpr int EP_R2 = EP_R1 + EP_GROUPS * 9;
constexpr int EP_R3 = EP_R2 + EP_GROUPS * 9;
constexpr int EP_SMEM = (EP_R3 + EP_GROUPS * 9) * 4;
constexpr int EP_SWEEPS = 16;                    // cap of the 9 x 9 sweeps
constexpr int EP_SWEEPS3 = 10;                   // cap of the 3 x 3 sweeps
// Jacobi stops once Σ_{i≠j} a_ij² ≤ EP_OFF2 · ‖a‖²_F (off ≤ 2⁻²⁴·‖a‖_F).
constexpr float EP_OFF2 = 3.5527137e-15f;        // 2⁻⁴⁸
// The one-sided Jacobi leaves a column pair once |g_i·g_j| ≤ EP_ORTHO ·
// ‖g_i‖·‖g_j‖ (a few f32 roundings: a tighter test would chase rounding).
constexpr float EP_ORTHO = 4.7683716e-07f;       // 2⁻²¹
constexpr float EP_FLT_MAX = 3.40282347e+38f;
constexpr unsigned EP_WARP = 0xffffffffu;

// The index paired with x in round r of the round-robin order on 0-8 and
// a dummy: r sits out (its own partner here), any other x plays
// (2r − x) mod 9. Over r = 0..8 every pair meets once.
__host__ __device__ constexpr int ep_partner(int x, int r) {
  return x == r ? x : (2 * r - x + 9) % 9;
}

// The special-function unit's reciprocal square root and reciprocal
// (within about an ulp; their arguments here are normal, so the flush of
// subnormals never applies). A host build that emulates the kernels
// (tests/cuda_emulation) takes them correctly rounded.
#ifdef EKF_HOST_EMULATION
__device__ __forceinline__ float ep_rsqrt(float x) { return 1.f / sqrtf(x); }
__device__ __forceinline__ float ep_rcp(float x) { return 1.f / x; }
#else
__device__ __forceinline__ float ep_rsqrt(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float ep_rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
#endif

// (c, s, t) of the plane rotation that zeroes the off-diagonal entry of a
// symmetric 2 x 2 [[x, y], [y, z]], from d = z − x and h = 2·y ≠ 0:
// t = tan θ = sign(d)·h / (|d| + √(d² + h²)), the smaller root of
// t² + 2·(d/h)·t − 1 = 0 (Golub and Van Loan's sym.schur2), c = 1/√(1 + t²),
// s = t·c. d and h are first scaled by the power of two that brings the
// larger into [1, 2) (exact; no square over- or underflows, whatever the
// scale), then the square roots and the quotient come from ep_rsqrt and
// ep_rcp, c refined by one Newton step: t within a few ulps, which sets
// only how nearly the entry vanishes (it is then set to 0), and
// c² + s² = 1 within about an ulp, which keeps the rotations orthogonal.
// Four IEEE divides and two IEEE square roots in a chain cost ~500 cycles;
// this ~120.
__device__ __forceinline__ void ep_rot(float d, float h, float& c, float& s,
                                       float& t) {
  const int e = (__float_as_int(fmaxf(fabsf(d), fabsf(h))) >> 23) & 0xff;
  const float sc = __int_as_float((254 - e) << 23);
  const float d1 = d * sc, h1 = h * sc;
  const float x = fmaf(d1, d1, h1 * h1);
  t = copysignf(1.f, d) * h1 * ep_rcp(fmaf(x, ep_rsqrt(x), fabsf(d1)));
  const float y = fmaf(t, t, 1.f), c0 = ep_rsqrt(y);
  c = c0 * fmaf(-0.5f * y * c0, c0, 1.5f);
  s = t * c;
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
        if (!(ga * ga > EP_ORTHO * EP_ORTHO * (al * be))) continue;
        rotated = true;
        float c, s, t;
        ep_rot(be - al, 2.f * ga, c, s, t);
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

// Row i of a (three 16-byte loads; entries 9-11 are padding).
__device__ __forceinline__ void ep_load_row(const float* A, int i,
                                            float (&a)[12]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 w = ld4(A + EP_ROW * i + 4 * k);
    a[4 * k] = w.x;
    a[4 * k + 1] = w.y;
    a[4 * k + 2] = w.z;
    a[4 * k + 3] = w.w;
  }
}

__device__ __forceinline__ void ep_store_row(float* A, int i,
                                             const float (&a)[9]) {
  float4* p = reinterpret_cast<float4*>(A + EP_ROW * i);
  p[0] = make_float4(a[0], a[1], a[2], a[3]);
  p[1] = make_float4(a[4], a[5], a[6], a[7]);
  p[2] = make_float4(a[8], 0.f, 0.f, 0.f);
}

// One round r of the parallel order on the matrix whose row i this lane
// rewrites (A its rows in shared memory, cs its published (c, σ), v the
// lane's row of V). A frozen matrix keeps its rows and V.
template <int r>
__device__ __forceinline__ void ep_round(float (&v)[9], float* A, float2* cs,
                                         int i, int ip, bool frozen) {
  float a[12], b[12];                 // this row and the partner's, a_i· a_i'·
  ep_load_row(A, i, a);
  ep_load_row(A, ip, b);
  const float dg = A[EP_ROW * i + i], dq = A[EP_ROW * ip + ip];
  const float apq = A[EP_ROW * i + ip];
  const bool lo = i < ip;             // this lane holds the pair's p
  float c, s, t;
  ep_rot(lo ? dq - dg : dg - dq, 2.f * apq, c, s, t);
  if (ip == i || apq == 0.f) {        // the index that sits out: J = I
    c = 1.f;
    s = t = 0.f;
  }
  const float sg = lo ? -s : s;
  cs[i] = make_float2(c, sg);
  __syncwarp(EP_WARP);
  // The new row: for a column pair (p, q) with (c_P, s_P) as its q lane
  // published them (σ_p = −s_P, σ_q = s_P), the four products of this
  // row's (c, σ) with them, formed once and negated where σ_p enters.
  float an[9], cv[9], sv[9];
#pragma unroll
  for (int x = 0; x < 9; ++x) {
    const int xp = ep_partner(x, r);
    if (x == xp) {                    // the column that sits out: (1, 0)
      an[x] = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(c, 1.f), a[x]),
                    __fmul_rn(__fmul_rn(sg, 0.f), b[x])),
          __fadd_rn(__fmul_rn(__fmul_rn(c, 0.f), a[x]),
                    __fmul_rn(__fmul_rn(sg, 1.f), b[x])));
    } else if (x < xp) {
      const float2 w = cs[xp];
      const float kcc = __fmul_rn(c, w.x), kss = __fmul_rn(sg, w.y);
      const float kcs = __fmul_rn(c, w.y), ksc = __fmul_rn(sg, w.x);
      an[x] = __fadd_rn(
          __fadd_rn(__fmul_rn(kcc, a[x]), __fmul_rn(-kss, b[xp])),
          __fadd_rn(__fmul_rn(-kcs, a[xp]), __fmul_rn(ksc, b[x])));
      an[xp] = __fadd_rn(
          __fadd_rn(__fmul_rn(kcc, a[xp]), __fmul_rn(kss, b[x])),
          __fadd_rn(__fmul_rn(kcs, a[x]), __fmul_rn(ksc, b[xp])));
      cv[x] = cv[xp] = w.x;
      sv[x] = -w.y;
      sv[xp] = w.y;
    }
  }
  if (!frozen) {                      // every read of the old rows is done
    ep_store_row(A, i, an);
    A[EP_ROW * i + ip] = 0.f;         // the pair's own entries, last
    A[EP_ROW * i + i] = fmaf(lo ? -t : t, apq, dg);
#pragma unroll
    for (int x = 0; x < 9; ++x) {
      const int xp = ep_partner(x, r);
      if (x < xp) {
        const float vp = v[x], vq = v[xp];
        v[x] = cv[x] * vp + sv[x] * vq;
        v[xp] = cv[xp] * vq + sv[xp] * vp;
      }
    }
  }
  __syncwarp(EP_WARP);
}

template <int r>
__device__ __forceinline__ void ep_rounds(float (&v)[9], float* A, float2* cs,
                                          int i, const int (&ips)[9],
                                          bool frozen) {
  if constexpr (r < 9) {
    ep_round<r>(v, A, cs, i, ips[r], frozen);
    ep_rounds<r + 1>(v, A, cs, i, ips, frozen);
  }
}

__global__ void __launch_bounds__(EP_THREADS)
    ep_kernel(const float* __restrict__ M, float* __restrict__ F2,
              float* __restrict__ fv, int N) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x;
  const int g = lane / 9, i = lane - 9 * g;  // matrix g of the warp, row i
  const int n0 = blockIdx.x * EP_MATS;
  const int nb = min(EP_MATS, N - n0);
  const bool valid = g < nb;
  const float* Mg = sm + EP_M + 81 * g;
  float* A = sm + EP_A + 9 * EP_ROW * g;
  float2* cs = reinterpret_cast<float2*>(sm + EP_CS + 18 * g);
  float* r1 = sm + EP_R1 + 9 * g;
  float* r2 = sm + EP_R2 + 9 * g;
  float* r3 = sm + EP_R3 + 9 * g;
  // Stage the warp's matrices (zeros past N), every load in flight before
  // the first store.
  const float* src = M + static_cast<size_t>(n0) * 81;
  float st[EP_STAGE];
#pragma unroll
  for (int u = 0; u < EP_STAGE; ++u) {
    const int k = EP_THREADS * u + lane;
    st[u] = k < nb * 81 ? src[k] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < EP_STAGE; ++u) {
    const int k = EP_THREADS * u + lane;
    if (k < EP_MATS * 81) sm[EP_M + k] = st[u];
  }
  __syncwarp(EP_WARP);
  float row[9], col[9], rmax = 0.f;
  bool rfin = true;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    row[j] = valid ? Mg[9 * i + j] : 0.f;
    col[j] = valid ? Mg[9 * j + i] : 0.f;
    const float x = fabsf(row[j]);
    rfin = rfin && x <= EP_FLT_MAX;
    rmax = x > rmax ? x : rmax;
  }
  r1[i] = rmax;
  r2[i] = rfin ? 1.f : 0.f;
  __syncwarp(EP_WARP);
  float amax = 0.f;
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    amax = fmaxf(amax, r1[k]);
    finite = finite && r2[k] == 1.f;
  }
  int e = 0;
  frexpf(amax, &e);
  const float sc = finite && amax > 0.f ? ldexpf(1.f, -e) : 1.f;  // |m|·sc<1
  float a[9], v[9], fro = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    a[j] = finite ? __fmul_rn(0.5f, __fadd_rn(__fmul_rn(row[j], sc),
                                              __fmul_rn(col[j], sc)))
                  : 0.f;
    v[j] = j == i ? 1.f : 0.f;
    fro = fmaf(a[j], a[j], fro);
  }
  ep_store_row(A, i, a);
  __syncwarp(EP_WARP);                // every lane has read r1
  r1[i] = fro;
  __syncwarp(EP_WARP);
  float fro2 = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) fro2 += r1[k];
  const float tol2 = EP_OFF2 * fro2;
  int ips[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) ips[r] = ep_partner(i, r);
  bool done = !(valid && finite);
#pragma unroll 1
  for (int sweep = 0; sweep < EP_SWEEPS; ++sweep) {
    float ar[12], off = 0.f;
    ep_load_row(A, i, ar);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float x = j == i ? 0.f : ar[j];
      off = fmaf(x, x, off);
    }
    __syncwarp(EP_WARP);              // the last reads of r1 are done
    r1[i] = off;
    __syncwarp(EP_WARP);
    float off2 = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) off2 += r1[k];
    done = done || off2 <= tol2;
    if (__all_sync(EP_WARP, done)) break;
    ep_rounds<0>(v, A, cs, i, ips, done);
  }
  // f: V's column at the smallest diagonal entry, the first of equal ones.
  r2[i] = A[EP_ROW * i + i];
  __syncwarp(EP_WARP);
  float best = r2[0];
  int kb = 0;
#pragma unroll
  for (int k = 1; k < 9; ++k)
    if (r2[k] < best) {
      best = r2[k];
      kb = k;
    }
  float fk = v[0];
#pragma unroll
  for (int x = 1; x < 9; ++x) fk = x == kb ? v[x] : fk;
  r3[i] = fk;
  __syncwarp(EP_WARP);
  float f[9], out[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = r3[k];
  ep_rank2(f, out);
  float o2 = out[0], of = f[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    o2 = k == i ? out[k] : o2;
    of = k == i ? f[k] : of;
  }
  if (!finite) o2 = of = __uint_as_float(0x7fc00000u);
  if (valid) {
    const size_t o = (static_cast<size_t>(n0) + g) * 9 + i;
    F2[o] = o2;
    if (fv != nullptr) fv[o] = of;    // the eigenvectors, for a check
  }
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
  return launch(fn, dim3((N + EP_MATS - 1) / EP_MATS), EP_SMEM, args,
                static_cast<cudaStream_t>(stream), EP_THREADS);
}

}  // extern "C"
