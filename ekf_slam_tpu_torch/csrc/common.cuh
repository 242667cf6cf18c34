// Device helpers shared by the covariance kernels (fused_cov.cu,
// unfused_cov.cu): the tile geometry, the thread layout, loads and stores
// of P in its storage type (f32 or bf16: upcast on load, one
// round-to-nearest-even on store), staging of operand blocks into shared
// memory, the tile's pair of rank-R sums (column or row factors), the P·Hᵀ
// stripe accumulation, and the launch helper.
//
// Thread layout: 256 threads, thread (tx, ty) owns column tx and the four
// consecutive rows 4·ty .. 4·ty+3 of a TILE x TILE tile. Row-side operands
// sit in shared memory transposed ([k][row]), so one 16-byte load feeds
// four rows; the column-side operand is one scalar per k.
//
// Each .cu includes this header once; everything here has internal
// linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int NT = 256;                 // threads per block
constexpr int RPT = 4;                  // rows per thread (TILE·TILE / NT)
constexpr int LD = TILE + 1;            // leading dim of [row][col] tiles
constexpr int LDT = TILE + 4;           // leading dim of [k][row] buffers
constexpr int MC = 32;                  // contraction chunk of pair_sums
constexpr int MAX_CG = 8;               // column groups of 32: 256 columns

struct Tid {
  int tx, r0;                           // column, first of the 4 rows
};

__device__ __forceinline__ Tid tid() {
  return {static_cast<int>(threadIdx.x) % TILE,
          RPT * (static_cast<int>(threadIdx.x) / TILE)};
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// An element of P (or of any operand) as f32, and an f32 stored in P's
// type: bf16 rounds to nearest, ties to even.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copy a (rows x cols) block of a row-major matrix with leading dim `ld`,
// starting at (r0, c0), into smem (f32) with leading dim `sld`; entries
// outside (nrows, ncols) read as 0. transpose: store element (rr, cc) at
// dst[cc * sld + rr]. T is float or __nv_bfloat16 (upcast on the way).
template <typename T>
__device__ void stage(float* dst, int sld, const T* src, int ld, int r0,
                      int c0, int rows, int cols, int nrows, int ncols,
                      bool transpose = false) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += NT) {
    const int rr = idx / cols, cc = idx % cols;
    const int gr = r0 + rr, gc = c0 + cc;
    const float v = (gr < nrows && gc < ncols)
                        ? to_f32(src[static_cast<size_t>(gr) * ld + gc])
                        : 0.f;
    dst[transpose ? cc * sld + rr : rr * sld + cc] = v;
  }
}

// The pair of rank-R sums of tile (i0, j0) for two (D x R) factors X, Y:
//   a[q] = Σ_k X[row][k]·Y[col][k],   b[q] = Σ_k Y[row][k]·X[col][k],
// each a sequential fmaf chain in k order over MC-wide chunks (entries past
// R stage as 0 and add nothing). So b of entry (r, c) is the same chain of
// the same products as a of entry (c, r): the (i,j) and (j,i) tiles are
// float-exact mirrors. The row side (X_i, Y_i) is staged [k][row], the
// column side [col][k]; four MC x TILE buffers.
__device__ void pair_sums(const float* X, const float* Y, int D, int R,
                          int i0, int j0, float* sXi, float* sYi, float* sXj,
                          float* sYj, float (&a)[RPT], float (&b)[RPT]) {
  const Tid t = tid();
#pragma unroll
  for (int q = 0; q < RPT; ++q) a[q] = b[q] = 0.f;
  for (int m0 = 0; m0 < R; m0 += MC) {
    stage(sXi, LDT, X, R, i0, m0, TILE, MC, D, R, true);
    stage(sYi, LDT, Y, R, i0, m0, TILE, MC, D, R, true);
    stage(sXj, LD, X, R, j0, m0, TILE, MC, D, R);
    stage(sYj, LD, Y, R, j0, m0, TILE, MC, D, R);
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < MC; ++mm) {
      const float xj = sXj[t.tx * LD + mm];
      const float yj = sYj[t.tx * LD + mm];
      const float4 xi = ld4(sXi + mm * LDT + t.r0);
      const float4 yi = ld4(sYi + mm * LDT + t.r0);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        a[q] = fmaf(at(xi, q), yj, a[q]);
        b[q] = fmaf(at(yi, q), xj, b[q]);
      }
    }
    __syncthreads();
  }
}

// The same pair of sums for two (R x D) ROW factors Xt, Yt (the row-form
// update's At, Bt):
//   a[q] = Σ_k Xt[k][row]·Yt[k][col],   b[q] = Σ_k Yt[k][row]·Xt[k][col],
// in the same fixed k order, so again b of (r, c) is a of (c, r) product
// for product. A factor row is contiguous along D, so all four MC x TILE
// blocks stage straight ([k][row] and [k][col], ld LDT): coalesced loads,
// no transposed staging; a warp then reads 32 consecutive [k][col] words.
__device__ void pair_sums_rows(const float* Xt, const float* Yt, int D,
                               int R, int i0, int j0, float* sXi, float* sYi,
                               float* sXj, float* sYj, float (&a)[RPT],
                               float (&b)[RPT]) {
  const Tid t = tid();
#pragma unroll
  for (int q = 0; q < RPT; ++q) a[q] = b[q] = 0.f;
  for (int m0 = 0; m0 < R; m0 += MC) {
    stage(sXi, LDT, Xt, D, m0, i0, MC, TILE, R, D);
    stage(sYi, LDT, Yt, D, m0, i0, MC, TILE, R, D);
    stage(sXj, LDT, Xt, D, m0, j0, MC, TILE, R, D);
    stage(sYj, LDT, Yt, D, m0, j0, MC, TILE, R, D);
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < MC; ++mm) {
      const float xj = sXj[mm * LDT + t.tx];
      const float yj = sYj[mm * LDT + t.tx];
      const float4 xi = ld4(sXi + mm * LDT + t.r0);
      const float4 yi = ld4(sYi + mm * LDT + t.r0);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        a[q] = fmaf(at(xi, q), yj, a[q]);
        b[q] = fmaf(at(yi, q), xj, b[q]);
      }
    }
    __syncthreads();
  }
}

// Product stripe accumulation: acc[q][cg] += Σ_k T[row q][k]·H[k][col] for
// k < kmax and the columns col = tx + TILE·cg < R, with T staged
// transposed in sTt ([k][row], ld LDT) and H in sH ([k][col], ld R ≤ 256).
__device__ void accumulate_pht(float (&acc)[RPT][MAX_CG], const float* sTt,
                               const float* sHt, int R, int kmax) {
  const Tid t = tid();
  const int ncg = (R + TILE - 1) / TILE;
  for (int k = 0; k < kmax; ++k) {
    const float4 tv = ld4(sTt + k * LDT + t.r0);
#pragma unroll
    for (int cg = 0; cg < MAX_CG; ++cg) {
      if (cg < ncg) {
        const int c = t.tx + TILE * cg;
        const float hv = c < R ? sHt[k * R + c] : 0.f;
#pragma unroll
        for (int q = 0; q < RPT; ++q)
          acc[q][cg] = fmaf(at(tv, q), hv, acc[q][cg]);
      }
    }
  }
}

// Round a shared-memory offset (in floats) up to a 16-byte boundary.
__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

cudaError_t launch(const void* fn, dim3 grid, size_t smem, void** args,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(fn, grid, dim3(NT), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
