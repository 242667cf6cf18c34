// K7 — the NCC matcher's correlation numerator for Hopper (sm_90a), in two
// forms built from one kernel template.
// Replaces ekf_slam_tpu/ops/pallas_kernels.py ncc_corr (_ncc_corr_kernel):
// for N (window, zero-mean template) pairs,
//   corr[n][oy][ox] = Σ_{dy,dx} win[n][oy+dy][ox+dx] · tm[n][dy][dx],
// win (N, W2, W2), tm (N, t, t), corr (N, R2, R2), R2 = W2 − t + 1, all f32
// row-major. The second form, the one the image path runs, also forms the
// NCC norms of the same windows from the same staging (the JAX function
// computes them around its Pallas call with XLA ops,
// ekf_slam_tpu/vision/ncc.py:142-150; the port's plain version with
// integral images, ops/kernels.py ncc_corr_norms_plain):
//   var[n][oy][ox] = max(Σ_patch wc² − (Σ_patch wc)² / t², 0),
//   energy[n]      = Σ_window wc²,   wc = win − mean(win[n]).
//
// Bound on the H100 at the pixels-bench size (N = 3,200 = B 32 · CAP 100,
// W2 = 37, t = 13, R2 = 25): the correlation's 2·N·R2²·t² = 676 MFLOP,
// 10.1 µs at the 67 TFLOP/s f32 peak, against 27.7 MB moved (8.3 µs at
// 3.35 TB/s); the norms add at least 145 MFLOP and 8 MB (chip_smoke.FLOPS).
// The operations bind.
//
// What the design does about it:
// - Register blocking. A thread owns a TY x TX micro-tile of neighbouring
//   offsets (5 x 5: a pair's 25 x 25 offsets are 25 threads). It walks the
//   TY + t − 1 window rows its tile touches; each row is loaded from shared
//   memory once (TX + t − 1 values, held in registers) and serves every
//   tile row ty whose template row dy = j − ty exists, TX·t FMAs each, the
//   template row read as 16-byte broadcasts. At t = 13: 17 + 4·5 shared
//   loads for 325 FFMAs a window row, against two loads an FMA in the
//   first design (one offset a thread). t = 13 is compiled unrolled
//   (K7_T); any other t runs the same loop with runtime bounds.
// - Fixed sum order. Each offset's t² taps run dy-major, dx-minor from 0,
//   one fmaf each (the Pallas kernel's and the plain version's order):
//   deterministic, no atomics. f32 on CUDA cores: no TF32, no tensor cores.
// - Staging. A block takes a group of pb pairs (pb·tiles ≤ 128 threads),
//   their windows and templates copied from device memory once, 4 bytes a
//   cp.async (a window starts at any 4-byte offset), into padded rows: an
//   odd row pitch, so the 25 tiles of a pair read 25 different banks. The
//   grid is as many blocks as the card holds at once, each walking groups
//   g, g + gridDim.x, ...; at the bench that is one group a block. One
//   staging buffer: a second, for the next group under this one's
//   multiply, halves the resident blocks and measured slower.
// - Norms from the staged window (second form): each pair's mean, then its
//   Σwc², as row totals (four interleaved partial sums a row) summed in
//   order; then each tile thread, in a second pass over its window rows,
//   forms the sums of wc and wc² over t columns at its TX columns and adds
//   t of them down each column. Each is a direct sum of its own t terms
//   (window_sums shares the block common to the TX columns): no running
//   (subtract-the-tail) sums, which in f32 drift as integral images do,
//   whose cancellation forced the centring (vision/ncc.py). Nothing but
//   the row totals goes to shared memory, and the register budget keeps
//   five 128-thread blocks an SM (K7_SM_THREADS).
// Ragged tiles and groups compute into padding and are masked on store.
//
// Plain C ABI (bound with ctypes): each launcher returns the cudaError_t of
// its launch and launches on the caller's stream.

#include "common.cuh"

namespace {

// The design's choices.
constexpr int K7_TY = 5, K7_TX = 5;     // a thread's micro-tile of offsets
constexpr int K7_THREADS = 128;         // threads a block
constexpr int K7_T = 13;                // the template width compiled unrolled
constexpr int K7_SM_THREADS = 640;      // register budget: threads an SM

// One launch's staged layout, computed by the launcher.
struct K7Geo {
  int N, W2, t, R2;
  int tiles_x, tiles_y, tpp;  // micro-tiles along a row, a column, a pair
  int pb, groups;             // pairs a group, groups
  int wp, win_floats;         // window row pitch (odd), floats a window
  int tp, tm_floats;          // template row pitch (16-byte rows), a template
  int tm0, buf_floats;        // a buffer: pb windows, then from tm0 pb
                              // templates
};

// (p, y, x) of element i = threadIdx.x, + K7_THREADS, ... of a stack of
// rows x cols blocks, advanced by constant steps: no division in a loop.
struct Walk3 {
  int p, y, x, sp, sy, sx, rows, cols;
  __device__ Walk3(int rows_, int cols_) : rows(rows_), cols(cols_) {
    const int per = rows * cols, tid = static_cast<int>(threadIdx.x);
    p = tid / per;
    y = tid % per / cols;
    x = tid % cols;
    sp = K7_THREADS / per;
    sy = K7_THREADS % per / cols;
    sx = K7_THREADS % cols;
  }
  __device__ __forceinline__ void next() {
    x += sx;
    y += sy;
    p += sp;
    if (x >= cols) x -= cols, ++y;
    if (y >= rows) y -= rows, ++p;
  }
};

// Start copying `count` consecutive floats of src — stacked rows x cols
// blocks — to dst[p·bstride + y·pitch + x] (cp.async; awaited by
// cp_async_wait_all).
__device__ __forceinline__ void stage_blocks(float* dst, const float* src,
                                             int count, int rows, int cols,
                                             int pitch, int bstride) {
  Walk3 w(rows, cols);
  for (int i = threadIdx.x; i < count; i += K7_THREADS, w.next())
    cp_async4(dst + w.p * bstride + w.y * pitch + w.x, src + i, true);
}

// Group g's windows, then its templates, into staging buffer `buf`.
__device__ __forceinline__ void k7_stage(const float* win, const float* tm,
                                         float* buf, int g, const K7Geo& G) {
  const int n0 = g * G.pb, np = min(G.pb, G.N - n0);
  stage_blocks(buf, win + static_cast<size_t>(n0) * G.W2 * G.W2,
               np * G.W2 * G.W2, G.W2, G.W2, G.wp, G.win_floats);
  stage_blocks(buf + G.tm0,
               tm + static_cast<size_t>(n0) * G.t * G.t, np * G.t * G.t,
               G.t, G.t, G.tp, G.tm_floats);
}

// acc[ty][c] = Σ_{dy,dx} w0[(ty+dy)·wp + c+dx] · t0[dy·tp + dx], each a
// chain from 0 in dy-major, dx-minor order. w0: the tile's first window
// entry; t0: the template's (16-byte aligned rows of tp floats).
template <int T, int TY, int TX>
__device__ __forceinline__ void corr_tile(float (&acc)[TY][TX],
                                          const float* w0, const float* t0,
                                          int t, int wp, int tp) {
#pragma unroll
  for (int ty = 0; ty < TY; ++ty)
#pragma unroll
    for (int c = 0; c < TX; ++c) acc[ty][c] = 0.f;
#pragma unroll 1
  for (int j = 0; j < TY + t - 1; ++j) {
    const float* row = w0 + j * wp;
    if constexpr (T > 0) {
      float seg[TX + T - 1];
#pragma unroll
      for (int i = 0; i < TX + T - 1; ++i) seg[i] = row[i];
#pragma unroll
      for (int ty = 0; ty < TY; ++ty) {
        const int dy = j - ty;
        if (dy < 0 || dy >= T) continue;
        const float* tr = t0 + dy * tp;
#pragma unroll
        for (int k = 0; k < (T + 3) / 4; ++k) {
          const float4 q = ld4(tr + 4 * k);
          const float tq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int u = 0; u < 4 && 4 * k + u < T; ++u)
#pragma unroll
            for (int c = 0; c < TX; ++c)
              acc[ty][c] = fmaf(seg[c + 4 * k + u], tq[u], acc[ty][c]);
        }
      }
    } else {
#pragma unroll
      for (int ty = 0; ty < TY; ++ty) {
        const int dy = j - ty;
        if (dy < 0 || dy >= t) continue;
        const float* tr = t0 + dy * tp;
        for (int k = 0; 4 * k < t; ++k) {
          const float4 q = ld4(tr + 4 * k);
          const float tq[4] = {q.x, q.y, q.z, q.w};
          float seg[TX + 3];
#pragma unroll
          for (int i = 0; i < TX + 3; ++i)
            seg[i] = 4 * k + i < TX + t - 1 ? row[4 * k + i] : 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (4 * k + u < t)
#pragma unroll
              for (int c = 0; c < TX; ++c)
                acc[ty][c] = fmaf(seg[c + u], tq[u], acc[ty][c]);
        }
      }
    }
  }
}

// out[c] = Σ_{k<T} d[c + k] for c < TX, each a sum of its own T terms, no
// subtraction: the block d[TX−1 .. T−1] common to every c is added once,
// then the terms left of it (suffix sums) and right of it (prefix sums).
template <int T, int TX>
__device__ __forceinline__ void window_sums(const float (&d)[TX + T - 1],
                                            float (&out)[TX]) {
  static_assert(T >= TX, "a block of terms common to every column");
  float mid = d[TX - 1];
#pragma unroll
  for (int k = TX; k < T; ++k) mid += d[k];
  float left = 0.f, right = 0.f;
#pragma unroll
  for (int c = TX - 1; c >= 0; --c) {
    if (c < TX - 1) left = c == TX - 2 ? d[c] : d[c] + left;
    out[c] = c < TX - 1 ? left + mid : mid;
  }
#pragma unroll
  for (int c = 1; c < TX; ++c) {
    right = c == 1 ? d[T] : right + d[T + c - 1];
    out[c] += right;
  }
}

// The tile's patch variances (times t²), from the window w0 at its first
// offset (rows wp apart) less the pair's mean m: for each of the TY + t − 1
// window rows, the sums of wc and wc² over t columns at the tile's TX
// columns (window_sums), added down t rows in dy order for each offset;
// then max(sq − box²/t², 0).
template <int T, int TY, int TX>
__device__ __forceinline__ void var_tile(float (&v)[TY][TX], const float* w0,
                                         float m, int t, int wp) {
  float box[TY][TX], sq[TY][TX];
#pragma unroll
  for (int ty = 0; ty < TY; ++ty)
#pragma unroll
    for (int c = 0; c < TX; ++c) box[ty][c] = sq[ty][c] = 0.f;
#pragma unroll 1
  for (int j = 0; j < TY + t - 1; ++j) {
    const float* row = w0 + j * wp;
    float a[TX], b[TX];
    if constexpr (T > 0) {
      float d[TX + T - 1];
#pragma unroll
      for (int i = 0; i < TX + T - 1; ++i) d[i] = row[i] - m;
      window_sums<T, TX>(d, a);
#pragma unroll
      for (int i = 0; i < TX + T - 1; ++i) d[i] *= d[i];
      window_sums<T, TX>(d, b);
    } else {
#pragma unroll
      for (int c = 0; c < TX; ++c) {
        a[c] = b[c] = 0.f;
        for (int dx = 0; dx < t; ++dx) {
          const float d = row[c + dx] - m;
          a[c] += d;
          b[c] = fmaf(d, d, b[c]);
        }
      }
    }
#pragma unroll
    for (int ty = 0; ty < TY; ++ty) {
      const int dy = j - ty;
      if (dy < 0 || dy >= t) continue;
#pragma unroll
      for (int c = 0; c < TX; ++c) box[ty][c] += a[c], sq[ty][c] += b[c];
    }
  }
  const float tt = static_cast<float>(t * t);
#pragma unroll
  for (int ty = 0; ty < TY; ++ty)
#pragma unroll
    for (int c = 0; c < TX; ++c)
      v[ty][c] = fmaxf(sq[ty][c] - box[ty][c] * box[ty][c] / tt, 0.f);
}

// The tile's entries that lie inside the R2 x R2 output o.
template <int TY, int TX>
__device__ __forceinline__ void store_tile(float* o, const float (&v)[TY][TX],
                                           int oy0, int ox0, int R2) {
#pragma unroll
  for (int ty = 0; ty < TY; ++ty)
#pragma unroll
    for (int c = 0; c < TX; ++c)
      if (oy0 + ty < R2 && ox0 + c < R2)
        o[(oy0 + ty) * R2 + ox0 + c] = v[ty][c];
}

// Σ_{x<W2} f(r[x]) of one staged window row in a fixed order: four
// interleaved partial sums (independent chains), then their pairwise sum.
template <typename F>
__device__ __forceinline__ float row_total(const float* r, int W2, F f) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int x = 0;
  for (; x + 4 <= W2; x += 4)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] += f(r[x + k]);
  for (; x < W2; ++x) s[0] += f(r[x]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// Each staged row's total of f into rtot (np·W2 rows, a thread a row),
// then each pair's Σ_y rtot / div into out[p] (threads p < np). Ends
// synchronised.
template <typename F>
__device__ __forceinline__ void pair_totals(const float* sw, float* rtot,
                                            float* out, float div, int np,
                                            const K7Geo& G, F f) {
  const int W2 = G.W2;
  Walk3 w(W2, 1);
  for (int i = threadIdx.x; i < np * W2; i += K7_THREADS, w.next())
    rtot[i] = row_total(sw + w.p * G.win_floats + w.y * G.wp, W2,
                        [&](float x) { return f(x, w.p); });
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < np)
    out[threadIdx.x] = row_total(rtot + threadIdx.x * W2, W2,
                                 [](float x) { return x; }) / div;
  __syncthreads();
}

// One kernel, two forms: NORMS false writes corr; NORMS true also var and
// energy. T: the template width compiled unrolled, or 0 (t at run time).
template <int T, int TY, int TX, bool NORMS>
__global__ void __launch_bounds__(K7_THREADS, K7_SM_THREADS / K7_THREADS)
    k7_kernel(const float* __restrict__ win, const float* __restrict__ tm,
              float* __restrict__ corr, float* __restrict__ var,
              float* __restrict__ energy, K7Geo G) {
  extern __shared__ __align__(16) float sm[];
  const int t = T > 0 ? T : G.t;
  const int R2 = G.R2;
  float* const rtot = sm + G.buf_floats;        // norms: pb·W2 row totals
  float* const mean = rtot + up4(G.pb * G.W2);     // pb, then pb energies
  float* const esum = mean + G.pb;

  int g = blockIdx.x;
  if (g < G.groups) k7_stage(win, tm, sm, g, G);
  cp_async_wait_all();
  __syncthreads();
  for (; g < G.groups; g += gridDim.x) {
    const float* st = sm + G.tm0;
    const int n0 = g * G.pb, np = min(G.pb, G.N - n0);
    if constexpr (NORMS) {      // each pair's mean, then its Σwc²
      pair_totals(sm, rtot, mean, static_cast<float>(G.W2 * G.W2), np, G,
                  [](float x, int) { return x; });
      pair_totals(sm, rtot, esum, 1.f, np, G, [&](float x, int p) {
        const float d = x - mean[p];
        return d * d;
      });
      if (static_cast<int>(threadIdx.x) < np)
        energy[n0 + threadIdx.x] = esum[threadIdx.x];
    }
    Walk3 w(G.tiles_y, G.tiles_x);
    for (int i = threadIdx.x; i < np * G.tpp; i += K7_THREADS, w.next()) {
      const int oy0 = w.y * TY, ox0 = w.x * TX;
      const size_t out0 = static_cast<size_t>(n0 + w.p) * R2 * R2;
      const float* w0 = sm + w.p * G.win_floats + oy0 * G.wp + ox0;
      float v[TY][TX];
      corr_tile<T, TY, TX>(v, w0, st + w.p * G.tm_floats, t, G.wp, G.tp);
      store_tile(corr + out0, v, oy0, ox0, R2);
      if constexpr (NORMS) {
        var_tile<T, TY, TX>(v, w0, mean[w.p], t, G.wp);
        store_tile(var + out0, v, oy0, ox0, R2);
      }
    }
    if (g + gridDim.x < G.groups) {   // once every tile has read this group
      __syncthreads();
      k7_stage(win, tm, sm, g + gridDim.x, G);
      cp_async_wait_all();
      __syncthreads();
    }
  }
}

constexpr size_t K7_MAX_SMEM = 227 * 1024;

// The layout for N pairs of W2-wide windows and t-wide templates; false
// when one pair's staging does not fit shared memory.
template <bool NORMS>
bool k7_geometry(K7Geo& G, size_t& smem, int N, int W2, int t) {
  G.N = N, G.W2 = W2, G.t = t, G.R2 = W2 - t + 1;
  G.tiles_x = (G.R2 + K7_TX - 1) / K7_TX;
  G.tiles_y = (G.R2 + K7_TY - 1) / K7_TY;
  G.tpp = G.tiles_x * G.tiles_y;
  const int wrows = G.tiles_y * K7_TY + t - 1;
  G.wp = (G.tiles_x * K7_TX + t - 1) | 1;
  G.win_floats = up4(wrows * G.wp);
  G.tp = up4(t);
  G.tm_floats = t * G.tp;
  G.pb = K7_THREADS / G.tpp < 1 ? 1 : K7_THREADS / G.tpp;
  if (G.pb > N) G.pb = N;
  for (;; --G.pb) {
    G.tm0 = G.pb * G.win_floats;
    G.buf_floats = G.tm0 + G.pb * G.tm_floats;
    smem = sizeof(float) *
           (static_cast<size_t>(G.buf_floats) +
            (NORMS ? up4(G.pb * W2) + 2 * G.pb : 0));
    if (smem <= K7_MAX_SMEM || G.pb == 1) break;
  }
  G.groups = (N + G.pb - 1) / G.pb;
  return smem <= K7_MAX_SMEM;
}

template <int T, bool NORMS>
cudaError_t k7_launch(const float* win, const float* tm, float* corr,
                      float* var, float* energy, int N, int W2, int t,
                      cudaStream_t stream) {
  K7Geo G;
  size_t smem = 0;
  if (!k7_geometry<NORMS>(G, smem, N, W2, t)) return cudaErrorInvalidValue;
  const void* fn =
      reinterpret_cast<const void*>(k7_kernel<T, K7_TY, K7_TX, NORMS>);
  // The occupancy is asked with the limit in place (common.cuh: both once).
  cudaError_t err = smem_limit(fn, smem);
  int resident = 0;
  if (err == cudaSuccess)
    err = resident_blocks(fn, K7_THREADS, smem, resident);
  if (err != cudaSuccess) return err;
  const int grid = G.groups < resident ? G.groups : resident;
  void* args[] = {&win, &tm, &corr, &var, &energy, &G};
  return launch(fn, dim3(grid), smem, args, stream, K7_THREADS);
}

template <bool NORMS>
cudaError_t k7_dispatch(const float* win, const float* tm, float* corr,
                        float* var, float* energy, int N, int W2, int t,
                        void* stream) {
  if (N < 1 || t < 1 || t > W2) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return t == K7_T
             ? k7_launch<K7_T, NORMS>(win, tm, corr, var, energy, N, W2, t, s)
             : k7_launch<0, NORMS>(win, tm, corr, var, energy, N, W2, t, s);
}

}  // namespace

extern "C" {

// K7, the correlation. win (N,W2,W2); tm (N,t,t); out (N,R2,R2).
// Contiguous row-major f32. 1 <= t <= W2, and one pair's staging must fit
// a block's shared memory (W2 up to about 160); else
// cudaErrorInvalidValue.
cudaError_t ekf_k7_ncc_corr(const float* win, const float* tm, float* out,
                            int N, int W2, int t, void* stream) {
  return k7_dispatch<false>(win, tm, out, nullptr, nullptr, N, W2, t, stream);
}

// K7 with the norms: corr and var (N,R2,R2), energy (N), as above.
cudaError_t ekf_k7_ncc_corr_norms(const float* win, const float* tm,
                                  float* corr, float* var, float* energy,
                                  int N, int W2, int t, void* stream) {
  return k7_dispatch<true>(win, tm, corr, var, energy, N, W2, t, stream);
}

}  // extern "C"
