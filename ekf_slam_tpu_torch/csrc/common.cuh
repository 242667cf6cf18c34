// Device helpers shared by the covariance kernels (fused_cov.cu,
// unfused_cov.cu): loads and stores of P in its storage type (f32 or bf16:
// upcast on load, one round-to-nearest-even on store), the launch helper
// with its once-per-kernel setup, and the building blocks of every covariance kernel (K1-K6, K8).
//
// The register-blocked panel product, designed for the H100's CUDA cores:
// acc[r][c] += Σ_k X[k][r]·Y[k][c] from a [k][row] panel and a [k][col]
// panel in shared memory (panel_fma), each thread a TM x TN micro-tile
// (8 x 8: 64 FMAs for four 16-byte shared loads a k), the k loop over a
// compile-time BK and fully unrolled, no predicate in it (ragged edges are
// staged as zeros). panel_product runs it over the contraction through a
// two-stage ring in shared memory: the loads of tile t+1 are started
// before tile t is multiplied (cp.async for f32 sources; a bf16 source,
// 2-byte aligned on odd rows and so below cp.async's 4-byte minimum, goes
// through registers: ld.global before the multiply, convert and st.shared
// after) — one __syncthreads a tile. Sums are IEEE fmaf chains in k order:
// deterministic, no atomics, no tensor cores. store_tile_pair is the
// mirrored epilogue of a symmetric update: one accumulator tile written to
// the (i, j) tile and, transposed through shared memory, to the (j, i)
// tile, both coalesced; the tiles of P it adds to are fetched by bulk
// copies (PTile) that land under the product.
//
// Each .cu includes this header once; everything here has internal
// linkage except the declaration of K6's launcher (unfused_cov.cu), whose
// product K1 and K2 (fused_cov.cu) run as their P·Hᵀ half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

constexpr int NT = 256;                 // threads a block: K7, launch()

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

// --- the register-blocked panel product ---------------------------------

constexpr int BK = 8;                   // contraction depth of a ring stage

// A BM x BN output tile over THREADS = (BM/TM)·(BN/TN) threads. Thread
// (tx, ty) owns TM x TN entries in groups of four: rows 4·ty .. 4·ty+3 of
// every 4·TYN-row band and columns 4·tx .. 4·tx+3 of every 4·TXN-column
// band, so a warp's 16-byte loads of one band touch consecutive words (no
// bank conflict) and threads of one ty (tx) share a load by broadcast.
// REGS is the thread's register budget: __launch_bounds__ asks for the
// 65,536 / (REGS·THREADS) blocks an SM that it allows.
template <int BM_, int BN_, int TM_, int TN_, int REGS = 128>
struct Blocking {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int TXN = BN / TN, TYN = BM / TM, THREADS = TXN * TYN;
  static constexpr int MIN_BLOCKS = 65536 / (REGS * THREADS);
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BM % TM == 0 && BN % TN == 0 &&
                    THREADS % 32 == 0,
                "micro-tiles in groups of four, whole warps");
  __device__ static int tx() { return static_cast<int>(threadIdx.x) % TXN; }
  __device__ static int ty() { return static_cast<int>(threadIdx.x) / TXN; }
  __device__ static int row(int q) {
    return (q / 4) * 4 * TYN + 4 * ty() + q % 4;
  }
  __device__ static int col(int p) {
    return (p / 4) * 4 * TXN + 4 * tx() + p % 4;
  }
};

// --- asynchronous copies (PTX) ------------------------------------------------
// Two kinds. cp.async moves 4 bytes a thread global -> shared and a thread
// waits for ALL the copies it has started. Hopper's bulk copy moves whole
// 16-byte lines and reports the bytes to an mbarrier in shared memory; it
// shares nothing with cp.async's bookkeeping, so a block can keep one in
// flight through a whole panel_product and wait for it afterwards. A host
// build that emulates the kernels (tests/cuda_emulation) defines
// EKF_HOST_EMULATION and supplies the functions of this section itself.
#ifndef EKF_HOST_EMULATION

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy global -> shared; !ok writes 0 and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = smem_addr(dst);
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

// Wait for every cp.async copy this thread has started.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One thread: a barrier that `count` threads arrive at, once.
__device__ __forceinline__ void mbar_init(unsigned long long* mbar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(mbar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive, announcing `bytes` of bulk copies this thread has started.
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* mbar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(mbar)),
               "r"(bytes)
               : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(mbar))
      : "memory");
}

// Wait until every thread has arrived and every announced byte has landed;
// the copied data is then visible to the waiting thread.
__device__ __forceinline__ void mbar_wait(unsigned long long* mbar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(mbar))
        : "memory");
}

#endif  // EKF_HOST_EMULATION

// Loader of a [k][col] panel whose rows are rows of a row-major source
// (leading dim `ld`), columns col0 .. col0+BW−1. The contraction may run
// over two sources of `nrows` rows each, one after the other, each padded
// to whole BK-deep tiles: tiles 0 .. tiles0−1 read f0, the rest f1 (the
// concatenated contraction [At; Bt] of K8; K6's B has one source). Rows
// past nrows and columns past ncols stage as 0. A source row is
// contiguous, so a warp copies consecutive words. f32 only: cp.async,
// nothing held in registers. Per tile a thread forms one address; its
// COUNT elements lie KSTEP rows apart, at compile-time multiples of `ld`.
template <int BW, int THREADS>
struct RowPanel {
  static_assert(THREADS % BW == 0 && (BK * BW) % THREADS == 0,
                "a thread keeps one column; whole passes");
  static constexpr int LD = BW;
  static constexpr int KSTEP = THREADS / BW;
  static constexpr int COUNT = BK / KSTEP;
  const float* f0;
  const float* f1;
  int tiles0, nrows, ld, col, k0;
  bool col_ok;

  __device__ RowPanel(const float* f0_, const float* f1_, int tiles0_,
                      int nrows_, int ld_, int col0, int ncols)
      : f0(f0_), f1(f1_), tiles0(tiles0_), nrows(nrows_), ld(ld_),
        col(col0 + static_cast<int>(threadIdx.x) % BW),
        k0(static_cast<int>(threadIdx.x) / BW), col_ok(col < ncols) {}

  __device__ __forceinline__ void begin(int t, float* dst) {
    const bool second = t >= tiles0;
    const int k = (second ? t - tiles0 : t) * BK + k0;
    const float* p = (second ? f1 : f0) + static_cast<size_t>(k) * ld + col;
    dst += threadIdx.x;
#pragma unroll
    for (int it = 0; it < COUNT; ++it)
      cp_async4(dst + it * THREADS, p + it * KSTEP * ld,
                col_ok && k + it * KSTEP < nrows);
  }
  __device__ __forceinline__ void end(float*) {}
};

// Loader of a [k][row] panel from a row-major source whose ROWS are the
// panel's rows and whose columns are the contraction (K6's A = P; the
// column-form factors of K4 and K3/K5): element (row0 + r, t·BK + k) lands
// at dst[k·LD + r], a transposed store. A warp takes 4 rows x 8 k (lane =
// 4·k + r mod 4): with LD ≡ 4 mod 32 its 32 words fall in 32 banks, and
// panel_fma still reads 16 bytes along r. The source's rows may be
// unaligned (D = 613: 2,452 B in f32, 1,226 B in bf16), so every load is
// one element: f32 by cp.async; bf16 into registers at begin(), converted
// and stored at end(), after the multiply it overlaps. A thread keeps one
// k and rows RSTEP apart: one address a tile, the rest at compile-time
// multiples of `ld`. With SOURCES = 2 the contraction runs over two
// sources of `ncols` columns each (the same `ld`), one after the other,
// each padded to whole BK-deep tiles with zeros: tiles 0 .. tiles0−1 read
// the first, the rest the second (K4's [A | B], K3's [K | PHt]), as
// RowPanel does along its rows.
template <typename T, int BM, int THREADS, int SOURCES = 1>
struct ColPanel {
  static_assert(BK == 8 && THREADS % 32 == 0 && BM % (THREADS / 8) == 0,
                "lane map: 8 k x 4 rows a warp; whole passes");
  static_assert(SOURCES == 1 || SOURCES == 2, "one or two sources");
  static constexpr int LD = BM + 4;
  static constexpr int RSTEP = THREADS / 8;
  static constexpr int COUNT = BM / RSTEP;
  static constexpr bool ASYNC = sizeof(T) == 4;
  const T* src;                         // element (row0 + r0, k) of tile 0
  const T* src1;                        // the same in the second source
  int ld, r0, k, rows_left, ncols;      // rows_left: nrows − (row0 + r0)
  int tiles0;
  unsigned short held[COUNT];           // raw bf16 bits between begin and end

  __device__ ColPanel(const T* a, int ld_, int row0, int nrows, int ncols_)
      : ColPanel(a, a, 0, ld_, row0, nrows, ncols_) {}

  __device__ ColPanel(const T* a, const T* b, int tiles0_, int ld_, int row0,
                      int nrows, int ncols_)
      : ld(ld_),
        r0(((static_cast<int>(threadIdx.x) >> 5) << 2) |
           (static_cast<int>(threadIdx.x) & 3)),
        k((static_cast<int>(threadIdx.x) >> 2) & 7),
        rows_left(nrows - row0 - r0), ncols(ncols_), tiles0(tiles0_) {
    const size_t off = static_cast<size_t>(row0 + r0) * ld + k;
    src = a + off;
    src1 = b + off;
  }

  __device__ __forceinline__ void begin(int t, float* dst) {
    const T* base = src;
    if constexpr (SOURCES == 2) {
      if (t >= tiles0) {
        t -= tiles0;
        base = src1;
      }
    }
    const T* p = base + t * BK;
    const bool k_ok = t * BK + k < ncols;
    dst += k * LD + r0;
#pragma unroll
    for (int it = 0; it < COUNT; ++it) {
      const bool ok = k_ok && it * RSTEP < rows_left;
      const T* q = p + it * RSTEP * ld;
      if constexpr (ASYNC)
        cp_async4(dst + it * RSTEP, reinterpret_cast<const float*>(q), ok);
      else
        held[it] = ok ? *reinterpret_cast<const unsigned short*>(q)
                      : static_cast<unsigned short>(0);
    }
  }

  __device__ __forceinline__ void end(float* dst) {
    if constexpr (!ASYNC) {
      dst += k * LD + r0;
#pragma unroll
      for (int it = 0; it < COUNT; ++it)
        dst[it * RSTEP] =
            __uint_as_float(static_cast<unsigned>(held[it]) << 16);
    }
  }
};

// The microkernel: acc[q][p] += Σ_{k < BK} X[k][row(q)]·Y[k][col(p)] for
// this thread's micro-tile. sX, sY point at the thread's first row / column
// of the stage ([k][row], ld LDX; [k][col], ld LDY). One fmaf chain per
// entry, in k order.
template <typename G, int LDX, int LDY>
__device__ __forceinline__ void panel_fma(float (&acc)[G::TM][G::TN],
                                          const float* sX, const float* sY) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float x[G::TM], y[G::TN];
#pragma unroll
    for (int g = 0; g < G::TM / 4; ++g) {
      const float4 v = ld4(sX + k * LDX + g * 4 * G::TYN);
      x[4 * g] = v.x, x[4 * g + 1] = v.y, x[4 * g + 2] = v.z,
             x[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < G::TN / 4; ++g) {
      const float4 v = ld4(sY + k * LDY + g * 4 * G::TXN);
      y[4 * g] = v.x, y[4 * g + 1] = v.y, y[4 * g + 2] = v.z,
             y[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < G::TM; ++q)
#pragma unroll
      for (int p = 0; p < G::TN; ++p) acc[q][p] = fmaf(x[q], y[p], acc[q][p]);
  }
}

// Floats of the two-stage ring of panel_product.
template <typename LX, typename LY>
constexpr int ring_floats() {
  return 2 * BK * (LX::LD + LY::LD);
}

// acc = Xᵀ·Y over `ntiles` BK-deep tiles of the contraction, X staged by
// `lx` ([k][row]) and Y by `ly` ([k][col]) into the two-stage `ring`
// (ring_floats<LX, LY>() floats, 16-byte aligned): tile t+1's copies are
// started, then tile t is multiplied, then every copy the thread has started
// is awaited and the block synchronised. Every thread of the block calls
// this; on return all threads are past the last read of the ring (it may
// be reused at once).
template <typename G, typename LX, typename LY>
__device__ __forceinline__ void panel_product(float (&acc)[G::TM][G::TN],
                                              float* ring, int ntiles, LX& lx,
                                              LY& ly) {
  constexpr int XS = BK * LX::LD, STAGE = XS + BK * LY::LD;
#pragma unroll
  for (int q = 0; q < G::TM; ++q)
#pragma unroll
    for (int p = 0; p < G::TN; ++p) acc[q][p] = 0.f;
  lx.begin(0, ring);
  ly.begin(0, ring + XS);
  lx.end(ring);
  ly.end(ring + XS);
  cp_async_wait_all();
  __syncthreads();
  const float* fx = ring + 4 * G::ty();
  const float* fy = ring + XS + 4 * G::tx();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = (t & 1) * STAGE, nxt = STAGE - cur;
    const bool more = t + 1 < ntiles;
    if (more) {
      lx.begin(t + 1, ring + nxt);
      ly.begin(t + 1, ring + nxt + XS);
    }
    panel_fma<G, LX::LD, LY::LD>(acc, fx + cur, fy + cur);
    if (more) {
      lx.end(ring + nxt);
      ly.end(ring + nxt + XS);
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

constexpr int PT_TILE = 64;             // tile of the mirrored epilogue
constexpr int LDC = PT_TILE + 1;        // odd: transposed reads, no conflict

// A PT_TILE x PT_TILE tile of P (T: float or bf16) held raw in shared
// memory, fetched by bulk copies that land while the product runs, so the
// epilogue reads no global memory. P's rows start at any 2- or 4-byte
// offset (D odd) and a bulk copy moves aligned 16-byte lines: each row is
// copied as the lines that cover it — up to 15 bytes of its neighbours in
// the array on either side, which lie inside the allocation's 256-byte
// granule even at the array's ends — and at(r, c) skips the row's lead.
template <typename T>
struct PTile {
  static constexpr int LINE = 16 / static_cast<int>(sizeof(T));
  static constexpr int PITCH = PT_TILE + LINE;     // entries a row
  static constexpr int BYTES = PT_TILE * PITCH * static_cast<int>(sizeof(T));
  T* raw;
  int lead0, D;       // entries of row 0 before its first one in its line

  // Entry index, mod LINE, of P(r0 + r, c0) counted from address 0.
  __device__ static int lead(const T* P, int D, int r0, int c0, int r) {
    return static_cast<int>(
        (reinterpret_cast<size_t>(P + static_cast<size_t>(r0 + r) * D + c0) /
         sizeof(T)) % LINE);
  }

  __device__ PTile(void* raw_, const T* P, int D_, int r0, int c0)
      : raw(static_cast<T*>(raw_)), lead0(lead(P, D_, r0, c0, 0)), D(D_) {}

  // Entry (r, c) of the tile in shared memory: read by at(), and written in
  // place by a kernel that transforms the tile before its epilogue (K3).
  __device__ __forceinline__ T& ref(int r, int c) const {
    return raw[r * PITCH + ((lead0 + r * D) & (LINE - 1)) + c];
  }

  __device__ __forceinline__ float at(int r, int c) const {
    return to_f32(ref(r, c));
  }

  // Start this thread's share of the copies of tile (r0, c0) of P (D x D)
  // into `dst` (BYTES bytes, 16-byte aligned): row r by thread r mod
  // THREADS. Returns the bytes started, to be announced to `mbar`.
  template <int THREADS>
  __device__ static unsigned fetch(void* dst, const T* P, int D, int r0,
                                   int c0, unsigned long long* mbar) {
    const int nvalid = min(PT_TILE, D - c0);
    unsigned total = 0;
    for (int r = threadIdx.x; r < min(PT_TILE, D - r0); r += THREADS) {
      const int l = lead(P, D, r0, c0, r);
      const unsigned bytes = static_cast<unsigned>(
          (l + nvalid + LINE - 1) / LINE * 16);
      bulk_copy(static_cast<T*>(dst) + r * PITCH,
                P + static_cast<size_t>(r0 + r) * D + c0 - l, bytes, mbar);
      total += bytes;
    }
    return total;
  }
};

// The mirrored epilogue of a symmetric rank update on tile pair (i0, j0),
// i0 <= j0, of a D x D matrix (T: float or bf16, one rounding on store).
// sC (PT_TILE x LDC, [r][c]) holds the accumulator tile S and pij / pji
// the tiles (i0, j0) / (j0, i0) of P, all complete and visible to the
// block (pji is pij on a diagonal tile and unused without `mirror`). With
// s = S[r][c] — on a diagonal tile (i0 == j0, mirror) S[min(r,c)][max(r,c)],
// so the lower entries are the upper ones bit for bit —
//   sym_p == false:  out(i0+r, j0+c) = P(i0+r, j0+c) + scale·s  and, when
//                    `mirror` and off the diagonal,
//                    out(j0+c, i0+r) = P(j0+c, i0+r) + scale·s;
//   sym_p == true:   both get ½(P(i0+r, j0+c) + P(j0+c, i0+r)) + scale·s.
// Side 0 writes tile (i0, j0) from S, side 1 tile (j0, i0) from Sᵀ: a
// thread keeps one column of the tile it writes and walks down its rows,
// so every global write has consecutive threads on consecutive entries and
// the transposed side is read from shared memory. `mirror` false writes
// the (i0, j0) tile alone (a plain update).
template <typename T, int THREADS>
__device__ void store_tile_pair(T* __restrict__ out, int D, int i0, int j0,
                                const float* sC, const PTile<T>& pij,
                                const PTile<T>& pji, float scale, bool mirror,
                                bool sym_p) {
  static_assert(THREADS % PT_TILE == 0, "a thread keeps one column");
  constexpr int ROWS = THREADS / PT_TILE;      // rows of a tile a pass
  const bool diag = mirror && i0 == j0;
  const int col = static_cast<int>(threadIdx.x) % PT_TILE;
  const int row0 = static_cast<int>(threadIdx.x) / PT_TILE;
  for (int side = 0; side < (mirror && !diag ? 2 : 1); ++side) {
    const int a0 = side ? j0 : i0, b0 = side ? i0 : j0;
    if (b0 + col >= D) continue;
    T* o = out + static_cast<size_t>(a0 + row0) * D + b0 + col;
    const int rows = min(PT_TILE, D - a0);
#pragma unroll 8
    for (int a = row0; a < rows; a += ROWS) {
      const int r = side ? col : a, c = side ? a : col;
      const float s = sC[diag && r > c ? c * LDC + r : r * LDC + c];
      float p = side ? pji.at(c, r) : pij.at(r, c);
      if (sym_p) p = 0.5f * (p + (side ? pij.at(r, c) : pji.at(c, r)));
      store(o + (a - row0) * D, p + scale * s);
    }
  }
}

// Tile pair number p of the nt(nt+1)/2 pairs i <= j of an nt x nt grid of
// tiles, row by row: (0, 0) .. (0, nt−1), (1, 1) .. (nt−1, nt−1).
__device__ __forceinline__ void pair_of(int p, int nt, int& i, int& j) {
  for (i = 0; p >= nt - i; ++i) p -= nt - i;
  j = i + p;
}

// Round a shared-memory offset (in floats) up to a 16-byte boundary.
__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// Launch setup done once, not at every launch: a kernel's dynamic
// shared-memory limit, set per device and kernel instantiation and raised
// only when a launch needs more than the largest set so far; K7's resident
// blocks (its occupancy at a shared-memory size times the device's SMs).
// None of these is a stream op; done once, a launch captured into a CUDA
// graph is cudaLaunchKernel alone. cudaGetDevice, which keys them, reads
// the calling thread's current device and touches no stream.
struct LaunchSetup {
  std::mutex mu;
  std::map<std::pair<int, const void*>, size_t> smem;
  std::map<std::tuple<int, const void*, size_t>, int> resident;
};

LaunchSetup& launch_setup() {
  static LaunchSetup s;
  return s;
}

// fn's dynamic shared-memory limit raised to at least smem on the current
// device (a call only the first time a size above the last is asked).
cudaError_t smem_limit(const void* fn, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  LaunchSetup& s = launch_setup();
  std::lock_guard<std::mutex> lock(s.mu);
  size_t& set = s.smem[{dev, fn}];
  if (smem <= set) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) set = smem;
  return err;
}

// The blocks of fn (threads a block, smem bytes) the current device holds
// at once: its occupancy a multiprocessor (at least 1) times its SMs,
// queried the first time per device, kernel and size.
cudaError_t resident_blocks(const void* fn, int threads, size_t smem,
                            int& blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  LaunchSetup& s = launch_setup();
  std::lock_guard<std::mutex> lock(s.mu);
  const auto key = std::make_tuple(dev, fn, smem);
  const auto it = s.resident.find(key);
  if (it != s.resident.end()) {
    blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  blocks = (per_sm < 1 ? 1 : per_sm) * sms;
  s.resident[key] = blocks;
  return cudaSuccess;
}

cudaError_t launch(const void* fn, dim3 grid, size_t smem, void** args,
                   cudaStream_t stream, int threads = NT) {
  cudaError_t err = smem_limit(fn, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(fn, grid, dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K6's launcher (unfused_cov.cu): C = A·B for A (Bn, M, K), f32 or
// (a_bf16) bf16, and B (Bn, K, N), C (Bn, M, N) f32. K1 and K2 form their
// P·Hᵀ with it.
extern "C" cudaError_t ekf_k6_matmul_big(const void* A, const float* B,
                                         float* C, int Bn, int M, int K,
                                         int N, int a_bf16, void* stream);
