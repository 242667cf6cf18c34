// pht_blocks — the measurement gain's gain columns and innovation
// covariance from the Jacobian's blocks, for Hopper (sm_90a).
//
// Replaces K6 f32_matmul_big (ekf_slam_tpu/ops/pallas_kernels.py:192)
// wherever its B operand is a measurement Jacobian: the unfused update's
// P·Hᵀ (ekf.update_gain, ekf.update_iterated), which K6 formed from a dense
// (B, 2M, D) H whose rows hold 19 nonzeros and 594 zeros each, with S =
// H·PHt a cuBLAS product beside it. K6 stays for a dense H (the loop's pose
// constraint, the row-sharded slab) and for RANSAC's P·G.
//
// The Jacobian of M gathered slots enters as its blocks: row 2m+c (c = u,
// v) has H_xv[m][c] (13) on the camera columns and H_y[m][c] (6) on the
// columns 13+6·sel[m] .. +5 of the slot it measures; sel's slots are
// distinct. For each of B instances, with P (D x D) as stored (f32 or bf16,
// read from its columns: no symmetry is assumed):
//   PHt[i][2m+c] = Σ_{k<13} P[i][k]·H_xv[m][c][k]
//                + Σ_{j<6} P[i][13+6·sel[m]+j]·H_y[m][c][j]       (D x 2M)
//   S[2m'+a][2m+c] = Σ_{k<13} H_xv[m'][a][k]·PHt[k][2m+c]
//                  + Σ_{j<6} H_y[m'][a][j]·PHt[13+6·sel[m']+j][2m+c]
//                  + (2m'+a == 2m+c ? r[2m+c] : 0)                (2M x 2M)
// Masked rows arrive as zero blocks: their columns of PHt are zero and
// their rows of S the unit noise alone, as the dense form gives.
//
// Bound on the H100 at the IEKF cell (B = 1,024, D = 613, 2M = 128): P read
// once, 1.54 GB, PHt and S written, 0.39 GB: 0.58 ms at 3.35 TB/s; the
// arithmetic, 19 multiply-adds an entry of PHt and of S, is 3.3 GFLOP
// (0.05 ms at 67 TFLOP/s). The pass over P binds.
//
// What the design does about it:
// - One block an instance (and 64 gathered slots: a second column tile of
//   the grid past M = 64). It streams the instance's P once, in chunks of
//   whole consecutive rows: chunk 0 the 13 camera rows, then chunk k the
//   rows of slots 2(k−1) and 2k−1. A chunk is one contiguous range of P, so
//   one bulk copy of the 16-byte lines that cover it moves it into a ring
//   of three stages in shared memory (one mbarrier a chunk, each waited
//   once), two chunks in flight while one is used.
// - A thread owns one gathered slot m of the tile, both its gain columns
//   2m and 2m+1, with H's two rows in registers: each P entry it reads
//   serves two outputs, the 13 camera entries of a row are one broadcast
//   load a warp, the slot's 6 one load each. Of a chunk's two slots, the
//   first 64 threads take the first, the next 64 the second. A warp stores
//   a row's 64 column pairs as 256 consecutive bytes.
// - S comes out of the same pass with no product over D: a thread keeps
//   the camera rows of its columns (PHt[0:13], exchanged once through
//   shared memory after chunk 0) and, when the chunk's slot q is gathered
//   as m' (a slot -> m' map in shared memory), the six rows of q it has
//   just formed; that is all S[2m'+a][2m+c] needs. Every entry of S is
//   written by one thread, once: no atomics, no reduction across blocks.
// - Every output is one fmaf chain in a fixed order (camera columns, then
//   the slot's): deterministic, no tensor cores, no TF32.
//
// Plain C ABI (bound with ctypes): the launcher returns the cudaError_t of
// its launch and launches on the caller's stream.

#include "common.cuh"

namespace {

constexpr int PHB_SLOTS = 64;           // gathered slots a block
constexpr int PHB_GROUPS = 2;           // slots a chunk, one a thread group
constexpr int PHB_THREADS = PHB_SLOTS * PHB_GROUPS;
constexpr int PHB_STAGES = 3;
constexpr int PHB_CAM = 13;             // camera rows: chunk 0
constexpr int PHB_ROWS = PHB_CAM;       // rows a stage holds, >= 6·GROUPS
constexpr int PHB_HW = PHB_CAM + 6;     // a row's nonzeros
constexpr int PHB_MAX_CAP = 200;
constexpr size_t PHB_MAX_SMEM = 232448;
static_assert(6 * PHB_GROUPS <= PHB_ROWS, "a slot chunk fits a stage");

// The dynamic shared memory of an instance of D columns and M gathered
// slots: the stage ring, the chunks' mbarriers, H's rows of all M slots,
// the camera rows of the tile's columns, the slot map.
template <typename T>
struct PhbLayout {
  static constexpr int LINE = 16 / static_cast<int>(sizeof(T));
  size_t stage, bars, hs, pcam, map, bytes;
  int cap, chunks;

  __host__ __device__ PhbLayout(int D, int M)
      : cap((D - PHB_CAM) / 6), chunks(1 + (cap + PHB_GROUPS - 1) /
                                               PHB_GROUPS) {
    stage = static_cast<size_t>(PHB_ROWS * D + 2 * LINE - 1) / LINE * 16;
    bars = PHB_STAGES * stage;
    hs = bars + up4(2 * chunks) * sizeof(float);
    pcam = hs + up4(2 * PHB_HW * M) * sizeof(float);
    map = pcam + PHB_CAM * 2 * PHB_SLOTS * sizeof(float);
    bytes = map + cap * sizeof(int);
  }
};

// Rows [r0, r1) of P in chunk c (0: the camera rows; c >= 1: the rows of
// slots GROUPS·(c−1) .. GROUPS·c − 1).
__device__ __forceinline__ void phb_rows(int c, int D, int& r0, int& r1) {
  r0 = c == 0 ? 0 : PHB_CAM + 6 * PHB_GROUPS * (c - 1);
  r1 = c == 0 ? PHB_CAM : min(D, r0 + 6 * PHB_GROUPS);
}

// Entries of the 16-byte line before `p`'s own entry.
template <typename T>
__device__ __forceinline__ int phb_lead(const T* p) {
  return static_cast<int>(reinterpret_cast<size_t>(p) / sizeof(T) %
                          (16 / sizeof(T)));
}

// Thread 0: chunk c of the instance's P (Pb) into `stage`, announced to
// `bar`: the lines that cover rows r0 .. r1−1, which lie inside the
// allocation's 256-byte granule at the array's ends.
template <typename T>
__device__ void phb_fetch(void* stage, const T* Pb, int D, int c,
                          unsigned long long* bar) {
  constexpr int LINE = 16 / static_cast<int>(sizeof(T));
  int r0, r1;
  phb_rows(c, D, r0, r1);
  const T* src = Pb + static_cast<size_t>(r0) * D;
  const int l = phb_lead(src);
  const unsigned bytes =
      static_cast<unsigned>((l + (r1 - r0) * D + LINE - 1) / LINE * 16);
  bulk_copy(stage, src - l, bytes, bar);
  mbar_arrive_expect(bar, bytes);
}

// The two gain columns of one row of P staged at `row`: camera columns,
// then the slot's six at `off`.
template <typename T>
__device__ __forceinline__ float2 phb_row(const T* row, int off,
                                          const float (&h)[2][PHB_HW]) {
  float u = 0.f, v = 0.f;
#pragma unroll
  for (int k = 0; k < PHB_CAM; ++k) {
    const float p = to_f32(row[k]);
    u = fmaf(p, h[0][k], u);
    v = fmaf(p, h[1][k], v);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float p = to_f32(row[off + j]);
    u = fmaf(p, h[0][PHB_CAM + j], u);
    v = fmaf(p, h[1][PHB_CAM + j], v);
  }
  return make_float2(u, v);
}

template <typename T>
__global__ void __launch_bounds__(PHB_THREADS)
    phtb_kernel(const T* __restrict__ P, const float* __restrict__ Hxv,
                const float* __restrict__ Hy,
                const long long* __restrict__ sel,
                const float* __restrict__ r, float* __restrict__ PHt,
                float* __restrict__ S, int D, int M) {
  extern __shared__ __align__(16) float sm[];
  const PhbLayout<T> L(D, M);
  char* base = reinterpret_cast<char*>(sm);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(base + L.bars);
  float* Hs = reinterpret_cast<float*>(base + L.hs);        // [m'][a][19]
  float* pcam = reinterpret_cast<float*>(base + L.pcam);    // [k][2·slot+c]
  int* map = reinterpret_cast<int*>(base + L.map);          // slot -> m'
  const int tid = static_cast<int>(threadIdx.x);
  const int slot = tid % PHB_SLOTS, g = tid / PHB_SLOTS;
  const int b = static_cast<int>(blockIdx.x);
  const int m = static_cast<int>(blockIdx.y) * PHB_SLOTS + slot;
  const bool own = m < M;
  const int N = 2 * M, cap = L.cap;
  const T* Pb = P + static_cast<size_t>(b) * D * D;
  const long long* selb = sel + static_cast<size_t>(b) * M;

  if (tid == 0)
    for (int c = 0; c < L.chunks; ++c) mbar_init(&bars[c], 1);
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(PHB_STAGES, L.chunks); ++c)
      phb_fetch(base + c * L.stage, Pb, D, c, &bars[c]);

  // H's rows of all M slots (for S's rows) and the slot map, while the
  // first chunks land.
  for (int e = tid; e < N * PHB_HW; e += PHB_THREADS) {
    const int row = e / PHB_HW, k = e % PHB_HW;
    Hs[e] = k < PHB_CAM
                ? Hxv[(static_cast<size_t>(b) * N + row) * PHB_CAM + k]
                : Hy[(static_cast<size_t>(b) * N + row) * 6 + k - PHB_CAM];
  }
  for (int q = tid; q < cap; q += PHB_THREADS) map[q] = -1;
  __syncthreads();
  for (int mm = tid; mm < M; mm += PHB_THREADS) {
    const long long q = selb[mm];
    if (q >= 0 && q < cap) map[q] = mm;
  }
  float h[2][PHB_HW];
  int off = PHB_CAM;
  {
    const long long q = own ? selb[m] : 0;
    off = PHB_CAM + 6 * static_cast<int>(q >= 0 && q < cap ? q : 0);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int k = 0; k < PHB_HW; ++k)
        h[a][k] = own ? Hs[(2 * m + a) * PHB_HW + k] : 0.f;
  }
  float* out = PHt + static_cast<size_t>(b) * D * N + 2 * m;

  // Chunk 0: the camera rows, group g rows g, g + GROUPS, ...
  mbar_wait(&bars[0]);
  {
    const T* st = reinterpret_cast<const T*>(base);
    const int l = phb_lead(Pb);
    for (int i = g; i < PHB_CAM; i += PHB_GROUPS) {
      const float2 p = phb_row(st + l + i * D, off, h);
      if (own) *reinterpret_cast<float2*>(out + static_cast<size_t>(i) * N) = p;
      pcam[i * 2 * PHB_SLOTS + 2 * slot] = p.x;
      pcam[i * 2 * PHB_SLOTS + 2 * slot + 1] = p.y;
    }
  }
  __syncthreads();                      // pcam and the slot map complete
  if (tid == 0 && PHB_STAGES < L.chunks)
    phb_fetch(base, Pb, D, PHB_STAGES, &bars[PHB_STAGES]);
  float pc[PHB_CAM][2];
#pragma unroll
  for (int k = 0; k < PHB_CAM; ++k) {
    pc[k][0] = pcam[k * 2 * PHB_SLOTS + 2 * slot];
    pc[k][1] = pcam[k * 2 * PHB_SLOTS + 2 * slot + 1];
  }
  float* Sb = S + static_cast<size_t>(b) * N * N + 2 * m;
  const float r0 = own ? r[static_cast<size_t>(b) * N + 2 * m] : 0.f;
  const float r1 = own ? r[static_cast<size_t>(b) * N + 2 * m + 1] : 0.f;

  // Chunks 1 ..: slot q = GROUPS·(c−1) + g, its six rows, then its rows of
  // S when it is gathered.
#pragma unroll 1
  for (int c = 1; c < L.chunks; ++c) {
    mbar_wait(&bars[c]);
    const int q = PHB_GROUPS * (c - 1) + g;
    if (q < cap) {
      const T* st = reinterpret_cast<const T*>(base + (c % PHB_STAGES) *
                                                          L.stage);
      int r0c, r1c;
      phb_rows(c, D, r0c, r1c);
      const T* rows = st + phb_lead(Pb + static_cast<size_t>(r0c) * D) +
                      6 * g * D;
      float pl[6][2];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float2 p = phb_row(rows + j * D, off, h);
        pl[j][0] = p.x, pl[j][1] = p.y;
        if (own)
          *reinterpret_cast<float2*>(
              out + static_cast<size_t>(PHB_CAM + 6 * q + j) * N) = p;
      }
      const int mq = map[q];
      if (mq >= 0 && own) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float* hr = Hs + (2 * mq + a) * PHB_HW;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int k = 0; k < PHB_CAM; ++k) {
            s0 = fmaf(hr[k], pc[k][0], s0);
            s1 = fmaf(hr[k], pc[k][1], s1);
          }
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            s0 = fmaf(hr[PHB_CAM + j], pl[j][0], s0);
            s1 = fmaf(hr[PHB_CAM + j], pl[j][1], s1);
          }
          const int row = 2 * mq + a;
          if (row == 2 * m) s0 += r0;
          if (row == 2 * m + 1) s1 += r1;
          *reinterpret_cast<float2*>(Sb + static_cast<size_t>(row) * N) =
              make_float2(s0, s1);
        }
      }
    }
    __syncthreads();                    // every read of this stage done
    if (tid == 0 && c + PHB_STAGES < L.chunks)
      phb_fetch(base + (c % PHB_STAGES) * L.stage, Pb, D, c + PHB_STAGES,
                &bars[c + PHB_STAGES]);
  }
}

template <typename T>
cudaError_t phb_launch(const void* P, const float* Hxv, const float* Hy,
                       const long long* sel, const float* r, float* PHt,
                       float* S, int B, int D, int M, cudaStream_t stream) {
  const PhbLayout<T> L(D, M);
  if (L.bytes > PHB_MAX_SMEM) return cudaErrorInvalidValue;
  void* args[] = {&P, &Hxv, &Hy, &sel, &r, &PHt, &S, &D, &M};
  return launch(reinterpret_cast<const void*>(phtb_kernel<T>),
                dim3(B, (M + PHB_SLOTS - 1) / PHB_SLOTS), L.bytes, args,
                stream, PHB_THREADS);
}

}  // namespace

extern "C" {

// pht_blocks. P (B,D,D), f32 or (p_bf16) bf16; H_xv (B,M,2,13), H_y
// (B,M,2,6), r (B,2M) f32; sel (B,M) int64, distinct slots in [0, CAP);
// PHt (B,D,2M) and S (B,2M,2M) f32. Contiguous row-major. D = 13 + 6·CAP
// with CAP <= 200 and 1 <= M <= CAP, else cudaErrorInvalidValue.
cudaError_t ekf_pht_blocks(const void* P, const float* Hxv, const float* Hy,
                           const long long* sel, const float* r, float* PHt,
                           float* S, int B, int D, int M, int p_bf16,
                           void* stream) {
  const int cap = (D - PHB_CAM) / 6;
  if (B < 1 || D < PHB_CAM + 6 ||
      (D - PHB_CAM) % 6 != 0 || cap > PHB_MAX_CAP || M < 1 || M > cap)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p_bf16 ? phb_launch<__nv_bfloat16>(P, Hxv, Hy, sel, r, PHt, S, B,
                                            D, M, s)
                : phb_launch<float>(P, Hxv, Hy, sel, r, PHt, S, B, D, M, s);
}

}  // extern "C"
