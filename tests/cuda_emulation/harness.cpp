// Runs K1 (fused_manage_predict_pht), K2 (fused_update_tail_pht) or K3/K5
// (fused_update_tail_add / fused_update_tail) of csrc/fused_cov.cu, K4
// (corr_apply_cols), K6 (f32_matmul_big) or K8 (corr_apply) of
// csrc/unfused_cov.cu (and K8's row-slab form), K7 (ncc_corr, ncc_corr_norms) of csrc/ncc.cu,
// spd_inverse_newton of csrc/newton_inverse.cu or pht_blocks of
// csrc/pht_blocks.cu on the CPU through the stand-in headers beside this
// file, on random operands (pht_blocks: on a file's), and holds the result
// against a plain f64 loop.
//
//   g++ -std=c++20 -O1 -fsanitize=address -I tests/cuda_emulation
//       -I ekf_slam_tpu_torch/csrc -x c++ tests/cuda_emulation/harness.cpp
//       -o emulate -lpthread
//   ./emulate k1 f32 B D R r symP
//   ./emulate k2 f32 B D M2 R symP
//   ./emulate k3 f32 B D M2 r symP             (r = 0: K5)
//   ./emulate k4 f32|bf16 B D R
//   ./emulate k6 f32|bf16 B M K N misalign     (misalign: C off 16 bytes)
//   ./emulate k8 f32|bf16 B D R mode symP      (mode 0 none, 1 expr, 2 full)
//   ./emulate k8s f32|bf16 B Dl Dc R r0         (the row-slab form)
//   ./emulate k7 f32 N W2 t norms              (norms 1: ncc_corr_norms)
//   ./emulate ep f32 case N                    (eight_point_fit; case 0
//       8-point systems, 1 repeated eigenvalues, 2 zero-weight rows, 3
//       non-finite entries, 4 identity, 5 systems scaled by 2^±40)
//   ./emulate span f32 id end                  (ekf_span_mark of spans.cu)
//   ./emulate nsi f32 B n case                 (spd_inverse_newton; case 0
//       SPD of condition 1e1 to 1e4, 1 a NaN entry, 2 an infinite entry,
//       3 a non-positive diagonal entry)
//   ./emulate pht f32|bf16 IN OUT              (pht_blocks on the operands
//       in file IN, its outputs to file OUT: run_pht's comment)
//
// Prints one line and exits 0 when every entry is within tolerance (1e-5
// of the entry's own scale — the same sums over absolute values — plus one
// bf16 ulp on a bf16 output), every entry was written, and the output is
// bitwise symmetric where it must be (K4; K8 "full", and "expr" on a
// symmetric P; K1, K2, K3 and K5 on a symmetric P). K1's and K2's P·Hᵀ
// output is held to 1e-5 of its own scale, Σ_k scale(P_ik)·|Ht_kc|, the
// reference's P output times Ht in f64. P lies at an odd offset inside
// a larger buffer, as a matrix of a batch does, so the bulk copies of its
// 16-byte lines stay inside the buffer. K7's correlation is held to 1e-5 of
// Σ|w||tm| an offset, its patch variance to 1e-5 of the pair's Σwc² and
// its energy to 1e-5 of itself; its windows start at odd 4-byte offsets.
// eight_point_fit is held to itself (launched again, and each matrix
// alone) and to an f64 Jacobi (run_ep's comment); spd_inverse_newton to an
// f64 loop of the same 20 iterations and to each instance launched alone
// (run_nsi's comment); pht_blocks writes its outputs for the test to hold
// against the plain version (run_pht). A span mark must launch
// the instance of its (id, end), and an (id, end) without one must launch
// nothing and return an error.
#include "eight_point.cu"
#include "fused_cov.cu"
#include "ncc.cu"
#include "newton_inverse.cu"
#include "pht_blocks.cu"
#include "spans.cu"
#include "unfused_cov.cu"

#include <random>
#include <string>

namespace {

std::mt19937 rng(1);
float rnd() { return std::normal_distribution<float>()(rng); }
float value(float v) { return v; }
float value(__nv_bfloat16 v) { return __bfloat162float(v); }
void put(float* p, float v) { *p = v; }
void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename AT, int BN>
void register_k6() {
  g_kernels[reinterpret_cast<const void*>(k6_kernel<AT, BN>)] = [](void** a) {
    k6_kernel<AT, BN>(*(const AT**)a[0], *(const float**)a[1], *(float**)a[2],
                      *(int*)a[3], *(int*)a[4], *(int*)a[5], *(int*)a[6]);
  };
}

template <typename PT>
void register_k8() {
  g_kernels[reinterpret_cast<const void*>(k8_kernel<PT>)] = [](void** a) {
    k8_kernel<PT>(*(const PT**)a[0], *(const float**)a[1],
                  *(const float**)a[2], *(PT**)a[3], *(int*)a[4],
                  *(int*)a[5], *(int*)a[6]);
  };
}

template <typename PT>
void register_k8s() {
  g_kernels[reinterpret_cast<const void*>(k8s_kernel<PT>)] = [](void** a) {
    k8s_kernel<PT>(*(const PT**)a[0], *(const float**)a[1],
                   *(const float**)a[2], *(PT**)a[3], *(int*)a[4],
                   *(int*)a[5], *(int*)a[6], *(int*)a[7]);
  };
}

template <typename PT>
void register_k4() {
  g_kernels[reinterpret_cast<const void*>(k4_kernel<PT>)] = [](void** a) {
    k4_kernel<PT>(*(const PT**)a[0], *(const float**)a[1],
                  *(const float**)a[2], *(PT**)a[3], *(int*)a[4],
                  *(int*)a[5]);
  };
}

void register_k6_f32() {
  register_k6<float, 64>();
  register_k6<float, 128>();
}

void register_k3() {
  g_kernels[reinterpret_cast<const void*>(k3v_kernel)] = [](void** a) {
    k3v_kernel(*(const float**)a[0], *(const float**)a[1],
               *(const float**)a[2], *(float**)a[3], *(int*)a[4],
               *(int*)a[5]);
  };
  g_kernels[reinterpret_cast<const void*>(k3_kernel)] = [](void** a) {
    k3_kernel(*(const float**)a[0], *(const float**)a[1],
              *(const float**)a[2], *(const float**)a[3],
              *(const float**)a[4], *(const float**)a[5],
              *(const float**)a[6], *(float**)a[7], *(int*)a[8],
              *(int*)a[9], *(int*)a[10]);
  };
}

// P (Bn x D x D) at an odd offset inside a buffer, random, symmetric when
// `sym`; its entries upcast to f64 in `Pd`.
template <typename PT>
PT* random_p(std::vector<PT>& buf, std::vector<double>& Pd, int Bn, int D,
             bool sym) {
  const size_t DD = static_cast<size_t>(D) * D;
  buf.assign(Bn * DD + 32, PT{});
  PT* P = buf.data() + 8 + D % 3;
  Pd.resize(Bn * DD);
  for (size_t b = 0; b < static_cast<size_t>(Bn); ++b)
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) {
        put(&P[b * DD + i * D + j], rnd());
        if (sym && j < i) P[b * DD + i * D + j] = P[b * DD + j * D + i];
      }
  for (size_t n = 0; n < Bn * DD; ++n) Pd[n] = value(P[n]);
  return P;
}

// Every entry of `out` against `ref` within 1e-5 of `scale` (one bf16 ulp
// more on a bf16 output); prints `tag` and returns whether it holds and the
// output is bitwise symmetric where `must_sym`.
template <typename PT>
bool report(const char* tag, int rc, const std::vector<PT>& out,
            const std::vector<double>& ref, const std::vector<double>& scale,
            int Bn, int D, bool must_sym) {
  const size_t DD = static_cast<size_t>(D) * D;
  double worst = 0;
  bool symmetric = true;
  for (size_t b = 0; b < static_cast<size_t>(Bn); ++b)
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) {
        const size_t n = b * DD + i * D + j;
        const double got = value(out[n]);
        double limit = 1e-5 * scale[n] + 1e-30;
        if (sizeof(PT) == 2) limit += std::abs(ref[n]) / 128;  // >= 1 ulp
        const double err = std::abs(got - ref[n]) / limit;
        worst = std::isnan(got) ? 1e9 : std::max(worst, err);
        if (memcmp(&out[n], &out[b * DD + j * D + i], sizeof(PT)))
          symmetric = false;
      }
  printf("%s rc=%d blocks=%ld worst=%.3f of the limit symmetric=%d\n", tag,
         rc, g_blocks, worst, symmetric);
  return rc == 0 && worst <= 1 && (symmetric || !must_sym);
}

template <typename AT>
bool run_k6(int Bn, int M, int K, int N, bool misalign) {
  register_k6<AT, 64>();
  register_k6<AT, 128>();
  std::vector<AT> A(static_cast<size_t>(Bn) * M * K);
  std::vector<float> B(static_cast<size_t>(Bn) * K * N);
  std::vector<float> buf(static_cast<size_t>(Bn) * M * N + 8, NAN);
  float* C = buf.data();
  while (reinterpret_cast<size_t>(C) % 16) ++C;
  if (misalign) ++C;
  for (auto& a : A) put(&a, rnd());
  for (auto& b : B) b = rnd();
  const int rc = ekf_k6_matmul_big(A.data(), B.data(), C, Bn, M, K, N,
                                   sizeof(AT) == 2, nullptr);
  double worst = 0;
  for (int b = 0; b < Bn; ++b)
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < N; ++j) {
        double s = 0, scale = 0;
        for (int k = 0; k < K; ++k) {
          const double p = static_cast<double>(value(
                               A[(static_cast<size_t>(b) * M + i) * K + k])) *
                           B[(static_cast<size_t>(b) * K + k) * N + j];
          s += p, scale += std::abs(p);
        }
        const double got = C[(static_cast<size_t>(b) * M + i) * N + j];
        const double err = std::abs(got - s) / (1e-5 * scale + 1e-30);
        worst = std::isnan(got) ? 1e9 : std::max(worst, err);
      }
  printf("k6 rc=%d blocks=%ld worst=%.3f of the limit\n", rc, g_blocks, worst);
  return rc == 0 && worst <= 1;
}

template <typename PT>
bool run_k8(int Bn, int D, int R, int mode, bool sym_p) {
  register_k8<PT>();
  const size_t DD = static_cast<size_t>(D) * D;
  std::vector<PT> buf, out(Bn * DD);
  std::vector<double> Pd, ref(Bn * DD), scale(Bn * DD);
  const PT* P = random_p(buf, Pd, Bn, D, sym_p);
  std::vector<float> At(static_cast<size_t>(Bn) * R * D), Bt(At.size());
  for (auto& a : At) a = rnd();
  for (auto& b : Bt) b = rnd();
  for (auto& o : out) put(&o, NAN);
  const int rc = ekf_k8_corr_apply(P, At.data(), Bt.data(), out.data(), Bn, D,
                                   R, mode, sizeof(PT) == 2, nullptr);
  for (int b = 0; b < Bn; ++b)
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) {
        double s1 = 0, s2 = 0, sc = 0;
        for (int k = 0; k < R; ++k) {
          const size_t row = (static_cast<size_t>(b) * R + k) * D;
          const double p1 = static_cast<double>(At[row + i]) * Bt[row + j];
          const double p2 = static_cast<double>(Bt[row + i]) * At[row + j];
          s1 += p1, s2 += p2, sc += std::abs(p1) + std::abs(p2);
        }
        const double pij = Pd[b * DD + i * D + j];
        const double pji = Pd[b * DD + j * D + i];
        const size_t n = b * DD + i * D + j;
        ref[n] = mode == 0   ? pij + s1
                 : mode == 1 ? pij + 0.5 * (s1 + s2)
                             : 0.5 * (pij + pji) + 0.5 * (s1 + s2);
        scale[n] = std::abs(pij) + std::abs(pji) + sc;
      }
  return report("k8", rc, out, ref, scale, Bn, D,
                mode == 2 || (mode == 1 && sym_p));
}

// K8's row-slab form: rows r0 .. r0+Dl−1 of a P with Dc columns, as one
// rank of the row-sharded step holds them, at an odd offset like random_p's.
template <typename PT>
bool run_k8s(int Bn, int Dl, int Dc, int R, int r0) {
  register_k8s<PT>();
  const size_t slab = static_cast<size_t>(Dl) * Dc;
  std::vector<PT> buf(Bn * slab + 32), out(Bn * slab);
  PT* P = buf.data() + 8 + Dc % 3;
  for (size_t n = 0; n < Bn * slab; ++n) put(&P[n], rnd());
  std::vector<float> At(static_cast<size_t>(Bn) * R * Dc), Bt(At.size());
  for (auto& a : At) a = rnd();
  for (auto& b : Bt) b = rnd();
  for (auto& o : out) put(&o, NAN);
  const int rc = ekf_k8_corr_apply_rows(P, At.data(), Bt.data(), out.data(),
                                        Bn, Dl, Dc, R, r0, sizeof(PT) == 2,
                                        nullptr);
  double worst = 0;
  for (int b = 0; b < Bn; ++b)
    for (int i = 0; i < Dl; ++i)
      for (int j = 0; j < Dc; ++j) {
        const size_t n = b * slab + static_cast<size_t>(i) * Dc + j;
        double s = value(P[n]), sc = std::abs(s);
        for (int k = 0; k < R; ++k) {
          const size_t row = (static_cast<size_t>(b) * R + k) * Dc;
          const double p = static_cast<double>(At[row + r0 + i]) * Bt[row + j];
          s += p, sc += std::abs(p);
        }
        double limit = 1e-5 * sc + 1e-30;
        if (sizeof(PT) == 2) limit += std::abs(s) / 128;    // >= 1 ulp
        const double got = value(out[n]);
        worst = std::isnan(got) ? 1e9 : std::max(worst, std::abs(got - s) / limit);
      }
  printf("k8s rc=%d blocks=%ld worst=%.3f of the limit\n", rc, g_blocks,
         worst);
  return rc == 0 && worst <= 1;
}

template <typename PT>
bool run_k4(int Bn, int D, int R) {
  register_k4<PT>();
  const size_t DD = static_cast<size_t>(D) * D;
  std::vector<PT> buf, out(Bn * DD);
  std::vector<double> Pd, ref(Bn * DD), scale(Bn * DD);
  const PT* P = random_p(buf, Pd, Bn, D, false);
  std::vector<float> A(static_cast<size_t>(Bn) * D * R), Bf(A.size());
  for (auto& a : A) a = rnd();
  for (auto& b : Bf) b = rnd();
  for (auto& o : out) put(&o, NAN);
  const int rc = ekf_k4_corr_apply_cols(P, A.data(), Bf.data(), out.data(),
                                        Bn, D, R, sizeof(PT) == 2, nullptr);
  for (int b = 0; b < Bn; ++b)
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) {
        const size_t ri = (static_cast<size_t>(b) * D + i) * R;
        const size_t rj = (static_cast<size_t>(b) * D + j) * R;
        double s = 0, sc = 0;
        for (int k = 0; k < R; ++k) {
          const double p1 = static_cast<double>(A[ri + k]) * Bf[rj + k];
          const double p2 = static_cast<double>(Bf[ri + k]) * A[rj + k];
          s += p1 + p2, sc += std::abs(p1) + std::abs(p2);
        }
        const double pij = Pd[b * DD + i * D + j];
        const double pji = Pd[b * DD + j * D + i];
        const size_t n = b * DD + i * D + j;
        ref[n] = 0.5 * (pij + pji) + 0.5 * s;
        scale[n] = std::abs(pij) + std::abs(pji) + sc;
      }
  return report("k4", rc, out, ref, scale, Bn, D, true);
}

void register_k1() {
  register_k3();
  register_k6_f32();
  g_kernels[reinterpret_cast<const void*>(k1p_kernel)] = [](void** a) {
    k1p_kernel(*(const float**)a[0], *(const float**)a[1],
               *(const float**)a[2], *(const float**)a[3],
               *(const float**)a[4], *(const float**)a[5], *(float**)a[6],
               *(int*)a[7], *(int*)a[8]);
  };
}

// J (W x W, row-major) on dims 0:W of one instance's f64 reference t and
// its scale s (absolute values): rows, then columns, then the W x W
// corner's lower entries from its upper ones, as the kernels do (the same
// entries where P is symmetric, their precondition).
void stripe_ref(double* t, double* s, const float* J, int W, int D) {
  const int n = std::min(W, D);
  std::vector<double> row(W), arow(W);
  for (int j = 0; j < D; ++j) {                   // rows 0:W <- J·rows
    for (int a = 0; a < n; ++a) {
      row[a] = arow[a] = 0;
      for (int k = 0; k < n; ++k) {
        row[a] += J[a * W + k] * t[k * D + j];
        arow[a] += std::abs(J[a * W + k]) * s[k * D + j];
      }
    }
    for (int a = 0; a < n; ++a) t[a * D + j] = row[a], s[a * D + j] = arow[a];
  }
  for (int i = 0; i < D; ++i) {                   // columns 0:W <- cols·Jᵀ
    for (int c = 0; c < n; ++c) {
      row[c] = arow[c] = 0;
      for (int k = 0; k < n; ++k) {
        row[c] += t[i * D + k] * J[c * W + k];
        arow[c] += s[i * D + k] * std::abs(J[c * W + k]);
      }
    }
    for (int c = 0; c < n; ++c) t[i * D + c] = row[c], s[i * D + c] = arow[c];
  }
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < i; ++j)
      t[i * D + j] = t[j * D + i], s[i * D + j] = s[j * D + i];
}

// keep∘t + EᵀU + UᵀE + Eᵀ·C·E on one instance's reference and scale
// (E, U (r, D), C (r, r) of that instance).
void add_ref(double* t, double* s, const float* keep, const float* E,
             const float* U, const float* C, int D, int r) {
  auto fe = [&](int k, int i) { return double(E[size_t(k) * D + i]); };
  auto fu = [&](int k, int i) { return double(U[size_t(k) * D + i]); };
  auto fc = [&](int k, int l) { return double(C[size_t(k) * r + l]); };
  std::vector<double> CE(static_cast<size_t>(r) * D), aCE(CE.size());
  for (int k = 0; k < r; ++k)
    for (int i = 0; i < D; ++i)
      for (int l = 0; l < r; ++l) {
        CE[size_t(k) * D + i] += fc(k, l) * fe(l, i);
        aCE[size_t(k) * D + i] += std::abs(fc(k, l) * fe(l, i));
      }
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      const bool kept = keep[i] > 0 && keep[j] > 0;
      double a = kept ? t[i * D + j] : 0, as = kept ? s[i * D + j] : 0;
      for (int k = 0; k < r; ++k) {
        a += fe(k, i) * fu(k, j) + fu(k, i) * fe(k, j) +
             fe(k, i) * CE[size_t(k) * D + j];
        as += std::abs(fe(k, i) * fu(k, j)) + std::abs(fu(k, i) * fe(k, j)) +
              std::abs(fe(k, i)) * aCE[size_t(k) * D + j];
      }
      t[i * D + j] = a, s[i * D + j] = as;
    }
}

// The P·Hᵀ output (Bn x D x R) of K1 / K2 against ref·Ht in f64, each
// entry within 1e-5 of Σ_k scale_ik·|Ht_kc|; every entry written.
bool report_pht(const char* tag, const std::vector<float>& pht,
                const std::vector<double>& ref,
                const std::vector<double>& scale,
                const std::vector<float>& Ht, int Bn, int D, int R) {
  const size_t DD = static_cast<size_t>(D) * D;
  double worst = 0;
  for (int b = 0; b < Bn; ++b)
    for (int i = 0; i < D; ++i)
      for (int c = 0; c < R; ++c) {
        double v = 0, sc = 0;
        for (int k = 0; k < D; ++k) {
          const double h = Ht[(size_t(b) * D + k) * R + c];
          v += ref[b * DD + size_t(i) * D + k] * h;
          sc += scale[b * DD + size_t(i) * D + k] * std::abs(h);
        }
        const double got = pht[(size_t(b) * D + i) * R + c];
        const double err = std::abs(got - v) / (1e-5 * sc + 1e-30);
        worst = std::isnan(got) ? 1e9 : std::max(worst, err);
      }
  printf("%s P·Hᵀ worst=%.3f of the limit\n", tag, worst);
  return worst <= 1;
}

// Random tail operands of Bn instances: K, PHt (D x M2), J8 = I₈ with a
// Jq4 near I at 3:7.
void tail_operands(std::vector<float>& K, std::vector<float>& PHt,
                   std::vector<float>& J8, int Bn, int D, int M2) {
  K.resize(static_cast<size_t>(Bn) * D * M2);
  PHt.resize(K.size());
  J8.resize(Bn * 64);
  for (auto& k : K) k = rnd();
  for (auto& h : PHt) h = rnd();
  for (int b = 0; b < Bn; ++b)
    for (int a = 0; a < 8; ++a)
      for (int c = 0; c < 8; ++c)
        J8[b * 64 + a * 8 + c] = a >= 3 && a < 7 && c >= 3 && c < 7
                                     ? (a == c) + 0.3f * rnd()
                                     : static_cast<float>(a == c);
}

// T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ of every instance in f64, and its scale.
void tail_ref(std::vector<double>& ref, std::vector<double>& scale,
              const std::vector<double>& Pd, const std::vector<float>& K,
              const std::vector<float>& PHt, const std::vector<float>& J8,
              int Bn, int D, int M2) {
  const size_t DD = static_cast<size_t>(D) * D;
  ref.assign(Bn * DD, 0);
  scale.assign(Bn * DD, 0);
  for (int b = 0; b < Bn; ++b) {
    double* t = ref.data() + b * DD;
    double* s = scale.data() + b * DD;
    auto fk = [&](int i, int m) { return K[(size_t(b) * D + i) * M2 + m]; };
    auto fh = [&](int i, int m) { return PHt[(size_t(b) * D + i) * M2 + m]; };
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) {
        double d = 0, ad = 0;
        for (int m = 0; m < M2; ++m) {
          const double p1 = double(fk(i, m)) * fh(j, m);
          const double p2 = double(fh(i, m)) * fk(j, m);
          d += p1 + p2, ad += std::abs(p1) + std::abs(p2);
        }
        const double p = Pd[b * DD + i * D + j];
        t[i * D + j] = p - 0.5 * d;
        s[i * D + j] = std::abs(p) + 0.5 * ad;
      }
    stripe_ref(t, s, J8.data() + b * 64, 8, D);
  }
}

// The feature add's operands: keep mostly 1, E, U (r x D), C symmetric.
void add_operands(std::vector<float>& keep, std::vector<float>& E,
                  std::vector<float>& U, std::vector<float>& C, int Bn, int D,
                  int r) {
  keep.resize(Bn * D);
  E.resize(static_cast<size_t>(Bn) * r * D);
  U.resize(E.size());
  C.resize(static_cast<size_t>(Bn) * r * r);
  for (auto& k : keep) k = rnd() > -1.f ? 1.f : 0.f;
  for (auto& e : E) e = rnd();
  for (auto& u : U) u = rnd();
  for (int b = 0; b < Bn; ++b)
    for (int k = 0; k < r; ++k)
      for (int l = 0; l <= k; ++l)
        C[(static_cast<size_t>(b) * r + l) * r + k] =
            C[(static_cast<size_t>(b) * r + k) * r + l] = rnd();
}

// K3 (r > 0) or K5 (r = 0): keepN∘(T·(P − ½(K·PHtᵀ + PHt·Kᵀ))·Tᵀ)
// + ENᵀUN + UNᵀEN + ENᵀ·CN·EN with a symmetric CN, its f64 reference and
// scale carried through the same steps (absolute values for the scale).
bool run_k3(int Bn, int D, int M2, int r, bool sym_p) {
  register_k3();
  const size_t DD = static_cast<size_t>(D) * D;
  std::vector<float> buf, out(Bn * DD, NAN), K, PHt, J8, keep, E, U, C;
  std::vector<double> Pd, ref, scale;
  const float* P = random_p(buf, Pd, Bn, D, sym_p);
  tail_operands(K, PHt, J8, Bn, D, M2);
  add_operands(keep, E, U, C, Bn, D, r);
  std::vector<float> V(E.size(), NAN);
  const int rc =
      r > 0 ? ekf_k3_update_tail_add(P, K.data(), PHt.data(), J8.data(),
                                     keep.data(), E.data(), U.data(),
                                     C.data(), V.data(), out.data(), Bn, D,
                                     M2, r, nullptr)
            : ekf_k5_update_tail(P, K.data(), PHt.data(), J8.data(),
                                 out.data(), Bn, D, M2, nullptr);
  tail_ref(ref, scale, Pd, K, PHt, J8, Bn, D, M2);
  if (r > 0)
    for (int b = 0; b < Bn; ++b)
      add_ref(ref.data() + b * DD, scale.data() + b * DD,
              keep.data() + size_t(b) * D, E.data() + size_t(b) * r * D,
              U.data() + size_t(b) * r * D, C.data() + size_t(b) * r * r, D,
              r);
  return report(r > 0 ? "k3" : "k5", rc, out, ref, scale, Bn, D, sym_p);
}

// K2: K5's tail, then P_li·Ht.
bool run_k2(int Bn, int D, int M2, int R, bool sym_p) {
  register_k3();
  register_k6_f32();
  const size_t DD = static_cast<size_t>(D) * D;
  std::vector<float> buf, out(Bn * DD, NAN), K, PHt, J8;
  std::vector<float> Ht(static_cast<size_t>(Bn) * D * R), pht(Ht.size(), NAN);
  std::vector<double> Pd, ref, scale;
  const float* P = random_p(buf, Pd, Bn, D, sym_p);
  tail_operands(K, PHt, J8, Bn, D, M2);
  for (auto& h : Ht) h = rnd();
  const int rc = ekf_k2_update_tail_pht(P, K.data(), PHt.data(), J8.data(),
                                        Ht.data(), out.data(), pht.data(), Bn,
                                        D, M2, R, nullptr);
  tail_ref(ref, scale, Pd, K, PHt, J8, Bn, D, M2);
  const bool ok = report("k2", rc, out, ref, scale, Bn, D, sym_p);
  return report_pht("k2", pht, ref, scale, Ht, Bn, D, R) && ok;
}

// K1: Lp·(keep∘P + EᵀU + UᵀE + EᵀCE)·Lpᵀ + Q̃ with F16 = F13 ⊕ I₃ (F13
// near I), a symmetric Q13 zero-padded to Q16, a symmetric C; then P⁻·Ht.
bool run_k1(int Bn, int D, int R, int r, bool sym_p) {
  register_k1();
  const size_t DD = static_cast<size_t>(D) * D;
  std::vector<float> buf, out(Bn * DD, NAN), keep, E, U, C;
  std::vector<float> F16(Bn * 256), Q16(Bn * 256, 0.f);
  std::vector<float> Ht(static_cast<size_t>(Bn) * D * R), pht(Ht.size(), NAN);
  std::vector<double> Pd;
  const float* P = random_p(buf, Pd, Bn, D, sym_p);
  add_operands(keep, E, U, C, Bn, D, r);
  std::vector<float> V(E.size(), NAN);
  for (int b = 0; b < Bn; ++b)
    for (int a = 0; a < 16; ++a)
      for (int c = 0; c < 16; ++c) {
        F16[b * 256 + a * 16 + c] =
            (a == c) + (a < 13 && c < 13 ? 0.3f * rnd() : 0.f);
        if (a < 13 && c <= a)
          Q16[b * 256 + a * 16 + c] = Q16[b * 256 + c * 16 + a] = rnd();
      }
  for (auto& h : Ht) h = rnd();
  const int rc = ekf_k1_manage_predict_pht(
      P, keep.data(), E.data(), U.data(), C.data(), F16.data(), Q16.data(),
      Ht.data(), V.data(), out.data(), pht.data(), Bn, D, R, r, nullptr);
  std::vector<double> ref(Pd), scale(Bn * DD);
  for (size_t n = 0; n < Bn * DD; ++n) scale[n] = std::abs(Pd[n]);
  for (int b = 0; b < Bn; ++b) {
    double* t = ref.data() + b * DD;
    double* s = scale.data() + b * DD;
    add_ref(t, s, keep.data() + size_t(b) * D, E.data() + size_t(b) * r * D,
            U.data() + size_t(b) * r * D, C.data() + size_t(b) * r * r, D, r);
    stripe_ref(t, s, F16.data() + b * 256, 16, D);
    for (int a = 0; a < 16; ++a)
      for (int c = 0; c < 16; ++c) {
        t[a * D + c] += Q16[b * 256 + a * 16 + c];
        s[a * D + c] += std::abs(Q16[b * 256 + a * 16 + c]);
      }
  }
  const bool ok = report("k1", rc, out, ref, scale, Bn, D, sym_p);
  return report_pht("k1", pht, ref, scale, Ht, Bn, D, R) && ok;
}


template <int T, bool NORMS>
void register_k7_form() {
  g_kernels[reinterpret_cast<const void*>(
      k7_kernel<T, K7_TY, K7_TX, NORMS>)] = [](void** a) {
    k7_kernel<T, K7_TY, K7_TX, NORMS>(
        *(const float**)a[0], *(const float**)a[1], *(float**)a[2],
        *(float**)a[3], *(float**)a[4], *(K7Geo*)a[5]);
  };
}

// K7 on N random pairs: windows in [0, 1) plus 0, 40 or 80 (pair n % 3: a
// window centred on another pair's mean loses its variance to
// cancellation), zero-mean templates; the correlation, and with `norms`
// the patch variances and energies, against f64 loops (the norms by
// direct box sums of the centred window).
bool run_k7(int N, int W2, int t, bool norms) {
  register_k7_form<K7_T, false>();
  register_k7_form<K7_T, true>();
  register_k7_form<0, false>();
  register_k7_form<0, true>();
  const int R2 = W2 - t + 1;
  const size_t nw = static_cast<size_t>(W2) * W2, nt = size_t(t) * t;
  const size_t no = static_cast<size_t>(R2) * R2;
  std::vector<float> wbuf(N * nw + 1), tm(N * nt), corr(N * no, NAN),
      var(N * no, NAN), energy(N, NAN);
  float* win = wbuf.data() + 1;
  std::uniform_real_distribution<float> unit(0.f, 1.f);
  for (size_t i = 0; i < N * nw; ++i) win[i] = 40.f * (i / nw % 3) + unit(rng);
  for (int n = 0; n < N; ++n) {
    double m = 0;
    for (size_t i = 0; i < nt; ++i) m += tm[n * nt + i] = rnd();
    for (size_t i = 0; i < nt; ++i) tm[n * nt + i] -= float(m / nt);
  }
  const int rc = norms ? ekf_k7_ncc_corr_norms(win, tm.data(), corr.data(),
                                                var.data(), energy.data(), N,
                                                W2, t, nullptr)
                       : ekf_k7_ncc_corr(win, tm.data(), corr.data(), N, W2,
                                         t, nullptr);
  auto worse = [](double& worst, double got, double ref, double limit) {
    const double e = std::abs(got - ref) / (limit + 1e-30);
    worst = std::isnan(got) ? 1e9 : std::max(worst, e);
  };
  double wc_ = 0, wv = 0, we = 0;
  std::vector<double> c(nw);
  for (int n = 0; n < N; ++n) {
    const float* w = win + n * nw;
    double m = 0, e = 0;
    for (size_t i = 0; i < nw; ++i) m += w[i];
    m /= double(nw);
    for (size_t i = 0; i < nw; ++i) e += (c[i] = w[i] - m) * c[i];
    for (int oy = 0; oy < R2; ++oy)
      for (int ox = 0; ox < R2; ++ox) {
        double s = 0, sc = 0, box = 0, sq = 0;
        for (int dy = 0; dy < t; ++dy)
          for (int dx = 0; dx < t; ++dx) {
            const size_t i = size_t(oy + dy) * W2 + ox + dx;
            const double p = double(w[i]) * tm[n * nt + dy * t + dx];
            s += p, sc += std::abs(p), box += c[i], sq += c[i] * c[i];
          }
        const size_t o = n * no + size_t(oy) * R2 + ox;
        worse(wc_, corr[o], s, 1e-5 * sc);
        if (norms)
          worse(wv, var[o], std::max(sq - box * box / (t * t), 0.0), 1e-5 * e);
      }
    if (norms) worse(we, energy[n], e, 1e-5 * e);
  }
  printf("k7 rc=%d blocks=%ld worst corr=%.3f var=%.3f energy=%.3f of the "
         "limit\n", rc, g_blocks, wc_, wv, we);
  return rc == 0 && wc_ <= 1 && wv <= 1 && we <= 1;
}


// --- eight_point_fit (csrc/eight_point.cu) ----------------------------------

void register_ep() {
  g_kernels[reinterpret_cast<const void*>(ep_kernel)] = [](void** a) {
    ep_kernel(*(const float**)a[0], *(float**)a[1], *(float**)a[2],
              *(int*)a[3]);
  };
}

// Cyclic Jacobi in f64 on the symmetric n x n s (row-major, overwritten by
// its diagonal form) until its off-diagonal entries vanish; v (n x n) the
// accumulated rotations.
void jacobi_f64(std::vector<double>& s, std::vector<double>& v, int n) {
  v.assign(n * n, 0.0);
  for (int i = 0; i < n; ++i) v[i * n + i] = 1.0;
  for (int sweep = 0; sweep < 60; ++sweep) {
    double off = 0;
    for (int p = 0; p < n; ++p)
      for (int q = p + 1; q < n; ++q) off += s[p * n + q] * s[p * n + q];
    if (off == 0) break;
    for (int p = 0; p < n; ++p)
      for (int q = p + 1; q < n; ++q) {
        const double apq = s[p * n + q];
        if (apq == 0) continue;
        const double tau = (s[q * n + q] - s[p * n + p]) / (2 * apq);
        const double t = std::copysign(1.0, tau) /
                         (std::abs(tau) + std::sqrt(1 + tau * tau));
        const double c = 1 / std::sqrt(1 + t * t), sn = t * c;
        for (int k = 0; k < n; ++k) {  // columns p, q, then rows p, q
          const double kp = s[k * n + p], kq = s[k * n + q];
          s[k * n + p] = c * kp - sn * kq;
          s[k * n + q] = sn * kp + c * kq;
        }
        for (int k = 0; k < n; ++k) {
          const double pk = s[p * n + k], qk = s[q * n + k];
          s[p * n + k] = c * pk - sn * qk;
          s[q * n + k] = sn * pk + c * qk;
        }
        s[p * n + q] = s[q * n + p] = 0;
        for (int k = 0; k < n; ++k) {
          const double kp = v[k * n + p], kq = v[k * n + q];
          v[k * n + p] = c * kp - sn * kq;
          v[k * n + q] = sn * kp + c * kq;
        }
      }
  }
}

// Operands of case `kind` for matrix n: the 8-point system M = Σ_k w_k
// a_k·a_kᵀ of random normalized correspondences (a_k the design row of
// _eight_point), 8 to 12 rows, weights in [0.5, 1.5] (kind 0, and the
// finite matrices of kind 3); Q·diag(λ)·Qᵀ with a repeated eigenvalue
// above a single smallest one (kind 1, even n) or a repeated smallest one
// (odd n); 8 rows of which one to three weigh 0 (kind 2: the null space
// has two to four dimensions); one entry NaN, +inf or −inf on every third
// matrix (kind 3); I on even n, 4·I on odd n (kind 4); kind 0's systems
// times 2⁺⁴⁰ on even n and 2⁻⁴⁰ on odd n (kind 5: the kernel's scaling).
void ep_operand(int kind, int n, float* M) {
  std::uniform_real_distribution<double> u(-1.4, 1.4), w(0.5, 1.5);
  std::vector<double> S(81, 0.0);
  if (kind == 1) {
    std::vector<double> Q(81), v;
    for (auto& q : Q) q = rnd();
    for (int j = 0; j < 9; ++j) {      // Gram-Schmidt on Q's columns
      for (int k = 0; k < j; ++k) {
        double d = 0;
        for (int i = 0; i < 9; ++i) d += Q[i * 9 + j] * Q[i * 9 + k];
        for (int i = 0; i < 9; ++i) Q[i * 9 + j] -= d * Q[i * 9 + k];
      }
      double nn = 0;
      for (int i = 0; i < 9; ++i) nn += Q[i * 9 + j] * Q[i * 9 + j];
      for (int i = 0; i < 9; ++i) Q[i * 9 + j] /= std::sqrt(nn);
    }
    const double lam_a[9] = {1e-3, 0.5, 0.5, 0.5, 1, 2, 2, 3, 4};
    const double lam_b[9] = {0.1, 0.1, 1, 1.5, 2, 2.5, 3, 3.5, 4};
    const double* lam = n % 2 == 0 ? lam_a : lam_b;
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j)
        for (int k = 0; k < 9; ++k)
          S[i * 9 + j] += Q[i * 9 + k] * lam[k] * Q[j * 9 + k];
  } else if (kind == 4) {
    for (int i = 0; i < 9; ++i) S[i * 10] = n % 2 == 0 ? 1.0 : 4.0;
  } else {
    const int rows = kind == 2 ? 8 : 8 + n % 5;
    for (int k = 0; k < rows; ++k) {
      const double x1 = u(rng), y1 = u(rng), x2 = u(rng), y2 = u(rng);
      const double a[9] = {x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                           x1, y1, 1.0};
      const double wk = kind == 2 && k < 1 + n % 3 ? 0.0 : w(rng);
      for (int i = 0; i < 9; ++i)
        for (int j = 0; j < 9; ++j) S[i * 9 + j] += wk * a[i] * a[j];
    }
  }
  const double scale = kind != 5 ? 1 : n % 2 == 0 ? 0x1p40 : 0x1p-40;
  for (int i = 0; i < 81; ++i) M[i] = static_cast<float>(scale * S[i]);
  if (kind == 3 && n % 3 == 0) {
    const float bad[3] = {NAN, INFINITY, -INFINITY};
    M[(7 * n) % 81] = bad[n / 3 % 3];
  }
}

// eight_point_fit on N matrices of case `kind` (ep_operand) through the
// launcher (three matrices a block: the last block ragged for N not a
// multiple of 3). The matrices of a warp solve together, so the launch is
// held to itself: a second launch gives the same bits, and each matrix
// launched alone (N = 1) gives its slot's bits in the batch (a result does
// not depend on its neighbours or its place). Then against f64, for each
// matrix, S = ½(M + Mᵀ) in f64 and the launch's f and F₂:
//   |‖f‖ − 1| ≤ 1e-5;
//   fᵀ·S·f − λ₁ ≤ TOL·ε·‖S‖₂ (f lies in the smallest eigenspace; λ₁ and
//     ‖S‖₂ from an f64 Jacobi);
//   F₂ against F·(I − v₃v₃ᵀ) of F = f in f64 (v₃ from an f64 Jacobi of FᵀF),
//     each entry ≤ TOL·ε·κ_F, κ_F = 1 + (σ₂ + σ₃)/(σ₂ − σ₃) (the rank-2
//     projection's amplification; 1 where σ₂ = σ₃ = 0);
//   where the smallest eigenvalue is single ((λ₂ − λ₁) ≥ 1e-3·‖S‖₂): f
//     against the f64 eigenvector up to sign, each entry ≤ TOL·ε·‖S‖₂ /
//     (λ₂ − λ₁);
// ε = 2⁻²³ and TOL = 4. A non-finite M must give an all-NaN F₂ and f, and
// the identity's F₂ is e₀·e₀ᵀ exactly. Every output starts at 1e30, so an
// entry left unwritten fails these checks.
bool run_ep(int kind, int N) {
  register_ep();
  constexpr double EPS = 1.1920928955078125e-07, TOL = 4;
  std::vector<float> M(N * 81), F2(N * 9, 1e30f), fv(N * 9, 1e30f);
  std::vector<float> F2b(N * 9, 1e30f), fvb(N * 9, 1e30f);
  for (int n = 0; n < N; ++n) ep_operand(kind, n, M.data() + n * 81);
  int rc = ekf_eight_point_fit(M.data(), F2.data(), fv.data(), N, nullptr);
  rc |= ekf_eight_point_fit(M.data(), F2b.data(), fvb.data(), N, nullptr);
  const auto same = [](const float* a, const float* b) {
    return std::memcmp(a, b, 9 * sizeof(float)) == 0;
  };
  double w_norm = 0, w_ray = 0, w_f2 = 0, w_vec = 0;
  int bad = 0, repeat = 0, alone = 0, nonfinite = 0, unique = 0;
  for (int n = 0; n < N; ++n) {
    const float* m = M.data() + n * 81;
    const float* got = F2.data() + n * 9;
    const float* f = fv.data() + n * 9;
    repeat += !same(got, F2b.data() + n * 9) ||
              !same(f, fvb.data() + n * 9);
    std::vector<float> f2a(9, 1e30f), fa(9, 1e30f);
    rc |= ekf_eight_point_fit(m, f2a.data(), fa.data(), 1, nullptr);
    alone += !same(got, f2a.data()) || !same(f, fa.data());
    bool fin = true;
    for (int i = 0; i < 81; ++i) fin = fin && std::isfinite(m[i]);
    if (!fin) {
      ++nonfinite;
      for (int i = 0; i < 9; ++i)
        bad += !std::isnan(got[i]) || !std::isnan(f[i]);
      continue;
    }
    std::vector<double> S(81), V;
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j)
        S[i * 9 + j] = 0.5 * (double(m[i * 9 + j]) + double(m[j * 9 + i]));
    const std::vector<double> S0 = S;
    jacobi_f64(S, V, 9);
    std::vector<int> order(9);
    for (int i = 0; i < 9; ++i) order[i] = i;
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return S[a * 10] < S[b * 10]; });
    const double l1 = S[order[0] * 10], l2 = S[order[1] * 10];
    const double snorm = std::max(std::abs(S[order[0] * 10]),
                                  std::abs(S[order[8] * 10]));
    double nf = 0, ray = 0;
    for (int i = 0; i < 9; ++i) {
      nf += double(f[i]) * f[i];
      for (int j = 0; j < 9; ++j) ray += double(f[i]) * S0[i * 9 + j] * f[j];
    }
    w_norm = std::max(w_norm, std::abs(std::sqrt(nf) - 1) / 1e-5);
    w_ray = std::max(w_ray, (ray - l1) / (TOL * EPS * snorm + 1e-300));
    if (l2 - l1 >= 1e-3 * snorm) {
      ++unique;
      double dot = 0;
      for (int i = 0; i < 9; ++i) dot += f[i] * V[i * 9 + order[0]];
      const double sg = dot < 0 ? -1 : 1;
      for (int i = 0; i < 9; ++i)
        w_vec = std::max(w_vec, std::abs(f[i] - sg * V[i * 9 + order[0]]) /
                                    (TOL * EPS * snorm / (l2 - l1)));
    }
    // F·(I − v₃v₃ᵀ) in f64 from the eigensystem of FᵀF (the columns of F
    // as f64: its squared condition is well inside f64 here)
    std::vector<double> G(9, 0.0), W;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        for (int r = 0; r < 3; ++r)
          G[i * 3 + j] += double(f[3 * r + i]) * f[3 * r + j];
    jacobi_f64(G, W, 3);
    int k3 = 0;
    double sig[3];
    for (int j = 0; j < 3; ++j) {
      sig[j] = std::sqrt(std::max(G[j * 4], 0.0));
      if (G[j * 4] < G[k3 * 4]) k3 = j;
    }
    std::sort(sig, sig + 3);
    const double kf = sig[1] > sig[0]
                          ? 1 + (sig[1] + sig[0]) / (sig[1] - sig[0])
                      : sig[1] == 0 ? 1
                                    : 1e300;
    for (int r = 0; r < 3; ++r) {
      double uu = 0;
      for (int c = 0; c < 3; ++c) uu += double(f[3 * r + c]) * W[c * 3 + k3];
      for (int c = 0; c < 3; ++c) {
        const double ref = f[3 * r + c] - uu * W[c * 3 + k3];
        w_f2 = std::max(w_f2,
                        std::abs(got[3 * r + c] - ref) / (TOL * EPS * kf));
      }
    }
    if (kind == 4)
      for (int i = 0; i < 9; ++i) bad += got[i] != (i == 0 ? 1.f : 0.f);
  }
  printf("ep rc=%d blocks=%ld bad=%d repeat=%d alone=%d nonfinite=%d "
         "unique=%d worst norm=%.3f rayleigh=%.3f F2=%.3f eigvec=%.3f of the "
         "limit\n", rc, g_blocks, bad, repeat, alone, nonfinite, unique,
         w_norm, w_ray, w_f2, w_vec);
  return rc == 0 && bad == 0 && repeat == 0 && alone == 0 && w_norm <= 1 &&
         w_ray <= 1 && w_f2 <= 1 && w_vec <= 1;
}

// --- spd_inverse_newton (csrc/newton_inverse.cu) ----------------------------

void register_nsi() {
  g_kernels[reinterpret_cast<const void*>(nsi_kernel<64>)] = [](void** a) {
    nsi_kernel<64>(*(const float**)a[0], *(float**)a[1], *(int*)a[2]);
  };
  g_kernels[reinterpret_cast<const void*>(nsi_kernel<128>)] = [](void** a) {
    nsi_kernel<128>(*(const float**)a[0], *(float**)a[1], *(int*)a[2]);
  };
}

// Q·diag(λ)·Qᵀ scaled by D on both sides (n x n, f64): Q orthogonal (Gram-
// Schmidt on a random matrix), λ log-spaced from 1 to `cond`, D = e^z,
// z ~ N(0, 1/4) (a diagonal spread the Jacobi start takes out).
std::vector<double> nsi_spd(int n, double cond) {
  std::vector<double> Q(n * n), S(n * n, 0.0), D(n);
  for (auto& q : Q) q = rnd();
  for (int j = 0; j < n; ++j) {
    for (int k = 0; k < j; ++k) {
      double d = 0;
      for (int i = 0; i < n; ++i) d += Q[i * n + j] * Q[i * n + k];
      for (int i = 0; i < n; ++i) Q[i * n + j] -= d * Q[i * n + k];
    }
    double nn = 0;
    for (int i = 0; i < n; ++i) nn += Q[i * n + j] * Q[i * n + j];
    for (int i = 0; i < n; ++i) Q[i * n + j] /= std::sqrt(nn);
  }
  for (int i = 0; i < n; ++i) D[i] = std::exp(0.5 * rnd());
  for (int k = 0; k < n; ++k) {
    const double lam = n == 1 ? 1.0 : std::pow(cond, double(k) / (n - 1));
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        S[i * n + j] += Q[i * n + k] * lam * Q[j * n + k];
  }
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) S[i * n + j] *= D[i] * D[j];
  return S;
}

// Instance b of case `kind`, rounded to f32: SPD of condition 10^(1 + b%4)
// (kind 0); SPD of condition 1e2 but for instance 1, which has one NaN
// entry (kind 1), or one +inf / −inf entry (kind 2, on and off the
// diagonal), or a diagonal entry that is not > 0 (kind 3: on even b a row
// and column zeroed, so d = 0 there, replaced by 1, and that entry of X
// doubles each iteration; on odd b S_kk = −1, an indefinite S).
void nsi_operand(int kind, int b, int n, float* S) {
  const std::vector<double> A = nsi_spd(n, kind == 0 ? std::pow(10.0, 1 + b % 4)
                                                     : 100.0);
  for (int i = 0; i < n * n; ++i) S[i] = static_cast<float>(A[i]);
  const int k = (3 * b + 1) % n, m = (5 * b + 2) % n;
  if (kind == 1 && b == 1) S[k * n + m] = NAN;
  if (kind == 2 && b == 1) S[k * n + m] = m % 2 ? INFINITY : -INFINITY;
  if (kind == 3 && b % 2 == 0)
    for (int i = 0; i < n; ++i) S[k * n + i] = S[i * n + k] = 0.f;
  if (kind == 3 && b % 2 == 1) S[k * n + k] = -1.f;
}

// The plain version's function in f64 on one f32 S: the preconditioner
// (d not > 0 replaced by 1, rsd = 1/√d, λ̂ the largest Gershgorin row sum,
// NaN if any is), X₀ = (I / d) / λ̂, then 20 times X ← X·(2I − S·X).
std::vector<double> nsi_f64(const float* S, int n) {
  std::vector<double> d(n), rsd(n), X(n * n), T(n * n), Y(n * n);
  for (int i = 0; i < n; ++i) {
    d[i] = S[i * n + i] > 0 ? double(S[i * n + i]) : 1.0;
    rsd[i] = 1 / std::sqrt(d[i]);
  }
  double lam = 0;
  bool nan = false;
  for (int i = 0; i < n; ++i) {
    double s = 0;
    for (int j = 0; j < n; ++j) s += std::abs(double(S[i * n + j])) * rsd[i] * rsd[j];
    nan = nan || std::isnan(s);
    lam = i == 0 || s > lam ? s : lam;
  }
  if (nan) lam = NAN;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) X[i * n + j] = ((i == j ? 1.0 : 0.0) / d[j]) / lam;
  for (int it = 0; it < NSI_ITERS; ++it) {
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) {
        double y = 0;
        for (int k = 0; k < n; ++k) y += double(S[i * n + k]) * X[k * n + j];
        T[i * n + j] = (i == j ? 2.0 : 0.0) - y;
      }
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) {
        double y = 0;
        for (int k = 0; k < n; ++k) y += X[i * n + k] * T[k * n + j];
        Y[i * n + j] = y;
      }
    X.swap(Y);
  }
  return X;
}

// spd_inverse_newton on B instances of case `kind` (nsi_operand) through
// the launcher. Each instance is held, first, to itself launched alone
// (bit for bit: a block an instance, nothing shared between them); then to
// the f64 loop X of the same function (nsi_f64): where X is NaN the kernel
// is NaN, where X is ±inf the kernel is not finite, and where X is finite
// each entry is within TOL·κ̂·ε·√(|X_ii|·|X_jj|) of it. Newton–Schulz
// settles where each step's rounding, ε relative to ‖X‖·‖S‖·‖X‖, meets the
// contraction of the residual, so the f32 iteration ends about κ·ε from
// the f64 one, relative to X's own scale: κ̂ = ‖Ŝ‖_∞·‖X̂‖_∞ of the
// Jacobi-scaled Ŝ = D^-½·S·D^-½ and X̂ = D^½·X·D^½ (the condition the
// iteration sees; an instance with a non-finite X, or with ‖X̂‖_∞ past
// 1e30, gets no κ̂ and is held to being finite, or not, alone), and
// √(X_ii·X_jj) the Cauchy–Schwarz bound of an entry of an SPD inverse;
// ε = 2⁻²³, TOL = 4 (at n = 1, κ̂ = 1, the f32 fixed point may sit up to
// an ulp, one unit, from 1/s). A wrong index, mask or edge reads
// O(1/(κ̂·ε)) there.
// Every output starts at 1e30, so an entry left unwritten fails.
bool run_nsi(int B, int n, int kind) {
  register_nsi();
  constexpr double EPS = 1.1920928955078125e-07, TOL = 4;
  const size_t nn = size_t(n) * n;
  std::vector<float> S(B * nn), W(B * nn, 1e30f);
  for (int b = 0; b < B; ++b) nsi_operand(kind, b, n, S.data() + b * nn);
  int rc = ekf_spd_inverse_newton(S.data(), W.data(), B, n, nullptr);
  double worst = 0;
  int alone = 0, bad = 0, nonfinite = 0;
  for (int b = 0; b < B; ++b) {
    const float* s = S.data() + b * nn;
    const float* w = W.data() + b * nn;
    std::vector<float> Wa(nn, 1e30f);
    rc |= ekf_spd_inverse_newton(s, Wa.data(), 1, n, nullptr);
    alone += std::memcmp(w, Wa.data(), nn * sizeof(float)) != 0;
    const std::vector<double> X = nsi_f64(s, n);
    bool finite = true;
    for (size_t i = 0; i < nn; ++i) {
      finite = finite && std::isfinite(X[i]);
      if (std::isnan(X[i])) bad += !std::isnan(w[i]);
      else if (!std::isfinite(X[i])) bad += std::isfinite(w[i]);
    }
    nonfinite += !finite;
    std::vector<double> d(n);
    for (int i = 0; i < n; ++i) d[i] = s[i * n + i] > 0 ? double(s[i * n + i]) : 1.0;
    double sh = 0, xh = 0;
    for (int i = 0; i < n; ++i) {
      double rs = 0, rx = 0;
      for (int j = 0; j < n; ++j) {
        rs += std::abs(double(s[i * n + j])) / std::sqrt(d[i] * d[j]);
        rx += std::abs(X[i * n + j]) * std::sqrt(d[i] * d[j]);
      }
      sh = std::max(sh, rs);
      xh = std::max(xh, rx);
    }
    const bool held = finite && xh <= 1e30;
    for (size_t i = 0; i < nn; ++i) {
      if (!std::isfinite(X[i])) continue;
      const int r = i / n, c = i % n;
      const double diff = std::abs(double(w[i]) - X[i]);
      if (!held) {
        bad += !std::isfinite(w[i]);
        continue;
      }
      const double lim = TOL * sh * xh * EPS *
                         std::sqrt(std::abs(X[r * n + r] * X[c * n + c]));
      worst = std::max(worst, std::isnan(diff) ? 1e9
                              : diff == 0     ? 0.0
                                              : diff / lim);
    }
  }
  printf("nsi rc=%d blocks=%ld alone=%d bad=%d nonfinite=%d worst=%.3f of "
         "the limit\n", rc, g_blocks, alone, bad, nonfinite, worst);
  return rc == 0 && alone == 0 && bad == 0 && worst <= 1;
}

// --- span marks (csrc/spans.cu) ---------------------------------------------

int g_span = -1;  // 2·id + end of the last mark that ran

template <int... I>
void register_span(std::integer_sequence<int, I...>) {
  ((g_kernels[reinterpret_cast<const void*>(&span_mark<I / 2, I % 2>)] =
        [](void**) {
          span_mark<I / 2, I % 2>();
          g_span = I;
        }),
   ...);
}

bool run_span(int id, int end) {
  register_span(std::make_integer_sequence<int, 2 * SPAN_IDS>());
  const cudaError_t rc = ekf_span_mark(id, end, nullptr);
  const bool valid = 0 <= id && id < SPAN_IDS && (end == 0 || end == 1);
  const int want = valid ? 2 * id + end : -1;
  printf("span rc=%d ran=%d want=%d\n", rc, g_span, want);
  return valid ? rc == 0 && g_span == want : rc != 0 && g_span == -1;
}

// --- pht_blocks (csrc/pht_blocks.cu) --------------------------------------

template <typename T>
void register_pht() {
  g_kernels[reinterpret_cast<const void*>(phtb_kernel<T>)] = [](void** a) {
    phtb_kernel<T>(*(const T**)a[0], *(const float**)a[1],
                   *(const float**)a[2], *(const long long**)a[3],
                   *(const float**)a[4], *(float**)a[5], *(float**)a[6],
                   *(int*)a[7], *(int*)a[8]);
  };
}

template <typename V>
bool read_into(FILE* f, V* dst, size_t n) {
  return fread(dst, sizeof(V), n, f) == n;
}

// pht_blocks through its launcher on the operands in file `in`: int32 B,
// D, M; then P as stored (B·D·D entries), H_xv (B·M·2·13 f32), H_y
// (B·M·2·6 f32), sel (B·M int64), r (B·2M f32). P is copied to an odd
// offset inside a larger buffer, as a matrix of a batch lies, so the bulk
// copies of its 16-byte lines stay inside the buffer; the outputs' buffers
// start as NaN, so an entry nobody wrote shows. Writes int32 rc, then PHt
// (B·D·2M f32) and S (B·2M·2M f32) to `out`, which
// tests/test_torch_cuda_emulation.py holds against the plain version.
template <typename T>
bool run_pht(const char* in, const char* out) {
  register_pht<T>();
  FILE* f = fopen(in, "rb");
  if (!f) return false;
  int dims[3];
  if (!read_into(f, dims, 3)) return false;
  const int B = dims[0], D = dims[1], M = dims[2];
  const size_t DD = static_cast<size_t>(D) * D, N = 2 * M;
  std::vector<T> buf(B * DD + 32);
  T* P = buf.data() + 8 + D % 3;
  std::vector<float> Hxv(B * N * 13), Hy(B * N * 6), r(B * N);
  std::vector<long long> sel(static_cast<size_t>(B) * M);
  const bool ok = read_into(f, P, B * DD) &&
                  read_into(f, Hxv.data(), Hxv.size()) &&
                  read_into(f, Hy.data(), Hy.size()) &&
                  read_into(f, sel.data(), sel.size()) &&
                  read_into(f, r.data(), r.size());
  fclose(f);
  if (!ok) return false;
  std::vector<float> PHt(B * D * N, NAN), S(B * N * N, NAN);
  const int rc = ekf_pht_blocks(P, Hxv.data(), Hy.data(), sel.data(),
                                r.data(), PHt.data(), S.data(), B, D, M,
                                sizeof(T) == 2, nullptr);
  FILE* o = fopen(out, "wb");
  if (!o) return false;
  fwrite(&rc, sizeof(int), 1, o);
  fwrite(PHt.data(), sizeof(float), PHt.size(), o);
  fwrite(S.data(), sizeof(float), S.size(), o);
  fclose(o);
  printf("pht rc=%d blocks=%ld\n", rc, g_blocks);
  return rc == 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) return 2;
  const std::string kernel = argv[1], type = argv[2];
  if (kernel == "pht") {
    if (argc != 5) return 2;
    const bool ok = type == "bf16" ? run_pht<__nv_bfloat16>(argv[3], argv[4])
                                   : run_pht<float>(argv[3], argv[4]);
    return ok ? 0 : 1;
  }
  std::vector<int> n;
  for (int i = 3; i < argc; ++i) n.push_back(atoi(argv[i]));
  const size_t want = kernel == "ep" || kernel == "span" ? 2
                      : kernel == "k4" || kernel == "nsi"  ? 3
                      : kernel == "k7" ? 4
                                       : 5;
  if (n.size() != want) return 2;
  const bool bf16 = type == "bf16";
  bool ok;
  if (kernel == "k1")
    ok = !bf16 && run_k1(n[0], n[1], n[2], n[3], n[4]);
  else if (kernel == "k2")
    ok = !bf16 && run_k2(n[0], n[1], n[2], n[3], n[4]);
  else if (kernel == "k3")
    ok = !bf16 && run_k3(n[0], n[1], n[2], n[3], n[4]);
  else if (kernel == "k4")
    ok = bf16 ? run_k4<__nv_bfloat16>(n[0], n[1], n[2])
              : run_k4<float>(n[0], n[1], n[2]);
  else if (kernel == "k6")
    ok = bf16 ? run_k6<__nv_bfloat16>(n[0], n[1], n[2], n[3], n[4])
              : run_k6<float>(n[0], n[1], n[2], n[3], n[4]);
  else if (kernel == "k7")
    ok = !bf16 && run_k7(n[0], n[1], n[2], n[3]);
  else if (kernel == "ep")
    ok = !bf16 && run_ep(n[0], n[1]);
  else if (kernel == "span")
    ok = !bf16 && run_span(n[0], n[1]);
  else if (kernel == "nsi")
    ok = !bf16 && run_nsi(n[0], n[1], n[2]);
  else if (kernel == "k8s")
    ok = bf16 ? run_k8s<__nv_bfloat16>(n[0], n[1], n[2], n[3], n[4])
              : run_k8s<float>(n[0], n[1], n[2], n[3], n[4]);
  else if (kernel == "k8")
    ok = bf16 ? run_k8<__nv_bfloat16>(n[0], n[1], n[2], n[3], n[4])
              : run_k8<float>(n[0], n[1], n[2], n[3], n[4]);
  else
    return 2;
  return ok ? 0 : 1;
}
