// Runs K6 (f32_matmul_big) or K8 (corr_apply) of csrc/unfused_cov.cu on the
// CPU through the stand-in headers beside this file, on random operands,
// and holds the result against a plain f64 loop.
//
//   g++ -std=c++20 -O1 -fsanitize=address -I tests/cuda_emulation
//       -I ekf_slam_tpu_torch/csrc -x c++ tests/cuda_emulation/harness.cpp
//       -o emulate -lpthread
//   ./emulate k6 f32|bf16 B M K N misalign     (misalign: C off 16 bytes)
//   ./emulate k8 f32|bf16 B D R mode symP      (mode 0 none, 1 expr, 2 full)
//
// Prints one line and exits 0 when every entry is within tolerance (K6:
// 1e-5 of Σ|a||b|; K8: 1e-5 of |P| + |At|ᵀ|Bt| + |Bt|ᵀ|At|, plus one bf16
// ulp on a bf16 output), every entry was written, and K8's output is
// bitwise symmetric where it must be ("full"; "expr" on a symmetric P).
// P lies at an odd offset inside a larger buffer, as a matrix of a batch
// does, so the bulk copies of its 16-byte lines stay inside the buffer.
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
  std::vector<PT> buf(Bn * DD + 32), out(Bn * DD);
  PT* P = buf.data() + 8 + D % 3;
  std::vector<float> At(static_cast<size_t>(Bn) * R * D), Bt(At.size());
  for (int b = 0; b < Bn; ++b)
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) {
        put(&P[b * DD + i * D + j], rnd());
        if (sym_p && j < i) P[b * DD + i * D + j] = P[b * DD + j * D + i];
      }
  for (auto& a : At) a = rnd();
  for (auto& b : Bt) b = rnd();
  for (auto& o : out) put(&o, NAN);
  const int rc = ekf_k8_corr_apply(P, At.data(), Bt.data(), out.data(), Bn, D,
                                   R, mode, sizeof(PT) == 2, nullptr);
  double worst = 0;
  bool symmetric = true;
  for (int b = 0; b < Bn; ++b)
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) {
        double s1 = 0, s2 = 0, scale = 0;
        for (int k = 0; k < R; ++k) {
          const size_t row = (static_cast<size_t>(b) * R + k) * D;
          const double p1 = static_cast<double>(At[row + i]) * Bt[row + j];
          const double p2 = static_cast<double>(Bt[row + i]) * At[row + j];
          s1 += p1, s2 += p2, scale += std::abs(p1) + std::abs(p2);
        }
        const double pij = value(P[b * DD + i * D + j]);
        const double pji = value(P[b * DD + j * D + i]);
        const double ref = mode == 0   ? pij + s1
                           : mode == 1 ? pij + 0.5 * (s1 + s2)
                                       : 0.5 * (pij + pji) + 0.5 * (s1 + s2);
        const double got = value(out[b * DD + i * D + j]);
        double limit = 1e-5 * (std::abs(pij) + std::abs(pji) + scale) + 1e-30;
        if (sizeof(PT) == 2) limit += std::abs(ref) / 128;  // >= one bf16 ulp
        const double err = std::abs(got - ref) / limit;
        worst = std::isnan(got) ? 1e9 : std::max(worst, err);
        if (memcmp(&out[b * DD + i * D + j], &out[b * DD + j * D + i],
                   sizeof(PT)))
          symmetric = false;
      }
  const bool must = mode == 2 || (mode == 1 && sym_p);
  printf("k8 rc=%d blocks=%ld worst=%.3f of the limit symmetric=%d\n", rc,
         g_blocks, worst, symmetric);
  return rc == 0 && worst <= 1 && (symmetric || !must);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const std::string kernel = argv[1], type = argv[2];
  int n[5];
  for (int i = 0; i < 5; ++i) n[i] = atoi(argv[3 + i]);
  bool ok;
  if (kernel == "k6")
    ok = type == "bf16" ? run_k6<__nv_bfloat16>(n[0], n[1], n[2], n[3], n[4])
                        : run_k6<float>(n[0], n[1], n[2], n[3], n[4]);
  else
    ok = type == "bf16" ? run_k8<__nv_bfloat16>(n[0], n[1], n[2], n[3], n[4])
                        : run_k8<float>(n[0], n[1], n[2], n[3], n[4]);
  return ok ? 0 : 1;
}
