// cpu_oracle — native exact k-NN search, the recall ground truth
// (counterpart: rag_on_edge_tpu/runtime/cpu_oracle.cpp, copied unchanged in
// its code).
//
// The rebuild of the reference's CPU baseline (its cpu/cpu_baseline.cpp):
// precomputed squared norms with AVX2+FMA (+OpenMP when available), a
// blocked GEMM-style score pass, and an O(N*k) insertion top-k per query.
// Differences from the reference, by design:
//   - exposed as a C shared library (ctypes) instead of a standalone binary,
//     so the Python harness drives it directly (the reference's main()
//     ignored argv — cpu_baseline.cpp:323-346 — we keep the documented API);
//   - supports both ranking conventions explicitly: inner product
//     (descending) and L2 distance (ascending) — SURVEY §2.5;
//   - no OpenBLAS dependency: a hand-blocked AVX2 dot-product microkernel
//     stands in for cblas_sgemm.
//
// Build: runtime/oracle.py build_library() (g++ -O3 -march=native -std=c++17
// -fopenmp -shared -fPIC, retried without -fopenmp).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// 8-lane AVX2+FMA dot product, the analog of compute_norm_avx2
// (cpu_baseline.cpp:95-114) generalized to dot(a, b).
inline float dot_avx2(const float* a, const float* b, int d) {
#if defined(__AVX2__)
    __m256 acc0 = _mm256_setzero_ps();
    __m256 acc1 = _mm256_setzero_ps();
    int i = 0;
    for (; i + 16 <= d; i += 16) {
        acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i), acc0);
        acc1 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i + 8), _mm256_loadu_ps(b + i + 8), acc1);
    }
    for (; i + 8 <= d; i += 8) {
        acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i), acc0);
    }
    acc0 = _mm256_add_ps(acc0, acc1);
    __m128 lo = _mm256_castps256_ps128(acc0);
    __m128 hi = _mm256_extractf128_ps(acc0, 1);
    lo = _mm_add_ps(lo, hi);
    lo = _mm_hadd_ps(lo, lo);
    lo = _mm_hadd_ps(lo, lo);
    float out = _mm_cvtss_f32(lo);
    for (; i < d; ++i) out += a[i] * b[i];
    return out;
#else
    float out = 0.f;
    for (int i = 0; i < d; ++i) out += a[i] * b[i];
    return out;
#endif
}

// O(N*k) insertion top-k over a score row, "larger is better"
// (select_topk, cpu_baseline.cpp:127-153).
inline void select_topk(const float* scores, int64_t n, int k,
                        int32_t* out_ids, float* out_scores) {
    std::vector<std::pair<float, int64_t>> heap;  // min-heap by score
    heap.reserve(static_cast<size_t>(k));
    auto cmp = [](const std::pair<float, int64_t>& a, const std::pair<float, int64_t>& b) {
        return a.first > b.first;  // min-heap on score
    };
    for (int64_t i = 0; i < n; ++i) {
        float s = scores[i];
        if (static_cast<int>(heap.size()) < k) {
            heap.emplace_back(s, i);
            std::push_heap(heap.begin(), heap.end(), cmp);
        } else if (s > heap.front().first) {
            std::pop_heap(heap.begin(), heap.end(), cmp);
            heap.back() = {s, i};
            std::push_heap(heap.begin(), heap.end(), cmp);
        }
    }
    // Best (largest score) first, ties by lower id.
    std::sort(heap.begin(), heap.end(), [](const auto& a, const auto& b) {
        if (a.first != b.first) return a.first > b.first;
        return a.second < b.second;
    });
    for (size_t i = 0; i < heap.size(); ++i) {
        out_scores[i] = heap[i].first;
        out_ids[i] = static_cast<int32_t>(heap[i].second);
    }
}

}  // namespace

extern "C" {

// Exact search: queries [nq, d], base [n, d] row-major float32.
// metric: 0 = inner product (score = q·b), 1 = L2 (score = -(‖b‖²-2q·b),
// larger-is-better, same ranking as ascending distance).
// Outputs: out_ids [nq, k] int32, out_scores [nq, k] float32.
// Returns 0 on success.
int oracle_search(const float* queries, int64_t nq,
                  const float* base, int64_t n, int32_t d,
                  int32_t k, int32_t metric,
                  int32_t* out_ids, float* out_scores) {
    if (k <= 0 || k > n || d <= 0 || (metric != 0 && metric != 1)) return -1;

    // Precompute ‖b‖² once (cpu_baseline.cpp:209-212).
    std::vector<float> base_norms;
    if (metric == 1) {
        base_norms.resize(static_cast<size_t>(n));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int64_t i = 0; i < n; ++i) {
            const float* b = base + i * d;
            base_norms[static_cast<size_t>(i)] = dot_avx2(b, b, d);
        }
    }

#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<float> scores(static_cast<size_t>(n));
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
        for (int64_t q = 0; q < nq; ++q) {
            const float* qv = queries + q * d;
            for (int64_t i = 0; i < n; ++i) {
                float s = dot_avx2(qv, base + i * d, d);
                scores[static_cast<size_t>(i)] =
                    (metric == 0) ? s : 2.f * s - base_norms[static_cast<size_t>(i)];
            }
            select_topk(scores.data(), n, k, out_ids + q * k, out_scores + q * k);
        }
    }
    return 0;
}

// Version tag so Python can sanity-check the loaded library.
int oracle_abi_version() { return 1; }

}  // extern "C"
