// cpu_oracle_main — standalone exact-search baseline binary
// (counterpart: rag_on_edge_tpu/runtime/cpu_oracle_main.cpp, copied
// unchanged in its code).
//
// The runnable counterpart of the reference's cpu/cpu_baseline.cpp with the
// CLI its README documents but its main() never wired (the reference
// hardcodes both datasets, cpu_baseline.cpp:323-346 vs cpu/README.md:82-103):
//
//   cpu_oracle <base.fvecs> <query.fvecs> <top_k> [results_dir] [metric]
//
// metric: "ip" (default) or "l2".  Writes results.txt in the shared
// cross-backend row format ("Query i: (idx, score) ...",
// cpu_baseline.cpp:167-173) and prints throughput/latency statistics
// (run_benchmark, cpu_baseline.cpp:177-321).
//
// Build: runtime/oracle.py build_binary(), or
//   g++ -O3 -march=native -std=c++17 -fopenmp cpu_oracle_main.cpp cpu_oracle.cpp -o cpu_oracle

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

extern "C" int oracle_search(const float*, int64_t, const float*, int64_t,
                             int32_t, int32_t, int32_t, int32_t*, float*);

namespace {

// fvecs: per vector an int32 dim header then dim float32 payload
// (reference readers: cpu_baseline.cpp:31-58).
bool read_fvecs(const std::string& path, std::vector<float>& out,
                int64_t& n, int32_t& dim) {
    std::ifstream f(path, std::ios::binary);
    if (!f) return false;
    int32_t d = 0;
    if (!f.read(reinterpret_cast<char*>(&d), 4) || d <= 0) return false;
    f.seekg(0, std::ios::end);
    const int64_t bytes = f.tellg();
    const int64_t rec = 4 + int64_t(d) * 4;
    if (bytes % rec != 0) return false;
    n = bytes / rec;
    dim = d;
    out.resize(size_t(n) * d);
    f.seekg(0, std::ios::beg);
    for (int64_t i = 0; i < n; ++i) {
        int32_t di;
        f.read(reinterpret_cast<char*>(&di), 4);
        if (di != d) return false;
        f.read(reinterpret_cast<char*>(out.data() + i * d), int64_t(d) * 4);
    }
    return bool(f);
}

double percentile(std::vector<double> v, double p) {
    if (v.empty()) return 0.0;
    std::sort(v.begin(), v.end());
    const double idx = p / 100.0 * (v.size() - 1);
    const size_t lo = size_t(idx);
    const size_t hi = std::min(lo + 1, v.size() - 1);
    return v[lo] + (v[hi] - v[lo]) * (idx - lo);
}

}  // namespace

int main(int argc, char** argv) {
    if (argc < 4) {
        std::fprintf(stderr,
                     "usage: %s <base.fvecs> <query.fvecs> <top_k> "
                     "[results_dir] [metric=ip|l2]\n", argv[0]);
        return 2;
    }
    const std::string base_path = argv[1], query_path = argv[2];
    const int k = std::atoi(argv[3]);
    const std::string results_dir = argc > 4 ? argv[4] : "";
    const std::string metric = argc > 5 ? argv[5] : "ip";
    if (metric != "ip" && metric != "l2") {
        std::fprintf(stderr, "unknown metric %s\n", metric.c_str());
        return 2;
    }

    std::vector<float> base, queries;
    int64_t n = 0, nq = 0;
    int32_t d = 0, dq = 0;
    if (!read_fvecs(base_path, base, n, d) ||
        !read_fvecs(query_path, queries, nq, dq) || d != dq) {
        std::fprintf(stderr, "failed to load fvecs (or dim mismatch)\n");
        return 1;
    }
    std::printf("base: %lld x %d, queries: %lld x %d, k=%d, metric=%s\n",
                static_cast<long long>(n), d, static_cast<long long>(nq), d,
                k, metric.c_str());

    std::vector<int32_t> ids(size_t(nq) * k);
    std::vector<float> scores(size_t(nq) * k);
    std::vector<double> per_query_ms;
    per_query_ms.reserve(size_t(nq));

    const auto t0 = std::chrono::steady_clock::now();
    // Per-query timing loop (reference times each query,
    // cpu_baseline.cpp:222-254).
    for (int64_t i = 0; i < nq; ++i) {
        const auto q0 = std::chrono::steady_clock::now();
        const int rc = oracle_search(queries.data() + i * d, 1, base.data(), n,
                                     d, k, metric == "ip" ? 0 : 1,
                                     ids.data() + i * k, scores.data() + i * k);
        if (rc != 0) {
            std::fprintf(stderr, "oracle_search failed (%d)\n", rc);
            return 1;
        }
        per_query_ms.push_back(
            std::chrono::duration<double, std::milli>(
                std::chrono::steady_clock::now() - q0).count());
    }
    const double total_s = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count();

    double mean = 0;
    for (double v : per_query_ms) mean += v;
    mean /= std::max<size_t>(per_query_ms.size(), 1);
    std::printf("throughput_qps: %.1f\n", nq / total_s);
    std::printf("per_query_latency_ms: mean=%.4f p50=%.4f p95=%.4f p99=%.4f\n",
                mean, percentile(per_query_ms, 50), percentile(per_query_ms, 95),
                percentile(per_query_ms, 99));
    std::printf("gflops: %.2f\n", 2.0 * nq * d * n / total_s / 1e9);

    if (!results_dir.empty()) {
        std::ofstream rf(results_dir + "/results.txt");
        for (int64_t i = 0; i < nq; ++i) {
            rf << "Query " << i << ":";
            for (int j = 0; j < k; ++j) {
                rf << " (" << ids[i * k + j] << ", " << scores[i * k + j] << ")";
            }
            rf << "\n";
        }
        std::printf("wrote %s/results.txt\n", results_dir.c_str());
    }
    return 0;
}
