"""The port's benchmark harnesses on the CPU at dataset "unit", against the
JAX package's: ``bench_bruteforce.run`` and ``bench_ivf.run`` write the same
files, CSV headers and ``metrics.txt`` sections; the IVF index cache a JAX
run writes loads in the port and gives JAX's recall; and
``bench_executor.run`` serves an index it is handed.

The data root of both packages is redirected to the test's ``tmp_path``,
so no test touches the repository's ``data/``.
"""

import os

import numpy as np
import pytest

from rag_on_edge_tpu.harness import bench_bruteforce as jbb
from rag_on_edge_tpu.harness import bench_ivf as jbi
from rag_on_edge_tpu.utils import datasets as jdatasets
from rag_on_edge_tpu.utils import metrics as jmetrics
from rag_on_edge_tpu_torch.harness import bench_bruteforce, bench_executor, bench_ivf
from rag_on_edge_tpu_torch.utils import datasets, metrics


@pytest.fixture(autouse=True)
def _data_root(tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    for target in ("rag_on_edge_tpu.utils.datasets.DEFAULT_DATA_ROOT",
                   "rag_on_edge_tpu.harness.bench_ivf.DEFAULT_DATA_ROOT",
                   "rag_on_edge_tpu_torch.utils.datasets.DEFAULT_DATA_ROOT",
                   "rag_on_edge_tpu_torch.harness.bench_ivf.DEFAULT_DATA_ROOT"):
        monkeypatch.setattr(target, root)
    yield


def _tree(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, files in os.walk(out) for f in files)


def _sections(path):
    with open(path) as f:
        return [line.strip() for line in f if line.startswith("=== ")]


def test_bench_bruteforce_run_writes_jax_files(tmp_path):
    kw = dict(dataset="unit", batch=8, k=5, dtype="int8", repeats=2, quiet=True)
    r = bench_bruteforce.run(outdir=str(tmp_path / "torch"), device="cpu", **kw)
    jr = jbb.run(outdir=str(tmp_path / "jax"), **kw)
    assert r["qps"] > 0 and 0.5 <= r["recall"] <= 1.0
    assert set(r) == set(jr)
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    cfg = "unit_b8_k5_int8"
    assert (_sections(tmp_path / "torch" / cfg / "metrics.txt")
            == _sections(tmp_path / "jax" / cfg / "metrics.txt"))
    rows = {pkg: (tmp_path / pkg / "benchmark_bruteforce.csv").read_text().splitlines()
            for pkg in ("torch", "jax")}
    assert rows["torch"][0] == rows["jax"][0] == "dataset,batch,qps,gflops,avg_ms,p95_ms,p99_ms"
    assert rows["torch"][1].startswith("unit,8,")
    lines = (tmp_path / "torch" / cfg / "results.txt").read_text().splitlines()
    assert len(lines) == 32 and lines[0].startswith("Query 0: (")


def test_bench_ivf_run_writes_jax_files(tmp_path):
    kw = dict(dataset="unit", nlist=16, nprobes=(4,), k=5, batch=8, repeats=2, quiet=True,
              mode="query", vs_brute=False)
    rows = bench_ivf.run(outdir=str(tmp_path / "torch"), device="cpu", **kw)
    jrows = jbi.run(outdir=str(tmp_path / "jax"), **kw)
    assert len(rows) == 1 and rows[0]["recall"] >= 0.5
    assert set(rows[0]) == set(jrows[0])
    # Both runs share one data root: the JAX run loaded the port's cache.
    assert rows[0]["recall"] == jrows[0]["recall"]
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    cfg = "unit_ivf16_np4_b8_k5_fp32"
    assert (_sections(tmp_path / "torch" / cfg / "metrics.txt")
            == _sections(tmp_path / "jax" / cfg / "metrics.txt"))
    head = {pkg: (tmp_path / pkg / "benchmark_ivf.csv").read_text().splitlines()[0]
            for pkg in ("torch", "jax")}
    assert head["torch"] == head["jax"] == ("dataset,nprobe,top_k,recall,qps,avg_ms,p50_ms,"
                                            "p95_ms,p99_ms,avg_candidates,reduction")
    timing_txt = (tmp_path / "torch" / "timing.txt").read_text()
    assert timing_txt.startswith("index_build_or_load_s: ")


def test_port_loads_jax_index_cache(tmp_path):
    """An index cache the JAX package's ``build_or_load_index`` wrote under
    the data root loads in the port's (same name, same artifact set, no
    rebuild) and searches to JAX's recall exactly."""
    jds = jdatasets.load_dataset("unit", gt_k=10)
    jidx = jbi.build_or_load_index(jds, 16, "l2", "int8")
    ds = datasets.load_dataset("unit", gt_k=10, device="cpu")
    cache = os.path.join(datasets.DEFAULT_DATA_ROOT, "unit", "ivf_nlist16_l2_int8_seed42_pp")
    assert os.path.exists(os.path.join(cache, "ivf_config.json"))
    stamp = os.path.getmtime(os.path.join(cache, "ivf_config.json"))
    idx = bench_ivf.build_or_load_index(ds, 16, "l2", "int8", device="cpu")
    assert os.path.getmtime(os.path.join(cache, "ivf_config.json")) == stamp
    for name in ("_centroids_np", "_vectors_np", "_offsets_np", "_reorder_np"):
        np.testing.assert_array_equal(getattr(idx, name), getattr(jidx, name))
    ids, _, cand = idx.search(ds.queries, k=10, nprobe=4, mode="query")
    jids, _, jcand = jidx.search(jds.queries, k=10, nprobe=4, mode="query")
    np.testing.assert_array_equal(ids, jids)
    assert cand == jcand
    assert (metrics.recall_at_k(ids, ds.ground_truth_l2, 10)
            == jmetrics.recall_at_k(jids, jds.ground_truth_l2, 10))


def test_build_or_load_index_resumes_and_clears_its_checkpoint(tmp_path):
    """The port's cache build writes the k-means checkpoint beside the
    cache, resumes from it, and removes it once the index is saved; the
    centroid cache is written once per dataset."""
    ds = datasets.load_dataset("unit", gt_k=10, device="cpu")
    root = os.path.join(datasets.DEFAULT_DATA_ROOT, "unit")
    idx = bench_ivf.build_or_load_index(ds, 16, "l2", "int8", device="cpu")
    assert not [f for f in os.listdir(root) if f.endswith(".kmeans_ckpt.npz")]
    assert os.path.exists(os.path.join(root, "centroids_nlist16_seed42_pp_mi100.npy"))
    idx2 = bench_ivf.build_or_load_index(ds, 16, "l2", "fp32", device="cpu")
    np.testing.assert_array_equal(idx2._centroids_np, idx._centroids_np)


def test_bench_executor_run_serves_a_given_index():
    ds = datasets.load_dataset("unit", gt_k=10, device="cpu")
    idx = bench_ivf.build_or_load_index(ds, 16, "l2", "int8", device="cpu")
    r = bench_executor.run(dataset="unit", batch=16, nprobe=4, k=10, requests=200,
                           max_delay_ms=2.0, inflight=4, quiet=True, index=idx)
    assert r["qps_end_to_end"] > 0
    assert 0.0 <= r["recall"] <= 1.0
    assert r["wire"] == "uint8"  # the synthetic corpus is integral
    assert r["pipeline"]["rows_dispatched"] == 200
    assert r["pipeline"]["batches_collected"] == r["pipeline"]["batches_dispatched"]
