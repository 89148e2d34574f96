"""The port's profilers, sweeps, skew and recovery harnesses, timing
protocol and kernel-library cache on the CPU, against the JAX package's.

One JAX IVF index over ``small_data`` (nlist 16, L2, int8, pad_block 128:
clusters span 1-3 blocks) is carried into the port through
``IVFIndex.from_arrays``.  The harnesses that load a dataset run at dataset
"unit" with both packages' data roots redirected to one temporary
directory: the JAX run builds the index cache and the port's run loads it,
so both search the same index.  The corpus is integer-valued, so every
recall and spill is compared exactly; times are only checked to be
positive and finite (a CPU time says nothing of the card).
"""

import json
import math
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.harness import qcap_calib as jqcap
from rag_on_edge_tpu.harness import recover_lab as jlab
from rag_on_edge_tpu.harness import recover_sweep as jsweep_r
from rag_on_edge_tpu.harness import sweep as jsweep
from rag_on_edge_tpu.harness import timing as jtiming
from rag_on_edge_tpu.models import ivf as jivf
from rag_on_edge_tpu.parallel import ShardedIVFIndex as JIVF
from rag_on_edge_tpu.parallel import make_mesh as jax_mesh
from rag_on_edge_tpu_torch.harness import (profile_ivf, profile_sharded, qcap_calib,
                                           recover_lab, recover_sweep, sweep, sweep10m,
                                           timing, warmup)
from rag_on_edge_tpu_torch.models import ivf as tivf
from rag_on_edge_tpu_torch.ops import _build
from rag_on_edge_tpu_torch.parallel import ShardedIVFIndex
from rag_on_edge_tpu_torch.utils import datasets
from rag_on_edge_tpu_torch.utils.cache import enable_compilation_cache

K, NPROBE = 10, 4


@pytest.fixture(scope="module")
def module_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("profile") / "data")


@pytest.fixture
def data_root(module_root, monkeypatch):
    """One data root for the module: dataset "unit" and its index caches are
    made once and shared by the harness tests."""
    root = module_root
    for target in ("rag_on_edge_tpu.utils.datasets.DEFAULT_DATA_ROOT",
                   "rag_on_edge_tpu.harness.bench_ivf.DEFAULT_DATA_ROOT",
                   "rag_on_edge_tpu_torch.utils.datasets.DEFAULT_DATA_ROOT",
                   "rag_on_edge_tpu_torch.harness.bench_ivf.DEFAULT_DATA_ROOT"):
        monkeypatch.setattr(target, root)
    return root


@pytest.fixture(scope="module")
def jax_index(small_data):
    base, _ = small_data
    return jivf.IVFIndex.build(base, nlist=16, metric="l2", dtype="int8", pad_block=128,
                               seed=42, max_iter=10)


def _port_of(j):
    return tivf.IVFIndex.from_arrays(j._centroids_np, j._vectors_np, j._offsets_np,
                                     j._reorder_np, metric=j.metric, dtype=j.dtype,
                                     pad_block=j.PAD_BLOCK, config=j.config, device="cpu")


# ---------------------------------------------------------------- timing, cache


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_unique_variants_bit_equal_jax(dtype):
    """Float batches get r·jitter in their dtype, integer batches a row roll
    plus r // rows: bit-equal to JAX's, including copies past the row count
    (5 rows, 12 copies), and every variant distinct."""
    rng = np.random.default_rng(3)
    batches = [rng.integers(-100, 100, (5, 7)).astype(dtype),
               rng.integers(-100, 100, (3, 7)).astype(dtype)]
    got = timing.unique_variants([torch.from_numpy(b) for b in batches], 12)
    want = jtiming.unique_variants([jnp.asarray(b) for b in batches], 12)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert g.numpy().tobytes() == w.tobytes()
    assert len({g.numpy().tobytes() for g in got}) == 24


def test_measure_latency_and_throughput_count_distinct_calls():
    seen = []

    def fn(q):
        seen.append(q.numpy().tobytes())
        return q.sum(1), q.max(1).values

    q = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    lat = timing.measure_latency(fn, [q, q + 1], warmup=1)
    assert lat.count == 2 and lat.p50 > 0
    seen.clear()
    qps = timing.measure_throughput(fn, [q], warmup=2, repeats=5)
    assert qps > 0 and math.isfinite(qps)
    assert len(seen) == 2 + 5  # the warm-up pair, then repeats x batches
    assert len(set(seen[2:])) == 5 and not set(seen[:1]) & set(seen[2:])


def test_enable_compilation_cache_is_the_build_dir():
    path = enable_compilation_cache()
    assert path == str(_build.BUILD_DIR) and os.path.isdir(path)
    assert enable_compilation_cache(path) == path  # idempotent
    with pytest.raises(ValueError, match="built in"):
        enable_compilation_cache(os.path.join(path, "elsewhere"))


# ---------------------------------------------------------------- sweeps


def test_recall_target_summary_equals_jax():
    rows = [dict(nprobe=4, k=10, qps=1000.0, recall=0.85),
            dict(nprobe=8, k=10, qps=600.0, recall=0.93),
            dict(nprobe=16, k=10, qps=250.5, recall=0.97),
            dict(nprobe=32, k=10, qps=90.0, recall=0.99)]
    for targets in ((0.95, 0.90, 0.80), (0.999,)):
        assert (sweep.recall_target_summary(rows, targets)
                == jsweep.recall_target_summary(rows, targets))


def test_sweep_ivf_rows_equal_jax(data_root, tmp_path):
    kw = dict(dataset="unit", nprobes=(2, 4), k=5, batch=8, nlist=16, mode="query")
    jrows = jsweep.sweep_ivf(outdir=str(tmp_path / "jax"), **kw)
    rows = sweep.sweep_ivf(outdir=str(tmp_path / "torch"), device="cpu", **kw)
    assert [r["nprobe"] for r in rows] == [2, 4]
    assert [r["recall"] for r in rows] == [r["recall"] for r in jrows]
    assert rows[-1]["recall"] >= 0.5 and all(r["qps"] > 0 for r in rows)
    (out,) = os.listdir(tmp_path / "torch")
    assert out.startswith("sweep_ivf_unit_")
    (jout,) = os.listdir(tmp_path / "jax")
    for d in (tmp_path / "torch" / out, tmp_path / "jax" / jout):
        head = (d / "benchmark_ivf.csv").read_text().splitlines()
        assert head[0].startswith("dataset,nprobe,top_k,recall,qps") and len(head) == 3


def test_sweep_bruteforce_rows_equal_jax(data_root, tmp_path):
    kw = dict(dataset="unit", batches=(8, 16), k=5, dtype="int8")
    jrows = jsweep.sweep_bruteforce(outdir=str(tmp_path / "jax"), **kw)
    rows = sweep.sweep_bruteforce(outdir=str(tmp_path / "torch"), device="cpu", **kw)
    assert [r["recall"] for r in rows] == [r["recall"] for r in jrows]
    (out,) = os.listdir(tmp_path / "torch")
    assert out.startswith("sweep_brute_unit_")
    lines = (tmp_path / "torch" / out / "benchmark_bruteforce.csv").read_text().splitlines()
    assert lines[0] == "dataset,batch,qps,gflops,avg_ms,p95_ms,p99_ms" and len(lines) == 3


def test_sweep10m_frontier_rows(data_root, tmp_path, capsys):
    """The spill_eps x nprobe frontier over one coarse quantizer, on the
    compact store: one row per (eps, nprobe); the spilled index holds more
    rows than the base."""
    sweep10m.main(["--dataset", "unit", "--nlist", "16", "--pad-block", "128",
                   "--spill-eps", "0", "0.1", "--nprobe", "4", "--batch", "16",
                   "--outdir", str(tmp_path / "out"), "--json", "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["spill_eps"], r["nprobe"]) for r in rows] == [(0.0, 4), (0.1, 4)]
    assert rows[0]["n_rows"] == rows[0]["n_base"] == 2048 and rows[1]["n_rows"] > 2048
    assert all(0.5 <= r["recall"] <= 1.0 and r["qps"] > 0 for r in rows)
    root = os.path.join(data_root, "unit")
    assert [f for f in os.listdir(root) if f.startswith("centroids_nlist16")] == [
        "centroids_nlist16_seed42_pp_mi100.npy"]


# ---------------------------------------------------------------- skew and recovery


def test_qcap_calib_rows_equal_jax(data_root, tmp_path):
    argv = ["--dataset", "unit", "--nlist", "16", "--pad-block", "128", "--nprobe", "2", "4",
            "--batch", "128", "--json"]
    jqcap.main(argv + ["--outdir", str(tmp_path / "jax")])
    qcap_calib.main(argv + ["--outdir", str(tmp_path / "torch"), "--device", "cpu"])
    rows = {}
    for pkg in ("jax", "torch"):
        (f,) = (tmp_path / pkg).glob("qcap_calib_unit_nlist16_*.json")
        rows[pkg] = json.loads(f.read_text())
    assert rows["torch"] == rows["jax"]  # measured loads and estimates, exactly
    for r in rows["torch"]:
        assert r["mean_load"] <= r["measured_max_load"] <= r["batch"]


def test_recover_sweep_rows_equal_jax(data_root, tmp_path):
    """The off and auto anchors and one swept shape, row for row as JAX's
    (recall, spill); at B=128 the auto qcap is the batch, so no row drops a
    pair (the recovery pass itself is held to JAX in test_torch_ivf.py)."""
    argv = ["--dataset", "unit", "--nlist", "16", "--spill-eps", "0", "--pad-block", "128",
            "--store", "padded", "--batch", "128", "--k", "10", "--nprobe", "4",
            "--recover-qcap", "64", "--recover-passes", "1", "--json"]
    jsweep_r.main(argv + ["--outdir", str(tmp_path / "jax")])
    recover_sweep.main(argv + ["--outdir", str(tmp_path / "torch"), "--device", "cpu"])
    rows = {}
    for pkg in ("jax", "torch"):
        (f,) = (tmp_path / pkg).glob("recover_sweep_unit_nlist16_*.json")
        rows[pkg] = json.loads(f.read_text())["rows"]
    keys = ("nprobe", "config", "recall", "recall_at_1", "spill_total", "spill_max")
    assert [{k: r[k] for k in keys} for r in rows["torch"]] == [
        {k: r[k] for k in keys} for r in rows["jax"]]
    assert [r["config"] for r in rows["torch"]][::2] == ["off", "rq=64,rp=1,rb=def"]
    assert all(r["qps"] > 0 and r["spill_total"] == 0 and r["recall"] >= 0.9
               for r in rows["torch"])


@pytest.mark.parametrize("shape", ["off", "auto", "64x8x2"])
def test_recover_lab_measure_equals_jax(jax_index, small_data, shape):
    base, queries = small_data
    gt = datasets.ground_truth(base, queries, K, metric="l2", device="cpu")
    ds = types.SimpleNamespace(queries=queries, ground_truth_l2=gt)
    got = recover_lab.measure(_port_of(jax_index), ds, 64, K, NPROBE, shape)
    want = jlab.measure(jax_index, ds, 64, K, NPROBE, shape)
    keys = ("shape", "nprobe", "batch", "recall_at_10", "recall_at_1",
            "lossy_spill_per_batch", "engine")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["qps"] > 0 and got["recall_at_10"] >= 0.9


# ---------------------------------------------------------------- profilers


@pytest.mark.parametrize("engine", ["pallas", "pallas_accum"])
def test_profile_ivf_rows_and_full_prefix_equal_jax(jax_index, small_data, engine):
    _, queries = small_data
    t = _port_of(jax_index)
    rows = profile_ivf.profile(t, queries, K, NPROBE, repeats=2, engine=engine)
    assert [r[0] for r in rows] == list(profile_ivf.NAMES)
    prev = 0.0
    for _, cum, delta in rows:
        assert math.isfinite(cum) and cum > 0 and delta == pytest.approx(cum - prev)
        prev = cum
    qcap = t._auto_qcap(len(queries), NPROBE)
    _, fns = profile_ivf._stage_fns(t, K, NPROBE, qcap, engine=engine)
    tv, tids, _ = fns[-1](torch.from_numpy(queries))
    jv, jids, _ = jax_index.search_device(jnp.asarray(queries), K, NPROBE, mode="cluster",
                                          qcap=qcap, engine=engine, rescore=True,
                                          recover=False)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.fixture(scope="module")
def sharded_pair(jax_index):
    return JIVF(jax_index, jax_mesh(4)), ShardedIVFIndex(_port_of(jax_index),
                                                         [torch.device("cpu")] * 4)


def test_sharded_stage_full_bit_equal_and_unchanged_by_stages(sharded_pair, small_data):
    """``stage="full"`` is the stage-less call, bit for bit, and a run of
    every earlier stage leaves the next full call's result unchanged."""
    _, ts = sharded_pair
    ts._ensure_cluster_state()
    q = torch.from_numpy(small_data[1])
    qcap = ts._auto_qcap(q.shape[0], NPROBE)
    args = (q, K, NPROBE, qcap, 0, 0, 1, "pallas_accum")
    before = ts._search_cluster(*args)
    full = ts._search_cluster(*args, stage="full")
    for stage in profile_sharded.STAGES[:-1]:
        assert timing._leaves(ts._search_cluster(*args, stage=stage))
    after = ts._search_cluster(*args)
    for x, y, z in zip(before, full, after):
        assert x.dtype == y.dtype == z.dtype
        assert x.numpy().tobytes() == y.numpy().tobytes() == z.numpy().tobytes()


@pytest.mark.parametrize("engine", ["auto", "pallas"])
def test_profile_sharded_rows_and_full_stage_equal_jax(sharded_pair, small_data, engine):
    js, ts = sharded_pair
    _, queries = small_data
    rows = profile_sharded.profile(ts, queries, K, NPROBE, engine=engine, repeats=2)
    assert [r[0] for r in rows] == list(profile_sharded.STAGES)
    assert all(math.isfinite(cum) and cum > 0 for _, cum, _ in rows)
    resolved = "pallas_accum" if engine == "auto" else engine
    qcap = ts._auto_qcap(len(queries), NPROBE)
    tv, tids, _, spill = ts._search_cluster(torch.from_numpy(queries), K, NPROBE, qcap, 0, 0, 1,
                                            resolved, "full")
    jv, jids, _ = js.search_device(jnp.asarray(queries), K, NPROBE, mode="cluster",
                                   recover=False, engine=resolved)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(spill) == int(js.last_spill)


# ---------------------------------------------------------------- warmup


def test_warmup_stage_order(data_root, monkeypatch, capsys):
    """Every stage in the JAX module's order, with the datasets and the
    index build swapped for small ones: the kernel libraries first (all
    seven sources), siftsmall, sift, the 1M index at pad_block 2048 then
    512, the serving shapes, both brute indexes, the absent 10M cache,
    siftsmall brute last."""
    unit = datasets.load_dataset("unit", gt_k=10, device="cpu")
    loaded, built = [], []
    monkeypatch.setattr(_build, "load_library", loaded.append)
    monkeypatch.setattr(warmup.datasets, "load_dataset", lambda name, **kw: unit)
    real_build = warmup.bench_ivf.build_or_load_index

    def small_index(ds, nlist, **kw):
        built.append((nlist, kw["pad_block"]))
        return real_build(ds, 16, **dict(kw, pad_block=128))

    monkeypatch.setattr(warmup.bench_ivf, "build_or_load_index", small_index)
    assert warmup.main(["--device", "cpu"]) == 0
    assert sorted(loaded) == sorted(warmup.KERNEL_SOURCES)
    assert built == [(1024, 2048), (1024, 512)]
    stages = [line.split(" ...")[0] for line in capsys.readouterr().out.splitlines()
              if line.startswith("[warmup] ") and line.endswith("...")]
    order = ["kernel libraries", "siftsmall dataset", "sift (1M) dataset",
             "1M IVF index build/load", "first call: IVF search_device B=8192",
             "1M IVF pb=512", "first call: serving shape B=16384", "first call: brute 1M",
             "first call: siftsmall brute"]
    assert len(stages) == len(order)
    for stage, want in zip(stages, order):
        assert stage.startswith(f"[warmup] {want}"), (stage, want)
