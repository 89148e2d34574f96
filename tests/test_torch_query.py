"""Parity of the port's query-major IVF search and the rest of ``IVFIndex``'s
API with the JAX package, on the CPU.

One JAX index over the shared ``small_data`` corpus (nlist=16, L2, int8,
pad_block=128, so clusters span 1-3 blocks) gives the arrays; its (dtype,
metric) variants and the port's indexes are built from them.  Covered:
``search_device(mode="query")`` (the JAX ``_search_impl``: the coarse
probes, ``fine_scan`` through the padded-row map, bf16 products for a bf16
index, the optional rescore), the host ``search`` at one query, the cluster
mode's ``engine="xla"`` (the per-cluster scan of the block-padded fp32
copy), ``search_stream_device`` in both modes, ``required_qcap``,
``memory_report``, ``compile`` and the fallback of ``_est_max_load``.

The corpus is integer-valued (0..141): bf16 holds it exactly and every
fp32 sum is an exact integer, so ids and scores are compared exactly
(a tolerance of 0, where a non-integer corpus would need an rtol of a few
fp32 ulps for the sum order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.models import ivf as jivf
from rag_on_edge_tpu_torch.models import ivf as tivf
from rag_on_edge_tpu_torch.utils.datasets import ground_truth
from rag_on_edge_tpu_torch.utils.metrics import recall_at_k

K, NPROBE = 10, 4
INDEXES = [(dtype, metric) for dtype in ("fp32", "bf16", "int8") for metric in ("ip", "l2")]


@pytest.fixture(scope="module")
def query_src(small_data):
    base, _ = small_data
    return jivf.IVFIndex.build(base, nlist=16, metric="l2", dtype="int8", pad_block=128,
                               seed=42)


@pytest.fixture(scope="module")
def query_pairs(query_src):
    """(dtype, metric) → (jax index, port index) over the same arrays, made
    on first use."""
    made = {}

    def get(dtype, metric):
        if (dtype, metric) not in made:
            s = query_src
            j = jivf.IVFIndex(s._centroids_np, s._vectors_np, s._offsets_np, s._reorder_np,
                              metric=metric, dtype=dtype, pad_block=128, config=dict(s.config))
            t = tivf.IVFIndex.from_arrays(s._centroids_np, s._vectors_np, s._offsets_np,
                                          s._reorder_np, metric=metric, dtype=dtype,
                                          pad_block=128, config=dict(s.config), device="cpu")
            made[dtype, metric] = (j, t)
        return made[dtype, metric]

    return get


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _equal(j_out, t_out):
    """Ids, scores and candidate counts equal (exact: integer data)."""
    for jx, tx in zip(j_out, t_out):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("probe_chunk", [1, None], ids=["pc1", "pc-auto"])
@pytest.mark.parametrize("rescore", [True, False], ids=["rescore", "plain"])
@pytest.mark.parametrize("dtype,metric", INDEXES)
def test_query_mode_equal_jax(query_pairs, small_data, dtype, metric, rescore, probe_chunk):
    j, t = query_pairs(dtype, metric)
    q = small_data[1]
    kw = dict(probe_chunk=probe_chunk, mode="query", rescore=rescore)
    want = j.search_device(jnp.asarray(q), K, NPROBE, **kw)
    got = t.search_device(_t(q), K, NPROBE, **kw)
    assert t.last_mode == j.last_mode == "query" and t.last_engine == j.last_engine == "xla"
    _equal(want, got)
    ids = got[1].numpy()
    assert (ids >= 0).all() and (ids < t.n_base).all()
    if probe_chunk is None:
        assert t._auto_probe_chunk(len(q)) == j._auto_probe_chunk(len(q)) >= NPROBE


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_query_mode_default_rescore_equal_jax(query_pairs, small_data, dtype):
    """``rescore=None``: off for an fp32 index, on for bf16 (the JAX rule),
    and ``mode="auto"`` picks the query mode for this small batch (B·nprobe
    below nlist)."""
    j, t = query_pairs(dtype, "l2")
    q = small_data[1][:3]
    assert t._pick_mode(len(q), NPROBE) == j._pick_mode(len(q), NPROBE) == "query"
    _equal(j.search_device(jnp.asarray(q), K, NPROBE),
           t.search_device(_t(q), K, NPROBE))
    assert t.last_mode == "query"


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_search_one_query_auto_mode_equal_jax(query_pairs, small_data, dtype):
    """The host API at one query, every default but nprobe: the auto mode
    picks the query mode, which answers as the JAX package's does."""
    j, t = query_pairs(dtype, "l2")
    q = small_data[1][:1]
    jids, jscores, javg = j.search(q, K, nprobe=NPROBE)
    tids, tscores, tavg = t.search(q, K, nprobe=NPROBE)
    assert t.last_mode == "query"
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tscores, jscores)
    assert tavg == javg
    ids, _, _ = t.search(small_data[1], K)  # nprobe 16: every cluster of this index
    base = small_data[0]
    assert recall_at_k(ids, ground_truth(base, small_data[1], K, metric="l2", device="cpu"),
                       K) >= 0.99


XLA_RUNS = {"fp32-l2": ("fp32", "l2", {}), "fp32-ip": ("fp32", "ip", {}),
            "int8-l2": ("int8", "l2", {}), "bf16-l2-spill": ("bf16", "l2", dict(qcap=4)),
            "fp32-l2-rescore": ("fp32", "l2", dict(rescore=True, rescore_k=15))}


@pytest.mark.parametrize("run", list(XLA_RUNS))
def test_xla_engine_equal_jax(query_pairs, small_data, run):
    """The cluster mode's ``engine="xla"``: its padded fp32 copy is built
    on first use only, and a routing capacity of 4 drops pairs (counted in
    ``last_spill``; the xla engine has no recovery pass)."""
    dtype, metric, extra = XLA_RUNS[run]
    j, t = query_pairs(dtype, metric)
    q = small_data[1]
    kw = dict(mode="cluster", engine="xla", **extra)
    want = j.search_device(jnp.asarray(q), K, NPROBE, **kw)
    got = t.search_device(_t(q), K, NPROBE, **kw)
    assert t.last_engine == j.last_engine == "xla"
    assert int(t.last_spill) == int(j.last_spill)
    assert (int(t.last_spill) > 0) == ("spill" in run)
    _equal(want, got)
    pad = t._arrays["vectors"]
    assert pad.dtype == torch.float32 and tuple(pad.shape) == (t.n_padded, t.dim)
    assert t.max_cluster_padded == j.max_cluster_padded


def test_xla_engine_refuses_recovery(query_pairs, small_data):
    _, t = query_pairs("fp32", "l2")
    with pytest.raises(ValueError, match="recover"):
        t.search_device(_t(small_data[1]), K, NPROBE, mode="cluster", engine="xla",
                        recover=True)


@pytest.mark.parametrize("mode", ["query", "cluster"])
def test_search_stream_device_equal_jax(query_pairs, small_data, mode):
    """Four micro-batches of 8: M independent query-mode searches, or one
    cluster-mode batch of 32."""
    j, t = query_pairs("int8", "l2")
    stream = small_data[1].reshape(4, 8, -1)
    want = j.search_stream_device(jnp.asarray(stream), K, NPROBE, mode=mode)
    got = t.search_stream_device(_t(stream), K, NPROBE, mode=mode)
    assert tuple(got[0].shape) == tuple(got[1].shape) == (4, 8, K)
    assert tuple(got[2].shape) == (4, 8)
    _equal(want, got)


@pytest.mark.parametrize("nprobe,multiple", [(4, 32), (16, 8), (2, 1)])
def test_required_qcap_equal_jax(query_pairs, small_data, nprobe, multiple):
    j, t = query_pairs("int8", "l2")
    q = small_data[1]
    got = t.required_qcap(q, nprobe, multiple=multiple)
    assert got == j.required_qcap(q, nprobe, multiple=multiple)
    assert got % multiple == 0
    t.search_device(_t(q), K, nprobe, mode="cluster", qcap=got, recover=False)
    assert int(t.last_spill) == 0


def test_memory_report_equal_jax(query_src, small_data):
    """Bytes per array and the total, before and after the cluster mode
    adds the kernel state and the xla engine its padded copy (a fresh pair:
    the shared ones carry what earlier searches added)."""
    s = query_src
    j = jivf.IVFIndex(s._centroids_np, s._vectors_np, s._offsets_np, s._reorder_np,
                      metric="l2", dtype="fp32", pad_block=128, config=dict(s.config))
    t = tivf.IVFIndex.from_arrays(s._centroids_np, s._vectors_np, s._offsets_np,
                                  s._reorder_np, metric="l2", dtype="fp32", pad_block=128,
                                  config=dict(s.config), device="cpu")
    q = small_data[1]
    assert t.memory_report() == j.memory_report()
    for engine in ("pallas", "xla"):
        j.search_device(jnp.asarray(q), K, NPROBE, mode="cluster", engine=engine)
        t.search_device(_t(q), K, NPROBE, mode="cluster", engine=engine)
        rep = t.memory_report()
        assert rep == j.memory_report()
        assert rep["TOTAL"] == sum(v for name, v in rep.items() if name != "TOTAL")
    assert {"vectors_t", "vectors", "vectors_f32"} <= set(rep)


@pytest.mark.parametrize("mode", ["auto", "cluster"])
def test_compile_warms_the_search(query_pairs, small_data, mode):
    """``compile`` runs one search at the shape on a zero batch and returns
    nothing; the search after it answers as JAX's."""
    j, t = query_pairs("bf16", "ip")
    assert t.compile(3, K, NPROBE, mode=mode) is None
    assert t.last_mode == ("query" if mode == "auto" else "cluster")
    if mode == "cluster":
        assert "vectors_t" in t._arrays
    q = small_data[1][:3]
    _equal(j.search_device(jnp.asarray(q), K, NPROBE, mode=mode),
           t.search_device(_t(q), K, NPROBE, mode=mode))


def test_est_max_load_fallback_equal_jax(query_src):
    """With no readable skew table, the load estimate takes the JAX
    package's formula (mean load times clip(nlist/256, 8, 32))."""
    s = query_src
    config = dict(s.config, probe_skew={"not a number": 0.5})
    j = jivf.IVFIndex(s._centroids_np, s._vectors_np, s._offsets_np, s._reorder_np,
                      metric="l2", dtype="int8", pad_block=128, config=dict(config))
    t = tivf.IVFIndex.from_arrays(s._centroids_np, s._vectors_np, s._offsets_np,
                                  s._reorder_np, metric="l2", dtype="int8", pad_block=128,
                                  config=dict(config), device="cpu")
    for b, nprobe in ((32, 4), (8192, 4), (8192, 16), (3, 1)):
        got = t._est_max_load(b, nprobe)
        assert got == j._est_max_load(b, nprobe)
        assert got == min(float(b), 8.0 * b * min(nprobe, 16) / 16)
        assert t._auto_recover(b, nprobe) == j._auto_recover(b, nprobe)
