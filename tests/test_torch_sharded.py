"""Parity of the port's sharded search with the JAX package, on the CPU.

The JAX side shards over the conftest's 8 CPU devices (and 3 for the
uneven case); the port drives 8 (or 3) logical shards on the CPU.  One JAX
IVF index over ``small_data`` (nlist=16, pad_block=128, so clusters span
1-3 blocks) is built once and given to the port through
``IVFIndex.from_arrays``; its metric and dtype variants reuse its arrays.
The synthetic corpus is integer-valued, so fp32 scores are exact and are
compared bit for bit; the unrescored int8 brute-force scores differ from
JAX's by up to 3e-7 relative, because XLA reassociates the scale product
(ROADMAP facts).  Each JAX program compiles once per configuration, which
is most of this file's time, so the cases are chosen to share nothing
they do not need.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.models import ivf as jivf
from rag_on_edge_tpu.ops import pallas_ivf
from rag_on_edge_tpu.parallel import ShardedBruteForceIndex as JBrute
from rag_on_edge_tpu.parallel import ShardedIVFIndex as JIVF
from rag_on_edge_tpu.parallel import make_mesh as jax_mesh
from rag_on_edge_tpu.parallel.sharded import _partition_clusters as jax_partition
from rag_on_edge_tpu_torch.models import ivf as tivf
from rag_on_edge_tpu_torch.ops import _build, block_tables, ivf_scan
from rag_on_edge_tpu_torch.parallel import ShardedBruteForceIndex, ShardedIVFIndex, make_mesh
from rag_on_edge_tpu_torch.parallel.sharded import _gather_merge, _partition_clusters
from rag_on_edge_tpu_torch.utils.metrics import recall_at_k

K, NPROBE = 10, 4


def _cpus(n):
    return [torch.device("cpu")] * n


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- K6

K6_BLK, K6_QCAP, K6_D, K6_K = 256, 12, 16, 20
# One shard's clusters 3..7 of 9: 2, 0, 3, 1 and 1 blocks (the last too
# small to fill k, so its rows end in -inf), padded to 8 blocks with dummies
# on the last owned cluster, as ShardedIVFIndex lays a shard out.
K6_SIZES, K6_LO, K6_NLIST = [300, 0, 700, 129, 10], 3, 9


def _k6_tables(sizes, lo, blk, nblocks):
    sizes = np.asarray(sizes)
    bc = np.full(nblocks, max(lo + len(sizes) - 1, 0), np.int32)
    bf, bl, rv = (np.zeros(nblocks, np.int32) for _ in range(3))
    if len(sizes):
        offs = np.concatenate([[0], np.cumsum(-(-sizes // blk) * blk)[:-1]])
        bcl, bfl, bll, rvl, _ = block_tables.build_block_tables(offs, sizes, blk)
        nb = len(bcl)
        bc[:nb], bf[:nb], bl[:nb], rv[:nb] = bcl + lo, bfl, bll, rvl
    return bc, bf, bl, rv


def _k6_case(case):
    """Inputs of one K6 case → (qg, vt, bc, bf, bl, rv, bias, row_base, depth)."""
    rng = np.random.default_rng(41)
    lo_v, hi_v = (0, 2) if "ties" in case else (-127, 128)
    sizes, lo = (([], 2) if case == "no-owned-cluster" else (K6_SIZES, K6_LO))
    bc, bf, bl, rv = _k6_tables(sizes, lo, K6_BLK, 8)
    nb = len(bc)
    qg = rng.integers(lo_v, hi_v, (K6_NLIST, K6_QCAP, K6_D), dtype=np.int8)
    vt = rng.integers(lo_v, hi_v, (nb, K6_D, K6_BLK), dtype=np.int8)
    rb = np.arange(nb, dtype=np.int32) * K6_BLK
    bias = None
    if "bias" in case or case == "no-owned-cluster":  # the latter shares a compilation
        bias = rng.uniform(0, 3000, (1, nb * K6_BLK)).astype(np.float32)
    if case.startswith("f32"):
        qg = np.concatenate([qg.astype(np.float32) // 16,
                             np.ones((K6_NLIST, K6_QCAP, 1), np.float32)], 2)
        v = vt.astype(np.float32) // 16
        vt = np.concatenate([v, -0.5 * np.sum(v * v, axis=1, keepdims=True)], 1)
    if "compact" in case:
        # The recovery pass's list (ShardedIVFIndex._cm_recover): the active
        # clusters' blocks in storage order, cut at `rb` blocks, then the
        # rest with zeroed tables, parked on the last listed block's cluster.
        active_c, cap = ({3, 5}, 4) if "parked" in case else ({3, 5, 6}, 8)
        active = np.isin(bc, list(active_c)) & (rv > 0)
        order = np.concatenate([np.nonzero(active)[0], np.nonzero(~active)[0]])
        blocks = order[:cap]
        inc = (np.cumsum(active) - 1 < cap)[blocks] & active[blocks]
        n_inc = int(inc.sum())
        bc = np.where(inc, bc[blocks], bc[blocks][max(n_inc - 1, 0)]).astype(np.int32)
        bf, bl, rv = (np.where(inc, x[blocks], 0).astype(np.int32) for x in (bf, bl, rv))
        vt, rb = vt[blocks], rb[blocks]
        if bias is not None:
            bias = bias.reshape(nb, K6_BLK)[blocks].reshape(1, -1)
    depth = int(case[-1]) if case[-1].isdigit() else 2
    return qg, vt, bc, bf, bl, rv, bias, rb, depth


K6_CASES = ["i8-bias-dense-d2", "i8-compact-parked-d3", "i8-ties-compact-d4",
            "f32-aug-dense-d2", "no-owned-cluster"]


@pytest.mark.parametrize("case", K6_CASES)
def test_k6_plain_equals_jax(case):
    qg, vt, bc, bf, bl, rv, bias, rb, depth = _k6_case(case)
    kw = dict(k=K6_K, blk=K6_BLK, bin_depth=depth)
    jv, ji = pallas_ivf.cluster_major_scan(
        *map(jnp.asarray, (qg, vt, bc, bf, bl, rv)), bias=None if bias is None else
        jnp.asarray(bias), row_base=jnp.asarray(rb), **kw)
    tv, ti = ivf_scan.cluster_major_scan(*map(_t, (qg, vt, bc, bf, bl, rv)), bias=None
                                         if bias is None else _t(bias), row_base=_t(rb), **kw)
    assert tuple(tv.shape) == tuple(ti.shape) == (K6_NLIST, K6_QCAP, K6_K)
    emitted = bc[np.nonzero(bl)[0]]
    if case == "no-owned-cluster":
        assert emitted.size == 0  # nothing to compare: every output row is unwritten
        return
    if "parked" in case:
        assert list(emitted) == [3]  # cluster 5 lost its last block to the cut: no emit
    jv, ji, tv, ti = np.asarray(jv)[emitted], np.asarray(ji)[emitted], tv.numpy()[emitted], \
        ti.numpy()[emitted]
    np.testing.assert_array_equal(tv, jv)
    fin = jv > -np.inf
    np.testing.assert_array_equal(ti[fin], ji[fin])
    assert fin.any()
    if case == "i8-bias-dense-d2":
        assert not fin.all()  # the 10-row cluster cannot fill k=20


def test_k6_int8_operands_keep_every_score():
    """What the CUDA K6's int8 mode (wgmma fed by TMA) reads: the routed
    rows per cluster through the wrapper's own preparation (D 37 padded to
    TMA's 16-byte pitch, 16-byte bases), both operands' d read as zeros up
    to the kernel's 128-byte unit (TMA's fill).  The plain K6 on those
    operands equals the JAX kernel on the original ones, empty (zero) slots
    and the L2 bias included: padding moves no score."""
    rng = np.random.default_rng(43)
    bc, bf, bl, rv = _k6_tables(K6_SIZES, K6_LO, K6_BLK, 8)
    nb = len(bc)
    qg = rng.integers(-127, 128, (K6_NLIST, K6_QCAP, 37), dtype=np.int8)
    for c, n in enumerate(rng.integers(0, K6_QCAP + 1, K6_NLIST)):
        qg[c, n:] = 0
    vt = rng.integers(-127, 128, (nb, 37, K6_BLK), dtype=np.int8)
    rb = np.arange(nb, dtype=np.int32) * K6_BLK
    bias = rng.uniform(0, 3000, (1, nb * K6_BLK)).astype(np.float32)
    kw = dict(k=K6_K, blk=K6_BLK)
    jv, ji = pallas_ivf.cluster_major_scan(*map(jnp.asarray, (qg, vt, bc, bf, bl, rv)),
                                           bias=jnp.asarray(bias), row_base=jnp.asarray(rb), **kw)
    qk, vk = ivf_scan.int8_operands(_t(qg), _t(vt))
    assert qk.shape == (K6_NLIST, K6_QCAP, 48) and qk.data_ptr() % 16 == 0
    assert torch.equal(qk[..., :37], _t(qg)) and not qk[..., 37:].any()
    qk = torch.nn.functional.pad(qk, (0, 128 - qk.shape[-1]))
    vk = torch.nn.functional.pad(vk, (0, 0, 0, 128 - 37))
    tv, ti = ivf_scan.cluster_major_scan(qk, vk, *map(_t, (bc, bf, bl, rv)), bias=_t(bias),
                                         row_base=_t(rb), **kw)
    emitted = bc[np.nonzero(bl)[0]]
    jv, ji, tv, ti = np.asarray(jv)[emitted], np.asarray(ji)[emitted], tv.numpy()[emitted], \
        ti.numpy()[emitted]
    np.testing.assert_array_equal(tv, jv)
    fin = jv > -np.inf
    np.testing.assert_array_equal(ti[fin], ji[fin])
    assert fin.any()


def test_k6_rejects_bad_inputs():
    qg, vt, bc, bf, bl, rv, _, _, _ = map(lambda x: _t(x) if isinstance(x, np.ndarray) else x,
                                          _k6_case("i8-bias-dense-d2"))
    with pytest.raises(ValueError):  # blk not a multiple of nbins
        ivf_scan.cluster_major_scan(qg, vt, bc, bf, bl, rv, 5, blk=K6_BLK, nbins=96)
    with pytest.raises(ValueError):  # block_cluster not int32
        ivf_scan.cluster_major_scan(qg, vt, bc.long(), bf, bl, rv, 5, blk=K6_BLK)
    with pytest.raises(ValueError):  # bias of the wrong length
        ivf_scan.cluster_major_scan(qg, vt, bc, bf, bl, rv, 5, blk=K6_BLK,
                                    bias=torch.zeros((1, 100)))
    with pytest.raises(ValueError):  # mixed dtypes
        ivf_scan.cluster_major_scan(qg.float(), vt, bc, bf, bl, rv, 5, blk=K6_BLK)


# ---------------------------------------------------------------- helpers


@pytest.mark.parametrize("probe_chunk", [1, 3])
def test_fine_scan_chunks_equal_jax(probe_chunk):
    """The query-mode scan over several probe chunks (3 pads the last one),
    with empty probes and rows that cannot fill k."""
    rng = np.random.default_rng(44)
    vecs = rng.integers(-20, 20, (200, 16)).astype(np.float32)
    norms = np.sum(vecs ** 2, axis=1)
    q = rng.integers(-20, 20, (6, 16)).astype(np.float32)
    p_offs = rng.integers(0, 160, (6, 4)).astype(np.int32)
    p_sizes = rng.integers(0, 40, (6, 4)).astype(np.int32)
    p_sizes[0] = [3, 0, 2, 0]  # 5 candidates for k=12: -inf fill
    kw = dict(k=12, probe_chunk=probe_chunk, metric="l2", max_cluster_size=40)
    jv, jr = jivf.fine_scan(*map(jnp.asarray, (q, vecs, norms, p_offs, p_sizes)), **kw)
    tv, tr = tivf.fine_scan(*map(_t, (q, vecs, norms, p_offs, p_sizes)), **kw)
    jv, jr = np.asarray(jv), np.asarray(jr)
    np.testing.assert_array_equal(tv.numpy(), jv)
    fin = jv > -np.inf
    np.testing.assert_array_equal(tr.numpy()[fin], jr[fin])
    assert not fin[0].all() and fin[1:].any()



def test_partition_clusters_equal_jax():
    rng = np.random.default_rng(42)
    for nlist, n_shards in ((16, 8), (16, 3), (5, 8), (1024, 4)):
        offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 300, nlist))])
        assert _partition_clusters(offsets, n_shards) == jax_partition(offsets, n_shards)


def test_gather_merge_shard_order_and_dedup():
    inf = float("-inf")
    vals = [torch.tensor([[5.0, 1.0]]), torch.tensor([[5.0, 3.0]]), torch.tensor([[3.0, inf]])]
    ids = [torch.tensor([[7, 2]], dtype=torch.int32), torch.tensor([[7, 9]], dtype=torch.int32),
           torch.tensor([[4, 11]], dtype=torch.int32)]
    v, i = _gather_merge(vals, ids, 4)  # ties go to the earlier shard
    assert v.tolist() == [[5.0, 5.0, 3.0, 3.0]] and i.tolist() == [[7, 7, 9, 4]]
    v, i = _gather_merge(vals, ids, 4, dedup=True)  # id 7 once; -inf slots read -1
    assert v.tolist() == [[5.0, 3.0, 3.0, 1.0]] and i.tolist() == [[7, 4, 9, 2]]
    v, i = _gather_merge([vals[2]], [ids[2]], 2, dedup=True)
    assert i.tolist() == [[4, -1]]


def test_make_mesh_is_explicit():
    assert make_mesh(device_type="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(2, device_type="cpu")
    with pytest.raises(ValueError):
        make_mesh(device_type="tpu")
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError):  # no fall-back to the CPU
            make_mesh()


# ---------------------------------------------------------------- brute force


@pytest.fixture(scope="module")
def meshes():
    return {8: jax_mesh(8), 3: jax_mesh(3)}


def _brute_pair(meshes, base, n_shards, **kw):
    return (JBrute(base, meshes[n_shards], **kw), ShardedBruteForceIndex(base, _cpus(n_shards),
                                                                         **kw))


def _check_brute(j, t, queries, k=K):
    jv, ji = (np.asarray(x) for x in j.search_device(jnp.asarray(queries), k))
    tv, ti = (x.numpy() for x in t.search_device(_t(queries), k))
    np.testing.assert_array_equal(ti, ji)
    if t.dtype == "int8" and not t.rescore:
        # XLA computes the int8 scale product as amax·(sb·2/127), the port
        # in the source order: up to 3 ulps apart (ROADMAP facts).
        np.testing.assert_allclose(tv, jv, rtol=3e-7, atol=0)
    else:
        np.testing.assert_array_equal(tv, jv)
    return ti


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_sharded_brute_equal_jax(meshes, small_data, engine, metric, dtype):
    base, queries = small_data
    j, t = _brute_pair(meshes, base, 8, metric=metric, dtype=dtype, engine=engine)
    d, n = j._base.shape if engine == "pallas" else j._base.shape[::-1]
    want = (d, n // 8) if engine == "pallas" else (n // 8, d)  # columns or rows sharded
    assert tuple(t._shards[0]["base"].shape) == want
    _check_brute(j, t, queries)


@pytest.mark.parametrize("engine,metric,dtype", [("pallas", "l2", "int8"),
                                                 ("xla", "ip", "bf16")])
def test_sharded_brute_rescore_equal_jax(meshes, small_data, engine, metric, dtype):
    base, queries = small_data
    j, t = _brute_pair(meshes, base, 8, metric=metric, dtype=dtype, engine=engine,
                       rescore=True)
    ids = _check_brute(j, t, queries)
    vals = t.search_device(_t(queries), K)[0].numpy()
    q64, b64 = queries.astype(np.float64), base.astype(np.float64)
    exact = np.take_along_axis(q64 @ b64.T, ids.astype(np.int64), axis=1)
    if metric == "l2":
        exact = 2.0 * exact - (b64 ** 2).sum(1)[ids]
    np.testing.assert_array_equal(vals, exact.astype(np.float32))  # integer data: exact


def test_sharded_brute_ragged_uneven_equal_jax(meshes):
    """N = 1003 over 3 shards of 335: the last shard's tail is masked by
    its n_valid, and no padded row is ever returned."""
    rng = np.random.default_rng(43)
    base = rng.integers(-100, 100, (1003, 64)).astype(np.float32)
    queries = rng.integers(-100, 100, (9, 64)).astype(np.float32)
    j, t = _brute_pair(meshes, base, 3, dtype="fp32")
    assert t.rows_per_shard == 335
    ids = _check_brute(j, t, queries, k=5)
    assert ids.min() >= 0 and ids.max() < 1003


# ---------------------------------------------------------------- IVF


@pytest.fixture(scope="module")
def jax_index(small_data):
    base, _ = small_data
    return jivf.IVFIndex.build(base, nlist=16, metric="l2", dtype="int8", pad_block=128,
                               seed=42, max_iter=10)


def _variant(j0, metric, dtype):
    if (metric, dtype) == (j0.metric, j0.dtype):
        return j0
    return jivf.IVFIndex(j0._centroids_np, j0._vectors_np, j0._offsets_np, j0._reorder_np,
                         metric=metric, dtype=dtype, pad_block=j0.PAD_BLOCK,
                         config=dict(j0.config))


def _port_of(j):
    return tivf.IVFIndex.from_arrays(j._centroids_np, j._vectors_np, j._offsets_np,
                                     j._reorder_np, metric=j.metric, dtype=j.dtype,
                                     pad_block=j.PAD_BLOCK, config=j.config, device="cpu")


@pytest.fixture(scope="module")
def ivf_pair(jax_index, meshes):
    """(metric, dtype, n_shards) → (JAX sharded index, port sharded index),
    made once each."""
    made = {}

    def get(metric="l2", dtype="int8", n_shards=8):
        key = (metric, dtype, n_shards)
        if key not in made:
            j = _variant(jax_index, metric, dtype)
            made[key] = (JIVF(j, meshes[n_shards]), ShardedIVFIndex(_port_of(j),
                                                                     _cpus(n_shards)))
        return made[key]

    return get


def _check_ivf(js, ts, queries, nprobe=NPROBE, **kw):
    jv, ji, jc = (np.asarray(x) for x in js.search_device(jnp.asarray(queries), K, nprobe,
                                                           **kw))
    tv, ti, tc = (x.numpy() for x in ts.search_device(_t(queries), K, nprobe, **kw))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    if kw.get("mode") == "cluster":
        assert ts.last_engine == js.last_engine
        assert int(ts.last_spill) == int(js.last_spill)
    return tv, ti


@pytest.mark.parametrize("n_shards", [8, 3])
def test_shard_arrays_bit_equal_jax(ivf_pair, n_shards):
    js, ts = ivf_pair(n_shards=n_shards)
    js._ensure_cluster_state()
    ts._ensure_cluster_state()
    js._ensure_query_state()
    ts._ensure_query_state()
    assert ts._cm_accum_ok == js._cm_accum_ok
    for layout, jarr, tarr in (("cluster", js._cm_arrays, ts._cm_arrays),
                               ("query", js._qm_arrays, ts._qm_arrays)):
        for name in tarr[0]:
            want = np.asarray(jarr[name])
            for s in range(n_shards):
                got = tarr[s][name].numpy()
                replicated = layout == "cluster" and name in ("cluster_shard", "sizes")
                w = want if replicated else want[s]
                assert got.dtype == w.dtype and got.shape == w.shape, (layout, name)
                assert got.tobytes() == w.tobytes(), (layout, name, s)
    bc = np.stack([a["bc"].numpy() for a in ts._cm_arrays])
    assert (bc >= 0).all() and (bc < 16).all()  # global cluster ids


# The accum engine with an ip index runs in the one-pass recovery case
# below: each JAX accum program takes seconds to compile.
@pytest.mark.parametrize("metric,dtype,engine", [
    ("l2", "int8", "auto"), ("l2", "int8", "pallas"), ("ip", "fp32", "pallas")])
def test_sharded_ivf_cluster_equal_jax(ivf_pair, small_data, metric, dtype, engine):
    js, ts = ivf_pair(metric, dtype)
    _check_ivf(js, ts, small_data[1], mode="cluster", engine=engine)
    assert ts.last_engine == ("pallas_accum" if engine == "auto" else "pallas")
    assert int(ts.last_spill) == 0


# qcap=4 drops pairs; the recovery pass places them through K6 over a
# compacted list of each shard's blocks.  One pass of 9 pairs over 3 blocks
# per shard leaves a residual (and cuts clusters off the list); two passes
# of 16 over every block place every pair (the hottest cluster holds 30).
RECOVERY_RUNS = {
    "one-pass-auto-ip": (("ip", "fp32"), dict(qcap=4, recover=True, recover_qcap=9,
                                              recover_blocks=3, recover_passes=1)),
    "two-pass-pallas-l2": (("l2", "int8"), dict(qcap=4, recover=True, recover_qcap=16,
                                                recover_blocks=8, recover_passes=2,
                                                engine="pallas")),
}


@pytest.mark.parametrize("run", list(RECOVERY_RUNS))
def test_sharded_ivf_recovery_equal_jax(ivf_pair, small_data, run):
    index_kind, kw = RECOVERY_RUNS[run]
    js, ts = ivf_pair(*index_kind)
    _check_ivf(js, ts, small_data[1], mode="cluster", **kw)
    if run.startswith("one-pass"):
        assert ts.last_engine == "pallas_accum" and int(ts.last_spill) > 0
    else:
        assert int(ts.last_spill) == 0
        ts.search_device(_t(small_data[1]), K, NPROBE, mode="cluster", qcap=4, recover=False,
                         engine="pallas")
        assert int(ts.last_spill) > 0  # the pairs the recovery pass placed


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_routed_tables_written_at_pitch_equal_jax(jax_index, small_data, dtype):
    """The routed tables of a float index's sharded search (the main walk's
    and the recovery pass's) lie at the batch's 16-byte row pitch (D' = 129
    with L2's ones column: 132 fp32, 136 bf16, the pad zero), so K6's float
    wrapper reads them in place; their values equal the JAX package's table
    (``jnp.where(routed, qrow[clip(cq, 0)], 0)``, its sharded.py) on the
    same probes."""
    j = _variant(jax_index, "l2", dtype)
    ts = ShardedIVFIndex(_port_of(j), _cpus(8))
    ts._ensure_cluster_state()
    queries = small_data[1]
    r = ts._cm_route(_t(queries), NPROBE, 4)
    assert r["lossy"].any()
    rec = ts._cm_recover_tables(0, r, r["lossy"], None, 16, 8)[0]
    ldq = {"fp32": 132, "bf16": 136}[dtype]
    for table in (r["qg"], rec[0]):
        storage, pitch = _build.pitched_storage(table)
        assert (storage.data_ptr(), pitch) == (table.data_ptr(), ldq)
        assert table.shape[-1] == 129 and not storage[..., 129:].any()
        qs, _, ldq2, _ = ivf_scan.float_operands("K6", table, rec[1])
        assert (qs.data_ptr(), ldq2) == (table.data_ptr(), ldq)
    cq, _, _ = jivf.invert_probes(jnp.asarray(r["probes"].numpy()), 16, 4)
    qrow = jnp.concatenate([jnp.asarray(queries), jnp.ones((len(queries), 1), jnp.float32)], -1)
    qrow = qrow.astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want = jnp.where((cq >= 0)[..., None], qrow[jnp.clip(cq, 0)], jnp.zeros((), qrow.dtype))
    got = r["qg"].contiguous()
    got = got.view(torch.int16) if dtype == "bf16" else got
    want = np.asarray(want.view(jnp.int16) if dtype == "bf16" else want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_ivf_spilled_dedup_equal_jax(jax_index, meshes, small_data):
    """A spilled index: a vector stored in two clusters reaches a pool twice
    (in-shard dedup) or two shards' results (the merge's dedup)."""
    base, queries = small_data
    j = jivf.IVFIndex.build(base, nlist=16, metric="l2", dtype="int8", pad_block=128,
                            seed=42, spill_eps=0.3, centroids=jax_index._centroids_np)
    js, ts = JIVF(j, meshes[8]), ShardedIVFIndex(_port_of(j), _cpus(8))
    assert ts.spilled and j.config["n_spilled"] > 0
    _, ids = _check_ivf(js, ts, queries, nprobe=8, mode="cluster", engine="pallas")
    for row in ids:
        assert len(set(row.tolist())) == K


def test_sharded_ivf_query_mode_uneven_equal_jax(ivf_pair, small_data):
    """Query mode (per-shard fine_scan, exact fp32) on 3 uneven shards,
    through the host API (which zero-pads the last batch)."""
    base, queries = small_data
    js, ts = ivf_pair(n_shards=3)
    _check_ivf(js, ts, queries, mode="query")
    jids, jscores, javg = js.search(queries, K, nprobe=NPROBE)
    tids, tscores, tavg = ts.search(queries, K, nprobe=NPROBE)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tscores, jscores)
    assert tavg == javg


def test_sharded_ivf_nprobe1_idle_shards_equal_jax(ivf_pair, small_data):
    """nprobe=1: for each query 7 of the 8 shards own nothing probed."""
    js, ts = ivf_pair()
    _, ids = _check_ivf(js, ts, small_data[1], nprobe=1, mode="cluster", engine="pallas")
    assert ((ids >= 0) & (ids < 2048)).all()


def test_sharded_ivf_refusals(ivf_pair, small_data):
    _, ts = ivf_pair()
    q = _t(small_data[1])
    with pytest.raises(ValueError, match="engine"):
        ts.search_device(q, K, NPROBE, mode="cluster", engine="xla")
    with pytest.raises(ValueError, match="mode"):
        ts.search_device(q, K, NPROBE, mode="auto")


# ------------------------------------------------- routed rows at D = 100

D_UNPITCHED = 100  # int8 rows pad to 112, fp32 / bf16 (L2: D' 101) to 104


@pytest.fixture(scope="module")
def jax_index_d100(jax_index, small_data):
    """The JAX index of ``small_data`` cut to D 100 (no multiple of 16
    bytes in any dtype), on the first 100 dims of ``jax_index``'s
    centroids."""
    return jivf.IVFIndex.build(small_data[0][:, :D_UNPITCHED], nlist=16, metric="l2",
                               dtype="int8", pad_block=128, seed=42,
                               centroids=jax_index._centroids_np[:, :D_UNPITCHED])


def _spy_scan_rows(monkeypatch):
    """Wrap K6's and K7's wrappers to record how their routed rows lie →
    the list of (kernel, dtype, contiguous, read in place at a 16-byte row
    pitch by ``ivf_scan.float_operands``).  On the card the int8 rows must
    be contiguous (``_build.check_inputs``; the wrapper pads them, since
    the kernel reads the pad); float rows take any layout, and a copy where
    they do not lie at the pitch."""
    seen = []

    def spy(name, fn):
        def call(rows, *args, **kw):
            in_place = _build.pitched_storage(rows)[0].data_ptr() == rows.data_ptr()
            seen.append((name, str(rows.dtype), rows.is_contiguous(), in_place))
            return fn(rows, *args, **kw)
        return call

    monkeypatch.setattr(ivf_scan, "cluster_major_scan", spy("K6", ivf_scan.cluster_major_scan))
    monkeypatch.setattr(ivf_scan, "cluster_major_scan_routed",
                        spy("K7", ivf_scan.cluster_major_scan_routed))
    return seen


@pytest.mark.parametrize("dtype", ["int8", "fp32", "bf16"])
def test_sharded_k6_rows_at_d100_equal_jax(jax_index_d100, meshes, small_data, monkeypatch,
                                           dtype):
    """A sharded search at D 100 with ``engine="pallas"`` and two recovery
    passes: K6's routed tables lie as the card's wrapper takes them, int8
    contiguous and float written at the 16-byte pitch (read in place), and
    the answers equal the JAX package's."""
    j = _variant(jax_index_d100, "l2", dtype)
    js, ts = JIVF(j, meshes[8]), ShardedIVFIndex(_port_of(j), _cpus(8))
    seen = _spy_scan_rows(monkeypatch)
    _check_ivf(js, ts, small_data[1][:, :D_UNPITCHED], mode="cluster", qcap=4, recover=True,
               recover_qcap=16, recover_blocks=8, recover_passes=2, engine="pallas")
    assert seen and {name for name, _, _, _ in seen} == {"K6"}, seen
    assert all(in_place if dtype != "int8" else contiguous
               for _, _, contiguous, in_place in seen), seen
    assert int(ts.last_spill) == 0


@pytest.mark.parametrize("dtype", ["int8", "fp32", "bf16"])
def test_routed_engine_rows_at_d100_equal_grouped(jax_index_d100, small_data, monkeypatch,
                                                  dtype):
    """The routed engine at D 100 with two recovery passes: K7's batch is
    contiguous, as the card's int8 wrapper takes it (the float wrapper pads
    it to the 16-byte pitch), and the answers equal ``engine="pallas"``'s
    (K4 on the gathered rows), as they must on the card."""
    t = _port_of(_variant(jax_index_d100, "l2", dtype))
    q = _t(small_data[1][:, :D_UNPITCHED])
    kw = dict(mode="cluster", qcap=4, recover=True, recover_qcap=16, recover_blocks=64,
              recover_passes=2)  # every block
    want = t.search_device(q, K, NPROBE, engine="pallas", **kw)
    seen = _spy_scan_rows(monkeypatch)
    got = t.search_device(q, K, NPROBE, engine="pallas_routed", **kw)
    assert seen and {name for name, _, _, _ in seen} == {"K7"}, seen
    assert all(contiguous for _, _, contiguous, _ in seen), seen
    assert int(t.last_spill) == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _compact_pair(j0, meshes, n_shards=8):
    """(JAX sharded index, port sharded index) over compact-store indexes
    on ``j0``'s arrays."""
    args = (j0._centroids_np, j0._vectors_np, j0._offsets_np, j0._reorder_np)
    jc = jivf.IVFIndex(*args, metric=j0.metric, dtype=j0.dtype, pad_block=j0.PAD_BLOCK,
                       store="compact", config=dict(j0.config))
    tc = tivf.IVFIndex.from_arrays(*args, metric=j0.metric, dtype=j0.dtype,
                                   pad_block=j0.PAD_BLOCK, config=j0.config, device="cpu",
                                   store="compact")
    return JIVF(jc, meshes[n_shards]), ShardedIVFIndex(tc, _cpus(n_shards))


@pytest.mark.parametrize("metric,dtype", [("l2", "int8"), ("ip", "fp32")])
def test_sharded_compact_store_matches_padded(jax_index, meshes, small_data, metric, dtype):
    """store='compact' sources shard the cluster-major path: kernel slabs
    sliced from the source's own tables, the fp32 rescore through the
    compact offset maps.  The port's results equal its padded-store sharded
    index's, and the JAX compact sharded index's on the same arrays."""
    _, queries = small_data
    j0 = _variant(jax_index, metric, dtype)
    padded = ShardedIVFIndex(_port_of(j0), _cpus(8))
    js_c, ts_c = _compact_pair(j0, meshes)
    ids_p, s_p, cand_p = padded.search(queries, k=K, nprobe=NPROBE, mode="cluster")
    ids_c, s_c, cand_c = ts_c.search(queries, k=K, nprobe=NPROBE, mode="cluster")
    np.testing.assert_array_equal(ids_p, ids_c)
    np.testing.assert_allclose(s_p, s_c, rtol=1e-5)
    assert cand_p == cand_c
    _check_ivf(js_c, ts_c, queries, mode="cluster")


def test_sharded_compact_matches_single_chip(jax_index, small_data):
    """The sharded compact cluster-major search against the single-card
    compact index it shards: recall@10 >= 0.97 of the single index's ids,
    as the JAX package holds it."""
    _, queries = small_data
    j0 = jax_index
    single = tivf.IVFIndex.from_arrays(j0._centroids_np, j0._vectors_np, j0._offsets_np,
                                       j0._reorder_np, metric="l2", dtype="int8",
                                       pad_block=j0.PAD_BLOCK, config=j0.config,
                                       device="cpu", store="compact")
    sharded = ShardedIVFIndex(single, _cpus(8))
    ids_s, _, _ = single.search(queries, k=K, nprobe=NPROBE, mode="cluster")
    ids_m, _, _ = sharded.search(queries, k=K, nprobe=NPROBE, mode="cluster")
    assert recall_at_k(ids_m, ids_s, K) >= 0.97
