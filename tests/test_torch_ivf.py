"""Parity of the PyTorch port's IVF slice with the JAX package, on the CPU.

One JAX index over the shared ``small_data`` corpus (nlist=16, L2, int8)
is searched by both packages at two block sizes: pad_block=512 (one block
per cluster) and pad_block=128 (clusters span 1-3 blocks, exercising the
block-code decode).  Every stage is compared: kernel state, probe
inversion, query prep and bias rows, kernel K1's planes, the join and the
rescore; then the recovery pass (kernel K4) and the grouped engine end to
end.  The synthetic corpus is integer-valued, so every fp32 score is
an exact integer and the comparisons are exact unless stated otherwise.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.models import ivf as jivf
from rag_on_edge_tpu.models import kmeans as jkmeans
from rag_on_edge_tpu.ops import pallas_ivf_dma
from rag_on_edge_tpu.ops import quantize as jquant
from rag_on_edge_tpu_torch.models import ivf as tivf
from rag_on_edge_tpu_torch.models import kmeans as tkmeans
from rag_on_edge_tpu_torch.utils.datasets import ground_truth
from rag_on_edge_tpu_torch.utils.metrics import recall_at_k

K, NPROBE = 10, 4
PAD_BLOCKS = [512, 128]


def _port_of(j, **kw):
    return tivf.IVFIndex.from_arrays(
        j._centroids_np, j._vectors_np, j._offsets_np, j._reorder_np,
        metric=j.metric, dtype=j.dtype, pad_block=j.PAD_BLOCK, config=j.config,
        device="cpu", **kw)


@pytest.fixture(scope="session")
def jax_base(small_data):
    base, _ = small_data
    return jivf.IVFIndex.build(base, nlist=16, metric="l2", dtype="int8",
                               pad_block=512, seed=42)


@pytest.fixture(scope="session")
def pair(jax_base):
    """{pad_block: (jax index, port index)} over the same arrays."""
    out = {}
    for pb in PAD_BLOCKS:
        j = jax_base if pb == 512 else jivf.IVFIndex(
            jax_base._centroids_np, jax_base._vectors_np, jax_base._offsets_np,
            jax_base._reorder_np, metric="l2", dtype="int8", pad_block=pb,
            config=dict(jax_base.config))
        j._ensure_kernel_state()
        t = _port_of(j)
        t._ensure_kernel_state()
        out[pb] = (j, t)
    return out


@jax.jit
def _jax_prep(arrays, q, cq, base_scale):
    """The JAX package's inline int8 query prep, L2 bias and planes bias
    rows (models/ivf.py, cluster-major STAGE 3), as one jitted function."""
    nblocks, _, blk = arrays["vectors_t"].shape
    sq = jquant.calibrate_scale(q)
    qi = jnp.clip(jnp.round(q / sq), -127, 127).astype(jnp.int8)
    alpha = 2.0 * (sq * base_scale)
    norms = arrays["vector_norms"]
    norms = jnp.pad(norms, (0, nblocks * blk - norms.shape[0]))
    bias = (norms / alpha).reshape(nblocks, 1, blk)
    code = jnp.int32(15) - (jnp.arange(nblocks, dtype=jnp.int32) % 16)
    cidc = jnp.arange(blk, dtype=jnp.int32) >> 7
    pack = jax.lax.shift_left(code, 4)[:, None] | cidc[None, :]
    br = jnp.clip(jnp.round(bias), -(2.0**21), 2.0**21).astype(jnp.int32)
    bias_rows = jax.lax.shift_left(br, 8) - pack[:, None, :]
    routed = (cq >= 0)[..., None]
    qk = jnp.where(routed, qi[jnp.clip(cq, 0)], jnp.zeros((), qi.dtype))
    return qi, qk[arrays["block_cluster"]], bias, bias_rows, alpha


@pytest.fixture(scope="session")
def jax_stages(pair, small_data):
    """JAX stage outputs per pad_block for one routed batch."""
    _, queries = small_data
    out = {}
    for pb, (j, _) in pair.items():
        q = jnp.asarray(queries)
        probes = j._coarse_probes(j._arrays, q, NPROBE)
        qcap = j._auto_qcap(q.shape[0], NPROBE)
        cq, slot, spill = jivf.invert_probes(probes, j.nlist, qcap)
        qi, qb, bias, bias_rows, alpha = _jax_prep(j._arrays, q, cq,
                                                   jnp.float32(j._base_scale))
        pp = pallas_ivf_dma.cluster_major_accum_planes(
            qb, j._arrays["vectors_t"], j._arrays["block_first"],
            j._arrays["block_last"], j._arrays["rows_valid"], blk=pb,
            group=8, depth=8, bias_rows=bias_rows)
        ncand = jnp.sum(j._arrays["sizes"][probes], axis=1)
        kk = 2 * K
        fin = {}
        for rescore, k in ((False, kk), (True, K)):
            v, ids, _, _ = j._cm_finish_planes(j._arrays, q, probes, slot, pp, k, kk,
                                               rescore, ncand, spill, alpha)
            fin[rescore] = (np.asarray(v), np.asarray(ids))
        out[pb] = dict(q=queries, probes=np.asarray(probes), qcap=qcap, cq=np.asarray(cq),
                       slot=np.asarray(slot), qi=np.asarray(qi), qb=np.asarray(qb),
                       bias=np.asarray(bias), bias_rows=np.asarray(bias_rows),
                       alpha=np.asarray(alpha), pp=np.asarray(pp), fin=fin)
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("pb", PAD_BLOCKS)
def test_kernel_state_bit_equal(pair, pb):
    j, t = pair[pb]
    assert t._base_scale == j._base_scale
    for name in ("vectors_t", "block_cluster", "block_first", "block_last",
                 "rows_valid", "last_block", "vector_norms", "reorder", "offsets",
                 "sizes"):
        a, b = np.asarray(j._arrays[name]), t._arrays[name].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert t._cm_max_nb == j._cm_max_nb
    assert t._coarse_tier == j._coarse_tier == "fp32"


def test_load_reads_jax_artifacts_and_back(pair, tmp_path):
    j, _ = pair[512]
    j.save(str(tmp_path / "jax"))
    t = tivf.IVFIndex.load(str(tmp_path / "jax"), device="cpu")
    t._ensure_kernel_state()
    assert t.PAD_BLOCK == 512 and t.metric == "l2" and t.dtype == "int8"
    assert np.asarray(j._arrays["vectors_t"]).tobytes() == t._arrays["vectors_t"].numpy().tobytes()
    t.save(str(tmp_path / "port"))
    j2 = jivf.IVFIndex.load(str(tmp_path / "port"))
    for name in ("_centroids_np", "_vectors_np", "_offsets_np", "_reorder_np"):
        np.testing.assert_array_equal(getattr(j2, name), getattr(j, name))
    with open(tmp_path / "port" / "ivf_config.json") as f:
        assert json.load(f)["probe_skew"] == j.config["probe_skew"]


@pytest.mark.parametrize("qcap", [3, 8])
def test_invert_probes_equal(qcap):
    rng = np.random.default_rng(20)
    probes = np.stack([rng.choice(16, 4, replace=False) for _ in range(32)]).astype(np.int32)
    jcq, jslot, jspill = jivf.invert_probes(jnp.asarray(probes), 16, qcap)
    tcq, tslot, tspill = tivf.invert_probes(_t(probes), 16, qcap)
    np.testing.assert_array_equal(tcq.numpy(), np.asarray(jcq))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    assert int(tspill) == int(jspill) > 0


@pytest.mark.parametrize("pb", PAD_BLOCKS)
def test_query_prep_and_bias_rows_bit_equal(pair, jax_stages, pb):
    _, t = pair[pb]
    s = jax_stages[pb]
    qi, qb, bias, bias_rows, alpha = t._scan_inputs(_t(s["q"]), _t(s["cq"]))
    assert qi.numpy().tobytes() == s["qi"].tobytes()
    assert bias.numpy().tobytes() == s["bias"].tobytes()
    assert qb.numpy().tobytes() == s["qb"].tobytes()
    assert bias_rows.numpy().tobytes() == s["bias_rows"].tobytes()
    assert alpha.numpy().tobytes() == s["alpha"].tobytes()


@pytest.mark.parametrize("pb", PAD_BLOCKS)
def test_k1_planes_bit_equal_on_real_index(pair, jax_stages, pb):
    _, t = pair[pb]
    s = jax_stages[pb]
    pp = t._scan(_t(s["qb"]), _t(s["bias_rows"]))
    rows = np.nonzero(t._arrays["block_last"].numpy())[0]
    assert len(rows) == 16
    np.testing.assert_array_equal(pp.numpy()[rows], s["pp"][rows])


@pytest.mark.parametrize("pb", PAD_BLOCKS)
def test_slice_stage_by_stage_equal(pair, jax_stages, pb):
    """JAX's probes feed the port's later stages: routing, prep, K1, the
    joined pool, the decoded rows and the final ids are all equal."""
    j, t = pair[pb]
    s = jax_stages[pb]
    probes = _t(s["probes"])
    cq, slot, _ = tivf.invert_probes(probes, t.nlist, s["qcap"])
    np.testing.assert_array_equal(cq.numpy(), s["cq"])
    np.testing.assert_array_equal(slot.numpy(), s["slot"])
    q = _t(s["q"])
    _, qb, _, bias_rows, alpha = t._scan_inputs(q, cq)
    pp = t._scan(qb, bias_rows)
    # Joined pool, against the JAX gather of the same planes.
    tl = np.asarray(j._arrays["last_block"])[s["probes"]]
    ok = (s["slot"] >= 0) & (np.asarray(j._arrays["sizes"])[s["probes"]] > 0)
    w = s["pp"].shape[2]
    want_pool = s["pp"].reshape(-1, w)[(tl * s["qcap"] + np.maximum(s["slot"], 0)).reshape(-1)]
    want_pool = np.where(ok.reshape(-1, 1), want_pool, pallas_ivf_dma.KMIN).reshape(len(q), -1)
    np.testing.assert_array_equal(t._join_pool(probes, slot, pp).numpy(), want_pool)
    # Decoded top-kk rows (as ids, with their int8 scores), then the rescore.
    kk = 2 * K
    for rescore, k in ((False, kk), (True, K)):
        v, ids = t._cm_finish_planes(q, probes, slot, pp, k, kk, rescore, alpha)
        np.testing.assert_array_equal(ids.numpy(), s["fin"][rescore][1])
        np.testing.assert_array_equal(v.numpy(), s["fin"][rescore][0])


def test_search_device_slice_bf16_tier(jax_base, small_data, monkeypatch):
    """The whole slice with the bf16 coarse tier (the SIFT-1M tier, forced
    here by lowering the tier threshold on both classes)."""
    base, queries = small_data
    monkeypatch.setattr(jivf.IVFIndex, "COARSE_BF16_MIN_NLIST", 16)
    monkeypatch.setattr(tivf.IVFIndex, "COARSE_BF16_MIN_NLIST", 16)
    j = jivf.IVFIndex(jax_base._centroids_np, jax_base._vectors_np,
                      jax_base._offsets_np, jax_base._reorder_np, metric="l2",
                      dtype="int8", pad_block=128, config=dict(jax_base.config))
    t = _port_of(j)
    assert j._coarse_tier == t._coarse_tier == "bf16"
    q = np.ascontiguousarray(queries)
    jv, jids, jc = j.search_device(jnp.asarray(q), K, NPROBE, mode="cluster")
    tv, tids, tc = t.search_device(_t(q), K, NPROBE, mode="cluster")
    assert j.last_engine == t.last_engine == "pallas_accum"
    assert int(t.last_spill) == int(j.last_spill) == 0
    # The coarse GEMM sums in another order, so a near-tie probe may flip.
    jp = np.sort(np.asarray(j._coarse_probes(j._arrays, jnp.asarray(q), NPROBE)), axis=1)
    tp = np.sort(t._coarse_probes(_t(q), NPROBE).numpy(), axis=1)
    agree = np.all(jp == tp, axis=1)
    print(f"probe agreement {agree.mean():.4f}")
    assert agree.mean() >= 0.97
    np.testing.assert_array_equal(tids.numpy()[agree], np.asarray(jids)[agree])
    np.testing.assert_array_equal(tv.numpy()[agree], np.asarray(jv)[agree])
    np.testing.assert_array_equal(tc.numpy()[agree], np.asarray(jc)[agree])
    gt = ground_truth(base, q, K, metric="l2", device="cpu")
    rj, rt = recall_at_k(np.asarray(jids), gt, K), recall_at_k(tids.numpy(), gt, K)
    print(f"recall@10 jax {rj:.4f} port {rt:.4f}")
    assert abs(rj - rt) <= 0.01


def test_search_device_slice_fused_tier(jax_base, small_data, monkeypatch):
    """The whole slice with the fused coarse tier (kernel K3 over the
    transposed, augmented centroids; the 10M configuration's tier, forced
    here by lowering the tier threshold on both classes)."""
    _, queries = small_data
    monkeypatch.setattr(jivf.IVFIndex, "COARSE_FUSED_MIN_NLIST", 16)
    monkeypatch.setattr(tivf.IVFIndex, "COARSE_FUSED_MIN_NLIST", 16)
    j = jivf.IVFIndex(jax_base._centroids_np, jax_base._vectors_np,
                      jax_base._offsets_np, jax_base._reorder_np, metric="l2",
                      dtype="int8", pad_block=512, config=dict(jax_base.config))
    t = _port_of(j)
    assert j._coarse_tier == t._coarse_tier == "fused"
    assert (np.asarray(j._arrays["centroids_t"]).tobytes()
            == t._arrays["centroids_t"].numpy().tobytes())
    q = np.ascontiguousarray(queries)
    jp = np.asarray(j._coarse_probes(j._arrays, jnp.asarray(q), NPROBE))
    tp = t._coarse_probes(_t(q), NPROBE).numpy()
    # The centroids are not integers, so the two fp32 sums round in
    # another order; on this data no probe lands on a near-tie.
    np.testing.assert_array_equal(tp, jp)
    jv, jids, jc = j.search_device(jnp.asarray(q), K, NPROBE, mode="cluster")
    tv, tids, tc = t.search_device(_t(q), K, NPROBE, mode="cluster")
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_search_host_api_pads_tail_cyclically(pair, small_data):
    _, t = pair[512]
    base, queries = small_data
    ids, scores, avg = t.search(queries, K, nprobe=NPROBE, batch_size=12, mode="cluster")
    assert ids.shape == (32, K) and scores.shape == (32, K)
    for s in range(0, 32, 12):
        chunk = np.resize(queries[s:s + 12], (12, queries.shape[1]))
        v, i, _ = t.search_device(_t(chunk), K, NPROBE, mode="cluster")
        got = min(12, 32 - s)
        np.testing.assert_array_equal(ids[s:s + got], i.numpy()[:got])
    gt = ground_truth(base, queries, K, metric="l2", device="cpu")
    assert recall_at_k(ids, gt, K) >= 0.9
    assert avg > 0


POLICY_GRID = ((32, 4), (8192, 4), (8192, 16), (100, 1))


def test_auto_policy_matches_jax(pair):
    j, t = pair[512]
    for b, np_ in POLICY_GRID:
        assert t._auto_qcap(b, np_) == j._auto_qcap(b, np_)
        assert t._est_max_load(b, np_) == j._est_max_load(b, np_)
        assert t._auto_recover(b, np_) == j._auto_recover(b, np_)
    assert t._accum_dim_cap() == j._accum_dim_cap()
    assert t._auto_cluster_k(10, True, None) == j._auto_cluster_k(10, True, None)


def test_auto_recover_passes_matches_jax(pair):
    j, t = pair[512]
    got = [t._auto_recover_passes(b, np_, rq) for b, np_ in POLICY_GRID for rq in (1, 8, 256)]
    assert got == [j._auto_recover_passes(b, np_, rq)
                   for b, np_ in POLICY_GRID for rq in (1, 8, 256)]
    assert len(set(got)) > 1


# Three recovery passes of 9 pairs each behind a main pass of qcap=4: a
# capacity of 31 pairs per cluster.  The test batch's hottest cluster holds
# 30 pairs, so recovery places every dropped pair; a batch of one query
# repeated 32 times loads its 4 clusters with 32 each and leaves a residual.
# Both runs share one compilation of the JAX search.  The third run is the
# grouped engine (kernel K4) on the dense walk; the last two are the routed
# engine (kernel K7, the routing inside the kernel) without and with the
# recovery pass, which then runs through K7 too.
RECOVER = dict(qcap=4, recover=True, recover_qcap=9, recover_blocks=16, recover_passes=3)
RECOVERY_RUNS = {"recover": RECOVER, "residual": RECOVER, "grouped": dict(engine="pallas"),
                 "routed": dict(engine="pallas_routed"),
                 "routed_recover": dict(RECOVER, engine="pallas_routed")}


@pytest.mark.parametrize("run", list(RECOVERY_RUNS))
def test_search_device_recovery_and_grouped_equal_jax(pair, small_data, run):
    j, t = pair[512]
    kw = RECOVERY_RUNS[run]
    q = np.ascontiguousarray(small_data[1])
    if run == "residual":
        q = np.repeat(q[:1], len(q), axis=0)
    jv, jids, jc = j.search_device(jnp.asarray(q), K, NPROBE, mode="cluster", **kw)
    tv, tids, tc = t.search_device(_t(q), K, NPROBE, mode="cluster", **kw)
    assert t.last_engine == j.last_engine
    assert int(t.last_spill) == int(j.last_spill)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if run in ("recover", "routed_recover"):
        assert int(t.last_spill) == 0
        t.search_device(_t(q), K, NPROBE, mode="cluster", qcap=4, recover=False)
        assert int(t.last_spill) > 0  # the pairs the recovery pass placed
    elif run == "residual":
        assert int(t.last_spill) == 4
    else:
        assert t.last_engine == kw["engine"]


@pytest.mark.parametrize("pad_block,bin_depth", [(1024, 5), (512, 9)],
                         ids=["depth5", "depth-past-bin"])
def test_search_device_bin_depth_equals_jax(jax_base, small_data, pad_block, bin_depth):
    """F8: the recovery pass at bin depth 5 (of the 8 columns a bin holds at
    pad_block 1024) and at a depth past a bin's 4 columns (pad_block 512:
    the same function as depth 4, which the card's general selection
    clamps to), equal to the JAX package."""
    j = jivf.IVFIndex(jax_base._centroids_np, jax_base._vectors_np, jax_base._offsets_np,
                      jax_base._reorder_np, metric="l2", dtype="int8", pad_block=pad_block,
                      config=dict(jax_base.config))
    t = _port_of(j)
    q = np.ascontiguousarray(small_data[1])
    kw = dict(RECOVER, bin_depth=bin_depth)
    jv, jids, jc = j.search_device(jnp.asarray(q), K, NPROBE, mode="cluster", **kw)
    tv, tids, tc = t.search_device(_t(q), K, NPROBE, mode="cluster", **kw)
    assert int(t.last_spill) == int(j.last_spill) == 0
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_signatures_take_jax_positions():
    """``search_device``, ``build``, ``kmeans``, ``ground_truth``,
    ``make_mesh`` and the sharded indexes take the JAX package's parameters
    in its order; the port only appends ``device`` (``device_type``)."""
    import inspect

    from rag_on_edge_tpu.parallel import mesh as jmesh
    from rag_on_edge_tpu.parallel import sharded as jsharded
    from rag_on_edge_tpu.utils import datasets as jdatasets
    from rag_on_edge_tpu_torch.parallel import mesh as tmesh
    from rag_on_edge_tpu_torch.parallel import sharded as tsharded
    from rag_on_edge_tpu_torch.utils import datasets as tdatasets

    def names(fn):
        return list(inspect.signature(fn).parameters)

    assert names(tivf.IVFIndex.search_device) == names(jivf.IVFIndex.search_device)
    assert names(tivf.IVFIndex.build) == names(jivf.IVFIndex.build) + ["device"]
    assert names(tkmeans.kmeans) == names(jkmeans.kmeans) + ["device"]
    assert names(tdatasets.ground_truth) == names(jdatasets.ground_truth) + ["device"]
    assert names(tmesh.make_mesh) == names(jmesh.make_mesh) + ["device_type"]
    for cls in ("ShardedIVFIndex", "ShardedBruteForceIndex"):
        assert (names(getattr(tsharded, cls).__init__)
                == names(getattr(jsharded, cls).__init__))


def test_mesh_arguments_bind_as_jax(jax_base, small_data):
    """``make_mesh(1, "shard")`` and ``mesh=`` on both sharded indexes bind
    as in JAX, and ``mesh=`` searches as the positional list does."""
    from rag_on_edge_tpu_torch.parallel.mesh import make_mesh
    from rag_on_edge_tpu_torch.parallel.sharded import (ShardedBruteForceIndex,
                                                        ShardedIVFIndex)

    mesh = make_mesh(1, "shard", device_type="cpu")
    assert mesh == [torch.device("cpu")]
    base, queries = small_data
    q = _t(queries[:4])
    two = [torch.device("cpu")] * 2
    kw = ShardedBruteForceIndex(base[:512], mesh=two, metric="l2", dtype="fp32")
    pos = ShardedBruteForceIndex(base[:512], two, "l2", "fp32")
    assert kw.devices == two
    for a, b in zip(kw.search_device(q, K), pos.search_device(q, K)):
        assert torch.equal(a, b)
    t = _port_of(jax_base)
    kw = ShardedIVFIndex(t, mesh=two)
    pos = ShardedIVFIndex(t, two)
    assert kw.devices == two
    for a, b in zip(kw.search_device(q, K, NPROBE, mode="cluster"),
                    pos.search_device(q, K, NPROBE, mode="cluster")):
        assert torch.equal(a, b)


def test_search_device_positional_equals_keyword(pair, small_data):
    """``search_device(q, k, nprobe, probe_chunk, mode)`` binds as in JAX:
    the 4th argument is ``probe_chunk`` (no effect in cluster mode), the
    5th ``mode``."""
    _, t = pair[512]
    q = _t(small_data[1])
    pos = t.search_device(q, K, NPROBE, None, "cluster")
    kw = t.search_device(q, K, NPROBE, mode="cluster")
    chunked = t.search_device(q, K, NPROBE, 8, "cluster")
    for a, b, c in zip(pos, kw, chunked):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_checkpoints_raise_naming_item_6(small_data, tmp_path):
    """The checkpoint at its JAX positions now builds and resumes: the same
    positional calls write the file, and a second call resumes from it to
    the same centroids and assignment (the index to the same arrays)."""
    base, _ = small_data
    ck = str(tmp_path / "ivf.ckpt.npz")
    a = tivf.IVFIndex.build(base, 16, "l2", "int8", "l2", 512, "padded", 42, 5, "kmeans++",
                            ck, device="cpu")
    assert int(np.load(ck)["next_iter"]) == 5
    b = tivf.IVFIndex.build(base, 16, "l2", "int8", "l2", 512, "padded", 42, 5, "kmeans++",
                            ck, device="cpu")
    for x, y in ((a._centroids_np, b._centroids_np), (a._reorder_np, b._reorder_np),
                 (a._offsets_np, b._offsets_np)):
        np.testing.assert_array_equal(x, y)
    ck = str(tmp_path / "km.ckpt.npz")
    c1, a1 = tkmeans.kmeans(base, 16, 42, 5, 1e-4, 131_072, "sample", 1024, ck, device="cpu")
    c2, a2 = tkmeans.kmeans(base, 16, 42, 5, 1e-4, 131_072, "sample", 1024, ck, device="cpu")
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)


# cluster_k below JAX's clamp (ceil(2k / nprobe) = 5) and above it, through
# the grouped engine, whose kernel (K4) emits cluster_k entries per cluster.
@pytest.mark.parametrize("cluster_k", [2, 8])
def test_search_device_cluster_k_equals_jax(pair, small_data, cluster_k):
    j, t = pair[512]
    q = np.ascontiguousarray(small_data[1])
    kw = dict(engine="pallas", cluster_k=cluster_k)
    jv, jids, jc = j.search_device(jnp.asarray(q), K, NPROBE, None, "cluster", **kw)
    tv, tids, tc = t.search_device(_t(q), K, NPROBE, None, "cluster", **kw)
    assert int(t.last_spill) == int(j.last_spill) == 0
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_auto_engine_falls_back_to_grouped(small_data):
    """400-dim int8 L2 vectors are past the accum engine's 384 (its packed
    key has no headroom for wider dots): ``engine="auto"`` takes the
    grouped engine (K4), and asking for ``pallas_accum`` is refused."""
    base, queries = small_data
    vecs = np.tile(base, (1, 4))[:, :400]
    qs = np.ascontiguousarray(np.tile(queries, (1, 4))[:, :400])
    t = tivf.IVFIndex.from_arrays(vecs.mean(0, keepdims=True), vecs,
                                  np.array([0, len(vecs)], np.int32),
                                  np.arange(len(vecs), dtype=np.int32), metric="l2",
                                  dtype="int8", pad_block=2048, device="cpu")
    _, ids, _ = t.search_device(_t(qs), K, 1, mode="cluster")
    assert t.last_engine == "pallas" and t.dim == 400 > t._accum_dim_cap()
    assert recall_at_k(ids.numpy(), ground_truth(vecs, qs, K, metric="l2",
                                                 device="cpu"), K) >= 0.99
    with pytest.raises(ValueError, match="pallas_accum"):
        t.search_device(_t(qs), K, 1, mode="cluster", engine="pallas_accum")


def test_assign_clusters_matches_jax(jax_base, small_data):
    base, _ = small_data
    c = jax_base._centroids_np
    want = np.asarray(jkmeans.assign_clusters(jnp.asarray(base), jnp.asarray(c)))
    got = tkmeans.assign_clusters(_t(base), _t(c)).numpy()
    assert (got == want).mean() >= 0.999


def test_kmeans_sample_init_matches_jax(small_data):
    base, _ = small_data
    jc, ja = jkmeans.kmeans(base, 16, seed=3, max_iter=5, init="sample")
    tc, ta = tkmeans.kmeans(base, 16, seed=3, max_iter=5, init="sample", device="cpu")
    # Same init rows; fp32 sums in another order.
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    assert (ta == ja).mean() >= 0.999


def test_build_kmeanspp_deterministic_and_recall(small_data):
    base, queries = small_data
    c1, a1 = tkmeans.kmeans(base, 16, seed=42, max_iter=3, device="cpu")
    c2, a2 = tkmeans.kmeans(base, 16, seed=42, max_iter=3, device="cpu")
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)
    t = tivf.IVFIndex.build(base, nlist=16, metric="l2", dtype="int8", pad_block=512,
                            seed=42, max_iter=25, device="cpu")
    gt = ground_truth(base, queries, K, metric="l2", device="cpu")
    ids, _, _ = t.search(queries, K, nprobe=NPROBE, mode="cluster")
    # k-means++ draws differ between the frameworks, so only recall is
    # held: the JAX index over the same corpus scores 0.9969 here.
    assert recall_at_k(ids, gt, K) >= 0.95


def test_build_spilled_matches_jax_layout(small_data):
    base, queries = small_data
    t = tivf.IVFIndex.build(base, nlist=16, metric="l2", dtype="int8", pad_block=512,
                            seed=42, max_iter=5, spill_eps=0.2, device="cpu")
    j = jivf.IVFIndex.build(base, nlist=16, metric="l2", dtype="int8", pad_block=512,
                            seed=42, spill_eps=0.2, centroids=t._centroids_np)
    assert t.spilled and t.config["n_spilled"] == j.config["n_spilled"] > 0
    np.testing.assert_array_equal(t._reorder_np, j._reorder_np)
    np.testing.assert_array_equal(t._offsets_np, j._offsets_np)
    ids, _, _ = t.search(queries, K, nprobe=NPROBE, mode="cluster")
    for row in ids:
        assert len(set(row.tolist())) == K


def test_port_runs_without_jax(tmp_path):
    """The port never imports jax or the JAX package: both are blocked in a
    fresh interpreter that runs the CPU slice (its default, recovered and
    routed searches), the brute-force index, both sharded indexes, the
    spatial GEMM and its benchmark, the kernel lab's four variants and the
    dataset loader."""
    code = textwrap.dedent("""
        import sys
        before = set(sys.modules)
        sys.modules["jax"] = None
        sys.modules["rag_on_edge_tpu"] = None
        import numpy as np, torch
        import rag_on_edge_tpu_torch as rt
        from rag_on_edge_tpu_torch.utils.datasets import make_synthetic, ground_truth
        from rag_on_edge_tpu_torch.utils.metrics import recall_at_k
        base, q = make_synthetic(1024, 16, 32, 8, seed=1)
        idx = rt.IVFIndex.build(base, nlist=16, metric="l2", dtype="int8",
                                pad_block=256, max_iter=5, device="cpu")
        ids, _, _ = idx.search(q, 5, nprobe=4, mode="cluster")
        r = recall_at_k(ids, ground_truth(base, q, 5, "l2", device="cpu"), 5)
        assert idx.last_engine == "pallas_accum" and r > 0.5, r
        qt = torch.from_numpy(q)
        idx.search_device(qt, 5, 4, mode="cluster", qcap=2, recover=False)
        assert int(idx.last_spill) > 0
        _, rids, _ = idx.search_device(qt, 5, 4, mode="cluster", qcap=2, recover=True,
                                       recover_qcap=32,
                                       recover_blocks=idx._arrays["vectors_t"].shape[0])
        assert int(idx.last_spill) == 0
        assert recall_at_k(rids.numpy(), ids, 5) >= 0.9
        _, tids, _ = idx.search_device(qt, 5, 4, mode="cluster", engine="pallas_routed", qcap=2,
                                       recover=True, recover_qcap=32,
                                       recover_blocks=idx._arrays["vectors_t"].shape[0])
        assert idx.last_engine == "pallas_routed" and int(idx.last_spill) == 0
        assert recall_at_k(tids.numpy(), ids, 5) >= 0.9
        bf = rt.BruteForceIndex(base, metric="l2", dtype="int8", engine="accum",
                                device="cpu")
        bids, _ = bf.search(q, 5, batch_size=8)
        assert recall_at_k(bids, ground_truth(base, q, 5, "l2", device="cpu"), 5) >= 0.99
        shards = [torch.device("cpu")] * 3
        sh = rt.ShardedIVFIndex(idx, shards)
        _, sids, _ = sh.search_device(qt, 5, 4, mode="cluster", engine="pallas", qcap=2,
                                      recover=True, recover_qcap=32, recover_blocks=8)
        assert sh.last_engine == "pallas" and int(sh.last_spill) == 0
        assert recall_at_k(sids.numpy(), ids, 5) >= 0.9
        sb = rt.ShardedBruteForceIndex(base, shards, metric="l2", dtype="int8", rescore=True)
        sbids, _ = sb.search(q, 5)
        assert recall_at_k(sbids, ground_truth(base, q, 5, "l2", device="cpu"), 5) >= 0.99
        from rag_on_edge_tpu_torch.harness import bench_gemm, kernel_lab
        from rag_on_edge_tpu_torch.parallel import spatial_matmul, verify_matmul
        from rag_on_edge_tpu_torch.utils.datasets import load_dataset
        cpu = torch.device("cpu")
        ga = torch.from_numpy(np.random.default_rng(0).integers(-127, 128, (64, 32), np.int8))
        gb = torch.from_numpy(np.random.default_rng(1).integers(-127, 128, (32, 48), np.int8))
        gc = spatial_matmul(ga, gb, [[cpu] * 2] * 2, use_pallas_kernel=True)
        assert gc.dtype == torch.int32 and verify_matmul(ga.numpy(), gb.numpy(), gc.numpy())
        assert bench_gemm.run(m=16, k=32, n=64, iters=2, stack=2, quiet=True,
                              mesh=[[cpu] * 2] * 2)["verified"]
        qg = kernel_lab.routed_table(idx, q, 64, 4, 8)
        a = idx._arrays
        for v in kernel_lab.VARIANTS:
            kernel_lab._variant_scan(qg, a["vectors_t"], a["block_cluster"], a["block_first"],
                                     a["block_last"], a["rows_valid"], 4, 256, 128, v)
        ds = load_dataset("unit", root=TMP, gt_k=5, device="cpu")
        assert ds.ground_truth_l2.shape == (32, 5)
        new = [m for m, v in sys.modules.items() if v is not None and m not in before]
        assert not any(m == "jax" or m.startswith(("jax.", "rag_on_edge_tpu."))
                       for m in new), new
        print("ok", r)
    """)
    code = code.replace("TMP", repr(str(tmp_path)))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


def test_search_device_k20_recovery_equals_jax(pair, small_data):
    """k = 20 with the recovery pass: its rescore pool of 2k = 40 is past
    the 32 the CUDA kernels keep a pass (the card runs two), and the port
    answers as the JAX package does."""
    j, t = pair[512]
    q = np.ascontiguousarray(small_data[1])
    jv, jids, jc = j.search_device(jnp.asarray(q), 20, NPROBE, mode="cluster", **RECOVER)
    tv, tids, tc = t.search_device(_t(q), 20, NPROBE, mode="cluster", **RECOVER)
    assert int(t.last_spill) == int(j.last_spill) == 0
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_float_index_at_d384_equals_jax():
    """An fp32 IVF index at a sentence embedding's width (D = 384, past the
    old float stage's 320): the same ids and scores as the JAX index, with
    the recovery pass forced."""
    from rag_on_edge_tpu.utils.datasets import make_synthetic

    base, queries = make_synthetic(n_base=1024, n_queries=8, dim=384, n_clusters=8, seed=8)
    j = jivf.IVFIndex.build(base, nlist=8, metric="l2", dtype="fp32", pad_block=128, seed=42)
    t = _port_of(j)
    kw = dict(mode="cluster", qcap=4, recover=True, recover_qcap=8, recover_passes=2)
    jv, jids, _ = j.search_device(jnp.asarray(queries), K, NPROBE, **kw)
    tv, tids, _ = t.search_device(_t(queries), K, NPROBE, **kw)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("metric,dtype", [("ip", "fp32"), ("l2", "int8")])
def test_compact_store_matches_padded(jax_base, small_data, metric, dtype):
    """store='compact' returns the padded store's results on the
    cluster-major path, and the JAX compact index's on the same arrays
    (``from_arrays``); neither store holds a padded fp32 copy until the xla
    engine asks for one, and the query mode and the xla engine agree
    across stores."""
    _, queries = small_data
    j = jivf.IVFIndex(jax_base._centroids_np, jax_base._vectors_np, jax_base._offsets_np,
                      jax_base._reorder_np, metric=metric, dtype=dtype, pad_block=512,
                      store="compact", config=dict(jax_base.config))
    pad = _port_of(j)
    cmp_ = _port_of(j, store="compact")
    assert (pad.store, cmp_.store) == ("padded", "compact")
    q = _t(queries)
    b = q.shape[0]
    for nprobe in (4, 16):
        v_p, i_p, c_p = pad.search_device(q, K, nprobe, mode="cluster", qcap=b)
        _, i_a, _ = cmp_.search_device(q, K, nprobe)  # auto → cluster on a compact store
        assert cmp_.last_mode == "cluster"
        v_c, i_c, c_c = cmp_.search_device(q, K, nprobe, mode="cluster", qcap=b)
        assert torch.equal(c_p, c_c) and torch.equal(i_p, i_c)
        np.testing.assert_allclose(v_p.numpy(), v_c.numpy(), rtol=1e-5)
        if nprobe == 4:
            jv, ji, jc = j.search_device(jnp.asarray(queries), K, nprobe, mode="cluster",
                                         qcap=b)
            np.testing.assert_array_equal(i_c.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(c_c.numpy(), np.asarray(jc))
            np.testing.assert_allclose(v_c.numpy(), np.asarray(jv), rtol=1e-6)
    assert "vectors" not in cmp_._arrays and "vectors_f32" in cmp_._arrays
    assert "vectors" not in pad._arrays and "vectors_f32" in pad._arrays
    assert cmp_.memory_report()["TOTAL"] <= pad.memory_report()["TOTAL"] + \
        cmp_._arrays["vectors_f32"].numel() * 4
    _, i_q, _ = cmp_.search_device(q, K, 4, mode="query")
    _, i_qp, _ = pad.search_device(q, K, 4, mode="query")
    assert torch.equal(i_q, i_qp)
    _, i_x, _ = cmp_.search_device(q, K, 4, mode="cluster", engine="xla", qcap=b)
    assert "vectors" in cmp_._arrays  # the lazy padded copy, xla engine only
    _, i_xp, _ = pad.search_device(q, K, 4, mode="cluster", engine="xla", qcap=b)
    assert torch.equal(i_x, i_xp)
