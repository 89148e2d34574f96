"""Parity of the PyTorch port's brute-force search with the JAX package, on
the CPU.

Inputs come from numpy seeds (or the shared ``small_data`` corpus: N=2048,
D=128, 32 queries) and go through both packages; the JAX Pallas kernels run
in interpret mode, as the JAX suite runs them.  The synthetic corpus is
integer-valued, so every fp32 (and bf16) product and sum is exact and the
comparisons are exact unless stated otherwise.  The CUDA kernels
themselves are tested on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.models import brute_force as jbf
from rag_on_edge_tpu.ops import pallas_bruteforce, pallas_bruteforce_dma
from rag_on_edge_tpu.ops import quantize as jquant
from rag_on_edge_tpu.ops import topk as jtopk
from rag_on_edge_tpu.utils import datasets as jdatasets
from rag_on_edge_tpu.utils import metrics as jmetrics
from rag_on_edge_tpu_torch.models import brute_force as tbf
from rag_on_edge_tpu_torch.ops import bruteforce_accum, bruteforce_fused, quantize, topk
from rag_on_edge_tpu_torch.utils import datasets

K = 10


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- selection

def _ties(seed=21, shape=(6, 300)):
    """int32 scores of few distinct values (heavy ties), one all-min row."""
    x = np.random.default_rng(seed).integers(0, 4, shape).astype(np.int32)
    x[2] = np.iinfo(np.int32).min
    return x


@pytest.mark.parametrize("fn", ["topk", "two_stage_topk", "approx_topk"])
def test_selection_with_ties_equals_jax(fn):
    x = _ties()
    # A block smaller than the row exercises the two-stage merge.
    kw = {"block": 64} if fn == "two_stage_topk" else {}
    jv, ji = getattr(jtopk, fn)(jnp.asarray(x), 12, **kw)
    tv, ti = getattr(topk, fn)(_t(x), 12, **kw)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))


def test_topk_ids_and_merge_topk_equal_jax():
    x = _ties(22).astype(np.float32)
    ids = np.random.default_rng(23).permutation(600)[:300].astype(np.int32)
    jv, ji = jtopk.topk(jnp.asarray(x), 7, ids=jnp.asarray(ids))
    tv, ti = topk.topk(_t(x), 7, ids=_t(ids))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    # Ties between the two sets go to the first.
    a_v, a_i = x[:, :9], np.tile(np.arange(9, dtype=np.int32), (6, 1))
    b_v, b_i = x[:, 9:18], a_i + 100
    jv, ji = jtopk.merge_topk(*(jnp.asarray(z) for z in (a_v, a_i, b_v, b_i)))
    tv, ti = topk.merge_topk(*(_t(z) for z in (a_v, a_i, b_v, b_i)))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_array_equal(topk.merge_topk(*(_t(z) for z in (a_v, a_i, b_v, b_i)),
                                                  k=4)[1].numpy(),
                                  _np(jtopk.merge_topk(*(jnp.asarray(z) for z in
                                                         (a_v, a_i, b_v, b_i)), k=4)[1]))


def test_dequantize_equals_jax():
    rng = np.random.default_rng(24)
    s = rng.integers(-2**20, 2**20, (5, 7)).astype(np.int32)
    qs = rng.uniform(0.01, 2, (5, 1)).astype(np.float32)
    bs = np.float32(0.37)
    want = jquant.dequantize(jnp.asarray(s), jnp.asarray(qs), jnp.asarray(bs))
    got = quantize.dequantize(_t(s), _t(qs), torch.tensor(bs))
    assert got.numpy().tobytes() == _np(want).tobytes()
    with pytest.raises(ValueError):
        quantize.dequantize(_t(s), _t(qs), torch.ones(3))


# ---------------------------------------------------------------- K3

def _k3_case(case):
    """(queries, base_t, kwargs for both packages, k) of one K3 case."""
    rng = np.random.default_rng(25)
    n = 1500 if "ragged" in case else 2048
    lo, hi = (0, 3) if "ties" in case else (-127, 128)
    q = rng.integers(lo, hi, (40, 64), dtype=np.int8)
    bt = rng.integers(lo, hi, (64, n), dtype=np.int8)
    kw = {"nbins": 128 if "bin" in case else 0}
    if "l2" in case:
        kw["alpha"] = rng.uniform(0.5, 2.0, 40).astype(np.float32)
        kw["bias"] = rng.uniform(0, 3e4, n).astype(np.float32)
    if "f32" in case:
        q, bt = q.astype(np.float32), bt.astype(np.float32)
    if "nvalid" in case:
        kw["n_valid"] = np.array([1111], np.int32)
    return q, bt, kw, 20


K3_CASES = ["i8-exact", "i8-bin", "i8-l2-exact", "i8-l2-bin", "f32-exact", "f32-bin",
            "i8-bin-nvalid", "i8-l2-bin-ragged", "i8-ties-exact", "i8-ties-bin"]


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_plain_equals_jax(case):
    q, bt, kw, k = _k3_case(case)
    jv, ji = pallas_bruteforce.fused_topk_matmul(
        jnp.asarray(q), jnp.asarray(bt), k, **{a: jnp.asarray(v) if isinstance(v, np.ndarray)
                                              else v for a, v in kw.items()})
    tv, ti = bruteforce_fused.fused_topk_matmul(
        _t(q), _t(bt), k, **{a: _t(v) if isinstance(v, np.ndarray) else v
                             for a, v in kw.items()})
    jv, ji = _np(jv), _np(ji)
    assert tv.numpy().dtype == jv.dtype
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    if "ties" in case:
        assert (jv[:, :-1] == jv[:, 1:]).any()  # equal scores are ranked by id
    if "nvalid" in case:
        assert ji.max() < 1111


def test_k3_tile_width_is_the_jax_wrappers():
    for b, n, l2 in ((8192, 10**6, True), (8192, 10**6, False), (32, 2048, True), (1, 300, False)):
        tb = min(-(-b // 32) * 32, 256)
        want = pallas_bruteforce.auto_tile_n(tb, n, 4, 1)
        assert bruteforce_fused.auto_tile_n(tb, n, 4, 1) == want
        if l2 and want > 512:
            want -= 512
        got = bruteforce_fused._resolve(torch.zeros((b, 8), dtype=torch.int8),
                                        torch.zeros((8, n), dtype=torch.int8), 1, None, None,
                                        0, torch.ones(b) if l2 else None,
                                        torch.ones(n) if l2 else None)[-1]
        assert got == want
    assert bruteforce_fused._resolve(torch.zeros((8192, 8), dtype=torch.int8),
                                     torch.zeros((8, 10**6), dtype=torch.int8), 1, None, None,
                                     128, torch.ones(8192), torch.ones(10**6))[-1] == 5632


def test_k3_rejects_bad_inputs():
    q = torch.zeros((4, 8), dtype=torch.int8)
    bt = torch.zeros((8, 300), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        bruteforce_fused.fused_topk_matmul(q.float(), bt, 3)
    with pytest.raises(ValueError, match="together"):
        bruteforce_fused.fused_topk_matmul(q, bt, 3, alpha=torch.ones(4))
    with pytest.raises(ValueError, match="k="):
        bruteforce_fused.fused_topk_matmul(q, bt, 301)
    with pytest.raises(ValueError, match="multiple"):
        bruteforce_fused.fused_topk_matmul(q, bt, 3, tile_n=512, nbins=100)


# ---------------------------------------------------------------- K5

def test_k5_tiling_helpers_bit_equal():
    rng = np.random.default_rng(26)
    bt = rng.integers(-127, 128, (16, 1500), dtype=np.int8)
    jt, jn = pallas_bruteforce_dma.tile_base(bt, 128, 4)
    tt, tn = bruteforce_accum.tile_base(_t(bt), 128, 4)
    assert tn == jn and tt.numpy().tobytes() == jt.tobytes() and tt.shape == jt.shape
    norms = rng.uniform(0, 5e5, 1500).astype(np.float32)
    jnt = pallas_bruteforce_dma.tile_norms(norms, 128, 4)
    tnt = bruteforce_accum.tile_norms(norms, 128, 4)
    assert tnt.tobytes() == jnt.tobytes() and tnt.shape == jnt.shape
    for alpha in (np.float32(3.7), np.float32(1e-4)):  # the second hits the clamp
        jb = pallas_bruteforce_dma.l2_bias_rows(jnp.asarray(jnt), jnp.asarray(alpha), 4)
        tb = bruteforce_accum.l2_bias_rows(_t(tnt), torch.tensor(alpha), 4)
        assert tb.numpy().tobytes() == _np(jb).tobytes()


def _k5_case(case):
    """(queries, base_tiles, n, kwargs, k) of one K5 case: tile_n 128,
    group 4, so T = 16 tiles; the ragged case masks a partial tile and skips
    the padded ones."""
    rng = np.random.default_rng(27)
    n = 1300 if "ragged" in case else 2048
    lo, hi = (0, 3) if "ties" in case else (-127, 128)
    q = rng.integers(lo, hi, (24, 32), dtype=np.int8)
    bt = rng.integers(lo, hi, (32, n), dtype=np.int8)
    tiles, _ = pallas_bruteforce_dma.tile_base(bt, 128, 4)
    kw = {"group": 4, "depth": 4}
    if "l2" in case:
        norms = pallas_bruteforce_dma.tile_norms(
            rng.uniform(0, 1e5, n).astype(np.float32), 128, 4)
        kw["bias_rows"] = np.asarray(pallas_bruteforce_dma.l2_bias_rows(
            jnp.asarray(norms), jnp.float32(7.0), 4))
    if "f32" in case or "bf16" in case:
        q, tiles = q.astype(np.float32), tiles.astype(np.float32)
    return q, tiles, n, kw, 20


K5_CASES = ["i8", "i8-l2", "i8-ties", "i8-l2-ragged", "f32", "bf16"]


@pytest.mark.parametrize("case", K5_CASES)
def test_k5_plain_equals_jax(case):
    q, tiles, n, kw, k = _k5_case(case)
    jq, jt = jnp.asarray(q), jnp.asarray(tiles)
    tq, tt = _t(q), _t(tiles)
    if case == "bf16":
        jq, jt = jq.astype(jnp.bfloat16), jt.astype(jnp.bfloat16)
        tq, tt = tq.to(torch.bfloat16), tt.to(torch.bfloat16)
    jkw = {a: jnp.asarray(v) if isinstance(v, np.ndarray) else v for a, v in kw.items()}
    tkw = {a: _t(v) if isinstance(v, np.ndarray) else v for a, v in kw.items()}
    jv, ji = pallas_bruteforce_dma.fused_topk_accum(jq, jt, n, k, **jkw)
    tv, ti = bruteforce_accum.fused_topk_accum(tq, tt, n, k, **tkw)
    jv, ji = _np(jv), _np(ji)
    assert tv.numpy().dtype == jv.dtype
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert ji.max() < n
    if "ties" in case:
        assert (jv[:, :-1] == jv[:, 1:]).any()


def test_k5_rejects_bad_inputs():
    q = torch.zeros((4, 8), dtype=torch.int8)
    tiles = torch.zeros((8, 8, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="power of two"):
        bruteforce_accum.fused_topk_accum(q, tiles, 900, 3, group=6, depth=2)
    with pytest.raises(ValueError, match="multiple of group"):
        bruteforce_accum.fused_topk_accum(q, tiles[:6], 700, 3, group=4, depth=4)
    with pytest.raises(ValueError, match="int8"):
        bruteforce_accum.fused_topk_accum(q.float(), tiles, 900, 3, group=4, depth=4)
    with pytest.raises(ValueError, match="bias_rows"):
        bruteforce_accum.fused_topk_accum(q.float(), tiles.float(), 900, 3, group=4, depth=4,
                                          bias_rows=torch.zeros((8, 1, 128), dtype=torch.int32))


# ---------------------------------------------------------------- the index

INDEX_CONFIGS = [(e, m, d) for e in ("xla", "pallas", "accum") for m in ("ip", "l2")
                 for d in ("int8", "fp32", "bf16")]


def _pair(small_data, **kw):
    base, _ = small_data
    return jbf.BruteForceIndex(base, **kw), tbf.BruteForceIndex(base, device="cpu", **kw)


def _search_both(j, t, queries, k=K):
    jv, ji = j.search_device(jnp.asarray(queries), k)
    tv, ti = t.search_device(_t(queries), k)
    return _np(jv), _np(ji), tv.numpy(), ti.numpy()


def _assert_same(j, t, queries, k=K):
    """Equal ids; equal scores, except where an unrescored int8 engine
    reports scores through the query scale.  There XLA reassociates the
    scale product under jit, computing ``(amax/127)·sb`` as ``amax·(sb/127)``
    (checked on the CPU backend), so those scores may differ by one or two
    ulps (rtol 3e-7); the port keeps the source's order."""
    jv, ji, tv, ti = _search_both(j, t, queries, k)
    np.testing.assert_array_equal(ti, ji)
    if t.dtype == "int8" and not t.rescore and t.engine != "accum":
        np.testing.assert_allclose(tv, jv, rtol=3e-7, atol=0)
    else:
        np.testing.assert_array_equal(tv, jv)
    return ti


@pytest.mark.parametrize("engine,metric,dtype", INDEX_CONFIGS,
                         ids=["-".join(c) for c in INDEX_CONFIGS])
def test_index_equals_jax(small_data, engine, metric, dtype):
    """Every array the index builds is bit-equal to the JAX index's, and a
    search returns equal ids and scores (the accum engine rescores by
    default, the others stay exact)."""
    j, t = _pair(small_data, metric=metric, dtype=dtype, engine=engine)
    assert t.engine == j.engine and t.rescore == j.rescore == (engine == "accum")
    assert sorted(t._arrays) == sorted(j._arrays)
    for name, a in j._arrays.items():
        a, b = _np(a), t._arrays[name]
        want = a.view(np.uint16) if str(a.dtype) == "bfloat16" else a
        got = b.view(torch.int16).numpy().view(np.uint16) if b.dtype == torch.bfloat16 \
            else b.numpy()
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), name
    assert t.memory_report() == jmetrics.memory_report(j._arrays)
    _assert_same(j, t, small_data[1])


@pytest.mark.parametrize("engine,dtype", [("pallas", "int8"), ("pallas", "fp32"),
                                          ("xla", "int8")])
def test_index_rescored_equals_jax(small_data, engine, dtype):
    """rescore=True on the exact engines: the pallas engine then runs K3
    binned (128 bins), the slice's ``engine="pallas", rescore=True``."""
    j, t = _pair(small_data, metric="l2", dtype=dtype, engine=engine, rescore=True,
                 rescore_depth=3)
    ti = _assert_same(j, t, small_data[1])
    gt = datasets.ground_truth(*small_data, K, metric="l2", device="cpu")
    assert jmetrics.recall_at_k(ti, gt, K) == 1.0


@pytest.mark.parametrize("select", ["exact", "two_stage", "iterative", "approx"])
def test_index_select_strategies_equal_jax(small_data, select):
    # "auto" is the passes for k <= 32, as "iterative" (test_index_equals_jax).
    j, t = _pair(small_data, metric="ip", dtype="int8", engine="xla", select=select)
    _assert_same(j, t, small_data[1], k=40)


def test_index_stream_host_api_and_guards(small_data):
    base, queries = small_data
    t = tbf.BruteForceIndex(base, metric="l2", dtype="int8", engine="accum", device="cpu")
    stream = _t(queries[:30].reshape(3, 10, -1))
    v_s, i_s = t.search_stream_device(stream, 5)
    for m in range(3):
        v, i = t.search_device(stream[m], 5)
        assert torch.equal(v_s[m], v) and torch.equal(i_s[m], i)
    ids, scores = t.search(queries, 5, batch_size=7)  # a zero-padded tail batch
    v, i = t.search_device(_t(queries), 5)
    np.testing.assert_array_equal(ids, i.numpy())
    np.testing.assert_array_equal(scores, v.numpy())
    # Queries far smaller than the base overflow the packed int8 L2 keys:
    # both hosts refuse them.
    j = jbf.BruteForceIndex(base, metric="l2", dtype="int8", engine="accum")
    for idx in (j, t):
        with pytest.raises(ValueError, match="overflow"):
            idx.search(queries * 1e-4, 5)
    with pytest.raises(ValueError, match="selection bins"):
        t.search_device(_t(queries), 300)
    with pytest.raises(ValueError, match="rescore_depth"):
        tbf.BruteForceIndex(base, rescore_depth=0, device="cpu")
    assert t.search(queries[:0], 5)[0].shape == (0, 5)


def test_index_auto_rule(rng):
    big = rng.uniform(0, 100, size=(100_000, 8)).astype(np.float32)
    assert tbf.BruteForceIndex(big[:2048], dtype="fp32", device="cpu").engine == "xla"
    t = tbf.BruteForceIndex(big, dtype="int8", device="cpu")
    assert t.engine == "accum" and t.rescore and t._acc_tile_n == 512
    wide = np.zeros((10, 4100), np.float32)
    with pytest.raises(ValueError, match="4096"):
        tbf.BruteForceIndex(wide, dtype="int8", engine="accum", device="cpu")


# ---------------------------------------------------------------- ground truth

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ground_truth_fused_equals_jax(small_data, metric):
    base, queries = small_data
    want = jdatasets._ground_truth_fused(base, queries, K, metric, 24)
    got = datasets._ground_truth_fused(base, queries, K, metric, 24, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, datasets.ground_truth(base, queries, K, metric,
                                                             device="cpu"))
