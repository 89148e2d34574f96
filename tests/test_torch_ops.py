"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages; the JAX Pallas
kernels run in interpret mode, as the JAX suite runs them.  The CUDA
kernels themselves are tested on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.ops import pallas_bruteforce, pallas_ivf, pallas_ivf_dma, pallas_topk
from rag_on_edge_tpu.ops import quantize as jquant
from rag_on_edge_tpu.ops import topk as jtopk
from rag_on_edge_tpu.utils import datasets as jdatasets
from rag_on_edge_tpu.utils import metrics as jmetrics
from rag_on_edge_tpu_torch.ops import _build, block_tables, distances, fused_topk, ivf_accum
from rag_on_edge_tpu_torch.ops import ivf_scan, quantize, topk
from rag_on_edge_tpu_torch.utils import datasets, metrics


def _np(x):
    return np.asarray(x)


def test_make_synthetic_byte_equal():
    a = jdatasets.make_synthetic(3000, 17, 64, 8, seed=3)
    b = datasets.make_synthetic(3000, 17, 64, 8, seed=3)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert datasets.DATASET_SPECS == jdatasets.DATASET_SPECS


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ground_truth_matches_jax(small_data, metric):
    base, queries = small_data
    want = jdatasets.ground_truth(base, queries, 10, metric=metric, backend="numpy")
    got = datasets.ground_truth(base, queries, 10, metric=metric, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(1)
    pred = rng.integers(0, 50, (20, 10))
    gt = rng.integers(0, 50, (20, 10))
    assert metrics.recall_at_k(pred, gt, 10) == jmetrics.recall_at_k(pred, gt, 10)
    with pytest.raises(ValueError):
        metrics.recall_at_k(pred[:, :5], gt, 10)


def test_quantize_bit_equal():
    x = np.random.default_rng(2).normal(0, 40, (64, 128)).astype(np.float32)
    js = jquant.calibrate_scale(jnp.asarray(x))
    ts = quantize.calibrate_scale(torch.from_numpy(x))
    assert _np(js).tobytes() == ts.numpy().tobytes()
    jq = jquant.quantize_int8(jnp.asarray(x))
    tq, _ = quantize.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(jq.values), tq.numpy())
    jr = jquant.calibrate_scale(jnp.asarray(x), per_row=True)
    tr = quantize.calibrate_scale(torch.from_numpy(x), per_row=True)
    np.testing.assert_array_equal(_np(jr), tr.numpy())


def test_quantize_int8_returns_jax_fields():
    """``QuantizedTensor(values, scale)`` with ``.shape``, as JAX's, and it
    still unpacks as ``values, scale``."""
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    jq = jquant.quantize_int8(jnp.asarray(x))
    tq = quantize.quantize_int8(torch.from_numpy(x))
    assert isinstance(tq, quantize.QuantizedTensor)
    np.testing.assert_array_equal(tq.values.numpy(), _np(jq.values))
    assert tq.scale.numpy().tobytes() == _np(jq.scale).tobytes()
    assert float(tq.scale) == pytest.approx(0.01830733, rel=1e-6)
    assert tuple(tq.shape) == tuple(jq.shape) == (4, 8)
    qv, qs = tq
    assert qv is tq.values and qs is tq.scale


@pytest.mark.parametrize("percentile,sort", [(100.0, False), (95.0, False), (37.5, False),
                                             (95.0, True), (0.0, True)])
def test_calibrate_scale_from_sample_equals_jax(percentile, sort, monkeypatch):
    """max|x| at 100, else ``jnp.percentile``'s linear interpolation;
    ``sort`` lowers the ``torch.quantile`` size limit so the sort branch
    of large inputs runs on this small one."""
    if sort:
        monkeypatch.setattr(quantize, "_QUANTILE_MAX", 8)
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    want = _np(jquant.calibrate_scale_from_sample(jnp.asarray(x), percentile))
    got = quantize.calibrate_scale_from_sample(torch.from_numpy(x), percentile)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    if percentile == 95.0:
        assert float(got) == pytest.approx(0.010489044, rel=1e-6)


def test_ground_truth_takes_jax_positions():
    """``ground_truth(base, q, k, metric, chunk)`` binds as JAX's, chunks
    merged with ties to the lower id; ``backend="jax"`` is refused by name."""
    base = np.random.default_rng(0).integers(-8, 8, (256, 16)).astype(np.float32)
    q = base[:8] + 1
    want = jdatasets.ground_truth(base, q, 5, "l2", 64)
    got = datasets.ground_truth(base, q, 5, "l2", 64, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [0, 103, 84, 61, 10]
    np.testing.assert_array_equal(
        datasets.ground_truth(base, q, 5, "ip", 48, 3, "numpy", device="cpu"),
        jdatasets.ground_truth(base, q, 5, "ip", 48, 3, "numpy"))
    with pytest.raises(ValueError, match="no JAX backend"):
        datasets.ground_truth(base, q, 5, "l2", 64, backend="jax", device="cpu")


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_score_matrix_matches_jax(small_data, metric):
    from rag_on_edge_tpu.ops import distances as jdist

    base, queries = small_data
    want = jdist.score_matrix(jnp.asarray(queries), jnp.asarray(base), metric=metric)
    got = distances.score_matrix(torch.from_numpy(queries), torch.from_numpy(base),
                                 metric=metric)
    # Integer-valued SIFT data: every product and partial sum is an exact
    # fp32 integer, so the two sum orders agree exactly.
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(distances.base_norms_sq(torch.from_numpy(base)).numpy(),
                                  _np(jdist.base_norms_sq(jnp.asarray(base))))


def _tie_int32():
    """int32 [40, 1024] with heavy ties (values 0..4), one all-min row."""
    x = np.random.default_rng(4).integers(0, 5, (40, 1024)).astype(np.int32)
    x[7] = np.iinfo(np.int32).min
    return x


def _neg_inf_f32():
    """f32 [16, 256] with -inf-only rows and a two-hit row."""
    x = np.random.default_rng(5).normal(size=(16, 256)).astype(np.float32)
    x[::4] = -np.inf
    x[1] = -np.inf
    x[1, 5] = x[1, 9] = 1.0
    return x


CASES = [pytest.param(_tie_int32, 20, id="int32-ties-k20"),
         pytest.param(_neg_inf_f32, 8, id="f32-neginf-k8")]


@pytest.mark.parametrize("make,k", CASES)
def test_small_topk_exactly_equal(make, k):
    x = make()
    for jfn, tfn in ((jtopk.small_topk, topk.small_topk),
                     (jtopk.iterative_topk, topk.iterative_topk)):
        jv, ji = jfn(jnp.asarray(x), k)
        tv, ti = tfn(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), _np(jv))
        np.testing.assert_array_equal(ti.numpy(), _np(ji))


def test_small_topk_sort_branch_matches_jax():
    x = np.random.default_rng(6).integers(0, 7, (8, 256)).astype(np.int32)
    jv, ji = jtopk.small_topk(jnp.asarray(x), 40)
    tv, ti = topk.small_topk(torch.from_numpy(x), 40)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))


@pytest.mark.parametrize("make,k", CASES)
def test_fused_topk_plain_equals_jax_kernel(make, k):
    x = make()
    jv, ji = pallas_topk.fused_topk(jnp.asarray(x), k)
    tv, ti = fused_topk.fused_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))


def test_fused_topk_fill_rows_repeat_position_zero():
    # Once a row holds only fill values every further pass returns position
    # 0 again (a stable sort would give 0, 1).
    x = np.full((1, 128), -np.inf, np.float32)
    x[0, 5] = x[0, 9] = 1.0
    _, ti = fused_topk.fused_topk(torch.from_numpy(x), 4)
    _, ji = pallas_topk.fused_topk(jnp.asarray(x), 4)
    assert ti.tolist() == [[5, 9, 0, 0]] == _np(ji).tolist()


def test_fused_topk_rejects_bad_inputs():
    with pytest.raises(ValueError):
        fused_topk.fused_topk(torch.zeros((4, 100), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        fused_topk.fused_topk(torch.zeros((4, 128), dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        fused_topk.fused_topk(torch.zeros((4, 128), dtype=torch.int32), 129)


@pytest.mark.parametrize("case", ["device", "mixed"])
def test_check_inputs_refuses(case):
    """The one rule every kernel wrapper applies before a launch, held with
    device objects alone (no CUDA tensor is made)."""
    x = torch.zeros(4, dtype=torch.int8)
    cuda = torch.device("cuda")
    if case == "device":
        with pytest.raises(ValueError, match="unsupported device"):
            _build.check_inputs("K1", torch.device("meta"), [x])
    else:  # an input off the named device; None entries are skipped
        with pytest.raises(ValueError, match="one device"):
            _build.check_inputs("K1", cuda, [None, x])


def test_dedup_rows_by_id_matches_jax():
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 50, (6, 24)).astype(np.float32)
    vals[:, ::5] = -np.inf
    ids = rng.integers(0, 10, (6, 24)).astype(np.int32)
    payload = np.arange(6 * 24, dtype=np.int32).reshape(6, 24)
    jv, jid, jp = jtopk.dedup_rows_by_id(jnp.asarray(vals), jnp.asarray(ids),
                                         payload=jnp.asarray(payload))
    tv, tid, tp = topk.dedup_rows_by_id(torch.from_numpy(vals), torch.from_numpy(ids),
                                        payload=torch.from_numpy(payload))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(tid.numpy(), _np(jid))
    # Best copy survives: the selected set is what the rescore consumes.
    for r in range(6):
        assert sorted(zip(tv[r].tolist(), tid[r].tolist())) == sorted(
            zip(_np(jv)[r].tolist(), _np(jid)[r].tolist()))
    with pytest.raises(TypeError):
        topk.dedup_rows_by_id(torch.zeros((2, 3), dtype=torch.int32), torch.zeros((2, 3)))


def test_build_block_tables_equal():
    rng = np.random.default_rng(9)
    sizes = rng.integers(0, 900, 23)
    sizes[[0, 5]] = 0
    blk = 256
    offs = np.concatenate([[0], np.cumsum(-(-sizes // blk) * blk)[:-1]])
    for a, b in zip(pallas_ivf.build_block_tables(offs, sizes, blk),
                    block_tables.build_block_tables(offs, sizes, blk)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_monotone_key_roundtrip_matches_jax():
    x = np.random.default_rng(10).normal(0, 1e3, 512).astype(np.float32)
    x[:3] = [0.0, -0.0, -np.inf]
    jk = pallas_ivf_dma._monotone_key(jnp.asarray(x))
    tk = ivf_accum._monotone_key(torch.from_numpy(x))
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    np.testing.assert_array_equal(ivf_accum._key_to_f32(tk).numpy().view(np.int32),
                                  x.view(np.int32))


def _k1_inputs(rng, sizes, blk, qcap, d, lo=-127, hi=128):
    sizes = np.asarray(sizes)
    offs = np.concatenate([[0], np.cumsum(-(-sizes // blk) * blk)[:-1]])
    _, bf, bl, rv, _ = block_tables.build_block_tables(offs, sizes, blk)
    pad = (-len(bf)) % 8
    bf, bl, rv = (np.pad(x, (0, pad)).astype(np.int32) for x in (bf, bl, rv))
    nb = len(bf)
    qg = rng.integers(lo, hi, (nb, qcap, d), dtype=np.int8)
    vt = rng.integers(lo, hi, (nb, d, blk), dtype=np.int8)
    return qg, vt, bf, bl, rv


@pytest.mark.parametrize("bin2", [True, False], ids=["bin2", "bin1"])
def test_k1_plain_equals_jax_int8_no_bias(bin2):
    rng = np.random.default_rng(11)
    qg, vt, bf, bl, rv = _k1_inputs(rng, [300, 0, 700, 129, 40], 256, 24, 64)
    want = pallas_ivf_dma.cluster_major_accum_planes(
        *map(jnp.asarray, (qg, vt, bf, bl, rv)), blk=256, bin2=bin2)
    got = ivf_accum.cluster_major_accum_planes(
        *map(torch.from_numpy, (qg, vt, bf, bl, rv)), blk=256, bin2=bin2)
    rows = np.nonzero(bl)[0]
    np.testing.assert_array_equal(got.numpy()[rows], _np(want)[rows])


def test_k1_plain_float_modes_match_jax():
    # fp32 monotone keys: the product of small integers is exact in both
    # frameworks, so the keys agree bit for bit.
    rng = np.random.default_rng(12)
    qg, vt, bf, bl, rv = _k1_inputs(rng, [200, 300], 128, 8, 16)
    qf, vf = (x.astype(np.float32) for x in (qg, vt))
    want = pallas_ivf_dma.cluster_major_accum_planes(
        *map(jnp.asarray, (qf, vf, bf, bl, rv)), blk=128, depth=4)
    got = ivf_accum.cluster_major_accum_planes(
        *map(torch.from_numpy, (qf, vf, bf, bl, rv)), blk=128)
    rows = np.nonzero(bl)[0]
    np.testing.assert_array_equal(got.numpy()[rows], _np(want)[rows])


def test_k1_rejects_bad_inputs():
    rng = np.random.default_rng(13)
    qg, vt, bf, bl, rv = (torch.from_numpy(x) for x in _k1_inputs(rng, [100], 128, 8, 16))
    with pytest.raises(ValueError):  # blk beyond the 4-bit chunk id
        ivf_accum.cluster_major_accum_planes(qg, vt, bf, bl, rv, blk=4096)
    with pytest.raises(ValueError):  # mixed dtypes
        ivf_accum.cluster_major_accum_planes(qg.float(), vt, bf, bl, rv, blk=128)
    with pytest.raises(ValueError):  # bias rows on the float path
        ivf_accum.cluster_major_accum_planes(
            qg.float(), vt.float(), bf, bl, rv, blk=128,
            bias_rows=torch.zeros((8, 1, 128), dtype=torch.int32))
    wide = torch.zeros((8, 8, 400), dtype=torch.int8)
    with pytest.raises(ValueError):  # dim past the L2 bias cap
        ivf_accum.cluster_major_accum_planes(
            wide, torch.zeros((8, 400, 128), dtype=torch.int8), bf, bl, rv, blk=128,
            bias_rows=torch.zeros((8, 1, 128), dtype=torch.int32))


@pytest.mark.parametrize("depth", [2, 3])
def test_binned_top2_matches_jax(depth):
    # Few distinct values, so bins hold equal values; one row is all -inf
    # and one holds a single finite value.
    sc = np.random.default_rng(16).integers(0, 4, (6, 512)).astype(np.float32)
    sc[2] = -np.inf
    sc[4, 1:] = -np.inf
    jv, ji = pallas_bruteforce.binned_top2(jnp.asarray(sc), 1000, 512, 128, -np.inf, depth=depth)
    tv, ti = topk.binned_top2(torch.from_numpy(sc), 1000, 512, 128, float("-inf"), depth=depth)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))


def test_extract_topk_ids_matches_jax():
    # K4's merge: a fill state (-inf, id 0) beside binned survivors whose
    # values tie; ids of fill entries repeat.
    rng = np.random.default_rng(17)
    vals = np.concatenate([np.full((5, 8), -np.inf), rng.integers(0, 3, (5, 24))], 1)
    ids = np.concatenate([np.zeros((5, 8)), rng.permutation(100)[:24][None].repeat(5, 0)], 1)
    vals[3, 8:] = -np.inf
    vals, ids = vals.astype(np.float32), ids.astype(np.int32)
    jv, ji = pallas_bruteforce._extract_topk(jnp.asarray(vals), jnp.asarray(ids), 12, -np.inf)
    tv, ti = topk.extract_topk_ids(torch.from_numpy(vals), torch.from_numpy(ids), 12,
                                   float("-inf"))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))


K4_BLK, K4_K = 512, 20
# Clusters of 2, 0, 3, 1 and 1 blocks (the last too small to fill k, so its
# rows end in -inf), padded to 8 blocks.
K4_SIZES = [700, 0, 1300, 129, 10]


def _k4_case(case):
    """Inputs of one K4 case → (qg, vt, bf, bl, rv, bias, row_base, depth).
    Shapes repeat across cases where they can, so the JAX kernel compiles
    once for several of them."""
    rng = np.random.default_rng(18)
    ties = case == "i8-ties-d3"
    qg, vt, bf, bl, rv = _k1_inputs(rng, K4_SIZES, K4_BLK, 12, 16,
                                    *((0, 2) if ties else (-127, 128)))
    nb = len(bf)
    rb = np.arange(nb, dtype=np.int32) * K4_BLK
    bias = None
    if case.startswith("i8-bias"):
        bias = rng.uniform(0, 3000, (nb, 1, K4_BLK)).astype(np.float32)
    if ties:
        # The 3-block cluster's later blocks score 0 everywhere, below every
        # row's k-th value: the TPU kernel skips them (`improves` is false).
        vt[3:5] = 0
    if case == "f32-aug-d2":
        qg = np.concatenate([qg.astype(np.float32) // 16, np.ones((nb, 12, 1), np.float32)], 2)
        v = vt.astype(np.float32) // 16
        vt = np.concatenate([v, -0.5 * np.sum(v * v, axis=1, keepdims=True)], 1)
    if "compact" in case:
        # The recovery pass's list: the blocks of clusters 2 and 4 in storage
        # order, then the other blocks with zeroed tables, row_base = block·blk.
        seg = np.cumsum(bf) - 1
        active = np.isin(seg, [1, 3]) & (rv > 0)
        blocks = np.concatenate([np.nonzero(active)[0], np.nonzero(~active)[0]])
        inc = active[blocks]
        qg, vt, rb = qg[blocks], vt[blocks], rb[blocks]
        bf, bl, rv = (np.where(inc, x[blocks], 0).astype(np.int32) for x in (bf, bl, rv))
        bias = None if bias is None else bias[blocks]
    return qg, vt, bf, bl, rv, bias, rb, 3 if case.endswith("d3") else 2


@pytest.mark.parametrize("case", ["i8-bias-dense-d2", "i8-bias-compact-d2", "i8-compact-d3",
                                  "i8-ties-d3", "f32-aug-d2"])
def test_k4_plain_equals_jax(case):
    qg, vt, bf, bl, rv, bias, rb, depth = _k4_case(case)
    jv, ji = pallas_ivf.cluster_major_scan_grouped(
        *map(jnp.asarray, (qg, vt, bf, bl, rv)), k=K4_K, blk=K4_BLK, bin_depth=depth,
        bias=None if bias is None else jnp.asarray(bias), row_base=jnp.asarray(rb))
    tv, ti = ivf_scan.cluster_major_scan_grouped(
        *map(torch.from_numpy, (qg, vt, bf, bl, rv)), k=K4_K, blk=K4_BLK, bin_depth=depth,
        bias=None if bias is None else torch.from_numpy(bias), row_base=torch.from_numpy(rb))
    rows = np.nonzero(bl)[0]
    jv, ji, tv, ti = _np(jv)[rows], _np(ji)[rows], tv.numpy()[rows], ti.numpy()[rows]
    np.testing.assert_array_equal(tv, jv)
    fin = jv > -np.inf
    np.testing.assert_array_equal(ti[fin], ji[fin])
    assert fin.any()
    if case == "i8-ties-d3":
        assert not fin.all()  # the 10-row cluster cannot fill k=20
        assert (jv[rows == 4][..., K4_K - 1] > 0).all()  # blocks 3-4 (all 0) were skipped
        chunks = np.sort((qg[2].astype(np.int32) @ vt[2].astype(np.int32))
                         .reshape(12, 4, 128), axis=1)
        assert (chunks[:, -1] == chunks[:, -2]).any()  # a bin's two best are equal


def test_k4_rejects_bad_inputs():
    qg, vt, bf, bl, rv, _, _, _ = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                                   for x in _k4_case("i8-compact-d3"))
    with pytest.raises(ValueError):  # blk not a multiple of nbins
        ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, 5, blk=K4_BLK, nbins=96)
    with pytest.raises(ValueError):  # nblocks not a multiple of group
        ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, 5, blk=K4_BLK, group=3)
    with pytest.raises(ValueError):  # mixed dtypes
        ivf_scan.cluster_major_scan_grouped(qg.float(), vt, bf, bl, rv, 5, blk=K4_BLK)
    with pytest.raises(ValueError):  # int32 bias
        ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, 5, blk=K4_BLK,
                                            bias=torch.zeros((8, 1, K4_BLK), dtype=torch.int32))
