"""Parity of kernels K7 (the routed scan) and K9 (the extract-emit accum
scan) of the PyTorch port with the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages; the JAX Pallas
kernels run in interpret mode, as the JAX suite runs them.  Shapes are toy
ones (blk 256, d 64, 8 blocks, two blocks per grid step), so that the
interpreted JAX kernels compile quickly.  The CUDA kernels are tested on the
card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.ops import pallas_ivf, pallas_ivf_dma
from rag_on_edge_tpu_torch.ops import block_tables, ivf_accum, ivf_scan

BLK, D, K = 256, 64, 5


def _np(x):
    return np.asarray(x)


def _tables(sizes):
    """Block tables of clusters of ``sizes`` rows, padded to 8 blocks with
    dummies on the last cluster → (bc, bf, bl, rv) int32."""
    sizes = np.asarray(sizes)
    offs = np.concatenate([[0], np.cumsum(-(-sizes // BLK) * BLK)[:-1]])
    bc, bf, bl, rv, _ = block_tables.build_block_tables(offs, sizes, BLK)
    pad = (-len(bc)) % 8
    bc = np.pad(bc, (0, pad), constant_values=len(sizes) - 1).astype(np.int32)
    bf, bl, rv = (np.pad(x, (0, pad)).astype(np.int32) for x in (bf, bl, rv))
    return bc, bf, bl, rv


# --------------------------------------------------------------------- K7

# Clusters of 2, 0, 3, 1 and 1 blocks; the last is too small to fill k.
K7_SIZES = [300, 0, 700, 129, 3]
K7_B, K7_QCAP = 40, 12


def _k7_case(case):
    """Inputs of one K7 case → (qi, cq_blocks [nb, qcap, 1], vt, bf, bl,
    rv, bias, row_base, depth)."""
    rng = np.random.default_rng(40)
    bc, bf, bl, rv = _tables(K7_SIZES)
    nb, nlist = len(bc), len(K7_SIZES)
    qi = rng.integers(-127, 128, (K7_B, D), dtype=np.int8)
    vt = rng.integers(-127, 128, (nb, D, BLK), dtype=np.int8)
    # Each cluster's routed queries, with empty (-1) slots at the end.
    cq = np.full((nlist, K7_QCAP), -1, np.int32)
    for c in range(nlist):
        n = rng.integers(3, K7_QCAP)
        cq[c, :n] = rng.choice(K7_B, n, replace=False)
    rb = np.arange(nb, dtype=np.int32) * BLK
    bias = None
    if case == "i8-bias-dense":
        bias = rng.uniform(0, 3000, (nb, 1, BLK)).astype(np.float32)
    if case == "f32-aug":
        qf = qi.astype(np.float32) // 16
        qi = np.concatenate([qf, np.ones((K7_B, 1), np.float32)], 1)
        v = vt.astype(np.float32) // 16
        vt = np.concatenate([v, -0.5 * np.sum(v * v, axis=1, keepdims=True)], 1)
    cqb = cq[bc]
    if case == "i8-compact":
        # The recovery pass's list: the blocks of clusters 2 and 4 in storage
        # order, then the other blocks with zeroed tables; row_base = block·blk.
        seg = np.cumsum(bf) - 1
        active = np.isin(seg, [1, 3]) & (rv > 0)
        blocks = np.concatenate([np.nonzero(active)[0], np.nonzero(~active)[0]])
        inc = active[blocks]
        cqb, vt, rb = cqb[blocks], vt[blocks], rb[blocks]
        bf, bl, rv = (np.where(inc, x[blocks], 0).astype(np.int32) for x in (bf, bl, rv))
    return (qi, np.ascontiguousarray(cqb[..., None]), vt, bf, bl, rv, bias, rb,
            3 if case == "i8-compact" else 2)


@pytest.mark.parametrize("case", ["i8-bias-dense", "i8-compact", "f32-aug"])
def test_k7_plain_equals_jax(case):
    qi, cqb, vt, bf, bl, rv, bias, rb, depth = _k7_case(case)
    jv, ji = pallas_ivf.cluster_major_scan_routed(
        *map(jnp.asarray, (qi, cqb, vt, bf, bl, rv)), k=K, blk=BLK, group=2, bin_depth=depth,
        bias=None if bias is None else jnp.asarray(bias), row_base=jnp.asarray(rb))
    tv, ti = ivf_scan.cluster_major_scan_routed(
        *map(torch.from_numpy, (qi, cqb, vt, bf, bl, rv)), k=K, blk=BLK, group=2, bin_depth=depth,
        bias=None if bias is None else torch.from_numpy(bias), row_base=torch.from_numpy(rb))
    rows = np.nonzero(bl)[0]
    jv, ji, tv, ti = _np(jv)[rows], _np(ji)[rows], tv.numpy()[rows], ti.numpy()[rows]
    assert tv.tobytes() == jv.tobytes()
    fin = jv > -np.inf
    np.testing.assert_array_equal(ti[fin], ji[fin])
    assert fin.any() and not fin.all()  # empty slots and the 3-row cluster end in -inf
    assert (cqb[rows] < 0).any()


def test_k7_plain_equals_k4_on_the_gathered_table():
    qi, cqb, vt, bf, bl, rv, bias, rb, depth = _k7_case("i8-bias-dense")
    cqb[0, 0, 0] = K7_B  # an index past the batch gives a zero row, as -1 does
    cq = cqb[..., 0]
    hit = (cq >= 0) & (cq < K7_B)
    qg = np.where(hit[..., None], qi[np.where(hit, cq, 0)], 0).astype(np.int8)
    args = dict(k=K, blk=BLK, bin_depth=depth, bias=torch.from_numpy(bias),
                row_base=torch.from_numpy(rb))
    tabs = [torch.from_numpy(x) for x in (vt, bf, bl, rv)]
    pv, pr = ivf_scan.cluster_major_scan_routed(torch.from_numpy(qi), torch.from_numpy(cqb),
                                                *tabs, **args)
    gv, gr = ivf_scan.cluster_major_scan_grouped(torch.from_numpy(qg), *tabs, **args)
    rows = torch.from_numpy(np.nonzero(bl)[0])
    assert torch.equal(pv[rows], gv[rows])
    fin = gv[rows] > float("-inf")
    assert torch.equal(pr[rows][fin], gr[rows][fin])


def test_k7_rejects_bad_inputs():
    qi, cqb, vt, bf, bl, rv, _, _, _ = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                                        for x in _k7_case("i8-compact"))
    with pytest.raises(ValueError):  # cq_blocks without its trailing 1
        ivf_scan.cluster_major_scan_routed(qi, cqb[..., 0], vt, bf, bl, rv, K, blk=BLK)
    with pytest.raises(ValueError):  # int64 indices
        ivf_scan.cluster_major_scan_routed(qi, cqb.long(), vt, bf, bl, rv, K, blk=BLK)
    with pytest.raises(ValueError):  # mixed dtypes
        ivf_scan.cluster_major_scan_routed(qi.float(), cqb, vt, bf, bl, rv, K, blk=BLK)
    with pytest.raises(ValueError):  # nblocks not a multiple of group
        ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, K, blk=BLK, group=3)
    with pytest.raises(ValueError):  # slabs of another width
        ivf_scan.cluster_major_scan_routed(qi[:, :32], cqb, vt, bf, bl, rv, K, blk=BLK)


# --------------------------------------------------------------------- K9


def _clustered():
    """``tests/test_pallas_accum.py::TestClusterMajorAccum.clustered``,
    rebuilt with numpy: clusters of 300, 120, 0, 700, 256 and 90 rows in
    blocks of 256 (8 blocks), 5 routed queries of 32 per cluster."""
    rng = np.random.default_rng(1)
    sizes = np.array([300, 120, 0, 700, 256, 90], np.int64)
    offsets = np.concatenate([[0], np.cumsum(-(-sizes // BLK) * BLK)])[:-1]
    bc, bf, bl, rv, _ = block_tables.build_block_tables(offsets, sizes, BLK)
    padb = (-len(bc)) % 8
    if len(bc) + padb < 8:
        padb = 8 - len(bc)
    bc, bf, bl, rv = (np.pad(x, (0, padb)) for x in (bc, bf, bl, rv))
    n_padded = int(offsets[-1] + -(-int(sizes[-1]) // BLK) * BLK)
    vecs = np.zeros((n_padded, D), np.float32)
    for c in range(len(sizes)):
        vecs[offsets[c]:offsets[c] + sizes[c]] = rng.standard_normal((sizes[c], D))
    vq = np.clip(np.round(vecs / 0.02), -127, 127).astype(np.int8)
    vt = np.zeros((len(bc), D, BLK), np.int8)
    for j in range(len(bc) - padb):
        vt[j] = vq[j * BLK:(j + 1) * BLK].T
    qs = rng.standard_normal((32, D)).astype(np.float32)
    qi = np.clip(np.round(qs / 0.02), -127, 127).astype(np.int8)
    cq = np.full((len(sizes), 16), -1, np.int32)
    for c in range(len(sizes)):
        cq[c, :5] = rng.choice(32, size=5, replace=False)
    qk = np.where((cq >= 0)[..., None], qi[np.clip(cq, 0, None)], 0)
    return qk[bc].astype(np.int8), vt, bf, bl, rv


@pytest.mark.parametrize("case", ["i8-ip-bin2", "i8-ip-bin1", "i8-l2-bias", "f32-ip"])
def test_k9_plain_equals_jax(case):
    qb, vt, bf, bl, rv = _clustered()
    bias_rows = None
    if case == "i8-l2-bias":
        bias = np.random.default_rng(2).uniform(0, 4e4, (len(bf), 1, BLK)).astype(np.float32)
        bias_rows = ivf_accum.accum_bias_rows(torch.from_numpy(bias),
                                              torch.from_numpy(rv)).numpy()
    if case == "f32-ip":  # integer values: every fp32 sum is exact
        qb, vt = qb.astype(np.float32), vt.astype(np.float32)
    bin1 = case == "i8-ip-bin1"
    if bin1:
        # The row mask leaves the last cluster 3 rows, fewer than k: its
        # rows end in the fill entries.
        rv = rv.copy()
        rv[np.nonzero(bl)[0][-1]] = 3
    # group and depth shape the TPU's DMA ring and change no result; small
    # ones keep the interpreted JAX kernel quick to compile.
    kw = dict(k=K, blk=BLK, group=2, depth=2, bin2=not bin1)
    jv, ji = pallas_ivf_dma.cluster_major_accum(
        *map(jnp.asarray, (qb, vt, bf, bl, rv)),
        bias_rows=None if bias_rows is None else jnp.asarray(bias_rows), **kw)
    tv, ti = ivf_accum.cluster_major_accum(
        *map(torch.from_numpy, (qb, vt, bf, bl, rv)),
        bias_rows=None if bias_rows is None else torch.from_numpy(bias_rows), **kw)
    rows = np.nonzero(bl)[0]
    assert len(rows) == 5
    jv, ji, tv, ti = _np(jv)[rows], _np(ji)[rows], tv.numpy()[rows], ti.numpy()[rows]
    assert tv.tobytes() == jv.tobytes()
    np.testing.assert_array_equal(ti, ji)
    fin = jv > -np.inf
    assert fin.any()
    if bin1:
        assert not fin.all() and (ti[~fin] == 0).all()  # fill entries: -inf, row 0


def test_k9_bias_rows_layout():
    bias = torch.tensor([[[0.4, 2.6, 1e9, 7.0]]] * 17, dtype=torch.float32)
    rv = torch.full((17,), 2, dtype=torch.int32)
    rows = ivf_accum.accum_bias_rows(bias, rv)
    code = 15 - torch.arange(17, dtype=torch.int32) % 16
    assert rows.dtype == torch.int32 and rows.shape == (17, 1, 4)
    assert torch.equal(rows[:, 0, 0], -code) and torch.equal(rows[:, 0, 1], 3 * 16 - code)
    assert ivf_accum.BIAS_FILL == 2**30
    assert (rows[:, 0, 2:] == ivf_accum.BIAS_FILL).all()  # padded columns take the fill


def test_k9_rejects_bad_inputs():
    qb, vt, bf, bl, rv = (torch.from_numpy(x) for x in _clustered())
    with pytest.raises(ValueError):  # group not a multiple of depth
        ivf_accum.cluster_major_accum(qb, vt, bf, bl, rv, K, blk=BLK, group=8, depth=3)
    with pytest.raises(ValueError):  # nblocks not a multiple of group
        ivf_accum.cluster_major_accum(qb, vt, bf, bl, rv, K, blk=BLK, group=16, depth=8)
    with pytest.raises(ValueError):  # blk not a multiple of 128
        ivf_accum.cluster_major_accum(qb[..., :8], vt[:, :8, :200], bf, bl, rv, K, blk=200)
    with pytest.raises(ValueError):  # mixed dtypes
        ivf_accum.cluster_major_accum(qb.float(), vt, bf, bl, rv, K, blk=BLK)
    with pytest.raises(ValueError):  # bias rows on the float path
        ivf_accum.cluster_major_accum(qb.float(), vt.float(), bf, bl, rv, K, blk=BLK,
                                      bias_rows=torch.zeros((8, 1, BLK), dtype=torch.int32))
