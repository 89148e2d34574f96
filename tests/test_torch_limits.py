"""The port's selection past its CUDA kernels' old limits, on the CPU: K2's
segment-and-merge for rows wider than a warp's shared memory holds, K3's
fp32 split-and-merge, the passes of 32 that K3's int8 and bf16 modes, K4,
K6, K7 and K10 run for k > 32 and the passes of 256 of K3's fp32 mode.
Each is a plain function that takes the per-part selection as an
argument, so the code the card runs around its kernels runs here with the
plain versions, against the JAX kernels in interpret mode.  The kernels
themselves are held to these on the card by ``tests/test_torch_cuda.py``.
Beside them, the public call the card used to refuse: an int8 L2 IVF index
at D 3072; the row pitch the float modes of K4, K6, K7 and K10 read their
routed rows at (``_build.pitched_storage``, ``ivf_scan.float_operands``)
and the routed tables written at it (``ivf_scan.routed_table``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.harness import kernel_lab as jax_lab
from rag_on_edge_tpu.models import ivf as jax_ivf
from rag_on_edge_tpu.ops import pallas_ivf
from rag_on_edge_tpu.ops.pallas_bruteforce import fused_topk_matmul as jax_fused_topk_matmul
from rag_on_edge_tpu.ops.pallas_topk import fused_topk as jax_fused_topk
from rag_on_edge_tpu.utils.datasets import make_synthetic
from rag_on_edge_tpu_torch.harness import kernel_lab
from rag_on_edge_tpu_torch.models import ivf as port_ivf
from rag_on_edge_tpu_torch.ops import (_build, block_tables, bruteforce_fused, fused_topk,
                                       ivf_scan, topk)


def _wide_rows(dtype, w=20480):
    """Values 0..4 (ties across every segment edge), a row of fill values
    but two, and (float) a row of -0.0 / +0.0 ties."""
    rng = np.random.default_rng(60)
    x = rng.integers(0, 5, (5, w)).astype(np.int32)
    fill = np.iinfo(np.int32).min
    if dtype == "float32":
        x = x.astype(np.float32)
        fill = -np.inf
        x[4] = 0.0
        x[4, 1::3] = -0.0
    x[1] = fill
    x[1, [300, 17000]] = 3
    return x


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("k", [1, 20, 40])
def test_k2_segmented_topk_equals_jax(dtype, k):
    """W = 20,480: two segments of the kernel's 16,384 (and twenty of 1,024,
    whose winners take a second segmented merge), each segment's top-k by
    the plain K2, against the JAX kernel over the whole row."""
    x = _wide_rows(dtype)
    jv, ji = (np.asarray(a) for a in jax_fused_topk(jnp.asarray(x), k, interpret=True))
    for seg in (16384, 1024):
        v, i = fused_topk.segmented_topk(torch.from_numpy(x), k,
                                         fused_topk.fused_topk_reference, seg=seg)
        np.testing.assert_array_equal(v.numpy().view(np.int32), jv.view(np.int32))
        np.testing.assert_array_equal(i.numpy(), ji)


# (split_cols, nbins, tile_n, k, n_valid): splits of one and two 128-column
# chunks, binned splits of one and two 512-column tiles.
K3_SPLITS = {
    "exact-256": (256, 0, None, 10, None),
    "exact-128-nvalid": (128, 0, None, 40, 1000),
    "bin-512": (512, 128, 512, 10, None),
    "bin-1024-nvalid": (1024, 128, 512, 33, 1300),
}


@pytest.mark.parametrize("case", list(K3_SPLITS))
def test_k3_split_topk_equals_jax(case):
    """The fp32 kernel's column splits, each split's top-k by the plain K3
    and the splits joined by the plain K2, against the JAX kernel: values
    in -3..3 at D = 37 tie across every split edge."""
    split_cols, nbins, tile_n, k, n_valid = K3_SPLITS[case]
    rng = np.random.default_rng(61)
    q = rng.integers(-3, 4, (20, 37)).astype(np.float32)
    bt = rng.integers(-3, 4, (37, 1536)).astype(np.float32)
    nv = None if n_valid is None else torch.tensor([n_valid], dtype=torch.int32)
    v, i = bruteforce_fused.split_topk_reference(torch.from_numpy(q), torch.from_numpy(bt), k,
                                                 split_cols, tile_n=tile_n, nbins=nbins,
                                                 n_valid=nv)
    jkw = {} if n_valid is None else {"n_valid": jnp.asarray([n_valid], dtype=jnp.int32)}
    jv, ji = (np.asarray(a) for a in jax_fused_topk_matmul(
        jnp.asarray(q), jnp.asarray(bt), k, tile_n=tile_n or 512, nbins=nbins, interpret=True,
        **jkw))
    np.testing.assert_array_equal(v.numpy(), jv)
    fin = jv > -np.inf
    np.testing.assert_array_equal(i.numpy()[fin], ji[fin])


def test_split_plan_fills_the_card_and_keeps_tiles():
    """B = 1024 over 1M columns on 132 SMs: one wave of 8 row tiles x 16
    splits; a binned plan's splits are whole tiles; a short base one split."""
    cols, nsplit = bruteforce_fused.split_plan(1024, 1_000_000, 512, 0, 132)
    assert cols % 128 == 0 and nsplit == 16 and nsplit * cols >= 1_000_000
    cols, nsplit = bruteforce_fused.split_plan(1024, 1_000_000, 3584, 128, 132)
    assert cols % 3584 == 0 and nsplit > 1
    assert bruteforce_fused.split_plan(40, 2048, 512, 0, 132) == (2048, 1)


def _bounded_topk(scores, ids, fill):
    """The kernels' bounded selection in plain form: the best kp entries of
    each row ranked after the row's bound (by score desc, id asc)."""
    def run(kp, bound_v, bound_i):
        s = scores
        if bound_v is not None:
            after = (s < bound_v[:, None]) | ((s == bound_v[:, None]) & (ids > bound_i[:, None]))
            s = torch.where(after, s, torch.full_like(s, fill))
        return topk.extract_topk_ids(s, ids, kp, fill)
    return run


@pytest.mark.parametrize("k", [33, 64, 100, 256])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_passes_equal_one_selection(k, dtype):
    """k > 32 in passes of 32, each bounded by the last entry of the one
    before, on a tie-heavy matrix with shuffled ids and rows that run out of
    entries: the same list as one selection of k, ties to the lowest id."""
    rng = np.random.default_rng(62)
    scores = torch.from_numpy(rng.integers(0, 6, (7, 400))).to(dtype)
    fill = topk.fill_value(dtype)
    scores[2, 50:] = fill
    scores[5] = fill
    ids = torch.from_numpy(np.stack([rng.permutation(400) for _ in range(7)]).astype(np.int32))
    v, i = _build.by_passes(k, _bounded_topk(scores, ids, fill))
    rv, ri = topk.extract_topk_ids(scores, ids, k, fill)
    assert torch.equal(v, rv)
    fin = rv > fill
    assert torch.equal(i[fin], ri[fin])


@pytest.mark.parametrize("k", [257, 300, 600])
def test_passes_of_256_equal_one_selection(k):
    """K3 fp32's width: passes of 256 (the last one short), each bounded by
    the last entry of the one before, on ties, shuffled ids and rows that
    run out: the same list as one selection of k."""
    rng = np.random.default_rng(63)
    scores = torch.from_numpy(rng.integers(0, 9, (5, 900)).astype(np.float32))
    scores[1, 280:] = float("-inf")
    ids = torch.from_numpy(np.stack([rng.permutation(900) for _ in range(5)]).astype(np.int32))
    v, i = _build.by_passes(k, _bounded_topk(scores, ids, float("-inf")), 256)
    rv, ri = topk.extract_topk_ids(scores, ids, k, float("-inf"))
    assert torch.equal(v, rv)
    fin = rv > float("-inf")
    assert torch.equal(i[fin], ri[fin])


def _lab_layout():
    """Three clusters over six 256-column blocks (two partly valid), qcap 8,
    D 16, values 0..2 (ties everywhere) → (qg, vt, [bc, bf, bl, rv])."""
    rng = np.random.default_rng(64)
    sizes = np.asarray([400, 700, 256])
    offs = np.concatenate([[0], np.cumsum(-(-sizes // 256) * 256)[:-1]])
    bc, bf, bl, rv, _ = block_tables.build_block_tables(offs, sizes, 256)
    qg = rng.integers(0, 3, (3, 8, 16), dtype=np.int8)
    vt = rng.integers(0, 3, (len(bc), 16, 256), dtype=np.int8)
    return qg, vt, [np.ascontiguousarray(x, np.int32) for x in (bc, bf, bl, rv)]


@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_k10_pass_split_at_k40_equals_jax(variant):
    """K10 at k = 40 as the card runs it: ``full`` and ``nogate`` in passes
    of 32, each pass the plain K10's candidates ranked after the row's
    bound; ``maxonly`` and ``fixedout`` in one launch of width k, the row
    max in every slot.  Against the JAX kernel in interpret mode, in the
    windows each variant defines."""
    k = 40
    qg, vt, tabs = _lab_layout()
    args = (torch.from_numpy(qg), torch.from_numpy(vt), *(torch.from_numpy(x) for x in tabs))
    win = {"fixedout": np.array([0]), "maxonly": np.unique(tabs[0])}.get(
        variant, np.unique(tabs[0][tabs[2] > 0]))
    if variant in ("full", "nogate"):
        # Every candidate a window holds, in the kernels' order (2 bins of
        # 128 per block, at most 3 blocks a cluster), taken in passes.
        allv, alli = kernel_lab._variant_scan(*args, 3 * 256, 256, 128, variant)
        allv, alli = allv[win].reshape(-1, 3 * 256), alli[win].reshape(-1, 3 * 256)
        v, i = _build.by_passes(k, _bounded_topk(allv, alli, float("-inf")), _build.PASS_K)
    else:
        v, i = kernel_lab._variant_scan(*args, k, 256, 128, variant)
        v, i = v[win].reshape(-1, k), i[win].reshape(-1, k)
    jv, ji = jax_lab._variant_scan(jnp.asarray(qg), jnp.asarray(vt),
                                   *(jnp.asarray(x) for x in tabs), k, 256, 128, variant)
    jv, ji = np.asarray(jv)[win].reshape(-1, k), np.asarray(ji)[win].reshape(-1, k)
    assert v.numpy().tobytes() == jv.tobytes()
    fin = jv > -np.inf
    assert fin.any()
    np.testing.assert_array_equal(i.numpy()[fin], ji[fin])


def test_int8_l2_ivf_at_d3072_equals_jax():
    """An int8 L2 IVF index at D 3072 (OpenAI text-embedding-3-large's
    width), past K1's key caps, so ``engine="auto"`` resolves to "pallas"
    (K4) in both packages: ``search_device`` with its defaults gives the
    JAX package's ids, scores and candidate counts."""
    base, queries = make_synthetic(n_base=512, n_queries=4, dim=3072, n_clusters=4, seed=9)
    j = jax_ivf.IVFIndex.build(base, nlist=4, metric="l2", dtype="int8", pad_block=128, seed=42)
    t = port_ivf.IVFIndex.from_arrays(j._centroids_np, j._vectors_np, j._offsets_np,
                                      j._reorder_np, metric="l2", dtype="int8", pad_block=128,
                                      config=j.config, device="cpu")
    assert j.dim > j._accum_dim_cap() and t.dim > t._accum_dim_cap()
    jv, jids, jc = j.search_device(jnp.asarray(queries), 10, 2)
    tv, tids, tc = t.search_device(torch.from_numpy(queries), 10, 2)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


FLOAT_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _jnp_of(x):
    """A port tensor as a JAX array (bf16 through its bits)."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.contiguous().view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(x.contiguous().numpy())


@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
def test_k7_float_reads_a_pitched_batch_equal_jax(small_data, dtype):
    """A float batch [B, D' = 129] (small_data with L2's ones column) as a
    view of a zero-padded buffer: rows a 16-byte multiple apart (132 fp32,
    136 bf16), which ``float_operands`` hands K7 in place, pad and all
    (here filled with 7s: the kernels read only D' of a row).  The plain K7
    on the view equals the JAX kernel on the batch."""
    _, queries = small_data
    dt = FLOAT_DTYPES[dtype]
    qi = torch.cat([torch.from_numpy(queries), torch.ones((len(queries), 1))], 1).to(dt)
    view = _build.pad_rows(qi, 16 // qi.element_size())[:, :129]
    storage, ldq = _build.pitched_storage(view)
    assert ldq == {"fp32": 132, "bf16": 136}[dtype] and storage.data_ptr() == view.data_ptr()
    assert not storage[:, 129:].any() and torch.equal(view, qi)
    storage[:, 129:] = 7
    blk, nlist, qcap = 128, 6, 8
    sizes = np.array([200, 0, 300, 5, 128, 60])
    offs = np.concatenate([[0], np.cumsum(-(-sizes // blk) * blk)[:-1]])
    bc, bf, bl, rv, _ = block_tables.build_block_tables(offs, sizes, blk)
    rng = np.random.default_rng(70)
    vt = torch.from_numpy(rng.integers(-8, 9, (len(bc), 129, blk)).astype(np.float32)).to(dt)
    cq = np.full((nlist, qcap), -1, np.int32)
    for c in range(nlist):
        n = int(rng.integers(1, qcap))
        cq[c, :n] = rng.choice(len(queries), n, replace=False)
    cq[0, 0] = len(queries)  # past the batch: a zero row, as -1 gives
    cqb = torch.from_numpy(np.ascontiguousarray(cq[bc][..., None]))
    qs, vs, ldq2, bf16 = ivf_scan.float_operands("K7", view, vt)
    assert (qs.data_ptr(), ldq2, bf16) == (view.data_ptr(), ldq, int(dtype == "bf16"))
    tabs = tuple(torch.from_numpy(x.astype(np.int32)) for x in (bf, bl, rv))
    kw = dict(k=6, blk=blk, group=1, bin_depth=2)
    tv, ti = ivf_scan.cluster_major_scan_routed(view, cqb, vt, *tabs, **kw)
    jv, ji = pallas_ivf.cluster_major_scan_routed(
        _jnp_of(qi), jnp.asarray(cqb.numpy()), _jnp_of(vt),
        *(jnp.asarray(x.numpy()) for x in tabs), **kw)
    rows = np.nonzero(bl)[0]
    jv, ji = np.asarray(jv)[rows], np.asarray(ji)[rows]
    assert tv.numpy()[rows].tobytes() == jv.tobytes()
    fin = jv > -np.inf
    assert fin.any()
    np.testing.assert_array_equal(ti.numpy()[rows][fin], ji[fin])


def test_float_operands_check_what_the_kernels_take():
    """K6's and K7's float wrappers before a launch (plain functions, so
    they run here): one dtype, fp32 and bf16 at any blk (past 32768 too,
    where fp32 once kept a chunk in a byte); rows that do not lie at a
    16-byte pitch, or lie at one past their storage's end, are copied once
    with a zero pad."""
    q = torch.zeros((5, 129))
    with pytest.raises(ValueError, match="one dtype"):
        ivf_scan.float_operands("K6", q, torch.zeros((2, 129, 128), dtype=torch.bfloat16))
    qs, _, ldq, bf16 = ivf_scan.float_operands("K7", q, torch.zeros((1, 129, 32896)))
    assert (ldq, bf16, tuple(qs.shape)) == (132, 0, (5, 132)) and not qs.any()
    qs, _, ldq, bf16 = ivf_scan.float_operands(
        "K7", q.bfloat16(), torch.zeros((1, 129, 32896), dtype=torch.bfloat16))
    assert (ldq, bf16, tuple(qs.shape)) == (136, 1, (5, 136)) and not qs.any()
    wide = torch.randn(6, 200)
    for x, in_place in ((wide[:, :129], True), (wide[1:, 3:132], False),
                        (torch.randn(4, 3, 128), True), (torch.randn(4, 3, 129), False)):
        s, p = _build.pitched_storage(x)
        assert (s.data_ptr() == x.data_ptr()) == in_place and s.is_contiguous()
        assert p % 4 == 0 and torch.equal(s[..., :x.shape[-1]], x)
        if not in_place:
            assert not s[..., x.shape[-1]:].any()
    last_row_past_end = torch.randn(3 * 132 - 3).as_strided((3, 129), (132, 1))
    s, p = _build.pitched_storage(last_row_past_end)
    assert s.data_ptr() != last_row_past_end.data_ptr() and p == 132


@pytest.mark.parametrize("dtype", ["int8", "fp32", "bf16"])
def test_routed_table_at_pitch_equals_contiguous(small_data, dtype):
    """The routed tables of an L2 index on small_data (D' = 129 with the
    ones column of the float modes): ``ivf_scan.routed_table`` writes a
    float table at the batch's 16-byte row pitch (132 fp32, 136 bf16, the
    pad zero), which K4's float wrapper reads in place, equal in value to
    the contiguous table K1 reads and to a plain gather of the batch; an
    int8 table is contiguous either way (its kernels read the pad), also
    at D 37.  The index hands K4 its recovery tables and the grouped
    engine's dense table at the pitch, K1 its dense table contiguous."""
    base, queries = small_data
    t = port_ivf.IVFIndex.build(base, nlist=16, metric="l2", dtype=dtype, pad_block=128,
                                max_iter=5, device="cpu")
    t._ensure_kernel_state()
    q = torch.from_numpy(queries)
    probes, cq, _, lossy, _ = t._route(q, 4, 4)
    assert lossy.any()
    qi = t._query_prep(q)[0]
    bc = t._arrays["block_cluster"]
    flat = t._scan_inputs(q, cq)[1]
    pitched = t._scan_inputs(q, cq, pitched=True)[1]
    rec = t._recover_tables(qi, probes, lossy, None, 9, 16)[0]
    cqn, qn = cq.numpy(), qi.float().numpy()
    want = np.where((cqn >= 0)[..., None], qn[np.clip(cqn, 0, None)], 0)[bc.numpy()]
    assert flat.is_contiguous() and torch.equal(flat, pitched)
    np.testing.assert_array_equal(flat.float().numpy(), want)
    d = qi.shape[-1]
    for table in (pitched, rec[0]):
        storage, ldq = _build.pitched_storage(table)
        assert storage.data_ptr() == table.data_ptr() and table.shape[-1] == d
        if dtype == "int8":
            assert table.is_contiguous() and ldq == d == 128
        else:
            assert ldq == {"fp32": 132, "bf16": 136}[dtype] and not storage[..., d:].any()
            qs = ivf_scan.float_operands("K4", table, t._arrays["vectors_t"])[0]
            assert qs.data_ptr() == table.data_ptr()
    narrow = torch.from_numpy(np.random.default_rng(71).integers(-127, 128, (32, 37),
                                                                 dtype=np.int8))
    for pitch in (True, False):
        assert ivf_scan.routed_table(narrow, cq, bc, pitched=pitch).is_contiguous()
