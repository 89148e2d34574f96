"""Parity of the float modes (fp32, bf16) of kernels K6, K7, K9 and K10 with
the JAX package, on the CPU, and of the sharded index that reaches K6 with
a float index.

The JAX Pallas kernels run in interpret mode, as the JAX suite runs them;
the port's CPU tensors take the kernels' plain versions.  Inputs are made
with numpy from seeds and are integer-valued: bf16 holds them exactly
(the augmented column -‖b‖²/2 is rounded to bf16 once, in torch, and both
packages get the same bits), and every fp32 sum is exact, so every
comparison is exact.  Shapes are toy ones (blk 256, two blocks per grid
step) so that the interpreted kernels compile quickly.  The CUDA kernels
are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.harness import kernel_lab as jlab
from rag_on_edge_tpu.models import ivf as jivf
from rag_on_edge_tpu.ops import pallas_ivf, pallas_ivf_dma
from rag_on_edge_tpu.parallel import ShardedIVFIndex as JIVF
from rag_on_edge_tpu.parallel import make_mesh as jax_mesh
from rag_on_edge_tpu_torch.harness import kernel_lab as tlab
from rag_on_edge_tpu_torch.models import ivf as tivf
from rag_on_edge_tpu_torch.ops import block_tables, ivf_accum, ivf_scan
from rag_on_edge_tpu_torch.parallel import ShardedIVFIndex

BLK, D, K = 256, 48, 6
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# Clusters of 2, 0, 3, 1 and 1 blocks of 256; the last is too small to fill k.
SIZES = [300, 0, 700, 129, 3]


def _tables(sizes=SIZES):
    """Block tables padded to 8 blocks with dummies on the last cluster →
    (bc, bf, bl, rv) int32."""
    sizes = np.asarray(sizes)
    offs = np.concatenate([[0], np.cumsum(-(-sizes // BLK) * BLK)[:-1]])
    bc, bf, bl, rv, _ = block_tables.build_block_tables(offs, sizes, BLK)
    pad = (-len(bc)) % 8
    bc = np.pad(bc, (0, pad), constant_values=len(sizes) - 1).astype(np.int32)
    bf, bl, rv = (np.pad(x, (0, pad)).astype(np.int32) for x in (bf, bl, rv))
    return bc, bf, bl, rv


def _float(x, dtype):
    """A float32 numpy array as a port tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(DTYPES[dtype])


def _jnp(x):
    """A port tensor (or numpy array) as a JAX array, bf16 through its bits."""
    if isinstance(x, np.ndarray):
        return jnp.asarray(x)
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _aug_slabs(rng, nb, dtype):
    """Slabs [nb, D+1, BLK] of an augmented L2 index: integers in [-8, 8]
    and the column -‖b‖²/2, as ``dtype``."""
    v = rng.integers(-8, 9, (nb, D, BLK)).astype(np.float32)
    return _float(np.concatenate([v, -0.5 * np.sum(v * v, axis=1, keepdims=True)], 1), dtype)


def _aug_queries(rng, shape, dtype):
    """Queries [..., D+1]: integers in [-8, 8] and a ones column; every 5th
    row zero, as an empty slot of a routed table."""
    q = rng.integers(-8, 9, shape + (D,)).astype(np.float32)
    q = np.concatenate([q, np.ones(shape + (1,), np.float32)], -1)
    q.reshape(-1, D + 1)[::5] = 0
    return _float(q, dtype)


def _compact(active_clusters, bc, bf, bl, rv, *per_block):
    """The recovery pass's list: the blocks of ``active_clusters`` in
    storage order, then the others with zeroed tables (parked on the last
    listed block's cluster); row_base = block·blk."""
    active = np.isin(bc, active_clusters) & (rv > 0)
    blocks = np.concatenate([np.nonzero(active)[0], np.nonzero(~active)[0]])
    inc = active[blocks]
    n_inc = int(inc.sum())
    bc = np.where(inc, bc[blocks], bc[blocks][max(n_inc - 1, 0)]).astype(np.int32)
    bf, bl, rv = (np.where(inc, x[blocks], 0).astype(np.int32) for x in (bf, bl, rv))
    rb = (blocks * BLK).astype(np.int32)
    return (bc, bf, bl, rv, rb) + tuple(x[torch.from_numpy(blocks)] for x in per_block)


def _assert_rows_equal(tv, ti, jv, ji, rows):
    """Values bit-equal on the emitted rows, ids where the value is finite."""
    tv, ti = tv.numpy()[rows], ti.numpy()[rows]
    jv, ji = np.asarray(jv)[rows], np.asarray(ji)[rows]
    assert tv.tobytes() == jv.tobytes()
    fin = jv > -np.inf
    assert fin.any() and not fin.all()  # empty slots and the 3-row cluster end in -inf
    np.testing.assert_array_equal(ti[fin], ji[fin])


# --------------------------------------------------------------------- K6


@pytest.mark.parametrize("walk", ["dense", "compact"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k6_float_plain_equals_jax(dtype, walk):
    """K6 over a shard-like dense walk and over a recovery list."""
    rng = np.random.default_rng(60)
    bc, bf, bl, rv = _tables()
    nlist, qcap = len(SIZES), 12
    qg = _aug_queries(rng, (nlist, qcap), dtype)
    vt = _aug_slabs(rng, len(bc), dtype)
    rb = np.arange(len(bc), dtype=np.int32) * BLK
    if walk == "compact":
        bc, bf, bl, rv, rb, vt = _compact([2, 4], bc, bf, bl, rv, vt)
    kw = dict(k=K, blk=BLK, bin_depth=2 if walk == "dense" else 3)
    jv, ji = pallas_ivf.cluster_major_scan(
        _jnp(qg), _jnp(vt), *map(jnp.asarray, (bc, bf, bl, rv)), row_base=jnp.asarray(rb), **kw)
    tv, ti = ivf_scan.cluster_major_scan(
        qg, vt, *map(torch.from_numpy, (bc, bf, bl, rv)), row_base=torch.from_numpy(rb), **kw)
    _assert_rows_equal(tv, ti, jv, ji, bc[np.nonzero(bl)[0]])


# --------------------------------------------------------------------- K7


@pytest.mark.parametrize("walk", ["dense", "compact"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k7_float_plain_equals_jax(dtype, walk):
    """K7 with the routed rows gathered from the whole batch (the JAX
    kernel's one-hot product at HIGHEST precision); one slot points past
    the batch and gives a zero row, as -1 does."""
    rng = np.random.default_rng(61)
    bc, bf, bl, rv = _tables()
    nlist, qcap, nbatch = len(SIZES), 12, 40
    qi = _aug_queries(rng, (nbatch,), dtype)
    vt = _aug_slabs(rng, len(bc), dtype)
    cq = np.full((nlist, qcap), -1, np.int32)
    for c in range(nlist):
        n = int(rng.integers(3, qcap))
        cq[c, :n] = rng.choice(nbatch, n, replace=False)
    cq[0, 0] = nbatch
    cqb = torch.from_numpy(np.ascontiguousarray(cq[bc][..., None]))
    rb = np.arange(len(bc), dtype=np.int32) * BLK
    if walk == "compact":
        bc, bf, bl, rv, rb, vt, cqb = _compact([2, 4], bc, bf, bl, rv, vt, cqb)
    kw = dict(k=K, blk=BLK, group=2, bin_depth=2 if walk == "dense" else 4)
    jv, ji = pallas_ivf.cluster_major_scan_routed(
        _jnp(qi), _jnp(cqb), _jnp(vt), *map(jnp.asarray, (bf, bl, rv)),
        row_base=jnp.asarray(rb), **kw)
    tv, ti = ivf_scan.cluster_major_scan_routed(
        qi, cqb, vt, *map(torch.from_numpy, (bf, bl, rv)), row_base=torch.from_numpy(rb), **kw)
    _assert_rows_equal(tv, ti, jv, ji, np.nonzero(bl)[0])


# --------------------------------------------------------------------- K9


@pytest.mark.parametrize("bin2", [True, False], ids=["bin2", "bin1"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k9_float_plain_equals_jax(dtype, bin2):
    """K9's float emit: ``pv`` is the masked key turned back into fp32,
    ``(monotone(score) & ~15) | code``, not the exact score: the block
    code in the 4 low key bits moves it off the score.  Both packages give
    the same bits."""
    rng = np.random.default_rng(62)
    bc, bf, bl, rv = _tables()
    qcap = 10
    qg = rng.integers(-127, 128, (len(bc), qcap, D)).astype(np.float32)
    qg[:, ::4] = 0
    vt = rng.integers(-127, 128, (len(bc), D, BLK)).astype(np.float32)
    qg, vt = _float(qg, dtype), _float(vt, dtype)
    kw = dict(k=K, blk=BLK, group=2, depth=2, bin2=bin2)
    jv, ji = pallas_ivf_dma.cluster_major_accum(
        _jnp(qg), _jnp(vt), *map(jnp.asarray, (bf, bl, rv)), **kw)
    tv, ti = ivf_accum.cluster_major_accum(qg, vt, *map(torch.from_numpy, (bf, bl, rv)), **kw)
    rows = np.nonzero(bl)[0]
    assert tv.numpy()[rows].tobytes() == np.asarray(jv)[rows].tobytes()
    np.testing.assert_array_equal(ti.numpy()[rows], np.asarray(ji)[rows])
    # The trap: the low 4 key bits of a finite pv are its block's code.
    tv, ti = tv[rows], ti[rows]
    fin = tv > float("-inf")
    assert fin.any() and not fin.all()  # zero rows still score; the 3-row cluster fills
    code = 15 - (ti // BLK) % 16
    assert torch.equal(ivf_accum._monotone_key(tv)[fin] & 15, code[fin])
    # ... and so pv is not the exact score wherever mask and code moved it.
    r = torch.from_numpy(rows)
    exact = torch.bmm(qg.float()[r], vt.float()[r])  # each row's own block only
    own = (ti // BLK) == r[:, None, None]
    got = torch.gather(exact.reshape(len(rows), qcap, -1), 2, (ti % BLK).long())
    assert (fin & own).any() and (tv[fin & own] != got[fin & own]).any()


def test_k9_float_refuses_bias_rows():
    """The JAX function refuses bias rows on float slabs; so does the port."""
    bc, bf, bl, rv = (torch.from_numpy(x) for x in _tables())
    qg = torch.zeros((len(bc), 4, D))
    vt = torch.zeros((len(bc), D, BLK))
    rows = torch.zeros((len(bc), 1, BLK), dtype=torch.int32)
    with pytest.raises(ValueError, match="bias_rows"):
        ivf_accum.cluster_major_accum(qg, vt, bf, bl, rv, K, blk=BLK, group=2, depth=2,
                                      bias_rows=rows)
    with pytest.raises(ValueError, match="bias_rows"):
        pallas_ivf_dma.cluster_major_accum(*map(_jnp, (qg, vt, bf, bl, rv)), K, blk=BLK,
                                           group=2, depth=2, bias_rows=_jnp(rows))


# --------------------------------------------------------------------- K10


@pytest.mark.parametrize("variant", tlab.VARIANTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k10_float_plain_equals_jax(dtype, variant):
    """The lab's four variants on float tables, in the windows each
    variant defines (fixedout: window 0, the walk's last block)."""
    rng = np.random.default_rng(63)
    bc, bf, bl, rv = _tables([400, 700, 256])
    qg = _aug_queries(rng, (3, 8), dtype)
    vt = _aug_slabs(rng, len(bc), dtype)
    # The walk cut after its last block with rows (the dummies hold none).
    cut = int(np.nonzero(rv)[0].max()) + 1
    tabs = [x[:cut] for x in (bc, bf, bl, rv)]
    vt = vt[:cut]
    jv, ji = jlab._variant_scan(_jnp(qg), _jnp(vt), *map(jnp.asarray, tabs), K, BLK, 128,
                                variant)
    tv, ti = tlab._variant_scan(qg, vt, *map(torch.from_numpy, tabs), K, BLK, 128, variant)
    if variant == "fixedout":
        win = np.array([0])
    elif variant == "maxonly":
        win = np.unique(tabs[0])
    else:
        win = np.unique(tabs[0][tabs[2] > 0])
    jv, ji = np.asarray(jv)[win], np.asarray(ji)[win]
    tv, ti = tv.numpy()[win], ti.numpy()[win]
    assert tv.tobytes() == jv.tobytes()
    fin = jv > -np.inf
    assert fin.any()
    np.testing.assert_array_equal(ti[fin], ji[fin])


# --------------------------------------------------------- the sharded index


@pytest.fixture(scope="module")
def float_shards(small_data):
    """dtype → (JAX sharded index, port sharded index) over 8 shards of one
    fp32 or bf16 L2 index (nlist=16, pad_block=128), made on first use."""
    base, _ = small_data
    src = jivf.IVFIndex.build(base, nlist=16, metric="l2", pad_block=128, seed=42)
    mesh = jax_mesh(8)
    made = {}

    def get(dtype):
        if dtype not in made:
            j = jivf.IVFIndex(src._centroids_np, src._vectors_np, src._offsets_np,
                              src._reorder_np, metric="l2", dtype=dtype, pad_block=128,
                              config=dict(src.config))
            t = tivf.IVFIndex.from_arrays(src._centroids_np, src._vectors_np, src._offsets_np,
                                          src._reorder_np, metric="l2", dtype=dtype,
                                          pad_block=128, config=dict(src.config), device="cpu")
            made[dtype] = (JIVF(j, mesh), ShardedIVFIndex(t, [torch.device("cpu")] * 8))
        return made[dtype]

    return get


# qcap=4 drops pairs; two recovery passes of 16 over every shard block place
# them through K6 (the default engine: K1 in the main walk).
SHARDED_RUNS = {"recover": dict(qcap=4, recover=True, recover_qcap=16, recover_blocks=8,
                                recover_passes=2),
                "pallas": dict(engine="pallas")}


@pytest.mark.parametrize("run", list(SHARDED_RUNS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sharded_float_cluster_equal_jax(float_shards, small_data, dtype, run):
    """``ShardedIVFIndex.search_device(mode="cluster")`` on a float index:
    K6 in the recovery pass, or over every shard's walk: ids, scores,
    candidate counts, engine and residual spill equal to JAX's."""
    js, ts = float_shards(dtype)
    q = small_data[1]
    kw = SHARDED_RUNS[run]
    jv, ji, jc = js.search_device(jnp.asarray(q), 10, 4, mode="cluster", **kw)
    before = ivf_scan.CLUSTER_LAUNCHES
    tv, ti, tc = ts.search_device(torch.from_numpy(np.ascontiguousarray(q)), 10, 4,
                                  mode="cluster", **kw)
    assert ivf_scan.CLUSTER_LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ts.last_engine == js.last_engine == ("pallas_accum" if run == "recover" else "pallas")
    assert int(ts.last_spill) == int(js.last_spill) == 0
    assert ts._cm_arrays[0]["vectors_t"].dtype == DTYPES[dtype]
    if run == "recover":
        ts.search_device(torch.from_numpy(np.ascontiguousarray(q)), 10, 4, mode="cluster",
                         qcap=4, recover=False)
        assert int(ts.last_spill) > 0  # the pairs the recovery pass placed
