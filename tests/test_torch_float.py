"""Parity of the port's float modes (fp32 and bf16) with the JAX package, on
the CPU: the float index state, kernel K1's planes, kernel K4 on the
recovery pass's inputs, and the IVF slice end to end.

One JAX index over the shared ``small_data`` corpus (nlist=16, the default
dtype "fp32") gives the arrays; the other (dtype, metric, pad_block)
indexes of both packages are built from them.  The corpus is integer-valued
(SIFT-like, 0..141), so bf16 holds it exactly and every fp32 sum is an exact
integer: the comparisons are exact.  The JAX Pallas kernels run in interpret
mode, as the JAX suite runs them; the port's CPU tensors take the kernels'
plain versions.  The CUDA kernels are held against those plain versions on
the card by ``tests/test_torch_cuda.py``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.models import ivf as jivf
from rag_on_edge_tpu.ops import pallas_ivf, pallas_ivf_dma
from rag_on_edge_tpu_torch.models import ivf as tivf
from rag_on_edge_tpu_torch.ops import _build, ivf_accum, ivf_scan

K, NPROBE = 10, 4
DTYPES = ["fp32", "bf16"]
PAD_BLOCKS = [512, 128]
# Recovery forced: a routing capacity of 4 drops pairs, and three passes of
# capacity 9 over 16 blocks place them.
RECOVER = dict(qcap=4, recover=True, recover_qcap=9, recover_blocks=16, recover_passes=3)


@pytest.fixture(scope="session")
def float_src(small_data):
    base, _ = small_data
    return jivf.IVFIndex.build(base, nlist=16, metric="l2", pad_block=512, seed=42)


@pytest.fixture(scope="session")
def float_pairs(float_src):
    """{(dtype, metric, pad_block): (jax index, port index)} over the same
    arrays, built on first use."""
    cache = {}

    def get(dtype, metric, pb):
        key = (dtype, metric, pb)
        if key not in cache:
            s = float_src
            j = jivf.IVFIndex(s._centroids_np, s._vectors_np, s._offsets_np, s._reorder_np,
                              metric=metric, dtype=dtype, pad_block=pb, config=dict(s.config))
            j._ensure_kernel_state()
            t = tivf.IVFIndex.from_arrays(s._centroids_np, s._vectors_np, s._offsets_np,
                                          s._reorder_np, metric=metric, dtype=dtype,
                                          pad_block=pb, config=dict(s.config), device="cpu")
            t._ensure_kernel_state()
            cache[key] = (j, t)
        return cache[key]

    return get


def test_build_defaults_to_fp32(float_src):
    assert float_src.dtype == "fp32"
    assert inspect.signature(tivf.IVFIndex.build).parameters["dtype"].default == "fp32"


@pytest.mark.parametrize("pb", PAD_BLOCKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_float_kernel_state_bit_equal(float_pairs, dtype, pb):
    """The slabs [nblocks, D+1, blk] of an L2 index (the augmented column
    -‖b‖²/2, rounded to bf16 in the bf16 index) and the block tables."""
    j, t = float_pairs(dtype, "l2", pb)
    for name in ("vectors_t", "block_cluster", "block_first", "block_last", "rows_valid",
                 "last_block"):
        a, b = np.asarray(j._arrays[name]), t._arrays[name]
        if name == "vectors_t":
            assert b.dtype == {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
            assert b.shape[1:] == (t.dim + 1, pb)
            b = b.view(torch.int16) if dtype == "bf16" else b
            a = a.view(np.int16) if dtype == "bf16" else a
        b = b.numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name


def _routed(t, queries, qcap=None):
    """The port's routing of a batch → (q, qcap, probes, lossy, qi, qb)."""
    q = torch.from_numpy(np.ascontiguousarray(queries))
    qcap = qcap or t._auto_qcap(q.shape[0], NPROBE)
    probes, cq, slot, lossy, _ = t._route(q, NPROBE, qcap)
    qi, qb, bias, bias_rows, _ = t._scan_inputs(q, cq)
    assert bias is None and bias_rows is None  # float L2 rides the augmented column
    return q, qcap, probes, lossy, qi, qb


def _jnp(x):
    """A port tensor as a JAX array, bf16 through its bits."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("pb", PAD_BLOCKS)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_float_planes_bit_equal_on_real_index(float_pairs, small_data, dtype, metric, pb):
    _, t = float_pairs(dtype, metric, pb)
    qb = _routed(t, small_data[1])[5]
    assert qb.dtype == t._arrays["vectors_t"].dtype
    a = t._arrays
    tabs = (a["vectors_t"], a["block_first"], a["block_last"], a["rows_valid"])
    want = pallas_ivf_dma.cluster_major_accum_planes(
        _jnp(qb), *map(_jnp, tabs), blk=pb, group=8, depth=4 if dtype == "fp32" else 8)
    got = ivf_accum.cluster_major_accum_planes(qb, *tabs, blk=pb)
    rows = np.nonzero(a["block_last"].numpy())[0]
    np.testing.assert_array_equal(got.numpy()[rows], np.asarray(want)[rows])


@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_float_equal_jax_on_recovery_inputs(float_pairs, small_data, dtype):
    """K4 on the first recovery pass's own inputs (a routing capacity of 4
    drops pairs; the compacted block list with row_base = block·blk)."""
    _, t = float_pairs(dtype, "l2", 128)
    _, _, probes, lossy, qi, _ = _routed(t, small_data[1], qcap=4)
    assert lossy.any()
    scan, _, _, _ = t._recover_tables(qi, probes, lossy, None, 9, 16)
    qg, vt, bf, bl, rv, bias, rb = scan
    assert bias is None and qg.dtype == vt.dtype
    kw = dict(k=2 * K, blk=128, group=t.CM_GROUP)
    jv, ji = pallas_ivf.cluster_major_scan_grouped(*map(_jnp, (qg, vt, bf, bl, rv)),
                                                   row_base=_jnp(rb), **kw)
    tv, ti = ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, row_base=rb, **kw)
    rows = np.nonzero(bl.numpy())[0]
    jv, ji = np.asarray(jv)[rows], np.asarray(ji)[rows]
    tv, ti = tv.numpy()[rows], ti.numpy()[rows]
    np.testing.assert_array_equal(tv, jv)
    fin = jv > -np.inf
    assert fin.any()
    np.testing.assert_array_equal(ti[fin], ji[fin])


@pytest.mark.parametrize("pb,run", [(512, "recover"), (128, "recover"), (512, "grouped")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_float_slice_equal_jax(float_pairs, small_data, dtype, pb, run):
    """``search_device(q, 10, 4, mode="cluster")``: the default engine (K1,
    the planes join) with the recovery pass forced (K4), or the grouped
    engine (K4 over every block): ids, scores, candidate counts and the
    residual spill equal to the JAX package's."""
    j, t = float_pairs(dtype, "l2", pb)
    kw = RECOVER if run == "recover" else dict(engine="pallas")
    q = np.ascontiguousarray(small_data[1])
    jv, jids, jc = j.search_device(jnp.asarray(q), K, NPROBE, mode="cluster", **kw)
    tv, tids, tc = t.search_device(torch.from_numpy(q), K, NPROBE, mode="cluster", **kw)
    assert t.last_engine == j.last_engine == ("pallas_accum" if run == "recover" else "pallas")
    assert int(t.last_spill) == int(j.last_spill)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if run == "recover":
        assert int(t.last_spill) == 0
        t.search_device(torch.from_numpy(q), K, NPROBE, mode="cluster", qcap=4, recover=False)
        assert int(t.last_spill) > 0  # the pairs the recovery pass placed


@pytest.mark.parametrize("case", ["mixed", "wide"])
def test_check_float_refuses(case):
    """The rule the float modes of K1, K3, K4 and K5 apply on the card
    before a launch: operands in one dtype, D within the float stage."""
    x = torch.zeros((4, 16))
    if case == "mixed":
        with pytest.raises(ValueError, match="one dtype"):
            _build.check_float("K1", x, x.bfloat16(), 16)
    else:
        with pytest.raises(ValueError, match=f"D <= {_build.FLOAT_DIM_MAX}"):
            _build.check_float("K4", x, x, _build.FLOAT_DIM_MAX + 1)
    _build.check_float("K5", x.bfloat16(), x.bfloat16(), _build.FLOAT_DIM_MAX)
