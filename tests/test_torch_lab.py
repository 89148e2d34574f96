"""Parity of the port's kernel lab (kernel K10, ``_variant_scan``) with the
JAX package's, on the CPU.

A toy cluster-major layout (3 clusters in 6 blocks of 256 columns, with
partly valid blocks, qcap 8, d 16, k 4, 128 bins) goes through the JAX
kernel (interpreted) and the port's plain version in each variant.  The
inputs are integers, so every score is exact: values are compared bit for
bit, ids where the value is finite (the ``-inf`` fill's ids are not
defined), and only in the windows each variant defines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.harness import kernel_lab as jlab
from rag_on_edge_tpu_torch.harness import kernel_lab as tlab
from rag_on_edge_tpu_torch.ops import block_tables, ivf_scan

BLK, QCAP, D, K, NBINS = 256, 8, 16, 4, 128
SIZES = [400, 700, 256]  # blocks 0-1, 2-4, 5; blocks 1 and 4 partly valid


def _layout(dtype):
    rng = np.random.default_rng(31)
    sizes = np.asarray(SIZES)
    offs = np.concatenate([[0], np.cumsum(-(-sizes // BLK) * BLK)[:-1]])
    bc, bf, bl, rv, _ = block_tables.build_block_tables(offs, sizes, BLK)
    nb = len(bc)
    if dtype == "int8":
        qg = rng.integers(-127, 128, (len(SIZES), QCAP, D), dtype=np.int8)
        vt = rng.integers(-127, 128, (nb, D, BLK), dtype=np.int8)
    else:
        qg = rng.integers(-50, 51, (len(SIZES), QCAP, D)).astype(np.float32)
        vt = rng.integers(-50, 51, (nb, D, BLK)).astype(np.float32)
    tabs = [np.ascontiguousarray(x, np.int32) for x in (bc, bf, bl, rv)]
    return qg, vt, tabs


RUNS = [("int8", v) for v in tlab.VARIANTS] + [("fp32", "full")]


@pytest.fixture(scope="module")
def jax_out():
    """The JAX kernel's outputs per (dtype, variant), compiled once each."""
    out = {}
    for dtype, variant in RUNS:
        qg, vt, tabs = _layout(dtype)
        v, i = jlab._variant_scan(jnp.asarray(qg), jnp.asarray(vt),
                                  *(jnp.asarray(x) for x in tabs), K, BLK, NBINS, variant)
        out[dtype, variant] = (np.asarray(v), np.asarray(i))
    return out


def _defined_windows(variant, tabs):
    bc, _, bl, _ = tabs
    if variant == "fixedout":
        return np.array([0])
    if variant == "maxonly":
        return np.unique(bc)
    return np.unique(bc[bl > 0])


@pytest.mark.parametrize("dtype,variant", RUNS)
def test_k10_plain_equals_jax(jax_out, dtype, variant):
    qg, vt, tabs = _layout(dtype)
    tv, ti = tlab._variant_scan(torch.from_numpy(qg), torch.from_numpy(vt),
                                *(torch.from_numpy(x) for x in tabs), K, BLK, NBINS, variant)
    jv, ji = jax_out[dtype, variant]
    win = _defined_windows(variant, tabs)
    assert len(win) == (1 if variant == "fixedout" else 3)
    tv, ti, jv, ji = tv.numpy()[win], ti.numpy()[win], jv[win], ji[win]
    assert tv.tobytes() == jv.tobytes()
    fin = jv > -np.inf
    assert fin.any()
    np.testing.assert_array_equal(ti[fin], ji[fin])
    if variant in ("maxonly", "fixedout"):
        assert (ti == 0).all()
        assert (tv == tv[..., :1]).all()  # the row max over every slot


def test_k10_full_equals_k6_plain():
    """``full`` is K6 at bin depth 2 with no bias, in the same windows."""
    qg, vt, tabs = _layout("int8")
    args = (torch.from_numpy(qg), torch.from_numpy(vt), *(torch.from_numpy(x) for x in tabs))
    fv, fi = tlab._variant_scan(*args, K, BLK, NBINS, "full")
    kv, ki = ivf_scan.cluster_major_scan(*args, K, blk=BLK, nbins=NBINS, bin_depth=2)
    win = _defined_windows("full", tabs)
    assert torch.equal(fv[win], kv[win]) and torch.equal(fi[win], ki[win])


def test_k10_checks():
    qg, vt, tabs = _layout("int8")
    args = (torch.from_numpy(qg), torch.from_numpy(vt), *(torch.from_numpy(x) for x in tabs))
    with pytest.raises(ValueError, match="variant"):
        tlab._variant_scan(*args, K, BLK, NBINS, "bogus")
    with pytest.raises(ValueError, match="multiple of nbins"):
        tlab._variant_scan(*args, K, BLK, 96, "full")


@pytest.mark.parametrize("variant", tlab.VARIANTS)
def test_k10_int8_plain_at_d1152_equals_jax(variant):
    """K10's int8 mode past the D 1024 the card used to refuse: the plain
    version at D 1152 (nine 128-byte units of d) on a tiny walk (two
    clusters over three blocks, one partly valid) equals the JAX kernel in
    interpret mode on each variant's windows."""
    rng = np.random.default_rng(32)
    sizes = np.asarray([300, 200])
    offs = np.concatenate([[0], np.cumsum(-(-sizes // BLK) * BLK)[:-1]])
    bc, bf, bl, rv, _ = block_tables.build_block_tables(offs, sizes, BLK)
    tabs = [np.ascontiguousarray(x, np.int32) for x in (bc, bf, bl, rv)]
    qg = rng.integers(-127, 128, (len(sizes), QCAP, 1152), dtype=np.int8)
    qg[1, 5:] = 0  # empty slots
    vt = rng.integers(-127, 128, (len(bc), 1152, BLK), dtype=np.int8)
    tv, ti = tlab._variant_scan(torch.from_numpy(qg), torch.from_numpy(vt),
                                *(torch.from_numpy(x) for x in tabs), K, BLK, NBINS, variant)
    jv, ji = jlab._variant_scan(jnp.asarray(qg), jnp.asarray(vt), *(jnp.asarray(x) for x in tabs),
                                K, BLK, NBINS, variant)
    win = _defined_windows(variant, tabs)
    jv, ji = np.asarray(jv)[win], np.asarray(ji)[win]
    assert tv.numpy()[win].tobytes() == jv.tobytes()
    fin = jv > -np.inf
    assert fin.any()
    np.testing.assert_array_equal(ti.numpy()[win][fin], ji[fin])


@pytest.mark.parametrize("sizes,blk", [([300, 0, 700, 129, 10], 256), ([2048, 1, 0], 2048)])
def test_live_products_over_jax_block_tables(sizes, blk):
    """What the bounds of K4, K6, K7 and K10 charge for the product
    (``timing.live_products``): each walked block's live routed rows times
    its valid columns, over the JAX package's block tables; a compacted
    list (the first cluster's blocks) charges those alone.  ``live_rows``
    counts the rows with a nonzero element."""
    from rag_on_edge_tpu.ops.pallas_ivf import build_block_tables as jax_tables
    from rag_on_edge_tpu_torch.harness import timing

    sizes = np.asarray(sizes)
    offs = np.concatenate([[0], np.cumsum(-(-sizes // blk) * blk)[:-1]])
    bc, bf, bl, rv, _ = (np.asarray(x, np.int32) for x in jax_tables(offs, sizes, blk))
    table = np.zeros((len(sizes), 6, 5), np.float32)
    for c, n in enumerate([3, 0, 6, 1, 2][:len(sizes)]):
        table[c, :n, c % 5] = -1.5
    live = timing.live_rows(torch.from_numpy(table))
    assert live.tolist() == [3, 0, 6, 1, 2][:len(sizes)]
    per_block = live[torch.from_numpy(bc).long()]
    want = sum(int(live[c]) * int(sizes[c]) for c in range(len(sizes)))
    assert timing.live_products(per_block, *(torch.from_numpy(x) for x in (bf, bl, rv))) == want
    first = -(-int(sizes[0]) // blk)
    assert timing.live_products(per_block[:first], bf[:first], bl[:first], rv[:first]) == \
        int(live[0]) * int(sizes[0])


@pytest.mark.parametrize("sizes,blk", [([300, 0, 700, 129, 10], 256), ([2048, 1, 0], 2048)])
def test_walked_blocks_and_bound_over_jax_block_tables(sizes, blk):
    """What the timing harnesses charge a cluster-major walk
    (``timing.walked_blocks``) over the JAX package's block tables: every
    block that holds rows, and the clusters' sizes summed; a compacted list
    (the first cluster's blocks only, as a recovery pass walks) charges
    those blocks alone.  ``timing.bound_ms`` is the larger of the bytes and
    the operations time."""
    from rag_on_edge_tpu.ops.pallas_ivf import build_block_tables as jax_tables
    from rag_on_edge_tpu_torch.harness import timing

    sizes = np.asarray(sizes)
    offs = np.concatenate([[0], np.cumsum(-(-sizes // blk) * blk)[:-1]])
    bc, bf, bl, rv, _ = (torch.from_numpy(np.asarray(x, np.int32))
                         for x in jax_tables(offs, sizes, blk))
    nb = -(-sizes // blk)
    assert timing.walked_blocks(bf, bl, rv) == (int(nb.sum()), int(sizes.sum()))
    first = int(nb[0])
    assert timing.walked_blocks(bf[:first], bl[:first], rv[:first]) == (first, int(sizes[0]))
    assert timing.bound_ms(3.35e9, 0, 1.0) == (1.0, "bytes")
    assert timing.bound_ms(1.0, 2 * timing.OPS32_S, timing.OPS32_S) == (2000.0, "operations")
