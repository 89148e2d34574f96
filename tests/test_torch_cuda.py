"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``cuda`` marker and skips where torch sees no GPU.
This file imports neither jax nor the JAX package, so it runs on a machine
with a card and no JAX::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rag_on_edge_tpu_torch.harness import bench_gemm, hw_probe, kernel_lab
from rag_on_edge_tpu_torch.models.brute_force import BruteForceIndex
from rag_on_edge_tpu_torch.models.ivf import IVFIndex
from rag_on_edge_tpu_torch.ops import bruteforce_accum, bruteforce_fused
from rag_on_edge_tpu_torch.ops import block_tables, fused_topk, ivf_accum, ivf_scan
from rag_on_edge_tpu_torch.ops import tiled_matmul
from rag_on_edge_tpu_torch.parallel import ShardedBruteForceIndex, ShardedIVFIndex
from rag_on_edge_tpu_torch.parallel import make_mesh_2d, spatial_matmul
from rag_on_edge_tpu_torch.utils.datasets import make_synthetic

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


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


@pytest.mark.parametrize("sizes,blk,qcap,d", [
    ([2000, 0, 5000, 129], 2048, 40, 128),   # multi-block and empty clusters
    ([700, 300, 129, 2000], 256, 100, 37),   # ragged qcap tile, d % 4 != 0
])
@pytest.mark.parametrize("bias", [False, True], ids=["ip", "l2bias"])
@pytest.mark.parametrize("bin2", [True, False], ids=["bin2", "bin1"])
def test_k1_kernel_bit_equal_to_plain(dev, sizes, blk, qcap, d, bias, bin2):
    rng = np.random.default_rng(14)
    qg, vt, bf, bl, rv = (torch.from_numpy(x).to(dev)
                          for x in _k1_inputs(rng, sizes, blk, qcap, d))
    br = None
    if bias:
        br = torch.from_numpy(rng.integers(-2**29, 2**29, (vt.shape[0], 1, blk),
                                           dtype=np.int32)).to(dev)
    before = ivf_accum.LAUNCHES
    got = ivf_accum.cluster_major_accum_planes(qg, vt, bf, bl, rv, blk=blk, bin2=bin2,
                                               bias_rows=br)
    want = ivf_accum.cluster_major_accum_planes_reference(qg, vt, bf, bl, rv, blk=blk,
                                                          bin2=bin2, bias_rows=br)
    torch.cuda.synchronize()
    assert ivf_accum.LAUNCHES == before + 1
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(got[rows], want[rows])


FLOAT_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("sizes,blk,qcap,d", [
    ([2000, 0, 5000, 129], 2048, 40, 129),   # multi-block and empty clusters, D' odd
    ([700, 300, 129, 2000], 256, 100, 37),   # ragged qcap tile, d % 4 != 0
    ([700, 300], 256, 40, 320),              # the widest D the float stage holds
])
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("bin2", [True, False], ids=["bin2", "bin1"])
def test_k1_kernel_float_bit_equal_to_plain(dev, sizes, blk, qcap, d, dtype, bin2):
    """Integer values in [-127, 127]: bf16 holds them exactly and every fp32
    sum is exact, so the planes are bit-equal.  Every 7th routed row is
    zero, as an empty slot of the routed table: its scores are exact zeros."""
    rng = np.random.default_rng(16)
    qg, vt, bf, bl, rv = _k1_inputs(rng, sizes, blk, qcap, d)
    qg[:, ::7] = 0
    qg, vt = (torch.from_numpy(x).to(dev, FLOAT_DTYPES[dtype]) for x in (qg, vt))
    bf, bl, rv = (torch.from_numpy(x).to(dev) for x in (bf, bl, rv))
    before = ivf_accum.LAUNCHES
    got = ivf_accum.cluster_major_accum_planes(qg, vt, bf, bl, rv, blk=blk, bin2=bin2)
    want = ivf_accum.cluster_major_accum_planes_reference(qg, vt, bf, bl, rv, blk=blk,
                                                          bin2=bin2)
    torch.cuda.synchronize()
    assert ivf_accum.LAUNCHES == before + 1
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(got[rows], want[rows])


def test_k1_kernel_refuses_float(dev):
    """The float modes the CUDA K1 does not take: operands of two dtypes,
    and D past what its shared memory stages."""
    rng = np.random.default_rng(15)
    qg, vt, bf, bl, rv = (torch.from_numpy(x).to(dev)
                          for x in _k1_inputs(rng, [100], 128, 8, 16))
    with pytest.raises(ValueError, match="one dtype"):
        ivf_accum.cluster_major_accum_planes(qg.float(), vt.bfloat16(), bf, bl, rv, blk=128)
    wide = torch.zeros((qg.shape[0], 8, 330), device=dev)
    with pytest.raises(ValueError, match="D <= 320"):
        ivf_accum.cluster_major_accum_planes(wide, torch.zeros((qg.shape[0], 330, 128),
                                                               device=dev), bf, bl, rv, blk=128)


def _ties():
    x = np.random.default_rng(4).integers(0, 5, (40, 1024)).astype(np.int32)
    x[7] = np.iinfo(np.int32).min
    return x


def _neg_inf():
    x = np.random.default_rng(5).normal(size=(16, 256)).astype(np.float32)
    x[::4] = -np.inf
    x[1] = -np.inf
    x[1, 5] = x[1, 9] = 1.0
    return x


def _wide():
    return np.random.default_rng(6).integers(-2**31, 2**31 - 1, (8192, 1024), dtype=np.int32)


def _not_pow2():
    return np.random.default_rng(7).integers(0, 3, (33, 768), dtype=np.int32)


@pytest.mark.parametrize("make,k", [(_ties, 20), (_neg_inf, 8), (_wide, 20), (_not_pow2, 20)],
                         ids=["int32-ties", "f32-neginf", "join-shape", "w768"])
def test_k2_kernel_equal_to_plain(dev, make, k):
    x = torch.from_numpy(make()).to(dev)
    before = fused_topk.LAUNCHES
    v, i = fused_topk.fused_topk(x, k)
    rv, ri = fused_topk.fused_topk_reference(x, k)
    torch.cuda.synchronize()
    assert fused_topk.LAUNCHES == before + 1
    assert torch.equal(v, rv) and torch.equal(i, ri)


def _k4_inputs(rng, sizes, blk, qcap, d, ties, compact, bias):
    """K4 inputs; ``compact`` lays them out as the recovery pass does: the
    blocks of every other cluster in storage order, then the rest with
    zeroed tables, and row_base = block·blk."""
    qg, vt, bf, bl, rv = _k1_inputs(rng, sizes, blk, qcap, d, *((0, 2) if ties else ()))
    nb = len(bf)
    rb = np.arange(nb, dtype=np.int32) * blk
    br = rng.uniform(0, 3000, (nb, 1, blk)).astype(np.float32) if bias else None
    if compact:
        active = ((np.cumsum(bf) - 1) % 2 == 0) & (rv > 0)
        blocks = np.concatenate([np.nonzero(active)[0], np.nonzero(~active)[0]])
        inc = active[blocks]
        qg, vt, rb = qg[blocks], vt[blocks], rb[blocks]
        bf, bl, rv = (np.where(inc, x[blocks], 0).astype(np.int32) for x in (bf, bl, rv))
        br = None if br is None else br[blocks]
    return qg, vt, bf, bl, rv, br, rb


@pytest.mark.parametrize("sizes,blk,qcap,d,k,ties", [
    ([2000, 0, 5000, 129, 10], 2048, 40, 128, 20, False),  # 3-block cluster, -inf fill
    ([700, 300, 129, 2000], 256, 100, 37, 32, False),      # ragged qcap tile, d % 4 != 0
    ([3000, 2100, 40], 2048, 24, 128, 20, True),            # scores 0..128: heavy ties
], ids=["blk2048", "blk256", "ties"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("bias", [False, True], ids=["ip", "l2bias"])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_k4_kernel_equal_to_plain(dev, sizes, blk, qcap, d, k, ties, depth, bias, compact):
    rng = np.random.default_rng(19)
    qg, vt, bf, bl, rv, br, rb = (None if x is None else torch.from_numpy(x).to(dev)
                                  for x in _k4_inputs(rng, sizes, blk, qcap, d, ties,
                                                      compact, bias))
    kw = dict(k=k, blk=blk, bin_depth=depth, bias=br, row_base=rb)
    before = ivf_scan.LAUNCHES
    pv, pr = ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, **kw)
    rv_, rr = ivf_scan.cluster_major_scan_grouped_reference(qg, vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES == before + 1
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(pv[rows], rv_[rows])
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])


@pytest.mark.parametrize("sizes,blk,qcap,d,k,ties", [
    ([2000, 0, 5000, 129, 10], 2048, 40, 129, 20, False),  # 3-block cluster, D' odd
    ([700, 300, 129, 2000], 256, 100, 37, 32, False),      # ragged qcap tile, d % 4 != 0
    ([3000, 2100, 40], 2048, 24, 128, 20, True),            # scores 0..128: heavy ties
    ([700, 300], 256, 40, 320, 20, False),                  # the widest D the float stage holds
], ids=["blk2048", "blk256", "ties", "d320"])
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_k4_kernel_float_equal_to_plain(dev, sizes, blk, qcap, d, k, ties, dtype, depth, bias,
                                        compact):
    """K4's float modes on integer values (exact sums): pv bit-equal, pr
    equal where finite.  The index's float paths pass no bias (L2 rides
    the augmented dimension); the JAX kernel subtracts one if given, and
    so does this one."""
    rng = np.random.default_rng(21)
    qg, vt, bf, bl, rv, br, rb = _k4_inputs(rng, sizes, blk, qcap, d, ties, compact, bias)
    qg, vt = (torch.from_numpy(x).to(dev, FLOAT_DTYPES[dtype]) for x in (qg, vt))
    bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (bf, bl, rv, rb))
    br = None if br is None else torch.from_numpy(br).to(dev)
    kw = dict(k=k, blk=blk, bin_depth=depth, bias=br, row_base=rb)
    before = ivf_scan.LAUNCHES
    pv, pr = ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, **kw)
    rv_, rr = ivf_scan.cluster_major_scan_grouped_reference(qg, vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES == before + 1
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(pv[rows], rv_[rows])
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])


def _assert_topk_close(v, i, rv, ri, bound):
    """Non-integer float data, where the kernel and the plain version sum in
    different orders: finite values within ``bound`` (2·D·2**-24·max|q|·|b|
    of the row, the worst case of two fp32 sums in any order) of the plain
    version's, -inf where it is, and ids equal wherever a value stands more
    than twice the bound from both neighbours of its row (the row's last
    entry is left out: its next is not known)."""
    fin = rv > float("-inf")
    assert torch.equal(v > float("-inf"), fin)
    err = (v.double() - rv.double()).abs()
    assert (err[fin] <= bound.expand_as(err)[fin]).all()
    gap = rv.double().diff(dim=-1).abs() > 2.0 * bound
    sep = fin.clone()
    sep[..., :-1] &= gap
    sep[..., 1:] &= gap
    sep[..., -1] = False
    assert sep.any()
    assert torch.equal(i[sep], ri[sep])


def test_k4_kernel_fp32_close_to_plain_on_noninteger_data(dev):
    rng = np.random.default_rng(22)
    _, _, bf, bl, rv, _, rb = _k4_inputs(rng, [700, 300, 129, 2000], 256, 100, 37, False,
                                         False, False)
    nb = len(bf)
    qg = torch.from_numpy(rng.normal(size=(nb, 100, 37)).astype(np.float32)).to(dev)
    vt = torch.from_numpy(rng.normal(size=(nb, 37, 256)).astype(np.float32)).to(dev)
    bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (bf, bl, rv, rb))
    kw = dict(k=20, blk=256, row_base=rb)
    pv, pr = ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, **kw)
    rv_, rr = ivf_scan.cluster_major_scan_grouped_reference(qg, vt, bf, bl, rv, **kw)
    rows = torch.nonzero(bl).flatten()
    bound = 2.0 * 37 * 2.0**-24 * torch.bmm(qg.double().abs(), vt.double().abs()).amax(
        dim=-1, keepdim=True)
    _assert_topk_close(pv[rows], pr[rows], rv_[rows], rr[rows], bound[rows])


def test_k4_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(20)
    qg, vt, bf, bl, rv, _, _ = (None if x is None else torch.from_numpy(x).to(dev)
                                for x in _k4_inputs(rng, [100], 128, 8, 16, False, False,
                                                    False))
    with pytest.raises(ValueError, match="one dtype"):
        ivf_scan.cluster_major_scan_grouped(qg.float(), vt.bfloat16(), bf, bl, rv, 4, blk=128)
    with pytest.raises(ValueError):  # more than 32 per row
        ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, 33, blk=128)
    with pytest.raises(ValueError):  # bins other than 128
        ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, 4, blk=128, nbins=64)


def _k6_inputs(rng, sizes, blk, qcap, d, ties, walk, bias):
    """K6 inputs laid out as one shard of ShardedIVFIndex: clusters 2.. of
    nlist = len(sizes) + 4 (global ids), padded to 8 blocks with dummies on
    the last one.  ``walk`` "cut" and "parked" lay them out as the recovery
    pass does: every other cluster's blocks in storage order, cut one block
    short of them all (that cluster emits nothing) or followed by two more
    blocks with zeroed tables, parked on the last listed block's cluster;
    row_base = block·blk."""
    lo = 2
    sizes = np.asarray(sizes)
    offs = np.concatenate([[0], np.cumsum(-(-sizes // blk) * blk)[:-1]])
    bc, bf, bl, rv, _ = block_tables.build_block_tables(offs, sizes, blk)
    pad = (-len(bc)) % 8
    bc = np.pad(bc + lo, (0, pad), constant_values=lo + len(sizes) - 1).astype(np.int32)
    bf, bl, rv = (np.pad(x, (0, pad)).astype(np.int32) for x in (bf, bl, rv))
    nb, nlist = len(bc), len(sizes) + 4
    lo_v, hi_v = (0, 2) if ties else (-127, 128)
    qg = rng.integers(lo_v, hi_v, (nlist, qcap, d), dtype=np.int8)
    vt = rng.integers(lo_v, hi_v, (nb, d, blk), dtype=np.int8)
    rb = np.arange(nb, dtype=np.int32) * blk
    br = rng.uniform(0, 3000, (1, nb * blk)).astype(np.float32) if bias else None
    if walk != "dense":
        active = ((bc - lo) % 2 == 0) & (rv > 0)
        n_act = int(active.sum())
        cap = n_act - 1 if walk == "cut" else n_act + 2
        order = np.concatenate([np.nonzero(active)[0], np.nonzero(~active)[0]])
        blocks = order[:cap]
        inc = ((np.cumsum(active) - 1) < cap)[blocks] & active[blocks]
        n_inc = int(inc.sum())
        bc = np.where(inc, bc[blocks], bc[blocks][max(n_inc - 1, 0)]).astype(np.int32)
        bf, bl, rv = (np.where(inc, x[blocks], 0).astype(np.int32) for x in (bf, bl, rv))
        vt, rb = vt[blocks], rb[blocks]
        br = None if br is None else br.reshape(nb, blk)[blocks].reshape(1, -1)
    return qg, vt, bc, bf, bl, rv, br, rb


@pytest.mark.parametrize("sizes,blk,qcap,d,k,ties", [
    ([2000, 0, 5000, 129, 10], 2048, 40, 128, 20, False),  # 3-block cluster, -inf fill
    ([700, 300, 129, 2000, 90], 256, 100, 37, 32, False),  # ragged qcap tile, d % 4 != 0
    ([3000, 2100, 40, 2500], 2048, 24, 128, 20, True),     # scores 0..128: heavy ties
], ids=["blk2048", "blk256", "ties"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("bias", [False, True], ids=["ip", "l2bias"])
@pytest.mark.parametrize("walk", ["dense", "cut", "parked"])
def test_k6_kernel_equal_to_plain(dev, sizes, blk, qcap, d, k, ties, depth, bias, walk):
    rng = np.random.default_rng(21)
    qg, vt, bc, bf, bl, rv, br, rb = (None if x is None else torch.from_numpy(x).to(dev)
                                      for x in _k6_inputs(rng, sizes, blk, qcap, d, ties,
                                                          walk, bias))
    kw = dict(k=k, blk=blk, bin_depth=depth, bias=br, row_base=rb)
    before, k4_before = ivf_scan.CLUSTER_LAUNCHES, ivf_scan.LAUNCHES
    pv, pr = ivf_scan.cluster_major_scan(qg, vt, bc, bf, bl, rv, **kw)
    rv_, rr = ivf_scan.cluster_major_scan_reference(qg, vt, bc, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert ivf_scan.CLUSTER_LAUNCHES == before + 1 and ivf_scan.LAUNCHES == k4_before
    rows = bc[torch.nonzero(bl).flatten()].long()
    assert rows.numel() > 0
    assert torch.equal(pv[rows], rv_[rows])
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])


# Ragged float shapes: D' 129 (odd, the augmented L2 index), 37 (d % 4 != 0)
# and 320 (the widest the float stage holds), qcap off the row tile.
FLOAT_SHAPES = [([2000, 0, 5000, 129, 10], 2048, 40, 129),
                ([700, 300, 129, 2000, 90], 256, 100, 37),
                ([700, 300], 256, 24, 320)]
FLOAT_SHAPE_IDS = ["d129", "d37", "d320"]


def _as_float(dev, dtype, *arrays):
    """int8 arrays (values in [-127, 127]: exact in bf16, exact fp32 sums
    up to D=320) as ``dtype`` tensors on ``dev``."""
    return tuple(torch.from_numpy(x).to(dev, FLOAT_DTYPES[dtype]) for x in arrays)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("sizes,blk,qcap,d", FLOAT_SHAPES, ids=FLOAT_SHAPE_IDS)
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("walk", ["dense", "parked"])
@pytest.mark.parametrize("depth", [2, 3])
def test_k6_kernel_float_bit_equal_to_plain(dev, sizes, blk, qcap, d, dtype, walk, depth):
    """K6's float modes over a shard's walk and a recovery list; every 7th
    routed row is zero, as an empty slot: it scores +0."""
    rng = np.random.default_rng(27)
    qg, vt, bc, bf, bl, rv, _, rb = _k6_inputs(rng, sizes, blk, qcap, d, False, walk, False)
    qg[:, ::7] = 0
    qg, vt = _as_float(dev, dtype, qg, vt)
    bc, bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (bc, bf, bl, rv, rb))
    kw = dict(k=20, blk=blk, bin_depth=depth, row_base=rb)
    before = ivf_scan.CLUSTER_LAUNCHES
    pv, pr = ivf_scan.cluster_major_scan(qg, vt, bc, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert ivf_scan.CLUSTER_LAUNCHES == before + 1
    rv_, rr = ivf_scan.cluster_major_scan_reference(qg, vt, bc, bf, bl, rv, **kw)
    rows = bc[torch.nonzero(bl).flatten()].long()
    assert torch.equal(_bits(pv[rows]), _bits(rv_[rows]))
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])


def test_k6_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(22)
    qg, vt, bc, bf, bl, rv, _, _ = (None if x is None else torch.from_numpy(x).to(dev)
                                    for x in _k6_inputs(rng, [100], 128, 8, 16, False, "dense",
                                                        False))
    with pytest.raises(ValueError, match="one dtype"):
        ivf_scan.cluster_major_scan(qg.float(), vt.bfloat16(), bc, bf, bl, rv, 4, blk=128)
    with pytest.raises(ValueError):  # more than 32 per row
        ivf_scan.cluster_major_scan(qg, vt, bc, bf, bl, rv, 33, blk=128)
    with pytest.raises(ValueError):  # bins other than 128
        ivf_scan.cluster_major_scan(qg, vt, bc, bf, bl, rv, 4, blk=128, nbins=64)
    with pytest.raises(ValueError):  # depth past 4
        ivf_scan.cluster_major_scan(qg, vt, bc, bf, bl, rv, 4, blk=128, bin_depth=5)


def _k7_inputs(rng, sizes, blk, qcap, d, ties, compact, bias, nbatch=300):
    """K7 inputs → (qi [nbatch, d], cq_blocks [nb, qcap, 1], vt, bc, bf, bl, rv,
    bias, row_base, cq [nlist, qcap]).  Each cluster routes 1..qcap queries
    (-1 after them); one slot of cluster 0 holds ``nbatch``, past the batch,
    which routes a zero row as -1 does.  ``compact`` as :func:`_k4_inputs`."""
    lo, hi = (0, 2) if ties else (-127, 128)
    sizes = np.asarray(sizes)
    offs = np.concatenate([[0], np.cumsum(-(-sizes // blk) * blk)[:-1]])
    bc, bf, bl, rv, _ = block_tables.build_block_tables(offs, sizes, blk)
    pad = (-len(bc)) % 8
    bc = np.pad(bc, (0, pad), constant_values=len(sizes) - 1).astype(np.int32)
    bf, bl, rv = (np.pad(x, (0, pad)).astype(np.int32) for x in (bf, bl, rv))
    nb, nlist = len(bc), len(sizes)
    qi = rng.integers(lo, hi, (nbatch, d), dtype=np.int8)
    vt = rng.integers(lo, hi, (nb, d, blk), dtype=np.int8)
    cq = np.full((nlist, qcap), -1, np.int32)
    for c in range(nlist):
        n = int(rng.integers(1, qcap + 1))
        cq[c, :n] = rng.choice(nbatch, n, replace=False)
    cq[0, 0] = nbatch
    rb = np.arange(nb, dtype=np.int32) * blk
    br = rng.uniform(0, 3000, (nb, 1, blk)).astype(np.float32) if bias else None
    if compact:
        active = ((np.cumsum(bf) - 1) % 2 == 0) & (rv > 0)
        blocks = np.concatenate([np.nonzero(active)[0], np.nonzero(~active)[0]])
        inc = active[blocks]
        bc, vt, rb = bc[blocks], vt[blocks], rb[blocks]
        bf, bl, rv = (np.where(inc, x[blocks], 0).astype(np.int32) for x in (bf, bl, rv))
        br = None if br is None else br[blocks]
    return (qi, np.ascontiguousarray(cq[bc][..., None]), vt, bc, bf, bl, rv, br, rb, cq)


@pytest.mark.parametrize("sizes,blk,qcap,d,k,ties", [
    ([2000, 0, 5000, 129, 10], 2048, 40, 128, 20, False),  # 3-block cluster, -inf fill
    ([700, 300, 129, 2000], 256, 100, 37, 32, False),      # ragged qcap tile, d % 4 != 0
    ([3000, 2100, 40], 2048, 24, 128, 20, True),            # scores 0..128: heavy ties
], ids=["blk2048", "blk256", "ties"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("bias", [False, True], ids=["ip", "l2bias"])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_k7_kernel_equal_to_plain_and_to_k4_k6(dev, sizes, blk, qcap, d, k, ties, depth,
                                               bias, compact):
    """K7 against its plain version, then the shared template's other two
    modes on the gathered tables: K4 on ``qi[cq_blocks]`` and K6 on the
    per-cluster ``qi[cq]`` give the same rows, bit for bit."""
    rng = np.random.default_rng(23)
    qi, cqb, vt, bc, bf, bl, rv, br, rb, cq = (
        None if x is None else torch.from_numpy(x).to(dev)
        for x in _k7_inputs(rng, sizes, blk, qcap, d, ties, compact, bias))
    kw = dict(k=k, blk=blk, bin_depth=depth, bias=br, row_base=rb)
    before = (ivf_scan.ROUTED_LAUNCHES, ivf_scan.LAUNCHES, ivf_scan.CLUSTER_LAUNCHES)
    pv, pr = ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert (ivf_scan.ROUTED_LAUNCHES, ivf_scan.LAUNCHES, ivf_scan.CLUSTER_LAUNCHES) == (
        before[0] + 1, before[1], before[2])
    rv_, rr = ivf_scan.cluster_major_scan_routed_reference(qi, cqb, vt, bf, bl, rv, **kw)
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(pv[rows], rv_[rows])
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])

    def gathered(idx):
        hit = (idx >= 0) & (idx < qi.shape[0])
        g = qi[torch.where(hit, idx, torch.zeros_like(idx)).long()]
        return torch.where(hit[..., None], g, torch.zeros_like(g)).contiguous()

    gv, gr = ivf_scan.cluster_major_scan_grouped(gathered(cqb[..., 0]), vt, bf, bl, rv, **kw)
    cv, ci = ivf_scan.cluster_major_scan(
        gathered(cq), vt, bc, bf, bl, rv, k=k, blk=blk, bin_depth=depth, row_base=rb,
        bias=None if br is None else br.reshape(1, -1))
    torch.cuda.synchronize()
    out = bc[rows].long()
    assert torch.equal(gv[rows], pv[rows]) and torch.equal(cv[out], pv[rows])
    assert torch.equal(gr[rows][fin], pr[rows][fin]) and torch.equal(ci[out][fin], pr[rows][fin])


@pytest.mark.parametrize("sizes,blk,qcap,d", FLOAT_SHAPES, ids=FLOAT_SHAPE_IDS)
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("depth", [2, 4])
def test_k7_kernel_float_bit_equal_to_plain(dev, sizes, blk, qcap, d, dtype, compact, depth):
    """K7's float modes: the routed rows gathered from the batch [B, D']
    (rows start every 4·D' bytes, D' odd) through cq_blocks; a slot past the
    batch and the -1 slots give zero rows."""
    rng = np.random.default_rng(28)
    qi, cqb, vt, _, bf, bl, rv, _, rb, _ = _k7_inputs(rng, sizes, blk, qcap, d, False,
                                                      compact, False)
    qi, vt = _as_float(dev, dtype, qi, vt)
    cqb, bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (cqb, bf, bl, rv, rb))
    kw = dict(k=20, blk=blk, bin_depth=depth, row_base=rb)
    before = (ivf_scan.ROUTED_LAUNCHES, ivf_scan.LAUNCHES)
    pv, pr = ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert (ivf_scan.ROUTED_LAUNCHES, ivf_scan.LAUNCHES) == (before[0] + 1, before[1])
    rv_, rr = ivf_scan.cluster_major_scan_routed_reference(qi, cqb, vt, bf, bl, rv, **kw)
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(_bits(pv[rows]), _bits(rv_[rows]))
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])


def test_k7_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(24)
    qi, cqb, vt, _, bf, bl, rv, _, _, _ = (
        None if x is None else torch.from_numpy(x).to(dev)
        for x in _k7_inputs(rng, [100], 128, 8, 16, False, False, False))
    with pytest.raises(ValueError, match="D <= 320"):
        ivf_scan.cluster_major_scan_routed(
            torch.zeros((qi.shape[0], 330), device=dev), cqb,
            torch.zeros((vt.shape[0], 330, 128), device=dev), bf, bl, rv, 4, blk=128)
    with pytest.raises(ValueError):  # more than 32 per row
        ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, 33, blk=128)
    with pytest.raises(ValueError):  # depth past 4
        ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, 4, blk=128, bin_depth=5)


@pytest.mark.parametrize("sizes,blk,qcap,d,lo_hi", [
    ([2000, 0, 5000, 129], 2048, 40, 128, (-127, 128)),  # multi-block and empty clusters
    ([700, 300, 129, 2000], 256, 100, 37, (-127, 128)),  # ragged qcap tile, d % 4 != 0
    ([3000, 2100, 40], 2048, 24, 128, (0, 2)),            # equal keys across chunks
], ids=["blk2048", "blk256", "ties"])
@pytest.mark.parametrize("bias", ["ip", "l2bias", "raw"])
@pytest.mark.parametrize("bin2", [True, False], ids=["bin2", "bin1"])
@pytest.mark.parametrize("k", [20, 32])
def test_k9_kernel_equal_to_plain(dev, sizes, blk, qcap, d, lo_hi, bias, bin2, k):
    """``l2bias``: the 4-bit rows of ``accum_bias_rows`` (padding buried by
    the fill, no row mask); ``raw``: random int32 rows with the row mask,
    whose low bits name blocks outside the cluster."""
    rng = np.random.default_rng(25)
    qg, vt, bf, bl, rv = (torch.from_numpy(x).to(dev)
                          for x in _k1_inputs(rng, sizes, blk, qcap, d, *lo_hi))
    kw = dict(k=k, blk=blk, group=8, depth=8, bin2=bin2)
    if bias == "l2bias":
        norms = torch.from_numpy(rng.uniform(0, 4e4, (vt.shape[0], 1, blk)).astype(np.float32))
        kw["bias_rows"] = ivf_accum.accum_bias_rows(norms.to(dev), rv)
    elif bias == "raw":
        kw["bias_rows"] = torch.from_numpy(rng.integers(-2**29, 2**29, (vt.shape[0], 1, blk),
                                                        dtype=np.int32)).to(dev)
        kw["mask_rows"] = True
    before = (ivf_accum.ACCUM_LAUNCHES, ivf_accum.LAUNCHES)
    pv, pr = ivf_accum.cluster_major_accum(qg, vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert (ivf_accum.ACCUM_LAUNCHES, ivf_accum.LAUNCHES) == (before[0] + 1, before[1])
    rv_, rr = ivf_accum.cluster_major_accum_reference(qg, vt, bf, bl, rv, **kw)
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(pv[rows], rv_[rows])
    assert torch.equal(pr[rows], rr[rows])
    assert (rv_[rows] > float("-inf")).any()


@pytest.mark.parametrize("sizes,blk,qcap,d", [
    ([2000, 0, 5000, 129], 2048, 40, 129),  # multi-block and empty clusters, D' odd
    ([700, 300, 129, 2000], 256, 100, 37),  # ragged qcap tile, d % 4 != 0
    ([700, 300], 256, 24, 320),             # the widest D the float stage holds
], ids=FLOAT_SHAPE_IDS)
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("bin2", [True, False], ids=["bin2", "bin1"])
@pytest.mark.parametrize("k", [20, 32])
def test_k9_kernel_float_bit_equal_to_plain(dev, sizes, blk, qcap, d, dtype, bin2, k):
    """K9's float emit: ``pv`` is the masked key (monotone(score) & ~15 |
    code) turned back into fp32, bit for bit; every 7th routed row is zero
    (scores +0, whose key differs from -0's)."""
    rng = np.random.default_rng(29)
    qg, vt, bf, bl, rv = _k1_inputs(rng, sizes, blk, qcap, d)
    qg[:, ::7] = 0
    qg, vt = _as_float(dev, dtype, qg, vt)
    bf, bl, rv = (torch.from_numpy(x).to(dev) for x in (bf, bl, rv))
    kw = dict(k=k, blk=blk, group=8, depth=8, bin2=bin2)
    before = (ivf_accum.ACCUM_LAUNCHES, ivf_accum.LAUNCHES)
    pv, pr = ivf_accum.cluster_major_accum(qg, vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert (ivf_accum.ACCUM_LAUNCHES, ivf_accum.LAUNCHES) == (before[0] + 1, before[1])
    rv_, rr = ivf_accum.cluster_major_accum_reference(qg, vt, bf, bl, rv, **kw)
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(_bits(pv[rows]), _bits(rv_[rows]))
    assert torch.equal(pr[rows], rr[rows])
    assert (rv_[rows] > float("-inf")).any()


def test_k9_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(26)
    qg, vt, bf, bl, rv = (torch.from_numpy(x).to(dev)
                          for x in _k1_inputs(rng, [100], 128, 8, 16))
    with pytest.raises(ValueError, match="one dtype"):
        ivf_accum.cluster_major_accum(qg.bfloat16(), vt.float(), bf, bl, rv, 4, blk=128)
    with pytest.raises(ValueError, match="bias_rows"):  # float slabs take no bias rows
        ivf_accum.cluster_major_accum(qg.float(), vt.float(), bf, bl, rv, 4, blk=128,
                                      bias_rows=torch.zeros((vt.shape[0], 1, 128),
                                                            dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # more than 32 per row
        ivf_accum.cluster_major_accum(qg, vt, bf, bl, rv, 33, blk=128)


@pytest.mark.parametrize("recover", [False, True])
def test_routed_engine_card_equals_cpu(dev, recover):
    base, queries = make_synthetic(3000, 40, 64, 8, seed=5)
    src = IVFIndex.build(base, nlist=12, metric="l2", dtype="int8", pad_block=256,
                         max_iter=5, device="cpu")
    kw = dict(mode="cluster", engine="pallas_routed", qcap=4, recover=recover,
              recover_qcap=16, recover_blocks=24, recover_passes=2)  # every block

    def search(device):
        idx = IVFIndex.from_arrays(src._centroids_np, src._vectors_np, src._offsets_np,
                                   src._reorder_np, metric="l2", dtype="int8", pad_block=256,
                                   config=src.config, device=device)
        out = idx.search_device(torch.from_numpy(queries).to(device), 10, 4, **kw)
        return [x.cpu() for x in out], int(idx.last_spill), idx.last_engine

    before = (ivf_scan.ROUTED_LAUNCHES, ivf_scan.LAUNCHES)
    got, spill, engine = search(dev)
    torch.cuda.synchronize()
    launches = (ivf_scan.ROUTED_LAUNCHES - before[0], ivf_scan.LAUNCHES - before[1])
    want, want_spill, _ = search("cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert engine == "pallas_routed" and spill == want_spill
    assert launches == ((3, 0) if recover else (1, 0))  # main walk + 2 recovery passes
    assert (spill == 0) == recover


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("run", ["auto", "recover", "grouped"])
def test_float_ivf_card_equals_cpu(dev, dtype, run):
    """A float index (L2 on the augmented dimension) through K1 and the
    recovery pass's K4, or the grouped engine's K4, on the card and on the
    CPU: the same ids, scores and spill (integer data, exact sums)."""
    base, queries = make_synthetic(3000, 40, 64, 8, seed=5)
    src = IVFIndex.build(base, nlist=12, metric="l2", dtype=dtype, pad_block=256,
                         max_iter=5, device="cpu")
    kw = {"auto": dict(), "grouped": dict(engine="pallas"),
          "recover": dict(qcap=4, recover=True, recover_qcap=16, recover_passes=2)}[run]

    def search(device):
        idx = IVFIndex.from_arrays(src._centroids_np, src._vectors_np, src._offsets_np,
                                   src._reorder_np, metric="l2", dtype=dtype, pad_block=256,
                                   config=src.config, device=device)
        out = idx.search_device(torch.from_numpy(queries).to(device), 10, 4, mode="cluster",
                                **kw)
        return [x.cpu() for x in out], int(idx.last_spill), idx.last_engine

    before = (ivf_accum.LAUNCHES, ivf_scan.LAUNCHES)
    got, spill, engine = search(dev)
    torch.cuda.synchronize()
    launches = (ivf_accum.LAUNCHES - before[0], ivf_scan.LAUNCHES - before[1])
    want, want_spill, _ = search("cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert spill == want_spill
    assert launches == {"auto": (1, 0), "recover": (1, 2), "grouped": (0, 1)}[run]
    assert engine == ("pallas" if run == "grouped" else "pallas_accum")


# K3: (B, D, N, k, tile_n, n_valid, value range).  N = 3001 is not a multiple
# of 4 (byte staging) nor of 128 (a ragged last chunk) nor of 8 (bf16 base_t
# copied to a 16-byte row pitch); D = 37 pads a word.  The bf16 kernel's
# edges: 64 rows a CTA (B = 70, 200), 128 columns a chunk (tile_n 128, 256,
# 2048), 64 d a box (D = 129, 512).
K3_SHAPES = {
    "base": (40, 64, 2048, 20, 512, None, (-127, 128)),
    "ragged": (70, 37, 3001, 32, None, 2900, (-127, 128)),
    "ties": (33, 128, 5000, 10, None, None, (0, 3)),
    "t128-d129": (200, 129, 4100, 20, 128, None, (-127, 128)),
    "t256-b200": (200, 128, 3001, 32, 256, 2950, (-127, 128)),
    "t2048-d512": (70, 512, 5000, 20, 2048, 4500, (-127, 128)),
}


@pytest.mark.parametrize("shape", list(K3_SHAPES))
@pytest.mark.parametrize("nbins", [0, 128], ids=["exact", "bin128"])
@pytest.mark.parametrize("mode", ["i8", "i8_l2", "f32", "bf16"])
def test_k3_kernel_equal_to_plain(dev, shape, nbins, mode):
    b, d, n, k, tile_n, n_valid, (lo, hi) = K3_SHAPES[shape]
    rng = np.random.default_rng(30)
    q = torch.from_numpy(rng.integers(lo, hi, (b, d), dtype=np.int8)).to(dev)
    bt = torch.from_numpy(rng.integers(lo, hi, (d, n), dtype=np.int8)).to(dev)
    kw = dict(nbins=nbins, tile_n=tile_n)
    if mode == "i8_l2":
        kw["alpha"] = torch.from_numpy(rng.uniform(0.5, 2, b).astype(np.float32)).to(dev)
        kw["bias"] = torch.from_numpy(rng.uniform(0, 3e4, n).astype(np.float32)).to(dev)
    if mode in ("f32", "bf16"):  # integer values: exact in bf16, every fp32 sum exact
        q, bt = (x.to(torch.bfloat16 if mode == "bf16" else torch.float32) for x in (q, bt))
    if n_valid is not None:
        kw["n_valid"] = torch.tensor([n_valid], dtype=torch.int32, device=dev)
    before = bruteforce_fused.LAUNCHES
    v, i = bruteforce_fused.fused_topk_matmul(q, bt, k, **kw)
    rv, ri = bruteforce_fused.fused_topk_matmul_reference(q, bt, k, **kw)
    torch.cuda.synchronize()
    assert bruteforce_fused.LAUNCHES == before + 1
    assert torch.equal(v, rv)
    assert torch.equal(i, ri)
    assert int(i.max()) < (n_valid or n)


@pytest.mark.parametrize("nbins", [0, 128], ids=["exact", "bin128"])
def test_k3_kernel_bf16_close_to_plain_on_noninteger_data(dev, nbins):
    b, d, n, k, tile_n, n_valid, _ = K3_SHAPES["ragged"]
    rng = np.random.default_rng(32)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev, torch.bfloat16)
    bt = torch.from_numpy(rng.normal(size=(d, n)).astype(np.float32)).to(dev, torch.bfloat16)
    kw = dict(nbins=nbins, tile_n=tile_n,
              n_valid=torch.tensor([n_valid], dtype=torch.int32, device=dev))
    v, i = bruteforce_fused.fused_topk_matmul(q, bt, k, **kw)
    rv, ri = bruteforce_fused.fused_topk_matmul_reference(q, bt, k, **kw)
    bound = 2.0 * d * 2.0**-24 * (q.double().abs() @ bt.double().abs()).amax(dim=1,
                                                                              keepdim=True)
    _assert_topk_close(v, i, rv, ri, bound)


def test_k3_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros((4, 16), dtype=torch.int8, device=dev)
    bt = torch.zeros((16, 600), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        bruteforce_fused.fused_topk_matmul(q.float(), bt.bfloat16(), 4)
    with pytest.raises(ValueError):  # more than 32 per row
        bruteforce_fused.fused_topk_matmul(q, bt, 33)
    with pytest.raises(ValueError):  # bins other than 128
        bruteforce_fused.fused_topk_matmul(q, bt, 4, tile_n=512, nbins=64)


# K5: (B, D, N, tile_n, group, k, bias rows, value range); N = 1300 and 9000
# leave a partial tile and padded tiles.  The bf16 kernel's edges: 192 rows
# a CTA (B = 70, 200), 64 bins a CTA (tile_n 128, 256, 2048), 64 d a box
# (D = 37, 128, 129, 320).
K5_SHAPES = {
    "ip": (40, 64, 4096, 256, 4, 20, False, (-127, 128)),
    "l2": (40, 64, 4096, 256, 4, 20, True, (-127, 128)),
    "ties": (33, 128, 4096, 128, 8, 10, False, (0, 3)),
    "ragged-l2": (70, 37, 1300, 128, 4, 32, True, (-127, 128)),
    "d320": (40, 320, 1300, 128, 4, 20, False, (-127, 128)),
    "t2048-d129": (200, 129, 9000, 2048, 4, 20, False, (-127, 128)),
    "t256-b200": (200, 128, 5000, 256, 8, 20, False, (-127, 128)),
}


@pytest.mark.parametrize("shape", list(K5_SHAPES))
def test_k5_kernel_equal_to_plain(dev, shape):
    b, d, n, tile_n, group, k, l2, (lo, hi) = K5_SHAPES[shape]
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.integers(lo, hi, (b, d), dtype=np.int8)).to(dev)
    tiles, _ = bruteforce_accum.tile_base(rng.integers(lo, hi, (d, n), dtype=np.int8),
                                          tile_n, group)
    tiles = tiles.to(dev)
    br = None
    if l2:
        norms = bruteforce_accum.tile_norms(rng.uniform(0, 1e5, n).astype(np.float32),
                                            tile_n, group)
        br = bruteforce_accum.l2_bias_rows(torch.from_numpy(norms).to(dev),
                                           torch.tensor(7.0, device=dev), group)
    kw = dict(group=group, depth=group, bias_rows=br)
    before = bruteforce_accum.LAUNCHES
    v, i = bruteforce_accum.fused_topk_accum(q, tiles, n, k, **kw)
    rv, ri = bruteforce_accum.fused_topk_accum_reference(q, tiles, n, k, **kw)
    torch.cuda.synchronize()
    assert bruteforce_accum.LAUNCHES == before + 1
    assert torch.equal(v, rv)
    assert torch.equal(i, ri)
    assert int(i.max()) < n


@pytest.mark.parametrize("shape", ["ip", "ties", "ragged-l2", "d320", "t2048-d129",
                                   "t256-b200"])
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
def test_k5_kernel_float_equal_to_plain(dev, shape, dtype):
    """K5's float modes on integer values (exact sums): the decoded values
    bit for bit, and the ids.  Float L2 rides the data (an augmented
    dimension), so no shape has bias rows; ragged-l2 keeps its D = 37 and
    N = 1300 (a partial tile and padded tiles)."""
    b, d, n, tile_n, group, k, _, (lo, hi) = K5_SHAPES[shape]
    rng = np.random.default_rng(33)
    q = torch.from_numpy(rng.integers(lo, hi, (b, d), dtype=np.int8)).to(dev,
                                                                        FLOAT_DTYPES[dtype])
    tiles, _ = bruteforce_accum.tile_base(rng.integers(lo, hi, (d, n), dtype=np.int8),
                                          tile_n, group)
    tiles = tiles.to(dev, FLOAT_DTYPES[dtype])
    kw = dict(group=group, depth=group)
    before = bruteforce_accum.LAUNCHES
    v, i = bruteforce_accum.fused_topk_accum(q, tiles, n, k, **kw)
    rv, ri = bruteforce_accum.fused_topk_accum_reference(q, tiles, n, k, **kw)
    torch.cuda.synchronize()
    assert bruteforce_accum.LAUNCHES == before + 1
    assert v.dtype == rv.dtype == torch.float32
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(i, ri)
    assert int(i.max()) < n


@pytest.mark.parametrize("shape", ["ragged-l2", "t2048-d129"])
def test_k5_kernel_bf16_close_to_plain_on_noninteger_data(dev, shape):
    """bf16 on the tensor cores against the plain fp32 product of the same
    bf16 values: the decoded values within the order bound of two fp32 sums
    (plus the key's ceded low bits), ids equal where values stand apart."""
    b, d, n, tile_n, group, k, _, _ = K5_SHAPES[shape]
    rng = np.random.default_rng(34)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev, torch.bfloat16)
    base_t = rng.normal(size=(d, n)).astype(np.float32)
    tiles, _ = bruteforce_accum.tile_base(base_t, tile_n, group)
    tiles = tiles.to(dev, torch.bfloat16)
    kw = dict(group=group, depth=group)
    before = bruteforce_accum.LAUNCHES
    v, i = bruteforce_accum.fused_topk_accum(q, tiles, n, k, **kw)
    rv, ri = bruteforce_accum.fused_topk_accum_reference(q, tiles, n, k, **kw)
    torch.cuda.synchronize()
    assert bruteforce_accum.LAUNCHES == before + 1
    bt = torch.from_numpy(base_t).to(dev, torch.bfloat16)
    mag = (q.double().abs() @ bt.double().abs()).amax(dim=1, keepdim=True)
    # The key keeps the score's top bits: log2(group) low bits are ceded, a
    # relative 2**(shift-23) of the value on each side.
    bound = (2.0 * d * 2.0**-24 * mag
             + rv.double().abs().amax(dim=1, keepdim=True) * 2.0**(group.bit_length() - 24))
    _assert_topk_close(v, i, rv, ri, bound)


def test_k5_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros((4, 16), dtype=torch.int8, device=dev)
    tiles = torch.zeros((8, 16, 128), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        bruteforce_accum.fused_topk_accum(q.float(), tiles.bfloat16(), 900, 4, group=4, depth=4)
    with pytest.raises(ValueError):  # bins past 2048
        bruteforce_accum.fused_topk_accum(q, torch.zeros((8, 16, 4096), dtype=torch.int8,
                                                         device=dev), 900, 4, group=4,
                                          depth=4)


@pytest.mark.parametrize("engine,dtype,rescore", [
    ("accum", "int8", None), ("pallas", "int8", True), ("pallas", "int8", False),
    ("pallas", "fp32", False), ("xla", "int8", False), ("accum", "bf16", None),
    ("accum", "fp32", None), ("pallas", "bf16", True), ("pallas", "bf16", False)])
def test_brute_force_index_card_equals_cpu(dev, engine, dtype, rescore):
    base, queries = make_synthetic(3000, 40, 64, 8, seed=5)
    kw = dict(metric="l2", dtype=dtype, engine=engine, rescore=rescore)
    got = BruteForceIndex(base, device=dev, **kw).search_device(
        torch.from_numpy(queries).to(dev), 10)
    want = BruteForceIndex(base, device="cpu", **kw).search_device(
        torch.from_numpy(queries), 10)
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


SHARDED_IVF_RUNS = {
    "auto": dict(mode="cluster"),  # K1, the planes join
    "pallas": dict(mode="cluster", engine="pallas"),  # K6 over each shard's walk
    "recover": dict(mode="cluster", qcap=4, recover=True, recover_qcap=16,
                    recover_passes=2),  # K1, then K6 over the compacted lists
    "query": dict(mode="query"),  # fine_scan, plain torch
}


@pytest.mark.parametrize("run", list(SHARDED_IVF_RUNS))
def test_sharded_ivf_card_equals_cpu(dev, run):
    base, queries = make_synthetic(3000, 40, 64, 8, seed=5)
    src = IVFIndex.build(base, nlist=12, metric="l2", dtype="int8", pad_block=256,
                         max_iter=5, device="cpu")
    kw = SHARDED_IVF_RUNS[run]

    def search(device):
        idx = IVFIndex.from_arrays(src._centroids_np, src._vectors_np, src._offsets_np,
                                   src._reorder_np, metric="l2", dtype="int8", pad_block=256,
                                   config=src.config, device=device)
        sh = ShardedIVFIndex(idx, [torch.device(device)] * 3)
        out = sh.search_device(torch.from_numpy(queries).to(device), 10, 4, **kw)
        return [x.cpu() for x in out], sh.last_spill

    launches = (ivf_accum.LAUNCHES, ivf_scan.CLUSTER_LAUNCHES)
    got, spill = search(dev)
    torch.cuda.synchronize()
    k1, k6 = ivf_accum.LAUNCHES - launches[0], ivf_scan.CLUSTER_LAUNCHES - launches[1]
    want, want_spill = search("cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if run != "query":
        assert int(spill) == int(want_spill)
    assert (k1 == 3) == (run in ("auto", "recover")) and (k6 > 0) == (run in ("pallas",
                                                                              "recover"))


@pytest.mark.parametrize("rescore", [False, True])
def test_sharded_brute_card_equals_cpu(dev, rescore):
    base, queries = make_synthetic(3001, 40, 64, 8, seed=6)
    kw = dict(metric="l2", dtype="int8", rescore=rescore)
    before = bruteforce_fused.LAUNCHES
    got = ShardedBruteForceIndex(base, [dev] * 3, **kw).search_device(
        torch.from_numpy(queries).to(dev), 10)
    torch.cuda.synchronize()
    assert bruteforce_fused.LAUNCHES == before + 3
    want = ShardedBruteForceIndex(base, ["cpu"] * 3, **kw).search_device(
        torch.from_numpy(queries), 10)
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])


# K8 shapes (M, K, N): M < 16, K not a multiple of 32 (nor of 16 for int8),
# N not a multiple of 8 (nor even), several C tiles and K tiles, one row;
# and the float kernels' edges: M 1, 65 and 9 * 128 + 1 (a ragged run of
# the f32 kernel's tile order), N off a multiple of 8 and 2 * 256 + 1, K 8,
# 72 (a 64-K stage and a tail) and 4096.
K8_SHAPES = {"m8": (8, 40, 30), "k96": (130, 96, 257), "k50": (257, 50, 1000),
             "row": (1, 3, 5), "tiles": (300, 517, 129), "wide": (64, 128, 4099),
             "m1k72": (1, 72, 257), "m65k8": (65, 8, 30),
             "m1153k4096": (1153, 4096, 513)}


def _k8_inputs(rng, dtype, m, k, n):
    if dtype == "int8":
        return (torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)),
                torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)))
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    return (a.to(torch.bfloat16), b.to(torch.bfloat16)) if dtype == "bf16" else (a, b)


def _assert_k8(got, want, a, b):
    """int8 exact; floats within the worst-case bound of an fp32 sum of K
    products in any order, 2·K·2**-24·(|A| @ |B|), for the two sums."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.int32:
        assert torch.equal(got, want)
        return
    bound = 2.0 * a.shape[1] * 2.0**-24 * (a.double().abs() @ b.double().abs())
    assert ((got.double() - want.double()).abs() <= bound).all()


@pytest.mark.parametrize("shape", list(K8_SHAPES))
@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32"])
def test_k8_kernel_equal_to_plain(dev, shape, dtype):
    a, b = _k8_inputs(np.random.default_rng(41), dtype, *K8_SHAPES[shape])
    a, b = a.to(dev), b.to(dev)
    before = dict(tiled_matmul.LAUNCHES)
    got = tiled_matmul.tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert tiled_matmul.LAUNCHES == {**before, dtype: before[dtype] + 1}
    _assert_k8(got, tiled_matmul.tiled_matmul_reference(a, b), a, b)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32"])
def test_k8_kernel_unaligned_views(dev, dtype):
    """Contiguous views that start off the kernels' 16-byte alignment (TMA's
    and cp.async's) are copied, not misread."""
    a, b = _k8_inputs(np.random.default_rng(42), dtype, 65, 128, 77)

    def shifted(x, off):
        out = torch.empty(x.numel() + off, dtype=x.dtype, device=dev)[off:].view(x.shape)
        return out.copy_(x)

    a, b = shifted(a, 3), shifted(b, 1)
    assert a.data_ptr() % 16 and b.data_ptr() % (4 if dtype == "int8" else 16)
    _assert_k8(tiled_matmul.tiled_matmul(a, b), tiled_matmul.tiled_matmul_reference(a, b), a, b)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32"])
def test_k8_kernel_on_every_card(dev, dtype):
    """K8 on each card in turn, each after another card has run it: a
    kernel's launch attributes (the float kernels' dynamic shared memory)
    belong to one device."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    a, b = _k8_inputs(np.random.default_rng(46), dtype, 130, 96, 257)
    want = tiled_matmul.tiled_matmul_reference(a, b)
    for i in range(torch.cuda.device_count()):
        card = torch.device("cuda", i)
        got = tiled_matmul.tiled_matmul(a.to(card), b.to(card))
        torch.cuda.synchronize(card)
        _assert_k8(got.cpu(), want, a, b)


def test_k8_kernel_refuses_what_it_does_not_take(dev):
    a = torch.zeros((16, 32), dtype=torch.int8, device=dev)
    b = torch.zeros((32, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tiled_matmul.tiled_matmul(a, b.t().contiguous().t())
    with pytest.raises(ValueError, match="one device"):
        tiled_matmul.tiled_matmul(a, b.cpu())
    with pytest.raises(ValueError, match="dtype mismatch"):
        tiled_matmul.tiled_matmul(a, b.float())
    with pytest.raises(ValueError, match="unsupported dtype"):
        tiled_matmul.tiled_matmul(a.to(torch.int16), b.to(torch.int16))


def _k10_defined(variant, bc, bl):
    if variant == "fixedout":
        return torch.zeros(1, dtype=torch.long, device=bc.device)
    if variant == "maxonly":
        return torch.unique(bc.long())
    return torch.unique(bc[bl > 0].long())


@pytest.mark.parametrize("sizes,blk,qcap,d,k,ties", [
    ([2000, 0, 5000, 129, 10], 2048, 40, 128, 20, False),  # 3-block cluster, dummy tail
    ([700, 300, 129, 2000, 90], 256, 100, 37, 32, False),  # ragged qcap tile, d % 4 != 0
    ([3000, 2100, 40, 2500], 2048, 24, 128, 20, True),     # heavy ties
], ids=["blk2048", "blk256", "ties"])
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_k10_kernel_equal_to_plain_and_full_to_k6(dev, sizes, blk, qcap, d, k, ties, variant):
    rng = np.random.default_rng(43)
    qg, vt, bc, bf, bl, rv, _, _ = (None if x is None else torch.from_numpy(x).to(dev)
                                    for x in _k6_inputs(rng, sizes, blk, qcap, d, ties,
                                                        "dense", False))
    for cut in (len(bc), int(torch.nonzero(rv).max()) + 1):
        # The whole walk (its last blocks are dummies without rows, so
        # fixedout's window holds -inf), and the walk cut after its last
        # block with rows.
        tabs = (x[:cut] for x in (vt, bc, bf, bl, rv))
        args = (qg, *tabs, k, blk, 128, variant)
        before = kernel_lab.LAUNCHES
        pv, pr = kernel_lab._variant_scan(*args)
        rv_, rr = kernel_lab._variant_scan_reference(*args)
        torch.cuda.synchronize()
        assert kernel_lab.LAUNCHES == before + 1
        win = _k10_defined(variant, bc[:cut], bl[:cut])
        assert torch.equal(pv[win], rv_[win])
        fin = rv_[win] > float("-inf")
        assert fin.any() or (variant == "fixedout" and cut == len(bc))
        assert torch.equal(pr[win][fin], rr[win][fin])
        if variant == "full":
            kv, ki = ivf_scan.cluster_major_scan(*args[:6], k, blk=blk, bin_depth=2)
            assert torch.equal(pv[win], kv[win]) and torch.equal(pr[win][fin], ki[win][fin])


@pytest.mark.parametrize("sizes,blk,qcap,d", FLOAT_SHAPES, ids=FLOAT_SHAPE_IDS)
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_k10_kernel_float_equal_to_plain(dev, sizes, blk, qcap, d, dtype, variant):
    """K10's float modes on each variant's defined windows, the walk cut
    after its last block with rows."""
    rng = np.random.default_rng(30)
    qg, vt, bc, bf, bl, rv, _, _ = _k6_inputs(rng, sizes, blk, qcap, d, False, "dense", False)
    qg[:, ::7] = 0
    cut = int(np.nonzero(rv)[0].max()) + 1
    qg, vt = _as_float(dev, dtype, qg, vt[:cut])
    tabs = [torch.from_numpy(x[:cut]).to(dev) for x in (bc, bf, bl, rv)]
    args = (qg, vt, *tabs, 20, blk, 128, variant)
    before = kernel_lab.LAUNCHES
    pv, pr = kernel_lab._variant_scan(*args)
    torch.cuda.synchronize()
    assert kernel_lab.LAUNCHES == before + 1
    rv_, rr = kernel_lab._variant_scan_reference(*args)
    win = _k10_defined(variant, tabs[0], tabs[2])
    assert torch.equal(_bits(pv[win]), _bits(rv_[win]))
    fin = rv_[win] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[win][fin], rr[win][fin])


def test_k10_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(44)
    qg, vt, bc, bf, bl, rv, _, _ = (None if x is None else torch.from_numpy(x).to(dev)
                                    for x in _k6_inputs(rng, [100], 128, 8, 16, False, "dense",
                                                        False))
    with pytest.raises(ValueError, match="one dtype"):
        kernel_lab._variant_scan(qg.float(), vt.bfloat16(), bc, bf, bl, rv, 4, 128, 128,
                                 "full")
    with pytest.raises(ValueError, match="one device"):
        kernel_lab._variant_scan(qg, vt, bc.cpu(), bf, bl, rv, 4, 128, 128, "maxonly")
    with pytest.raises(ValueError, match="contiguous"):
        kernel_lab._variant_scan(qg, vt.transpose(1, 2).contiguous().transpose(1, 2), bc, bf,
                                 bl, rv, 4, 128, 128, "full")
    with pytest.raises(ValueError):  # more than 32 per row
        kernel_lab._variant_scan(qg, vt, bc, bf, bl, rv, 33, 128, 128, "nogate")


@pytest.mark.parametrize("pallas", [True, False], ids=["k8", "plain"])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32"])
def test_spatial_matmul_card_grid_equals_cpu(dev, dtype, pallas):
    """A logical 2x2 grid on one card against the CPU grid."""
    a, b = _k8_inputs(np.random.default_rng(45), dtype, 128, 128, 2560)
    before = sum(tiled_matmul.LAUNCHES.values())
    got = spatial_matmul(a.to(dev), b.to(dev), [[dev] * 2] * 2, use_pallas_kernel=pallas)
    torch.cuda.synchronize()
    assert sum(tiled_matmul.LAUNCHES.values()) == before + (4 if pallas else 0)
    want = spatial_matmul(a, b, [[torch.device("cpu")] * 2] * 2, use_pallas_kernel=pallas)
    _assert_k8(got.cpu(), want, a, b)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32"])
def test_spatial_matmul_distinct_cards_equals_cpu(dtype):
    """The spatial GEMM over a grid of distinct cards (2x2 from four, else
    1x2), each position through K8, against the CPU grid."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    rows, cols = (2, 2) if torch.cuda.device_count() >= 4 else (1, 2)
    a, b = _k8_inputs(np.random.default_rng(47), dtype, 128, 128, 2560)
    before = sum(tiled_matmul.LAUNCHES.values())
    got = spatial_matmul(a, b, make_mesh_2d(rows, cols), use_pallas_kernel=True)
    torch.cuda.synchronize()
    assert sum(tiled_matmul.LAUNCHES.values()) == before + rows * cols
    want = spatial_matmul(a, b, [[torch.device("cpu")] * cols] * rows, use_pallas_kernel=True)
    _assert_k8(got.cpu(), want, a, b)


def test_bench_gemm_reference_workload(dev):
    res = bench_gemm.run(128, 128, 10240, "int8", iters=10, stack=4, quiet=True)
    assert res["verified"] and res["mesh"] == "1x1" and res["kernel"] == "pallas"
    assert res["device"] == torch.cuda.get_device_name(0) and res["gflops_sustained"] > 0


def _probe_gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _launched(key, before, kernels=1):
    torch.cuda.synchronize()
    assert hw_probe.LAUNCHES[key] == before + kernels


def _rand_op(shape, dtype, gen, dev):
    if dtype == torch.int8:
        return torch.randint(-127, 127, shape, generator=gen, device=dev, dtype=dtype)
    return torch.randn(shape, generator=gen, device=dev, dtype=dtype)


@pytest.mark.parametrize("semantics", hw_probe.SEMANTICS)
@pytest.mark.parametrize("moving", [False, True], ids=["pinned", "moving"])
@pytest.mark.parametrize("g", [1, 7, 300])
def test_k11_kernel_equal_to_plain(dev, g, moving, semantics):
    x = torch.randn((8, 128), generator=_probe_gen(dev, 51), device=dev)
    before = hw_probe.LAUNCHES["K11"]
    got = hw_probe._step_probe(x, g, moving, semantics)
    _launched("K11", before)
    assert torch.equal(got, hw_probe._step_probe_reference(x, g, moving, semantics))


def _k12_against_plain(x, data, blk, fat, gemm, semantics, tops):
    """K12's value and whole per-step buffer (NaN where no CTA wrote)
    against the plain version; without the product the plain version must
    find the planted maxima.  bf16 products: each step within
    2·d·2**-24·max(|x| @ |tile|) over its tiles."""
    want = hw_probe._stream_steps_reference(x, data, fat, gemm)
    if not gemm:
        assert torch.equal(want, tops)
    before = hw_probe.LAUNCHES["K12"]
    steps = hw_probe._stream_steps(x, data, blk, fat, gemm, semantics)
    got = hw_probe._stream_probe(x, data, blk, fat, gemm, semantics)
    _launched("K12", before, 2)
    if data.dtype == torch.bfloat16 and gemm:
        nb, d, _ = data.shape
        prod = torch.matmul(x.double().abs(),
                            data.double().abs().reshape(nb // fat, fat, d, blk))
        tol = 2.0 * d * 2.0**-24 * prod.amax(dim=(1, 2, 3))
        assert bool(((steps.double() - want.double()).abs() <= tol).all())
        assert abs(float(got[0]) - float(want[-1])) <= float(tol[-1])
    else:
        assert torch.equal(steps, want) and torch.equal(got, want[-1:])
    assert torch.equal(hw_probe._stream_probe_reference(x, data, blk, fat, gemm, semantics),
                       want[-1:])


@pytest.mark.parametrize("semantics", hw_probe.SEMANTICS)
@pytest.mark.parametrize("fat", [1, 3])
@pytest.mark.parametrize("gemm", [False, True], ids=["max", "gemm"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_k12_kernel_equal_to_plain(dev, dtype, gemm, fat, semantics):
    # Ragged: 9 blocks of [36, 301] (steps start off 16-byte boundaries) or,
    # with the product, [36, 300] (column slices end mid-tile), x [100, 36];
    # every step holds a planted max, an earlier step the walk's.
    blk = 300 if gemm else 301
    gen = _probe_gen(dev, 52)
    data, tops = hw_probe._planted_walk(9, 36, blk, fat, dtype, gen)
    x = _rand_op((100, 36), dtype, gen, dev)
    _k12_against_plain(x, data, blk, fat, gemm, semantics, tops)


@pytest.mark.parametrize("semantics", [None, "arbitrary"])
@pytest.mark.parametrize("gemm", [False, True], ids=["max", "gemm"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_k12_kernel_equal_to_plain_at_jax_width(dev, dtype, gemm, semantics):
    # d = 128, blk = 2048, x [128, 128]: the probe's shapes over 64 blocks,
    # fat 4, planted step maxima.
    gen = _probe_gen(dev, 55)
    data, tops = hw_probe._planted_walk(64, 128, 2048, 4, dtype, gen)
    x = _rand_op((128, 128), dtype, gen, dev)
    _k12_against_plain(x, data, 2048, 4, gemm, semantics, tops)


@pytest.mark.parametrize("depth", [1, 3, 8])
@pytest.mark.parametrize("shape", [(11, 24, 40), (70, 128, 2048)], ids=["ragged", "18MB"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_k13_kernel_equal_to_plain(dev, dtype, shape, depth):
    # One value planted at a time above the bulk: past the walk (where
    # blocks lie past it) a decoy the walk must not return, then in the
    # walk at its first and last element and at 8 seeded random ones; at
    # 18 MB each CTA's ring wraps.
    gen = _probe_gen(dev, 53)
    data = _rand_op(shape, dtype, gen, dev)
    plant, decoy = (127, 127) if dtype == torch.int8 else (64.0, 128.0)
    x = torch.zeros((8, 128), device=dev)
    flat = data.view(-1)
    walked = hw_probe._dma_blocks(data, depth) * data[0].numel()
    trials = [(p, plant) for p in [0, walked - 1]
              + torch.randint(walked, (8,), generator=gen, device=dev).tolist()]
    if walked < flat.numel():
        trials.insert(0, (flat.numel() - 1, decoy))
    for pos, val in trials:
        old = flat[pos].clone()
        flat[pos] = val
        want = hw_probe._dma_probe_reference(x, data, depth)
        assert (float(want[0]) == val) == (pos < walked)
        before = hw_probe.LAUNCHES["K13"]
        got = hw_probe._dma_probe(x, data, depth)
        _launched("K13", before, 2)
        assert torch.equal(got, want), (pos, val)
        flat[pos] = old


@pytest.mark.parametrize("sel", [False, True], ids=["max", "sel"])
@pytest.mark.parametrize("g", [1, 37])
@pytest.mark.parametrize("tb,tn,d", [(200, 300, 96), (256, 2048, 128)])
@pytest.mark.parametrize("dtype,unit", [(torch.int8, "mma"), (torch.int8, "dp4a"),
                                        (torch.bfloat16, "mma")])
def test_k14_kernel_equal_to_plain(dev, dtype, unit, tb, tn, d, g, sel):
    # The value and every step's max (NaN where no CTA wrote); bf16 each
    # step within 2·d·2**-24·max(|twisted q| @ |v|).
    gen = _probe_gen(dev, 54)
    q, v = _rand_op((tb, d), dtype, gen, dev), _rand_op((d, tn), dtype, gen, dev)
    x = torch.zeros((8, 128), device=dev)
    before = hw_probe.LAUNCHES["K14"]
    got = hw_probe._gemm_rate_probe(x, q, v, g, tb, tn, sel, unit)
    steps = hw_probe._gemm_rate_steps(q, v, g, tb, tn, sel, unit)
    _launched("K14", before, 4)
    want = hw_probe._gemm_rate_steps_reference(q, v, g, tb, tn, sel, unit)
    assert torch.equal(hw_probe._gemm_rate_probe_reference(x, q, v, g, tb, tn, sel, unit),
                       want[-1:])
    if dtype == torch.int8:
        assert torch.equal(got, want[-1:]) and torch.equal(steps, want)
    else:
        qx = hw_probe._twisted_q(q, torch.arange(g, device=dev), torch.float64)
        tol = 2.0 * d * 2.0**-24 * (qx.abs() @ v.double().abs()).amax(dim=(1, 2))
        assert bool(((steps.double() - want.double()).abs() <= tol).all())
        assert abs(float(got[0]) - float(want[-1])) <= float(tol[-1])


def test_probe_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((8, 128), device=dev)
    data = torch.zeros((8, 3, 5), dtype=torch.int8, device=dev)  # 15-byte blocks
    with pytest.raises(ValueError):
        hw_probe._dma_probe(x, data, 1)
    with pytest.raises(ValueError):
        hw_probe._dma_probe(x, torch.zeros((9, 4, 4), dtype=torch.int8, device=dev), 9)
    with pytest.raises(ValueError):  # the product wants d·elem a multiple of 4
        hw_probe._stream_probe(torch.zeros((4, 3), dtype=torch.int8, device=dev), data, 5, 1,
                               True, None)
    with pytest.raises(ValueError):
        hw_probe._gemm_rate_probe(x, torch.zeros((4, 1024), dtype=torch.int8, device=dev),
                                  torch.zeros((1024, 8), dtype=torch.int8, device=dev), 2, 4, 8,
                                  False)
    with pytest.raises(ValueError):
        hw_probe._step_probe(x[:, :64], 4, True, None)


def test_probe_cli_runs_at_toy_sizes_on_the_card(dev, capsys):
    before = hw_probe.LAUNCHES["K14"]
    res = hw_probe.probe_pallas_gemm(repeats=1, device=dev, shapes=((128, 256),), gs=(4, 8))
    assert len(res) == 3 and all(v > 0 for v in res.values())
    # Six timings of one call, each 2 warm-up calls and 4 replays of the
    # captured one, 2 kernels a call: the count is of launches on the card.
    assert hw_probe.LAUNCHES["K14"] - before == 6 * (2 + 4) * 2
    res = hw_probe.probe_pallas_step(repeats=1, device=dev, grids=(4, 16))
    assert res["launch_us"]["graph"] > 0 and res["launch_us"]["eager"] > 0
