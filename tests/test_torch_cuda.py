"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``cuda`` marker and skips where torch sees no GPU.
This file imports neither jax nor the JAX package, so it runs on a machine
with a card and no JAX::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

from rag_on_edge_tpu_torch.harness import bench_gemm, hw_probe, kernel_lab
from rag_on_edge_tpu_torch.models.brute_force import BruteForceIndex
from rag_on_edge_tpu_torch.models.ivf import IVFIndex
from rag_on_edge_tpu_torch.ops import bruteforce_accum, bruteforce_fused
from rag_on_edge_tpu_torch.ops import _build, block_tables, fused_topk, ivf_accum, ivf_scan
from rag_on_edge_tpu_torch.ops import tiled_matmul, topk
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


# The int8 and bf16 modes' tiling: 128 routed rows (two warpgroups of 64) x
# 64 bins a CTA, the d in units of 128 bytes, the half-chunks past
# rows_valid skipped.
K1_SHAPES = [
    ([2000, 0, 5000, 129], 2048, 40, 128),   # multi-block and empty clusters
    ([700, 300, 129, 2000], 256, 100, 37),   # ragged qcap tile, d % 4 != 0
    ([300, 5, 900], 128, 1, 32),             # one routed row, blk 128, D one k32 step
    ([1500, 0, 40], 512, 63, 33),            # one row short of a warpgroup, D one past
    ([1500, 0, 40], 512, 65, 33),            # one row into the second warpgroup
    ([300, 16 * 128 - 7], 128, 256, 384),    # a cluster of 16 blocks (the code wraps), 3 units
    ([3000, 1000], 512, 256, 512),           # the widest int8 D without bias rows
]
K1_CASES = [pytest.param(*shape, bias, id=f"{'l2bias' if bias else 'ip'}-{i}")
            for i, shape in enumerate(K1_SHAPES) for bias in (False, True)
            if not (bias and shape[3] > ivf_accum.INT8_DIM_MAX_BIAS)]


@pytest.mark.parametrize("sizes,blk,qcap,d,bias", K1_CASES)
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
    ([700, 300], 256, 40, 320),              # the widest D the float modes take
    ([300, 5, 900], 128, 1, 32),             # one routed row, blk 128
    ([1500, 0, 40], 512, 63, 33),            # one row short of a warpgroup
    ([1500, 0, 40], 512, 65, 33),            # one row into the second warpgroup
    ([300, 16 * 128 - 7], 128, 256, 320),    # a cluster of 16 blocks: the code wraps
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


@pytest.mark.parametrize("sizes,blk,qcap,d", [
    ([2000, 0, 5000, 129], 2048, 40, 129),
    ([1500, 0, 40], 512, 65, 33),
])
def test_k1_kernel_bf16_close_to_plain_on_noninteger_data(dev, sizes, blk, qcap, d):
    """bf16 on wgmma sums in another order than the plain fp32 product of
    the same bf16 values.  Each plane value (the key turned back into fp32,
    its 8 low bits ceded to the pack) within the order bound
    2·D·2^-24·(|q|@|b|) plus those bits on both sides, KMIN exactly where the
    plain version has it."""
    rng = np.random.default_rng(17)
    _, _, bf, bl, rv = _k1_inputs(rng, sizes, blk, qcap, d)
    nb = len(bf)
    qg = torch.from_numpy(rng.standard_normal((nb, qcap, d), dtype=np.float32)).to(dev)
    vt = torch.from_numpy(rng.standard_normal((nb, d, blk), dtype=np.float32)).to(dev)
    qg, vt = qg.to(torch.bfloat16), vt.to(torch.bfloat16)
    bf, bl, rv = (torch.from_numpy(x).to(dev) for x in (bf, bl, rv))
    got = ivf_accum.cluster_major_accum_planes(qg, vt, bf, bl, rv, blk=blk)
    want = ivf_accum.cluster_major_accum_planes_reference(qg, vt, bf, bl, rv, blk=blk)
    torch.cuda.synchronize()
    rows = torch.nonzero(bl).flatten()
    got, want = got[rows], want[rows]
    assert torch.equal(got == ivf_accum.KMIN, want == ivf_accum.KMIN)
    order = 2 * d * 2.0**-24 * float(torch.bmm(qg.double().abs(), vt.double().abs()).max())
    ok = want != ivf_accum.KMIN
    gv = ivf_accum._key_to_f32(got[ok]).double()
    wv = ivf_accum._key_to_f32(want[ok]).double()
    assert bool(((gv - wv).abs() <= order + wv.abs() * 2.0**-14).all())


def test_k1_kernel_refuses_float(dev):
    """The float modes the CUDA K1 does not take: operands of two dtypes.
    A D past the old float stage's 320 is taken (d-slices) and equals the
    plain version."""
    rng = np.random.default_rng(15)
    qg, vt, bf, bl, rv = (torch.from_numpy(x).to(dev)
                          for x in _k1_inputs(rng, [100], 128, 8, 16))
    with pytest.raises(ValueError, match="one dtype"):
        ivf_accum.cluster_major_accum_planes(qg.float(), vt.bfloat16(), bf, bl, rv, blk=128)
    wide = torch.ones((qg.shape[0], 8, 330), device=dev)
    wide_t = torch.ones((qg.shape[0], 330, 128), device=dev)
    got = ivf_accum.cluster_major_accum_planes(wide, wide_t, bf, bl, rv, blk=128)
    want = ivf_accum.cluster_major_accum_planes_reference(wide, wide_t, bf, bl, rv, blk=128)
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(got[rows], want[rows])


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


def _k2_mix(w, dtype, b=37):
    """Rows of every kind the passes meet, [b, w] (37 rows: a multiple of
    no CTA's row count).  int32: heavy ties, full-range values, FILL
    (INT32_MIN) and KMIN (INT32_MIN + 1, an empty probe) scattered mid-row,
    rows with 0-24 values above FILL (the later passes repeat the lowest
    FILL position), and an all-FILL row.  float32: ties among -0.0, +0.0 and
    a few values, -inf scattered and in whole rows, normal values."""
    rng = np.random.default_rng(w + (dtype == "f32"))
    if dtype == "int32":
        fill = np.iinfo(np.int32).min
        x = rng.integers(-4, 5, (b, w)).astype(np.int32)
        x[1::4] = rng.integers(fill, 2**31 - 1, (len(range(1, b, 4)), w), dtype=np.int32)
        x[rng.random(x.shape) < 0.05] = fill
        x[rng.random(x.shape) < 0.05] = fill + 1
        x[3::8, w // 3::5] = fill + 1
        sparse = [fill + 1, 0, 7]
    else:
        fill = -np.inf
        x = rng.choice(np.array([-2.0, -1.0, -0.0, 0.0, 1.0, 3.0], np.float32), (b, w))
        x[1::4] = rng.normal(size=(len(range(1, b, 4)), w)).astype(np.float32)
        x[rng.random(x.shape) < 0.05] = fill
        x[3::8, w // 3::5] = -0.0
        sparse = [-0.0, 0.0, 1.0, -1.0]
    for r in range(2, b, 4):
        x[r] = fill
        cols = rng.choice(w, int(rng.integers(0, 25)), replace=False)
        x[r, cols] = rng.choice(np.array(sparse, x.dtype), cols.size)
    x[0] = fill
    return x


K2_CASES = [pytest.param(_ties, 20, id="int32-ties"), pytest.param(_neg_inf, 8, id="f32-neginf"),
            pytest.param(_wide, 20, id="join-shape"), pytest.param(_not_pow2, 20, id="w768")]
K2_CASES += [pytest.param(functools.partial(_k2_mix, w, dtype), k, id=f"{dtype}-w{w}-k{k}")
             for w in (128, 1024, 4096, 8192) for k in (1, 20, 32, 100)
             for dtype in ("int32", "f32")]
K2_CASES += [pytest.param(functools.partial(_k2_mix, 128, "f32"), 128, id="f32-w128-k128"),
             pytest.param(functools.partial(_k2_mix, 16384, "int32"), 40, id="int32-w16384-k40")]


@pytest.mark.parametrize("make,k", K2_CASES)
def test_k2_kernel_equal_to_plain(dev, make, k):
    """Values and positions equal to the plain version's; where a pass took
    a value above FILL, the kernel's value is the element at its position,
    bit for bit (the plain version's max of -0.0 and +0.0 may be either)."""
    x = torch.from_numpy(make()).to(dev)
    before = fused_topk.LAUNCHES
    v, i = fused_topk.fused_topk(x, k)
    rv, ri = fused_topk.fused_topk_reference(x, k)
    torch.cuda.synchronize()
    assert fused_topk.LAUNCHES == before + 1
    assert torch.equal(v, rv) and torch.equal(i, ri)
    bits = (lambda t: t.view(torch.int32)) if x.dtype == torch.float32 else (lambda t: t)
    took = v > topk.fill_value(x.dtype)
    at = bits(torch.gather(x, 1, i.long()))
    assert torch.equal(bits(v)[took], at[took])


def test_k2_kernel_refuses_what_it_does_not_take(dev):
    """What the JAX kernel refuses too: W not a multiple of 128, k past W.
    A row wider than a warp's shared memory holds (16384) is taken in
    segments."""
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_topk.fused_topk(torch.zeros((2, 16500), dtype=torch.int32, device=dev), 4)
    with pytest.raises(ValueError, match="k=200"):
        fused_topk.fused_topk(torch.zeros((2, 128), dtype=torch.int32, device=dev), 200)
    v, i = fused_topk.fused_topk(torch.zeros((2, 16512), dtype=torch.int32, device=dev), 4)
    assert torch.equal(i.cpu(), torch.tensor([[0, 1, 2, 3]] * 2, dtype=torch.int32))


def _k4_inputs(rng, sizes, blk, qcap, d, ties, compact, bias, empty_slots=False):
    """K4 inputs; ``compact`` lays them out as the recovery pass does: the
    blocks of every other cluster in storage order, then the rest with
    zeroed tables, and row_base = block·blk.  ``empty_slots`` zeroes the
    rows of each block from a random count on (0 to qcap), as a routed
    table's empty slots, and row 3 of every other block, so a row can be
    zero in one block of a run and not in the next."""
    qg, vt, bf, bl, rv = _k1_inputs(rng, sizes, blk, qcap, d, *((0, 2) if ties else ()))
    nb = len(bf)
    if empty_slots:
        for b, n in enumerate(rng.integers(0, qcap + 1, nb)):
            qg[b, n:] = 0
        qg[::2, 3:4] = 0
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


# The int8 modes' tiling (wgmma): N = 32 routed rows a CTA (16 for depth >
# 2) x the 128 bins of a chunk, d in units of 128 bytes, the chunks past
# rows_valid skipped, each block's survivors merged per row.
K4_SHAPES = [
    pytest.param([2000, 0, 5000, 129, 10], 2048, 40, 128, 20, False,
                 id="blk2048"),    # 3-block cluster, -inf fill
    pytest.param([700, 300, 129, 2000], 256, 100, 37, 32, False,
                 id="blk256"),     # ragged qcap tile, d % 4 != 0
    pytest.param([3000, 2100, 40], 2048, 24, 128, 20, True,
                 id="ties"),       # scores 0..128: ties across chunks and blocks of a run
    pytest.param([300, 5, 900], 128, 1, 32, 10, False,
                 id="q1-d32"),     # one routed row, blk 128, D one k32 step
    pytest.param([1500, 0, 40], 512, 63, 1024, 20, False,
                 id="q63-d1024"),  # one row short of 64; 8 units of d
    pytest.param([1500, 40], 512, 64, 512, 20, False,
                 id="q64-d512"),
    pytest.param([1500, 0, 40], 512, 65, 37, 20, False,
                 id="q65-d37"),
    pytest.param([2000, 700], 256, 128, 128, 16, False,
                 id="q128"),
    pytest.param([700, 300], 256, 129, 128, 20, False,
                 id="q129"),
    pytest.param([300, 16 * 128 - 7], 128, 256, 128, 20, False,
                 id="q256-16blocks"),  # a cluster of 16 blocks
    pytest.param([2000, 1000], 128, 33, 32, 20, True,
                 id="ties-blk128"),    # ties across 16 one-chunk blocks of one run
]


@pytest.mark.parametrize("sizes,blk,qcap,d,k,ties", K4_SHAPES)
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("bias", [False, True], ids=["ip", "l2bias"])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_k4_kernel_equal_to_plain(dev, sizes, blk, qcap, d, k, ties, depth, bias, compact):
    rng = np.random.default_rng(19)
    qg, vt, bf, bl, rv, br, rb = (None if x is None else torch.from_numpy(x).to(dev)
                                  for x in _k4_inputs(rng, sizes, blk, qcap, d, ties,
                                                      compact, bias, empty_slots=True))
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


# K4's float modes at the edges of grouped_wgmma_kernel (bf16) and
# grouped_ffma_kernel (fp32): qcap 24, 40, 100 and 257 (tiles of 32 and 16
# rows cut short; 257 one row into a ninth tile), D' 37 and 129 (odd), 320,
# and 384, 768 and 1536 (many fp32 slices and bf16 units).  Values in
# [-8, 7] keep every fp32 sum exact at these D.
K4_FLOAT_EDGES = [
    pytest.param([2000, 0, 5000, 129, 10], 2048, 257, 129, id="q257-d129"),
    pytest.param([700, 300, 129, 2000], 256, 24, 37, id="q24-d37"),
    pytest.param([700, 300, 129], 256, 40, 320, id="q40-d320"),
    pytest.param([1500, 0, 40], 512, 100, 384, id="q100-d384"),
    pytest.param([700, 300, 129], 256, 40, 768, id="q40-d768"),
    pytest.param([300, 16 * 128 - 7], 128, 24, 1536, id="q24-d1536-16blocks"),
]


@pytest.mark.parametrize("sizes,blk,qcap,d", K4_FLOAT_EDGES)
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [20, 33, 64])
@pytest.mark.parametrize("walk", ["dense-pitched", "compact"])
def test_k4_kernel_float_edges_equal_to_plain(dev, sizes, blk, qcap, d, dtype, depth, k, walk):
    """K4's float modes (bf16 on wgmma, fp32 on the FFMA tile) with empty
    slots from a random count on in every block: the dense walk with the
    routed rows handed over as a pitched view whose pad holds NaN (read in
    place: no kernel reads past a row's D'), and a compacted recovery list;
    k past 32 in passes.  pv bit-equal, pr equal where finite."""
    rng = np.random.default_rng(33)
    qg, vt, bf, bl, rv, _, rb = _k4_inputs(rng, sizes, blk, qcap, d, False, walk == "compact",
                                           False, empty_slots=True)
    qg, vt = _as_float(dev, dtype, qg // 16, vt // 16)
    if walk == "dense-pitched":
        storage = _build.pad_rows(qg, 16 // qg.element_size())
        storage[..., d:] = float("nan")
        qg = storage[..., :d]
        assert ivf_scan.float_operands("K4", qg, vt)[0].data_ptr() == qg.data_ptr()
    bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (bf, bl, rv, rb))
    kw = dict(k=k, blk=blk, bin_depth=depth, row_base=rb)
    before = ivf_scan.LAUNCHES
    pv, pr = ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES - before == -(-k // 32)
    rv_, rr = ivf_scan.cluster_major_scan_grouped_reference(qg, vt, bf, bl, rv, **kw)
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(_bits(pv[rows]), _bits(rv_[rows]))
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


def _noninteger(rng, dev, dtype, *shapes):
    """Normal values of the given shapes as ``dtype`` on ``dev``."""
    return tuple(torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(
        dev, FLOAT_DTYPES[dtype]) for sh in shapes)


def _order_bound(q, vt, d):
    """2·D·2^-24·(|q|@|v|), each row's max over every block's slab v: two
    fp32 sums of D products (exact in fp32 for bf16 operands) in any order
    differ by no more."""
    v = vt.double().abs().amax(dim=0, keepdim=True)
    return 2.0 * d * 2.0**-24 * torch.matmul(q.double().abs(), v).amax(dim=-1, keepdim=True)


@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
def test_k6_kernel_float_close_to_plain_on_noninteger_data(dev, dtype):
    """K6's float modes sum in another order than the plain fp32 product
    (bf16: the tensor cores' order) on non-integer data: within the order
    bound, ids equal where values stand apart."""
    rng = np.random.default_rng(29)
    _, _, bc, bf, bl, rv, _, rb = _k6_inputs(rng, [700, 300, 129, 2000, 90], 256, 100, 129,
                                             False, "dense", False)
    qg, vt = _noninteger(rng, dev, dtype, (9, 100, 129), (len(bc), 129, 256))
    bc, bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (bc, bf, bl, rv, rb))
    kw = dict(k=20, blk=256, row_base=rb)
    pv, pr = ivf_scan.cluster_major_scan(qg, vt, bc, bf, bl, rv, **kw)
    rv_, rr = ivf_scan.cluster_major_scan_reference(qg, vt, bc, bf, bl, rv, **kw)
    last = torch.nonzero(bl).flatten()
    rows = bc[last].long()
    _assert_topk_close(pv[rows], pr[rows], rv_[rows], rr[rows], _order_bound(qg[rows], vt, 129))


@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
def test_k7_kernel_float_close_to_plain_on_noninteger_data(dev, dtype):
    """K7's float modes on non-integer data, as K6's."""
    rng = np.random.default_rng(30)
    _, cqb, _, _, bf, bl, rv, _, rb, _ = _k7_inputs(rng, [2000, 0, 5000, 129, 10], 2048, 40,
                                                    129, False, False, False)
    qi, vt = _noninteger(rng, dev, dtype, (300, 129), (len(bf), 129, 2048))
    cqb, bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (cqb, bf, bl, rv, rb))
    kw = dict(k=20, blk=2048, row_base=rb)
    pv, pr = ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, **kw)
    rv_, rr = ivf_scan.cluster_major_scan_routed_reference(qi, cqb, vt, bf, bl, rv, **kw)
    rows = torch.nonzero(bl).flatten()
    idx = cqb[rows, :, 0].long()
    qg = torch.where(((idx >= 0) & (idx < 300))[..., None], qi[idx.clamp(0, 299)],
                     torch.zeros((), dtype=qi.dtype, device=dev))
    _assert_topk_close(pv[rows], pr[rows], rv_[rows], rr[rows], _order_bound(qg, vt, 129))


def _assert_scan_equal(got, want, rows):
    """A scan's (pv, pr) against the plain version's at output rows ``rows``:
    pv bit-equal, pr equal where finite."""
    (pv, pr), (rv_, rr) = got, want
    assert torch.equal(_bits(pv[rows]), _bits(rv_[rows]))
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])


def test_k4_kernel_refuses_what_it_does_not_take(dev):
    """Operands of two float dtypes; a bin depth past 4 and bins other than
    128, once refused, equal the plain version (the general selection)."""
    rng = np.random.default_rng(20)
    qg, vt, bf, bl, rv, _, _ = (None if x is None else torch.from_numpy(x).to(dev)
                                for x in _k4_inputs(rng, [100], 128, 8, 16, False, False,
                                                    False))
    with pytest.raises(ValueError, match="one dtype"):
        ivf_scan.cluster_major_scan_grouped(qg.float(), vt.bfloat16(), bf, bl, rv, 4, blk=128)
    for kw in (dict(bin_depth=5), dict(nbins=64)):
        _assert_scan_equal(
            ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, 4, blk=128, **kw),
            ivf_scan.cluster_major_scan_grouped_reference(qg, vt, bf, bl, rv, 4, blk=128, **kw),
            torch.nonzero(bl).flatten())


def _k6_inputs(rng, sizes, blk, qcap, d, ties, walk, bias, empty_slots=False):
    """K6 inputs laid out as one shard of ShardedIVFIndex: clusters 2.. of
    nlist = len(sizes) + 4 (global ids), padded to 8 blocks with dummies on
    the last one.  ``walk`` "cut" and "parked" lay them out as the recovery
    pass does: every other cluster's blocks in storage order, cut one block
    short of them all (that cluster emits nothing) or followed by two more
    blocks with zeroed tables, parked on the last listed block's cluster;
    row_base = block·blk.  ``empty_slots`` zeroes each cluster's rows from
    a random count on (0 to qcap), as a routed table's empty slots."""
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
    if empty_slots:
        for c, n in enumerate(rng.integers(0, qcap + 1, nlist)):
            qg[c, n:] = 0
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


# The int8 mode's tiling is K4's (wgmma, N = 32 routed rows a CTA, 16 for
# depth > 2): K4's cases, each with at least two clusters that the recovery
# walks keep (every other one), and with empty (zero) slots.
K6_SHAPES = [
    pytest.param([2000, 0, 5000, 129, 10], 2048, 40, 128, 20, False, False,
                 id="blk2048"),    # 3-block cluster, -inf fill
    pytest.param([700, 300, 129, 2000, 90], 256, 100, 37, 32, False, False,
                 id="blk256"),     # ragged qcap tile, d % 4 != 0
    pytest.param([3000, 2100, 40, 2500], 2048, 24, 128, 20, True, False,
                 id="ties"),       # scores 0..128: heavy ties
    pytest.param([2000, 0, 5000, 129, 10], 2048, 40, 128, 20, False, True,
                 id="blk2048-empty"),
    pytest.param([3000, 2100, 40], 2048, 24, 128, 20, True, True,
                 id="ties-empty"),  # ties across chunks and blocks of a run
    pytest.param([300, 5, 900], 128, 1, 32, 10, False, True,
                 id="q1-d32"),     # one routed row, blk 128, D one k32 step
    pytest.param([1500, 0, 40], 512, 63, 1024, 20, False, True,
                 id="q63-d1024"),  # one row short of 64; 8 units of d
    pytest.param([1500, 40, 600], 512, 64, 512, 20, False, True,
                 id="q64-d512"),
    pytest.param([1500, 0, 40], 512, 65, 37, 20, False, True,
                 id="q65-d37"),
    pytest.param([2000, 700, 300], 256, 128, 128, 16, False, True,
                 id="q128"),
    pytest.param([700, 300, 129], 256, 129, 128, 20, False, True,
                 id="q129"),
    pytest.param([16 * 128 - 7, 300, 500], 128, 256, 128, 20, False, True,
                 id="q256-16blocks"),  # a cluster of 16 blocks, kept by the recovery walks
    pytest.param([2000, 1000, 700], 128, 33, 32, 20, True, True,
                 id="ties-blk128"),    # ties across 16 one-chunk blocks of one run
]


@pytest.mark.parametrize("sizes,blk,qcap,d,k,ties,empty", K6_SHAPES)
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("bias", [False, True], ids=["ip", "l2bias"])
@pytest.mark.parametrize("walk", ["dense", "cut", "parked"])
def test_k6_kernel_equal_to_plain(dev, sizes, blk, qcap, d, k, ties, empty, depth, bias, walk):
    rng = np.random.default_rng(21)
    qg, vt, bc, bf, bl, rv, br, rb = (None if x is None else torch.from_numpy(x).to(dev)
                                      for x in _k6_inputs(rng, sizes, blk, qcap, d, ties,
                                                          walk, bias, empty_slots=empty))
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
# and 320 (the widest the float stage holds), qcap off the row tile; three
# clusters or more, so a recovery walk cut short still emits one.
FLOAT_SHAPES = [([2000, 0, 5000, 129, 10], 2048, 40, 129),
                ([700, 300, 129, 2000, 90], 256, 100, 37),
                ([700, 300, 129], 256, 24, 320)]
FLOAT_SHAPE_IDS = ["d129", "d37", "d320"]


def _as_float(dev, dtype, *arrays):
    """int8 arrays (values in [-127, 127]: exact in bf16, exact fp32 sums
    up to D=320) as ``dtype`` tensors on ``dev``."""
    return tuple(torch.from_numpy(x).to(dev, FLOAT_DTYPES[dtype]) for x in arrays)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_plus_zero(pv):
    """The finite scores of zero routed rows (no bias) are +0, bit for bit."""
    fin = pv > float("-inf")
    assert fin.any() and bool((pv[fin].float().view(torch.int32) == 0).all())


@pytest.mark.parametrize("sizes,blk,qcap,d", FLOAT_SHAPES, ids=FLOAT_SHAPE_IDS)
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("walk", ["dense", "cut", "parked"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [20, 33, 64])
def test_k6_kernel_float_bit_equal_to_plain(dev, sizes, blk, qcap, d, dtype, walk, depth, k):
    """K6's float modes (bf16 on wgmma, fp32 on the FFMA tile) over a
    shard's walk and a recovery list, cut or with its parked tail; k past
    32 in passes; every 7th routed row is zero, as an empty slot: it scores
    +0."""
    rng = np.random.default_rng(27)
    qg, vt, bc, bf, bl, rv, _, rb = _k6_inputs(rng, sizes, blk, qcap, d, False, walk, False)
    qg[:, ::7] = 0
    qg, vt = _as_float(dev, dtype, qg, vt)
    bc, bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (bc, bf, bl, rv, rb))
    kw = dict(k=k, blk=blk, bin_depth=depth, row_base=rb)
    before = (ivf_scan.CLUSTER_LAUNCHES, ivf_scan.LAUNCHES)
    pv, pr = ivf_scan.cluster_major_scan(qg, vt, bc, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert (ivf_scan.CLUSTER_LAUNCHES, ivf_scan.LAUNCHES) == (before[0] + -(-k // 32),
                                                              before[1])
    rv_, rr = ivf_scan.cluster_major_scan_reference(qg, vt, bc, bf, bl, rv, **kw)
    rows = bc[torch.nonzero(bl).flatten()].long()
    assert torch.equal(_bits(pv[rows]), _bits(rv_[rows]))
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])
    _assert_plus_zero(pv[rows][:, ::7])


def test_k6_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(22)
    qg, vt, bc, bf, bl, rv, _, _ = (None if x is None else torch.from_numpy(x).to(dev)
                                    for x in _k6_inputs(rng, [100], 128, 8, 16, False, "dense",
                                                        False))
    with pytest.raises(ValueError, match="one dtype"):
        ivf_scan.cluster_major_scan(qg.float(), vt.bfloat16(), bc, bf, bl, rv, 4, blk=128)
    # Once refused: bins other than 128, a depth past 4, fp32 past 256
    # chunks a block (a chunk in a byte then; 16 bits now).
    rows = bc[torch.nonzero(bl).flatten()].long()
    wide = torch.zeros((len(bc), 16, 32896), device=dev)
    wide[..., :128] = vt.float()
    for args, kw in (((qg, vt), dict(blk=128, nbins=64)), ((qg, vt), dict(blk=128, bin_depth=5)),
                     ((qg.float(), wide), dict(blk=32896))):
        _assert_scan_equal(
            ivf_scan.cluster_major_scan(*args, bc, bf, bl, rv, 4, **kw),
            ivf_scan.cluster_major_scan_reference(*args, bc, bf, bl, rv, 4, **kw), rows)


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


@pytest.mark.parametrize("sizes,blk,qcap,d,k,ties", K4_SHAPES)
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
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [20, 33, 64])
def test_k7_kernel_float_bit_equal_to_plain(dev, sizes, blk, qcap, d, dtype, compact, depth, k):
    """K7's float modes: the routed rows gathered from the batch [B, D']
    (D' odd: the wrapper pads the rows to a 16-byte pitch) through
    cq_blocks; a slot past the batch and the -1 slots give zero rows; k past
    32 in passes."""
    rng = np.random.default_rng(28)
    qi, cqb, vt, _, bf, bl, rv, _, rb, _ = _k7_inputs(rng, sizes, blk, qcap, d, False,
                                                      compact, False)
    qi, vt = _as_float(dev, dtype, qi, vt)
    cqb, bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (cqb, bf, bl, rv, rb))
    kw = dict(k=k, blk=blk, bin_depth=depth, row_base=rb)
    before = (ivf_scan.ROUTED_LAUNCHES, ivf_scan.LAUNCHES)
    pv, pr = ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert (ivf_scan.ROUTED_LAUNCHES, ivf_scan.LAUNCHES) == (before[0] + -(-k // 32),
                                                             before[1])
    rv_, rr = ivf_scan.cluster_major_scan_routed_reference(qi, cqb, vt, bf, bl, rv, **kw)
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(_bits(pv[rows]), _bits(rv_[rows]))
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])


# The float kernels' edges: (sizes, blk, qcap, D', depth).  qcap 257 runs
# one row into a fifth 64-row (fp32) and ninth 32-row (bf16) tile, its empty
# slots making all-zero tiles; D' 384, 768 and 1536 (sentence-embedding
# widths, with L2's column left out) pass the fp32 slice of 32 and bf16's
# 64-dim unit many times; 2100 and 4000 hold bf16's routed rows out of
# shared memory (read a unit at a time) at depths 1-2 and 3-4.  Values in
# [-8, 7]: every fp32 sum is exact at these D.
FLOAT_EDGES = [
    pytest.param([2000, 0, 5000, 129, 10], 2048, 257, 129, 2, id="q257-d129"),
    pytest.param([700, 300, 129, 2000, 90], 256, 24, 384, 1, id="q24-d384"),
    pytest.param([700, 300, 129], 256, 40, 768, 3, id="q40-d768"),
    pytest.param([1500, 0, 40], 512, 100, 1536, 2, id="q100-d1536"),
    pytest.param([700, 300, 129], 256, 40, 2100, 2, id="q40-d2100"),
    pytest.param([700, 300, 129], 128, 33, 4000, 4, id="q33-d4000"),
]


@pytest.mark.parametrize("sizes,blk,qcap,d,depth", FLOAT_EDGES)
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_k6_k7_kernel_float_edges_bit_equal_to_plain(dev, sizes, blk, qcap, d, depth, dtype,
                                                     bias, kernel):
    """K6 (empty slots from a random count on, and walks cut short) and K7
    (a compacted list) at the float kernels' edges, ± bias, the routed rows
    handed over as pitched views whose pad holds NaN: no kernel reads past
    a row's D'."""
    rng = np.random.default_rng(31)
    if kernel == "K6":
        qg, vt, bc, bf, bl, rv, br, rb = _k6_inputs(rng, sizes, blk, qcap, d, False, "cut",
                                                    bias, empty_slots=True)
        cqb = None
    else:
        qg, cqb, vt, bc, bf, bl, rv, br, rb, _ = _k7_inputs(rng, sizes, blk, qcap, d, False,
                                                           True, bias)
    q, vt = _as_float(dev, dtype, qg // 16, vt // 16)
    storage = _build.pad_rows(q, 16 // q.element_size())
    storage[..., d:] = float("nan")
    q = storage[..., :d]
    bc, bf, bl, rv, rb = (torch.from_numpy(x).to(dev) for x in (bc, bf, bl, rv, rb))
    br = None if br is None else torch.from_numpy(br).to(dev)
    kw = dict(k=20, blk=blk, bin_depth=depth, row_base=rb, bias=br)
    if kernel == "K6":
        before = ivf_scan.CLUSTER_LAUNCHES
        pv, pr = ivf_scan.cluster_major_scan(q, vt, bc, bf, bl, rv, **kw)
        rv_, rr = ivf_scan.cluster_major_scan_reference(q, vt, bc, bf, bl, rv, **kw)
        launched = ivf_scan.CLUSTER_LAUNCHES - before
        rows = bc[torch.nonzero(bl).flatten()].long()
    else:
        cqb = torch.from_numpy(cqb).to(dev)
        before = ivf_scan.ROUTED_LAUNCHES
        pv, pr = ivf_scan.cluster_major_scan_routed(q, cqb, vt, bf, bl, rv, **kw)
        rv_, rr = ivf_scan.cluster_major_scan_routed_reference(q, cqb, vt, bf, bl, rv, **kw)
        launched = ivf_scan.ROUTED_LAUNCHES - before
        rows = torch.nonzero(bl).flatten()
    torch.cuda.synchronize()
    assert launched == 1 and rows.numel() > 0
    assert torch.equal(_bits(pv[rows]), _bits(rv_[rows]))
    fin = rv_[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[rows][fin], rr[rows][fin])


@pytest.mark.parametrize("sizes,blk,qcap,d", FLOAT_SHAPES, ids=FLOAT_SHAPE_IDS)
@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("depth", [1, 4])
def test_k7_kernel_float_equals_k6_and_k4(dev, sizes, blk, qcap, d, dtype, depth):
    """The three float designs on the same rows: K7 (gathered in the
    kernel), K6 on the per-cluster table ``qi[cq]`` and K4 (the float stage)
    on the per-block table ``qi[cq_blocks]`` give the same values, bit for
    bit, and the same ids."""
    rng = np.random.default_rng(32)
    qi, cqb, vt, bc, bf, bl, rv, _, rb, cq = _k7_inputs(rng, sizes, blk, qcap, d, False, False,
                                                        False)
    qi, vt = _as_float(dev, dtype, qi, vt)
    cqb, cq, bc, bf, bl, rv, rb = (torch.from_numpy(x).to(dev)
                                   for x in (cqb, cq, bc, bf, bl, rv, rb))

    def gathered(idx):
        hit = (idx >= 0) & (idx < qi.shape[0])
        g = qi[torch.where(hit, idx, torch.zeros_like(idx)).long()]
        return torch.where(hit[..., None], g, torch.zeros_like(g)).contiguous()

    kw = dict(k=20, blk=blk, bin_depth=depth, row_base=rb)
    before = (ivf_scan.ROUTED_LAUNCHES, ivf_scan.CLUSTER_LAUNCHES, ivf_scan.LAUNCHES)
    pv, pr = ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, **kw)
    cv, ci = ivf_scan.cluster_major_scan(gathered(cq), vt, bc, bf, bl, rv, **kw)
    gv, gr = ivf_scan.cluster_major_scan_grouped(gathered(cqb[..., 0]), vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert (ivf_scan.ROUTED_LAUNCHES, ivf_scan.CLUSTER_LAUNCHES, ivf_scan.LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    rows = torch.nonzero(bl).flatten()
    out = bc[rows].long()
    fin = pv[rows] > float("-inf")
    assert fin.any()
    assert torch.equal(_bits(cv[out]), _bits(pv[rows]))
    assert torch.equal(_bits(gv[rows]), _bits(pv[rows]))
    assert torch.equal(ci[out][fin], pr[rows][fin]) and torch.equal(gr[rows][fin], pr[rows][fin])


def test_grouped_scan_cubin_bf16_on_wgmma_unserialized(dev):
    """The build report of ``csrc/ivf_grouped_scan.cu`` (``chip_smoke.py``'s
    ``wgmma_report``, which raises on a missing instance, a bf16 instance
    without bf16 ``wgmma``, ptxas serializing its groups, C7520, or any
    ``__dp4a``): the bf16 instances of K4, K6 and K7 at depths 1-4 and 0
    (the general selection) and of K10's nogate, maxonly and fixedout hold
    HGMMA, their fp32 instances FFMA, and the library holds no IDP
    (``__dp4a``) instruction."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lines = smoke.wgmma_report(_build, "ivf_grouped_scan")
    bf16 = [ln for ln in lines if " bf16, depth" in ln]
    fp32 = [ln for ln in lines if "grouped_ffma_kernel<" in ln]
    assert len(bf16) == 18 and all("HGMMA" in ln and "BF16" in ln for ln in bf16)
    assert len(fp32) == 18 and all("FFMA 0" not in ln for ln in fp32)
    assert lines[-1].startswith("IDP (__dp4a) instructions in libivf_grouped_scan: 0 ")
    assert lines[-1].endswith("ptxas serialization warnings: none")


def test_k7_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(24)
    qi, cqb, vt, _, bf, bl, rv, _, _, _ = (
        None if x is None else torch.from_numpy(x).to(dev)
        for x in _k7_inputs(rng, [100], 128, 8, 16, False, False, False))
    with pytest.raises(ValueError, match="one dtype"):
        ivf_scan.cluster_major_scan_routed(
            torch.zeros((qi.shape[0], 330), device=dev), cqb,
            torch.zeros((vt.shape[0], 330, 128), device=dev, dtype=torch.bfloat16), bf, bl, rv,
            4, blk=128)
    # Once refused: bins other than 128, a depth past 4, fp32 past 256
    # chunks a block.
    wide = torch.zeros((vt.shape[0], 16, 32896), device=dev)
    wide[..., :128] = vt.float()
    for args, kw in (((qi, cqb, vt), dict(blk=128, nbins=64)),
                     ((qi, cqb, vt), dict(blk=128, bin_depth=5)),
                     ((qi.float(), cqb, wide), dict(blk=32896))):
        _assert_scan_equal(
            ivf_scan.cluster_major_scan_routed(*args, bf, bl, rv, 4, **kw),
            ivf_scan.cluster_major_scan_routed_reference(*args, bf, bl, rv, 4, **kw),
            torch.nonzero(bl).flatten())


# The general selection of K4, K6 and K7 (nbins, depth, blk, k): depths
# past 4 (5 and 8 on the lists; 16 = blk / nbins keeps every column), nbins
# dividing 128, a multiple of it and neither (96 at blk 384), a blk off the
# 128-column chunk (480 = 5·96: padded), and keepall where the depth
# reaches k; k 33 runs two passes.
GENERAL_CASES = [
    pytest.param(128, 5, 2048, 20, id="depth5"),
    pytest.param(128, 8, 2048, 20, id="depth8"),
    pytest.param(128, 16, 2048, 33, id="depth16-all"),
    pytest.param(64, 2, 2048, 20, id="nbins64"),
    pytest.param(256, 2, 2048, 20, id="nbins256"),
    pytest.param(96, 2, 384, 20, id="nbins96-blk384"),
    pytest.param(96, 3, 480, 33, id="nbins96-blk480-k33"),
    pytest.param(64, 4, 2048, 3, id="keepall-k3"),
]
GENERAL_SIZES = [1500, 0, 40, 700, 129]


def _general_inputs(rng, dev, mode, blk, qcap=40, d=37):
    """K4's inputs at ``blk`` (one to three blocks a cluster, empty slots,
    the int8 mode with bias) in ``mode`` on ``dev``: float values in [-8,
    7], exact sums."""
    qg, vt, bf, bl, rv, br, rb = _k4_inputs(rng, GENERAL_SIZES, blk, qcap, d, False, False,
                                            mode == "int8", empty_slots=True)
    if mode == "int8":
        qg, vt = (torch.from_numpy(x).to(dev) for x in (qg, vt))
    else:
        qg, vt = _as_float(dev, mode, qg // 16, vt // 16)
    tabs = tuple(torch.from_numpy(x).to(dev) for x in (bf, bl, rv, rb))
    return qg, vt, tabs, None if br is None else torch.from_numpy(br).to(dev)


@pytest.mark.parametrize("nbins,depth,blk,k", GENERAL_CASES)
@pytest.mark.parametrize("mode", ["int8", "fp32", "bf16"])
def test_k4_k6_k7_general_selection_equal_to_plain(dev, mode, nbins, depth, blk, k):
    """F8, F9: K4, K6 (the routed table by cluster) and K7 (the batch
    gathered through cq) at bins other than 128 and depths past 4, each
    counted and equal to its plain version."""
    rng = np.random.default_rng(90)
    qg, vt, (bf, bl, rv, rb), br = _general_inputs(rng, dev, mode, blk)
    kw = dict(k=k, blk=blk, nbins=nbins, bin_depth=depth, row_base=rb)
    rows = torch.nonzero(bl).flatten()
    passes = -(-k // 32)
    before = ivf_scan.LAUNCHES
    got = ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, bias=br, **kw)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES - before == passes
    _assert_scan_equal(got, ivf_scan.cluster_major_scan_grouped_reference(
        qg, vt, bf, bl, rv, bias=br, **kw), rows)
    # K6: each block's rows as its own cluster's (one block a cluster run
    # here keeps a cluster to one run); K7: the same rows from a batch.
    bc = torch.cumsum(bf, 0, dtype=torch.int32) - 1
    nlist = int(bc.max()) + 1
    qc = qg[torch.nonzero(bf).flatten()]
    before = ivf_scan.CLUSTER_LAUNCHES
    got = ivf_scan.cluster_major_scan(qc, vt, bc, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert ivf_scan.CLUSTER_LAUNCHES - before == passes
    _assert_scan_equal(got, ivf_scan.cluster_major_scan_reference(qc, vt, bc, bf, bl, rv, **kw),
                       bc[rows].long())
    qi = qc.reshape(-1, qc.shape[-1])
    cqb = (bc[:, None] * qc.shape[1] + torch.arange(qc.shape[1], device=dev)).to(torch.int32)
    cqb = cqb[..., None].contiguous()
    before = ivf_scan.ROUTED_LAUNCHES
    got = ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, bias=br, **kw)
    torch.cuda.synchronize()
    assert ivf_scan.ROUTED_LAUNCHES - before == passes and nlist == len(qc)
    _assert_scan_equal(got, ivf_scan.cluster_major_scan_routed_reference(
        qi, cqb, vt, bf, bl, rv, bias=br, **kw), rows)


@pytest.mark.parametrize("nbins,depth,blk,k", GENERAL_CASES[3:7])
@pytest.mark.parametrize("mode", ["int8", "fp32", "bf16"])
def test_k10_general_bins_equal_to_plain(dev, mode, nbins, depth, blk, k):
    """F9: the lab's four variants at bins other than 128 (full and nogate
    on K6's general selection; maxonly and fixedout select nothing)."""
    rng = np.random.default_rng(91)
    qg, vt, (bf, bl, rv, _), _ = _general_inputs(rng, dev, mode, blk)
    bc = torch.cumsum(bf, 0, dtype=torch.int32) - 1
    qc = qg[torch.nonzero(bf).flatten()]
    rows = bc[torch.nonzero(bl).flatten()].long()
    for variant in kernel_lab.VARIANTS:
        args = (qc, vt, bc, bf, bl, rv, k, blk, nbins, variant)
        got, want = kernel_lab._variant_scan(*args), kernel_lab._variant_scan_reference(*args)
        if variant in ("full", "nogate"):
            _assert_scan_equal(got, want, rows)
        else:
            rows_ = rows[-1:] if variant == "fixedout" else rows
            rows_ = torch.zeros_like(rows_) if variant == "fixedout" else rows_
            assert torch.equal(_bits(got[0][rows_]), _bits(want[0][rows_]))


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("nbins,tile_n", [(64, 512), (256, 512), (32, 512), (96, 384),
                                          (192, 384)])
def test_k3_binned_general_bins_equal_to_plain(dev, mode, nbins, tile_n):
    """F9: K3's binned modes at nbins 64, 32, 256, 96 and 192 (dividing 128,
    a multiple of it and neither), all on the general binning (per-(row,
    bin) lists in device memory), over a ragged N, k 20."""
    gen = torch.Generator(device=dev).manual_seed(92)
    q = torch.randint(-8, 8, (70, 37), generator=gen, device=dev)
    bt = torch.randint(-8, 8, (37, 3000), generator=gen, device=dev)
    if mode == "int8":
        q, bt = q.to(torch.int8), bt.to(torch.int8)
    else:
        q, bt = q.to(FLOAT_DTYPES[mode]), bt.to(FLOAT_DTYPES[mode])
    before = bruteforce_fused.LAUNCHES
    got = bruteforce_fused.fused_topk_matmul(q, bt, 20, tile_n=tile_n, nbins=nbins)
    torch.cuda.synchronize()
    assert bruteforce_fused.LAUNCHES > before
    want = bruteforce_fused.fused_topk_matmul_reference(q, bt, 20, tile_n=tile_n, nbins=nbins)
    fin = want[0] > float("-inf")
    assert torch.equal(got[0].float(), want[0].float())
    assert torch.equal(got[1][fin], want[1][fin])


def test_k4_kernel_fp32_at_blk_65536_equal_to_plain(dev):
    """F9: fp32 past 256 chunks a block (the lists' chunks in 16 bits):
    blk 65536, three blocks, depth 2 and 4."""
    rng = np.random.default_rng(93)
    for depth in (2, 4):
        qg, vt, (bf, bl, rv, rb), _ = _general_inputs(rng, dev, "fp32", 65536, qcap=24, d=9)
        kw = dict(k=20, blk=65536, bin_depth=depth, row_base=rb)
        _assert_scan_equal(ivf_scan.cluster_major_scan_grouped(qg, vt, bf, bl, rv, **kw),
                           ivf_scan.cluster_major_scan_grouped_reference(qg, vt, bf, bl, rv,
                                                                         **kw),
                           torch.nonzero(bl).flatten())


@pytest.mark.parametrize("case", ["bin_depth5", "fp32_blk65536"])
def test_ivf_search_general_selection_card_equals_cpu(dev, case):
    """F8: ``search_device(q, 10, 4, bin_depth=5)`` with the recovery pass
    (K1, then K4 at depth 5 on the lists) on an int8 index of 2048-row
    blocks; F9: an fp32 index with pad_block 65536 through
    ``engine="pallas"`` (K4) and its recovery pass.  The same ids, scores
    and spill on the card as on the CPU."""
    base, queries = make_synthetic(3000, 40, 32, 4, seed=6)
    dtype, blk, kw = (("int8", 2048, dict(bin_depth=5)) if case == "bin_depth5"
                      else ("fp32", 65536, dict(engine="pallas")))
    src = IVFIndex.build(base, nlist=4, metric="l2", dtype="int8", pad_block=256, max_iter=5,
                         device="cpu")

    def search(device):
        idx = IVFIndex.from_arrays(src._centroids_np, src._vectors_np, src._offsets_np,
                                   src._reorder_np, metric="l2", dtype=dtype, pad_block=blk,
                                   config=src.config, device=device)
        out = idx.search_device(torch.from_numpy(queries).to(device), 10, 4, mode="cluster",
                                recover=True, qcap=16, recover_qcap=16, **kw)
        return [x.cpu() for x in out], int(idx.last_spill)

    before = ivf_scan.LAUNCHES
    got, spill = search(dev)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES > before
    want, want_spill = search("cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert spill == want_spill


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
    with pytest.raises(ValueError, match="int8 D <= 1024"):  # its key's int32 cap
        ivf_accum.cluster_major_accum(
            torch.zeros((qg.shape[0], 8, 1025), dtype=torch.int8, device=dev),
            torch.zeros((vt.shape[0], 1025, 128), dtype=torch.int8, device=dev), bf, bl, rv, 4,
            blk=128)


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
# of 4 nor of 128 (a ragged last chunk) nor of 8 (bf16 base_t copied to a
# 16-byte row pitch; int8 K-major rows past N arrive as zeros); D = 37 pads
# the int8 rows to 48 bytes.  The wgmma kernels' edges: 64 rows a CTA (B =
# 70, 193, 200), 128 columns a chunk (tile_n 128, 256, 2048), 64 bf16 or 128
# int8 d a box (D = 129, 320, 512), and the ring wrapping within a chunk at
# the depth it takes (D = 320 binned, 512 exact).  tile_n 40064 walks 313
# chunks in a tile: the binned table's chunk index passes one byte.
K3_SHAPES = {
    "base": (40, 64, 2048, 20, 512, None, (-127, 128)),
    "ragged": (70, 37, 3001, 32, None, 2900, (-127, 128)),
    "ties": (33, 128, 5000, 10, None, None, (0, 3)),
    "t128-d129": (200, 129, 4100, 20, 128, None, (-127, 128)),
    "t256-b200": (200, 128, 3001, 32, 256, 2950, (-127, 128)),
    "t2048-d512": (70, 512, 5000, 20, 2048, 4500, (-127, 128)),
    "b193-d320": (193, 320, 4100, 20, 256, 4000, (-127, 128)),
    "b193-d37": (193, 37, 3001, 32, 128, None, (-127, 128)),
    "t40064-wide": (70, 64, 70001, 20, 40064, 69000, (-127, 128)),
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
    with pytest.raises(ValueError, match="k=601 > N=600"):  # past the base, as JAX refuses
        bruteforce_fused.fused_topk_matmul(q.float(), bt.float(), 601)
    # Once refused: bins other than 128 (64 divides 128), and (F11) tiles off
    # the 128-column chunk, equal to the plain version.
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randint(-127, 127, (4, 16), generator=gen, device=dev, dtype=torch.int8)
    bt = torch.randint(-127, 127, (16, 600), generator=gen, device=dev, dtype=torch.int8)
    for tile_n, nbins in ((512, 64), (192, 48)):
        got = bruteforce_fused.fused_topk_matmul(q, bt, 4, tile_n=tile_n, nbins=nbins)
        want = bruteforce_fused.fused_topk_matmul_reference(q, bt, 4, tile_n=tile_n,
                                                            nbins=nbins)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# F11: binned tiles off the 128-column chunk, so a chunk lies across two
# tiles: (B, D, N, k, tile_n, nbins, n_valid).  N 40,000 gives the fp32
# mode several column splits (a multiple of 384 columns each).
K3_OFF_CHUNK = {
    "t192-n48-k4": (70, 37, 3001, 4, 192, 48, None),
    "t320-n40-k20": (100, 64, 40000, 20, 320, 40, 39000),
}


@pytest.mark.parametrize("shape", list(K3_OFF_CHUNK))
@pytest.mark.parametrize("mode", ["i8", "i8_l2", "f32", "bf16"])
def test_k3_binned_off_chunk_tiles_equal_to_plain(dev, mode, shape):
    """F11: K3's binned modes at tile_n 192 and 320 (off the 128-column
    chunk), each chunk across two tiles binned once for each."""
    b, d, n, k, tile_n, nbins, n_valid = K3_OFF_CHUNK[shape]
    rng = np.random.default_rng(33)
    q = torch.from_numpy(rng.integers(-127, 128, (b, d), dtype=np.int8)).to(dev)
    bt = torch.from_numpy(rng.integers(-127, 128, (d, n), dtype=np.int8)).to(dev)
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


# K5: (B, D, N, tile_n, group, k, alpha of the L2 bias rows or None, value
# range); N = 1300 and 9000 leave a partial tile and padded tiles.  The
# wgmma kernels' edges: 192 rows a CTA (B = 193, 200; int8 takes 64 or 128
# rows where B = 33, 40 or 70 fills no more), 64 bins a CTA (tile_n 128,
# 256, 2048), 64 bf16 or 128 int8 d a box (D = 37, 128, 129, 320, 1024:
# 192 resident int8 rows of 1024 d leave the ring four stages).  alpha
# 3.5e-4 puts the quotients norms/alpha near the clamp 2**30 >> shift, and
# the largest norms on it.
K5_SHAPES = {
    "ip": (40, 64, 4096, 256, 4, 20, None, (-127, 128)),
    "l2": (40, 64, 4096, 256, 4, 20, 7.0, (-127, 128)),
    "ties": (33, 128, 4096, 128, 8, 10, None, (0, 3)),
    "ragged-l2": (70, 37, 1300, 128, 4, 32, 7.0, (-127, 128)),
    "d320": (40, 320, 1300, 128, 4, 20, None, (-127, 128)),
    "t2048-d129": (200, 129, 9000, 2048, 4, 20, None, (-127, 128)),
    "t256-b200": (200, 128, 5000, 256, 8, 20, None, (-127, 128)),
    "b193-d37-l2": (193, 37, 1300, 128, 4, 32, 7.0, (-127, 128)),
    "b193-d129": (193, 129, 9000, 2048, 4, 20, None, (-127, 128)),
    "b193-d320-l2": (193, 320, 5000, 256, 8, 20, 7.0, (-127, 128)),
    "d1024": (193, 1024, 1300, 128, 4, 20, None, (-127, 128)),
    "d1024-l2": (193, 1024, 1300, 128, 4, 20, 7.0, (-127, 128)),
    "l2-clamp": (193, 64, 4096, 256, 4, 20, 3.5e-4, (-127, 128)),
}


@pytest.mark.parametrize("shape", list(K5_SHAPES))
def test_k5_kernel_equal_to_plain(dev, shape):
    b, d, n, tile_n, group, k, alpha, (lo, hi) = K5_SHAPES[shape]
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.integers(lo, hi, (b, d), dtype=np.int8)).to(dev)
    tiles, _ = bruteforce_accum.tile_base(rng.integers(lo, hi, (d, n), dtype=np.int8),
                                          tile_n, group)
    tiles = tiles.to(dev)
    br = None
    if alpha is not None:
        norms = bruteforce_accum.tile_norms(rng.uniform(0, 1e5, n).astype(np.float32),
                                            tile_n, group)
        br = bruteforce_accum.l2_bias_rows(torch.from_numpy(norms).to(dev),
                                           torch.tensor(alpha, device=dev), group)
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


def _index_d100(dtype, device):
    """An L2 IVF index at D 100 (no 16-byte multiple in any dtype: int8
    rows pad to 112, fp32 and bf16 (D' 101) to 104), built on the CPU and
    placed on ``device``."""
    _, queries = make_synthetic(3000, 40, 100, 8, seed=5)
    src = _index_d100_src()
    idx = IVFIndex.from_arrays(src._centroids_np, src._vectors_np, src._offsets_np,
                               src._reorder_np, metric="l2", dtype=dtype, pad_block=256,
                               config=src.config, device=device)
    return idx, torch.from_numpy(queries).to(device)


@functools.lru_cache(maxsize=1)
def _index_d100_src():
    base, _ = make_synthetic(3000, 40, 100, 8, seed=5)
    return IVFIndex.build(base, nlist=12, metric="l2", dtype="int8", pad_block=256,
                          max_iter=5, device="cpu")


@pytest.mark.parametrize("dtype", ["int8", "fp32", "bf16"])
@pytest.mark.parametrize("recover", [False, True])
def test_routed_engine_card_equals_cpu_at_d100(dev, dtype, recover):
    """The routed engine at D 100: K7 takes the int8 batch contiguous (its
    wrapper pads it) and a float batch at the 16-byte pitch in place; the
    same ids, scores and spill on the card as on the CPU."""
    kw = dict(mode="cluster", engine="pallas_routed", qcap=4, recover=recover,
              recover_qcap=16, recover_blocks=24, recover_passes=2)  # every block

    def search(device):
        idx, q = _index_d100(dtype, device)
        out = idx.search_device(q, 10, 4, **kw)
        return [x.cpu() for x in out], int(idx.last_spill)

    before = (ivf_scan.ROUTED_LAUNCHES, ivf_scan.LAUNCHES)
    got, spill = search(dev)
    torch.cuda.synchronize()
    launches = (ivf_scan.ROUTED_LAUNCHES - before[0], ivf_scan.LAUNCHES - before[1])
    want, want_spill = search("cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert spill == want_spill and (spill == 0) == recover
    assert launches == ((3, 0) if recover else (1, 0))  # main walk + 2 recovery passes


@pytest.mark.parametrize("dtype", ["int8", "fp32", "bf16"])
@pytest.mark.parametrize("run", ["pallas", "recover"])
def test_sharded_ivf_card_equals_cpu_at_d100(dev, dtype, run):
    """The sharded index at D 100, K6 over each shard's walk
    (``engine="pallas"``) or in the recovery pass after K1: K6 takes the int8
    routed tables contiguous and the float ones at the 16-byte pitch in
    place; the same ids, scores and spill on the card as on the CPU."""
    kw = SHARDED_IVF_RUNS[run]

    def search(device):
        idx, q = _index_d100(dtype, device)
        sh = ShardedIVFIndex(idx, [torch.device(device)] * 3)
        out = sh.search_device(q, 10, 4, **kw)
        return [x.cpu() for x in out], int(sh.last_spill)

    before = ivf_scan.CLUSTER_LAUNCHES
    got, spill = search(dev)
    torch.cuda.synchronize()
    k6 = ivf_scan.CLUSTER_LAUNCHES - before
    want, want_spill = search("cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert spill == want_spill and k6 > 0


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


@pytest.mark.parametrize("d", [1152, 2048, 3072])
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_k10_kernel_int8_wide_d_equal_to_plain(dev, d, variant):
    """K10 int8 past the D 1024 the staged kernel took, on K6's wgmma
    kernel: D 1152 and 2048 with the routed rows resident, 3072 gathered a
    unit at a time beside the transpose.  Random int8 values keep every
    |dot| far below 2**24, so the plain fp32 product stays exact."""
    rng = np.random.default_rng(56)
    qg, vt, bc, bf, bl, rv, _, _ = (torch.from_numpy(x).to(dev) if x is not None else None
                                    for x in _k6_inputs(rng, [900, 300, 2100, 129], 256, 40, d,
                                                        False, "dense", False,
                                                        empty_slots=True))
    cut = int(torch.nonzero(rv).max()) + 1
    tabs = [x[:cut] for x in (vt, bc, bf, bl, rv)]
    args = (qg, *tabs, 20, 256, 128, variant)
    before = kernel_lab.LAUNCHES
    pv, pr = kernel_lab._variant_scan(*args)
    torch.cuda.synchronize()
    assert kernel_lab.LAUNCHES == before + 1
    rv_, rr = kernel_lab._variant_scan_reference(*args)
    win = _k10_defined(variant, tabs[1], tabs[3])
    assert torch.equal(pv[win], rv_[win])
    fin = rv_[win] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[win][fin], rr[win][fin])


@pytest.mark.parametrize("dtype", ["int8", "fp32", "bf16"])
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_k10_kernel_zero_tiles_equal_to_plain(dev, dtype, variant):
    """K10 where whole row tiles are empty slots: one cluster routes no
    query (every tile zero: its scores are +0, maxonly's row max +0) and
    another none past row 20 (its second tile zero), qcap 40.  Values
    bit-equal (+0 is not -0), ids equal where finite."""
    rng = np.random.default_rng(57)
    qg, vt, bc, bf, bl, rv, _, _ = _k6_inputs(rng, [900, 300, 2100, 129], 256, 40, 129, False,
                                              "dense", False)
    qg[3] = 0
    qg[4, 20:] = 0
    cut = int(np.nonzero(rv)[0].max()) + 1
    if dtype == "int8":
        qg, vt = torch.from_numpy(qg).to(dev), torch.from_numpy(vt[:cut]).to(dev)
    else:
        qg, vt = _as_float(dev, dtype, qg, vt[:cut])
    tabs = [torch.from_numpy(x[:cut]).to(dev) for x in (bc, bf, bl, rv)]
    args = (qg, vt, *tabs, 20, 256, 128, variant)
    pv, pr = kernel_lab._variant_scan(*args)
    rv_, rr = kernel_lab._variant_scan_reference(*args)
    torch.cuda.synchronize()
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
    # Once refused: bins other than 128, equal to the plain version.
    rows = bc[torch.nonzero(bl).flatten()].long()
    _assert_scan_equal(kernel_lab._variant_scan(qg, vt, bc, bf, bl, rv, 4, 128, 64, "nogate"),
                       kernel_lab._variant_scan_reference(qg, vt, bc, bf, bl, rv, 4, 128, 64,
                                                          "nogate"), rows)


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
@pytest.mark.parametrize("gemm,m,blk", [
    pytest.param(False, 100, 301, id="max"), pytest.param(True, 100, 300, id="gemm"),
    pytest.param(True, 1, 128, id="gemm-m1-blk128"),
    pytest.param(True, 64, 2052, id="gemm-m64-blk2052"),
    pytest.param(True, 65, 128, id="gemm-m65-blk128"),
    pytest.param(True, 65, 2052, id="gemm-m65-blk2052")])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_k12_kernel_equal_to_plain(dev, dtype, gemm, m, blk, fat, semantics):
    # Ragged: 9 blocks of [36, 301] (steps start off 16-byte boundaries) or,
    # with the product, [36, 300] (column slices end mid-tile), x [100, 36];
    # every step holds a planted max, an earlier step the walk's.  The
    # product's edges: x of 1, 64 (one warpgroup) and 65 rows; blk 128 (a
    # 16-byte row pitch: the 16-byte cp.async pieces) and 2052 (a 4-byte
    # pitch: the 4-byte pieces, 17 slices, the last 4 columns wide).
    gen = _probe_gen(dev, 52)
    data, tops = hw_probe._planted_walk(9, 36, blk, fat, dtype, gen)
    x = _rand_op((m, 36), dtype, gen, dev)
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
@pytest.mark.parametrize("g", [1, 37, 300])
@pytest.mark.parametrize("tb,tn,d", [(200, 300, 96), (256, 2048, 128), (64, 16, 32),
                                     (65, 130, 48), (65, 16, "cap"), (65, 130, "640B"),
                                     (20, 40, "odd")])
@pytest.mark.parametrize("dtype,unit", [(torch.int8, "mma"), (torch.int8, "dp4a"),
                                        (torch.bfloat16, "mma")])
def test_k14_kernel_equal_to_plain(dev, dtype, unit, tb, tn, d, g, sel):
    # The value and every step's max (NaN where no CTA wrote); bf16 each
    # step within 2·d·2**-24·max(|twisted q| @ |v|).  The edges of the
    # wgmma design: tb 64 (one warpgroup) and 65 (a row past it), d 32 and
    # 48 (int8: one and 1.5 k-steps of 32 bytes), d at the 512-byte cap
    # ("cap": int8 512, bf16 256, 16 k-steps), tn 16 and 130; g 1, and 37
    # and 300, which no CTA count divides (a CTA with no step, CTAs with
    # one, two or many steps through both accumulator sets).  Past the
    # registers' 16 k-steps: 640 bytes of K (int8 640, bf16 320: the
    # chunked kernel, dp4a's resident tiles) and an odd d past 512 bytes
    # (int8 1025: dp4a in chunks; bf16 257), padded to 4-byte words.
    d = {"cap": 512, "640B": 640, "odd": {torch.int8: 1025, torch.bfloat16: 514}[dtype]}.get(
        d, d * dtype.itemsize) // dtype.itemsize
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
    """K11's tile other than [8, 128] (JAX's BlockSpec).  What K12-K14 once
    refused equals the plain version: K13 at 15-byte blocks and depth 9,
    K12's product at d·elem 3, K14 at 1024 bytes of K."""
    x = torch.zeros((8, 128), device=dev)
    with pytest.raises(ValueError):
        hw_probe._step_probe(x[:, :64], 4, True, None)
    gen = _probe_gen(dev, 56)
    data = _rand_op((9, 3, 5), torch.int8, gen, dev)  # 15-byte blocks
    for depth in (1, 9):
        assert torch.equal(hw_probe._dma_probe(x, data, depth),
                           hw_probe._dma_probe_reference(x, data, depth))
    xs = _rand_op((4, 3), torch.int8, gen, dev)
    assert torch.equal(hw_probe._stream_steps(xs, data, 5, 1, True, None),
                       hw_probe._stream_steps_reference(xs, data, 1, True))
    q, v = _rand_op((4, 1024), torch.int8, gen, dev), _rand_op((1024, 8), torch.int8, gen, dev)
    assert torch.equal(hw_probe._gemm_rate_probe(x, q, v, 2, 4, 8, False),
                       hw_probe._gemm_rate_probe_reference(x, q, v, 2, 4, 8, False))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("m,d,blk", [(256, 37, 130), (130, 640, 2048), (300, 1100, 515)])
def test_k12_product_past_the_old_caps_equal_to_plain(dev, dtype, m, d, blk):
    """F10: K12's product at 256 and more x rows (row tiles in turn), odd
    d and blk (padded to 4-byte words), and K past 512 bytes (x resident,
    or riding the ring at d 1100: 3 row tiles x 9 units of 16 KB)."""
    gen = _probe_gen(dev, 57)
    data, tops = hw_probe._planted_walk(6, d, blk, 2, dtype, gen)
    x = _rand_op((m, d), dtype, gen, dev)
    _k12_against_plain(x, data, blk, 2, True, None, tops)


@pytest.mark.parametrize("depth", [8, 15, 16])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_k13_kernel_past_the_old_caps_equal_to_plain(dev, dtype, depth):
    """F10: K13 at depths past its ring of 8 (the JAX depth picks the
    blocks) over 15-byte int8 blocks (30-byte bf16) whose walk ends off a
    16-byte piece, a value planted at its last element."""
    gen = _probe_gen(dev, 58)
    data = _rand_op((40, 3, 5), dtype, gen, dev)
    x = torch.zeros((8, 128), device=dev)
    walked = hw_probe._dma_blocks(data, depth) * 15
    flat = data.view(-1)
    flat[walked - 1] = 127 if dtype == torch.int8 else 64.0
    want = hw_probe._dma_probe_reference(x, data, depth)
    assert float(want[0]) == float(flat[walked - 1])
    assert torch.equal(hw_probe._dma_probe(x, data, depth), want)


def test_probe_cli_runs_at_toy_sizes_on_the_card(dev, capsys):
    before = hw_probe.LAUNCHES["K14"]
    res = hw_probe.probe_pallas_gemm(repeats=1, device=dev, shapes=((128, 256),), gs=(4, 8))
    assert len(res) == 3 and all(v > 0 for v in res.values())
    # Six timings of one call, each 2 warm-up calls and 4 replays of the
    # captured one, 2 kernels a call: the count is of launches on the card.
    assert hw_probe.LAUNCHES["K14"] - before == 6 * (2 + 4) * 2
    res = hw_probe.probe_pallas_step(repeats=1, device=dev, grids=(4, 16))
    assert res["launch_us"]["graph"] > 0 and res["launch_us"]["eager"] > 0


# ---------------------------------------------------------------------------
# Past the kernels' old limits: k past 32 (K3's int8 and bf16 modes, K4, K6
# and K7 in passes of 32; K3 fp32 and K9 in one launch), rows wider than
# 16384 (K2 in segments), and any D (the float stage in d-slices, the wgmma
# modes' rows in the ring) up to the int8 caps of the key packing.

WIDE_K = [33, 40, 64, 100, 256]
WIDE_D = [384, 768, 1536]


def _k3_operands(dev, rng, mode, b, d, n, lo, hi):
    """K3 operands in ``mode``: int8 values in [lo, hi), the float modes the
    same integers (exact sums while D·max² stays below 2**24)."""
    q = torch.from_numpy(rng.integers(lo, hi, (b, d), dtype=np.int8)).to(dev)
    bt = torch.from_numpy(rng.integers(lo, hi, (d, n), dtype=np.int8)).to(dev)
    kw = {}
    if mode == "i8_l2":
        kw["alpha"] = torch.from_numpy(rng.uniform(0.5, 2, b).astype(np.float32)).to(dev)
        kw["bias"] = torch.from_numpy(rng.uniform(0, 3e4, n).astype(np.float32)).to(dev)
    if mode in ("f32", "bf16"):
        q, bt = (x.to(torch.bfloat16 if mode == "bf16" else torch.float32) for x in (q, bt))
    return q, bt, kw


def _k3_equal(q, bt, k, **kw):
    """K3 against its plain version: values bit-equal, ids equal above the
    fill value → the launches it made."""
    before = bruteforce_fused.LAUNCHES
    v, i = bruteforce_fused.fused_topk_matmul(q, bt, k, **kw)
    rv, ri = bruteforce_fused.fused_topk_matmul_reference(q, bt, k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(v), _bits(rv))
    fin = rv > topk.fill_value(rv.dtype)
    assert fin.any()
    assert torch.equal(i[fin], ri[fin])
    return bruteforce_fused.LAUNCHES - before


@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("nbins", [0, 128], ids=["exact", "bin128"])
@pytest.mark.parametrize("mode", ["i8", "i8_l2", "f32", "bf16"])
def test_k3_kernel_wide_k_equal_to_plain(dev, k, nbins, mode):
    """k past 32 on a tie-heavy batch (values 0..3): the int8 and bf16
    modes run ceil(k / 32) passes, fp32 one launch."""
    rng = np.random.default_rng(40)
    q, bt, kw = _k3_operands(dev, rng, mode, 70, 37, 3001, 0, 4)
    n_valid = torch.tensor([2900], dtype=torch.int32, device=dev)
    launches = _k3_equal(q, bt, k, nbins=nbins, tile_n=512 if nbins else None, n_valid=n_valid,
                         **kw)
    assert launches == (1 if mode == "f32" else -(-k // 32))


@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("nbins", [0, 128], ids=["exact", "bin128"])
@pytest.mark.parametrize("mode", ["i8", "i8_l2", "f32", "bf16"])
def test_k3_kernel_wide_d_equal_to_plain(dev, d, nbins, mode):
    """D past the rows the wgmma modes keep resident beside two stages
    (they then ride the ring) and past the old fp32 cap."""
    rng = np.random.default_rng(41)
    lo, hi = (-127, 128) if mode.startswith("i8") else (-8, 9)
    q, bt, kw = _k3_operands(dev, rng, mode, 70, d, 3001, lo, hi)
    _k3_equal(q, bt, 20, nbins=nbins, tile_n=512 if nbins else None, **kw)


# K3 fp32 (the register-tiled kernel over column splits): (B, D, N, k,
# n_valid); values 0..2, so ties run across chunks and splits.
K3_F32_SHAPES = {
    "b33-d37": (33, 37, 20000, 10, None),
    "b200-d129-nvalid": (200, 129, 40000, 20, 39000),
    "b70-d513": (70, 513, 9000, 40, None),
    "b130-d1024-nvalid": (130, 1024, 9000, 100, 8000),
    "b1024-d129-split": (1024, 129, 300000, 10, None),
}


@pytest.mark.parametrize("shape", list(K3_F32_SHAPES))
@pytest.mark.parametrize("nbins", [0, 128], ids=["exact", "bin128"])
def test_k3_fp32_bit_equal_to_plain(dev, shape, nbins):
    b, d, n, k, n_valid = K3_F32_SHAPES[shape]
    rng = np.random.default_rng(42)
    q, bt, _ = _k3_operands(dev, rng, "f32", b, d, n, 0, 3)
    kw = dict(nbins=nbins, tile_n=2048 if nbins else None)
    if n_valid is not None:
        kw["n_valid"] = torch.tensor([n_valid], dtype=torch.int32, device=dev)
    before = fused_topk.LAUNCHES
    assert _k3_equal(q, bt, k, **kw) == 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit = bruteforce_fused.split_plan(b, n, 2048, nbins, sms)[1]
    assert fused_topk.LAUNCHES - before == (nsplit > 1)  # K2 joins the splits
    if shape == "b1024-d129-split":
        assert nsplit > 1


@pytest.mark.parametrize("nbins", [0, 128], ids=["exact", "bin128"])
def test_k3_fp32_ties_across_split_edges(dev, nbins):
    """2k equal best columns straddle the first split edge: the k lowest ids
    win, all of them left of the edge."""
    b, d, n, k = 256, 37, 200000, 40
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    edge, nsplit = bruteforce_fused.split_plan(b, n, 512, nbins, sms)
    assert nsplit > 1
    rng = np.random.default_rng(43)
    q = torch.from_numpy(rng.integers(1, 3, (b, d)).astype(np.float32)).to(dev)
    bt = torch.from_numpy(rng.integers(0, 2, (d, n)).astype(np.float32)).to(dev)
    bt[:, edge - k:edge + k] = 3.0
    v, i = bruteforce_fused.fused_topk_matmul(q, bt, k, nbins=nbins, tile_n=512)
    rv, ri = bruteforce_fused.fused_topk_matmul_reference(q, bt, k, nbins=nbins, tile_n=512)
    torch.cuda.synchronize()
    assert torch.equal(v, rv) and torch.equal(i, ri)
    assert torch.equal(i[0].sort().values.cpu(),
                       torch.arange(edge - k, edge, dtype=torch.int32))


def test_k3_fp32_sorted_base_every_column_passes(dev):
    """A base whose scores rise along the columns: every chunk's every
    column beats the running k-th value, the buffers' worst case."""
    q = torch.ones((300, 16), device=dev)
    bt = torch.arange(20000, device=dev, dtype=torch.float32).repeat(16, 1)
    for k in (10, 200):
        assert _k3_equal(q, bt, k) == 1


@pytest.mark.parametrize("k", [257, 300, 1000])
@pytest.mark.parametrize("nbins", [0, 128], ids=["exact", "bin128"])
def test_k3_fp32_past_256_in_passes_equal_to_plain(dev, k, nbins):
    """fp32 k past one launch's 256 on a tie-heavy batch (values 0..3): a
    pass of 256 at a time, each bounded by the last entry of the one
    before (binned: the survivors of 6 tiles of 512, 1536 a row)."""
    rng = np.random.default_rng(52)
    q, bt, _ = _k3_operands(dev, rng, "f32", 70, 37, 3001, 0, 4)
    n_valid = torch.tensor([2900], dtype=torch.int32, device=dev)
    launches = _k3_equal(q, bt, k, nbins=nbins, tile_n=512 if nbins else None, n_valid=n_valid)
    assert launches == -(-k // 256)


def _k2_wide(w, dtype):
    """Rows of values 0..4 (ties across every segment edge), a row of fill
    values but two, and (float) -0.0 / +0.0 ties."""
    rng = np.random.default_rng(44)
    x = rng.integers(0, 5, (37, w)).astype(np.int32)
    fill = np.iinfo(np.int32).min
    if dtype == "float32":
        x = x.astype(np.float32)
        fill = -np.inf
        x[5] = 0.0
        x[5, 1::3] = -0.0
    x[3] = fill
    x[3, [7, w - 5]] = 2
    return x


@pytest.mark.parametrize("w", [16512, 32768, 65536])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("k", [1, 20, 100, 256])
def test_k2_kernel_wide_rows_equal_to_plain(dev, w, dtype, k):
    """Past 16384 columns (16512: one column chunk past): a launch a
    segment, then one on the segments' winners."""
    x = torch.from_numpy(_k2_wide(w, dtype)).to(dev)
    before = fused_topk.LAUNCHES
    v, i = fused_topk.fused_topk(x, k)
    rv, ri = fused_topk.fused_topk_reference(x, k)
    torch.cuda.synchronize()
    assert torch.equal(v, rv) and torch.equal(i, ri)
    assert fused_topk.LAUNCHES - before == -(-w // 16384) + 1
    # As in one launch: a value above the fill value is the element at its
    # position, bit for bit (the plain version's max of -0.0 and +0.0 may
    # be either).
    took = v > topk.fill_value(x.dtype)
    assert torch.equal(_bits(v)[took], _bits(torch.gather(x, 1, i.long()))[took])


def _grouped_three(dev, dtype, k, depth, d, sizes=(3000, 2100, 40, 700), ties=True):
    """K7 on its inputs, K4 on the gathered table and K6 on the per-cluster
    table, each against its plain version → the launches each made."""
    rng = np.random.default_rng(45)
    qi, cqb, vt, bc, bf, bl, rv, _, rb, cq = _k7_inputs(rng, list(sizes), 256, 40, d, ties,
                                                        False, False)
    if dtype == "int8":
        qi, vt = (torch.from_numpy(x).to(dev) for x in (qi, vt))
    else:  # small values: every fp32 sum exact at any D here
        qi, vt = (np.clip(x, -8, 8) for x in (qi, vt))
        qi, vt = _as_float(dev, dtype, qi, vt)
    cqb, bc, bf, bl, rv, rb, cq = (torch.from_numpy(x).to(dev)
                                   for x in (cqb, bc, bf, bl, rv, rb, cq))
    kw = dict(k=k, blk=256, bin_depth=depth, row_base=rb)

    def gathered(idx):
        hit = (idx >= 0) & (idx < qi.shape[0])
        g = qi[torch.where(hit, idx, torch.zeros_like(idx)).long()]
        return torch.where(hit[..., None], g, torch.zeros_like(g)).contiguous()

    rows = torch.nonzero(bl).flatten()
    before = (ivf_scan.ROUTED_LAUNCHES, ivf_scan.LAUNCHES, ivf_scan.CLUSTER_LAUNCHES)
    runs = [
        (rows, ivf_scan.cluster_major_scan_routed(qi, cqb, vt, bf, bl, rv, **kw),
         ivf_scan.cluster_major_scan_routed_reference(qi, cqb, vt, bf, bl, rv, **kw)),
        (rows, ivf_scan.cluster_major_scan_grouped(gathered(cqb[..., 0]), vt, bf, bl, rv, **kw),
         ivf_scan.cluster_major_scan_grouped_reference(gathered(cqb[..., 0]), vt, bf, bl, rv,
                                                       **kw)),
        (bc[rows].long(), ivf_scan.cluster_major_scan(gathered(cq), vt, bc, bf, bl, rv, **kw),
         ivf_scan.cluster_major_scan_reference(gathered(cq), vt, bc, bf, bl, rv, **kw)),
    ]
    torch.cuda.synchronize()
    for sel, (pv, pr), (wv, wr) in runs:
        assert torch.equal(_bits(pv[sel]), _bits(wv[sel]))
        fin = wv[sel] > float("-inf")
        assert fin.any()
        assert torch.equal(pr[sel][fin], wr[sel][fin])
    return (ivf_scan.ROUTED_LAUNCHES - before[0], ivf_scan.LAUNCHES - before[1],
            ivf_scan.CLUSTER_LAUNCHES - before[2])


@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("dtype", ["int8", "fp32", "bf16"])
@pytest.mark.parametrize("depth", [2, 4])
def test_k4_k6_k7_kernels_wide_k_equal_to_plain(dev, k, dtype, depth):
    """k past 32 on tie-heavy tables (values 0..1): passes of 32, each bound
    by the last entry of the one before."""
    passes = -(-k // 32)
    assert _grouped_three(dev, dtype, k, depth, 37) == (passes, passes, passes)


@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("dtype", ["int8", "fp32", "bf16"])
def test_k4_k6_k7_kernels_wide_d_equal_to_plain(dev, d, dtype):
    """The float stage in d-slices past D' = 320; int8 on wgmma with the
    routed rows resident."""
    assert _grouped_three(dev, dtype, 20, 2, d, sizes=(900, 300, 129), ties=False) == (1, 1, 1)


@pytest.mark.parametrize("d", [3072, 4096, 6144])
@pytest.mark.parametrize("depth", [2, 4])
def test_k4_k6_k7_int8_past_the_resident_rows_equal_to_plain(dev, d, depth):
    """int8 D past the routed rows the wgmma kernel holds beside two stages
    (2816 at depth 1-2, 5888 at 3-4): each unit's rows gathered beside its
    transpose.  Random int8 values keep every |dot| far below 2**24, so the
    plain fp32 product stays exact."""
    assert _grouped_three(dev, "int8", 20, depth, d, sizes=(900, 300, 129),
                          ties=False) == (1, 1, 1)


@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k1_kernel_float_wide_d_bit_equal_to_plain(dev, d, dtype):
    rng = np.random.default_rng(47)
    qg, vt, bf, bl, rv = _k1_inputs(rng, [900, 0, 300, 129], 256, 70, d, -8, 9)
    qg, vt = _as_float(dev, dtype, qg, vt)
    bf, bl, rv = (torch.from_numpy(x).to(dev) for x in (bf, bl, rv))
    got = ivf_accum.cluster_major_accum_planes(qg, vt, bf, bl, rv, blk=256)
    want = ivf_accum.cluster_major_accum_planes_reference(qg, vt, bf, bl, rv, blk=256)
    torch.cuda.synchronize()
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(got[rows], want[rows])


@pytest.mark.parametrize("d", [384, 512])
@pytest.mark.parametrize("bias", [False, True], ids=["ip", "l2bias"])
def test_k1_kernel_int8_at_the_jax_caps(dev, d, bias):
    """int8 K1 to the JAX package's key caps (512; 384 with bias rows) and
    the JAX package's refusal one past them."""
    cap = ivf_accum.INT8_DIM_MAX_BIAS if bias else ivf_accum.INT8_DIM_MAX
    rng = np.random.default_rng(48)
    qg, vt, bf, bl, rv = (torch.from_numpy(x).to(dev)
                          for x in _k1_inputs(rng, [900, 300], 256, 40, min(d, cap)))
    br = None
    if bias:
        br = torch.from_numpy(rng.integers(-2**29, 2**29, (vt.shape[0], 1, 256),
                                           dtype=np.int32)).to(dev)
    got = ivf_accum.cluster_major_accum_planes(qg, vt, bf, bl, rv, blk=256, bias_rows=br)
    want = ivf_accum.cluster_major_accum_planes_reference(qg, vt, bf, bl, rv, blk=256,
                                                          bias_rows=br)
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(got[rows], want[rows])
    wide = torch.zeros((qg.shape[0], 8, cap + 1), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match=f"dim <= {cap}"):
        ivf_accum.cluster_major_accum_planes(
            wide, torch.zeros((qg.shape[0], cap + 1, 256), dtype=torch.int8, device=dev), bf, bl,
            rv, blk=256, bias_rows=br)


@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("dtype", ["int8", "fp32"])
@pytest.mark.parametrize("d", [37, 768, 1536])
def test_k9_kernel_wide_k_and_d_equal_to_plain(dev, k, dtype, d):
    """K9 writes each pass's winner from lane 0, so any k in one launch (past
    the 256 candidates of bin2 the rest is fill); float D in d-slices, int8
    to its key's cap of 1024."""
    if dtype == "int8":
        d = min(d, 1024)
    rng = np.random.default_rng(49)
    qg, vt, bf, bl, rv = _k1_inputs(rng, [2000, 0, 900, 129], 256, 40, d, -8, 9)
    if dtype == "int8":
        qg, vt = (torch.from_numpy(x).to(dev) for x in (qg, vt))
    else:
        qg, vt = _as_float(dev, dtype, qg, vt)
    bf, bl, rv = (torch.from_numpy(x).to(dev) for x in (bf, bl, rv))
    kw = dict(k=k, blk=256, group=8, depth=8, bin2=True)
    before = ivf_accum.ACCUM_LAUNCHES
    pv, pr = ivf_accum.cluster_major_accum(qg, vt, bf, bl, rv, **kw)
    rv_, rr = ivf_accum.cluster_major_accum_reference(qg, vt, bf, bl, rv, **kw)
    torch.cuda.synchronize()
    assert ivf_accum.ACCUM_LAUNCHES - before == 1
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(_bits(pv[rows]), _bits(rv_[rows]))
    assert torch.equal(pr[rows], rr[rows])


@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("dtype", ["int8", "fp32", "bf16"])
def test_k5_kernel_wide_d_equal_to_plain(dev, d, dtype):
    """K5 past its old caps: fp32 in d-slices; bf16 and int8 with fewer
    warpgroups, or the rows in the ring once one warpgroup's no longer fit."""
    rng = np.random.default_rng(50)
    lo, hi = (-127, 128) if dtype == "int8" else (-8, 9)
    q = torch.from_numpy(rng.integers(lo, hi, (193, d), dtype=np.int8)).to(dev)
    tiles, _ = bruteforce_accum.tile_base(rng.integers(lo, hi, (d, 5000), dtype=np.int8), 256,
                                          8)
    tiles = tiles.to(dev)
    if dtype != "int8":
        q, tiles = q.to(FLOAT_DTYPES[dtype]), tiles.to(FLOAT_DTYPES[dtype])
    kw = dict(group=8, depth=8)
    v, i = bruteforce_accum.fused_topk_accum(q, tiles, 5000, 20, **kw)
    rv, ri = bruteforce_accum.fused_topk_accum_reference(q, tiles, 5000, 20, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(v), _bits(rv)) and torch.equal(i, ri)


@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k10_kernel_float_wide_d_equal_to_plain(dev, d, dtype):
    rng = np.random.default_rng(51)
    qg, vt, bc, bf, bl, rv, _, _ = _k6_inputs(rng, [900, 300, 129], 256, 16, d, False, "dense",
                                              False)
    qg = rng.integers(-8, 9, qg.shape, dtype=np.int8)
    vt = rng.integers(-8, 9, vt.shape, dtype=np.int8)
    qg, vt = _as_float(dev, dtype, qg, vt)
    bc, bf, bl, rv = (torch.from_numpy(x).to(dev) for x in (bc, bf, bl, rv))
    args = (qg, vt, bc, bf, bl, rv, 20, 256, 128, "full")
    ov, oi = kernel_lab._variant_scan(*args)
    rv_, ri = kernel_lab._variant_scan_reference(*args)
    torch.cuda.synchronize()
    out = bc[torch.nonzero(bl).flatten()].long()
    assert torch.equal(_bits(ov[out]), _bits(rv_[out]))
    fin = rv_[out] > float("-inf")
    assert torch.equal(oi[out][fin], ri[out][fin])


def test_search_device_k20_with_recovery_card_equals_cpu(dev):
    """The public call the recovery pass's 2k pool (k = 40) used to refuse:
    ``search_device(q, 20, 4)`` with the recovery pass, int8, on the card and
    on the CPU."""
    base, queries = make_synthetic(3000, 40, 64, 8, seed=5)
    src = IVFIndex.build(base, nlist=12, metric="l2", dtype="int8", pad_block=256,
                         max_iter=5, device="cpu")
    kw = dict(mode="cluster", qcap=4, recover=True, recover_qcap=16, recover_passes=2)

    def search(device):
        idx = IVFIndex.from_arrays(src._centroids_np, src._vectors_np, src._offsets_np,
                                   src._reorder_np, metric="l2", dtype="int8", pad_block=256,
                                   config=src.config, device=device)
        out = idx.search_device(torch.from_numpy(queries).to(device), 20, 4, **kw)
        return [x.cpu() for x in out], int(idx.last_spill)

    before = ivf_scan.LAUNCHES
    got, spill = search(dev)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES - before == 2 * 2  # two recovery passes, two k-passes each
    want, want_spill = search("cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert spill == want_spill


@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32"])
def test_brute_pallas_rescore_k20_card_equals_cpu(dev, dtype):
    base, queries = make_synthetic(3000, 40, 64, 8, seed=6)
    kw = dict(metric="l2", dtype=dtype, engine="pallas", rescore=True)
    got = BruteForceIndex(base, device=dev, **kw).search_device(
        torch.from_numpy(queries).to(dev), 20)
    torch.cuda.synchronize()
    want = BruteForceIndex(base, device="cpu", **kw).search_device(torch.from_numpy(queries), 20)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_brute_force_defaults_at_d768_card_equals_cpu(dev):
    """``BruteForceIndex(base)`` with every default (ip, bf16, and at N =
    100,000 the accum engine: K5) at a sentence embedding's width; values up
    to 141 keep every fp32 sum exact."""
    base, queries = make_synthetic(100_000, 40, 768, 8, seed=7)
    before = bruteforce_accum.LAUNCHES
    idx = BruteForceIndex(base, device=dev)
    assert idx.engine == "accum"
    got = idx.search_device(torch.from_numpy(queries).to(dev), 10)
    torch.cuda.synchronize()
    assert bruteforce_accum.LAUNCHES - before >= 1
    want = BruteForceIndex(base, device="cpu").search_device(torch.from_numpy(queries), 10)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# K5 fp32 on the register tile (128 rows x 128 bins a CTA): (B, D, N,
# tile_n, group): B past a whole row tile, N not a multiple of tile_n (a
# partial tile and padded ones), group 2 and 16 (the ceded low bits).
# Values -8..8 keep every fp32 sum exact at D 768.
K5_F32_SHAPES = {
    "b200-d129-g2": (200, 129, 5000, 256, 2),
    "b129-d129-g16": (129, 129, 9000, 2048, 16),
    "b70-d384-g16": (70, 384, 3001, 128, 16),
    "b300-d768-g2": (300, 768, 4100, 512, 2),
}


@pytest.mark.parametrize("shape", list(K5_F32_SHAPES))
def test_k5_fp32_tile_edges_bit_equal_to_plain(dev, shape):
    b, d, n, tile_n, group = K5_F32_SHAPES[shape]
    rng = np.random.default_rng(53)
    q = torch.from_numpy(rng.integers(-8, 9, (b, d)).astype(np.float32)).to(dev)
    q[::7] = 0.0  # rows whose every score is +0: ties across every tile
    tiles, _ = bruteforce_accum.tile_base(rng.integers(-8, 9, (d, n)).astype(np.float32),
                                          tile_n, group)
    tiles = tiles.to(dev)
    kw = dict(group=group, depth=group)
    before = bruteforce_accum.LAUNCHES
    v, i = bruteforce_accum.fused_topk_accum(q, tiles, n, 20, **kw)
    rv, ri = bruteforce_accum.fused_topk_accum_reference(q, tiles, n, 20, **kw)
    torch.cuda.synchronize()
    assert bruteforce_accum.LAUNCHES == before + 1
    assert torch.equal(_bits(v), _bits(rv)) and torch.equal(i, ri)
    assert int(i.max()) < n


# K1 fp32 on the register tile (128 routed rows x a chunk's 128 bins a
# CTA): (sizes, blk, qcap, d): qcap 200 (a partial row tile) and 256,
# clusters of 1, 3 and 16 blocks, partial rows_valid, D 129 and 768.
K1_F32_SHAPES = [
    ([2000, 129, 5000], 2048, 200, 129),
    ([300, 16 * 128 - 7, 129], 128, 256, 129),
    ([700, 4100, 40], 2048, 256, 768),
    ([5000, 1, 0, 2048], 2048, 200, 768),
]


@pytest.mark.parametrize("sizes,blk,qcap,d", K1_F32_SHAPES)
@pytest.mark.parametrize("bin2", [True, False], ids=["bin2", "bin1"])
def test_k1_fp32_tile_edges_bit_equal_to_plain(dev, sizes, blk, qcap, d, bin2):
    rng = np.random.default_rng(54)
    lo, hi = (-127, 128) if d <= 129 else (-8, 9)
    qg, vt, bf, bl, rv = _k1_inputs(rng, sizes, blk, qcap, d, lo, hi)
    qg[:, ::7] = 0
    qg, vt = _as_float(dev, "fp32", qg, vt)
    bf, bl, rv = (torch.from_numpy(x).to(dev) for x in (bf, bl, rv))
    before = ivf_accum.LAUNCHES
    got = ivf_accum.cluster_major_accum_planes(qg, vt, bf, bl, rv, blk=blk, bin2=bin2)
    want = ivf_accum.cluster_major_accum_planes_reference(qg, vt, bf, bl, rv, blk=blk,
                                                          bin2=bin2)
    torch.cuda.synchronize()
    assert ivf_accum.LAUNCHES == before + 1
    rows = torch.nonzero(bl).flatten()
    assert torch.equal(got[rows], want[rows])


@pytest.mark.parametrize("k", [33, 64])
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_k10_kernel_wide_k_equal_to_plain(dev, k, variant):
    """K10 past 32 a row: full and nogate in passes of 32 (as K6), maxonly
    and fixedout in one launch that writes the row max to every slot."""
    rng = np.random.default_rng(55)
    qg, vt, bc, bf, bl, rv, _, _ = (None if x is None else torch.from_numpy(x).to(dev)
                                    for x in _k6_inputs(rng, [3000, 2100, 40, 2500], 2048, 24,
                                                        128, True, "dense", False))
    cut = int(torch.nonzero(rv).max()) + 1
    tabs = [x[:cut] for x in (vt, bc, bf, bl, rv)]
    args = (qg, *tabs, k, 2048, 128, variant)
    before = kernel_lab.LAUNCHES
    pv, pr = kernel_lab._variant_scan(*args)
    rv_, rr = kernel_lab._variant_scan_reference(*args)
    torch.cuda.synchronize()
    assert kernel_lab.LAUNCHES - before == (-(-k // 32) if variant in ("full", "nogate") else 1)
    win = _k10_defined(variant, tabs[1], tabs[3])
    assert torch.equal(pv[win], rv_[win])
    fin = rv_[win] > float("-inf")
    assert fin.any()
    assert torch.equal(pr[win][fin], rr[win][fin])


def test_int8_l2_ivf_at_d3072_card_equals_cpu(dev):
    """An int8 L2 ``IVFIndex`` at D 3072 (OpenAI text-embedding-3-large's
    width): ``engine="auto"`` resolves to "pallas" (K4) past K1's key caps,
    and ``search_device`` with its defaults answers on the card as on the
    CPU."""
    base, queries = make_synthetic(3000, 40, 3072, 8, seed=8)
    src = IVFIndex.build(base, nlist=12, metric="l2", dtype="int8", pad_block=256,
                         max_iter=5, device="cpu")

    def search(device):
        idx = IVFIndex.from_arrays(src._centroids_np, src._vectors_np, src._offsets_np,
                                   src._reorder_np, metric="l2", dtype="int8", pad_block=256,
                                   config=src.config, device=device)
        out = idx.search_device(torch.from_numpy(queries).to(device), 10, 4)
        return [x.cpu() for x in out]

    before = ivf_scan.LAUNCHES
    got = search(dev)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES - before >= 1
    want = search("cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Every kernel on every card (F12).  A kernel's launch attributes, such as
# the opt-in past 48 KB of dynamic shared memory, belong to one device: a
# wrapper that sets them once a process has every card after the first
# refuse the launch.  Each case runs its kernel's card tests at shapes whose
# launch takes more than 48 KB of dynamic shared memory, on cuda:0 and then
# on each further card in turn, with cuda:0 left current; each test holds
# the kernel against its plain version as it does on one card (bit-equal,
# or within its stated bf16 bound).  K8 also keeps its own,
# test_k8_kernel_on_every_card, at another shape.


def _k12_k13_graphed(card):
    """K13 at depth 8 and K12's product (int8, fat 4) captured in one CUDA
    graph on ``card`` and replayed (``timing.graph_ms`` through
    ``hw_probe._graph_ms``): every captured launch counted once a replay,
    the replayed results equal to the plain versions."""
    gen = _probe_gen(card, 59)
    data = _rand_op((70, 128, 2048), torch.int8, gen, card)
    walk, _ = hw_probe._planted_walk(64, 128, 2048, 4, torch.int8, gen)
    xw, x1 = _rand_op((128, 128), torch.int8, gen, card), torch.zeros((8, 128), device=card)
    out = torch.full((2,), float("nan"), device=card)

    def both():
        out[:1].copy_(hw_probe._dma_probe(x1, data, 8))
        out[1:].copy_(hw_probe._stream_probe(xw, walk, 2048, 4, True, None))

    before = dict(hw_probe.LAUNCHES)
    assert hw_probe._graph_ms(both, card, 2) > 0
    torch.cuda.synchronize(card)
    # Two warm-up calls, then two captured calls run by 3 + 1 replays; K13
    # launches two kernels a call, K12 one.
    assert hw_probe.LAUNCHES["K13"] - before["K13"] == 2 * (2 + 2 * 4)
    assert hw_probe.LAUNCHES["K12"] - before["K12"] == 2 + 2 * 4
    assert torch.equal(out[:1], hw_probe._dma_probe_reference(x1, data, 8))
    assert torch.equal(out[1:], hw_probe._stream_probe_reference(xw, walk, 2048, 4, True, None))


def _k14_wide(card):
    # wgmma with B resident at the 16 k-step cap (int8 d 512, bf16 d 256),
    # the chunked kernel past it (640 bytes of K), dp4a's wide tiles.
    for dtype, unit, d in ((torch.int8, "mma", "cap"), (torch.bfloat16, "mma", "cap"),
                           (torch.int8, "mma", "640B"), (torch.bfloat16, "mma", "640B"),
                           (torch.int8, "dp4a", "cap"), (torch.int8, "dp4a", "odd")):
        test_k14_kernel_equal_to_plain(card, dtype, unit, 65, 130, d, 37, True)


EVERY_CARD = {
    "K1": lambda c: test_k1_kernel_bit_equal_to_plain(c, *K1_SHAPES[0], False, True),
    "K2": lambda c: test_k2_kernel_wide_rows_equal_to_plain(c, 16512, "int32", 20),
    "K3": lambda c: test_k3_kernel_equal_to_plain(c, "t2048-d512", 128, "i8_l2"),
    "K4": lambda c: test_k4_kernel_equal_to_plain(c, *K4_SHAPES[0].values, 2, True, False),
    "K5": lambda c: test_k5_kernel_equal_to_plain(c, "l2"),
    "K6": lambda c: test_k6_kernel_equal_to_plain(c, *K6_SHAPES[0].values, 2, True, "dense"),
    "K7": lambda c: test_k7_kernel_equal_to_plain_and_to_k4_k6(c, *K4_SHAPES[0].values, 2,
                                                                True, False),
    "K8": lambda c: [test_k8_kernel_equal_to_plain(c, "tiles", dt)
                     for dt in ("int8", "bf16", "fp32")],
    "K9": lambda c: test_k9_kernel_equal_to_plain(c, *K1_SHAPES[0][:4], (-127, 128), "l2bias",
                                                  True, 20),
    "K10": lambda c: test_k10_kernel_equal_to_plain_and_full_to_k6(
        c, *K6_SHAPES[0].values[:6], "full"),
    "K11": lambda c: [test_k11_kernel_equal_to_plain(c, 300, True, sem)
                      for sem in hw_probe.SEMANTICS],
    "K12": lambda c: [test_k12_kernel_equal_to_plain_at_jax_width(c, dt, True, sem)
                      for dt in (torch.int8, torch.bfloat16) for sem in (None, "arbitrary")]
    + [test_k12_product_past_the_old_caps_equal_to_plain(c, dt, 300, 1100, 515)
       for dt in (torch.int8, torch.bfloat16)],
    "K13": lambda c: [test_k13_kernel_equal_to_plain(c, dt, (70, 128, 2048), 8)
                      for dt in (torch.int8, torch.bfloat16)],
    "K14": _k14_wide,
    "K12-K13-graph": _k12_k13_graphed,
}


@pytest.mark.parametrize("kernel", list(EVERY_CARD))
def test_every_kernel_on_every_card(dev, kernel):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    for i in range(torch.cuda.device_count()):
        EVERY_CARD[kernel](torch.device("cuda", i))
