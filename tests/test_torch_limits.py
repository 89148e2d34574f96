"""The port's selection past its CUDA kernels' old limits, on the CPU: K2's
segment-and-merge for rows wider than a warp's shared memory holds, K3's
fp32 split-and-merge, and the passes of 32 that K3's int8 and bf16 modes,
K4, K6 and K7 run for k > 32.  Each is a plain function that takes the
per-part selection as an argument, so the code the card runs around its
kernels runs here with the plain versions, against the JAX kernels in
interpret mode.  The kernels themselves are held to these on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.ops.pallas_bruteforce import fused_topk_matmul as jax_fused_topk_matmul
from rag_on_edge_tpu.ops.pallas_topk import fused_topk as jax_fused_topk
from rag_on_edge_tpu_torch.ops import _build, bruteforce_fused, fused_topk, topk


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
