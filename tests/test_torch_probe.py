"""Parity of the port's hardware probes (kernels K11-K14,
``rag_on_edge_tpu_torch/harness/hw_probe.py``) with the JAX package's, on
the CPU.

The JAX probes have no ``interpret=`` argument; they run here inside
``pltpu.force_tpu_interpret_mode()``.  Numpy-seeded toy inputs go through
each JAX kernel and the port's plain version.  Tolerances: every value is
exact (int8 products are integers below 2**24, maxima of bf16 values are
bf16 values) except the bf16 products of K12 and K14, which differ by the
order of two fp32 sums of K terms: within 2·K·2**-24·max(|A| @ |B|) (the
max of two matrices moves by at most their largest entry difference).
The bf16 twist of K14 is bit-equal.  Then each ``probe_*`` function runs
once at toy size on ``device="cpu"`` and must print its rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rag_on_edge_tpu.harness import hw_probe as jhp
from rag_on_edge_tpu_torch.harness import hw_probe as thp

D, BLK, M = 32, 256, 16


def _pair(a, dtype):
    """One numpy array as (jax, torch) operands of ``dtype`` ("int8",
    "bf16", "f32") with the same bits."""
    if dtype == "bf16":
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j).astype(np.float32)).to(torch.bfloat16)
    j = jnp.asarray(a)
    return j, torch.from_numpy(np.ascontiguousarray(a))


def _operand(rng, shape, dtype):
    if dtype == "int8":
        return _pair(rng.integers(-127, 127, shape, dtype=np.int8), dtype)
    return _pair(rng.standard_normal(shape).astype(np.float32), dtype)


def _jax(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args), np.float32)


def _bf16_bound(a, b):
    """2·K·2**-24·max(|A| @ |B|) in fp64, A [.., m, K], B [.., K, n]."""
    prod = torch.matmul(a.double().abs(), b.double().abs())
    return 2.0 * a.shape[-1] * 2.0**-24 * float(prod.max())


@pytest.mark.parametrize("semantics", [None, "parallel"])
@pytest.mark.parametrize("moving", [False, True], ids=["pinned", "moving"])
def test_k11_step_probe_equals_jax(moving, semantics):
    xj, xt = _operand(np.random.default_rng(11), (8, 128), "f32")
    want = _jax(jhp._step_probe, xj, 5, moving, semantics)
    got = thp._step_probe(xt, 5, moving, semantics)
    assert got.shape == (1,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fat,gemm", [(1, False), (2, True)], ids=["fat1", "fat2-gemm"])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_k12_stream_probe_equals_jax(dtype, fat, gemm):
    # Every step holds a planted max above the bulk, distinct from its
    # neighbours'; the first step also holds the walk's max, which is not
    # what lands.
    rng = np.random.default_rng(12)
    g = 4 // fat
    if dtype == "int8":
        raw = rng.integers(-127, -100, (g, fat * D * BLK)).astype(np.float32)
        tops, decoy = -100.0 + (37 * np.arange(g)) % 226, 127
    else:
        raw = rng.standard_normal((g, fat * D * BLK)).clip(-7.5, 7.5).astype(np.float32)
        tops, decoy = 8.0 + 0.25 * rng.permutation(g), 64.0
    raw[np.arange(g), rng.integers(0, raw.shape[1], g)] = tops
    raw[0, 0] = decoy
    raw = raw.reshape(4, D, BLK)
    dj, dt = _pair(raw.astype(np.int8) if dtype == "int8" else raw, dtype)
    xj, xt = _operand(rng, (M, D), dtype)
    want = _jax(jhp._stream_probe, xj, dj, BLK, fat, gemm, None)
    got = thp._stream_probe(xt, dt, BLK, fat, gemm, None)
    assert got.shape == (1,) and got.dtype == torch.float32
    if dtype == "bf16" and gemm:
        last = dt[-fat:].float()
        assert abs(float(got[0]) - float(want[0])) <= _bf16_bound(xt.float(), last)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    if not gemm:
        assert float(got[0]) == tops[-1] < decoy
        assert thp._stream_steps(xt, dt, BLK, fat, gemm, None).tolist() == [decoy, *tops[1:]]


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_k13_dma_probe_equals_jax(dtype, depth):
    rng = np.random.default_rng(13)
    raw = (rng.integers(-100, 100, (6, 16, 128)).astype(np.float32) if dtype == "int8"
           else rng.standard_normal((6, 16, 128)).astype(np.float32))
    raw[3, 5, 9] = 110  # in the last whole group of 4
    raw[5, 3, 7] = 120  # in a block past it
    dj, dt = _pair(raw.astype(np.int8) if dtype == "int8" else raw, dtype)
    xj, xt = _pair(np.zeros((8, 128), np.float32), "f32")
    want = _jax(jhp._dma_probe, xj, dj, depth)
    got = thp._dma_probe(xt, dt, depth)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0]) == (120 if depth == 1 else 110)


@pytest.mark.parametrize("sel", [False, True], ids=["max", "sel"])
@pytest.mark.parametrize("dtype,unit", [("int8", "mma"), ("int8", "dp4a"), ("bf16", "mma")])
def test_k14_gemm_rate_probe_equals_jax(dtype, unit, sel):
    rng = np.random.default_rng(14)
    qj, qt = _operand(rng, (M, D), dtype)
    vj, vt = _operand(rng, (D, BLK), dtype)
    xj, xt = _pair(np.zeros((8, 128), np.float32), "f32")
    g = 19  # > tb: the twisted row wraps to (g - 1) % tb = 2
    want = _jax(jhp._gemm_rate_probe, xj, qj, vj, g, M, BLK, sel)
    got = thp._gemm_rate_probe(xt, qt, vt, g, M, BLK, sel, unit)
    assert got.shape == (1,) and got.dtype == torch.float32
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        qx = thp._twisted_q(qt, torch.tensor([g - 1]), torch.float32)[0]
        assert abs(float(got[0]) - float(want[0])) <= _bf16_bound(qx, vt.float())
    steps = thp._gemm_rate_steps(qt, vt, g, M, BLK, sel, unit)
    assert steps.shape == (g,) and torch.equal(steps[-1:], got)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_k14_twist_bit_equal_to_jax(dtype):
    qj, qt = _operand(np.random.default_rng(15), (M, D), dtype)
    for i in (0, 2, 18, 1999):
        if dtype == "int8":
            rows = np.arange(M)[:, None] == i % M
            want = np.asarray(jnp.where(jnp.asarray(rows), jnp.int8(1), qj))
        else:
            want = np.asarray(qj * (1.0 + jnp.int32(i)).astype(jnp.bfloat16))
        got = thp._twisted_q(qt, torch.tensor([i]), qt.dtype)[0]
        if dtype == "bf16":  # compare bits
            want = want.astype(np.float32).view(np.uint32)
            got = got.float().numpy().view(np.uint32)
        np.testing.assert_array_equal(np.asarray(got), want)


def test_probes_refuse_bad_arguments():
    x = torch.zeros((8, 128))
    data = torch.zeros((3, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        thp._step_probe(x, 4, False, "sequential")
    with pytest.raises(ValueError):
        thp._stream_probe(x, data, 8, 2, False, None)  # fat does not divide nblocks
    with pytest.raises(ValueError):
        thp._dma_probe(x, data.float(), 1)
    with pytest.raises(ValueError):
        thp._gemm_rate_probe(x, torch.zeros((4, 8), dtype=torch.bfloat16),
                             torch.zeros((8, 16), dtype=torch.bfloat16), 2, 4, 16, False, "dp4a")
    with pytest.raises(ValueError):  # the products take d·elem <= 512, as the kernels do
        thp._gemm_rate_probe(x, torch.zeros((4, 513), dtype=torch.int8),
                             torch.zeros((513, 16), dtype=torch.int8), 2, 4, 16, False)
    with pytest.raises(ValueError):
        thp._stream_probe(torch.zeros((4, 257), dtype=torch.bfloat16),
                          torch.zeros((2, 257, 8), dtype=torch.bfloat16), 8, 1, True, None)


def _rows(out, head):
    lines = out.splitlines()
    assert lines[0].startswith("==") and head in lines[0]
    return lines[1:]


def test_probe_functions_print_their_rows_on_cpu(capsys):
    res = thp.probe_xla(repeats=1, device="cpu", nbytes=1 << 16,
                        gemms=((32, 64, 64, torch.int8), (32, 64, 64, torch.bfloat16)))
    rows = _rows(capsys.readouterr().out, "ceilings")
    assert [r.split()[0] for r in rows] == ["gemm"] * 2 + ["reduce", "copy"] * 3
    assert set(res["copy"]) == {"int8", "bfloat16", "float32"}

    res = thp.probe_pallas_step(repeats=1, device="cpu", grids=(2, 4))
    rows = _rows(capsys.readouterr().out, "step")
    assert len(rows) == 7 and all("slope=" in r for r in rows[:6])
    assert "not measured" in rows[6] and res["launch_us"]["graph"] is None

    res = thp.probe_pallas_stream(repeats=1, device="cpu", total=1 << 17, blks=(256,), d=16)
    rows = _rows(capsys.readouterr().out, "streaming")
    assert len(rows) == 16 == len(res) and all("GB/s" in r for r in rows)

    res = thp.probe_pallas_dma(repeats=1, device="cpu", total=1 << 17,
                               cases=((torch.int8, 128),), depths=(1, 4), d=16)
    rows = _rows(capsys.readouterr().out, "marginal")
    assert len(rows) == 2 == len(res) and all("marginal" in r for r in rows)

    res = thp.probe_pallas_gemm(repeats=1, device="cpu", shapes=((16, 64),), gs=(2, 4), d=16)
    rows = _rows(capsys.readouterr().out, "GEMM rate")
    assert len(rows) == 3 and rows[1].endswith("unit=dp4a") and "bfloat16" in rows[2]
    assert set(res) == {("int8", 16, 64, "mma"), ("int8", 16, 64, "dp4a"),
                        ("bfloat16", 16, 64, "mma")}
