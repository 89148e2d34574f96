"""Parity of the port's spatial GEMM (kernel K8's plain version,
``spatial_matmul``, ``preprocess`` and ``bench_gemm``) with the JAX
package's, on the CPU.

The same numpy inputs go to both packages.  int8 products must be exact.
Float products are held to the worst-case bound of an fp32 sum of K
products taken in any order, ``|C - C'| <= 2·K·2**-24·(|A| @ |B|)``
elementwise: the two packages sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_on_edge_tpu.harness import bench_gemm as jbench
from rag_on_edge_tpu.ops.pallas_matmul import tiled_matmul as jtiled
from rag_on_edge_tpu.parallel import spatial_gemm as jspatial
from rag_on_edge_tpu.utils import preprocess as jpre
from rag_on_edge_tpu_torch.harness import bench_gemm as tbench
from rag_on_edge_tpu_torch.ops import tiled_matmul as ttiled
from rag_on_edge_tpu_torch.parallel import spatial_gemm as tspatial
from rag_on_edge_tpu_torch.utils import preprocess as tpre

CPU = torch.device("cpu")


def _inputs(dtype, m, k, n, seed=5):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return (rng.integers(-128, 128, (m, k), dtype=np.int8),
                rng.integers(-128, 128, (k, n), dtype=np.int8))
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _to_jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else None)


def _to_torch(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _assert_product(got, want, a, b, dtype):
    """int8 exact; floats within the fp32 summation bound."""
    if dtype == "int8":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        return
    assert got.dtype == np.float32
    af, bf = np.abs(np.asarray(a, np.float64)), np.abs(np.asarray(b, np.float64))
    bound = 2.0 * a.shape[1] * 2.0**-24 * (af @ bf)
    assert (np.abs(got.astype(np.float64) - want.astype(np.float64)) <= bound).all()


# test_spatial_gemm.py's shapes and tiles, and one ragged shape per dtype
# (no dimension a multiple of the tiles; int8 K not a multiple of 16).
K8_CASES = {
    "fp32-300x200x450": ("fp32", 300, 200, 450, dict(bm=128, bn=256, bk=128)),
    "int8-64x128x256": ("int8", 64, 128, 256, dict(bm=64, bn=128, bk=64)),
    "int8-ragged": ("int8", 37, 70, 45, dict(bm=16, bn=32, bk=32)),
    "bf16-ragged": ("bf16", 20, 50, 33, dict(bm=16, bn=32, bk=16)),
    "fp32-ragged": ("fp32", 19, 33, 7, dict(bm=8, bn=8, bk=16)),
}


@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_plain_equals_jax(case):
    dtype, m, k, n, tiles = K8_CASES[case]
    a, b = _inputs(dtype, m, k, n)
    want = np.asarray(jtiled(_to_jax(a, dtype), _to_jax(b, dtype), **tiles))
    got = ttiled.tiled_matmul(_to_torch(a, dtype), _to_torch(b, dtype), **tiles)
    if dtype == "bf16":
        a, b = (np.asarray(_to_torch(x, dtype).float()) for x in (a, b))
    _assert_product(got.numpy(), want, a, b, dtype)


def test_k8_int8_exact_past_fp32_range():
    """K = 3000 int8 products sum past 2**24: the plain version's K tiles
    keep every fp32 partial exact, and the int32 sum is exact."""
    a = np.full((3, 3000), -128, np.int8)
    b = np.full((3000, 5), -128, np.int8)
    got = ttiled.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b), bk=3000)
    assert (got.numpy() == 3000 * 128 * 128).all()


@pytest.mark.parametrize("k,n", [(21, 45), (21, 48), (48, 45)], ids=["kn", "k", "n"])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32"])
def test_k8_kernel_operands_padded_and_aligned(dtype, k, n):
    """The operands the CUDA branch hands its kernel: K and N zero-padded to
    16-byte row pitches, each base 16-byte aligned (int8's B: 4 bytes of
    pitch and base); their plain product, cut to [M, N], is the unpadded
    one.  Operands that comply pass as they are."""
    a, b = (_to_torch(x, dtype) for x in _inputs(dtype, 37, k, n))

    def shifted(x):  # a contiguous view one element off its allocation's start
        buf = torch.empty(x.numel() + 1, dtype=x.dtype)
        return buf[1:].view(x.shape).copy_(x)

    a, b = shifted(a), shifted(b)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    pa, pb = ttiled.kernel_operands(a, b)
    es, b_bytes = a.element_size(), 4 if dtype == "int8" else 16
    kp, np_ = pa.shape[1], pb.shape[1]
    assert pa.shape == (37, kp) and pb.shape == (kp, np_)
    assert kp * es % 16 == 0 and np_ * es % b_bytes == 0 and 0 <= kp - k < 16 // es
    assert 0 <= np_ - n < b_bytes // es
    assert pa.is_contiguous() and pb.is_contiguous()
    assert pa.data_ptr() % 16 == 0 and pb.data_ptr() % b_bytes == 0
    assert not pa[:, k:].any() and not pb[k:].any() and not pb[:, n:].any()
    assert torch.equal(pa[:, :k], a) and torch.equal(pb[:k, :n], b)
    got = ttiled.tiled_matmul_reference(pa, pb)[:, :n]
    want = ttiled.tiled_matmul_reference(a, b)
    af, bf = (x.float().numpy() if dtype == "bf16" else x.numpy() for x in (a, b))
    _assert_product(got.numpy(), want.numpy(), af, bf, dtype)
    x, y = (_to_torch(v, dtype) for v in _inputs(dtype, 5, 32, 64))
    if dtype == "int8":  # B 4 bytes off a 16-byte boundary, N = 44
        y = torch.empty(32 * 44 + 4, dtype=torch.int8)[4:].view(32, 44).copy_(y[:, :44])
        assert y.data_ptr() % 16
    px, py = ttiled.kernel_operands(x, y)
    assert px is x and py is y


def test_k8_refusals_match_jax():
    for (ja, jb), (ta, tb), match in (
            ((jnp.zeros((4, 8)), jnp.zeros((9, 4))),
             (torch.zeros((4, 8)), torch.zeros((9, 4))), "contraction"),
            ((jnp.zeros((4, 8), jnp.int8), jnp.zeros((8, 4))),
             (torch.zeros((4, 8), dtype=torch.int8), torch.zeros((8, 4))), "dtype mismatch")):
        with pytest.raises(ValueError, match=match):
            jtiled(ja, jb)
        with pytest.raises(ValueError, match=match):
            ttiled.tiled_matmul(ta, tb)


def test_preprocess_bit_equal():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(33, 128)).astype(np.float32)
    b = rng.normal(size=(1000, 128)).astype(np.float32)
    assert tpre.l2_normalize(q).tobytes() == jpre.l2_normalize(q).tobytes()
    assert tpre.pad_to_multiple(q, 32).tobytes() == jpre.pad_to_multiple(q, 32).tobytes()
    aligned = q[:32]
    assert tpre.pad_to_multiple(aligned, 32) is aligned
    for got, want in zip(tpre.prepare_int8_operands(q, b), jpre.prepare_int8_operands(q, b)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


# The reference workload shape on 2x4 (int8, exact) and fp32 on 4x2, as
# test_spatial_gemm.py runs them, through both local products.
SPATIAL_CASES = {"int8-2x4": ("int8", 2, 4, 128, 128, 2560), "fp32-4x2": ("fp32", 4, 2, 256, 64, 128)}


@pytest.mark.parametrize("pallas", [True, False], ids=["k8", "plain"])
@pytest.mark.parametrize("case", list(SPATIAL_CASES))
def test_spatial_matmul_equals_jax(case, pallas):
    dtype, rows, cols, m, k, n = SPATIAL_CASES[case]
    a, b = _inputs(dtype, m, k, n, seed=11)
    if dtype == "int8":  # the JAX test's range
        a, b = np.maximum(a, -127), np.maximum(b, -127)
    want = np.asarray(jspatial.spatial_matmul(jnp.asarray(a), jnp.asarray(b),
                                              jspatial.make_mesh_2d(rows, cols),
                                              use_pallas_kernel=pallas))
    got = tspatial.spatial_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                  [[CPU] * cols] * rows, use_pallas_kernel=pallas).numpy()
    _assert_product(got, want, a, b, dtype)
    assert tspatial.verify_matmul(a, b, got)


def test_spatial_matmul_refusals():
    a, b = torch.zeros((6, 4)), torch.zeros((4, 8))
    with pytest.raises(ValueError, match="rows"):
        tspatial.spatial_matmul(a, b, [[CPU]] * 4)
    with pytest.raises(ValueError, match="cols"):
        tspatial.spatial_matmul(a, b, [[CPU] * 3])
    with pytest.raises(ValueError, match="contraction"):
        tspatial.spatial_matmul(a, torch.zeros((5, 8)), [[CPU]])
    with pytest.raises(ValueError, match="requested 4 devices"):
        tspatial.make_mesh_2d(2, 2, device_type="cpu")
    assert tspatial.make_mesh_2d(1, 1, device_type="cpu") == [[CPU]]


def test_verify_matmul_catches_errors():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(8, 16)).astype(np.float32)
    c = a @ b
    assert tspatial.verify_matmul(a, b, c) and jspatial.verify_matmul(a, b, c)
    c_bad = c.copy()
    c_bad[3, 7] += 1.0
    assert not tspatial.verify_matmul(a, b, c_bad)
    assert not jspatial.verify_matmul(a, b, c_bad)


def test_bench_gemm_run_matches_jax():
    """The benchmark on a 2x2 CPU grid: the JAX package's inputs and
    result keys (plus the device), verified through both local products."""
    for dtype in ("int8", "bf16", "fp32"):
        ja, jb = jbench._make_inputs(32, 64, 256, dtype, 0)
        ta, tb = tbench._make_inputs(32, 64, 256, dtype, 0)
        np.testing.assert_array_equal(ta.float().numpy(), np.asarray(ja, np.float32))
        np.testing.assert_array_equal(tb.float().numpy(), np.asarray(jb, np.float32))
    want = jbench.run(m=32, k=64, n=256, dtype="int8", rows=2, cols=2, iters=3, stack=2,
                      quiet=True)
    mesh = [[CPU] * 2] * 2
    got = tbench.run(m=32, k=64, n=256, dtype="int8", iters=3, stack=2, quiet=True, mesh=mesh)
    assert set(got) == set(want) | {"device"}
    assert got["verified"] and want["verified"]
    assert got["mesh"] == want["mesh"] == "2x2" and got["kernel"] == want["kernel"] == "pallas"
    assert got["gflops_sustained"] > 0 and got["sync_p50_us"] > 0
    got = tbench.run(m=32, k=64, n=256, dtype="fp32", iters=3, stack=2, pallas=False,
                     quiet=True, mesh=mesh)
    assert got["verified"] and got["kernel"] == "xla"
