"""The port's dataset IO (``utils/io.py``, ``utils/datasets.load_dataset``)
against the JAX package's, on the CPU: both read and write the same files,
so they share one ``data/<name>`` cache."""

import numpy as np
import pytest

from rag_on_edge_tpu.utils import datasets as jds
from rag_on_edge_tpu.utils import io as jio
from rag_on_edge_tpu_torch.utils import datasets as tds
from rag_on_edge_tpu_torch.utils import io as tio

FORMATS = {
    "fvecs": (lambda r: r.normal(size=(17, 12)).astype(np.float32), "write_fvecs", "read_fvecs"),
    "ivecs": (lambda r: r.integers(0, 10_000, (9, 100)).astype(np.int32), "write_ivecs",
              "read_ivecs"),
}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_vecs_written_by_one_package_read_by_the_other(tmp_path, fmt, writer):
    make, write, read = FORMATS[fmt]
    arr = make(np.random.default_rng(2))
    src, dst = (tio, jio) if writer == "port" else (jio, tio)
    path = tmp_path / f"x.{fmt}"
    getattr(src, write)(path, arr)
    back = getattr(dst, read)(path)
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(getattr(dst, read)(path, max_vectors=3), arr[:3])


def test_bvecs_read_equal(tmp_path):
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, (6, 20), dtype=np.uint8)
    rec = np.concatenate([np.full((6, 1), 20, np.int32).view(np.uint8), arr], axis=1)
    path = tmp_path / "x.bvecs"
    rec.tofile(path)
    np.testing.assert_array_equal(tio.read_bvecs(path), arr)
    np.testing.assert_array_equal(tio.read_bvecs(path), jio.read_bvecs(path))


def test_refusals_match_jax(tmp_path):
    arr = np.random.default_rng(5).normal(size=(4, 8)).astype(np.float32)
    trunc = tmp_path / "trunc.fvecs"
    tio.write_fvecs(trunc, arr)
    trunc.write_bytes(trunc.read_bytes()[:-4])
    bad = tmp_path / "bad.fvecs"
    np.array([3, 0, 0, 0, 2, 0, 0, 0], dtype=np.int32).tofile(bad)  # dim 3, then dim 2
    badb = tmp_path / "bad.bvecs"
    rec = np.zeros((2, 8), np.uint8)  # two 4-byte records: dim 4, then dim 3
    rec[0, :4] = np.frombuffer(np.int32(4).tobytes(), np.uint8)
    rec[1, :4] = np.frombuffer(np.int32(3).tobytes(), np.uint8)
    rec.tofile(badb)
    for path, read, match in ((trunc, "read_fvecs", "truncated"),
                              (bad, "read_fvecs", "inconsistent"),
                              (badb, "read_bvecs", "inconsistent")):
        for mod in (tio, jio):
            with pytest.raises(ValueError, match=match):
                getattr(mod, read)(path)
    empty = tmp_path / "empty.fvecs"
    empty.write_bytes(b"")
    assert tio.read_fvecs(empty).size == 0 == jio.read_fvecs(empty).size


def test_load_dataset_shared_with_jax(tmp_path, monkeypatch):
    """The port synthesizes and caches ``unit``; the JAX package reads the
    cache back (no file is rewritten) with equal arrays, and the port's
    ground truth equals the JAX package's own."""
    root = str(tmp_path)
    t = tds.load_dataset("unit", root=root, gt_k=10, device="cpu")
    assert t.base.shape == (2048, 128) and t.queries.shape == (32, 128)
    assert t.ground_truth_ip.shape == t.ground_truth_l2.shape == (32, 10) and t.gt_k == 10
    files = {p.name: p.stat().st_mtime_ns for p in (tmp_path / "unit").iterdir()}
    assert len(files) == 5  # base, queries, two ground truths, the manifest

    def no_recompute(*args, **kw):
        raise AssertionError("the JAX package recomputed a cached ground truth")

    monkeypatch.setattr(jds, "ground_truth", no_recompute)
    j = jds.load_dataset("unit", root=root, gt_k=10)
    assert {p.name: p.stat().st_mtime_ns for p in (tmp_path / "unit").iterdir()} == files
    monkeypatch.undo()
    for name in ("base", "queries", "ground_truth_ip", "ground_truth_l2"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert (t.name, t.gt_k, t.meta, t.dim) == (j.name, j.gt_k, j.meta, j.dim)
    for metric in ("ip", "l2"):
        np.testing.assert_array_equal(t.gt(metric), jds.ground_truth(t.base, t.queries, 10,
                                                                     metric=metric))
    # And back: the port reads what it wrote, and refuses a truncated cache.
    t2 = tds.load_dataset("unit", root=root, gt_k=10, device="cpu")
    np.testing.assert_array_equal(t2.ground_truth_l2, t.ground_truth_l2)
    base_path = tmp_path / "unit" / "unit_base.fvecs"
    base_path.write_bytes(base_path.read_bytes()[: 129 * 4 * 2000])
    with pytest.raises(ValueError, match="manifest"):
        tds.load_dataset("unit", root=root, gt_k=10, device="cpu")
    with pytest.raises(KeyError):
        tds.load_dataset("nope", root=root, device="cpu")


def test_default_data_root_is_the_jax_packages():
    import os

    assert os.path.realpath(tds.DEFAULT_DATA_ROOT) == os.path.realpath(jds.DEFAULT_DATA_ROOT)
