"""The port's native exact-search oracle (``runtime/oracle.py``, its two C++
sources built into the port's build directory) on the CPU: the six cases
of ``tests/test_oracle.py`` run on the port's copy, and its ids and scores
held equal to the JAX package's oracle (the same C++ code, built apart).
Scores are compared as ``tests/test_oracle.py`` compares them: by the
exact scores of the returned ids, sorted (ties may order ids either way),
rtol 1e-4; the two oracles against each other exactly."""

import subprocess

import numpy as np
import pytest

from rag_on_edge_tpu.runtime import oracle as joracle
from rag_on_edge_tpu_torch.ops import _build
from rag_on_edge_tpu_torch.runtime import oracle
from rag_on_edge_tpu_torch.utils import io
from rag_on_edge_tpu_torch.utils.datasets import ground_truth


def test_native_builds_into_the_build_dir():
    assert oracle.native_available(), "native oracle failed to build (g++ expected)"
    path = oracle.build_library()
    assert path.startswith(str(_build.BUILD_DIR)) and path.endswith(".so")
    assert oracle.build_library() == path  # hashed name: built once


def _exact(base, q, ids, metric):
    b = base[ids].astype(np.float64)
    q = q.astype(np.float64)
    return b @ q if metric == "ip" else -np.sum((b - q) ** 2, axis=1)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_oracle_matches_exact_gt(small_data, metric):
    base, queries = small_data
    ids, _ = oracle.oracle_search(queries, base, k=10, metric=metric)
    gt = ground_truth(base, queries, 10, metric=metric, device="cpu")
    for row_ids, row_gt, q in zip(ids, gt, queries):
        np.testing.assert_allclose(np.sort(_exact(base, q, row_ids, metric)),
                                   np.sort(_exact(base, q, row_gt, metric)), rtol=1e-4)


def test_oracle_scores_descending(small_data):
    base, queries = small_data
    _, scores = oracle.oracle_search(queries, base, k=10, metric="ip")
    assert (np.diff(scores, axis=1) <= 1e-6).all()


def test_oracle_input_validation(small_data):
    base, queries = small_data
    with pytest.raises(ValueError, match="metric"):
        oracle.oracle_search(queries, base, k=5, metric="cosine")
    with pytest.raises(ValueError, match="dim"):
        oracle.oracle_search(queries[:, :64], base, k=5)
    with pytest.raises(ValueError, match="k="):
        oracle.oracle_search(queries, base, k=0)
    with pytest.raises(ValueError, match="k="):
        oracle.oracle_search(queries, base, k=len(base) + 1)


def test_numpy_fallback_matches_native(small_data):
    base, queries = small_data
    ids_n, s_n = oracle.oracle_search(queries[:8], base, k=5, metric="ip")
    ids_f, s_f = oracle._numpy_fallback(
        queries[:8].astype(np.float32), base.astype(np.float32), 5, "ip")
    np.testing.assert_allclose(s_n, s_f, rtol=1e-5)


def test_standalone_binary(tmp_path, small_data):
    path = oracle.build_binary()
    assert path and path.startswith(str(_build.BUILD_DIR)), "cpu_oracle binary failed to build"
    base, queries = small_data
    io.write_fvecs(tmp_path / "base.fvecs", base)
    io.write_fvecs(tmp_path / "query.fvecs", queries[:8])
    out = subprocess.run(
        [path, str(tmp_path / "base.fvecs"), str(tmp_path / "query.fvecs"), "5",
         str(tmp_path), "ip"],
        capture_output=True, text=True, check=True)
    assert "throughput_qps" in out.stdout
    lines = (tmp_path / "results.txt").read_text().strip().splitlines()
    assert len(lines) == 8 and lines[0].startswith("Query 0:")
    ids, _ = oracle.oracle_search(queries[:1], base, k=5, metric="ip")
    assert f"({ids[0, 0]}," in lines[0]


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_oracle_equals_jax_oracle(small_data, metric, tmp_path, monkeypatch):
    # The JAX oracle builds its library in place; here it builds under
    # tmp_path, so no other test process can load a half-written file.
    monkeypatch.setattr(joracle, "_LIB", str(tmp_path / "libcpu_oracle.so"))
    monkeypatch.setattr(joracle, "_lib", None)
    monkeypatch.setattr(joracle, "_build_failed", False)
    base, queries = small_data
    ids, scores = oracle.oracle_search(queries, base, k=10, metric=metric)
    jids, jscores = joracle.oracle_search(queries, base, k=10, metric=metric)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(scores, jscores)
