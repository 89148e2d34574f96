"""k-means checkpoint and resume in the PyTorch port, on the CPU: the JAX
package's four checkpoint tests (``tests/test_kmeans.py``) run against the
port's ``kmeans``, and the checkpoint file is carried across packages in
both directions.

The file format is the JAX package's: an ``.npz`` of ``centroids``,
``prev_centroids``, ``next_iter``, ``seed`` and ``done``.  The corpus is
integer-valued, so a cluster's sum is exact in fp32 in any order, and one
Lloyd step from the same centroids gives the same assignment in both
packages; the centroids are held within rtol 1e-5 (their division).
"""

import numpy as np

from rag_on_edge_tpu.models import kmeans as jkmeans
from rag_on_edge_tpu_torch.models import kmeans


def _km(base, nlist, **kw):
    return kmeans.kmeans(base, nlist, device="cpu", **kw)


def test_kmeans_checkpoint_resume_replays_trajectory(small_data, tmp_path):
    """A run resumed from a mid-build checkpoint lands on the exact
    centroids of an uninterrupted run (the checkpoint is the loop state)."""
    base, _ = small_data
    ck = str(tmp_path / "km.ckpt.npz")
    ref_c, ref_a = _km(base, 16, seed=42, max_iter=8, tol=0.0)
    _km(base, 16, seed=42, max_iter=3, tol=0.0, checkpoint=ck)
    assert int(np.load(ck)["next_iter"]) == 3
    c2, a2 = _km(base, 16, seed=42, max_iter=8, tol=0.0, checkpoint=ck)
    np.testing.assert_array_equal(ref_c, c2)
    np.testing.assert_array_equal(ref_a, a2)


def test_kmeans_checkpoint_mismatch_is_ignored(small_data, tmp_path):
    """A checkpoint from a different seed or shape is not loaded."""
    base, _ = small_data
    ck = str(tmp_path / "km.ckpt.npz")
    _km(base, 16, seed=7, max_iter=2, tol=0.0, checkpoint=ck)
    ref_c, _ = _km(base, 16, seed=42, max_iter=2, tol=0.0)
    c2, _ = _km(base, 16, seed=42, max_iter=2, tol=0.0, checkpoint=ck)
    np.testing.assert_array_equal(ref_c, c2)
    c3, _ = _km(base, 8, seed=7, max_iter=2, tol=0.0, checkpoint=ck)  # another shape
    np.testing.assert_array_equal(c3, _km(base, 8, seed=7, max_iter=2, tol=0.0)[0])


def test_kmeans_checkpoint_resume_past_max_iter(small_data, tmp_path):
    """Resumed after the last step (the checkpoint written, the result not
    used): the last step is replayed from the stored previous centroids, so
    the result is exactly the uninterrupted run's."""
    base, _ = small_data
    ck = str(tmp_path / "km.ckpt.npz")
    c1, a1 = _km(base, 16, seed=42, max_iter=4, tol=0.0, checkpoint=ck)
    c2, a2 = _km(base, 16, seed=42, max_iter=4, tol=0.0, checkpoint=ck)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)


def test_kmeans_checkpoint_resume_after_convergence(small_data, tmp_path):
    """A converged checkpointed run resumes to the identical result (the
    done flag stops further iteration)."""
    base, _ = small_data
    ck = str(tmp_path / "km.ckpt.npz")
    c1, a1 = _km(base, 16, seed=42, max_iter=50, tol=1e-4, checkpoint=ck)
    assert bool(np.load(ck)["done"])
    c2, a2 = _km(base, 16, seed=42, max_iter=50, tol=1e-4, checkpoint=ck)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)


def test_port_resumes_from_jax_checkpoint(small_data, tmp_path):
    """The JAX package writes the checkpoint after 3 steps; the port takes
    the 4th from it and returns JAX's uninterrupted 4-step assignment, with
    its centroids within rtol 1e-5."""
    base, _ = small_data
    ck = str(tmp_path / "jax.ckpt.npz")
    jkmeans.kmeans(base, 16, seed=42, max_iter=3, tol=0.0, checkpoint=ck)
    jc, ja = jkmeans.kmeans(base, 16, seed=42, max_iter=4, tol=0.0)
    tc, ta = _km(base, 16, seed=42, max_iter=4, tol=0.0, checkpoint=ck)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    assert int(np.load(ck)["next_iter"]) == 4  # the port wrote the file in JAX's format


def test_jax_resumes_from_port_checkpoint(small_data, tmp_path):
    """The port writes the checkpoint after 3 steps; the JAX package resumes
    from it and returns the port's uninterrupted 4-step assignment, with its
    centroids within rtol 1e-5; resumed past the last step, it replays it."""
    base, _ = small_data
    ck = str(tmp_path / "torch.ckpt.npz")
    _km(base, 16, seed=42, max_iter=3, tol=0.0, init="sample", checkpoint=ck)
    tc, ta = _km(base, 16, seed=42, max_iter=4, tol=0.0, init="sample")
    jc, ja = jkmeans.kmeans(base, 16, seed=42, max_iter=4, tol=0.0, init="sample",
                            checkpoint=ck)
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_allclose(jc, tc, rtol=1e-5)
    jc2, ja2 = jkmeans.kmeans(base, 16, seed=42, max_iter=4, tol=0.0, checkpoint=ck)
    np.testing.assert_array_equal(ja2, ja)
    np.testing.assert_array_equal(jc2, jc)
