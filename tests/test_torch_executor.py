"""The PyTorch port's serving executor on the CPU: the JAX package's
executor tests (``tests/test_executor.py``) run against
``rag_on_edge_tpu_torch.runtime.BatchingExecutor`` over the port's
``BruteForceIndex(fp32, exact)``, and parity with the JAX package.

The JAX executor's drain fusion (one stacked fetch for a drain) is gone in
the port; its tests here hold the port's copy-back path instead: each
batch's packed result copied back and a drain resolved with one wait
(``fused_drains``), with results equal to a direct search.  Every wait
carries its own timeout and every executor is closed by ``with``.
"""

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np
import pytest
import torch

from rag_on_edge_tpu_torch.harness import bench_executor
from rag_on_edge_tpu_torch.models.brute_force import BruteForceIndex
from rag_on_edge_tpu_torch.runtime import executor as executor_mod
from rag_on_edge_tpu_torch.runtime.executor import BatchingExecutor, SliceFuture
from rag_on_edge_tpu_torch.utils import metrics


def _ex(fn, dim, **kw):
    return BatchingExecutor(fn, dim=dim, device="cpu", **kw)


@pytest.fixture(scope="module")
def index(small_data):
    base, _ = small_data
    return BruteForceIndex(base, metric="ip", dtype="fp32", select="exact", device="cpu")


def test_executor_matches_direct_search(small_data, index):
    _, queries = small_data
    direct_ids, direct_scores = index.search(queries[:40], k=5)
    with _ex(lambda q: index.search_device(q, k=5), queries.shape[1],
             batch_size=16, max_delay_ms=5.0) as ex:
        futs = [ex.submit(q) for q in queries[:40]]
        for i, f in enumerate(futs):
            vals, ids = f.result(timeout=30)
            assert ids.shape == (5,)
            np.testing.assert_array_equal(ids, direct_ids[i])
            np.testing.assert_allclose(vals, direct_scores[i], rtol=1e-6)


def test_executor_concurrent_submitters(small_data, index):
    _, queries = small_data  # 32 queries
    direct_ids, _ = index.search(queries, k=3)
    results = {}
    with _ex(lambda q: index.search_device(q, k=3), queries.shape[1],
             batch_size=16, max_delay_ms=2.0) as ex:
        def worker(lo, hi):
            for i in range(lo, hi):
                results[i] = ex.submit(queries[i]).result(timeout=30)[1]

        threads = [threading.Thread(target=worker, args=(i * 8, (i + 1) * 8))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert len(results) == 32
    for i, ids in results.items():
        np.testing.assert_array_equal(ids, direct_ids[i])


def test_executor_group_submit_and_deadline(small_data, index):
    """An underfull batch still launches once the deadline passes, and a
    group comes back as a slice."""
    _, queries = small_data
    with _ex(lambda q: index.search_device(q, k=4), queries.shape[1],
             batch_size=64, max_delay_ms=1.0) as ex:  # 3 rows never fill 64
        vals, ids = ex.submit(queries[:3]).result(timeout=30)
        assert ids.shape == (3, 4)
        direct_ids, _ = index.search(queries[:3], k=4)
        np.testing.assert_array_equal(ids, direct_ids)


def test_executor_submit_many(small_data, index):
    """submit_many enqueues contiguous blocks and returns per-row handles
    that each resolve like a singleton submit, across batches and an
    underfull tail."""
    _, queries = small_data
    q = np.resize(queries, (40, queries.shape[1])).astype(np.float32)
    q += np.linspace(0, 1, 40, dtype=np.float32)[:, None]  # distinct rows
    direct_ids, direct_scores = index.search(q, k=5, batch_size=16)
    with _ex(lambda b: index.search_device(b, k=5), q.shape[1],
             batch_size=16, max_delay_ms=2.0) as ex:
        futs = ex.submit_many(q)
        assert len(futs) == 40
        for i, f in enumerate(futs):
            vals, ids = f.result(timeout=30)
            assert ids.shape == (5,)
            np.testing.assert_array_equal(ids, direct_ids[i])
            np.testing.assert_allclose(vals, direct_scores[i], rtol=1e-6)
    with _ex(lambda b: index.search_device(b, k=3), q.shape[1], batch_size=16) as ex:
        with pytest.raises(ValueError, match="M >= 1"):
            ex.submit_many(np.empty((0, q.shape[1]), np.float32))
        with pytest.raises(ValueError, match="dim"):
            ex.submit_many(np.zeros((4, 7), np.float32))


def test_executor_mixed_singleton_and_group_batch(small_data, index):
    """A batch mixing singletons and groups places every row at its
    handle's offset."""
    _, queries = small_data
    direct_ids, _ = index.search(queries[:8], k=4)
    with _ex(lambda b: index.search_device(b, k=4), queries.shape[1],
             batch_size=8, max_delay_ms=50.0) as ex:
        f0 = ex.submit(queries[0])
        g = ex.submit(queries[1:5])     # group of 4
        f1 = ex.submit(queries[5])
        f2 = ex.submit(queries[6])
        f3 = ex.submit(queries[7])      # fills batch_size=8 by rows
        np.testing.assert_array_equal(f0.result(timeout=30)[1], direct_ids[0])
        np.testing.assert_array_equal(g.result(timeout=30)[1], direct_ids[1:5])
        np.testing.assert_array_equal(f1.result(timeout=30)[1], direct_ids[5])
        np.testing.assert_array_equal(f2.result(timeout=30)[1], direct_ids[6])
        np.testing.assert_array_equal(f3.result(timeout=30)[1], direct_ids[7])


def test_executor_rejects_bad_inputs(small_data, index):
    _, queries = small_data
    ex = _ex(lambda q: index.search_device(q, k=3), queries.shape[1], batch_size=8)
    with ex:
        with pytest.raises(ValueError, match="dim"):
            ex.submit(np.zeros(7, np.float32))
        with pytest.raises(ValueError, match="batch_size"):
            ex.submit(np.zeros((9, queries.shape[1]), np.float32))
    ex.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit(queries[0])


def test_executor_propagates_engine_errors(small_data, index):
    """An fn that raises fails every waiter of its batch with the original
    exception, and the executor stays usable."""
    _, queries = small_data
    calls = {"n": 0}

    def flaky(q):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("engine exploded")
        return index.search_device(q, k=3)

    with _ex(flaky, queries.shape[1], batch_size=4, max_delay_ms=1.0) as ex:
        bad = [ex.submit(queries[i]) for i in range(4)]
        for f in bad:
            with pytest.raises(RuntimeError, match="engine exploded"):
                f.result(timeout=30)
        ok = ex.submit(queries[0]).result(timeout=30)
        direct_ids, _ = index.search(queries[:1], k=3)
        np.testing.assert_array_equal(ok[1], direct_ids[0])


def test_executor_result_timeout(small_data, index):
    """result(timeout) on a handle not yet resolved raises TimeoutError
    (concurrent.futures semantics)."""
    _, queries = small_data
    slow_release = threading.Event()

    def slow(q):
        slow_release.wait(10)
        return index.search_device(q, k=3)

    with _ex(slow, queries.shape[1], batch_size=4, max_delay_ms=1.0) as ex:
        try:
            f = ex.submit(queries[0])
            t0 = time.perf_counter()
            with pytest.raises(FutureTimeoutError):
                f.result(timeout=0.2)
            assert time.perf_counter() - t0 < 5.0
            assert not f.done()
            slow_release.set()
            f.result(timeout=30)  # resolves once the engine finishes
            assert f.done()
        finally:
            slow_release.set()


def test_executor_pipelined_integrity(small_data, index):
    """Many batches in flight neither scramble nor corrupt per-request
    results (no buffer is reused while a batch still reads it)."""
    base, queries = small_data
    q = np.resize(queries, (512, queries.shape[1])).astype(np.float32)
    q += np.linspace(0, 1, 512, dtype=np.float32)[:, None]  # distinct rows
    direct_ids, _ = index.search(q, k=5, batch_size=32)
    with _ex(lambda b: index.search_device(b, 5), base.shape[1],
             batch_size=32, max_delay_ms=50.0, inflight=8) as ex:
        futs = [ex.submit(q[i]) for i in range(512)]
        got = np.stack([np.asarray(f.result(timeout=120)[1]) for f in futs])
    np.testing.assert_array_equal(got, direct_ids)


def test_executor_rejects_zero_row_group(small_data, index):
    """[0, D] raises at submit() and the executor keeps serving."""
    _, queries = small_data
    with _ex(lambda q: index.search_device(q, k=3), queries.shape[1], batch_size=8) as ex:
        with pytest.raises(ValueError, match="1..batch_size"):
            ex.submit(np.empty((0, queries.shape[1]), np.float32))
        ids = ex.submit(queries[0]).result(timeout=30)[1]
        direct_ids, _ = index.search(queries[:1], k=3)
        np.testing.assert_array_equal(ids, direct_ids[0])


def test_executor_group_rows_trigger_size_launch(small_data, index):
    """Four [8, D] groups fill batch_size=32 by rows: the batch launches on
    fullness, not after a long deadline."""
    _, queries = small_data
    with _ex(lambda q: index.search_device(q, k=3), queries.shape[1],
             batch_size=32, max_delay_ms=10_000.0) as ex:
        t0 = time.perf_counter()
        futs = [ex.submit(queries[i * 8:(i + 1) * 8]) for i in range(4)]
        for f in futs:
            f.result(timeout=30)
        elapsed = time.perf_counter() - t0
    assert elapsed < 5.0, f"batch waited for the deadline ({elapsed:.1f}s)"


def test_executor_lost_wakeup_self_heals(small_data, index):
    """Items queued without a wake (two racing singleton submits can both
    read len == 2) are still taken: the dispatcher's empty-queue wait is
    bounded by the deadline."""
    _, queries = small_data
    with _ex(lambda q: index.search_device(q, k=3), queries.shape[1],
             batch_size=32, max_delay_ms=20.0) as ex:
        time.sleep(0.2)  # the dispatcher reaches its empty-queue wait
        futs = []
        for i in range(2):
            f = SliceFuture(ex)
            f._q = np.asarray(queries[i], np.float32)
            f._t = time.perf_counter()
            ex._queue.append(f)
            futs.append(f)
        ex._wake.clear()  # no wake signal
        direct_ids, _ = index.search(queries[:2], k=3)
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=10)[1], direct_ids[i])


def test_executor_stats_counters(small_data, index):
    """Rows and batches account exactly; every dispatched batch is
    collected; batches_per_drain >= 1 once drains happened."""
    _, queries = small_data
    with _ex(lambda q: index.search_device(q, k=5), queries.shape[1],
             batch_size=16, max_delay_ms=5.0) as ex:
        futs = [ex.submit(q) for q in queries[:32]]
        for f in futs:
            f.result(timeout=30)
        s = ex.stats()
    assert s["rows_dispatched"] == 32
    assert s["batches_dispatched"] >= 2  # 32 rows / batch_size 16
    assert s["batches_collected"] == s["batches_dispatched"]
    assert s["drains"] >= 1
    assert s["batches_per_drain"] >= 1.0
    assert s["avg_rows_per_batch"] <= 16


def test_executor_pack_engages_and_matches(small_data, index):
    """Packing (an int32 view of each leaf, concatenated into one tensor a
    batch) is on by default for several 4-byte leaves and is invisible:
    equal ids and scores, and packed_batches counts every batch."""
    _, queries = small_data
    direct_ids, direct_scores = index.search(queries[:32], k=5)
    with _ex(lambda q: index.search_device(q, k=5), queries.shape[1],
             batch_size=16, max_delay_ms=5.0) as ex:
        futs = [ex.submit(q) for q in queries[:32]]
        for i, f in enumerate(futs):
            vals, ids = f.result(timeout=30)
            assert ids.dtype == direct_ids.dtype
            np.testing.assert_array_equal(ids, direct_ids[i])
            np.testing.assert_allclose(vals, direct_scores[i], rtol=1e-6)
        s = ex.stats()
    assert s["packed_batches"] == s["batches_dispatched"] > 0


def test_executor_pack_off_matches(small_data, index):
    """pack=False copies each leaf back on its own."""
    _, queries = small_data
    direct_ids, _ = index.search(queries[:16], k=5)
    with _ex(lambda q: index.search_device(q, k=5), queries.shape[1],
             batch_size=16, max_delay_ms=5.0, pack=False) as ex:
        futs = [ex.submit(q) for q in queries[:16]]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=30)[1], direct_ids[i])
        assert ex.stats()["packed_batches"] == 0


def test_executor_pack_mixed_leaf_shapes(small_data, index):
    """Packing takes [B, k] f32, [B, k] i32, a [B] vector and a [B, 2, 3]
    leaf in one result."""
    _, queries = small_data

    def fn(q):
        scores, ids = index.search_device(q, k=4)
        ncand = torch.full((q.shape[0],), 7, dtype=torch.int32)
        cube = scores[:, :1, None].expand(q.shape[0], 2, 3).to(torch.float32)
        return scores, ids, ncand, cube

    direct_ids, direct_scores = index.search(queries[:16], k=4)
    with _ex(fn, queries.shape[1], batch_size=16, max_delay_ms=5.0) as ex:
        futs = [ex.submit(q) for q in queries[:16]]
        for i, f in enumerate(futs):
            scores, ids, ncand, cube = f.result(timeout=30)
            np.testing.assert_array_equal(ids, direct_ids[i])
            np.testing.assert_allclose(scores, direct_scores[i], rtol=1e-6)
            assert ncand == 7 and ncand.dtype == np.int32
            assert cube.shape == (2, 3)
            np.testing.assert_allclose(cube, np.broadcast_to(scores[:1, None], (2, 3)),
                                       rtol=1e-6)
        assert ex.stats()["packed_batches"] > 0


def test_executor_pack_falls_back_on_narrow_dtype(small_data, index):
    """A leaf that is not 4 bytes wide (int8) turns packing off; results
    come back through the plain path."""
    _, queries = small_data

    def fn(q):
        scores, ids = index.search_device(q, k=3)
        return scores, ids, torch.zeros((q.shape[0],), dtype=torch.int8)

    with _ex(fn, queries.shape[1], batch_size=16, max_delay_ms=5.0) as ex:
        direct_ids, _ = index.search(queries[:16], k=3)
        futs = [ex.submit(q) for q in queries[:16]]
        for i, f in enumerate(futs):
            _, ids, flag = f.result(timeout=30)
            np.testing.assert_array_equal(ids, direct_ids[i])
            assert flag.dtype == np.int8
        assert ex.stats()["packed_batches"] == 0


def test_executor_drain_fusion_matches(small_data, index, monkeypatch):
    """The copy-back path's bookkeeping: when the collector's first wait is
    slow, later batches pile up in flight, so a later drain resolves several
    batches with one wait (``fused_drains``), results equal to a direct
    search."""
    _, queries = small_data
    real_wait = BatchingExecutor._wait_drain
    first = [True]

    def slow_first_wait(self, flights):
        if first[0]:
            first[0] = False
            time.sleep(0.3)  # the dispatcher runs ahead meanwhile
        return real_wait(self, flights)

    monkeypatch.setattr(BatchingExecutor, "_wait_drain", slow_first_wait)
    qs = np.concatenate([queries, queries + 0.25], axis=0).astype(np.float32)  # 64 rows
    direct_ids, direct_scores = index.search(qs, k=5)
    with _ex(lambda q: index.search_device(q, k=5), qs.shape[1],
             batch_size=16, max_delay_ms=50.0, inflight=8) as ex:
        futs = [ex.submit(q) for q in qs]
        for i, f in enumerate(futs):
            vals, ids = f.result(timeout=30)
            np.testing.assert_array_equal(ids, direct_ids[i])
            np.testing.assert_allclose(vals, direct_scores[i], rtol=1e-6)
        s = ex.stats()
    assert set(s) == {"batches_dispatched", "rows_dispatched", "underfull_launches", "drains",
                      "batches_collected", "packed_batches", "fused_drains",
                      "avg_rows_per_batch", "batches_per_drain"}
    assert s["packed_batches"] == s["batches_dispatched"] == 4
    assert s["fused_drains"] >= 1
    assert s["drains"] < s["batches_collected"]  # at least one multi-batch drain


def test_executor_drain_fusion_off_without_pack(small_data, index):
    """pack=False resolves each batch with its own wait: fused_drains stays
    zero, results unaffected."""
    _, queries = small_data
    direct_ids, _ = index.search(queries[:16], k=5)
    with _ex(lambda q: index.search_device(q, k=5), queries.shape[1],
             batch_size=16, max_delay_ms=5.0, pack=False) as ex:
        futs = [ex.submit(q) for q in queries[:16]]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=30)[1], direct_ids[i])
        assert ex.stats()["fused_drains"] == 0


def test_executor_set_max_delay_live(small_data, index):
    """set_max_delay_ms retunes the window live: shrinking a window far past
    the test's budget releases the pending request promptly."""
    _, queries = small_data
    with _ex(lambda q: index.search_device(q, k=3), queries.shape[1],
             batch_size=32, max_delay_ms=60_000.0) as ex:
        f = ex.submit(queries[0])
        time.sleep(0.1)
        assert not f.done()  # 60 s window: the underfull batch is held
        ex.set_max_delay_ms(5.0)
        ids = f.result(timeout=10)[1]
        direct_ids, _ = index.search(queries[:1], k=3)
        np.testing.assert_array_equal(ids, direct_ids[0])


def test_auto_max_delay_knee():
    """auto_max_delay_ms = clamp(min(fill, cycle), 5, 200)."""
    amd = bench_executor.auto_max_delay_ms
    assert amd(4096, 16_500, 66_000) == pytest.approx(1e3 * 4096 / 66_000)
    assert amd(4096, 66_000, 66_000) == pytest.approx(1e3 * 4096 / 66_000)
    assert amd(4096, 132_000, 66_000) == pytest.approx(1e3 * 4096 / 132_000)
    assert amd(32, 66_000, 66_000) == 5.0
    assert amd(65_536, 1_000, 2_000) == 200.0


def test_executor_needs_a_card_for_cuda():
    """The default device is the card; without one the executor raises and
    never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchingExecutor(lambda q: q, dim=4)
    assert threading.active_count() == threads  # no worker was started


# ---------------------------------------------------------------- parity


def test_executor_over_ivf_equals_jax_executor(small_data):
    """The JAX executor over a JAX IVFIndex and the port's over the same
    index (``from_arrays``) return equal ids for the same 64 requests at
    B 16 (the query-major mode: exact fp32 over the probed cells)."""
    from rag_on_edge_tpu.models.ivf import IVFIndex as JaxIVF
    from rag_on_edge_tpu.runtime.executor import BatchingExecutor as JaxExecutor
    from rag_on_edge_tpu_torch.models.ivf import IVFIndex

    base, queries = small_data
    jidx = JaxIVF.build(base, nlist=16, metric="l2", seed=0, max_iter=5)
    tidx = IVFIndex.from_arrays(jidx._centroids_np, jidx._vectors_np, jidx._offsets_np,
                                jidx._reorder_np, metric="l2", config=jidx.config,
                                device="cpu")
    reqs = np.resize(queries, (64, queries.shape[1])).astype(np.float32)
    reqs[32:] += 0.5
    got = {}
    for name, ex in (("jax", JaxExecutor(lambda q: jidx.search_device(q, 5, 4, mode="query"),
                                         dim=base.shape[1], batch_size=16, max_delay_ms=2.0)),
                     ("torch", _ex(lambda q: tidx.search_device(q, 5, 4, mode="query"),
                                   base.shape[1], batch_size=16, max_delay_ms=2.0))):
        with ex:
            futs = [ex.submit(q) for q in reqs]
            got[name] = np.stack([np.asarray(f.result(timeout=60)[1]) for f in futs])
    np.testing.assert_array_equal(got["torch"], got["jax"])


def test_executor_uint8_wire_matches_f32():
    """The uint8 wire is lossless for integral queries: results equal the
    f32 wire's bit for bit (fn casts back to f32)."""
    def fn(q):
        qf = q.to(torch.float32)
        return qf.sum(dim=1), (qf * 3.0 + 1.0).amax(dim=1)

    rng = np.random.default_rng(3)
    qs = rng.integers(0, 142, size=(64, 16)).astype(np.float32)
    outs = {}
    for wd in (None, np.uint8):
        with _ex(fn, 16, batch_size=8, max_delay_ms=2.0, wire_dtype=wd) as ex:
            futs = [ex.submit(q) for q in qs]
            outs[wd] = [f.result(timeout=60) for f in futs]
    for a, b in zip(outs[None], outs[np.uint8]):
        assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
        assert np.array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_ivf_search_device_uint8_queries_through_executor(small_data):
    """An int8 L2 IVFIndex served on the uint8 wire returns exactly the f32
    wire's ids and scores (the corpus is integral, the cast lossless)."""
    from rag_on_edge_tpu_torch.models.ivf import IVFIndex

    base, queries = small_data
    idx = IVFIndex.build(base, nlist=16, metric="l2", dtype="int8", seed=0, max_iter=5,
                         device="cpu")
    assert np.array_equal(queries.astype(np.uint8).astype(np.float32), queries)
    outs = {}
    for wd in (None, np.uint8):
        with _ex(lambda q: idx.search_device(q, 5, 4, mode="cluster"), base.shape[1],
                 batch_size=16, max_delay_ms=2.0, wire_dtype=wd) as ex:
            futs = [ex.submit(q) for q in queries]
            outs[wd] = [f.result(timeout=60) for f in futs]
    for a, b in zip(outs[None], outs[np.uint8]):
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_wire_dtype_and_auto_delay_equal_jax():
    """``_wire_dtype`` and ``auto_max_delay_ms`` give JAX's answers on a
    grid of inputs."""
    from rag_on_edge_tpu.harness import bench_executor as jbe

    cases = [np.array([[0.0, 141.0, 37.0]], np.float32),
             np.array([[0.5, 1.0, 2.0]], np.float32),
             np.array([[0.0, 256.0]], np.float32),
             np.array([[-1.0, 3.0]], np.float32),
             np.array([[255.0, 0.0]], np.float32)]
    for q in cases:
        for wire in ("auto", "f32", "uint8"):
            try:
                want = jbe._wire_dtype(q, wire)
            except ValueError:
                with pytest.raises(ValueError):
                    bench_executor._wire_dtype(q, wire)
                continue
            assert bench_executor._wire_dtype(q, wire) == want
    for batch in (32, 512, 2048, 4096, 65_536):
        for offered in (0.0, 1_000.0, 16_500.0, 66_000.0, 132_000.0):
            for capacity in (0.0, 2_000.0, 66_000.0, 400_000.0):
                assert (bench_executor.auto_max_delay_ms(batch, offered, capacity)
                        == jbe.auto_max_delay_ms(batch, offered, capacity))


def test_latency_stats_equal_jax():
    """``LatencyStats`` (and its report lines) equal JAX's on the same
    samples, the empty list included."""
    from rag_on_edge_tpu.utils import metrics as jmetrics

    rng = np.random.default_rng(5)
    for samples in ([], [3.5], rng.exponential(2.0, 1000).tolist(),
                    rng.uniform(0, 50, 37).tolist()):
        got = metrics.LatencyStats.from_samples(samples)
        want = jmetrics.LatencyStats.from_samples(samples)
        assert got.__dict__ == want.__dict__
        assert got.lines("batch") == want.lines("batch")


def test_executor_module_imports_no_jax():
    """The runtime module is the port's own: no jax in its globals."""
    assert "jax" not in vars(executor_mod) and "jnp" not in vars(executor_mod)
