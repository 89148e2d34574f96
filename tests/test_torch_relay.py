"""The port's transfer probe, serialized-cycle probe and gated serving run
on the CPU (``relay_probe``, ``bench_executor.relay_cycle_probe``,
``serve_hunt``), mirroring ``tests/test_relay_probe.py`` and the serve-hunt
cases of ``tests/test_round5_harnesses.py``.  A CPU time means nothing for
the card: these hold the key schemas, the borrowed pack, the record
written after each entry and the outage handling.

The data root is redirected to one temporary directory for the module, so
dataset "siftsmall" is synthesized and its index built once, outside the
repository's ``data/``.
"""

import json

import numpy as np
import pytest
import torch

from rag_on_edge_tpu_torch.harness import bench_executor, relay_probe, serve_hunt

FETCH_KEYS = ("fetch_1_arrays_ms", "fetch_3_arrays_ms", "fetch_9_arrays_ms",
              "fetch_per_array_ms", "fetch_1.25mb_ms", "fetch_5mb_ms", "fetch_per_mb_ms",
              "sync_rtt_ms")


@pytest.fixture(scope="module")
def module_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("relay") / "data")


@pytest.fixture(autouse=True)
def _data_root(module_root, monkeypatch):
    for target in ("rag_on_edge_tpu_torch.utils.datasets.DEFAULT_DATA_ROOT",
                   "rag_on_edge_tpu_torch.harness.bench_ivf.DEFAULT_DATA_ROOT"):
        monkeypatch.setattr(target, module_root)


def test_probe_fetch_schema():
    out = relay_probe.probe_fetch(rounds=1, device="cpu")
    assert tuple(out) == FETCH_KEYS
    assert all(np.isfinite(v) for v in out.values())
    assert out["fetch_1_arrays_ms"] >= 0 and out["sync_rtt_ms"] >= 0


def test_probe_cycle_runs_and_packs():
    out = relay_probe.probe_cycle(batch=32, nprobe=4, k=5, rounds=1, dataset="siftsmall",
                                  device="cpu")
    assert set(out) == {"batch", "nprobe", "cycle_unpacked_ms", "cycle_packed_ms",
                        "capacity_unpacked_qps", "capacity_packed_qps"}
    assert out["cycle_packed_ms"] > 0 and out["cycle_unpacked_ms"] > 0
    assert out["capacity_packed_qps"] == pytest.approx(32e3 / out["cycle_packed_ms"])


def test_relay_cycle_probe_uploads_distinct_batches_in_the_wire_dtype():
    seen = []

    def fn(q):
        seen.append((q.dtype, q.numpy().tobytes()))
        qf = q.to(torch.float32)
        return qf.sum(1), qf.argmax(1).to(torch.int32)

    ms = bench_executor.relay_cycle_probe(fn, dim=8, batch=16, cycles=3, wire_dtype=np.uint8,
                                          device="cpu")
    assert ms > 0 and len(seen) == 4
    assert {dt for dt, _ in seen} == {torch.uint8}
    assert len({b for _, b in seen}) == 4


def _hunt_argv(tmp_path, *extra):
    return ["--dataset", "siftsmall", "--batch", "64", "--nprobe", "4", "--requests", "256",
            "--max-delay-ms", "5", "--outdir", str(tmp_path), "--device", "cpu", *extra]


def test_serve_hunt_out_of_time_runs_once_and_persists(tmp_path):
    assert serve_hunt.main(_hunt_argv(tmp_path, "--max-wait-s", "0", "--good-ms", "0")) == 0
    files = list(tmp_path.glob("serving_hunt_*.json"))
    assert len(files) == 1
    rec = json.loads(files[0].read_text())
    # Out of time at t=0: one probe, one run, the best recorded.
    assert len(rec["probes"]) == 1 and "cycle_ms" in rec["probes"][0]
    assert len(rec["runs"]) == 1
    run = rec["runs"][0]
    assert run["trigger"] == "out_of_time"
    assert run["dataset"] == "siftsmall"  # --dataset reaches the serving run
    assert run["relay_cycle_ms"] == rec["probes"][0]["cycle_ms"]
    assert rec["best"]["qps_end_to_end"] == run["qps_end_to_end"]
    assert 0.9 <= rec["best"]["recall"] <= 1.0


def test_serve_hunt_survives_probe_outage(tmp_path, monkeypatch):
    """A probe that raises is logged in the record and the hunt goes on."""
    calls = {"n": 0}
    real_probe = bench_executor.relay_cycle_probe

    def flaky_probe(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("CUDA error: unspecified launch failure")
        return real_probe(*a, **kw)

    monkeypatch.setattr(bench_executor, "relay_cycle_probe", flaky_probe)
    assert serve_hunt.main(_hunt_argv(tmp_path, "--max-wait-s", "1e9", "--good-ms", "1e9",
                                      "--target-qps", "0", "--poll-s", "0.01")) == 0
    rec = json.loads(list(tmp_path.glob("serving_hunt_*.json"))[0].read_text())
    assert "error" in rec["probes"][0]
    assert rec["probes"][1]["cycle_ms"] > 0
    assert rec["runs"] and rec["best"] is not None and rec["runs"][0]["trigger"] == "window"
