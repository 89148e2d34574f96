"""Serving executor: a micro-batching queue in front of a device search
function (counterpart: ``rag_on_edge_tpu/runtime/executor.py``).

A server receives queries one by one, and the search wants fixed, full
batches.  This executor is that glue:

- callers ``submit()`` single queries (or small groups) and get a
  future-like :class:`SliceFuture`; ``submit_many()`` enqueues a
  contiguous block of requests at once and hands back per-row views;
- a DISPATCH thread drains the queue into fixed-size batches, zero-padded
  (a batch launches when full or when its oldest request has waited
  ``max_delay_ms``: the size-or-deadline policy), uploads each through a
  ring of pinned host buffers (``non_blocking`` copies), runs the search
  on the executor's compute stream, packs the result leaves into one
  int32 tensor, and starts its copy into pinned host memory on a side
  stream (after ``wait_stream``), marked by a CUDA event; it does not wait
  for the batch;
- a COLLECT thread takes every batch already in flight and waits once, on
  the last one's event (the copies run in order on the side stream), with
  a blocking-sync event wait that releases the GIL: no polling and no
  device-wide synchronize.  One broadcast then wakes the callers, who
  slice their own rows out in ``result()``.

Up to ``inflight`` batches stay in flight, so the host's batching, the
device's search and the result copies overlap.  The per-request hot path
is one object and one deque append; the batch's rows are filled by one
C-level list assignment.

The executor is engine-agnostic: ``fn(queries[B, D]) -> tensor, or a
tuple / list of tensors`` whose leaves all have leading dimension B
(both index types' ``search_device`` qualify).  ``device`` is explicit and
defaults to the card; on the CPU the same pipeline runs with plain host
tensors and nothing to wait for.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np
import torch

__all__ = ["BatchingExecutor", "SliceFuture"]

_F32 = np.dtype(np.float32)


def _rows_full(queue, bs: int) -> bool:
    """True if the queued ROW count reaches bs.  Deque iteration raises
    RuntimeError if a producer appends mid-scan: that reads as not full,
    and the nap's re-check (at worst the deadline) takes the batch."""
    try:
        rows = 0
        for fut in queue:
            rows += fut._m or 1
            if rows >= bs:
                return True
        return False
    except RuntimeError:
        return False


def _flatten(out):
    """A result → (leaves, unflatten): a tensor, or a tuple or list of
    tensors."""
    if isinstance(out, torch.Tensor):
        return [out], lambda leaves: leaves[0]
    if isinstance(out, (tuple, list)):
        kind = type(out)
        return list(out), lambda leaves: kind(leaves)
    raise TypeError(f"fn must return a tensor or a tuple or list of them, "
                    f"not {type(out).__name__}")


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


class _BatchRecord:
    """One dispatched batch: filled by the collector, read by callers."""

    __slots__ = ("ready", "leaves", "unflatten", "exc")

    def __init__(self):
        self.ready = False
        self.leaves = None
        self.unflatten = None
        self.exc = None


class SliceFuture:
    """Future-like handle for one submit(): ``result(timeout)`` /
    ``done()``.  The batch resolves as a whole (one wait, one broadcast);
    this handle slices its own rows out on the calling thread.  The handle
    is also the queue item (``_q`` the payload, ``_t`` the enqueue time)."""

    __slots__ = ("_ex", "_rec", "_r0", "_m", "_q", "_t")

    def __init__(self, ex):
        self._ex = ex
        self._rec = None  # attached by the dispatcher
        self._r0 = 0
        self._m = 0  # 0 = single query ([D] submit), else group rows

    def done(self) -> bool:
        rec = self._rec
        return rec is not None and rec.ready

    def _wait(self, timeout):
        rec = self._rec
        if rec is None or not rec.ready:
            cond = self._ex._cond
            deadline = None if timeout is None else time.perf_counter() + timeout
            with cond:
                while True:
                    rec = self._rec
                    if rec is not None and rec.ready:
                        break
                    if deadline is None:
                        cond.wait()
                    else:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            raise FutureTimeoutError()
                        cond.wait(remaining)
        if rec.exc is not None:
            raise rec.exc
        return rec

    def result(self, timeout: float | None = None):
        rec = self._wait(timeout)
        r0 = self._r0
        if self._m == 0:
            return rec.unflatten([a[r0] for a in rec.leaves])
        return rec.unflatten([a[r0:r0 + self._m] for a in rec.leaves])


class _RowView:
    """Row ``j`` of a group future, minted by
    :meth:`BatchingExecutor.submit_many`: it waits on the parent and slices
    one row."""

    __slots__ = ("_p", "_j")

    def __init__(self, parent: SliceFuture, j: int):
        self._p = parent
        self._j = j

    def done(self) -> bool:
        return self._p.done()

    def result(self, timeout: float | None = None):
        p = self._p
        rec = p._wait(timeout)
        r = p._r0 + self._j
        return rec.unflatten([a[r] for a in rec.leaves])


class _Flight:
    """A batch on its way back: its record, the device tensors its copy
    reads (kept alive until the copy's event completes), the pinned host
    tensors it writes, and the event."""

    __slots__ = ("rec", "keep", "host", "event", "packed", "unflatten")

    def __init__(self, rec, keep, host, event, packed, unflatten):
        self.rec, self.keep, self.host, self.event = rec, keep, host, event
        self.packed, self.unflatten = packed, unflatten


class BatchingExecutor:
    """Size-or-deadline micro-batcher with pipelined dispatch.

    Parameters
    ----------
    fn : callable(tensor [batch_size, D] on ``device``, of the wire dtype)
        -> a tensor or a tuple / list of tensors, each with leading
        dimension batch_size (e.g. ``lambda q: index.search_device(q, 10,
        16)``).
    dim : query dimensionality.
    batch_size : the one batch shape.
    max_delay_ms : launch an underfull batch once its oldest request has
        waited this long.
    inflight : batches kept in flight (dispatch runs ahead of the
        collector by up to this many).
    pack : join each batch's result leaves into ONE int32 tensor on the
        device (each leaf viewed as int32 and concatenated by columns), so
        each batch makes one copy back ("auto" / True; False disables).  It
        turns itself off, for the executor's life, on the first batch where
        a leaf is not 4 bytes wide or there is one leaf; the host reads
        column views back, no copies.  Packing also lets a drain resolve
        every batch in it with one wait (``fused_drains``).
    wire_dtype : dtype of the uploaded query batch (default float32).
        Integral corpora (SIFT values lie in [0, 255]) upload losslessly as
        uint8 at a quarter of the bytes; ``fn`` casts to float32 (both
        index types' ``search_device`` do).  The cast happens once a batch,
        when the staging buffer is filled.
    device : where the batch is uploaded and ``fn`` runs (default the
        card).  On CUDA the dispatcher and the collector each enter it, and
        the search runs on the executor's own compute stream.
    """

    def __init__(self, fn, dim: int, batch_size: int = 32,
                 max_delay_ms: float = 2.0, inflight: int = 4,
                 pack: bool | str = "auto", wire_dtype=None,
                 device: str | torch.device = "cuda"):
        self._fn = fn
        self.dim = int(dim)
        self.batch_size = int(batch_size)
        self.wire_dtype = np.dtype(wire_dtype) if wire_dtype is not None else _F32
        self._wire_torch = torch.from_numpy(np.zeros(0, self.wire_dtype)).dtype
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            if not torch.cuda.is_available():
                raise RuntimeError("BatchingExecutor(device='cuda') needs a CUDA device")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._compute = torch.cuda.Stream(self.device)
            self._side = torch.cuda.Stream(self.device)
            # The upload ring: the queue's batches, the one the collector
            # holds and the one being filled.  A slot is refilled only once
            # its upload's event has completed.
            ring = max(1, inflight) + 2
            self._stage = [torch.empty((self.batch_size, self.dim), dtype=self._wire_torch,
                                       pin_memory=True) for _ in range(ring)]
            self._stage_np = [t.numpy() for t in self._stage]
            self._stage_ev: list = [None] * ring
            self._slot = 0
        # Queue of SliceFuture items (the payload rides on the future);
        # deque.append is GIL-atomic, so the submit path takes no lock.
        self._queue: deque = deque()
        self._has_groups = False  # any group submit seen -> row-exact fullness
        self._wake = threading.Event()
        self._cond = threading.Condition()
        self._closed = False
        self._inflight: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, inflight))
        # Pipeline counters (one writer each; counted a batch or a drain,
        # never a request).
        self._n_batches = 0   # dispatched batches
        self._n_rows = 0      # real rows dispatched (zero padding excluded)
        self._n_underfull = 0  # deadline-expired (underfull) launches
        self._n_drains = 0    # collector rounds
        self._n_collected = 0  # batches resolved across all drains
        self._n_packed = 0    # batches whose leaves were packed
        self._n_fused_drains = 0  # drains that resolved >1 batch with one wait
        # Packing, decided on the first batch's result: "unknown" ->
        # "on" / "off".
        self._pack_state = "unknown" if pack in ("auto", True) else "off"
        self._pack_slices = None   # [(col0, col1, np.dtype, trailing)]
        self._pack_unflatten = None
        self._fuse_drains = pack in ("auto", True)
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._collector = threading.Thread(target=self._collect_loop, daemon=True)
        self._dispatcher.start()
        self._collector.start()

    # ------------------------------------------------------------------ API

    def set_max_delay_ms(self, max_delay_ms: float) -> None:
        """Retune the size-or-deadline window live: the dispatcher reads it
        on every pass, and the wake cuts its current nap short."""
        self.max_delay_s = float(max_delay_ms) / 1e3
        self._wake.set()

    def submit(self, query: np.ndarray) -> SliceFuture:
        """Enqueue one query [D] or a group [m, D] (m ≤ batch_size).
        Resolves to the result's slice for these rows ([D] input → leading
        dim dropped)."""
        if self._closed:
            raise RuntimeError("executor is closed")
        q = query
        if type(q) is not np.ndarray or q.dtype is not _F32:
            q = np.asarray(q, np.float32)
        fut = SliceFuture(self)
        if q.ndim != 1:
            # Groups: fullness is counted by rows once one is seen, and a
            # group submit always wakes the dispatcher.
            if q.ndim != 2 or not 1 <= q.shape[0] <= self.batch_size:
                raise ValueError(
                    f"expected [D] or a group of 1..batch_size="
                    f"{self.batch_size} rows, got {q.shape}"
                )
            if q.shape[1] != self.dim:
                raise ValueError(f"query dim {q.shape[1]} != {self.dim}")
            fut._m = q.shape[0]
            self._has_groups = True
        elif q.shape[0] != self.dim:
            raise ValueError(f"query dim {q.shape[0]} != {self.dim}")
        fut._q = q
        fut._t = time.perf_counter()
        queue = self._queue
        queue.append(fut)
        # Wake the dispatcher only at its decision points: the first
        # request arms the deadline, a full batch launches.
        ql = len(queue)
        if ql == 1 or ql >= self.batch_size or fut._m:
            self._wake.set()
        if self._closed:
            # Raced close(): the dispatcher may have drained and exited.
            # Withdraw the item and refuse, unless the dispatcher took it.
            if fut in queue:
                try:
                    queue.remove(fut)
                except ValueError:
                    return fut  # the dispatcher took it meanwhile
                raise RuntimeError("executor is closed")
        return fut

    def submit_many(self, queries: np.ndarray) -> list:
        """Enqueue [M, D] (any M ≥ 1) as ⌈M/batch_size⌉ contiguous groups
        and return M per-row handles, each resolving like a singleton
        ``submit``."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim != 2 or q.shape[0] < 1:
            raise ValueError(f"expected [M, D] with M >= 1, got {q.shape}")
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != {self.dim}")
        out: list[_RowView] = []
        bs = self.batch_size
        for s in range(0, q.shape[0], bs):
            parent = self.submit(q[s:s + bs])
            out.extend(_RowView(parent, j) for j in range(parent._m))
        return out

    def search(self, query: np.ndarray, timeout: float = 60.0):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(query).result(timeout=timeout)

    def stats(self) -> dict:
        """Pipeline counters since construction (diff two snapshots to
        scope them to a run).  ``batches_per_drain`` is how many batches a
        collector round resolves; ``fused_drains`` the rounds that resolved
        more than one with a single wait."""
        b, d = self._n_batches, self._n_drains
        return {
            "batches_dispatched": b,
            "rows_dispatched": self._n_rows,
            "underfull_launches": self._n_underfull,
            "drains": d,
            "batches_collected": self._n_collected,
            "packed_batches": self._n_packed,
            "fused_drains": self._n_fused_drains,
            "avg_rows_per_batch": round(self._n_rows / b, 1) if b else 0.0,
            "batches_per_drain": round(self._n_collected / d, 2) if d else 0.0,
        }

    def close(self) -> None:
        """Drain outstanding requests, then stop the workers (idempotent)."""
        if self._closed:
            if self._dispatcher.is_alive() or self._collector.is_alive():
                self._dispatcher.join()
                self._collector.join()
            return
        self._closed = True
        self._wake.set()
        self._dispatcher.join()
        self._collector.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- packing

    def _maybe_pack(self, leaves):
        """The batch's leaves joined into one [B, C] int32 tensor → (packed,
        True), or (None, False) where packing is off or turns off here (any
        failure: packing is never needed for a right answer)."""
        if self._pack_state == "off":
            return None, False
        try:
            if self._pack_state == "unknown":
                ok = len(leaves) >= 2 and all(
                    isinstance(a, torch.Tensor) and a.dim() >= 1
                    and a.shape[0] == self.batch_size and a.element_size() == 4
                    for a in leaves)
                if not ok:
                    self._pack_state = "off"
                    return None, False
                self._build_pack(leaves)
                self._pack_state = "on"
            b = self.batch_size
            return torch.cat([a.contiguous().reshape(b, -1).view(torch.int32)
                              for a in leaves], dim=1), True
        except Exception:
            self._pack_state = "off"
            return None, False

    def _build_pack(self, leaves) -> None:
        slices, o = [], 0
        for a in leaves:
            trail = tuple(int(s) for s in a.shape[1:])
            c = 1
            for s in trail:
                c *= s
            slices.append((o, o + c, _np_dtype(a.dtype), trail))
            o += c
        self._pack_slices = slices

    def _unpack_rows(self, arr: np.ndarray) -> list:
        """The host-side inverse of the pack: column views of the [B, C]
        int32 buffer (a dtype view of a column slice; a copy only where a
        leaf has more than one trailing dim)."""
        leaves = []
        for o0, o1, dt, trail in self._pack_slices:
            col = arr[:, o0:o1]
            if dt != col.dtype:
                col = col.view(dt)
            if trail == ():
                leaves.append(col[:, 0])
            elif len(trail) == 1:
                leaves.append(col)
            else:
                leaves.append(col.reshape((arr.shape[0],) + trail))
        return leaves

    # --------------------------------------------------------------- workers

    def _take_batch(self) -> list | None:
        """Blocks until a full batch, a deadline expiry, or close with an
        empty queue → [future, ...] or None on shutdown.  The dispatcher is
        the only consumer, so a stale len() only delays an item to the next
        batch."""
        queue = self._queue
        bs = self.batch_size
        while True:
            if queue:
                try:
                    oldest = queue[0]._t
                except IndexError:
                    continue  # a raced-close withdrawal emptied the queue
                full = len(queue) >= bs or (self._has_groups and _rows_full(queue, bs))
                expired = (time.perf_counter() - oldest) >= self.max_delay_s
                if full or expired or self._closed:
                    # Pop, then check the popped item's rows (a concurrent
                    # withdrawal may change the head between a peek and a pop).
                    taken, rows = [], 0
                    while queue:
                        try:
                            fut = queue.popleft()
                        except IndexError:
                            break
                        m = fut._m or 1
                        if rows + m > bs:
                            queue.appendleft(fut)  # the next batch's; FIFO kept
                            break
                        taken.append(fut)
                        rows += m
                    if taken:
                        return taken
                # Nap until the deadline or a producer's wake (set after the
                # append, so one between the clear and the wait is kept).
                self._wake.clear()
                if (len(queue) >= bs or self._closed
                        or (self._has_groups and _rows_full(queue, bs))):
                    continue
                remaining = self.max_delay_s - (time.perf_counter() - oldest)
                self._wake.wait(timeout=max(remaining, 1e-4))
            elif self._closed:
                return None
            else:
                self._wake.clear()
                if queue or self._closed:
                    continue
                # Bounded: two concurrent singleton submits into an empty
                # queue can both read len == 2 and neither wake us; the
                # timeout lets the deadline policy take them anyway.
                self._wake.wait(timeout=self.max_delay_s)

    def _fill(self, taken, rec, buf) -> int:
        """Place the batch's rows into ``buf`` (zeroed past them) → rows."""
        r0 = 0
        groups = False
        for fut in taken:
            fut._r0 = r0
            fut._rec = rec
            if fut._m:
                groups = True
                buf[r0:r0 + fut._m] = fut._q
                r0 += fut._m
            else:
                r0 += 1
        if not groups:
            buf[:r0] = [fut._q for fut in taken]  # one C-level fill
        else:
            for fut in taken:
                if not fut._m:
                    buf[fut._r0] = fut._q
        buf[r0:] = 0
        for fut in taken:
            fut._q = None  # release the payloads early
        return r0

    def _upload(self, taken, rec) -> tuple[torch.Tensor, int]:
        """The batch on the device → (tensor [B, D] of the wire dtype, rows).
        CUDA: filled into the next pinned slot (once that slot's last upload
        has completed) and copied on the compute stream, non-blocking.  CPU:
        a fresh buffer each batch (a tensor from numpy aliases it, and the
        batch may still be in use)."""
        if not self._cuda:
            buf = np.empty((self.batch_size, self.dim), dtype=self.wire_dtype)
            return torch.from_numpy(buf), self._fill(taken, rec, buf)
        s = self._slot
        self._slot = (s + 1) % len(self._stage)
        if self._stage_ev[s] is not None:
            self._stage_ev[s].synchronize()
        rows = self._fill(taken, rec, self._stage_np[s])
        q = torch.empty((self.batch_size, self.dim), dtype=self._wire_torch, device=self.device)
        q.copy_(self._stage[s], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self._compute)
        self._stage_ev[s] = ev
        return q, rows

    def _launch(self, taken, rec) -> _Flight:
        """Upload, search, pack, and start the copy back; nothing waits."""
        q, rows = self._upload(taken, rec)
        self._n_batches += 1
        self._n_rows += rows
        if rows < self.batch_size:
            self._n_underfull += 1
        leaves, unflatten = _flatten(self._fn(q))
        packed, did_pack = self._maybe_pack(leaves)
        if did_pack:
            self._n_packed += 1
        dev_leaves = [packed] if did_pack else leaves
        if not self._cuda:
            return _Flight(rec, None, dev_leaves, None, did_pack, unflatten)
        # The copy back on the side stream, after the search; the device
        # tensors stay referenced by the flight until its event completes.
        self._side.wait_stream(self._compute)
        with torch.cuda.stream(self._side):
            host = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in dev_leaves]
            for h, a in zip(host, dev_leaves):
                h.copy_(a, non_blocking=True)
            event = torch.cuda.Event(blocking=True)  # a wait that sleeps, not spins
            event.record(self._side)
        return _Flight(rec, dev_leaves, host, event, did_pack, unflatten)

    def _dispatch_loop(self) -> None:
        if self._cuda:
            with torch.cuda.device(self.device), torch.cuda.stream(self._compute):
                self._dispatch()
        else:
            self._dispatch()

    def _dispatch(self) -> None:
        while True:
            taken = self._take_batch()
            if taken is None:
                self._inflight.put(None)  # sentinel: the collector drains and exits
                return
            rec = _BatchRecord()
            try:
                flight = self._launch(taken, rec)
            except Exception as e:  # every waiter of the batch gets it
                for fut in taken:
                    fut._rec = rec
                    fut._q = None
                rec.exc = e
                self._resolve(rec)
                continue
            self._inflight.put(flight)

    def _resolve(self, rec: _BatchRecord) -> None:
        with self._cond:
            rec.ready = True
            self._cond.notify_all()

    def _wait_drain(self, flights) -> None:
        """Wait for the last flight's copy: the side stream runs the copies
        in order, so the earlier ones are done with it."""
        if flights[-1].event is not None:
            flights[-1].event.synchronize()

    def _land(self, f: _Flight) -> None:
        """Fill the record from the flight's host tensors."""
        got = [h.numpy() for h in f.host]
        rec = f.rec
        if f.packed:
            rec.leaves = self._unpack_rows(got[0])
        else:
            rec.leaves = got
        rec.unflatten = f.unflatten
        f.keep = None

    def _collect_loop(self) -> None:
        if self._cuda:
            with torch.cuda.device(self.device):
                self._collect()
        else:
            self._collect()

    def _collect(self) -> None:
        get, get_nowait = self._inflight.get, self._inflight.get_nowait
        done = False
        while not done:
            item = get()
            if item is None:
                return
            items = [item]
            # Every batch already in flight joins this drain.
            while True:
                try:
                    nxt = get_nowait()
                except queue_mod.Empty:
                    break
                if nxt is None:
                    done = True  # close(): finish what we hold, then exit
                    break
                items.append(nxt)
            self._n_drains += 1
            self._n_collected += len(items)
            if self._fuse_drains:
                try:
                    self._wait_drain(items)
                    for f in items:
                        self._land(f)
                except Exception:
                    pass  # each flight alone, below
                else:
                    if len(items) > 1:
                        self._n_fused_drains += 1
                    with self._cond:  # one broadcast for the whole drain
                        for f in items:
                            f.rec.ready = True
                        self._cond.notify_all()
                    continue
            for f in self._isolate(items):
                self._resolve(f.rec)

    def _isolate(self, items) -> list:
        """Wait for and land each flight alone, so a failed one fails only
        its own waiters → the flights, each record filled or holding its
        error."""
        for f in items:
            try:
                self._wait_drain([f])
                self._land(f)
            except Exception as e:
                f.rec.exc = e
        return items
