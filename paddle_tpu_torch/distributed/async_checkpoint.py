"""Asynchronous checkpointing: snapshot-then-write saves that overlap
training.

Counterpart of paddle_tpu/distributed/async_checkpoint.py. A save is
split at the only point the training thread has to take part:

  1. **Snapshot** (training thread): `checkpoint._snapshot_state`
     copies every tensor on the card into one pinned host buffer (all
     copies enqueued, then one wait) and clones CPU tensors. `save()`
     returns once the snapshot is in host memory, so the next step may
     update parameters and moments in place.
     `checkpoint.snapshot.seconds` records this stall.
  2. **Write** (writer thread): the format-v4 files through
     `checkpoint._write_files` (the shard file hashed while written,
     `__table_digest__`, tmp-then-rename), so `verify_checkpoint` and
     `load_newest_complete` treat these checkpoints as sync ones.
     `checkpoint.write.seconds` records this part.
  3. **Commit**: the completion marker (metadata.json) is written by
     the coordinator after every process's files landed, and `wait()`
     returns after the marker did: a crash mid-write leaves a directory
     without a marker, which the newest-complete scan passes over.
     Across processes both points are barriers over a
     torch.distributed Store (`store=`, `rank=`, `world_size=`).

One outstanding save: `policy="wait"` (default) makes a new `save()`
wait until the previous one committed; `policy="supersede"` replaces a
queued-but-unstarted save (a save already writing always finishes).

Writer failures re-raise as the ORIGINAL exception object from the next
`save()`/`wait()`/`flush()`, and an atexit hook drains in-flight saves
so interpreter exit never truncates the run's last checkpoint. The
`checkpoint.async.pending` gauge (queued + in flight) is what the fleet
heartbeat reports.
"""
from __future__ import annotations

import atexit
import collections
import datetime
import os
import sys
import threading
import time
import weakref

from paddle_tpu_torch import observability
from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.distributed import checkpoint as _ckpt

__all__ = ["AsyncCheckpointer"]


class _Save:
    """One enqueued snapshot on its way to disk."""

    __slots__ = ("payload", "meta", "pid", "path", "coordinator_rank",
                 "callbacks", "committed", "error")

    def __init__(self, payload, meta, pid, path, coordinator_rank):
        self.payload = payload
        self.meta = meta
        self.pid = pid
        self.path = path
        self.coordinator_rank = coordinator_rank
        self.callbacks: list = []
        self.committed = False
        self.error = None


# live checkpointers, drained by ONE atexit hook
_LIVE: "weakref.WeakSet[AsyncCheckpointer]" = weakref.WeakSet()


def _atexit_flush():
    for cp in list(_LIVE):
        try:
            cp.flush()
        except Exception as e:  # noqa: BLE001 — exit path: report only
            print(f"WARNING: async checkpoint flush failed at exit: "
                  f"{e!r}", file=sys.stderr)


atexit.register(_atexit_flush)


class AsyncCheckpointer:
    """Snapshot-then-write checkpoint saver (see module docstring).

    policy: "wait" (a new save() first waits for the previous one to
        commit: one payload alive at a time) or "supersede" (save()
        never waits on the writer; a queued save that has not started
        is replaced by the newer one; one process only).
    store / rank / world_size: a torch.distributed Store (e.g. a
        TCPStore) for the commit barriers of a multi-process run; rank
        and world_size default to torch.distributed's when it is
        initialized. A multi-process checkpointer without a store is
        refused.
    coordinator_rank: which process commits the completion marker.
    """

    def __init__(self, *, policy="wait", coordinator_rank=0, store=None,
                 rank=None, world_size=None, barrier_timeout=600.0):
        if policy not in ("wait", "supersede"):
            raise ValueError(
                f"policy must be 'wait' or 'supersede', got {policy!r}")
        d_rank, d_world = _ckpt._dist()
        ws = int(world_size) if world_size is not None else d_world
        if policy == "supersede" and ws > 1:
            # superseding is a process-local queue decision: one rank
            # skipping a save the others perform would pair the commit
            # barriers of different saves
            raise ValueError(
                "policy='supersede' is single-process only: rank-local "
                "supersede decisions desynchronize the collective "
                "commit barriers; use policy='wait' in multi-process "
                "runs")
        if ws > 1 and store is None:
            raise ValueError(
                f"a {ws}-process AsyncCheckpointer needs store= (a "
                "torch.distributed Store) for its commit barriers")
        self.policy = policy
        self.coordinator_rank = int(coordinator_rank)
        # a connection of the writer's own: a blocking wait() on a
        # shared client would hold its socket from every other thread
        self._store = store.clone() if hasattr(store, "clone") else store
        self._rank = int(rank) if rank is not None else d_rank
        self._world_size = ws
        self._barrier_timeout = float(barrier_timeout)
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._inflight: _Save | None = None
        self._error = None          # first un-reraised writer failure
        self._stop = False
        self._closed = False
        self._thread: threading.Thread | None = None
        self._last_job: _Save | None = None
        self._barrier_seq = 0       # writer-thread-only (no lock)
        self.saves_started = 0
        self.saves_committed = 0
        _LIVE.add(self)

    # -- public API ----------------------------------------------------
    def save(self, state_dict, path, *, on_complete=None):
        """Snapshot `state_dict` NOW (the only part the caller pays) and
        enqueue the write. Returns once the snapshot is in host memory:
        later training steps may update the tensors in place.
        `on_complete` (optional, called on the writer thread) runs after
        the completion marker committed."""
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncCheckpointer is closed")
        if self.policy == "wait":
            # one outstanding save: drain (and surface any failure of)
            # the previous one BEFORE snapshotting
            self.wait()
        payload, meta, pid = _ckpt._snapshot_state(state_dict,
                                                    pid=self._rank)
        job = _Save(payload, meta, pid, os.path.abspath(str(path)),
                    self.coordinator_rank)
        if on_complete is not None:
            job.callbacks.append(on_complete)
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncCheckpointer is closed")
            if self.policy == "supersede":
                # replace anything not yet started; the in-flight save
                # (if any) finishes untouched
                self._queue.clear()
            self._queue.append(job)
            self._last_job = job
            self.saves_started += 1
            self._ensure_thread()
            self._pending_gauge_locked()
            self._cv.notify_all()
        return job

    def wait(self, timeout=None):
        """Block until every enqueued save is durably committed (files,
        barrier, marker); re-raise the first writer failure as the
        ORIGINAL exception object. Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._queue or self._inflight is not None:
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._cv.wait(rem)
            err, self._error = self._error, None
        if err is not None:
            raise err
        return True

    def flush(self, timeout=None):
        """wait(), named for the lifecycle: call on a preemption signal
        and at normal exit so the last checkpoint is durable."""
        return self.wait(timeout)

    def on_complete(self, fn):
        """Attach `fn` to the most recently enqueued save: it runs (on
        the writer thread) after that save's marker commits. When that
        save already committed, `fn` runs now on the calling thread;
        when it FAILED (or was superseded), `fn` is dropped."""
        with self._cv:
            target = self._queue[-1] if self._queue else self._inflight
            if target is not None and not target.committed:
                target.callbacks.append(fn)
                return
            last = self._last_job
        if last is not None and not last.committed:
            return      # the save died before fn could attach: drop
        fn()

    @property
    def pending(self) -> int:
        """Saves not yet durably committed (queued + in flight)."""
        with self._cv:
            return len(self._queue) + (self._inflight is not None)

    def close(self, flush=True):
        """Stop the writer. With `flush` (default) all queued saves
        commit first (re-raising a writer failure); with flush=False
        queued-but-unstarted saves are dropped and only the in-flight
        one finishes. Idempotent."""
        with self._cv:
            self._closed = True
            if not flush:
                self._queue.clear()
        try:
            if flush:
                self.flush()
        finally:
            with self._cv:
                self._stop = True
                self._cv.notify_all()
            t = self._thread
            if t is not None:
                t.join(timeout=60)
            _LIVE.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- writer --------------------------------------------------------
    def _ensure_thread(self):
        # caller holds self._cv
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer, daemon=True,
                name="ckpt-async-writer")
            self._thread.start()

    def _writer(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if not self._queue:           # stop requested, drained
                    return
                job = self._queue.popleft()
                self._inflight = job
            try:
                callbacks = self._write(job)
                # the save is durable by here: a failing callback is the
                # caller's problem (warn, keep going)
                for cb in callbacks:
                    try:
                        cb()
                    except Exception as e:    # noqa: BLE001
                        print(f"WARNING: async checkpoint on_complete "
                              f"callback failed for {job.path!r}: "
                              f"{e!r}", file=sys.stderr)
            except BaseException as e:        # noqa: BLE001 — handed to
                job.error = e                 # the consumer as the
                with self._cv:                # original object
                    if self._error is None:
                        self._error = e
            finally:
                with self._cv:
                    self._inflight = None
                    if job.error is None:
                        self.saves_committed += 1
                    # the gauge moves under the lock, BEFORE waiters wake
                    self._pending_gauge_locked()
                    self._cv.notify_all()

    def _write(self, job):
        t0 = time.monotonic()
        if chaos.ENABLED:
            chaos.maybe_delay("ckpt.async.delay")
        _ckpt._write_files(job.payload, job.meta, job.pid, job.path,
                           job.coordinator_rank, defer_marker=True)
        job.payload = job.meta = None      # free the snapshot promptly
        if chaos.ENABLED and chaos.should_fire("ckpt.async.fail"):
            # the writer dying after its files landed, before the marker:
            # the torn state the marker ordering makes recoverable
            raise chaos.InjectedFault(
                f"chaos: async checkpoint writer killed at {job.path!r} "
                "after file writes, before the completion marker")
        self._barrier("files")
        if job.pid == job.coordinator_rank:
            _ckpt._write_marker(job.path, self._world_size)
        # no process's wait() may return (and start a scan that would
        # quarantine a marker-less directory) before the marker exists
        self._barrier("marker")
        if observability.ENABLED:
            observability.observe("checkpoint.write.seconds",
                                  time.monotonic() - t0)
        with self._cv:
            job.committed = True
            return list(job.callbacks)

    def _barrier(self, stage):
        """Every process's writer reaches `stage` of the same save: each
        sets its key, then waits for all of them. Saves through one
        checkpointer are collective and its writer is one thread, so the
        private sequence number advances in lockstep."""
        if self._world_size <= 1:
            return
        self._barrier_seq += 1
        name = f"async_ckpt/{stage}/{self._barrier_seq}"
        self._store.set(f"{name}/{self._rank}", b"1")
        self._store.wait([f"{name}/{r}" for r in range(self._world_size)],
                         datetime.timedelta(seconds=self._barrier_timeout))

    def _pending_gauge_locked(self):
        # caller holds self._cv
        if observability.ENABLED:
            observability.set_gauge(
                "checkpoint.async.pending",
                len(self._queue) + (self._inflight is not None))
