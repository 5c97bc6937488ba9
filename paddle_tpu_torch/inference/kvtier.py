"""Host-RAM KV tier: spill evicted-but-reusable prefix pages to host
memory, restore them on a later hit.

Counterpart of paddle_tpu/inference/kvtier.py. `PagedKVEngine(
host_tier_bytes=N)` consults a `HostKVTier` at the moments the device
prefix cache changes population:

- **Spill**: when eviction would destroy a zero-ref cached page, the
  engine gathers the page's rows of every pool buffer into a fresh
  device tensor on its stream (a snapshot: the page goes back to the
  free list right after, where its int8 scales are zeroed and the next
  request's scatter overwrites it), copies that to pinned host memory on
  a side stream and records an event. This tier's worker waits on the
  event, off the scheduler thread, before it commits the entry, so a
  spill never stalls a tick. On the CPU the gather is the copy.
- **Restore**: admission extends a device-cache run with host-resident
  pages through one batched copy per pool buffer into the buffers the
  captured tick reads (the engine's `_tier_upload`).
- **Suspend/resume**: a long-idle session's cached pages take the same
  spill path (the engine's `suspend_after_s` sweep).

Entries are host CPU tensors (pinned when the engine is on CUDA): per
layer a tuple in pool-group order, (k, v) shaped (kv_heads, page_size,
head_dim), or for int8 KV (k, v, k_scale_row, v_scale_row) with
(kv_heads,) f32 scale rows, plus the draft model's mirror; the JAX
package's layout, so an entry and a disaggregation bundle
(inference/disagg.py) mean the same thing in both packages. Keys are
the chain keys of inference/prefix.py: a key commits to the full token
prefix, and KV content is a function of it, so a key already resident
never needs capturing again.

One leaf lock guards everything (never held while calling back into
the engine). The worker is a daemon holding a weakref to the tier, so
an abandoned tier stays collectable; `stop()` joins it. With
observability on, spills, restores, suspends and resumes count into the
`inference.kvtier.*` instruments, at the JAX module's sites;
`snapshot()` carries the JAX module's keys.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
import warnings
import weakref

from paddle_tpu_torch import observability

__all__ = ["HostKVTier"]

_SENTINEL = object()


def _group_bytes(groups):
    return sum(a.nbytes for grp in groups for a in grp)


class _HostEntry:
    """One spilled page: per-layer tuples of host arrays in pool-group
    order ((k, v) or (k, v, k_scale_row, v_scale_row)), plus the draft
    model's mirror when the engine runs speculative decoding."""

    __slots__ = ("layers", "draft", "nbytes")

    def __init__(self, layers, draft):
        self.layers = layers
        self.draft = draft
        n = _group_bytes(layers)
        if draft is not None:
            n += _group_bytes(draft)
        self.nbytes = n


def _worker_loop(tier_ref, stop, q):
    """Drain spill jobs. Holds only a weakref to the tier (plus the stop
    event and queue, which carry no back-reference): a tier abandoned
    without stop() stays collectable and the worker exits on its next
    poll."""
    while not stop.is_set():
        try:
            item = q.get(timeout=0.5)
        except _queue.Empty:
            if tier_ref() is None:
                return
            continue
        if item is _SENTINEL:
            return
        tier = tier_ref()
        if tier is None:
            return
        tier._commit(item)
        del tier


class HostKVTier:
    """Byte-budgeted LRU of chain key -> host-resident KV page.

    Thread-safe: the engine's scheduler thread enqueues spills and takes
    restore runs; the worker commits entries once their copies have
    landed; caller threads read snapshots and runs. All state mutates
    under one leaf lock.
    """

    def __init__(self, budget_bytes):
        self.budget_bytes = int(budget_bytes)
        if self.budget_bytes <= 0:
            raise ValueError(
                f"budget_bytes must be > 0, got {budget_bytes}")
        self._entries: collections.OrderedDict[str, _HostEntry] = \
            collections.OrderedDict()
        self._bytes = 0
        self._drafts = 0            # entries still carrying a draft mirror
        self._pending = 0           # spills enqueued, not yet committed
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread = None
        self._q: _queue.Queue = _queue.Queue()
        # counters (all guarded by _lock; snapshot() is the reader)
        self.spilled_pages = 0
        self.restored_pages = 0
        self.spill_bytes = 0
        self.restore_bytes = 0
        self.suspends = 0
        self.resumes = 0
        self.lookups = 0            # restore consults (per admission)
        self.hits = 0               # consults that extended the run
        self.evictions = 0          # entries dropped by the byte budget
        self.draft_dropped = 0      # draft mirrors shed before entries
        self.spill_skipped = 0      # captures dropped (a chaos site)
        self.spill_errors = 0       # worker-side copy failures

    def __len__(self):
        with self._lock:
            return len(self._entries)

    # -- spill (scheduler thread enqueues, worker commits) ---------------
    def _ensure_worker(self):
        # under _lock. Started lazily, and again after stop(), so an
        # engine that never evicts owns no thread
        t = self._thread
        if t is not None and t.is_alive():
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_worker_loop,
            args=(weakref.ref(self), self._stop, self._q),
            daemon=True, name="ptt-kvtier-spill")
        self._thread.start()

    def spill(self, key, layers, draft=None, ready=None):
        """Queue one page's host arrays for commit. `ready` (a CUDA event,
        or None when the arrays already hold the page) is recorded after
        the copies that fill them; the worker waits on it. Returns
        immediately."""
        with self._cond:
            self._pending += 1
            self._ensure_worker()
        self._q.put((key, layers, draft, ready))

    def _commit(self, item):
        """Worker thread: wait for one job's copies and install it under
        the byte-budgeted LRU."""
        key, layers, draft, ready = item
        try:
            if ready is not None:
                ready.synchronize()
            entry = _HostEntry(layers, draft)
        except Exception:       # noqa: BLE001 — a failed copy loses one
            #                     page, never the worker
            with self._cond:
                self.spill_errors += 1
                self._pending -= 1
                self._cond.notify_all()
            return
        with self._cond:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
                if old.draft is not None:
                    self._drafts -= 1
            self._entries[key] = entry
            self._bytes += entry.nbytes
            if entry.draft is not None:
                self._drafts += 1
            self.spilled_pages += 1
            self.spill_bytes += entry.nbytes
            while self._bytes > self.budget_bytes and self._entries:
                # draft mirrors go first: losing one only costs
                # speculation acceptance on a later restore (the target
                # verifies, so outputs stay exact), losing an entry
                # costs a full prefill. The oldest draft-carrying entry
                # sheds its mirror; whole-entry LRU eviction resumes
                # once no drafts remain
                victim = None
                if self._drafts:
                    for e in self._entries.values():
                        if e.draft is not None:
                            victim = e
                            break
                if victim is not None:
                    dropped = _group_bytes(victim.draft)
                    victim.draft = None
                    victim.nbytes -= dropped
                    self._bytes -= dropped
                    self._drafts -= 1
                    self.draft_dropped += 1
                    continue
                _, ev = self._entries.popitem(last=False)
                self._bytes -= ev.nbytes
                if ev.draft is not None:
                    self._drafts -= 1
                self.evictions += 1
            self._pending -= 1
            self._cond.notify_all()
        if observability.ENABLED:
            observability.inc("inference.kvtier.spilled_pages")
            observability.inc("inference.kvtier.spill_bytes",
                              entry.nbytes)

    def flush(self, timeout=30.0):
        """Block until every queued spill has committed. Returns True
        when drained."""
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0,
                                       timeout)

    # -- restore (scheduler thread) ---------------------------------------
    def has(self, key):
        with self._lock:
            return key in self._entries

    def match_run(self, keys):
        """Entries for the longest LEADING run of `keys` resident, the
        chain-truncation of PrefixCache.match. Matched entries are
        LRU-touched and returned as (key, entry) pairs; they stay
        resident (a later re-eviction of the restored page needs no new
        copy)."""
        out = []
        with self._lock:
            if keys:
                self.lookups += 1
            for k in keys:
                e = self._entries.get(k)
                if e is None:
                    break
                self._entries.move_to_end(k)
                out.append((k, e))
            if out:
                self.hits += 1
        return out

    def peek_run(self, keys):
        """`match_run` without touching LRU order or the lookup and hit
        counters: the disaggregation export reads pages on a caller
        thread and must not skew the restore hit rate or recency."""
        out = []
        with self._lock:
            for k in keys:
                e = self._entries.get(k)
                if e is None:
                    break
                out.append((k, e))
        return out

    def discard(self, key):
        """Drop one entry (the engine found it geometry-incompatible)."""
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self._bytes -= e.nbytes
                if e.draft is not None:
                    self._drafts -= 1

    # -- engine-side accounting -------------------------------------------
    def note_restored(self, n_pages, nbytes):
        with self._lock:
            self.restored_pages += n_pages
            self.restore_bytes += nbytes
        if observability.ENABLED:
            observability.inc("inference.kvtier.restored_pages",
                              n_pages)
            observability.inc("inference.kvtier.restore_bytes", nbytes)

    def note_suspend(self):
        with self._lock:
            self.suspends += 1
        if observability.ENABLED:
            observability.inc("inference.kvtier.suspends")

    def note_resume(self):
        with self._lock:
            self.resumes += 1
        if observability.ENABLED:
            observability.inc("inference.kvtier.resumes")

    def note_spill_skipped(self):
        """Chaos `kvtier.spill.fail`: the capture was dropped and the
        eviction went on as a plain (destructive) one."""
        with self._lock:
            self.spill_skipped += 1

    # -- observation --------------------------------------------------------
    def snapshot(self):
        """The /stats `kvtier` block."""
        with self._lock:
            lk = self.lookups
            return {"enabled": True,
                    "host_pages": len(self._entries),
                    "host_bytes": self._bytes,
                    "budget_bytes": self.budget_bytes,
                    "pending_spills": self._pending,
                    "spilled_pages": self.spilled_pages,
                    "restored_pages": self.restored_pages,
                    "spill_bytes": self.spill_bytes,
                    "restore_bytes": self.restore_bytes,
                    "suspends": self.suspends,
                    "resumes": self.resumes,
                    "lookups": lk,
                    "hits": self.hits,
                    "hit_rate": round(self.hits / lk, 4) if lk else 0.0,
                    "evictions": self.evictions,
                    "draft_dropped": self.draft_dropped,
                    "spill_skipped": self.spill_skipped,
                    "spill_errors": self.spill_errors}

    # -- lifecycle ------------------------------------------------------------
    def stop(self, join_timeout=5.0):
        """Stop the worker after it drains queued spills (entries stay
        resident; a later spill() starts it again)."""
        with self._lock:
            t = self._thread
            self._thread = None
        if t is None or not t.is_alive():
            return
        self._q.put(_SENTINEL)
        t.join(timeout=join_timeout)
        if t.is_alive():        # a daemon: it dies with the process
            warnings.warn("HostKVTier: spill worker did not stop "
                          f"within {join_timeout}s", stacklevel=2)
