"""Asynchronous device prefetch: overlap host-to-device copies with the
step.

Counterpart of paddle_tpu/io/prefetch.py without its sharding, chaos
sites and metrics. A `DevicePrefetcher` pulls batches from any iterator
on a background thread and keeps up to `depth` of them ready on the
device, so `Trainer.step` finds its batch already placed and copies
nothing on the thread that launches the kernels.

On a CUDA device each array or tensor leaf is staged in pinned host
memory and copied with `non_blocking=True` on a side stream; an event
recorded after the copies travels with the batch, and `next()` makes the
consumer's current stream wait on it (a wait on the device, not on the
host) and marks the batch's tensors as used on that stream, so the
allocator does not hand their memory back to the side stream while the
step still reads it. On the CPU (`device="cpu"`) the leaves are only
converted to tensors, with no stream.

Lifecycle contract (the JAX package's):
  - exhaustion of the source propagates as StopIteration;
  - an exception of the worker is re-raised in the consumer (the same
    exception object);
  - `close()` (or leaving the context manager) stops the worker, drains
    the queue and joins the thread; safe mid-epoch and idempotent;
  - the queue is bounded by `depth`: a slow consumer holds the worker
    back instead of buffering the epoch on the device.
"""
from __future__ import annotations

import queue as _queue
import threading
import weakref

import numpy as np
import torch

__all__ = ["DevicePrefetcher", "prefetch_to_device"]

# queue item tags (the payload rides alongside)
_ITEM, _DONE, _ERR = 0, 1, 2


class DevicePrefetcher:
    """Iterate `source`, yielding batches whose array and tensor leaves
    already lie on `device` (default the current CUDA card), prefetched
    `depth` ahead by a background thread. Up to `depth` batches wait in
    the queue, plus one held by the worker while the queue is full."""

    def __init__(self, source, *, device="cuda", depth=2):
        self._it = iter(source)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.depth = max(1, int(depth))
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: _queue.Queue = _queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._finished = False
        # the thread holds only a weak reference to self, so a prefetcher
        # abandoned without close() stays collectable and its __del__
        # stops the worker
        self._thread = threading.Thread(
            target=_worker_loop, args=(weakref.ref(self), self._stop,
                                       self._q),
            daemon=True, name="ptt-device-prefetch")
        self._thread.start()

    # -- placement (worker thread) ------------------------------------
    def _place_leaf(self, v, placed):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if not isinstance(v, torch.Tensor):
            return v            # a non-array leaf: the consumer converts
        if self._stream is None:
            out = v.to(self.device)
        elif v.device == self.device:
            out = v
        else:
            host = v if v.is_pinned() or v.device.type != "cpu" \
                else v.pin_memory()
            out = host.to(self.device, non_blocking=True)
        placed.append(out)
        return out

    def _place(self, tree, placed):
        if isinstance(tree, dict):
            return {k: self._place(v, placed) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [self._place(v, placed) for v in tree]
            if hasattr(tree, "_fields"):      # namedtuple batches
                return type(tree)(*vals)
            return type(tree)(vals)
        return self._place_leaf(tree, placed)

    def _produce_one(self):
        """Pull and place one batch (worker thread): a queue item, _DONE
        when the source is exhausted."""
        try:
            batch = next(self._it)
        except StopIteration:
            return _DONE, None
        placed = []
        if self._stream is None:
            out = self._place(batch, placed)
            event = None
        else:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                out = self._place(batch, placed)
                event = torch.cuda.Event()
                event.record(self._stream)
        return _ITEM, (out, event, placed)

    # -- consumer ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        while True:
            try:
                tag, payload = self._q.get(timeout=0.1)
                break
            except _queue.Empty:
                if self._stop.is_set() and not self._thread.is_alive():
                    self._finished = True
                    raise StopIteration from None
        if tag == _ITEM:
            batch, event, placed = payload
            if event is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(event)
                for t in placed:
                    t.record_stream(current)
            return batch
        self._finished = True
        if tag == _ERR:
            raise payload
        raise StopIteration                     # _DONE

    def qsize(self) -> int:
        """Batches waiting in the queue (advisory)."""
        return self._q.qsize()

    # -- lifecycle -----------------------------------------------------
    def close(self):
        """Stop the worker and release the queue. Idempotent; safe
        mid-epoch (batches already prefetched are dropped)."""
        self._stop.set()
        _drain(self._q)         # a worker blocked on a full queue sees stop
        self._finished = True
        it_close = getattr(self._it, "close", None)
        if it_close is not None:
            try:
                it_close()      # generator sources: run their finally blocks
            except ValueError:  # the worker is inside the generator's next()
                pass
        if threading.current_thread() is self._thread:
            return              # __del__ ran on the worker: it exits itself
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            import warnings
            warnings.warn(
                "DevicePrefetcher.close(): the worker did not exit within "
                "5 s (the source's next() is still blocking); the daemon "
                "thread exits when it returns", stacklevel=2)
        _drain(self._q)         # a put that was blocked may have landed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        if hasattr(self, "_thread") and not self._stop.is_set():
            self.close()


def _drain(q):
    try:
        while True:
            q.get_nowait()
    except _queue.Empty:
        pass


def _worker_loop(wref, stop, q):
    """The prefetch thread. It holds the prefetcher only through `wref`,
    re-checked between batches and while waiting on a full queue."""
    while not stop.is_set():
        self = wref()
        if self is None:
            return
        try:
            tag, payload = self._produce_one()
        except BaseException as e:    # noqa: BLE001 - handed to the consumer
            tag, payload = _ERR, e
        del self                      # no strong reference while parked
        while True:                   # bounded-queue push
            if stop.is_set():
                return
            try:
                q.put((tag, payload), timeout=0.05)
                break
            except _queue.Full:
                if wref() is None:
                    return            # the consumer abandoned us
        if tag != _ITEM:
            return                    # exhaustion or error: done


def prefetch_to_device(source, depth=2, *, device="cuda"):
    """`for batch in prefetch_to_device(loader): ...`; training code
    should prefer `Trainer.data_iter(loader)`, which passes the model's
    device."""
    return DevicePrefetcher(source, device=device, depth=depth)
