"""Disaggregated prefill/decode: chain-key-addressed KV page handoff.

Counterpart of paddle_tpu/inference/disagg.py. A prefill-pool engine
(`PagedKVEngine(role="prefill")`) captures each request's committed
full prompt pages to its host tier (inference/kvtier.py) right after
the prefill that wrote them; `export_pages(keys)` hands them out as
`PageBundleEntry` objects. A decode-pool engine (`role="decode"`) asks
`disagg_missing(keys)` which pages it lacks, takes the bundle through
`stage_import`, and its scheduler inserts the pages into its prefix
cache before the next admission, so the request admits warm. This
module holds the pieces between them:

- **Bundle wire format** (`pack_bundle` / `unpack_bundle`), the JAX
  module's byte for byte: the `PTKV1\\n` magic, a little-endian u32
  header length, a JSON header (per-array dtype and shape by numpy's
  names: "bfloat16", "int8", "float32"; the draft mirror nullable),
  then the arrays' raw bytes in order. A bundle either package packs
  unpacks in the other. `pack_bundle` takes torch tensors or numpy
  arrays; `unpack_bundle` gives CPU torch tensors (bfloat16 read by
  torch itself, no ml_dtypes).
- **`DisaggStats`**: the engine-side counters; `snapshot()` is the
  /stats `disagg` block, which always carries `role`. With
  observability on they also count into the `inference.disagg.*`
  instruments, at the JAX module's sites.
- **`HandoffArbiter`**: weighted-fair ordering of concurrent transfers
  (virtual-finish-time WFQ with weights from `TenantPolicy.weight`).
"""
from __future__ import annotations

import json
import struct
import threading

import numpy as np
import torch

from paddle_tpu_torch import observability

__all__ = ["PageBundleEntry", "pack_bundle", "unpack_bundle",
           "DisaggStats", "HandoffArbiter"]

_MAGIC = b"PTKV1\n"

# the dtypes a bundle may name, by numpy's name
_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "float64": torch.float64,
                 "int8": torch.int8, "uint8": torch.uint8,
                 "int16": torch.int16, "int32": torch.int32,
                 "int64": torch.int64, "bool": torch.bool}


class PageBundleEntry:
    """One page travelling between replicas: kvtier's host-entry layout
    (per-layer tuples of host arrays in pool-group order, the draft
    mirror nullable) plus the chain key that names it."""

    __slots__ = ("key", "layers", "draft", "nbytes")

    def __init__(self, key, layers, draft=None):
        self.key = key
        self.layers = layers
        self.draft = draft
        n = sum(a.nbytes for grp in layers for a in grp)
        if draft is not None:
            n += sum(a.nbytes for grp in draft for a in grp)
        self.nbytes = n


def dtype_name(a):
    """numpy's name for the element type of a torch tensor or a numpy
    array ("bfloat16", "int8", "float32", ...): the name a bundle header
    carries and a host entry's type is compared by."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return str(a.dtype)


def _raw(a):
    """A contiguous numpy array over `a`'s bytes (a torch tensor's bf16
    viewed as int16, which numpy can hold); `b"".join` copies it once."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    return np.ascontiguousarray(a)


def _group_meta(groups):
    return [[{"dtype": dtype_name(a), "shape": [int(s) for s in a.shape]}
             for a in grp] for grp in groups]


def pack_bundle(entries):
    """Serialize entries (anything exposing `.key` / `.layers` /
    `.draft`) into one blob. int8 pools ship their f32 scale rows as
    more arrays in the group; the header records each array's dtype and
    shape, so the format never needs to know about quantization."""
    meta = []
    blobs = []
    for ent in entries:
        draft = ent.draft   # read once: the host tier may strip a
        #                     draft mirror concurrently (budget
        #                     pressure); either snapshot is valid
        meta.append({"key": ent.key,
                     "layers": _group_meta(ent.layers),
                     "draft": None if draft is None
                     else _group_meta(draft)})
        for grp in ent.layers:
            blobs.extend(_raw(a) for a in grp)
        if draft is not None:
            for grp in draft:
                blobs.extend(_raw(a) for a in grp)
    header = json.dumps({"entries": meta}).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(header)), header]
                    + blobs)


def _read_groups(meta, raw, off):
    groups = []
    for grp_meta in meta:
        grp = []
        for m in grp_meta:
            dt = _TORCH_DTYPES.get(m["dtype"])
            if dt is None:
                raise ValueError(f"disagg bundle names an unknown dtype "
                                 f"{m['dtype']!r}")
            shape = tuple(int(s) for s in m["shape"])
            count = 1
            for s in shape:
                count *= s
            n = count * dt.itemsize
            if off + n > len(raw):
                raise ValueError("disagg bundle truncated")
            if count == 0:
                grp.append(torch.empty(shape, dtype=dt))
            else:
                grp.append(torch.frombuffer(raw, dtype=dt, count=count,
                                            offset=off).reshape(shape))
            off += n
        groups.append(tuple(grp))
    return groups, off


def unpack_bundle(raw):
    """Parse a `pack_bundle` blob back into `PageBundleEntry` objects of
    CPU torch tensors, views over one private copy of `raw` (the import
    copies them into the pools anyway); a malformed blob raises
    ValueError."""
    buf = bytearray(raw)        # writable: torch.frombuffer's tensors
    if not buf.startswith(_MAGIC):
        raise ValueError("not a disagg page bundle (bad magic)")
    off = len(_MAGIC)
    if off + 4 > len(buf):
        raise ValueError("disagg bundle truncated")
    (hlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    header = json.loads(buf[off:off + hlen].decode())
    off += hlen
    out = []
    for m in header.get("entries", []):
        layers, off = _read_groups(m["layers"], buf, off)
        draft = None
        if m.get("draft") is not None:
            draft, off = _read_groups(m["draft"], buf, off)
        out.append(PageBundleEntry(str(m["key"]), layers, draft))
    return out


class DisaggStats:
    """Counters for one engine's view of the handoff protocol (one leaf
    lock, never held while calling anything). `snapshot()` is the /stats
    `disagg` block; it always carries `role`, which is how a router
    learns pool membership without configuration."""

    def __init__(self, role="both"):
        self.role = role
        self._lock = threading.Lock()
        self.handoff_pages = 0      # pages served to peers
        self.handoff_bytes = 0      # packed bundle bytes served
        self.pulled_pages = 0       # pages fetched from a peer
        self.pulled_bytes = 0
        self.imported_pages = 0     # peer pages written into the pools
        self.imported_bytes = 0
        self.dedup_skipped_pages = 0  # already resident: not moved
        self.transfer_s = 0.0
        self.pull_failures = 0      # degraded to a local cold prefill

    def note_export(self, pages, nbytes):
        with self._lock:
            self.handoff_pages += pages
            self.handoff_bytes += nbytes
        if observability.ENABLED:
            observability.inc("inference.disagg.handoff_pages", pages)
            observability.inc("inference.disagg.handoff_bytes", nbytes)

    def note_pull(self, pages, nbytes, seconds, skipped=0):
        with self._lock:
            self.pulled_pages += pages
            self.pulled_bytes += nbytes
            self.transfer_s += seconds
            self.dedup_skipped_pages += skipped
        if observability.ENABLED:
            observability.observe("inference.disagg.transfer_seconds",
                                  seconds)
            if skipped:
                observability.inc(
                    "inference.disagg.dedup_skipped_pages", skipped)

    def note_dedup(self, pages):
        """Every key was already resident: the handoff moved nothing."""
        with self._lock:
            self.dedup_skipped_pages += pages
        if observability.ENABLED:
            observability.inc("inference.disagg.dedup_skipped_pages",
                              pages)

    def note_imported(self, pages, nbytes):
        with self._lock:
            self.imported_pages += pages
            self.imported_bytes += nbytes
        if observability.ENABLED:
            observability.inc("inference.disagg.imported_pages", pages)
            observability.inc("inference.disagg.imported_bytes", nbytes)

    def note_pull_failure(self):
        with self._lock:
            self.pull_failures += 1
        if observability.ENABLED:
            observability.inc("inference.disagg.pull_failures")

    def snapshot(self):
        with self._lock:
            return {"role": self.role,
                    "handoff_pages": self.handoff_pages,
                    "handoff_bytes": self.handoff_bytes,
                    "pulled_pages": self.pulled_pages,
                    "pulled_bytes": self.pulled_bytes,
                    "imported_pages": self.imported_pages,
                    "imported_bytes": self.imported_bytes,
                    "dedup_skipped_pages": self.dedup_skipped_pages,
                    "transfer_s": round(self.transfer_s, 6),
                    "pull_failures": self.pull_failures}


class HandoffArbiter:
    """Weighted-fair admission to the KV transfer path.

    `max_concurrent` transfers run at once; excess callers queue and are
    granted in virtual-finish-time order. Each grant charges its tenant
    1 / weight of virtual time (weights from
    `TenantTable.policy(t).weight`; every tenant weighs 1 without a
    table), so a tenant's burst still interleaves with everyone else in
    weight proportion: tenancy.WeightedFairScheduler's discipline,
    applied to transfers.

    One lock and condition; the lock is never held during the transfer
    itself (acquire returns before the caller does its I/O).
    """

    def __init__(self, tenancy=None, max_concurrent=2):
        self.max_concurrent = int(max_concurrent)
        if self.max_concurrent <= 0:
            raise ValueError(
                f"max_concurrent must be > 0, got {max_concurrent}")
        self._table = tenancy
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._active = 0
        self._vt = 0.0              # system virtual time (last grant)
        self._tenant_vft = {}       # tenant -> last virtual finish time
        self._waiting = []          # sorted [(vft, seq, tenant), ...]
        self._seq = 0
        self.granted = 0

    def _weight(self, tenant):
        if self._table is None:
            return 1.0
        try:
            return max(float(self._table.policy(tenant).weight), 1e-9)
        except Exception:       # noqa: BLE001 — arbitration must never
            return 1.0          # fail a transfer over a policy lookup

    def acquire(self, tenant=None, timeout=None):
        """Block until granted a transfer slot; False on timeout (the
        caller then proceeds unarbitrated rather than drop the handoff:
        ordering is an optimization, completion is not)."""
        with self._cond:
            vft = max(self._vt, self._tenant_vft.get(tenant, 0.0)) \
                + 1.0 / self._weight(tenant)
            self._seq += 1
            ticket = (vft, self._seq, tenant)
            self._waiting.append(ticket)
            self._waiting.sort(key=lambda t: t[:2])
            ok = self._cond.wait_for(
                lambda: self._active < self.max_concurrent
                and self._waiting[0] is ticket, timeout)
            self._waiting.remove(ticket)
            if not ok:
                self._cond.notify_all()   # unblock the next head
                return False
            self._active += 1
            self._vt = max(self._vt, vft)
            self._tenant_vft[tenant] = vft
            self.granted += 1
            if len(self._tenant_vft) > 4096:
                # bound the idle tenants' bookkeeping: anyone fully
                # behind the system virtual time restarts from it
                self._tenant_vft = {t: v for t, v
                                    in self._tenant_vft.items()
                                    if v > self._vt}
            self._cond.notify_all()
            return True

    def release(self):
        with self._cond:
            self._active -= 1
            self._cond.notify_all()

    class _Slot:
        __slots__ = ("_arb", "_held")

        def __init__(self, arb, tenant, timeout):
            self._arb = arb
            self._held = arb.acquire(tenant, timeout)

        def __enter__(self):
            return self._held

        def __exit__(self, *exc):
            if self._held:
                self._arb.release()
            return False

    def slot(self, tenant=None, timeout=30.0):
        """`with arbiter.slot(tenant):` yields whether a slot was held
        (False after the timeout: proceed anyway, unarbitrated)."""
        return HandoffArbiter._Slot(self, tenant, timeout)

    def snapshot(self):
        with self._lock:
            return {"active": self._active,
                    "waiting": len(self._waiting),
                    "granted": self.granted,
                    "max_concurrent": self.max_concurrent}
