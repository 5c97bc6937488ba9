"""Checkpoints in the JAX package's on-disk format, over torch tensors.

Counterpart of paddle_tpu/distributed/checkpoint.py. A checkpoint is a
directory: each process writes one `shards_{pid}.npz` holding its
tensors and one `table_{pid}.json` mapping each name to its global
shape, its dtype and its pieces [{offsets, sizes, file, key}], with the
shard file's sha256 and size under "__files__" and the table's own
digest under "__table_digest__"; the coordinator writes
`metadata.json` ({"process_count", "format_version": 4}) last, as the
completion marker. The same state dict saves to the same bytes in both
packages, and the port reads what either wrote (the JAX package's reader
cannot cast a bf16 entry, its own included: ROADMAP queue 3).

- Saving: `save_state_dict` flattens a nested dict ("a.b.c" names);
  each leaf is a torch tensor (any device), a numpy array or a scalar,
  saved whole as one piece. Tensors on the card are copied into one
  pinned host buffer, every copy enqueued before one wait per device
  (`checkpoint.snapshot.seconds`), so later in-place updates cannot
  reach the checkpoint; the shard file is hashed while it is written,
  then the table, then the marker, each atomically (tmp + rename,
  transient OSErrors retried).
- bf16 entries are 16-bit words: the table says "bfloat16", the npz
  member is numpy's '<V2' (what `np.save` writes for ml_dtypes'
  bfloat16), read back as int16 and viewed as torch.bfloat16. No
  ml_dtypes is needed.
- Loading: `load_state_dict` assembles each entry on the host from the
  saved pieces that overlap it (a checkpoint the JAX package wrote
  sharded over a mesh loads whole) and fills the target: a torch tensor
  of the saved dtype is filled in place on its device; any other target
  is replaced in the dict by a new tensor of the saved dtype, on the
  target's device for a tensor, on the CPU otherwise. Placement over a
  mesh is not ported.
- Integrity: `verify_checkpoint`, `quarantine_corrupt`,
  `newest_complete_checkpoint`, `load_newest_complete` and
  `register_migration` are the JAX module's.
- Processes: the process index and count are torch.distributed's when
  it is initialized, else 0 and 1. A multi-process save ends with
  `torch.distributed.barrier`. The asynchronous save is
  `async_checkpoint.AsyncCheckpointer` (the JAX module's older
  `async_save=True` flag is not ported).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import time
import zipfile
from contextlib import contextmanager

import numpy as np
import torch

from paddle_tpu_torch import observability
from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.distributed.retries import default_policy

__all__ = ["save_state_dict", "load_state_dict", "register_migration", "CheckpointCorruptionError",
           "verify_checkpoint", "quarantine_corrupt",
           "newest_complete_checkpoint", "load_newest_complete"]

_META = "metadata.json"
_QUARANTINE = ".quarantine"
_BF16 = "bfloat16"

# file-write retry budget (transient I/O errors on network filesystems)
_io_retry = default_policy(retryable=(OSError,))

# v1: unstamped; v2: format_version stamp; v3: per-file sha256 in each
# table's "__files__"; v4: each table's "__table_digest__"
_FORMAT_VERSION = 4


class CheckpointCorruptionError(RuntimeError):
    """A shard/table file failed its recorded checksum (or cannot be
    parsed). `bad_files` names them, relative to `path`."""

    def __init__(self, path, bad_files):
        self.path = path
        self.bad_files = dict(bad_files)
        super().__init__(
            f"checkpoint {path!r} corrupt: " + "; ".join(
                f"{f}: {why}" for f, why in self.bad_files.items()))


# {from_version: fn(merged_tables, info) -> merged_tables} applied in
# sequence on load until _FORMAT_VERSION is reached
_MIGRATIONS: dict = {}


def register_migration(from_version: int):
    """Register an upgrade hook for checkpoints written at
    `from_version`; it receives (merged_tables, metadata_info) and
    returns upgraded tables."""
    def deco(fn):
        _MIGRATIONS[int(from_version)] = fn
        return fn
    return deco


def _flatten_state(state_dict, prefix=""):
    flat = {}
    for k, v in state_dict.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_state(v, name + "."))
        else:
            flat[name] = v
    return flat


def _unflatten_into(state_dict, flat, prefix=""):
    for k, v in state_dict.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            _unflatten_into(v, flat, name + ".")
        elif name in flat:
            state_dict[k] = flat[name]


def _dist(group=None):
    """(process index, process count): torch.distributed's when it is
    initialized, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0):
    """Write this process's tensors and the global metadata; returns once
    the files (and, from the coordinator, the marker) are durable and
    every process has written."""
    payload, meta, pid = _snapshot_state(state_dict, process_group)
    try:
        _write_files(payload, meta, pid, path, coordinator_rank,
                     process_group=process_group)
    finally:
        # every process reaches the barrier, even when its write failed:
        # the raise reports it, and a missing table shows at load time
        _save_barrier(process_group)


def _dtype_name(v):
    """The table's dtype string: numpy's name ("bfloat16" for torch's
    and ml_dtypes' bf16)."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype)


def _to_host(v, staged=None):
    """A host numpy copy of one leaf (`staged`: its pinned copy, for a
    tensor on the card); bf16 as '<V2' 16-bit words. A CPU tensor is
    cloned, so an in-place update after the save returns cannot reach
    the checkpoint."""
    if isinstance(v, torch.Tensor):
        t = staged if staged is not None else v.detach().clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    a = np.asarray(v)
    if a.dtype.name == _BF16:
        return a.view(np.int16).view("V2")
    return a


def _stage_device_tensors(flat):
    """{name: pinned host copy} of every leaf on the card: one pinned
    buffer for all of them, every copy enqueued (non-blocking, on each
    tensor's device's current stream) before one wait per device."""
    cuda = [(n, v) for n, v in flat.items()
            if isinstance(v, torch.Tensor) and v.is_cuda]
    if not cuda:
        return {}
    offsets, total = [], 0
    for _, v in cuda:
        offsets.append(total)
        total += -(-(v.numel() * v.element_size()) // 64) * 64
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    staged, devices = {}, set()
    for (name, v), off in zip(cuda, offsets):
        nb = v.numel() * v.element_size()
        dst = buf[off:off + nb].view(v.dtype).view(v.shape)
        with torch.cuda.device(v.device):
            dst.copy_(v.detach(), non_blocking=True)
        staged[name] = dst
        devices.add(v.device)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return staged


def _snapshot_state(state_dict, process_group=None, pid=None):
    """Device->host copy of every leaf, the part of a save the training
    thread pays; afterwards the checkpoint's content is immune to
    in-place updates of the tensors. Returns (payload {key: numpy},
    meta {name: table entry}, process index: `pid`, else
    torch.distributed's). Shared by the sync save and AsyncCheckpointer;
    `checkpoint.snapshot.seconds` records the stall it costs."""
    t0 = time.monotonic()
    flat = _flatten_state(state_dict)
    pid = _dist(process_group)[0] if pid is None else int(pid)
    fname = f"shards_{pid}.npz"
    staged = _stage_device_tensors(flat)
    payload, meta = {}, {}
    for name, v in flat.items():
        host = _to_host(v, staged.get(name))
        key = f"{name}__0"
        payload[key] = host
        shape = list(host.shape)
        meta[name] = {"shape": shape, "dtype": _dtype_name(v),
                      "shards": [{"offsets": [0] * host.ndim,
                                  "sizes": shape, "file": fname,
                                  "key": key}]}
    if observability.ENABLED:
        observability.observe("checkpoint.snapshot.seconds",
                              time.monotonic() - t0)
    return payload, meta, pid


def _savez(f, payload):
    """np.savez's layout (one stored zip member `{key}.npy` a leaf),
    written to a stream; a bf16 member gets numpy's '<V2' header, as
    np.save writes an ml_dtypes bfloat16 array."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in payload.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if arr.dtype.kind == "V" and arr.dtype.names is None:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": arr.shape})
                    fid.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.lib.format.write_array(fid, np.asanyarray(arr))


# Digest memo, active only inside one resume operation (scan + load), so
# a restart hashes each file once; separate calls always re-hash.
_digest_memo: dict | None = None


@contextmanager
def _digest_memo_scope():
    global _digest_memo
    prev = _digest_memo
    if prev is None:
        _digest_memo = {}
    try:
        yield
    finally:
        _digest_memo = prev


def _sha256_file(path, chunk=1 << 20):
    key = os.path.abspath(path)
    if _digest_memo is not None and key in _digest_memo:
        return _digest_memo[key]
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    if _digest_memo is not None:
        _digest_memo[key] = h.hexdigest()
    return h.hexdigest()


class _HashingWriter:
    """Write-only file facade that streams every byte through sha256 on
    its way to the real file, so the save records a digest without
    re-reading what it wrote. Not seekable: zipfile then writes in pure
    append order (data descriptors), which np.load reads."""

    def __init__(self, f):
        self._f = f
        self._h = hashlib.sha256()

    def write(self, b):
        n = self._f.write(b)
        self._h.update(b)
        return n

    def flush(self):
        self._f.flush()

    def tell(self):             # zipfile probes; OSError -> streaming
        raise io.UnsupportedOperation("not seekable")

    def hexdigest(self):
        return self._h.hexdigest()


def _atomic_write(final, write_fn, hashed=False):
    """tmp-then-rename, so a death mid-write never leaves a half file
    under the final name; transient I/O errors retried per policy.
    `hashed=True` hands write_fn a _HashingWriter and returns the sha256
    of the written bytes."""
    tmp = final + ".tmp"
    out = {}

    def attempt():
        with open(tmp, "wb") as f:
            if hashed:
                w = _HashingWriter(f)
                write_fn(w)
                out["sha256"] = w.hexdigest()
            else:
                write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    try:
        _io_retry.run(attempt, desc=f"write {os.path.basename(final)}")
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return out.get("sha256")


def _table_digest(table: dict) -> str:
    """sha256 over the table's canonical JSON (sorted keys, no
    whitespace), without the digest record itself."""
    body = {k: v for k, v in table.items() if k != "__table_digest__"}
    blob = json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def _table_digest_issue(table: dict):
    """None when `table` matches its recorded self-digest (or predates
    v4 and has none), else a reason string."""
    rec = table.get("__table_digest__")
    if rec is None:
        return None
    if not isinstance(rec, dict) or not rec.get("sha256"):
        return "table digest record malformed"
    if _table_digest(table) != rec["sha256"]:
        return ("table digest mismatch (corrupted-but-parseable "
                "table)")
    return None


def _write_files(payload, meta, pid, path, coordinator_rank,
                 defer_marker=False, process_group=None):
    """Write this process's shards and table (+ the metadata.json
    completion marker, unless `defer_marker`: the async writer commits
    it only after every process's files landed)."""
    t0 = time.monotonic()
    os.makedirs(path, exist_ok=True)
    fname = f"shards_{pid}.npz"
    shards_path = os.path.join(path, fname)
    digest = _atomic_write(shards_path, lambda f: _savez(f, payload),
                           hashed=True)
    table = dict(meta)
    table["__files__"] = {fname: {"sha256": digest,
                                  "size": os.path.getsize(shards_path)}}
    # the table's own integrity record goes last: it covers every other
    # key, the shard checksums above included
    table["__table_digest__"] = {"sha256": _table_digest(table)}
    if chaos.ENABLED:
        # a torn or corrupted write AFTER the digest was taken: what the
        # checksum must catch
        chaos.maybe_corrupt_file("ckpt.write.shards", shards_path)
    _atomic_write(os.path.join(path, f"table_{pid}.json"),
                  lambda f: f.write(json.dumps(table, indent=1).encode()))
    if chaos.ENABLED:
        chaos.maybe_corrupt_file("ckpt.write.table",
                                 os.path.join(path, f"table_{pid}.json"))
    if pid == coordinator_rank and not defer_marker:
        _write_marker(path, _dist(process_group)[1])
    if observability.ENABLED:
        observability.inc("ckpt.saves")
        observability.observe("ckpt.save.seconds", time.monotonic() - t0)


def _write_marker(path, process_count):
    """metadata.json, the checkpoint's completion marker, written after
    every process's files exist."""
    _atomic_write(os.path.join(path, _META),
                  lambda f: f.write(json.dumps(
                      {"process_count": int(process_count),
                       "format_version": _FORMAT_VERSION},
                      indent=1).encode()))


def _save_barrier(process_group=None):
    """Block until every process finished writing: nothing in one
    process, `torch.distributed.barrier` across several."""
    if _dist(process_group)[1] > 1:
        torch.distributed.barrier(group=process_group)


def _merged_tables(path):
    """Union of every process's table, with completeness checking."""
    try:
        with open(os.path.join(path, _META)) as f:
            info = json.load(f)
    except FileNotFoundError:
        info = {}
    version = int(info.get("format_version", 1))   # unstamped = v1
    if version > _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has format_version {version}, newer "
            f"than this build's {_FORMAT_VERSION}; upgrade to load it")
    if "state_dict_metadata" in info:   # pre-table single-file format
        return _migrate(info["state_dict_metadata"], version, info)
    expect = info.get("process_count")
    if expect is not None:
        # read EXACTLY this save's tables: an earlier save by more
        # processes into the same directory leaves stale ones behind
        tables = [f"table_{p}.json" for p in range(expect)]
        missing = [fn for fn in tables
                   if not os.path.exists(os.path.join(path, fn))]
        if missing:
            raise ValueError(
                f"checkpoint {path!r} incomplete: missing {missing} "
                f"of {expect} process tables (a save did not finish?)")
    else:
        tables = sorted(
            fn for fn in os.listdir(path)
            if fn.startswith("table_") and fn.endswith(".json"))
        if tables:
            raise ValueError(
                f"checkpoint {path!r} has {len(tables)} table files but "
                f"no {_META} with process_count (coordinator crashed "
                "after tables were written, or the file was deleted); "
                "refusing to glob-merge possibly-stale tables. Restore "
                f"{_META} or delete stale table_*.json files.")
    if not tables:
        raise FileNotFoundError(f"no shard tables in checkpoint {path!r}")
    merged = {}
    for fn in tables:
        with open(os.path.join(path, fn)) as f:
            tbl = json.load(f)
        why = _table_digest_issue(tbl)
        if why is not None:
            raise CheckpointCorruptionError(path, {fn: why})
        for name, entry in tbl.items():
            if name.startswith("__"):   # reserved (file checksums etc.)
                continue
            if name not in merged:
                merged[name] = {"shape": entry["shape"],
                                "dtype": entry["dtype"], "shards": [],
                                "_seen": set()}
            tgt = merged[name]
            if list(entry["shape"]) != list(tgt["shape"]):
                raise ValueError(
                    f"{name}: process tables disagree on global shape "
                    f"({entry['shape']} vs {tgt['shape']})")
            for sh in entry["shards"]:
                box = tuple(sh["offsets"] + sh["sizes"])
                if box in tgt["_seen"]:   # replicated across processes
                    continue
                tgt["_seen"].add(box)
                tgt["shards"].append(sh)
    for entry in merged.values():
        entry.pop("_seen")
    return _migrate(merged, version, info)


def _migrate(merged, version, info):
    """Upgrade old formats through registered migration hooks."""
    for v in range(version, _FORMAT_VERSION):
        if v in _MIGRATIONS:
            merged = _MIGRATIONS[v](merged, info)
    return merged


# ---------------------------------------------------------------------------
# integrity: verification, quarantine, newest-complete fallback
# ---------------------------------------------------------------------------


def _recorded_checksums(path):
    """Union of every table's "__files__" record (v3+); empty for older
    checkpoints, whose loads then skip verification."""
    out = {}
    try:
        names = os.listdir(path)
    except OSError:
        return out
    for fn in names:
        if fn.startswith("table_") and fn.endswith(".json"):
            try:
                with open(os.path.join(path, fn)) as f:
                    tbl = json.load(f)
            except (OSError, ValueError):
                continue    # unparseable table reported by verify/merge
            if _table_digest_issue(tbl) is not None:
                continue    # corrupt table: its records can't be trusted
            out.update(tbl.get("__files__") or {})
    return out


def _check_file(path, fname, rec):
    """None if `fname` matches its record, else a reason string; the
    size first (a torn write), then the sha256."""
    fp = os.path.join(path, fname)
    if not os.path.exists(fp):
        return "missing"
    if rec is None:
        return None
    size = os.path.getsize(fp)
    if size != rec.get("size"):
        return (f"size {size} != recorded {rec.get('size')} "
                f"(torn write)")
    if _sha256_file(fp) != rec.get("sha256"):
        return "sha256 mismatch (corrupted)"
    return None


def verify_checkpoint(path):
    """Integrity-check a checkpoint directory WITHOUT loading tensors:
    metadata parse, the expected table set, table parses and digests,
    and every recorded per-file checksum. Returns {filename: reason};
    empty means complete and intact."""
    bad = {}
    try:
        with open(os.path.join(path, _META)) as f:
            info = json.load(f)
    except FileNotFoundError:
        info = None
    except (OSError, ValueError) as e:
        return {_META: f"unreadable: {e}"}
    version = int((info or {}).get("format_version", 1))
    if version > _FORMAT_VERSION:
        # intact for a newer build: the fallback skips it, and
        # quarantine_corrupt must not gut it
        return {_META: f"format_version {version} newer than supported "
                       f"{_FORMAT_VERSION} (skip, do not quarantine)"}
    expect = (info or {}).get("process_count")
    if expect is not None:
        tables = [f"table_{p}.json" for p in range(expect)]
    else:
        try:
            tables = sorted(
                fn for fn in os.listdir(path)
                if fn.startswith("table_") and fn.endswith(".json"))
        except OSError as e:
            return {path: f"unreadable directory: {e}"}
        if info is None and tables:
            bad[_META] = ("missing (cannot prove the table set is "
                          "complete)")
    if not tables:
        bad["table_*.json"] = "no shard tables"
        return bad
    for fn in tables:
        fp = os.path.join(path, fn)
        if not os.path.exists(fp):
            bad[fn] = "missing host table (a host's save did not finish)"
            continue
        try:
            with open(fp) as f:
                tbl = json.load(f)
        except (OSError, ValueError) as e:
            bad[fn] = f"unparseable (torn write?): {e}"
            continue
        why = _table_digest_issue(tbl)
        if why is not None:
            bad[fn] = why
            continue        # nothing in a corrupt table is trustable
        recs = tbl.get("__files__") or {}
        for fname, rec in recs.items():
            why = _check_file(path, fname, rec)
            if why is not None:
                bad[fname] = why
        # pre-v3 tables carry no checksums, but every referenced shard
        # file must still exist
        for name, entry in tbl.items():
            if name.startswith("__"):
                continue
            for sh in entry.get("shards", ()):
                fname = sh.get("file")
                if fname and fname not in recs and fname not in bad \
                        and not os.path.exists(os.path.join(path, fname)):
                    bad[fname] = "missing shard file"
    return bad


def quarantine_corrupt(path, bad_files=None):
    """Move corrupt/torn files into `path`/.quarantine/: the directory
    can never half-load, and the evidence survives. Returns the names
    moved."""
    bad = bad_files if bad_files is not None else verify_checkpoint(path)
    qdir = os.path.join(path, _QUARANTINE)
    moved = []
    for fn, why in bad.items():
        if "do not quarantine" in str(why):
            continue    # e.g. a newer-format checkpoint: intact, skip
        src = os.path.join(path, fn)
        if not os.path.isfile(src):
            continue
        os.makedirs(qdir, exist_ok=True)
        os.replace(src, os.path.join(qdir, fn))
        moved.append(fn)
    if moved and observability.ENABLED:
        observability.inc("ckpt.quarantined_files", len(moved))
    return moved


def _candidate_dirs(root):
    """Checkpoint subdirectories of `root`, NEWEST FIRST: `step_{n}` by
    step number, anything else by mtime. Directories holding a
    .quarantine are left out, and one vanishing mid-scan is skipped."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for n in names:
        d = os.path.join(root, n)
        try:
            if not os.path.isdir(d) or n == _QUARANTINE:
                continue
            if os.path.isdir(os.path.join(d, _QUARANTINE)):
                continue
            if not (os.path.exists(os.path.join(d, _META))
                    or any(fn.startswith("table_")
                           for fn in os.listdir(d))):
                continue
            mtime = os.path.getmtime(d)
        except OSError:
            continue    # removed between listdir and stat
        if n.startswith("step_"):
            try:
                key = (1, int(n[5:]))
            except ValueError:
                key = (0, mtime)
        else:
            key = (0, mtime)
        out.append((key, d))
    return [d for _, d in sorted(out, reverse=True)]


def newest_complete_checkpoint(root, quarantine=True):
    """Newest subdirectory of `root` that verifies complete and intact;
    corrupt newer candidates are quarantined and skipped. Returns the
    path, or None."""
    for d in _candidate_dirs(root):
        issues = verify_checkpoint(d)
        if not issues:
            return d
        if observability.ENABLED:
            observability.inc("ckpt.fallbacks")
        if quarantine:
            quarantine_corrupt(d, issues)
    return None


def load_newest_complete(state_dict, root, **kw):
    """load_state_dict from the newest complete checkpoint under `root`,
    falling back past corrupt ones. Returns the directory loaded, or
    None when no complete checkpoint exists."""
    failed: dict = {}
    while True:
        with _digest_memo_scope():      # verify + load hash each file once
            d = newest_complete_checkpoint(root)
            if d is None:
                return None
            try:
                load_state_dict(state_dict, d, **kw)
                return d
            except CheckpointCorruptionError as e:
                # verified, yet the load tripped (a file replaced between
                # scan and read): quarantine and retry, unless nothing
                # moved since the last pass
                if failed.get(d) == e.bad_files:
                    raise
                failed[d] = e.bad_files
                quarantine_corrupt(d, e.bad_files)


def _overlap(t_offs, t_sizes, s_offs, s_sizes):
    """Intersection box of target and saved piece; None if empty."""
    lo, hi = [], []
    for to, ts, so, ss in zip(t_offs, t_sizes, s_offs, s_sizes):
        l = max(to, so)
        h = min(to + ts, so + ss)
        if h <= l:
            return None
        lo.append(l)
        hi.append(h)
    return lo, hi


def _words(src, dtype_name):
    """A saved piece as the buffer's type: bf16 pieces (np.load gives
    |V2, or ml_dtypes' bfloat16) as int16 words."""
    return src.view(np.int16) if dtype_name == _BF16 else src


def _assemble(name, entry, read):
    """The whole saved tensor `name` as a numpy array (bf16 as int16
    words), from the saved pieces that overlap it; every element must be
    covered."""
    shape = [int(d) for d in entry["shape"]]
    dtype = np.dtype(np.int16) if entry["dtype"] == _BF16 \
        else np.dtype(entry["dtype"])
    pieces = entry["shards"]
    if (len(pieces) == 1 and not any(pieces[0]["offsets"])
            and list(pieces[0]["sizes"]) == shape):
        src = _words(read(pieces[0]), entry["dtype"])
        if src.dtype == dtype and list(src.shape) == shape:
            return src          # one piece holds the whole tensor
    buf = np.zeros(shape, dtype)
    covered = np.zeros(shape, bool) if int(np.prod(shape)) else None
    for sh in pieces:
        ov = _overlap([0] * len(shape), shape, sh["offsets"], sh["sizes"])
        if ov is None:
            continue
        lo, hi = ov
        src = _words(read(sh), entry["dtype"])
        src_sl = tuple(slice(l - o, h - o) for l, h, o in
                       zip(lo, hi, sh["offsets"]))
        dst_sl = tuple(slice(l, h) for l, h in zip(lo, hi))
        buf[dst_sl] = src[src_sl]
        if covered is not None:
            covered[dst_sl] = True
    if covered is not None and not covered.all():
        missing = int(covered.size - covered.sum())
        raise ValueError(
            f"{name}: checkpoint does not cover {missing} elements of "
            f"shape {shape}: incomplete shard set (lost host file?)")
    return buf


def load_state_dict(state_dict, path):
    """Fill `state_dict`'s leaves from a checkpoint: each entry is
    assembled whole on the host; a torch tensor target of the saved
    dtype is filled in place on its device, and any other target is
    replaced by a new tensor of the saved dtype (on the target tensor's
    device, else the CPU). Returns `state_dict`."""
    t0 = time.monotonic()
    meta = _merged_tables(path)
    checksums = _recorded_checksums(path)
    files = {}

    def read(piece):
        """One saved piece, its file verified against its recorded
        checksum first (a corrupt file raises CheckpointCorruptionError,
        never a parse crash or silently wrong weights)."""
        fname = piece["file"]
        if fname not in files:
            why = _check_file(path, fname, checksums.get(fname))
            if why is not None:
                raise CheckpointCorruptionError(path, {fname: why})
            try:
                files[fname] = np.load(os.path.join(path, fname))
            except (OSError, ValueError, zipfile.BadZipFile) as e:
                raise CheckpointCorruptionError(
                    path, {fname: f"unreadable npz: {e}"}) from e
        return files[fname][piece["key"]]

    flat = _flatten_state(state_dict)
    out = {}
    try:
        for name, target in flat.items():
            if name not in meta:
                raise KeyError(f"checkpoint has no tensor {name!r}")
            entry = meta[name]
            gshape = tuple(int(d) for d in entry["shape"])
            t_shape = tuple(target.shape) if hasattr(target, "shape") \
                else gshape
            if t_shape != gshape:
                raise ValueError(
                    f"{name}: target shape {t_shape} != saved {gshape}")
            t = torch.from_numpy(_assemble(name, entry, read))
            if entry["dtype"] == _BF16:
                t = t.view(torch.bfloat16)
            if isinstance(target, torch.Tensor) and target.dtype == t.dtype:
                with torch.no_grad():
                    target.copy_(t)
                out[name] = target
            elif isinstance(target, torch.Tensor):
                out[name] = t.to(target.device)
            else:
                out[name] = t
    finally:
        for f in files.values():
            f.close()
    _unflatten_into(state_dict, out)
    if observability.ENABLED:
        observability.inc("ckpt.loads")
        observability.observe("ckpt.load.seconds", time.monotonic() - t0)
    return state_dict
