"""The port's checkpoints (distributed/checkpoint.py, async_checkpoint.py)
against the JAX package's, on the CPU.

- A nested state dict (f32, int32, bf16 and 0-d entries) saved by either
  package gives the same files, byte for byte, and loads bit-equal in
  both. The JAX package cannot load a bf16 entry at all (np.load gives
  the '<V2' member as |V2, which numpy will not cast into ml_dtypes'
  bfloat16: ROADMAP queue 3); its loads here go through `_NpBf16`, a
  numpy whose `load` views those members as bfloat16, and the condition
  itself is pinned.
- A checkpoint the JAX package saved sharded over its virtual CPU mesh
  (tests/test_dist_checkpoint.py:35) loads in the port as whole tensors.
- Both packages' `verify_checkpoint`, `quarantine_corrupt`, the load and
  the newest-complete fallback give the same verdicts on the same
  damaged directory: a bit flip, a truncation, a torn table, a
  parseable-but-corrupt table, tampered recorded digests, a newer
  format, an old unstamped format and a pre-v3 table with a lost shard
  (tests/test_chaos_resilience.py:217-307,587,
  tests/test_dist_checkpoint.py:278-394).
- AsyncCheckpointer: the cases of tests/test_async_checkpoint.py that
  need no elastic module (:91-132, :218-260, :288-407, :493-512), and
  two ranks in one process committing through a torch TCPStore barrier.
"""
import datetime
import json
import os
import shutil
import threading
import time
import types

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import paddle_tpu
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.distributed import chaos as t_chaos
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed.async_checkpoint import AsyncCheckpointer

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

FILES = ("shards_0.npz", "table_0.json", "metadata.json")


def _state():
    """{name: numpy} with every kind of entry, nested."""
    rng = np.random.RandomState(0)
    return {"model": {"w": rng.randn(6, 5).astype(np.float32),
                      "b16": rng.randn(3, 4).astype(ml_dtypes.bfloat16),
                      "ids": rng.randint(-9, 9, (7,)).astype(np.int32)},
            "opt": {"lr": np.float32(0.25), "step": np.int32(7),
                    "pow": np.array(0.5, np.float32)}}


def _flat(sd, prefix=""):
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _nest(flat, fn):
    out = {}
    for name, v in flat.items():
        *parents, leaf = name.split(".")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = fn(v)
    return out


def _torch_of(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _numpy_of(t):
    if isinstance(t, paddle_tpu.Tensor):
        return np.asarray(t._value)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


class _NpBf16:
    """numpy for the JAX checkpoint module, whose `load` views '<V2'
    members as ml_dtypes' bfloat16 (the cast the module lacks)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def load(path):
        z = np.load(path)
        try:
            return {k: (z[k].view(ml_dtypes.bfloat16)
                        if z[k].dtype.kind == "V" else z[k])
                    for k in z.files}
        finally:
            z.close()


def _save(pkg, flat, path):
    if pkg == "jax":
        jckpt.save_state_dict(_nest(flat, paddle_tpu.to_tensor), path)
    else:
        tckpt.save_state_dict(_nest(flat, _torch_of), path)


def _load(pkg, flat, path, monkeypatch):
    """Every entry of `path` as numpy, through package `pkg`'s loader
    into zero targets of the saved dtypes."""
    if pkg == "jax":
        monkeypatch.setattr(jckpt, "np", _NpBf16())
        sd = _nest(flat, lambda a: paddle_tpu.to_tensor(np.zeros_like(a)))
        jckpt.load_state_dict(sd, path)
        monkeypatch.undo()
    else:
        sd = _nest(flat, lambda a: torch.zeros_like(_torch_of(a)))
        targets = _flat(sd)
        tckpt.load_state_dict(sd, path)
        # a target of the saved dtype is filled in place
        assert all(v is targets[k] for k, v in _flat(sd).items())
    return {k: _numpy_of(v) for k, v in _flat(sd).items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_dict_round_trips_across_packages(writer, tmp_path,
                                                monkeypatch):
    flat = _flat(_state())
    _save(writer, flat, str(tmp_path / writer))
    other = "port" if writer == "jax" else "jax"
    _save(other, flat, str(tmp_path / other))
    for fn in FILES:        # the same bytes, whichever package wrote them
        assert (tmp_path / "jax" / fn).read_bytes() == \
            (tmp_path / "port" / fn).read_bytes(), fn
    for reader in ("jax", "port"):
        got = _load(reader, flat, str(tmp_path / writer), monkeypatch)
        for name, want in flat.items():
            want = np.asarray(want)
            assert got[name].dtype == want.dtype, name
            assert got[name].shape == want.shape, name
            assert got[name].tobytes() == want.tobytes(), (reader, name)
    # the known condition of the JAX package, without the view
    sd = {"model": {"b16": paddle_tpu.to_tensor(
        np.zeros((3, 4), ml_dtypes.bfloat16))}}
    with pytest.raises(ValueError, match="cast"):
        jckpt.load_state_dict(sd, str(tmp_path / writer))


def test_port_loads_into_the_targets_device_and_other_dtypes(tmp_path):
    """A non-tensor target and a tensor of another dtype are replaced by
    new tensors of the saved dtype; a bf16 tensor round-trips bit for
    bit."""
    w = torch.randn(4, 3).to(torch.bfloat16)
    tckpt.save_state_dict({"w": w, "n": torch.tensor(2.5)}, str(tmp_path))
    sd = {"w": torch.zeros(4, 3), "n": np.zeros((), np.float32)}
    tckpt.load_state_dict(sd, str(tmp_path))
    assert sd["w"].dtype == torch.bfloat16 and torch.equal(
        sd["w"].view(torch.int16), w.view(torch.int16))
    assert isinstance(sd["n"], torch.Tensor) and float(sd["n"]) == 2.5
    with pytest.raises(ValueError, match="target shape"):
        tckpt.load_state_dict({"w": torch.zeros(3, 4, dtype=torch.bfloat16)},
                              str(tmp_path))
    with pytest.raises(KeyError):
        tckpt.load_state_dict({"x": torch.zeros(1)}, str(tmp_path))


def _mesh2d():
    return jdist.ProcessMesh(np.arange(8).reshape(4, 2).tolist(),
                             dim_names=["dp", "mp"])


def test_jax_sharded_checkpoint_loads_whole(tmp_path):
    """Saved by the JAX package sharded over a 4 x 2 CPU mesh (rows over
    dp, rows and columns over dp x mp, replicated), loaded by the port
    as whole tensors."""
    mesh = _mesh2d()
    rng = np.random.RandomState(1)
    w = rng.randn(8, 4).astype(np.float32)
    v = rng.randn(8, 6).astype(np.float32)
    ids = rng.randint(0, 100, (8, 2)).astype(np.int32)
    jckpt.save_state_dict({
        "w": jdist.shard_tensor(w, mesh, [jdist.Shard(0), jdist.Replicate()]),
        "opt": {"v": jdist.shard_tensor(v, mesh,
                                        [jdist.Shard(0), jdist.Shard(1)]),
                "ids": jdist.shard_tensor(ids, mesh, [jdist.Replicate(),
                                                      jdist.Replicate()])}},
        str(tmp_path))
    tbl = json.loads((tmp_path / "table_0.json").read_text())
    assert len(tbl["opt.v"]["shards"]) == 8
    sd = {"w": torch.zeros(8, 4), "opt": {"v": torch.zeros(8, 6),
                                          "ids": torch.zeros(8, 2,
                                                             dtype=torch.int32)}}
    tckpt.load_state_dict(sd, str(tmp_path))
    assert np.array_equal(sd["w"].numpy(), w)
    assert np.array_equal(sd["opt"]["v"].numpy(), v)
    assert np.array_equal(sd["opt"]["ids"].numpy(), ids)


# -- integrity: the same verdicts in both packages --------------------------

def _bitflip(d):
    p = d / "shards_0.npz"
    data = p.read_bytes()
    p.write_bytes(data[:50] + bytes([data[50] ^ 0xFF]) + data[51:])


def _truncate(d):
    p = d / "shards_0.npz"
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])


def _torn_table(d):
    p = d / "table_0.json"
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])


def _lying_table(d):
    tbl = json.loads((d / "table_0.json").read_text())
    tbl["w"]["dtype"] = "float64"          # parses fine, lies
    (d / "table_0.json").write_text(json.dumps(tbl))


def _tampered_digest(d):
    tbl = json.loads((d / "table_0.json").read_text())
    tbl["__files__"]["shards_0.npz"]["sha256"] = "0" * 64
    (d / "table_0.json").write_text(json.dumps(tbl))


def _newer(d):
    meta = json.loads((d / "metadata.json").read_text())
    meta["format_version"] = tckpt._FORMAT_VERSION + 1
    (d / "metadata.json").write_text(json.dumps(meta))


def _unstamped(d):
    meta = json.loads((d / "metadata.json").read_text())
    del meta["format_version"]
    (d / "metadata.json").write_text(json.dumps(meta))


def _pre_v3_lost_shard(d):
    tbl = json.loads((d / "table_0.json").read_text())
    tbl.pop("__files__")
    tbl.pop("__table_digest__")
    (d / "table_0.json").write_text(json.dumps(tbl))
    os.remove(d / "shards_0.npz")


DAMAGE = {"bitflip": _bitflip, "truncation": _truncate,
          "torn_table": _torn_table, "lying_table": _lying_table,
          "tampered_digest": _tampered_digest, "newer_format": _newer,
          "unstamped": _unstamped, "pre_v3_lost_shard": _pre_v3_lost_shard}

PKGS = {"jax": types.SimpleNamespace(ckpt=jckpt, zeros=lambda: {
            "w": paddle_tpu.to_tensor(np.zeros((3, 4), np.float32))}),
        "port": types.SimpleNamespace(ckpt=tckpt, zeros=lambda: {
            "w": torch.zeros(3, 4)})}


def _verdicts(pkg, root):
    """verify, the load's outcome, the newest-complete fallback and
    what quarantine moved, for the damaged step_2 under `root`."""
    P = PKGS[pkg]
    d = str(root / "step_00000002")
    issues = P.ckpt.verify_checkpoint(d)
    try:
        P.ckpt.load_state_dict(P.zeros(), d)
        outcome = "loaded"
    except Exception as e:              # noqa: BLE001 — the verdict
        outcome = type(e).__name__
    sd = P.zeros()
    loaded = P.ckpt.load_newest_complete(sd, str(root))
    w = np.asarray(sd["w"]._value if pkg == "jax" else sd["w"])
    q = root / "step_00000002" / ".quarantine"
    moved = sorted(os.listdir(q)) if q.exists() else []
    return issues, outcome, os.path.basename(loaded), float(w[0, 0]), moved


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_corruption_verdicts_match_jax(damage, tmp_path):
    for pkg in PKGS:
        root = tmp_path / pkg
        for step, value in ((1, 1.0), (2, 2.0)):
            tckpt.save_state_dict({"w": torch.full((3, 4), value)},
                                  str(root / f"step_{step:08d}"))
        DAMAGE[damage](root / "step_00000002")
    jv = _verdicts("jax", tmp_path / "jax")
    tv = _verdicts("port", tmp_path / "port")
    assert tv == jv
    issues, outcome, loaded, w, moved = tv
    intact = damage == "unstamped"
    assert (issues == {}) == intact
    assert loaded == ("step_00000002" if intact else "step_00000001")
    assert w == (2.0 if intact else 1.0)


def test_torn_shard_write_quarantined_and_fallback(tmp_path):
    """ckpt.write.shards tears the newest save: quarantined, and the load
    falls back to the previous complete checkpoint."""
    root = str(tmp_path)
    for step, value in ((10, 1.0), (20, 2.0)):
        tckpt.save_state_dict({"w": torch.full((3, 4), value)},
                              os.path.join(root, f"step_{step:08d}"))
    with t_chaos.scoped(seed=3, rates={"ckpt.write.shards": (1.0, 1)}):
        tckpt.save_state_dict({"w": torch.full((3, 4), 3.0)},
                              os.path.join(root, "step_00000030"))
    assert tckpt.verify_checkpoint(os.path.join(root, "step_00000030"))
    sd = {"w": torch.zeros(3, 4)}
    with t_obs.scoped() as reg:
        loaded = tckpt.load_newest_complete(sd, root)
        assert reg.counter("ckpt.fallbacks").value() == 1
        assert reg.counter("ckpt.quarantined_files").value() == 1
    assert loaded == os.path.join(root, "step_00000020")
    assert torch.equal(sd["w"], torch.full((3, 4), 2.0))
    assert os.path.exists(os.path.join(root, "step_00000030", ".quarantine",
                                       "shards_0.npz"))


def test_migration_hook_applies(tmp_path):
    tckpt.save_state_dict({"old_name": torch.arange(4.)}, str(tmp_path))
    meta = json.loads((tmp_path / "metadata.json").read_text())
    del meta["format_version"]              # pretend v1
    (tmp_path / "metadata.json").write_text(json.dumps(meta))

    @tckpt.register_migration(1)
    def rename(tables, info):
        return {("new_name" if k == "old_name" else k): v
                for k, v in tables.items()}

    try:
        sd = {"new_name": torch.zeros(4)}
        tckpt.load_state_dict(sd, str(tmp_path))
        assert torch.equal(sd["new_name"], torch.arange(4.))
    finally:
        tckpt._MIGRATIONS.pop(1, None)


# -- AsyncCheckpointer ------------------------------------------------------

def _w(value, shape=(3, 4)):
    return {"w": torch.full(shape, float(value))}


def _load_w(path, shape=(3, 4)):
    sd = {"w": torch.zeros(shape)}
    tckpt.load_state_dict(sd, path)
    return sd["w"]


@pytest.fixture
def gated_writer(monkeypatch):
    """Hold the background writer at the door until `gate.set()`."""
    gate = threading.Event()
    order = []
    orig = tckpt._write_files

    def slow_write(payload, meta, pid, path, *a, **k):
        assert gate.wait(30), "test gate never opened"
        order.append(os.path.basename(path))
        return orig(payload, meta, pid, path, *a, **k)

    monkeypatch.setattr(tckpt, "_write_files", slow_write)
    return gate, order


def test_async_written_checkpoint_identical_to_sync(tmp_path):
    w = torch.arange(12.).reshape(3, 4)
    tckpt.save_state_dict({"w": w}, str(tmp_path / "sync"))
    with AsyncCheckpointer() as cp:
        cp.save({"w": w}, str(tmp_path / "async"))
        cp.flush()
    for fn in FILES:
        assert (tmp_path / "sync" / fn).read_bytes() == \
            (tmp_path / "async" / fn).read_bytes(), fn
    assert tckpt.verify_checkpoint(str(tmp_path / "async")) == {}
    assert torch.equal(_load_w(str(tmp_path / "async")), w)
    meta = json.loads((tmp_path / "async" / "metadata.json").read_text())
    assert meta == {"process_count": 1,
                    "format_version": tckpt._FORMAT_VERSION}


def test_snapshot_taken_at_save_time_not_write_time(tmp_path, gated_writer):
    """An in-place update after save() returns cannot leak into the
    checkpoint: the host copy was taken inside save()."""
    gate, _ = gated_writer
    t = torch.ones(3, 4)
    with AsyncCheckpointer() as cp:
        cp.save({"w": t}, str(tmp_path / "c"))
        t.add_(99.0)                    # the "training step", in place
        assert cp.pending == 1
        gate.set()
        cp.flush()
    assert torch.equal(_load_w(str(tmp_path / "c")), torch.ones(3, 4))


def test_marker_commits_last(tmp_path, gated_writer):
    gate, _ = gated_writer
    with AsyncCheckpointer() as cp:
        cp.save(_w(1), str(tmp_path / "c"))
        assert not os.path.exists(tmp_path / "c" / "metadata.json")
        gate.set()
        cp.flush()
    assert os.path.exists(tmp_path / "c" / "metadata.json")


def test_writer_failure_reraises_original_object(tmp_path, monkeypatch):
    boom = OSError("disk full")

    def explode(*a, **k):
        raise boom

    monkeypatch.setattr(tckpt, "_write_files", explode)
    cp = AsyncCheckpointer()
    try:
        cp.save(_w(1), str(tmp_path / "a"))
        with pytest.raises(OSError) as ei:
            cp.flush()
        assert ei.value is boom
        monkeypatch.undo()              # drained: the checkpointer works on
        cp.save(_w(1), str(tmp_path / "b"))
        cp.flush()
        assert tckpt.verify_checkpoint(str(tmp_path / "b")) == {}
    finally:
        cp.close()


def test_wait_policy_next_save_surfaces_failure_first(tmp_path,
                                                      monkeypatch):
    boom = RuntimeError("writer died")
    monkeypatch.setattr(tckpt, "_write_files",
                        lambda *a, **k: (_ for _ in ()).throw(boom))
    cp = AsyncCheckpointer()
    try:
        cp.save(_w(1), str(tmp_path / "a"))
        with pytest.raises(RuntimeError) as ei:
            cp.save(_w(1), str(tmp_path / "b"))
        assert ei.value is boom
    finally:
        cp.close()


def test_chaos_killed_writer_leaves_no_marker_and_fallback_skips(tmp_path):
    root = str(tmp_path)
    with AsyncCheckpointer() as cp:
        cp.save(_w(1), os.path.join(root, "step_00000010"))
        cp.flush()
        with t_chaos.scoped(seed=0, rates={"ckpt.async.fail": (1.0, 1)}):
            cp.save(_w(2), os.path.join(root, "step_00000020"))
            with pytest.raises(t_chaos.InjectedFault):
                cp.flush()
    torn = os.path.join(root, "step_00000020")
    assert os.path.exists(os.path.join(torn, "table_0.json"))
    assert not os.path.exists(os.path.join(torn, "metadata.json"))
    sd = _w(0)
    assert tckpt.load_newest_complete(sd, root) == \
        os.path.join(root, "step_00000010")
    assert torch.equal(sd["w"], torch.ones(3, 4))


def test_wait_policy_serializes_saves(tmp_path, gated_writer):
    gate, order = gated_writer
    cp = AsyncCheckpointer()
    try:
        cp.save(_w(1), str(tmp_path / "a"))
        entered, done = threading.Event(), threading.Event()

        def second():
            entered.set()
            cp.save(_w(2), str(tmp_path / "b"))
            done.set()

        th = threading.Thread(target=second, daemon=True)
        th.start()
        assert entered.wait(5)
        assert not done.wait(0.3)       # stuck draining the gated first
        gate.set()
        assert done.wait(10)
        cp.flush()
        th.join(5)
        assert not th.is_alive()
    finally:
        cp.close()
    assert order == ["a", "b"]
    assert torch.equal(_load_w(str(tmp_path / "a")), torch.ones(3, 4))
    assert torch.equal(_load_w(str(tmp_path / "b")), torch.full((3, 4), 2.))


def test_supersede_policy_replaces_queued_save(tmp_path, gated_writer):
    gate, order = gated_writer
    cp = AsyncCheckpointer(policy="supersede")
    try:
        cp.save(_w(1), str(tmp_path / "a"))
        deadline = time.time() + 5
        while cp._inflight is None and time.time() < deadline:
            time.sleep(0.005)
        assert cp._inflight is not None
        cp.save(_w(2), str(tmp_path / "b"))
        cp.save(_w(3), str(tmp_path / "c"))
        assert cp.pending == 2          # in-flight a + queued c (b gone)
        gate.set()
        cp.flush()
    finally:
        cp.close()
    assert order == ["a", "c"]
    assert not os.path.exists(tmp_path / "b")
    assert torch.equal(_load_w(str(tmp_path / "a")), torch.ones(3, 4))
    assert torch.equal(_load_w(str(tmp_path / "c")), torch.full((3, 4), 3.))


def test_on_complete_dropped_when_save_failed(tmp_path, monkeypatch):
    monkeypatch.setattr(
        tckpt, "_write_files",
        lambda *a, **k: (_ for _ in ()).throw(OSError("writer dead")))
    cp = AsyncCheckpointer()
    try:
        cp.save(_w(1), str(tmp_path / "a"))
        deadline = time.time() + 5
        while cp.pending and time.time() < deadline:
            time.sleep(0.005)
        ran = []
        cp.on_complete(lambda: ran.append(1))
        assert ran == []
        with pytest.raises(OSError):
            cp.flush()
    finally:
        cp.close(flush=False)


def test_callback_exception_keeps_committed_save_good(tmp_path):
    ran = []

    def bad():
        raise RuntimeError("callback boom")

    with AsyncCheckpointer() as cp:
        cp.save(_w(1), str(tmp_path / "a"), on_complete=bad)
        cp.on_complete(lambda: ran.append(1))
        cp.flush()
    assert ran == [1]
    assert tckpt.verify_checkpoint(str(tmp_path / "a")) == {}


def test_multiprocess_refusals():
    with pytest.raises(ValueError, match="single-process"):
        AsyncCheckpointer(policy="supersede", world_size=2)
    with pytest.raises(ValueError, match="store="):
        AsyncCheckpointer(world_size=2)


def test_save_after_close_raises(tmp_path):
    cp = AsyncCheckpointer()
    cp.save(_w(1), str(tmp_path / "a"))
    cp.close()
    assert cp._thread is not None and not cp._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        cp.save(_w(1), str(tmp_path / "b"))


def test_save_path_never_rereads_shards_for_hash(tmp_path, monkeypatch):
    calls = []
    orig = tckpt._sha256_file

    def spy(path, *a, **k):
        calls.append(os.path.basename(path))
        return orig(path, *a, **k)

    monkeypatch.setattr(tckpt, "_sha256_file", spy)
    w = torch.arange(24.).reshape(4, 6)
    tckpt.save_state_dict({"w": w}, str(tmp_path / "c"))
    assert calls == []
    monkeypatch.undo()
    tbl = json.loads((tmp_path / "c" / "table_0.json").read_text())
    rec = tbl["__files__"]["shards_0.npz"]
    shards = str(tmp_path / "c" / "shards_0.npz")
    assert rec["sha256"] == tckpt._sha256_file(shards)
    assert rec["size"] == os.path.getsize(shards)
    assert tckpt.verify_checkpoint(str(tmp_path / "c")) == {}
    assert torch.equal(_load_w(str(tmp_path / "c"), shape=(4, 6)), w)


def test_two_ranks_commit_through_a_store_barrier(tmp_path):
    """Two checkpointers (ranks 0 and 1 of 2) in one process over one
    TCPStore: each writes its own shard file, the marker says 2
    processes, and it lands only after both ranks' files."""
    store = tdist.TCPStore("127.0.0.1", 0, 2, True, wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=10))
    path = str(tmp_path / "c")
    cps = [AsyncCheckpointer(store=store, rank=r, world_size=2,
                             barrier_timeout=10.0) for r in (0, 1)]
    try:
        cps[0].save(_w(1), path)
        time.sleep(0.2)                 # rank 0 waits at the barrier
        assert not os.path.exists(os.path.join(path, "metadata.json"))
        cps[1].save(_w(1), path)
        for cp in cps:
            cp.flush(timeout=20)
    finally:
        for cp in cps:
            cp.close()
    assert sorted(os.listdir(path)) == ["metadata.json", "shards_0.npz",
                                        "shards_1.npz", "table_0.json",
                                        "table_1.json"]
    assert json.loads(open(os.path.join(path, "metadata.json")).read())[
        "process_count"] == 2
    assert tckpt.verify_checkpoint(path) == {}
    assert torch.equal(_load_w(path), torch.ones(3, 4))
    shutil.rmtree(path)
