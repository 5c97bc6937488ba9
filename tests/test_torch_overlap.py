"""The FSDP overlap rings (paddle_tpu_torch/parallel/overlap.py) across
processes, against the JAX package's paddle_tpu/parallel/overlap.py on the
CPU.

The job: the port's launcher starts paddle_tpu_torch/distributed/launch/
ring_smoke.py `--job overlap` as eight gloo workers in a module-scoped
fixture, while this process computes the JAX references on its eight
virtual CPU devices: the JAX ops on the meshes {dp 2, fsdp 2, mp 2} and
{dp 2, fsdp 4} (tests/test_overlap.py's data and shardings), the JAX
Trainer with overlap_fsdp=True and overlap_chunks=2 on both
(test_overlap.py's `_train_losses` setup: the tiny Llama at 2 layers,
seed 0, AdamW 1e-3, f32), and jax.value_and_grad of step 1's loss.

Each rank's share of an op's output is held against the same slice of
the JAX op's global output, within 1e-5 of the JAX output's largest
entry; the Trainer's losses within 1e-5 relative and step 1's gathered
gradients within 1e-5 of each tensor's largest entry (the rules of
tests/test_torch_fsdp.py). Overlap on and off on fsdp x mp are held to
the same rules against each other.
"""
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed.mesh import init_mesh as j_init_mesh
from paddle_tpu.jit.functional import functional_call, state_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu.parallel import TrainStepConfig as JStepConfig
from paddle_tpu.parallel import llama_sharding_plan as j_plan
from paddle_tpu.parallel import overlap as jov
from paddle_tpu_torch.distributed.launch import ring_smoke as rs
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.parallel import overlap as tov

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "paddle_tpu_torch", "distributed", "launch",
                      "ring_smoke.py")
JOB_TIMEOUT_S = 300
TOL = 1e-5
WORLD = 8


def _mesh3():
    return Mesh(np.array(jax.devices()).reshape(2, 2, 2),
                ("dp", "fsdp", "mp"))


def _mesh2():
    return Mesh(np.array(jax.devices()).reshape(2, 4), ("dp", "fsdp"))


def _jmodel(layers):
    paddle_tpu.seed(0)
    return jllama.LlamaForCausalLM(
        jllama.tiny_llama_config(num_hidden_layers=layers))


def _jax_ops():
    """{key: the JAX op's global output} for every case the worker runs."""
    x, w, g = (jnp.asarray(a) for a in rs.op_data(**rs.OP_SHAPE))
    out = {}
    mesh = _mesh3()
    for sd in (0, 1):
        xs = jax.device_put(x, NamedSharding(mesh, P(
            ("dp", "fsdp"), None, "mp" if sd == 1 else None)))
        ws = jax.device_put(w, NamedSharding(
            mesh, P("fsdp", "mp") if sd == 0 else P("mp", "fsdp")))
        gs = jax.device_put(g, NamedSharding(mesh, P(
            ("dp", "fsdp"), None, "mp" if sd == 0 else None)))
        with mesh:
            for c in (1, 2, 3):
                out[f"ag/sd{sd}/c{c}"] = np.asarray(jax.jit(
                    lambda a, b, c=c, sd=sd: jov.overlap_all_gather_matmul(
                        a, b, chunks=c, mesh=mesh, shard_dim=sd))(xs, ws))
            for c in (1, 3):
                out[f"rs/sd{sd}/c{c}"] = np.asarray(jax.jit(
                    lambda a, b, c=c, sd=sd:
                    jov.overlap_matmul_reduce_scatter(
                        a, b, chunks=c, mesh=mesh, shard_dim=sd))(xs, gs))
    xs = jax.device_put(x, NamedSharding(mesh, P(("dp", "fsdp"), None,
                                                 None)))
    ws = jax.device_put(w, NamedSharding(mesh, P("fsdp", "mp")))
    with mesh:
        gx, gw = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.sin(
            jov.overlap_all_gather_matmul(a, b, chunks=2, mesh=mesh))),
            argnums=(0, 1)))(xs, ws)
    out["grad/x"], out["grad/w"] = np.asarray(gx), np.asarray(gw)
    gs = jax.device_put(g, NamedSharding(mesh, P(("dp", "fsdp"), None,
                                                 "mp")))
    with mesh:
        gx, gg = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.sin(
            jov.overlap_matmul_reduce_scatter(a, b, chunks=2, mesh=mesh))),
            argnums=(0, 1)))(xs, gs)
    out["rs_grad/x"], out["rs_grad/g"] = np.asarray(gx), np.asarray(gg)
    mesh = _mesh2()
    xs = jax.device_put(x, NamedSharding(mesh, P(("dp", "fsdp"), None,
                                                 None)))
    ws = jax.device_put(w, NamedSharding(mesh, P("fsdp", None)))
    with mesh:
        out["ag2/c3"] = np.asarray(jax.jit(
            lambda a, b: jov.overlap_all_gather_matmul(
                a, b, chunks=3, mesh=mesh))(xs, ws))
    mesh = Mesh(np.array(jax.devices()).reshape(8, 1), ("dp", "fsdp"))
    xs = jax.device_put(x, NamedSharding(mesh, P(("dp", "fsdp"), None,
                                                 None)))
    ws = jax.device_put(w, NamedSharding(mesh, P("fsdp", None)))
    with mesh:
        out["one_rank"] = np.asarray(jax.jit(
            lambda a, b: jov.overlap_all_gather_matmul(
                a, b, chunks=2, mesh=mesh))(xs, ws))
    return out


def _jax_trainer(axes):
    """The JAX Trainer's losses with overlap on (test_overlap.py's
    `_train_losses` setup)."""
    jm = _jmodel(2)
    mesh = j_init_mesh(axes)
    tr = JTrainer(jm, jopt.AdamW(learning_rate=rs.OVERLAP_LR,
                                 parameters=jm.parameters()),
                  mesh=mesh, plan=j_plan(mesh.jax_mesh.axis_names),
                  config=JStepConfig(compute_dtype=None, overlap_fsdp=True,
                                     overlap_chunks=2))
    return [float(np.asarray(tr.step(b).numpy()))
            for b in rs.train_batches(256, rs.OVERLAP_STEPS)]


def _jax_grads():
    """jax.value_and_grad of step 1's global batch, in the port's
    layout."""
    jm = _jmodel(2)
    b = rs.train_batches(256, 1)[0]

    def jloss(params):
        out = functional_call(
            jm, params, input_ids=JTensor(jnp.asarray(b["input_ids"])),
            labels=JTensor(jnp.asarray(b["labels"])))
        return out[0]._value.astype(jnp.float32)

    _, g = jax.value_and_grad(jloss)(state_arrays(jm))
    return from_paddle_tpu_state({k: np.asarray(v) for k, v in g.items()},
                                 rs.overlap_cfg())


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The eight-rank job, started first; the JAX references computed
    while it runs. (refs, [rank npz dicts], result)."""
    wdir = tmp_path_factory.mktemp("ovw")
    for name, layers in (("overlap", 2), ("overlap1", 1)):
        np.savez(wdir / f"{name}.npz", **{
            k: np.asarray(v)
            for k, v in state_arrays(_jmodel(layers)).items()})
    out = tmp_path_factory.mktemp("ov")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--devices", ",".join(str(i) for i in range(WORLD)),
         "--log_dir", str(out / "logs"), WORKER, "--job", "overlap",
         "--out", str(out), "--weights", str(wdir), "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        refs = {"ops": _jax_ops(), "grads": _jax_grads(),
                "dp_fsdp": _jax_trainer({"dp": 2, "fsdp": 4}),
                "fsdp_mp": _jax_trainer({"dp": 2, "fsdp": 2, "mp": 2})}
        code = proc.wait(timeout=JOB_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    logs = "".join((out / "logs" / f).read_text()
                   for f in sorted(os.listdir(out / "logs")))
    assert code == 0, f"overlap job failed:\n{logs[-4000:]}"
    assert logs.count("SMOKE_OK") == WORLD
    ranks = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    with open(out / "result.json") as f:
        result = json.load(f)
    return refs, ranks, result


def _close(got, want, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-30)
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def _coords3(r):
    """(dp, fsdp, mp) of rank r on the {dp 2, fsdp 2, mp 2} mesh."""
    return r // 4, (r // 2) % 2, r % 2


# -- the ops ------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [1, 2, 3])    # 3 does not divide the
@pytest.mark.parametrize("shard_dim", [0, 1])    # 8-row pieces: ragged tail
def test_all_gather_matmul_parity(job, chunks, shard_dim):
    """Each rank's rows (and, for shard_dim 0, its mp columns) of the
    contract / assemble ring equal the JAX ring's."""
    refs, ranks, _ = job
    want = refs["ops"][f"ag/sd{shard_dim}/c{chunks}"]
    for r in range(WORLD):
        dp, fs, mp = _coords3(r)
        sl = want[(dp * 2 + fs) * 2:(dp * 2 + fs + 1) * 2]
        if shard_dim == 0:
            sl = sl[..., mp * 16:(mp + 1) * 16]
        _close(ranks[r][f"ag/sd{shard_dim}/c{chunks}"], sl,
               f"rank {r} ag sd{shard_dim} c{chunks}")


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("shard_dim", [0, 1])
def test_matmul_reduce_scatter_parity(job, chunks, shard_dim):
    """Each rank's piece of xᵀ g (P(fsdp, mp) for shard_dim 0, P(mp,
    fsdp) for 1), summed over every row, equals the JAX ring's."""
    refs, ranks, _ = job
    want = refs["ops"][f"rs/sd{shard_dim}/c{chunks}"]
    for r in range(WORLD):
        _, fs, mp = _coords3(r)
        a, b = (fs, mp) if shard_dim == 0 else (mp, fs)
        _close(ranks[r][f"rs/sd{shard_dim}/c{chunks}"],
               want[a * 8:(a + 1) * 8, b * 16:(b + 1) * 16],
               f"rank {r} rs sd{shard_dim} c{chunks}")


def test_gradients_through_the_autograd_pairing(job):
    """The backward composed of the sibling ring (dx) and the
    reduce-scatter ring (dW, then summed over dp) equals jax.grad through
    the JAX ring's custom_vjp."""
    refs, ranks, _ = job
    for r in range(WORLD):
        dp, fs, mp = _coords3(r)
        i = dp * 2 + fs
        _close(ranks[r]["grad/x"], refs["ops"]["grad/x"][i * 2:(i + 1) * 2],
               f"rank {r} dx")
        _close(ranks[r]["grad/w"], refs["ops"]["grad/w"][
            fs * 8:(fs + 1) * 8, mp * 16:(mp + 1) * 16], f"rank {r} dW")


def test_reduce_scatter_gradients(job):
    """The reduce-scatter op's backward (the all-gather rings over the
    piece of the result's gradient, summed over mp where the contraction
    runs over mp-cut features) equals jax.grad through the JAX op."""
    refs, ranks, _ = job
    for r in range(WORLD):
        dp, fs, mp = _coords3(r)
        i = dp * 2 + fs
        _close(ranks[r]["rs_grad/x"],
               refs["ops"]["rs_grad/x"][i * 2:(i + 1) * 2], f"rank {r} dx")
        _close(ranks[r]["rs_grad/g"], refs["ops"]["rs_grad/g"][
            i * 2:(i + 1) * 2, :, mp * 16:(mp + 1) * 16], f"rank {r} dg")


def test_two_axis_mesh_uneven_chunks(job):
    """dp 2 x fsdp 4: 4-row pieces in 3 sub-chunks."""
    refs, ranks, _ = job
    for r in range(WORLD):
        _close(ranks[r]["ag2/c3"], refs["ops"]["ag2/c3"][r:r + 1],
               f"rank {r}")


def test_one_rank_ring(job):
    """An fsdp group of one rank: the ring is one step over the whole
    weight, no hop."""
    refs, ranks, _ = job
    for r in range(WORLD):
        _close(ranks[r]["one_rank"], refs["ops"]["one_rank"][r:r + 1],
               f"rank {r}")


# -- the Trainer --------------------------------------------------------------

def _close_losses(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, err_msg=what)


def _close_grads(ranks, key, want):
    for n, w in want.items():
        _close(ranks[0][f"{key}/grad/{n}"], w, f"{key} {n}")


def test_trainer_overlap_matches_jax_on_dp_fsdp(job):
    """overlap_fsdp=True, overlap_chunks=2 on {dp 2, fsdp 4}: the JAX
    Trainer's losses and jax.grad of step 1."""
    refs, ranks, result = job
    _close_losses(result["dp_fsdp"], refs["dp_fsdp"], "dp x fsdp losses")
    _close_grads(ranks, "dp_fsdp", refs["grads"])


def test_trainer_overlap_on_and_off_on_fsdp_mp(job):
    """{dp 2, fsdp 2, mp 2}: the ring inside the Megatron layers' f- and
    g-ops. On and off agree, and each matches the JAX Trainer (overlap
    on) and jax.grad."""
    refs, ranks, result = job
    on, off = result["fsdp_mp/True"], result["fsdp_mp/False"]
    _close_losses(on, off, "on against off")
    _close_losses(on, refs["fsdp_mp"], "on against JAX")
    for n in refs["grads"]:
        _close(ranks[0][f"fsdp_mp/True/grad/{n}"],
               ranks[0][f"fsdp_mp/False/grad/{n}"], f"on/off {n}")
    _close_grads(ranks, "fsdp_mp/True", refs["grads"])
    want = rs.ring_counts_per_step(rs.overlap_cfg(), 2, 4)
    del want["bytes"]
    assert result["fsdp_mp/True/rings"] == {
        k: rs.OVERLAP_STEPS * v for k, v in want.items()}
    assert result["fsdp_mp/False/rings"] == {k: 0 for k in want}


def test_every_fsdp_projection_takes_the_ring(job):
    """A bf16-compute step's ring counts are the code's (every
    projection's forward ring, its sibling and its reduce-scatter ring:
    the ring takes the Trainer's compute-type copies of the pieces), and
    the bytes one rank sends are 3 hops of each ring's piece, a quarter
    of each projection: bf16 weight pieces twice, f32 gradient
    accumulators once."""
    _, _, result = job
    assert result["ring_per_step"] == result["ring_want"]
    cfg = rs.overlap_cfg()
    d, f, kv = cfg.hidden_size, cfg.intermediate_size, \
        cfg.num_key_value_heads * cfg.head_dim
    per_layer = 2 * d * d + 2 * d * kv + 3 * d * f
    assert result["ring_want"]["bytes"] \
        == cfg.num_hidden_layers * 3 * (2 + 2 + 4) * per_layer // 4


def test_measure_phase_seconds_comm_columns(job):
    """With overlap on, the phase timing gains fwd_comm, bwd_comm and
    overlap_fraction, and records train.overlap.comm.seconds by phase."""
    _, _, result = job
    ph = result["phases"]
    assert {"fwd", "bwd", "optimizer", "step", "fwd_comm", "bwd_comm",
            "overlap_fraction"} <= set(ph)
    assert ph["fwd_comm"] >= 0.0 and ph["bwd_comm"] >= 0.0
    assert ph["overlap_fraction"] is None \
        or 0.0 <= ph["overlap_fraction"] <= 1.0
    assert result["comm_cells"] == sorted(
        [str((("phase", "bwd"),)), str((("phase", "fwd"),))])


# -- in this process ----------------------------------------------------------

def _pmesh3():
    return ProcessMesh(np.arange(8).reshape(2, 2, 2), ["dp", "fsdp", "mp"])


def test_contract_names_every_misaligned_dim():
    """The port's contracts are the JAX ones: the same problems, named
    alike, for the same global shapes."""
    mesh, jmesh = _pmesh3(), _mesh3()
    for args in [((8, 8, 17), (19, 33)), ((8, 8, 16), (16, 32)),
                 ((7, 8, 16), (16, 32)), ((8, 8, 16), (16, 31))]:
        for sd in (0, 1):
            assert tov.overlap_shape_problems(*args, mesh, shard_dim=sd) \
                == jov.overlap_shape_problems(*args, jmesh, shard_dim=sd)
    with pytest.raises(ValueError) as ei:
        tov.check_overlap_shapes((8, 8, 17), (19, 33), mesh, chunks=1,
                                 shard_dim=0)
    msg = str(ei.value)
    assert "contracting dims differ" in msg and "17" in msg
    assert "w dim 0 (19)" in msg and "'fsdp' size 2" in msg
    assert "w dim 1 (33)" in msg and "'mp' size 2" in msg
    with pytest.raises(ValueError, match=r"result dim 0 \(19\)"):
        tov.check_overlap_rs_shapes((8, 8, 19), (8, 8, 32), mesh)
    assert tov.overlap_rs_shape_problems((8, 8, 19), (8, 8, 32), mesh) \
        == jov.overlap_rs_shape_problems((8, 8, 19), (8, 8, 32), jmesh)
    assert any("no device mesh" in p for p in
               tov.overlap_shape_problems((8, 8, 16), (16, 32), None))
    assert any("no 'fsdp' axis" in p for p in tov.overlap_rs_shape_problems(
        (8, 8, 16), (8, 8, 32), ProcessMesh(np.arange(8), ["dp"])))
    with pytest.raises(ValueError, match="kernel must be"):
        tov.overlap_all_gather_matmul(None, None, kernel="pallas")


def test_guard_restores_state():
    assert tov.current_overlap() is None
    mesh = ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "fsdp"])
    with tov.overlap_fsdp_guard(mesh, chunks=3):
        st = tov.current_overlap()
        assert st["on"] and st["chunks"] == 3 and st["axis"] == "fsdp"
        with tov.overlap_fsdp_guard(mesh, chunks=0):
            assert tov.current_overlap()["chunks"] == 1
        assert tov.current_overlap()["chunks"] == 3
    assert tov.current_overlap() is None


def test_overlap_fraction_from_spans():
    """The JAX span arithmetic on planted spans: the same fraction, None
    for an incomplete set, the newest span of a (variant, phase) wins."""
    def span(variant, phase, secs):
        return types.SimpleNamespace(
            name="train.overlap.phase", dur_us=secs * 1e6,
            attrs={"variant": variant, "phase": phase})

    spans = [span("propagated", "fwd", 1.0), span("overlapped", "fwd", 0.7),
             span("nocomm", "fwd", 0.6), span("propagated", "bwd", 2.0),
             span("overlapped", "bwd", 1.5), span("nocomm", "bwd", 1.0)]
    for s in (spans, spans[:-1], []):
        assert tov.overlap_fraction_from_spans(s) \
            == jov.overlap_fraction_from_spans(s)
    assert tov.overlap_fraction_from_spans(spans) == pytest.approx(0.8 / 1.4)
    spans.append(span("overlapped", "bwd", 2.0))
    assert tov.overlap_fraction_from_spans(spans) == pytest.approx(0.3 / 1.4)


def test_ring_modules_import_without_jax_or_paddle_tpu():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import paddle_tpu_torch.parallel.overlap\n"
        "import paddle_tpu_torch.distributed.context_parallel\n"
        "import paddle_tpu_torch.distributed.launch.ring_smoke\n"
        "import paddle_tpu_torch.tools.p2p_probe\n"
        "import paddle_tpu_torch.parallel.trainer\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m.split('.')[0] in ('paddle_tpu', 'jax', 'jaxlib',"
        " 'ml_dtypes'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
