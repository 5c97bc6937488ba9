"""Context parallelism (paddle_tpu_torch/distributed/context_parallel.py and
the Trainer's 'sp' axis) across processes, against the JAX package's
paddle_tpu/distributed/context_parallel.py on the CPU.

The job: the port's launcher starts paddle_tpu_torch/distributed/launch/
ring_smoke.py `--job cp` as eight gloo workers on {"dp": 2, "sp": 4} in a
module-scoped fixture, while this process computes the JAX references on
its eight virtual CPU devices: JAX `ring_attention` / `ulysses_attention`
on the same mesh and the whole-sequence attention (`_sdpa_ref`), with
jax.grad of sum(out^2); the JAX flash ring in Pallas interpret mode
(`ring_attention_local(use_flash=True, interpret=True)`, as
tests/test_context_parallel.py:95-135) for the port's flash ring on the
kernels' CPU twins; the JAX Trainer with `context_parallel` "ring" and
"ulysses" on the same mesh (test_context_parallel.py:69-92's setup, the
tiny Llama at 2 layers, AdamW 1e-3, f32) for each ring_smoke.CP_VARIANTS
model; and jax.value_and_grad of step 1's loss on one device.

Tolerances (f32): each rank's share of an attention output or gradient
within 1e-5 of the JAX output's largest entry; against the JAX flash
ring in interpret mode, within 2e-4 of it (the JAX test's rtol for its
flash ring against its jnp ring); the Trainer's losses
within 1e-5 relative and step 1's gathered gradients within 1e-5 of each
tensor's largest entry.
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
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.jax_compat import shard_map
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import context_parallel as jcp
from paddle_tpu.distributed.mesh import init_mesh as j_init_mesh
from paddle_tpu.jit.functional import functional_call, state_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn.functional.attention import _sdpa_ref
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu.parallel import TrainStepConfig as JStepConfig
from paddle_tpu.parallel import llama_sharding_plan as j_plan
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import context_parallel as tcp
from paddle_tpu_torch.distributed.launch import ring_smoke as rs
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.parallel import plan as tplan
from paddle_tpu_torch.parallel.trainer import (ContextParallelRequired,
                                               Trainer, TrainStepConfig,
                                               _seq_shard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "paddle_tpu_torch", "distributed", "launch",
                      "ring_smoke.py")
JOB_TIMEOUT_S = 300
TOL = 1e-5
# against the JAX flash ring in interpret mode (its kernels take exp2 of
# base-2 scaled scores): the JAX test's rtol for its flash ring against its
# jnp ring, of each tensor's largest entry
FLASH_TOL = 2e-4
WORLD = 8
SP = 4
MODES = ("ring", "ulysses")


def _jcfg(name):
    return jllama.tiny_llama_config(num_hidden_layers=2,
                                    **rs.CP_VARIANTS[name])


def _jmodel(name):
    paddle_tpu.seed(0)
    return jllama.LlamaForCausalLM(_jcfg(name))


def _jax_ops():
    """{key: global output} of the JAX rings, Ulysses and the
    whole-sequence attention, and jax.grad of sum(out^2)."""
    mesh = j_init_mesh({"dp": 2, "sp": SP})
    out = {}
    for case, shape in rs.CP_OPS.items():
        q, k, v = (jnp.asarray(a) for a in rs.qkv(*shape))
        for causal in (True, False):
            out[f"ring/{case}/{causal}"] = np.asarray(jax.jit(
                lambda a, b, c, causal=causal: jcp.ring_attention(
                    a, b, c, mesh=mesh, causal=causal))(q, k, v))
            out[f"full/{case}/{causal}"] = np.asarray(
                _sdpa_ref(q, k, v, is_causal=causal))
        out[f"ulysses/{case}"] = np.asarray(jax.jit(
            lambda a, b, c: jcp.ulysses_attention(
                a, b, c, mesh=mesh, causal=True))(q, k, v))
        for mode, f in (("ring", jcp.ring_attention),
                        ("ulysses", jcp.ulysses_attention)):
            g = jax.jit(jax.grad(lambda a, b, c, f=f: jnp.sum(
                f(a, b, c, mesh=mesh, causal=True) ** 2),
                argnums=(0, 1, 2)))(q, k, v)
            for n, t in zip("qkv", g):
                out[f"grad/{mode}/{case}/{n}"] = np.asarray(t)
    return out


def _jax_flash_interpret():
    """The JAX flash ring (Pallas interpret mode) on the d64 case over an
    'sp' mesh of 4: output and jax.grad of sum(out^2), (B, S, H, D)."""
    mesh = j_init_mesh({"sp": SP})
    q, k, v = (jnp.swapaxes(jnp.asarray(a), 1, 2)
               for a in rs.qkv(*rs.CP_OPS["d64"]))

    def local(ql, kl, vl):
        return jcp.ring_attention_local(ql, kl, vl, "sp", causal=True,
                                        use_flash=True, interpret=True)

    spec = P(None, None, "sp", None)
    f = shard_map(local, mesh=mesh.jax_mesh, in_specs=(spec,) * 3,
                  out_specs=spec, check_vma=False)
    o = f(q, k, v)
    g = jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) ** 2),
                 argnums=(0, 1, 2))(q, k, v)
    out = {"out": np.asarray(jnp.swapaxes(o, 1, 2))}
    out.update({n: np.asarray(jnp.swapaxes(t, 1, 2))
                for n, t in zip("qkv", g)})
    return out


def _jax_trainers():
    """{variant/mode: losses}, {variant: step 1's gradients (port
    layout)}, {variant: the shift batch's loss, a step after the ring
    Trainer's}."""
    mesh = j_init_mesh({"dp": 2, "sp": SP})
    losses, grads, shift = {}, {}, {}
    for name in rs.CP_VARIANTS:
        batches = rs.train_batches(256, rs.CP_STEPS, rs.CP_BATCH)
        for mode in MODES:
            jm = _jmodel(name)
            tr = JTrainer(jm, jopt.AdamW(learning_rate=rs.CP_LR,
                                         parameters=jm.parameters()),
                          mesh=mesh, plan=j_plan(mesh.jax_mesh.axis_names),
                          config=JStepConfig(compute_dtype=None,
                                             context_parallel=mode))
            losses[f"{name}/{mode}"] = [float(np.asarray(tr.step(b).numpy()))
                                        for b in batches]
            if mode == "ring":
                shift[name] = float(np.asarray(tr.step(
                    rs.shift_batch(256, SP)).numpy()))
        jm = _jmodel(name)
        b = batches[0]

        def jloss(params, jm=jm, b=b):
            out = functional_call(
                jm, params, input_ids=JTensor(jnp.asarray(b["input_ids"])),
                labels=JTensor(jnp.asarray(b["labels"])))
            return out[0]._value.astype(jnp.float32)

        _, g = jax.value_and_grad(jloss)(state_arrays(jm))
        grads[name] = from_paddle_tpu_state(
            {k: np.asarray(v) for k, v in g.items()}, rs.cp_cfg(name))
    return losses, grads, shift


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The eight-rank job, started first; the JAX references computed
    while it runs. (refs, [rank npz dicts], result)."""
    wdir = tmp_path_factory.mktemp("cpw")
    for name in rs.CP_VARIANTS:
        np.savez(wdir / f"cp_{name}.npz", **{
            k: np.asarray(v) for k, v in state_arrays(_jmodel(name)).items()})
    out = tmp_path_factory.mktemp("cp")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--devices", ",".join(str(i) for i in range(WORLD)),
         "--log_dir", str(out / "logs"), WORKER, "--job", "cp",
         "--out", str(out), "--weights", str(wdir), "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        losses, grads, shift = _jax_trainers()
        refs = {"ops": _jax_ops(), "flash": _jax_flash_interpret(),
                "losses": losses, "grads": grads, "shift": shift}
        code = proc.wait(timeout=JOB_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    logs = "".join((out / "logs" / f).read_text()
                   for f in sorted(os.listdir(out / "logs")))
    assert code == 0, f"cp job failed:\n{logs[-4000:]}"
    assert logs.count("SMOKE_OK") == WORLD
    ranks = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    with open(out / "result.json") as f:
        result = json.load(f)
    return refs, ranks, result


def _close(got, want, what, tol=TOL):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _share(a, r):
    """Rank r's (row, sequence shard) of a global (B, S, ...) array."""
    dp, sp = r // SP, r % SP
    s = a.shape[1] // SP
    return a[dp:dp + 1, sp * s:(sp + 1) * s]


def _tags(case):
    return ("plain", "flash") if rs.CP_OPS[case][-1] == 64 else ("plain",)


# -- the attention ------------------------------------------------------------

@pytest.mark.parametrize("case", list(rs.CP_OPS))
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_and_full_attention(job, case, causal):
    """Each rank's shard of the ring (plain, and at d 64 the flash ring on
    the kernels' twins), GQA, equals the JAX ring's and the
    whole-sequence attention's."""
    refs, ranks, _ = job
    for tag in _tags(case):
        for r in range(WORLD):
            got = ranks[r][f"ring/{case}/{tag}/{causal}"]
            for ref in ("ring", "full"):
                _close(got, _share(refs["ops"][f"{ref}/{case}/{causal}"], r),
                       f"rank {r} {tag} against the JAX {ref}")


@pytest.mark.parametrize("case", list(rs.CP_OPS))
def test_ulysses_matches_jax_and_full_attention(job, case):
    """Ulysses (d32: K/V repeated to the query heads; d64: K/V at Hk
    heads, 4 over 4 ranks) equals the JAX Ulysses and the whole-sequence
    attention."""
    refs, ranks, _ = job
    for tag in _tags(case):
        for r in range(WORLD):
            got = ranks[r][f"ulysses/{case}/{tag}"]
            _close(got, _share(refs["ops"][f"ulysses/{case}"], r),
                   f"rank {r} {tag}")
            _close(got, _share(refs["ops"][f"full/{case}/True"], r),
                   f"rank {r} {tag} against the full")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(rs.CP_OPS))
def test_gradients_match_jax(job, mode, case):
    """dq, dk, dv of sum(out^2) through the ring's backward (the flash
    ring's (k, v, dk, dv) rotation; the plain ring's autograd hops) and
    Ulysses' all-to-alls equal jax.grad."""
    refs, ranks, _ = job
    for tag in _tags(case):
        for r in range(WORLD):
            for n in "qkv":
                _close(ranks[r][f"grad/{mode}/{case}/{tag}/{n}"],
                       _share(refs["ops"][f"grad/{mode}/{case}/{n}"], r),
                       f"rank {r} {tag} d{n}")


def test_flash_ring_matches_the_jax_flash_ring_interpret(job):
    """The port's per-block flash ring (the kernels' CPU twins, natural-log
    lse merge, skipped future shards) against the JAX flash ring of Pallas
    kernels in interpret mode (base-2 lse merge), values and gradients."""
    refs, ranks, _ = job
    want = refs["flash"]
    for r in range(SP):          # dp row 0 of the d64 case
        _close(ranks[r]["ring/d64/flash/True"][0], _share(want["out"], r)[0],
               f"rank {r} out", FLASH_TOL)
        for n in "qkv":
            _close(ranks[r][f"grad/ring/d64/flash/{n}"][0],
                   _share(want[n], r)[0], f"rank {r} d{n}", FLASH_TOL)


# -- the Trainer --------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(rs.CP_VARIANTS))
def test_trainer_matches_jax(job, name, mode):
    """The Trainer on {dp 2, sp 4} with context_parallel `mode`: the JAX
    Trainer's losses and jax.grad of step 1 (labels shifted across the
    cut, RoPE at global positions, plain or fused, gradients summed over
    dp x sp). The flash variant launches the flash twins and no whole
    attention."""
    refs, ranks, result = job
    key = f"trainer/{name}/{mode}"
    np.testing.assert_allclose(result[key], refs["losses"][f"{name}/{mode}"],
                               rtol=TOL)
    for n, w in refs["grads"][name].items():
        _close(ranks[0][f"{key}/grad/{n}"], w, f"{key} {n}")
    counts = result[key + "/counts"]
    if mode == "ring":
        assert counts["hops"] > 0 and counts["all_to_all"] == 0
    else:
        assert counts["all_to_all"] > 0 and counts["hops"] == 0


def test_flash_ring_hops_per_step(job):
    """The flash ring's hops are the code's: per layer and step, n - 1
    forward hops of k and of v, and in the backward n - 1 of k and v and
    n of the dk and dv accumulators (each shard's gradients end at home).
    Ulysses runs 3 all-to-alls forward (q, k, v) and 1 back, and as many
    in the backward."""
    _, _, result = job
    layers = rs.cp_cfg("flash").num_hidden_layers
    ring = result["trainer/flash/ring/counts"]
    assert ring["hops"] == rs.CP_STEPS * layers * (
        2 * (SP - 1) + 2 * (SP - 1) + 2 * SP)
    assert result["trainer/flash/ulysses/counts"]["all_to_all"] \
        == rs.CP_STEPS * layers * 8


def test_labels_shift_across_the_cut(job):
    """A batch whose one valid label sits at the first position of sp
    rank 1's shard, a step after the ring Trainer's: the loss is the JAX
    Trainer's, finite (the previous shard's last position scores it)."""
    refs, _, result = job
    for name in rs.CP_VARIANTS:
        got = result[f"shift/{name}"]
        assert np.isfinite(got) and got > 0
        np.testing.assert_allclose(got, refs["shift"][name], rtol=TOL)


# -- in this process ----------------------------------------------------------

def test_seq_shard_shifts_then_cuts_and_adds_global_positions():
    ids = torch.arange(16).reshape(2, 8)
    labels = ids.clone()
    for r in range(4):
        got = _seq_shard({"input_ids": ids, "labels": labels}, 4, r)
        assert torch.equal(got["input_ids"], ids[:, 2 * r:2 * r + 2])
        want = torch.cat([labels[:, 1:], torch.full((2, 1), -100)], 1)
        assert torch.equal(got["labels"], want[:, 2 * r:2 * r + 2])
        assert torch.equal(got["position_ids"],
                           torch.arange(2 * r, 2 * r + 2).expand(2, 2))
    with pytest.raises(ValueError, match="does not split"):
        _seq_shard({"input_ids": torch.zeros(2, 6)}, 4, 0)


def _tiny_trainer(**kw):
    model = tllama.LlamaForCausalLM(tllama.tiny_llama_config(
        num_hidden_layers=1), device="cpu")
    mesh = ProcessMesh([[0, 1]], ["dp", "sp"])
    return Trainer(model, topt.AdamW(parameters=model.named_parameters()),
                   TrainStepConfig(compute_dtype=None, **kw), mesh=mesh,
                   plan=tplan.llama_sharding_plan(mesh.dim_names))


def test_sp_without_context_parallel_raises():
    """'sp' > 1 needs the ring or Ulysses: the attention XLA would run
    there takes sq != sk, which the port's flash kernel refuses."""
    with pytest.raises(ValueError, match="queue 2 A item 1") as ei:
        _tiny_trainer()
    assert isinstance(ei.value, ContextParallelRequired)
    with pytest.raises(ValueError, match="shard_batch_seq"):
        _tiny_trainer(context_parallel="ring", shard_batch_seq=False)


def test_guard_restores_state_and_names_bad_input():
    mesh = ProcessMesh([[0, 1]], ["dp", "sp"])
    assert tcp.current_context_parallel() is None
    with tcp.context_parallel_guard(mesh, mode="ulysses"):
        assert tcp.current_context_parallel()["mode"] == "ulysses"
        with tcp.context_parallel_guard(mesh, mode="ring"):
            assert tcp.current_context_parallel()["mode"] == "ring"
        assert tcp.current_context_parallel()["mode"] == "ulysses"
    assert tcp.current_context_parallel() is None
    with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
        with tcp.context_parallel_guard(mesh, mode="zigzag"):
            pass
    group = types.SimpleNamespace(nranks=3, rank=0)
    q = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError, match="4 query heads do not divide"):
        tcp.ulysses_attention(q, q, q, group=group)
    q = torch.zeros(1, 4, 4, 32)
    with pytest.raises(ValueError, match="head_dim"):
        tcp.ring_attention(q, q, q, group=group)
