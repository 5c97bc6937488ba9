"""Tensor parallelism across processes: the Trainer on an {"mp": 2} and a
{"dp": 2, "mp": 2} mesh (paddle_tpu_torch/parallel/{plan,trainer}.py,
distributed/fleet/, the vocab-parallel losses) against the JAX package's
GSPMD Trainer on `init_mesh` with the same axes, on the CPU.

The jobs: the port's launcher starts paddle_tpu_torch/distributed/
launch/smoke.py as 2 (then 4) gloo workers with `--mesh mp:2` (then
`dp:2,mp:2`), once each, in a module-scoped fixture. Every worker loads
the JAX model's weights (tiny_llama_config(num_hidden_layers=2), seed 0)
for each of smoke.TP_VARIANTS: the dense loss and the blockwise loss
(loss_chunk 16, one with vocab blocks of 48 over a shard of 128), tied
and untied embeddings, unfused and fused qkv / gate-up projections, two
with ClipGradByGlobalNorm and the health probe; the same global batches,
rows 0-3 labelled -100 from column 20 (so the dp ranks hold different
counts of valid tokens). The JAX side is `Trainer(mesh=init_mesh(axes),
plan=llama_sharding_plan(...))` on this process's virtual CPU devices,
f32 compute.

Tolerances (f32): losses and the probe's gradient norm within 1e-5
relative (test_multiprocess.py:130's bound on its 2-process run), step
1's gathered gradients within 1e-5 of each tensor's largest entry
(test_torch_train.py's rule against `jax.value_and_grad`). Each planted
fault must read outside its bound: the blockwise loss combined from each
rank's local lse (the loss), a column-parallel f-op whose backward skips
its all-reduce (the gradients), a global norm that counts the replicated
gradients once per mp rank (the probe's norm).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed.fleet import (CommunicateTopology,
                                          HybridCommunicateGroup)
from paddle_tpu.distributed.mesh import init_mesh as j_init_mesh
from paddle_tpu.jit.functional import functional_call, state_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu.parallel import TrainStepConfig as JStepConfig
from paddle_tpu.parallel import llama_sharding_plan as j_plan
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.launch.smoke import (
    LAYERS, LR, TP_CKPT_AT, TP_CKPT_VARIANT, TP_CLIP, TP_STEPS, TP_VARIANTS,
    smoke_batches)
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.parallel import plan as tplan
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "paddle_tpu_torch", "distributed", "launch",
                     "smoke.py")
JOB_TIMEOUT_S = 300
MESHES = {"mp:2": {"mp": 2}, "dp:2,mp:2": {"dp": 2, "mp": 2}}
VOCAB = 256
CLIPPED = [n for n, (_, clip) in TP_VARIANTS.items() if clip]


def _jcfg(name):
    return jllama.tiny_llama_config(num_hidden_layers=LAYERS,
                                    **TP_VARIANTS[name][0])


def _tcfg(name):
    return tllama.tiny_llama_config(num_hidden_layers=LAYERS,
                                    **TP_VARIANTS[name][0])


def _jmodel(name):
    paddle_tpu.seed(0)
    return jllama.LlamaForCausalLM(_jcfg(name))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each variant's JAX weights, as DIR/{variant}.npz for the workers."""
    out = tmp_path_factory.mktemp("tpw")
    states = {}
    for name in TP_VARIANTS:
        states[name] = {k: np.asarray(v)
                        for k, v in state_arrays(_jmodel(name)).items()}
        np.savez(out / f"{name}.npz", **states[name])
    return str(out), states


def _start(mesh, weights_dir, out):
    world = int(np.prod(list(MESHES[mesh].values())))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--devices", ",".join(str(i) for i in range(world)),
           "--log_dir", str(out / "logs"), SMOKE, "--out", str(out),
           "--device", "cpu", "--mesh", mesh, "--tp-weights", weights_dir]
    return subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=REPO))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, weights):
    """Both launcher jobs, started together; the JAX references are
    computed while they run. {mesh: (out dir, result, grads)}."""
    outs = {m: tmp_path_factory.mktemp("tp") for m in MESHES}
    procs = {m: _start(m, weights[0], outs[m]) for m in MESHES}
    try:
        for name in TP_VARIANTS:
            _jax_grads(name)
            for m in MESHES:
                _jax_run(name, m)
        codes = {m: p.wait(timeout=JOB_TIMEOUT_S) for m, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {}
    for m, out in outs.items():
        world = int(np.prod(list(MESHES[m].values())))
        logs = "".join((out / "logs" / f).read_text()
                       for f in sorted(os.listdir(out / "logs")))
        assert codes[m] == 0, f"tp job {m} failed:\n{logs[-4000:]}"
        assert logs.count("SMOKE_OK") == world
        with open(out / "result.json") as f:
            result = json.load(f)
        with np.load(out / "grads.npz") as f:
            grads = {k: f[k] for k in f.files}
        got[m] = (out, result, grads)
    return got


@pytest.fixture(params=list(MESHES))
def job(request, jobs):
    """(mesh text, out dir, result, grads) of one mesh's job."""
    return (request.param,) + jobs[request.param]


def _jax_trainer(name, axes):
    jm = _jmodel(name)
    clip = TP_VARIANTS[name][1]
    mesh = j_init_mesh(axes)
    return JTrainer(jm, jopt.AdamW(
        learning_rate=LR, parameters=jm.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(TP_CLIP) if clip else None),
        mesh=mesh, plan=j_plan(mesh.jax_mesh.axis_names),
        config=JStepConfig(compute_dtype=None, health_probe=clip))


_JAX_RUNS = {}


def _jax_run(name, mesh):
    """The JAX mesh Trainer's losses and probe norms (cached)."""
    key = (name, mesh)
    if key not in _JAX_RUNS:
        tr = _jax_trainer(name, MESHES[mesh])
        losses, probes = [], []
        for b in smoke_batches(VOCAB, TP_STEPS):
            losses.append(float(np.asarray(tr.step(b).numpy())))
            if tr.last_probe is not None:
                probes.append(float(np.asarray(tr.last_probe)[0]))
        _JAX_RUNS[key] = (losses, probes)
    return _JAX_RUNS[key]


_JAX_GRADS = {}


def _jax_grads(name):
    """jax.value_and_grad of the step-1 global batch, in the port's
    layout (cached)."""
    if name not in _JAX_GRADS:
        jm = _jmodel(name)
        b = smoke_batches(VOCAB, 1)[0]

        def jloss(params):
            out = functional_call(
                jm, params, input_ids=JTensor(jnp.asarray(b["input_ids"])),
                labels=JTensor(jnp.asarray(b["labels"])))
            return out[0]._value.astype(jnp.float32)

        _, g = jax.value_and_grad(jloss)(state_arrays(jm))
        _JAX_GRADS[name] = from_paddle_tpu_state(
            {k: np.asarray(v) for k, v in g.items()}, _tcfg(name))
    return _JAX_GRADS[name]


def _grad_gap(got, want):
    """The largest |got - want| over want's largest entry, over the
    tensors."""
    return max(float(np.abs(got[n] - w.numpy()).max())
               / max(float(np.abs(w.numpy()).max()), 1e-30)
               for n, w in want.items())


def _grads_of(grads, prefix):
    return {k.split("/", 1)[1]: v for k, v in grads.items()
            if k.startswith(prefix + "/")}


def test_tp_job_world(job):
    mesh, _, result, _ = job
    axes = MESHES[mesh]
    assert result["world"] == int(np.prod(list(axes.values())))
    assert result["backend"] == "gloo"
    assert result["mesh"] == [[k, v] for k, v in axes.items()]


@pytest.mark.parametrize("name", list(TP_VARIANTS))
def test_tp_losses_match_jax_mesh_trainer(job, name):
    """3 steps of every variant: the JAX GSPMD Trainer's losses on the
    same axes."""
    mesh, _, result, _ = job
    got = result["variants"][name]["losses"]
    assert len(got) == TP_STEPS
    np.testing.assert_allclose(got, _jax_run(name, mesh)[0], rtol=1e-5)


@pytest.mark.parametrize("name", CLIPPED)
def test_tp_clip_norms_match_jax_probe(job, name):
    """ClipGradByGlobalNorm's norm, read by the health probe: the shards'
    squares summed over mp, the replicated ones counted once."""
    mesh, _, result, _ = job
    np.testing.assert_allclose(result["variants"][name]["probes"],
                               _jax_run(name, mesh)[1], rtol=1e-5)


@pytest.mark.parametrize("name", list(TP_VARIANTS))
def test_tp_step1_gathered_gradients_match_jax(job, name):
    _, _, _, grads = job
    want = _jax_grads(name)
    got = _grads_of(grads, name)
    assert set(got) == set(want)
    assert _grad_gap(got, want) <= 1e-5


def test_tp_shards_and_replicas(job):
    """Each rank holds half of every cut dim (rank r's fused rows are
    [q_r; k_r; v_r], [gate_r; up_r]), whole norms, bit-equal across the
    mp ranks after the steps."""
    _, _, result, _ = job
    for name, v in result["variants"].items():
        assert v["replicated_equal"], name
        cfg = _tcfg(name)
        d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
        kv = cfg.num_key_value_heads * hd
        shapes = v["local_shapes"]
        assert shapes["model.embed_tokens.weight"] == [VOCAB // 2, d]
        assert shapes["model.norm.weight"] == [d]
        attn = "model.layers.0.self_attn."
        mlp = "model.layers.0.mlp."
        if cfg.fuse_attention_qkv:
            assert shapes[attn + "qkv_proj.weight"] == [(d + 2 * kv) // 2, d]
            assert shapes[mlp + "gate_up_fused_proj.weight"] == [f, d]
        else:
            assert shapes[attn + "q_proj.weight"] == [d // 2, d]
            assert shapes[attn + "k_proj.weight"] == [kv // 2, d]
            assert shapes[mlp + "up_proj.weight"] == [f // 2, d]
        assert shapes[attn + "o_proj.weight"] == [d, d // 2]
        assert shapes[mlp + "down_proj.weight"] == [d, f // 2]
        if not cfg.tie_word_embeddings:
            assert shapes["lm_head.weight"] == [VOCAB // 2, d]


def test_planted_local_lse_reads_outside_the_loss_bound(job):
    mesh, _, result, _ = job
    fault = np.asarray(result["faults"]["local_lse"])
    want = np.asarray(_jax_run("chunk", mesh)[0][:1])
    assert (np.abs(fault - want) / np.abs(want) > 1e-5).all(), fault


def test_planted_dropped_fop_reads_outside_the_gradient_bound(job):
    _, _, _, grads = job
    assert _grad_gap(_grads_of(grads, "fop"), _jax_grads("dense")) > 1e-5


def test_planted_replicated_norm_reads_outside_the_probe_bound(job):
    mesh, _, result, _ = job
    fault = np.asarray(result["faults"]["norm"])
    want = np.asarray(_jax_run("dense", mesh)[1])
    assert (np.abs(fault - want) / np.abs(want) > 1e-5).all(), fault


def test_nonfinite_skip_agrees_across_the_mp_ranks(job):
    """A NaN in one rank's gradient shard only: the skip flag is taken
    over the mp group, so every rank skips and keeps its parameters."""
    _, _, result, _ = job
    assert result["skip"] == [[1.0, 1.0]] * result["world"]


def test_fleet_distributed_model_and_topology(job):
    """fleet.init over the world, distributed_model, the Trainer on the
    fleet mesh: the Megatron layers in place, the plan's losses, and the
    JAX HybridCommunicateGroup's view of rank 0 of the same topology."""
    mesh, _, result, _ = job
    axes = MESHES[mesh]
    fl = result["fleet"]
    np.testing.assert_allclose(fl["losses"],
                               result["variants"]["dense"]["losses"],
                               rtol=1e-6)
    dp, mp = axes.get("dp", 1), axes["mp"]
    assert fl["mesh"] == [["dp", "pp", "fsdp", "sp", "mp"], [dp, 1, 1, 1, mp]]
    assert fl["worker"] == [0, dp * mp, True]
    kinds = fl["kinds"]
    assert kinds["model.embed_tokens"] == "VocabParallelEmbedding"
    assert kinds["lm_head"] == "ColumnParallelLinear"
    assert kinds["model.layers.1.self_attn.o_proj"] == "RowParallelLinear"
    assert kinds["model.layers.1.mlp.gate_proj"] == "ColumnParallelLinear"
    hcg = HybridCommunicateGroup(CommunicateTopology(
        ["data", "pipe", "sharding", "sep", "model"], [dp, 1, 1, 1, mp]),
        global_rank=0)
    assert fl["hcg"] == {
        "dp_rank": hcg.get_data_parallel_rank(),
        "mp_rank": hcg.get_model_parallel_rank(),
        "dp_group": hcg.get_data_parallel_group(),
        "mp_group": hcg.get_model_parallel_group(),
        "mp_world": hcg.get_model_parallel_world_size(),
        "dp_world": hcg.get_data_parallel_world_size()}


def test_tp_checkpoint_loads_in_one_process_and_continues(job, weights):
    """The checkpoint the mp ranks wrote after step 2 holds whole tensors
    (the fused rows in the whole layer's order): a mesh-free Trainer
    loads it and its step 3 gives the uninterrupted run's loss."""
    _, out, result, _ = job
    cfg = _tcfg(TP_CKPT_VARIANT)
    model = tllama.LlamaForCausalLM(cfg, device="cpu", seed=5)
    tr = Trainer(model, topt.AdamW(learning_rate=LR,
                                   parameters=model.named_parameters()),
                 TrainStepConfig(compute_dtype=None))
    tr.load_checkpoint(os.path.join(out, "ckpt"))
    batches = smoke_batches(VOCAB, TP_STEPS)
    rest = [float(tr.step(b)) for b in batches[TP_CKPT_AT:]]
    np.testing.assert_allclose(
        rest, result["variants"][TP_CKPT_VARIANT]["losses"][TP_CKPT_AT:],
        rtol=1e-5)


def _tiny(**overrides):
    return tllama.LlamaForCausalLM(
        tllama.tiny_llama_config(num_hidden_layers=1, **overrides),
        device="cpu")


@pytest.mark.parametrize("overrides,param", [
    (dict(num_key_value_heads=1), "k_proj"),
    (dict(vocab_size=255), "embed_tokens"),
    (dict(intermediate_size=127), "gate_proj"),
])
def test_non_divisible_dims_and_few_kv_heads_raise(overrides, param):
    """The JAX package pads such dims; the port refuses them, naming the
    parameter, before it forms any group."""
    model = _tiny(**overrides)
    mesh = ProcessMesh([0, 1], ["mp"])
    with pytest.raises(ValueError, match=param):
        tplan.apply_plan(model, mesh, tplan.llama_sharding_plan(["mp"]))


_BUILD_ON_FSDP = """
import numpy as np
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import collective, env
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.parallel import plan as tplan
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
env.init_parallel_env(device="cpu")
model = tllama.LlamaForCausalLM(
    tllama.tiny_llama_config(num_hidden_layers=1), device="cpu")
mesh = ProcessMesh([[0, 1]], ["dp", "fsdp"])
tr = Trainer(model, topt.AdamW(parameters=model.named_parameters()),
             TrainStepConfig(compute_dtype=None), mesh=mesh,
             plan=tplan.llama_sharding_plan(mesh.dim_names))
ids = np.random.RandomState(0).randint(0, 256, (4, 16)).astype(np.int32)
loss = float(tr.step({"input_ids": ids, "labels": ids}))
print("BUILT", list(model.model.embed_tokens.weight.shape), loss,
      flush=True)
collective.destroy_process_group()
"""


@pytest.mark.parametrize("axis,slice_name", [
    ("fsdp", "FSDP"), ("sp", "context-parallel"), ("pp", "pipeline"),
    ("ep", "expert-parallel")])
def test_trainer_refuses_the_axes_still_to_come(axis, slice_name, tmp_path):
    """Each axis a later slice ports is refused, naming that slice; the
    FSDP slice has come, so on a {"dp": 1, "fsdp": 2} mesh the Trainer
    builds (two gloo ranks through the launcher), cuts the embedding's D
    columns and steps."""
    if axis == "fsdp":
        script = tmp_path / "build.py"
        script.write_text(_BUILD_ON_FSDP)
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--devices", "0,1", "--log_dir", str(tmp_path / "logs"),
             str(script)], env=dict(os.environ, PYTHONPATH=REPO),
            timeout=JOB_TIMEOUT_S)
        logs = "".join((tmp_path / "logs" / f).read_text()
                       for f in sorted(os.listdir(tmp_path / "logs")))
        assert proc.returncode == 0, logs[-4000:]
        built = [ln.split() for ln in logs.splitlines()
                 if ln.startswith("BUILT")]
        assert len(built) == 2 and all(b[1:3] == ["[256,", "32]"]
                                       for b in built), built
        assert built[0][3] == built[1][3]          # the one global loss
        return
    model = _tiny()
    mesh = ProcessMesh([[0, 1]], ["dp", axis])
    opt = topt.AdamW(parameters=model.named_parameters())
    with pytest.raises(NotImplementedError, match=slice_name):
        Trainer(model, opt, TrainStepConfig(compute_dtype=None), mesh=mesh,
                plan=tplan.llama_sharding_plan(mesh.dim_names))


def test_mp_mesh_without_a_plan_raises():
    """An mp request never runs one rank's whole model."""
    model = _tiny()
    mesh = ProcessMesh([[0, 1]], ["dp", "mp"])
    with pytest.raises(ValueError, match="needs a plan"):
        Trainer(model, topt.AdamW(parameters=model.named_parameters()),
                TrainStepConfig(compute_dtype=None), mesh=mesh)


def test_plan_maps_the_jax_layout_by_meaning():
    """The JAX (in, out) specs on the port's (out, in) weights: output
    dims on 'mp' are column cuts (dim 0), input dims row cuts (dim 1),
    the embedding's vocab its rows, in both packages' layouts."""
    model = _tiny(tie_word_embeddings=False)
    plan = tplan.llama_sharding_plan(["dp", "mp"])
    cuts = {name: kind for name, _, kind, _ in tplan._mp_cuts(model, plan, 2)}
    jplan = j_plan(("dp", "mp"))
    for name, kind in cuts.items():
        jspec = tuple(jplan.spec_for(name + ".weight"))
        if kind == "column":
            assert jspec[-1] == "mp", name         # JAX (in, out): out
        elif kind == "row":
            assert jspec[0] == "mp", name          # JAX (in, out): in
        else:
            assert name.endswith("embed_tokens") and jspec[0] == "mp"
    assert cuts["lm_head"] == "column"
    assert cuts["model.layers.0.self_attn.o_proj"] == "row"
    assert cuts["model.embed_tokens"] == "vocab"
    assert len(cuts) == 9
