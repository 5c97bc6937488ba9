"""FSDP / ZeRO across processes: the Trainer on {"fsdp": 2},
{"dp": 2, "fsdp": 2} and {"fsdp": 2, "mp": 2} meshes
(paddle_tpu_torch/distributed/sharding.py, parallel/{plan,trainer}.py,
the optimizer's norms over the cut groups), `group_sharded_parallel`,
`save_group_sharded_model` and `offload_opt_state`, against the JAX
package on the CPU; and the one-rank dp step, which issues no collective.

The jobs: the port's launcher starts paddle_tpu_torch/distributed/
launch/smoke.py as 2, 4 and 4 gloo workers with `--mesh fsdp:2`,
`dp:2,fsdp:2` and `fsdp:2,mp:2`, all at once in a module-scoped fixture,
while this process computes the JAX references. Every worker loads the
JAX model's weights (tiny_llama_config(num_hidden_layers=2), seed 0) for
each of smoke.TP_VARIANTS (dense and blockwise loss, tied and untied,
unfused and fused projections, two with ClipGradByGlobalNorm and the
health probe) and takes the same global batches, rows 0-3 labelled -100
from column 20. The JAX side is `Trainer(mesh=init_mesh(axes),
plan=llama_sharding_plan(...))` on this process's virtual CPU devices,
f32 compute.

Tolerances (f32): losses and the probe's gradient norm within 1e-5
relative, step 1's gathered gradients within 1e-5 of each tensor's
largest entry (tests/test_torch_tp.py's rules); the checkpoint's
tensors within 1e-5 of each tensor's largest entry of the JAX mesh
Trainer's after the same steps. Each planted fault must read outside
the gradient rule: a reducer that sums the reduce-scattered gradients
again over the batch group, and a gather whose backward keeps this
rank's piece of its own gradient without the reduce-scatter.
"""
import json
import os
import subprocess
import sys
import warnings

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
from paddle_tpu.distributed.sharding import (
    group_sharded_parallel as j_group_sharded,
    save_group_sharded_model as j_save_group_sharded)
from paddle_tpu.jit.functional import functional_call, state_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu.parallel import TrainStepConfig as JStepConfig
from paddle_tpu.parallel import llama_sharding_plan as j_plan
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import mesh as t_mesh
from paddle_tpu_torch.distributed import sharding as t_sharding
from paddle_tpu_torch.distributed.launch.smoke import (
    LAYERS, LR, SEQ_LR, TP_CKPT_AT, TP_CKPT_VARIANT, TP_CLIP, TP_STEPS,
    TP_VARIANTS, seq_x, smoke_batches)
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.framework import io_utils as t_io
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.parallel import plan as tplan
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "paddle_tpu_torch", "distributed", "launch",
                     "smoke.py")
JOB_TIMEOUT_S = 300
MESHES = {"fsdp:2": {"fsdp": 2}, "dp:2,fsdp:2": {"dp": 2, "fsdp": 2},
          "fsdp:2,mp:2": {"fsdp": 2, "mp": 2}}
VOCAB = 256
CLIPPED = [n for n, (_, clip) in TP_VARIANTS.items() if clip]
SEQ_SEED = 3


def _jcfg(name):
    return jllama.tiny_llama_config(num_hidden_layers=LAYERS,
                                    **TP_VARIANTS[name][0])


def _tcfg(name):
    return tllama.tiny_llama_config(num_hidden_layers=LAYERS,
                                    **TP_VARIANTS[name][0])


def _jmodel(name):
    paddle_tpu.seed(0)
    return jllama.LlamaForCausalLM(_jcfg(name))


def _jseq():
    paddle_tpu.seed(SEQ_SEED)
    return jnn.Sequential(jnn.Linear(16, 16), jnn.Linear(16, 8))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each variant's JAX weights as DIR/{variant}.npz, and the
    Sequential's as DIR/sequential.npz, for the workers."""
    out = tmp_path_factory.mktemp("fsdpw")
    for name in TP_VARIANTS:
        np.savez(out / f"{name}.npz", **{
            k: np.asarray(v) for k, v in state_arrays(_jmodel(name)).items()})
    np.savez(out / "sequential.npz", **{
        k: np.asarray(v) for k, v in state_arrays(_jseq()).items()})
    return str(out)


def _world(mesh):
    return int(np.prod(list(MESHES[mesh].values())))


def _start(mesh, weights_dir, out):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--devices", ",".join(str(i) for i in range(_world(mesh))),
           "--log_dir", str(out / "logs"), SMOKE, "--out", str(out),
           "--device", "cpu", "--mesh", mesh, "--tp-weights", weights_dir]
    return subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=REPO))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, weights):
    """The three launcher jobs, started together; the JAX references are
    computed while they run. {mesh: (out dir, result, grads)}."""
    outs = {m: tmp_path_factory.mktemp("fsdp") for m in MESHES}
    procs = {m: _start(m, weights, outs[m]) for m in MESHES}
    try:
        for name in TP_VARIANTS:
            _jax_grads(name)
            for m in MESHES:
                _jax_run(name, m)
        _jax_eager_step(outs["fsdp:2"])
        _jax_dp_losses()
        codes = {m: p.wait(timeout=JOB_TIMEOUT_S) for m, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {}
    for m, out in outs.items():
        logs = "".join((out / "logs" / f).read_text()
                       for f in sorted(os.listdir(out / "logs")))
        assert codes[m] == 0, f"fsdp job {m} failed:\n{logs[-4000:]}"
        assert logs.count("SMOKE_OK") == _world(m)
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


_JAX_RUNS = {}


def _jax_run(name, mesh):
    """The JAX mesh Trainer's losses, probe norms and, for the
    checkpointed variant, its checkpoint state after TP_CKPT_AT steps
    (cached)."""
    key = (name, mesh)
    if key not in _JAX_RUNS:
        jm = _jmodel(name)
        clip = TP_VARIANTS[name][1]
        jmesh = j_init_mesh(MESHES[mesh])
        tr = JTrainer(jm, jopt.AdamW(
            learning_rate=LR, parameters=jm.parameters(),
            grad_clip=jnn.ClipGradByGlobalNorm(TP_CLIP) if clip else None),
            mesh=jmesh, plan=j_plan(jmesh.jax_mesh.axis_names),
            config=JStepConfig(compute_dtype=None, health_probe=clip))
        losses, probes, state = [], [], None
        for i, b in enumerate(smoke_batches(VOCAB, TP_STEPS)):
            losses.append(float(np.asarray(tr.step(b).numpy())))
            if tr.last_probe is not None:
                probes.append(float(np.asarray(tr.last_probe)[0]))
            if name == TP_CKPT_VARIANT and i + 1 == TP_CKPT_AT:
                st = tr.checkpoint_state()
                state = ({k: np.asarray(v) for k, v in st["params"].items()},
                         {k: {n: np.asarray(a) for n, a in s.items()}
                          for k, s in st["opt"].items()})
        _JAX_RUNS[key] = (losses, probes, state)
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


_JAX_EAGER = {}


def _jax_eager_step(out):
    """tests/test_fleet.py's eager step on the JAX side: the Sequential
    cut by group_sharded_parallel at "p_g_os" on a {"dp": 2} mesh, one
    AdamW step on the summed output over SEQ_X, saved to DIR/jax_gs;
    {name: parameter after it}."""
    if not _JAX_EAGER:
        model = _jseq()
        opt = jopt.AdamW(learning_rate=SEQ_LR, parameters=model.parameters())
        with j_init_mesh({"dp": 2}):
            model, opt, _ = j_group_sharded(model, opt, "p_g_os")
            loss = model(paddle_tpu.to_tensor(seq_x())).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            j_save_group_sharded(model, str(out / "jax_gs"), opt)
        _JAX_EAGER.update({k: np.asarray(v)
                           for k, v in state_arrays(model).items()})
    return _JAX_EAGER


_JAX_DP = []


def _jax_dp_losses():
    """The dense variant's losses on the JAX {"dp": 2} mesh Trainer."""
    if not _JAX_DP:
        jm = _jmodel("dense")
        jmesh = j_init_mesh({"dp": 2})
        tr = JTrainer(jm, jopt.AdamW(learning_rate=LR,
                                     parameters=jm.parameters()),
                      mesh=jmesh, plan=j_plan(jmesh.jax_mesh.axis_names),
                      config=JStepConfig(compute_dtype=None))
        _JAX_DP.extend(float(np.asarray(tr.step(b).numpy()))
                       for b in smoke_batches(VOCAB, TP_STEPS))
    return _JAX_DP


def _gap(got, want):
    """The largest |got - want| over want's largest entry, over the
    tensors of `want` ({name: array})."""
    return max(float(np.abs(np.asarray(got[n]) - np.asarray(w)).max())
               / max(float(np.abs(np.asarray(w)).max()), 1e-30)
               for n, w in want.items())


def _grads_of(grads, prefix):
    return {k.split("/", 1)[1]: v for k, v in grads.items()
            if k.startswith(prefix + "/")}


def _torch_np(state):
    return {k: v.numpy() for k, v in state.items()}


# -- the one-rank dp fault ---------------------------------------------------

def test_one_rank_dp_step_issues_no_collective(monkeypatch):
    """A {"dp": 1} mesh: no reducer and no token count, so a step runs no
    collective, and its losses are bit-equal to the mesh-free run's."""
    import torch.distributed as tdist
    batch = smoke_batches(VOCAB, 1)[0]
    losses = {}
    for mesh in (None, t_mesh.init_mesh({"dp": 1})):
        model = tllama.LlamaForCausalLM(
            tllama.tiny_llama_config(num_hidden_layers=1), device="cpu")
        tr = Trainer(model, topt.AdamW(parameters=model.named_parameters()),
                     TrainStepConfig(compute_dtype=None), mesh=mesh,
                     plan=None if mesh is None
                     else tplan.llama_sharding_plan(mesh.dim_names))
        calls = []
        for name in ("all_reduce", "all_gather", "reduce_scatter",
                     "broadcast", "all_gather_into_tensor",
                     "reduce_scatter_tensor"):
            orig = getattr(tdist, name)
            monkeypatch.setattr(tdist, name, lambda *a, _o=orig, _n=name,
                                **k: (calls.append(_n), _o(*a, **k))[1])
        losses[mesh is None] = [float(tr.step(batch)) for _ in range(2)]
        monkeypatch.undo()
        assert calls == [], calls
    assert losses[True] == losses[False]


# -- the jobs -----------------------------------------------------------------

def test_fsdp_job_world(job):
    mesh, _, result, _ = job
    axes = MESHES[mesh]
    assert result["world"] == _world(mesh)
    assert result["backend"] == "gloo"
    assert result["mesh"] == [[k, v] for k, v in axes.items()]


@pytest.mark.parametrize("name", list(TP_VARIANTS))
def test_fsdp_losses_match_jax_mesh_trainer(job, name):
    mesh, _, result, _ = job
    got = result["variants"][name]["losses"]
    assert len(got) == TP_STEPS
    np.testing.assert_allclose(got, _jax_run(name, mesh)[0], rtol=1e-5)


@pytest.mark.parametrize("name", CLIPPED)
def test_fsdp_clip_norms_match_jax_probe(job, name):
    """The clip's global norm, read by the probe: the pieces' squares
    summed over fsdp (and mp), the replicated ones counted once."""
    mesh, _, result, _ = job
    np.testing.assert_allclose(result["variants"][name]["probes"],
                               _jax_run(name, mesh)[1], rtol=1e-5)


@pytest.mark.parametrize("name", list(TP_VARIANTS))
def test_fsdp_step1_gathered_gradients_match_jax(job, name):
    _, _, _, grads = job
    want = _jax_grads(name)
    got = _grads_of(grads, name)
    assert set(got) == set(want)
    assert _gap(got, want) <= 1e-5


def test_fsdp_pieces_and_replicas(job):
    """The plan's 'fsdp' entries by meaning: q/k/v/gate/up, lm_head and
    the embedding cut on D (the port's input columns / the table's
    columns), o/down on their output rows, after any mp cut; the norms
    whole and bit-equal on every rank after the steps."""
    mesh, _, result, _ = job
    mp = MESHES[mesh].get("mp", 1)
    for name, v in result["variants"].items():
        assert v["replicated_equal"], name
        cfg = _tcfg(name)
        d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
        kv = cfg.num_key_value_heads * hd
        shapes = v["local_shapes"]
        assert shapes["model.embed_tokens.weight"] == [VOCAB // mp, d // 2]
        assert shapes["model.norm.weight"] == [d]
        assert shapes["model.layers.0.input_layernorm.weight"] == [d]
        attn = "model.layers.0.self_attn."
        mlp = "model.layers.0.mlp."
        if cfg.fuse_attention_qkv:
            assert shapes[attn + "qkv_proj.weight"] == [(d + 2 * kv) // mp,
                                                        d // 2]
            assert shapes[mlp + "gate_up_fused_proj.weight"] == [
                2 * f // mp, d // 2]
        else:
            assert shapes[attn + "q_proj.weight"] == [d // mp, d // 2]
            assert shapes[attn + "k_proj.weight"] == [kv // mp, d // 2]
            assert shapes[mlp + "up_proj.weight"] == [f // mp, d // 2]
        assert shapes[attn + "o_proj.weight"] == [d // 2, d // mp]
        assert shapes[mlp + "down_proj.weight"] == [d // 2, f // mp]
        if not cfg.tie_word_embeddings:
            assert shapes["lm_head.weight"] == [VOCAB // mp, d // 2]


def test_planted_double_sum_reads_outside_the_gradient_bound(job):
    """The reducer summing the reduce-scattered gradients again over the
    batch group (it adds other ranks' pieces to this one's)."""
    _, _, _, grads = job
    assert _gap(_grads_of(grads, "fsdp_double"), _jax_grads("dense")) > 1e-5


def test_planted_local_gather_backward_reads_outside_the_gradient_bound(job):
    """The gather's backward keeping this rank's piece of its own
    gradient: the other fsdp rank's rows are missing from it."""
    _, _, _, grads = job
    assert _gap(_grads_of(grads, "fsdp_local"), _jax_grads("dense")) > 1e-5


def test_nonfinite_skip_agrees_across_the_fsdp_ranks(job):
    """A NaN in rank 1's lm_head gradient piece only: the skip flag is
    taken over the fsdp (and mp) groups, so every rank skips."""
    _, _, result, _ = job
    assert result["skip"] == [[1.0, 1.0]] * result["world"]


def test_fleet_sharding_degree_runs_fsdp(job):
    """fleet.init with sharding_degree 2 (and the mesh's dp and mp
    degrees), distributed_model, the Trainer on the fleet mesh: the
    plan's cuts and losses, and the JAX HybridCommunicateGroup's view of
    rank 0 of the same topology."""
    mesh, _, result, _ = job
    axes = MESHES[mesh]
    fl = result["fleet"]
    np.testing.assert_allclose(fl["losses"],
                               result["variants"]["dense"]["losses"],
                               rtol=1e-6)
    dp, fsdp, mp = axes.get("dp", 1), axes["fsdp"], axes.get("mp", 1)
    assert fl["mesh"] == [["dp", "pp", "fsdp", "sp", "mp"],
                          [dp, 1, fsdp, 1, mp]]
    assert fl["worker"] == [0, dp * fsdp * mp, True]
    dims = fl["fsdp_dims"]
    assert dims["model.embed_tokens.weight"] == 1
    assert dims["lm_head.weight"] == 1
    assert dims["model.layers.1.self_attn.q_proj.weight"] == 1
    assert dims["model.layers.1.self_attn.o_proj.weight"] == 0
    assert dims["model.layers.1.mlp.down_proj.weight"] == 0
    assert "model.norm.weight" not in dims
    hcg = HybridCommunicateGroup(CommunicateTopology(
        ["data", "pipe", "sharding", "sep", "model"], [dp, 1, fsdp, 1, mp]),
        global_rank=0)
    assert fl["hcg"] == {
        "dp_rank": hcg.get_data_parallel_rank(),
        "mp_rank": hcg.get_model_parallel_rank(),
        "dp_group": hcg.get_data_parallel_group(),
        "mp_group": hcg.get_model_parallel_group(),
        "mp_world": hcg.get_model_parallel_world_size(),
        "dp_world": hcg.get_data_parallel_world_size()}
    assert fl["sharding"] == [hcg.get_sharding_parallel_rank(),
                              hcg.get_sharding_parallel_world_size()]


def _one_process_trainer():
    cfg = _tcfg(TP_CKPT_VARIANT)
    model = tllama.LlamaForCausalLM(cfg, device="cpu", seed=5)
    return Trainer(model, topt.AdamW(learning_rate=LR,
                                     parameters=model.named_parameters()),
                   TrainStepConfig(compute_dtype=None))


def test_fsdp_checkpoint_loads_in_one_process_and_continues(job):
    """The checkpoint the ranks wrote after step 2 holds whole tensors: a
    mesh-free Trainer loads it and its step 3 gives the uninterrupted
    run's loss."""
    _, out, result, _ = job
    tr = _one_process_trainer()
    tr.load_checkpoint(os.path.join(out, "ckpt"))
    rest = [float(tr.step(b))
            for b in smoke_batches(VOCAB, TP_STEPS)[TP_CKPT_AT:]]
    np.testing.assert_allclose(
        rest, result["variants"][TP_CKPT_VARIANT]["losses"][TP_CKPT_AT:],
        rtol=1e-5)


def test_fsdp_checkpoint_tensors_match_jax_mesh_trainer(job):
    """The checkpoint's parameters and moments: the JAX mesh Trainer's
    after the same steps, in the port's layout. The parameters within
    1e-5 absolute, 1 % of the learning rate (tests/test_torch_dp.py's
    rule: Adam divides each gradient entry by its own root mean square,
    so an entry near 0 moves by up to the rate on a rounding of its
    gradient). The moments within 5e-5 of each tensor's largest entry:
    step 2's gradients are taken at parameters that already differ so,
    and the mesh-free port Trainer itself reads 1.5e-5 to 2.5e-5 against
    the JAX mesh Trainers here (moment1; step 1's gradients are held to
    1e-5 above)."""
    mesh, out, _, _ = job
    tr = _one_process_trainer()
    tr.load_checkpoint(os.path.join(out, "ckpt"))
    got = tr.checkpoint_state()
    jparams, jopt_state = _jax_run(TP_CKPT_VARIANT, mesh)[2]
    cfg = _tcfg(TP_CKPT_VARIANT)
    want = from_paddle_tpu_state(jparams, cfg)
    assert set(got["params"]) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got["params"][n].numpy(), w.numpy(),
                                   rtol=0, atol=1e-5, err_msg=n)
    for key in ("moment1", "moment2"):
        want = from_paddle_tpu_state(
            {n: s[key] for n, s in jopt_state.items()}, cfg)
        assert _gap({n: got["opt"][n][key].numpy() for n in want},
                    _torch_np(want)) <= 5e-5, key
    for n, s in jopt_state.items():
        np.testing.assert_allclose(float(got["opt"][n]["beta1_pow"]),
                                   float(np.asarray(s["beta1_pow"]).reshape(
                                       ())), rtol=1e-6)


def test_fsdp_checkpoint_loads_back_onto_the_mesh(job):
    """The whole checkpoint cut back into a fresh Trainer's pieces on the
    same mesh: its next step gives the uninterrupted run's loss."""
    _, _, result, _ = job
    want = result["variants"][TP_CKPT_VARIANT]["losses"][TP_CKPT_AT]
    np.testing.assert_allclose(result["resumed"], want, rtol=1e-5)


# -- group_sharded_parallel and save_group_sharded_model ---------------------

def _tiny(**overrides):
    return tllama.LlamaForCausalLM(
        tllama.tiny_llama_config(num_hidden_layers=1, **overrides),
        device="cpu")


def test_group_sharded_parallel_rejects_a_bad_level():
    model = torch.nn.Linear(4, 4)
    opt = topt.AdamW(parameters=model.named_parameters())
    with ProcessMesh([0, 1], ["dp"]):
        with pytest.raises(ValueError, match="level"):
            t_sharding.group_sharded_parallel(model, opt, "bogus")


def test_group_sharded_parallel_needs_a_mesh(monkeypatch):
    monkeypatch.setattr(t_mesh, "_current_mesh", [])
    model = torch.nn.Linear(4, 4)
    opt = topt.AdamW(parameters=model.named_parameters())
    with pytest.raises(RuntimeError, match="active mesh"):
        t_sharding.group_sharded_parallel(model, opt, "p_g_os")


@pytest.mark.parametrize("axes", [
    {"dp": 2, "fsdp": 2}, {"dp": 2, "fsdp": 1}, {"dp": 1, "mp": 4},
    {"mp": 2, "dp": 4}])
def test_group_sharded_axis_choice(axes):
    """'fsdp' if it has extent > 1, else 'dp', else the largest axis: the
    JAX function's choice, read at "os" (nothing is placed, no group)."""
    shape = list(axes.values())
    pmesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                        list(axes))
    model = torch.nn.Linear(4, 4)
    opt = topt.AdamW(parameters=model.named_parameters())
    with pmesh:
        m, o, _ = t_sharding.group_sharded_parallel(model, opt, "os",
                                                    offload=True)
    jm = _jseq()
    with j_init_mesh(axes):
        jm, jo, _ = j_group_sharded(jm, jopt.AdamW(
            parameters=jm.parameters()), "os")
    assert m._sharding_axis == jm._sharding_axis
    assert m._sharding_level == o._sharding_level == "os"
    assert m._sharding_offload and o._sharding_offload
    assert list(model.weight.shape) == [4, 4]        # nothing placed


def test_group_sharded_p_g_os_eager_step_matches_jax(jobs):
    """p_g_os at {"dp": 2}: every parameter cut along its largest dim,
    one eager AdamW step on each rank's rows (a summed loss) gives the
    JAX eager step on the whole batch."""
    _, result, _ = jobs["fsdp:2"]
    gs = result["group_sharded"]
    assert gs["axis"] == "dp"
    assert gs["local_shapes"] == {"0.weight": [8, 16], "0.bias": [8],
                                  "1.weight": [8, 8], "1.bias": [4]}
    want = _jax_eager_step(jobs["fsdp:2"][0])
    for name, w in want.items():
        got = np.asarray(gs["params"][name], dtype=np.float32)
        if name.endswith("weight"):
            got = got.T
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, err_msg=name)


def test_save_group_sharded_model_matches_jax_file(jobs):
    """The .pdparams holds the whole weights, equal to the JAX file's
    (the port's Linear weights transposed); the .pdopt holds the whole
    moments."""
    out = jobs["fsdp:2"][0]
    _jax_eager_step(out)
    got = t_io.load(str(out / "gs.pdparams"))
    want = paddle_tpu.load(str(out / "jax_gs.pdparams"))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        if name.endswith("weight"):
            g = g.T
        np.testing.assert_allclose(g, np.asarray(w.numpy()), rtol=0,
                                   atol=1e-6, err_msg=name)
    opt = t_io.load(str(out / "gs.pdopt"))
    assert list(opt["0.weight"]["moment1"].shape) == [16, 16]
    assert float(opt["1.bias"]["beta1_pow"]) == pytest.approx(0.9)


def test_group_sharded_model_trains_through_the_trainer(jobs):
    """The dense variant cut by p_g_os over 'dp' and trained by the
    Trainer with plan=None: the reducer does not sum those gradients a
    second time, so the losses are the JAX {"dp": 2} mesh Trainer's."""
    _, result, _ = jobs["fsdp:2"]
    np.testing.assert_allclose(result["group_sharded"]["trainer_losses"],
                               _jax_dp_losses(), rtol=1e-5)


# -- the plan, one process ----------------------------------------------------

def test_plan_maps_fsdp_by_meaning():
    """The JAX (in, out) 'fsdp' entries on the port's (out, in) weights:
    a Linear's JAX dim i is the port's dim 1 - i, the embedding's dims
    are the JAX ones; the norms stay whole."""
    model = _tiny(tie_word_embeddings=False)
    plan = tplan.llama_sharding_plan(["fsdp", "mp"])
    cuts = {f"{m}.{p}": d for m, p, d in tplan._fsdp_cuts(model, plan, 2)}
    jplan = j_plan(("fsdp", "mp"))
    linears = {n for n, mod in model.named_modules()
               if isinstance(mod, torch.nn.Linear)}
    for name, dim in cuts.items():
        jdim = list(jplan.spec_for(name)).index("fsdp")
        module = name.rsplit(".", 1)[0]
        assert dim == (1 - jdim if module in linears else jdim), name
    assert cuts["model.embed_tokens.weight"] == 1
    assert cuts["model.layers.0.self_attn.o_proj.weight"] == 0
    assert cuts["model.layers.0.mlp.gate_proj.weight"] == 1
    assert cuts["lm_head.weight"] == 1
    assert not any("norm" in n for n in cuts)
    assert len(cuts) == 9


def test_non_divisible_fsdp_dim_raises_before_any_cut():
    """The JAX package pads such a dim; the port refuses it, naming the
    parameter, before it forms a group or cuts anything."""
    model = _tiny(hidden_size=66, num_attention_heads=2,
                  num_key_value_heads=1)
    before = {n: p.shape for n, p in model.named_parameters()}
    mesh = ProcessMesh([0, 1, 2, 3], ["fsdp"])
    with pytest.raises(ValueError, match="embed_tokens.*fsdp extent 4"):
        tplan.apply_plan(model, mesh, tplan.llama_sharding_plan(["fsdp"]))
    assert {n: p.shape for n, p in model.named_parameters()} == before


# -- offload_opt_state, on the CPU -------------------------------------------

def test_offload_degrades_gracefully_on_cpu():
    """As tests/test_offload.py: a warning naming pinned_host, the flag
    off on the Trainer's copy of the config (the caller's stays), and
    the Trainer still trains."""
    model = tllama.LlamaForCausalLM(
        tllama.tiny_llama_config(num_hidden_layers=2), device="cpu", seed=1)
    opt = topt.AdamW(learning_rate=1e-3, parameters=model.named_parameters())
    cfg = TrainStepConfig(compute_dtype=None, offload_opt_state=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = Trainer(model, opt, cfg)
    assert any("pinned_host" in str(wi.message) for wi in w)
    assert tr.config.offload_opt_state is False
    assert cfg.offload_opt_state is True
    ids = np.random.RandomState(0).randint(0, 256, (4, 32)).astype(np.int32)
    l0 = float(tr.step({"input_ids": ids, "labels": ids}))
    l1 = float(tr.step({"input_ids": ids, "labels": ids}))
    assert np.isfinite([l0, l1]).all() and l1 < l0
    assert opt.state["lm_head.weight"]["moment1"].device.type == "cpu"
    assert not opt._parked


def test_group_sharded_offload_hint_reaches_trainer():
    model = tllama.LlamaForCausalLM(
        tllama.tiny_llama_config(num_hidden_layers=2), device="cpu", seed=2)
    opt = topt.AdamW(learning_rate=1e-3, parameters=model.named_parameters())
    with ProcessMesh(list(range(8)), ["dp"]):
        m2, o2, _ = t_sharding.group_sharded_parallel(model, opt, "os_g",
                                                      offload=True)
    assert m2._sharding_offload and o2._sharding_offload
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = Trainer(m2, o2)           # takes the hint, then turns it off
    assert any("pinned_host" in str(wi.message) for wi in w)
    assert tr.config.offload_opt_state is False


def test_save_and_load_tag_bfloat16():
    """framework/io_utils.py: a bf16 tensor is stored as f32 tagged
    'bfloat16', as the JAX module stores it, and comes back bf16."""
    import io
    buf = io.BytesIO()
    t = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    t_io.save({"a": t, "b": [torch.arange(3)]}, buf)
    buf.seek(0)
    got = t_io.load(buf)
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], t)
    assert torch.equal(got["b"][0], torch.arange(3))
    buf.seek(0)
    payload = __import__("pickle").load(buf)["a"]
    assert payload.dtype_name == "bfloat16"
    assert payload.data.dtype == np.float32

