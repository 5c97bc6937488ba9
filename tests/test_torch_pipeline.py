"""Pipeline parallelism (paddle_tpu_torch/parallel/pipeline.py) across
processes, against the JAX package's paddle_tpu/parallel/pipeline.py on
the CPU.

The job: the port's launcher starts paddle_tpu_torch/distributed/launch/
pp_smoke.py as eight gloo workers in a module-scoped fixture, while this
process runs the JAX PipelineTrainer of every case on its eight virtual
CPU devices (tests/test_pipeline.py's setup: the tiny Llama, seed 7,
f32, the same schedule, mesh and microbatches; each JAX trainer built
once, its step and its gradient function jitted). Rules: the losses
within 1e-5 relative; each rank's stage parameters after the steps, and
its step 1 gradients (the JAX pipeline's own gradient function), within
1e-5 of each tensor's largest entry.

The optimizer is AdamW(0.1, epsilon=1), not test_pipeline.py's
AdamW(1e-3): with epsilon 1e-8 an entry whose gradient lies near epsilon
moves by up to the learning rate on f32 rounding (1.4e-4 of a tensor's
largest entry after 3 steps, step 1's gradients within 1.1e-6), and a
clip's scale cancels in Adam's ratio; with epsilon 1 the update is
about 0.1 x the clipped gradient, so the parameters after the steps
follow the gradients and the clip linearly.

Cases (pp_smoke.CASES): 1F1B and GPipe on {pp 4, dp 2}; VPP (v 2) at 8
layers, M 8; ragged -100 labels at M 8 on {pp 2, dp 4}; 10 layers over
4 stages (3/3/2/2) with tied embeddings and a ClipGradByGlobalNorm clip
whose norm spans the stages (the tied copy counted once); custom
stage_boundaries (0, 4, 5); the ragged case again on
fleet.init(pp_degree=2)'s mesh. The batches have rows
enough for every microbatch to split over 'dp' (the port refuses a
microbatch of fewer rows than dp ranks; the JAX package replicates it).
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
import paddle_tpu.optimizer as jopt
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.mesh import init_mesh as j_init_mesh
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel import llama_sharding_plan as j_plan
from paddle_tpu.parallel import pipeline as jpp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.launch import pp_smoke as pp
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.parallel import pipeline as tpp
from paddle_tpu_torch.parallel import plan as tplan
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "paddle_tpu_torch", "distributed", "launch",
                      "pp_smoke.py")
JOB_TIMEOUT_S = 300
TOL = 1e-5
WORLD = 8
REFS = sorted(set(pp.REFERENCE.values()))


def _jmodel(case):
    c = pp.CASES[case]
    paddle_tpu.seed(pp.SEED)
    return jllama.LlamaForCausalLM(jllama.tiny_llama_config(
        num_hidden_layers=c["layers"], tie_word_embeddings=c.get("tie",
                                                                 False)))


def _jtrainer(model, mesh_axes, clip=None, **cfg_kw):
    mesh = j_init_mesh(mesh_axes)
    opt = jopt.AdamW(learning_rate=pp.LR, epsilon=pp.EPSILON,
                     parameters=model.parameters(),
                     grad_clip=None if clip is None
                     else jnn.ClipGradByGlobalNorm(clip))
    return jpp.PipelineTrainer(model, opt, mesh=mesh,
                               plan=j_plan(mesh.jax_mesh.axis_names),
                               config=jpp.PipelineConfig(**cfg_kw))


def _port_layout(tr, arrays, case):
    """The JAX trainer's {name: array} (stacked layer rows under
    STACK_PREFIX) as the port's {name: numpy} by its global names."""
    flat = {}
    for n, v in arrays.items():
        if not n.startswith(jpp.STACK_PREFIX):
            flat[n] = np.asarray(v)
            continue
        by_idx = tr._layer_groups[n[len(jpp.STACK_PREFIX):]]
        rows = range(len(by_idx)) if tr._even_stages else tr._slot_layers
        for row, li in enumerate(rows):
            if li >= 0:
                flat[by_idx[li]] = np.asarray(v[row])
    return {k: t.numpy() for k, t in from_paddle_tpu_state(
        flat, pp.case_config(case)).items()}


def _jax_case(case, model):
    """{"losses", "params", "grads"} of the JAX PipelineTrainer on
    `case`."""
    c = pp.CASES[case]
    kw = pp.pipeline_kwargs(case)
    tr = _jtrainer(model, c["mesh"], c.get("clip"), **kw)
    batch = pp.case_batch(case)
    if kw["schedule"] == "gpipe":
        fn = jax.value_and_grad(tr._loss_from_batch)
    elif kw["interleave"] > 1:
        fn = tr._pipeline_vpp_grads
    else:
        fn = tr._pipeline_1f1b_grads
    _, grads = jax.jit(fn)(tr.params, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    out = {"grads": _port_layout(tr, grads, case)}
    out["losses"] = [float(np.asarray(tr.step(batch).numpy()))
                     for _ in range(pp.STEPS)]
    out["params"] = _port_layout(tr, tr.params, case)
    return out


def _jax_refusals():
    """The JAX PipelineTrainer's messages for the job's refusals."""
    def message(fn):
        try:
            fn()
        except Exception as e:     # noqa: BLE001 — the message is the result
            return f"{type(e).__name__}: {e}"
        return None

    def model(layers):
        paddle_tpu.seed(0)
        return jllama.LlamaForCausalLM(
            jllama.tiny_llama_config(num_hidden_layers=layers))

    ids = np.zeros((32, 16), np.int32)
    batch = {"input_ids": ids, "labels": ids}
    pp2 = {"pp": 2, "dp": 4}
    out = {
        "bounds": message(lambda: _jtrainer(
            model(4), pp2, stage_boundaries=(0, 1, 2, 4))),
        "vpp_uneven": message(lambda: _jtrainer(
            model(5), pp2, num_microbatches=4, interleave=2))}
    tr = _jtrainer(model(4), {"pp": 4, "dp": 2}, compute_dtype=None,
                   num_microbatches=8, interleave=2)
    out["vpp_divisible"] = message(lambda: tr.step(batch))
    tr = _jtrainer(model(4), pp2, compute_dtype=None, grad_accum_steps=2)
    out["accum_1f1b"] = message(lambda: tr.step(batch))
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The eight-rank job, started first; the JAX references computed
    while it runs. (refs, [rank npz dicts], [rank results])."""
    wdir = tmp_path_factory.mktemp("ppw")
    models = {}
    for case in REFS:
        models[case] = _jmodel(case)
        np.savez(wdir / f"{case}.npz", **{
            k: np.asarray(v) for k, v in state_arrays(models[case]).items()})
    out = tmp_path_factory.mktemp("pp")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--devices", ",".join(str(i) for i in range(WORLD)),
         "--log_dir", str(out / "logs"), WORKER, "--out", str(out),
         "--weights", str(wdir), "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        refs = {case: _jax_case(case, models[case]) for case in REFS}
        refs["refusals"] = _jax_refusals()
        code = proc.wait(timeout=JOB_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    logs = "".join((out / "logs" / f).read_text()
                   for f in sorted(os.listdir(out / "logs")))
    assert code == 0, f"pipeline job failed:\n{logs[-4000:]}"
    assert logs.count("SMOKE_OK") == WORLD
    ranks, results = [], []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
        with open(out / f"rank{r}.json") as f:
            results.append(json.load(f))
    return refs, ranks, results


def _close(got, want, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-30)
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def _stages(case):
    c = pp.CASES[case]
    return 2 if c["mesh"] == "fleet" else c["mesh"]["pp"]


def _want_layers(case, s):
    """The stack indices stage s holds (the JAX split, without padding
    slots; VPP chunks l·S + s)."""
    c, S = pp.CASES[case], _stages(case)
    L, v = c["layers"], c.get("interleave", 1)
    if v > 1:
        k = L // (S * v)
        return [i for l in range(v) for i in range((l * S + s) * k,
                                                    (l * S + s + 1) * k)]
    b = c.get("stage_boundaries")
    if b is None:
        q, r = divmod(L, S)
        b = np.cumsum([0] + [q + (i < r) for i in range(S)])
    return list(range(int(b[s]), int(b[s + 1])))


# -- the job ------------------------------------------------------------------

@pytest.mark.parametrize("case", list(pp.CASES))
def test_pipeline_matches_the_jax_pipeline(job, case):
    """Every rank's losses, stage parameters after the steps and step 1
    gradients equal the JAX PipelineTrainer's of the same schedule."""
    refs, ranks, results = job
    want = refs[pp.REFERENCE[case]]
    for r in range(WORLD):
        res = results[r][case]
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=TOL,
                                   err_msg=f"{case} rank {r} losses")
        for n in res["names"]:
            _close(ranks[r][f"{case}/param/{n}"], want["params"][n],
                   f"{case} rank {r} {n} after {pp.STEPS} steps")
            _close(ranks[r][f"{case}/grad/{n}"], want["grads"][n],
                   f"{case} rank {r} {n} step 1 gradient")


@pytest.mark.parametrize("case", list(pp.CASES))
def test_each_rank_holds_its_stage(job, case):
    """Rank s holds stage s's layers (the first L % S stages one more,
    custom boundaries as given, VPP chunk l = global stage l·S + s),
    stage 0 the embedding, the last stage the final norm and the head
    (the tied embedding on both ends, no lm_head), nothing else."""
    _, _, results = job
    S = _stages(case)
    tie = pp.CASES[case].get("tie", False)
    for r in range(WORLD):
        res = results[r][case]
        s = res["stage"]
        assert res["layers"] == _want_layers(case, s), (case, r)
        ends = {n for n in res["names"] if not n.startswith("model.layers.")}
        want = set()
        if s == 0 or (tie and s == S - 1):
            want.add("model.embed_tokens.weight")
        if s == S - 1:
            want |= {"model.norm.weight"} | (set() if tie
                                             else {"lm_head.weight"})
        assert ends == want, (case, r, ends)


def _live_peak(tab, s):
    """Device s's most saved activations at once in the JAX tick tables
    (a tick's forward first, then its backward)."""
    live = peak = 0
    for t in range(len(tab["f_valid"])):
        live += int(tab["f_valid"][t, s])
        peak = max(peak, live)
        live -= int(tab["b_valid"][t, s])
    return peak


def test_in_flight_and_hops_per_rank(job):
    """Each rank's peak of held microbatches is 1F1B's min(M, S - s),
    GPipe's M, and VPP's the JAX tables' live slots on its device (at
    most (v + 1) S - 1); its hops a step are hops_per_step's."""
    _, _, results = job
    for case, c in pp.CASES.items():
        S, M, v = _stages(case), c["M"], c.get("interleave", 1)
        for r in range(WORLD):
            res = results[r][case]
            s = res["stage"]
            if v > 1:
                tab = jpp.build_interleaved_schedule(S, v, M)[0]
                want = _live_peak(tab, s)
                assert want <= (v + 1) * S - 1
            elif c.get("schedule") == "gpipe":
                want = M
            else:
                want = min(M, S - s)
            assert res["in_flight"] == want, (case, r, res["in_flight"])
            assert res["hops"] == tpp.hops_per_step(S, s, M, v), (case, r)


def test_probe_and_skip_span_the_stages(job):
    """The health probe's gradient norm is the whole model's (every
    stage's squares, the tied embedding once: the JAX gradients' norm),
    the same on every rank; NaN gradients on stage 0 alone make every
    stage skip the update."""
    refs, _, results = job
    want = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in refs["tied"]["grads"].values())))
    for r in range(WORLD):
        norm, applied = results[r]["tied"]["probe"]
        assert abs(norm - want) <= TOL * want and applied == 1.0, (r, norm,
                                                                   want)
        assert results[r]["skip"] == {"skipped": 1, "unchanged": True}, r


def test_refusals_match_the_jax_messages(job):
    """A bad split, an uneven stack under VPP, an interleave the stack
    does not divide (at the first step) and 1F1B with grad_accum_steps
    raise the JAX messages; checkpoints and the phase timing under 'pp'
    name the ROADMAP item they wait for."""
    refs, _, results = job
    for r in range(WORLD):
        got = results[r]["refusals"]
        for k, want in refs["refusals"].items():
            assert want is not None and got[k] == want, (r, k, got[k], want)
        for k in ("save", "load", "phases"):
            assert got[k].startswith("NotImplementedError") \
                and "ROADMAP.md queue 1 item 7.3b" in got[k], (r, k, got[k])


# -- in this process ----------------------------------------------------------

@pytest.mark.parametrize("S,v,M", [(4, 2, 8), (4, 1, 8), (2, 3, 4),
                                   (8, 2, 16), (2, 2, 2), (3, 2, 6)])
def test_interleaved_tables_equal_jax(S, v, M):
    got, want = (mod.build_interleaved_schedule(S, v, M)
                 for mod in (tpp, jpp))
    assert got[1:] == want[1:]
    assert got[0].keys() == want[0].keys()
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)


def test_interleaved_tables_refuse_like_jax():
    for mod in (tpp, jpp):
        with pytest.raises(ValueError, match="num_microbatches % pp"):
            mod.build_interleaved_schedule(4, 2, 6)


def _simulate(S, M, v, schedule):
    """Run every rank's units with sends that never block and a receive
    that waits for its message; returns each rank's peak of held units,
    or fails on a deadlock."""
    units = [tpp.schedule_units(S, s, M, v, schedule) for s in range(S)]
    at, held, peak = [0] * S, [set() for _ in range(S)], [0] * S
    box = set()           # (destination stage, kind, microbatch, chunk)
    while any(at[s] < len(units[s]) for s in range(S)):
        moved = False
        for s in range(S):
            if at[s] == len(units[s]):
                continue
            kind, m, l = units[s][at[s]]
            q = l * S + s
            need = None
            if kind == "F" and q > 0:
                need = (s, "F", m, l if s > 0 else l - 1)
            if kind == "B" and q < S * v - 1:
                need = (s, "B", m, l if s < S - 1 else l + 1)
            if need is not None and need not in box:
                continue
            box.discard(need)
            if kind == "F":
                held[s].add((m, l))
                if q < S * v - 1:
                    box.add(((s + 1) % S, "F", m, l))
            else:
                held[s].remove((m, l))
                if q > 0:
                    box.add(((s - 1) % S, "B", m, l))
            peak[s] = max(peak[s], len(held[s]))
            at[s] += 1
            moved = True
        assert moved, f"deadlock at {at} (S={S}, M={M}, v={v}, {schedule})"
    assert not box and not any(held)
    return peak


@pytest.mark.parametrize("S,M,v,schedule", [
    (4, 4, 1, "1f1b"), (4, 2, 1, "1f1b"), (2, 8, 1, "1f1b"),
    (8, 3, 1, "1f1b"), (4, 4, 1, "gpipe"), (4, 8, 2, "1f1b"),
    (2, 4, 3, "1f1b"), (3, 6, 2, "1f1b"), (1, 4, 1, "1f1b")])
def test_schedules_run_without_deadlock(S, M, v, schedule):
    """Every stage's units, each input awaited and each output sent
    without blocking, run to their end; every unit once; 1F1B holds
    min(M, S - s), GPipe M."""
    peak = _simulate(S, M, v, schedule)
    for s in range(S):
        units = tpp.schedule_units(S, s, M, v, schedule)
        assert sorted(u for u in units if u[0] == "F") == sorted(
            ("F", m, l) for m in range(M) for l in range(v))
        assert len(units) == 2 * M * v
        if v == 1:
            assert peak[s] == (M if schedule == "gpipe" else min(M, S - s))


def test_detect_layer_stack_on_the_port_llama():
    name, stack = tpp.detect_layer_stack(tllama.LlamaForCausalLM(
        tllama.tiny_llama_config(), device="cpu"))
    assert name == "model.layers" and len(stack) == 4
    with pytest.raises(ValueError) as got:
        tpp.detect_layer_stack(torch.nn.Linear(4, 4))
    with pytest.raises(ValueError) as want:
        jpp.detect_layer_stack(paddle_tpu.nn.Linear(4, 4))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(schedule="1F1B"), dict(interleave=0),
    dict(schedule="gpipe", interleave=2), dict(stage_boundaries=(0, 3, 3)),
    dict(stage_boundaries=(1, 3)), dict(stage_boundaries=(0,)),
    dict(stage_boundaries=(0, 2, 4), interleave=2)])
def test_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as got:
        tpp.PipelineConfig(**kw)
    with pytest.raises(ValueError) as want:
        jpp.PipelineConfig(**kw)
    assert str(got.value) == str(want.value)


def _tiny():
    return tllama.LlamaForCausalLM(tllama.tiny_llama_config(), device="cpu")


@pytest.mark.parametrize("axes,kw", [
    (["pp", "mp"], {}), (["pp", "fsdp"], {}), (["pp", "sp"], {}),
    (["pp", "dp"], dict(overlap_fsdp=True)),
    (["pp", "dp"], dict(offload_opt_state=True))])
def test_what_waits_names_the_roadmap(axes, kw):
    """'pp' with 'mp', 'fsdp' or 'sp', the overlap and offload raise
    NotImplementedError naming ROADMAP.md queue 1 item 7.3b, before any
    group is formed."""
    model = _tiny()
    mesh = ProcessMesh(np.arange(4).reshape(2, 2), axes)
    with pytest.raises(NotImplementedError, match="queue 1 item 7.3b"):
        tpp.PipelineTrainer(
            model, topt.AdamW(parameters=model.named_parameters()), mesh,
            tplan.llama_sharding_plan(mesh.dim_names),
            tpp.PipelineConfig(compute_dtype=None, **kw))


def test_plain_trainer_on_pp_names_the_pipeline_trainer():
    model = _tiny()
    mesh = ProcessMesh([[0, 1]], ["dp", "pp"])
    with pytest.raises(NotImplementedError, match="PipelineTrainer"):
        Trainer(model, topt.AdamW(parameters=model.named_parameters()),
                TrainStepConfig(compute_dtype=None), mesh=mesh,
                plan=tplan.llama_sharding_plan(mesh.dim_names))
    assert "pp" not in tplan.WAITS


def test_pipeline_plan_prepends_pp_like_jax():
    axes = ("pp", "dp", "mp")
    for local in ("model.layers.0.self_attn.q_proj.weight",
                  "model.layers.0.mlp.down_proj.weight",
                  "model.layers.0.input_layernorm.weight"):
        got = tpp.PipelinePlan(tplan.llama_sharding_plan(axes))
        want = jpp.PipelinePlan(j_plan(axes))
        for name in (tpp.STACK_PREFIX + local, local):
            assert tuple(got.spec_for(name)) == tuple(want.spec_for(name))


def test_pipeline_modules_import_without_jax_or_paddle_tpu():
    """The new modules, with every module the two earlier import checks
    load (tests/test_torch_prefetch.py, tests/test_torch_paged_engine.py),
    import neither jax nor the JAX package."""
    mods = [
        "paddle_tpu_torch", "paddle_tpu_torch.models.llama",
        "paddle_tpu_torch.models.convert", "paddle_tpu_torch.models",
        "paddle_tpu_torch.models.generation", "paddle_tpu_torch.core.graphs",
        "paddle_tpu_torch.inference.paged",
        "paddle_tpu_torch.inference.prefix",
        "paddle_tpu_torch.inference.overload",
        "paddle_tpu_torch.inference.tenancy",
        "paddle_tpu_torch.inference.kvtier",
        "paddle_tpu_torch.inference.disagg",
        "paddle_tpu_torch.observability",
        "paddle_tpu_torch.observability.metrics",
        "paddle_tpu_torch.observability.trace",
        "paddle_tpu_torch.observability.requests",
        "paddle_tpu_torch.inference.serving",
        "paddle_tpu_torch.inference.router",
        "paddle_tpu_torch.observability.fleet",
        "paddle_tpu_torch.inference.autopilot",
        "paddle_tpu_torch.observability.telemetry",
        "paddle_tpu_torch.io.prefetch", "paddle_tpu_torch.nn.clip",
        "paddle_tpu_torch.kernels.blockwise_ce",
        "paddle_tpu_torch.optimizer.lr",
        "paddle_tpu_torch.parallel.trainer",
        "paddle_tpu_torch.distributed.checkpoint",
        "paddle_tpu_torch.distributed.async_checkpoint",
        "paddle_tpu_torch.distributed.chaos",
        "paddle_tpu_torch.distributed.watchdog",
        "paddle_tpu_torch.distributed.store",
        "paddle_tpu_torch.distributed.elastic",
        "paddle_tpu_torch.distributed.sentry",
        "paddle_tpu_torch.distributed.env",
        "paddle_tpu_torch.distributed.collective",
        "paddle_tpu_torch.distributed.placement",
        "paddle_tpu_torch.distributed.mesh",
        "paddle_tpu_torch.distributed.parallel",
        "paddle_tpu_torch.distributed.launch",
        "paddle_tpu_torch.distributed.launch.smoke",
        "paddle_tpu_torch.distributed.api",
        "paddle_tpu_torch.distributed.fleet",
        "paddle_tpu_torch.distributed.fleet.topology",
        "paddle_tpu_torch.distributed.fleet.strategy",
        "paddle_tpu_torch.distributed.fleet.layers",
        "paddle_tpu_torch.distributed.fleet.utils",
        "paddle_tpu_torch.parallel.plan",
        "paddle_tpu_torch.distributed.sharding",
        "paddle_tpu_torch.parallel.overlap",
        "paddle_tpu_torch.distributed.context_parallel",
        "paddle_tpu_torch.distributed", "paddle_tpu_torch.framework",
        "paddle_tpu_torch.framework.io_utils",
        "paddle_tpu_torch.distributed.launch.ring_smoke",
        "paddle_tpu_torch.tools.p2p_probe",
        "paddle_tpu_torch.tools.ab_blockwise_ce",
        "paddle_tpu_torch.tools.ab_decode_tick",
        "paddle_tpu_torch.tools.ab_flash",
        "paddle_tpu_torch.tools.ab_fused_norm",
        "paddle_tpu_torch.tools.ab_paged_decode",
        "paddle_tpu_torch.tools.ab_w8a16",
        # this slice's
        "paddle_tpu_torch.parallel.pipeline",
        "paddle_tpu_torch.distributed.pipeline",
        "paddle_tpu_torch.distributed.launch.pp_smoke"]
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import paddle_tpu_torch.parallel as par\n"
        "assert par.PipelineTrainer.__module__ == "
        "'paddle_tpu_torch.parallel.pipeline'\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m.split('.')[0] in ('paddle_tpu', 'jax', 'jaxlib',"
        " 'ml_dtypes'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
