"""The port's Qwen2-MoE trained by the Trainer on a 'dp' axis across two
gloo processes (paddle_tpu_torch/nn/moe.py `batch_group`,
parallel/trainer.py) against the JAX package's dp-mesh Trainer, on the
CPU.

The gates' statistics belong to the global batch: the aux loss's means,
and on the capacity path the capacity and each expert's buffer
positions, which decide the tokens dropped. The JAX side is
`Trainer(mesh=init_mesh({"dp": 2}), plan=llama_sharding_plan(...))` on
this process's virtual CPU devices, f32 compute, where GSPMD keeps
those statistics global. The port's job (tests/_torch_moe_dp_worker.py)
runs as two gloo workers started once in a module-scoped fixture, while
this process computes the JAX references. Both sides take the JAX
model's weights (tiny_qwen2_moe_config, seed 0) and the same 3 global
batches of 4 x 16 ids, rows 0-1 labelled -100 from column 8, so the
ranks hold different counts of valid tokens (the aux term must still
count rank 0's whole rows). Runs: the capacity path at k = 2 with
capacity_factor 0.5 (tokens dropped at every step), the same with
grad_accum_steps 2, and the dropless path at k = 2.

Tolerances (f32, tests/test_torch_dp.py's and test_torch_fsdp.py's):
losses within 1e-5 relative; step 1's gradients, summed over the ranks,
within 1e-5 of each tensor's largest entry of `jax.value_and_grad` of
the global batch (the mean over its microbatches with grad_accum_steps).
The planted fault, each rank gating its own rows alone (the capacity
path), must read outside the loss tolerance.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.mesh import init_mesh as j_init_mesh
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.functional import functional_call, state_arrays
from paddle_tpu.models import qwen2_moe as jqwen
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu.parallel import TrainStepConfig as JStepConfig
from paddle_tpu.parallel import llama_sharding_plan as j_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_moe_dp_worker.py")
LR = 1e-3
STEPS = 3
JOB_TIMEOUT_S = 240
CAPACITY = dict(vocab_size=97, capacity_factor=0.5)
RUNS = [
    dict(name="capacity", config=CAPACITY, grad_accum_steps=1),
    dict(name="capacity_accum", config=CAPACITY, grad_accum_steps=2),
    dict(name="dropless", config=dict(vocab_size=97, moe_dropless=True),
         grad_accum_steps=1),
]
PLANTED = dict(name="planted", config=CAPACITY, grad_accum_steps=1)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jmodel(config):
    paddle_tpu.seed(0)
    return jqwen.Qwen2MoeForCausalLM(jqwen.tiny_qwen2_moe_config(**config))


def _batches():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 97, (STEPS, 4, 16)).astype(np.int32)
    labels = ids.copy()
    labels[:, 0:2, 8:] = -100
    return ids, labels


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The port's two ranks, started once; joined after the JAX runs."""
    tmp = tmp_path_factory.mktemp("moe_dp")
    weights = {}
    for run in RUNS + [PLANTED]:
        path = tmp / f"w_{run['name']}.npz"
        np.savez(path, **{k: np.asarray(v) for k, v in
                          state_arrays(_jmodel(run["config"])).items()})
        weights[run["name"]] = str(path)
    ids, labels = _batches()
    np.savez(tmp / "batches.npz", input_ids=ids, labels=labels)
    spec = dict(weights=weights, batches=str(tmp / "batches.npz"), lr=LR,
                out=str(tmp), runs=[dict(r, planted=False) for r in RUNS]
                + [dict(PLANTED, planted=True)])
    (tmp / "job.json").write_text(json.dumps(spec))
    # the world's variables as the launcher sets them, none inherited
    # from what ran before in this process
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")
           and k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, PADDLE_TRAINERS_NUM="2",
               PADDLE_MASTER=f"127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(tmp / "job.json")],
        env=dict(env, PADDLE_TRAINER_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    yield tmp, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def results(job):
    tmp, procs = job
    for p in procs:
        out, _ = p.communicate(timeout=JOB_TIMEOUT_S)
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    ranks = [json.loads((tmp / f"{r}.json").read_text()) for r in range(2)]
    return tmp, ranks


def _jax_run(run):
    jm = _jmodel(run["config"])
    mesh = j_init_mesh({"dp": 2})
    tr = JTrainer(jm, jopt.AdamW(learning_rate=LR,
                                 parameters=jm.parameters()),
                  mesh=mesh, plan=j_plan(mesh.jax_mesh.axis_names),
                  config=JStepConfig(compute_dtype=None,
                                     grad_accum_steps=run["grad_accum_steps"]))
    ids, labels = _batches()
    return [float(np.asarray(tr.step({"input_ids": ids[i],
                                      "labels": labels[i]}).numpy()))
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def jax_runs(job):
    """The JAX dp-mesh Trainer's losses, computed while the workers run."""
    return {run["name"]: _jax_run(run) for run in RUNS}


@pytest.mark.parametrize("name", [r["name"] for r in RUNS])
def test_moe_dp_losses_match_jax_mesh_trainer(jax_runs, results, name):
    _, ranks = results
    want = jax_runs[name]
    for got in ranks:
        np.testing.assert_allclose(got[name], want, rtol=1e-5)
    assert want[-1] < want[0]


def _jax_grads(run):
    """jax.value_and_grad of step 1's global batch (the mean over its
    microbatches), in the port's layout."""
    from paddle_tpu_torch.models import qwen2_moe
    from paddle_tpu_torch.models.convert import from_paddle_tpu_state
    jm = _jmodel(run["config"])
    ids, labels = _batches()
    n_mb = run["grad_accum_steps"]

    def jloss(params):
        total = 0.0
        for ib, lb in zip(np.split(ids[0], n_mb), np.split(labels[0], n_mb)):
            out = functional_call(jm, params,
                                  input_ids=JTensor(jnp.asarray(ib)),
                                  labels=JTensor(jnp.asarray(lb)))
            total = total + out[0]._value.astype(jnp.float32)
        return total / n_mb

    _, g = jax.value_and_grad(jloss)(state_arrays(jm))
    return from_paddle_tpu_state(
        {k: np.asarray(v) for k, v in g.items()},
        qwen2_moe.tiny_qwen2_moe_config(**run["config"]))


@pytest.mark.parametrize("run", RUNS, ids=[r["name"] for r in RUNS])
def test_moe_dp_step1_gradients_match_jax(results, run):
    tmp, _ = results
    want = _jax_grads(run)
    for r in range(2):
        with np.load(tmp / f"{r}_{run['name']}.npz") as f:
            assert set(f.files) == set(want)
            for k in f.files:
                w = want[k].numpy()
                scale = max(float(np.abs(w).max()), 1e-30)
                err = float(np.abs(f[k] - w).max())
                assert err <= 1e-5 * scale, (r, k, err, scale)


def test_local_gating_reads_outside_the_loss_tolerance(jax_runs, results):
    """Each rank gating its own rows (capacity and positions over its 32
    tokens, the aux loss's means over them) drops other tokens than the
    JAX Trainer."""
    _, ranks = results
    got = np.asarray(ranks[0]["planted"])
    want = np.asarray(jax_runs["capacity"])
    assert np.max(np.abs(got - want) / np.abs(want)) > 1e-5 * 10
