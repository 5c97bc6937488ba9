"""The port's Qwen2-MoE (paddle_tpu_torch/models/qwen2_moe.py) against the
JAX package's (paddle_tpu/models/qwen2_moe.py), on the CPU, for both
gating paths (GShard capacity at k = 2, dropless).

The JAX model's seeded weights are carried into the port by
`from_paddle_tpu_state` and both take the same numpy ids. Held, f32:
- the logits within 1e-5 of their largest entry, the loss (the dense
  next-token loss plus the router aux term) within 1e-5 relative, every
  gradient within 1e-5 of its largest entry;
- `generate`'s greedy tokens equal to JAX `generate`'s
  (tests/test_generation.py:371's model);
- the PagedKVEngine's greedy tokens with a request that joins mid-decode
  and shares the first one's prefix pages (the prefix cache on) equal
  to the JAX engine's (tests/test_paged_engine.py:344's pattern); idle
  slots go through the MoE in both engines;
- the Trainer's 3-step losses within 1e-5 relative of the JAX Trainer's;
- a mesh that would cut the stacked expert weights over 'mp', 'fsdp' or
  'ep', an 'sp' axis, and the PipelineTrainer raise NotImplementedError
  naming ROADMAP.md queue 1 item 7.5 before anything is cut; a
  `loss_chunk` (the blockwise loss, which the JAX model never takes)
  raises ValueError.
The Trainer on 'dp' is tests/test_torch_moe_dp.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.jit.functional import functional_call, state_arrays
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import qwen2_moe as jqwen
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu.parallel import TrainStepConfig as JStepConfig
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.models import Qwen2MoeForCausalLM
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import qwen2_moe as tqwen
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.parallel import plan as tplan
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig

TRAIN = dict(vocab_size=97, hidden_size=128, num_attention_heads=2,
             num_key_value_heads=1, use_flash_attention=True,
             fused_rope=True)
SERVE = dict(vocab_size=97, fused_rope=True)
PATHS = [pytest.param(False, id="capacity"), pytest.param(True, id="dropless")]


def _pair(dropless, seed=0, **kw):
    """(JAX model, port model with its weights, port config)."""
    paddle_tpu.seed(seed)
    jm = jqwen.Qwen2MoeForCausalLM(jqwen.tiny_qwen2_moe_config(
        moe_dropless=dropless, **kw))
    state = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    cfg = tqwen.tiny_qwen2_moe_config(moe_dropless=dropless, **kw)
    tm = Qwen2MoeForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(state, cfg))
    return jm, tm, cfg


def _ids(b=2, s=16, seed=0, vocab=97):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _rel(got, want, tol, name=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{name}: |err| {err} > {tol} x {scale}"


def test_conversion_transposes_the_linears_and_keeps_the_experts():
    jm, tm, cfg = _pair(True)
    state = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    got = from_paddle_tpu_state(state, cfg)
    assert set(got) == set(dict(tm.named_parameters()))
    pre = "model.layers.0.mlp."
    assert got[pre + "shared_expert_gate.weight"].shape == (1, 64)
    np.testing.assert_array_equal(
        got[pre + "shared_expert_gate.weight"].numpy(),
        state[pre + "shared_expert_gate.weight"].T)
    np.testing.assert_array_equal(
        got[pre + "shared_expert.down_proj.weight"].numpy(),
        state[pre + "shared_expert.down_proj.weight"].T)
    for name in ("router_weight", "experts_gate_weight",
                 "experts_down_weight"):
        np.testing.assert_array_equal(got[pre + "moe." + name].numpy(),
                                      state[pre + "moe." + name])
    assert got["lm_head.weight"].shape == (cfg.vocab_size, 64)
    with pytest.raises(ValueError, match="missing"):
        from_paddle_tpu_state({k: v for k, v in state.items()
                               if "router" not in k}, cfg)


@pytest.mark.parametrize("dropless", PATHS)
def test_model_logits_loss_and_gradients_match_jax(dropless):
    jm, tm, cfg = _pair(dropless, **TRAIN)
    ids = _ids()
    jstate = state_arrays(jm)

    def jloss(params):
        loss, logits = functional_call(jm, params,
                                       JTensor(jnp.asarray(ids)),
                                       labels=JTensor(jnp.asarray(ids)))
        return loss._value.astype(jnp.float32), logits._value

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jstate)
    tm.requires_grad_(True).train()
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert logits.shape == (2, 16, 97) and loss.dtype == torch.float32
    assert len(tm.model.aux_losses()) == cfg.num_hidden_layers
    loss.backward()
    _rel(logits.detach().numpy(), jlogits, 1e-5, "logits")
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = from_paddle_tpu_state({k: np.asarray(v)
                                  for k, v in jgrads.items()}, cfg)
    for name, p in tm.named_parameters():
        _rel(p.grad.numpy(), want[name].numpy(), 1e-5, name)


def test_recompute_keeps_the_loss_and_gradients():
    """Recompute reruns each layer in the backward: the aux term set by
    the first forward still carries its gradient."""
    _, tm, cfg = _pair(True, **TRAIN)
    ids = torch.from_numpy(_ids())
    grads = []
    for recompute in (False, True):
        tm.config.recompute = recompute
        tm.zero_grad(set_to_none=True)
        tm.requires_grad_(True).train()
        loss, _ = tm(ids, labels=ids)
        loss.backward()
        grads.append((float(loss.detach()),
                      {n: p.grad.clone() for n, p in tm.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for name, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][name], g, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("dropless", PATHS)
def test_generate_tokens_equal_jax(dropless):
    jm, tm, _ = _pair(dropless, seed=1, **SERVE)
    jm.eval()
    ids = _ids(b=2, s=8, seed=3)
    j = jgen.generate(jm, ids, max_new_tokens=6).numpy()
    t = tgen.generate(tm, ids, max_new_tokens=6)
    np.testing.assert_array_equal(t.numpy(), j)
    # the cached decode equals a full recompute, token for token
    np.testing.assert_array_equal(
        tm.generate(ids, max_new_tokens=6, use_cache=False).numpy(), j)


GEOM = dict(max_slots=2, page_size=4, num_pages=24, max_pages_per_slot=6,
            steps_per_tick=2, prefix_cache_pages=8)


def _drive(eng):
    ra = eng.submit([5, 9, 2, 14, 7, 30, 8, 1, 60], max_new_tokens=8)
    eng.step()
    # joins mid-decode of A and shares its first two pages
    rb = eng.submit([5, 9, 2, 14, 7, 30, 8, 1, 33, 12], max_new_tokens=6)
    eng.run_until_idle()
    rc = eng.submit([5, 9, 2, 14, 17, 3], max_new_tokens=5)
    eng.run_until_idle()
    return [ra.result(), rb.result(), rc.result()], eng.prefix_stats()


@pytest.mark.parametrize("dropless", PATHS)
def test_paged_engine_tokens_equal_the_jax_engines(dropless):
    jm, tm, _ = _pair(dropless, seed=1, **SERVE)
    jtoks, jstats = _drive(JEngine(jm, kernel="jnp", **GEOM))
    te = TEngine(tm, device="cpu", **GEOM)
    ttoks, tstats = _drive(te)
    assert ttoks == jtoks
    assert [len(t) for t in ttoks] == [8, 6, 5]
    assert tstats["hits"] == jstats["hits"] and tstats["hits"] >= 1
    assert te._reserved_unalloc == 0 and te.stats["finished"] == 3


@pytest.mark.parametrize("dropless", PATHS)
def test_trainer_trajectory_matches_jax(dropless):
    jm, tm, _ = _pair(dropless, **TRAIN)
    ids = _ids(b=4)
    jtr = JTrainer(jm, jopt.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters()),
                   config=JStepConfig(compute_dtype=None))
    jl = [float(np.asarray(jtr.step({"input_ids": ids, "labels": ids})
                           .numpy())) for _ in range(3)]
    tr = Trainer(tm, topt.AdamW(learning_rate=1e-3,
                                parameters=tm.named_parameters()),
                 TrainStepConfig(compute_dtype=None))
    tl = [float(tr.step({"input_ids": ids, "labels": ids}))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("axes", [("dp", "mp"), ("dp", "fsdp"), ("dp", "ep"),
                                  ("dp", "sp")])
def test_mesh_that_cuts_the_experts_is_refused(axes):
    _, tm, _ = _pair(True)
    before = {n: p.shape for n, p in tm.named_parameters()}
    mesh = ProcessMesh([[0, 1]], list(axes))
    with pytest.raises(NotImplementedError, match="queue 1 item 7.5"):
        Trainer(tm, topt.AdamW(parameters=tm.named_parameters()),
                TrainStepConfig(compute_dtype=None,
                                context_parallel="ring"), mesh=mesh,
                plan=tplan.llama_sharding_plan(mesh.dim_names))
    assert {n: p.shape for n, p in tm.named_parameters()} == before
    if axes[1] in ("mp", "fsdp"):
        with pytest.raises(NotImplementedError, match="expert weights"):
            tplan.apply_plan(tm, mesh,
                             tplan.llama_sharding_plan(mesh.dim_names))


def test_blockwise_loss_is_refused():
    """The JAX Qwen2-MoE always takes the dense loss; the port refuses a
    loss_chunk rather than ignore it."""
    with pytest.raises(ValueError, match="dense"):
        Qwen2MoeForCausalLM(tqwen.tiny_qwen2_moe_config(loss_chunk=8),
                            device="cpu")


def test_pipeline_refuses_a_moe_model():
    from paddle_tpu_torch.parallel.pipeline import PipelineTrainer
    _, tm, _ = _pair(True)
    mesh = ProcessMesh([[0, 1]], ["dp", "pp"])
    with pytest.raises(NotImplementedError, match="queue 1 item 7.5"):
        PipelineTrainer(tm, topt.AdamW(parameters=tm.named_parameters()),
                        mesh, tplan.llama_sharding_plan(mesh.dim_names))


def test_the_moe_modules_import_no_jax():
    """nn/moe.py and models/qwen2_moe.py (and what they pull in) load no
    module of JAX or of the JAX package."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys\n"
            "import paddle_tpu_torch.nn.moe\n"
            "from paddle_tpu_torch.models import Qwen2MoeForCausalLM\n"
            "import paddle_tpu_torch.models.convert\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('paddle_tpu', 'jax', 'jaxlib', 'ml_dtypes')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
