"""The port's PagedKVEngine against the JAX engine, on the CPU.

Both engines serve the same weights (exported from the JAX model) at
f32. The JAX engine takes the Pallas decode kernel in interpret mode
(`kernel="pallas"`); the port's decode goes through its kernel wrapper,
which on the CPU is the plain twin. Greedy tokens must be identical,
including a request that joins mid-decode of another and one that stops
at eos. Sampling noise differs by design (jax.random vs torch.Generator),
so only the first sampled token — drawn host-side from numpy in both —
is compared.

The int8 serving configuration (`kv_dtype="int8"` over a weight-only
int8 model) is held the same way: the JAX model converted by PTQ
(`execute="weight_only_int8"`) and served by the JAX engine with int8
KV, its state carried into a port model converted by
`quantize_weight_only`, greedy tokens identical. The JAX side's
`_weight_only_matmul` is routed through the interpret-mode W8A16 kernel
(monkeypatch), so both sides compute the kernel's function.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
import paddle_tpu.quantization as jq
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.kernels.quant_matmul import \
    weight_only_int8_matmul as j_w8a16
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.quantization import quantize_weight_only

ROOT = str(Path(__file__).resolve().parents[1])
TINY = dict(num_hidden_layers=2, vocab_size=97, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            fused_norm=True, fused_rope=True)
GEOM = dict(max_slots=2, page_size=4, num_pages=24, max_pages_per_slot=6,
            steps_per_tick=2)


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY))
    cfg = tllama.tiny_llama_config(**TINY)
    tm = tllama.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(from_paddle_tpu_state(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, cfg))
    return jm, tm


def _engines(models, **kw):
    jm, tm = models
    geom = dict(GEOM, **kw)
    return (JEngine(jm, kernel="pallas", **geom),
            TEngine(tm, device="cpu", **geom))


def _drive_mid_decode(eng, eos_c):
    ra = eng.submit([5, 9, 2, 14], max_new_tokens=10)
    eng.step()
    rb = eng.submit([17, 3, 11], max_new_tokens=6)        # joins mid-decode
    rc = eng.submit([40, 41], max_new_tokens=8, eos_token_id=eos_c)
    eng.run_until_idle()
    return ra.result(), rb.result(), rc.result()


def test_greedy_tokens_identical_to_jax_engine_mid_decode(models):
    je, te = _engines(models)
    assert je.decode_kernel == "pallas"
    # the third request stops at eos: its 3rd greedy token
    probe = TEngine(models[1], device="cpu", **GEOM)
    eos = probe.generate([[40, 41]], max_new_tokens=3)[0][-1]
    jres = _drive_mid_decode(je, eos)
    tres = _drive_mid_decode(te, eos)
    assert tres == jres
    assert [len(r) for r in tres] == [10, 6, len(tres[2])]
    assert tres[2][-1] == eos and len(tres[2]) <= 3
    # every page went back; no reservation outstanding
    assert sorted(te._free) == list(range(1, te.num_pages))
    assert te._reserved_unalloc == 0
    assert te.stats["finished"] == 3


def test_long_generation_crosses_page_boundaries(models):
    # prompt 3 + 18 new = 21 positions over page_size-4 pages (6 pages)
    je, te = _engines(models, max_slots=1, steps_per_tick=3)
    jt = je.generate([[5, 9, 2]], max_new_tokens=18)
    tt = te.generate([[5, 9, 2]], max_new_tokens=18)
    assert tt == jt and len(tt[0]) == 18
    assert len(te._free) == te.num_pages - 1


def test_first_sampled_token_identical(models):
    je, te = _engines(models, max_slots=3)
    kw = dict(max_new_tokens=1, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.9)
    prompts = [[5, 9, 2, 14], [17, 3, 11], [1, 2]]
    assert te.generate(prompts, **kw) == je.generate(prompts, **kw)


def test_requests_that_finish_in_prefill_free_their_slots(models):
    # more one-token requests than slots: each admission pass finishes
    # its requests in prefill, and the queue must keep draining
    _, te = _engines(models)
    out = te.generate([[5], [6], [7], [8], [9]], max_new_tokens=1)
    assert [len(o) for o in out] == [1] * 5
    assert te.stats["ticks"] == 0 and te.stats["finished"] == 5


def test_sampled_decode_stays_in_vocab(models):
    _, te = _engines(models)
    out = te.generate([[5, 9], [3]], max_new_tokens=7, do_sample=True,
                      temperature=1.2, top_k=30, top_p=0.95)
    assert [len(o) for o in out] == [7, 7]
    assert all(0 <= t < 97 for o in out for t in o)


def test_engine_reports_and_validates(models):
    _, te = _engines(models)
    # 2 layers x (k, v) x hk 2 x page 4 x hd 16 x 4 B per page, 6 pages
    assert te.kv_bytes_per_slot() == 2 * 2 * 2 * 4 * 16 * 4 * 6
    with pytest.raises(ValueError, match="max_pages_per_slot"):
        te.submit(list(range(20)), max_new_tokens=10)
    with pytest.raises(ValueError, match="kv_dtype"):
        TEngine(models[1], device="cpu", kv_dtype="fp8", **GEOM)
    # int8 pools and their f32 scale rows, from the real buffers (the
    # pin of the JAX package's test_kv_dtype_int8_halves_bytes_per_slot)
    bf16 = TEngine(models[1], device="cpu", kv_dtype="bf16", **GEOM)
    int8 = TEngine(models[1], device="cpu", kv_dtype="int8", **GEOM)
    assert int8.kv_bytes_per_slot() <= 0.6 * bf16.kv_bytes_per_slot()
    # per page: 2 layers x (k, v) x (hk 2 x page 4 x hd 16 x 1 B + hk 2 x 4 B)
    assert int8.kv_bytes_per_slot() == 2 * 2 * (2 * 4 * 16 + 2 * 4) * 6
    kp, vp, ks, vs = int8.pools[0]
    assert kp.dtype == vp.dtype == torch.int8
    assert ks.dtype == vs.dtype == torch.float32
    assert tuple(ks.shape) == (GEOM["num_pages"] + 1, 2)   # + the sink


# -- int8 KV over a weight-only int8 model ------------------------------------

# multiples of 128, as the TPU W8A16 kernel's blocks need: hidden 256,
# 4 q / 2 kv heads of 64, FFN 512, vocab 256
TINY8 = dict(num_hidden_layers=2, vocab_size=256, hidden_size=256,
             intermediate_size=512, num_attention_heads=4,
             num_key_value_heads=2, fused_norm=True, fused_rope=True)


def _jax_kernel_matmul(xv, qwv, eff_scale):
    return j_w8a16(xv, qwv, eff_scale.astype(jnp.float32), block_m=None,
                   block_n=128, block_k=128, out_dtype=xv.dtype,
                   interpret=True).astype(xv.dtype)


@pytest.fixture(scope="module")
def models8():
    """(JAX weight-only int8 model, port model holding its int8 state)."""
    paddle_tpu.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.tiny_llama_config(**TINY8))
    jm.eval()
    ptq = jq.PTQ(jq.QuantConfig(
        activation=None, weight=jq.AbsMaxChannelWiseWeightObserver()))
    qm = ptq.quantize(jm)
    qm(JTensor(jnp.asarray(np.array([[1, 2, 3, 4]], np.int32))))
    jconv = ptq.convert(qm, execute="weight_only_int8")
    cfg = tllama.tiny_llama_config(**TINY8)
    tm = quantize_weight_only(tllama.LlamaForCausalLM(cfg, device="cpu"))
    tm.load_state_dict(from_paddle_tpu_state(
        {k: np.asarray(v._value) for k, v in jconv.state_dict().items()},
        cfg))
    return jconv, tm


@pytest.fixture
def engines8(models8, monkeypatch):
    monkeypatch.setattr(jq, "_weight_only_matmul", _jax_kernel_matmul)
    jm, tm = models8

    def make(**kw):
        geom = dict(GEOM, kv_dtype="int8", **kw)
        return (JEngine(jm, kernel="pallas", **geom),
                TEngine(tm, device="cpu", **geom))
    with paddle_tpu.no_grad():         # Pallas calls have no JVP rule
        yield make


def test_int8_greedy_tokens_identical_to_jax_engine_mid_decode(models8,
                                                               engines8):
    je, te = engines8()
    assert je.decode_kernel == "pallas" and te.kv_dtype == "int8"
    probe = TEngine(models8[1], device="cpu", kv_dtype="int8", **GEOM)
    eos = probe.generate([[40, 41]], max_new_tokens=3)[0][-1]
    jres = _drive_mid_decode(je, eos)
    tres = _drive_mid_decode(te, eos)
    assert tres == jres
    assert [len(r) for r in tres] == [10, 6, len(tres[2])]
    assert tres[2][-1] == eos and len(tres[2]) <= 3
    assert sorted(te._free) == list(range(1, te.num_pages))
    assert te._reserved_unalloc == 0


def test_int8_long_generation_crosses_page_boundaries(engines8):
    # prompt 3 + 18 new = 21 positions over page_size-4 pages (6 pages)
    je, te = engines8(max_slots=1, steps_per_tick=3)
    jt = je.generate([[5, 9, 2]], max_new_tokens=18)
    tt = te.generate([[5, 9, 2]], max_new_tokens=18)
    assert tt == jt and len(tt[0]) == 18


def test_int8_kv_scales_reset_on_page_recycle(engines8):
    """The template is the JAX package's test of the same name: freed
    pages' scale rows go back to zero, and an engine that already served
    (and retired) a request gives the same tokens as a fresh one, and as
    the JAX engine after the same history."""
    geom = dict(max_slots=1, num_pages=12, max_pages_per_slot=4,
                steps_per_tick=3)
    je, used = engines8(**geom)
    fresh = engines8(**geom)[1]
    first = [[40, 41, 42, 43]]
    assert used.generate(first, max_new_tokens=6) == je.generate(
        first, max_new_tokens=6)
    for _, _, ks, vs in used.pools:
        assert float(ks[1:-1].abs().sum()) == 0.0    # the sink excluded
        assert float(vs[1:-1].abs().sum()) == 0.0
    again = used.generate([[5, 9, 2]], max_new_tokens=8)
    assert again == fresh.generate([[5, 9, 2]], max_new_tokens=8)
    assert again == je.generate([[5, 9, 2]], max_new_tokens=8)


def test_entry_points_need_cuda_unless_cpu_is_asked(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tllama.tiny_llama_config(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(models[1], **GEOM)


def test_port_imports_without_jax_or_paddle_tpu():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.models.llama, paddle_tpu_torch.models.convert\n"
        "import paddle_tpu_torch.models, paddle_tpu_torch.models.generation\n"
        "import paddle_tpu_torch.core.graphs\n"
        "import paddle_tpu_torch.inference.paged\n"
        "import paddle_tpu_torch.inference.prefix\n"
        "import paddle_tpu_torch.inference.overload\n"
        "import paddle_tpu_torch.inference.tenancy\n"
        "import paddle_tpu_torch.inference.kvtier\n"
        "import paddle_tpu_torch.inference.disagg\n"
        "import paddle_tpu_torch.observability\n"
        "import paddle_tpu_torch.observability.metrics\n"
        "import paddle_tpu_torch.observability.trace\n"
        "import paddle_tpu_torch.observability.requests\n"
        "import paddle_tpu_torch.distributed.chaos\n"
        "import paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.distributed.retries\n"
        "import paddle_tpu_torch.inference.router\n"
        "import paddle_tpu_torch.observability.fleet\n"
        "import paddle_tpu_torch.inference.autopilot\n"
        "import paddle_tpu_torch.observability.telemetry\n"
        "import paddle_tpu_torch.distributed.checkpoint\n"
        "import paddle_tpu_torch.distributed.async_checkpoint\n"
        "import paddle_tpu_torch.parallel.trainer\n"
        "import paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.distributed.watchdog\n"
        "import paddle_tpu_torch.distributed.store\n"
        "import paddle_tpu_torch.distributed.elastic\n"
        "import paddle_tpu_torch.distributed.sentry\n"
        "import paddle_tpu_torch.distributed.env\n"
        "import paddle_tpu_torch.distributed.collective\n"
        "import paddle_tpu_torch.distributed.placement\n"
        "import paddle_tpu_torch.distributed.mesh\n"
        "import paddle_tpu_torch.distributed.parallel\n"
        "import paddle_tpu_torch.distributed.launch\n"
        "import paddle_tpu_torch.distributed.launch.smoke\n"
        "import paddle_tpu_torch.distributed.api\n"
        "import paddle_tpu_torch.distributed.fleet\n"
        "import paddle_tpu_torch.distributed.fleet.topology\n"
        "import paddle_tpu_torch.distributed.fleet.strategy\n"
        "import paddle_tpu_torch.distributed.fleet.layers\n"
        "import paddle_tpu_torch.distributed.fleet.utils\n"
        "import paddle_tpu_torch.parallel.plan\n"
        "import paddle_tpu_torch.tools.ab_blockwise_ce,"
        " paddle_tpu_torch.tools.ab_decode_tick,"
        " paddle_tpu_torch.tools.ab_flash, paddle_tpu_torch.tools.ab_fused_norm,"
        " paddle_tpu_torch.tools.ab_paged_decode,"
        " paddle_tpu_torch.tools.ab_w8a16\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import chip_smoke\n"
        "import paddle_tpu_torch.kernels.fused_norm\n"
        "import paddle_tpu_torch.kernels.paged_attention\n"
        "import paddle_tpu_torch.kernels.quant_matmul\n"
        "import paddle_tpu_torch.quantization\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m.split('.')[0] in ('paddle_tpu', 'jax', 'jaxlib',"
        " 'ml_dtypes'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
