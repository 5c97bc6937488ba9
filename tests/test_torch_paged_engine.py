"""The port's PagedKVEngine against the JAX engine, on the CPU.

Both engines serve the same weights (exported from the JAX model) at
f32. The JAX engine takes the Pallas decode kernel in interpret mode
(`kernel="pallas"`); the port's decode goes through its kernel wrapper,
which on the CPU is the plain twin. Greedy tokens must be identical,
including a request that joins mid-decode of another and one that stops
at eos. Sampling noise differs by design (jax.random vs torch.Generator),
so only the first sampled token — drawn host-side from numpy in both —
is compared.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.inference.paged import PagedKVEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.paged import PagedKVEngine as TEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import from_paddle_tpu_state

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
        TEngine(models[1], device="cpu", kv_dtype="int8", **GEOM)


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
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.models.llama, paddle_tpu_torch.models.convert\n"
        "import paddle_tpu_torch.inference.paged\n"
        "import paddle_tpu_torch.kernels.fused_norm\n"
        "import paddle_tpu_torch.kernels.paged_attention\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m.split('.')[0] in ('paddle_tpu', 'jax', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
