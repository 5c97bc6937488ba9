"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one. The file imports no JAX, so it runs on a machine that has PyTorch
and the CUDA toolkit alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: f32 outputs within 1e-4 (the kernel and the twin compute the
same f32 expressions in another order); bf16 outputs within one bf16
rounding step, 2^-7 relative; the decode kernel's f32 output from bf16
pools within 1e-4, since both sides upcast the same bf16 values.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.paged import PagedKVEngine
from paddle_tpu_torch.kernels import fused_norm as tfn
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models.llama import LlamaForCausalLM, tiny_llama_config

BF16_TOL = 2 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_matches_ref(cuda, dtype, rows):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, 4096, generator=g, device=cuda).to(dtype)
    r = torch.randn(rows, 4096, generator=g, device=cuda).to(dtype)
    w = torch.randn(4096, generator=g, device=cuda).to(dtype)
    for res in (None, r):
        y, h = tfn.rms_norm_residual(x, w, res, 1e-5)
        ry, rh = tfn.rms_norm_residual_ref(x, w, res, 1e-5)
        torch.cuda.synchronize()
        assert torch.equal(h, rh)
        torch.testing.assert_close(y.float(), ry.float(), rtol=_tol(dtype),
                                   atol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [1, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_kernel_matches_ref(cuda, dtype, seq):
    # seq 1: decode rows at scattered positions; seq 1024: the batched
    # prefill's q/k with positions arange per row and one shared table
    # pair, 2^25 elements, past the launcher's 65535-block cap, so the
    # grid-stride loop runs more than one pass
    g = torch.Generator(device=cuda).manual_seed(1)
    if seq == 1:
        pos = torch.randint(0, 8000, (8, 1), generator=g, device=cuda,
                            dtype=torch.int32)
    else:
        pos = torch.arange(seq, dtype=torch.int32, device=cuda).repeat(8, 1)
    tables = tfn.rope_tables(pos.reshape(-1), 128, 500000.0)
    for heads in (32, 8):
        x = torch.randn(8, seq, heads, 128, generator=g,
                        device=cuda).to(dtype)
        out = tfn.rope_apply(x, pos, 500000.0, tables=tables)
        ref = tfn.rope_apply_ref(x, pos, 500000.0, tables=tables)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(),
                                   rtol=_tol(dtype), atol=_tol(dtype))


def _decode_inputs(device, dtype, lens, hq=32, hk=8, d=128, ps=16, mp=80,
                   npages=641, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lens)
    kp = rng.normal(size=(npages, hk, ps, d)).astype(np.float32)
    vp = rng.normal(size=(npages, hk, ps, d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, npages))[:b * mp].reshape(b, mp)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    t = [torch.from_numpy(a).to(device) for a in (q, kp, vp)]
    t = [a.to(dtype) for a in t]
    return t + [torch.from_numpy(bt.astype(np.int32)).to(device),
                torch.tensor(lens, dtype=torch.int32, device=device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_ref(cuda, dtype):
    args = _decode_inputs(cuda, dtype, [0, 15, 16, 1000, 1279, 517, 64, 31])
    out = tpa.paged_decode_attention(*args)
    ref = tpa.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    # no GQA fold (g = 1), the widest fold (g = 8), the other head widths
    # and a page size that is not a multiple of the 16-row chunk
    for hq, hk, d, ps in ((8, 8, 128, 16), (16, 2, 128, 16), (8, 2, 64, 16),
                          (8, 4, 256, 16), (4, 2, 128, 5), (4, 2, 128, 40)):
        args = _decode_inputs(cuda, dtype, [0, 16, 33, 4 * ps - 1], hq=hq,
                              hk=hk, d=d, ps=ps, mp=4, npages=40)
        torch.testing.assert_close(tpa.paged_decode_attention(*args),
                                   tpa.paged_decode_attention_ref(*args),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    q, kp, vp, bt, lens = _decode_inputs(cuda, torch.float32, [3, 4], mp=2,
                                         npages=8)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_decode_attention(q, kp, vp, bt.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_decode_attention(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), kp, vp, bt, lens)
    with pytest.raises(TypeError, match="not supported"):
        tpa.paged_decode_attention(q.bfloat16(), kp, vp, bt, lens)
    x = torch.randn(4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        tfn.rms_norm_residual(x, torch.ones(64, device=cuda,
                                            dtype=torch.float16))
    with pytest.raises(TypeError, match="one type"):
        tfn.rms_norm_residual(x.bfloat16(), torch.ones(64, device=cuda))


@pytest.mark.cuda
def test_tiny_engine_on_the_card_matches_the_cpu(cuda):
    # head_dim 64: the smallest width the decode kernel is compiled for
    cfg = tiny_llama_config(num_hidden_layers=2, vocab_size=97,
                            hidden_size=256, num_attention_heads=4,
                            num_key_value_heads=2, fused_norm=True,
                            fused_rope=True)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    gpu_model = LlamaForCausalLM(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    geom = dict(max_slots=2, page_size=4, num_pages=24,
                max_pages_per_slot=6, steps_per_tick=2)
    counts = {**tfn.launches, **tpa.launches}
    outs = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda)):
        eng = PagedKVEngine(model, device=dev, **geom)
        ra = eng.submit([5, 9, 2, 14], max_new_tokens=10)
        eng.step()
        rb = eng.submit([17, 3, 11], max_new_tokens=6)
        eng.run_until_idle()
        outs.append((ra.result(), rb.result()))
    assert outs[0] == outs[1]
    after = {**tfn.launches, **tpa.launches}
    assert all(after[k] > counts[k] for k in after)
