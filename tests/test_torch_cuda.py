"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one. The file imports no JAX, so it runs on a machine that has PyTorch
and the CUDA toolkit alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: f32 outputs within 1e-4 (the kernel and the twin compute the
same f32 expressions in another order); bf16 outputs within one bf16
rounding step, 2^-7 relative. The RMSNorm kernels run at decode,
prefill and training rows, d up to 12032, rows that are not whole
16-byte chunks and views that are not 16-byte aligned (both the scalar
instance); h is bit-equal to x + residual, y and dh the same bits from
call to call, dw held to its largest entry and the same bits twice.
RoPE, forward and backward, is bit-equal to its twin (both round the two
products and their sum apart) in f32 and bf16, in its 16-byte and its
scalar instance, and its backward runs no aten.neg;
`test_rms_norm_bwd_rule_rejects_a_dropped_warp` shows the dh rule failing
a backward whose row mean leaves out one warp's columns. The decode
kernel's f32 output from bf16
pools within 1e-4, since both sides upcast the same bf16 values. The
flash kernels' outputs entry by entry within the tolerance times (|ref|
+ the RMS of its head_dim row + 2^-6 of the RMS of the whole output), so
a row or key of small values is held to its own size; 2^-5 in bf16 (four
rounding steps: the kernel and the twin may round an output to
neighbouring bf16 values, and the kernel rounds p against the running
row max where the twin rounds the normalised p, noise that reaches 1.7
steps of a row's RMS over millions of entries).
`test_flash_bf16_rule_rejects_planted_faults` shows the rule failing
kernels that are wrong on some rows only. The blockwise cross-entropy
kernels' dx and dW are held by the same rule (2^-6 in bf16: both sides
round dS to bf16 once, and a dS that rounds the other way moves a row by
2^-8 of its size), their lse and picked within 1e-5 relative, and the
same bits from call to call; `test_ce_bf16_rule_rejects_planted_faults`
shows the rules failing a dx that drops one vocab tile, a dW that drops
its last 64 rows, a dS without its one-hot and a forward whose sum leaves
out three quarters of each tile (the lse rule, 1e-4 (1 + |ref|));
`test_ce_bf16_kernels_match_ref_at_ragged_edges` and
`test_ce_bf16_forward_matches_ref` run
super-blocks narrower than the 256-wide vocab tile and ragged rows, D
and V, `test_ce_kernels_past_the_old_int32_cap` n * v past 2^31. The int8
decode kernel's f32 output within 1e-4 of its twin (both dequantize the
same codes and scales in f32). The decode kernel splits each slot's
window over blocks and merges the splits in a fixed order: its cases put
lens on both sides of a split's edge, and
`test_paged_decode_is_bit_identical_from_call_to_call`,
`test_paged_decode_replays_in_a_cuda_graph` (the split plan reads no lens
on the host) and `test_decode_rule_rejects_a_dropped_split` (a combine
that leaves out the last split fails the 1e-4 rule) cover the design.
The W8A16 kernel's output entry by entry
within the tolerance times (|ref| + the RMS of its row + 2^-6 of the
output's RMS): 1e-4 in f32 (the same exact products summed in another
order), 2^-7 in bf16 (one rounding step: the two f32 sums may round to
neighbouring bf16 values); `test_w8a16_rule_rejects_a_dropped_k_tile`
shows it failing a split-K kernel and a wgmma kernel that leave out one
k-tile of 64, and a converter whose byte lane reads its neighbour.
`test_http_serving_over_the_captured_engine` serves a tiny f32 model
through the port's PredictorServer: its HTTP tokens equal the engine's
own generate(), the wave recaptures nothing, and the decode-kernel
counter reads "cuda" once per tick. Static-cache generation
(models/generation.py): the captured per-token decode step and block
give the eager bodies' tokens (bf16 and W8A16) and hold exactly the
kernel nodes their captures counted; a tail block stays inside max_len;
a sampled block's graph is seeded per stream; a capture that fails
raises.
"""
import gc
import os
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.inference.paged import PagedKVEngine
from paddle_tpu_torch.inference.prefix import chain_keys
from paddle_tpu_torch.io.prefetch import DevicePrefetcher
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import blockwise_ce as tbce
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_norm as tfn
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.models.llama import LlamaForCausalLM, tiny_llama_config
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
from paddle_tpu_torch.quantization import quantize_weight_only

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


def _close_to_max(out, ref, dtype, what=""):
    """|out - ref| within the tolerance times max(1, max |ref|)."""
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all(), what
    err = float((out - ref).abs().max())
    bound = tol * max(1.0, float(ref.abs().max()))
    assert err <= bound, f"{what}: |err| {err} > {bound}"


def _rows_ratio(out, ref, tol):
    """The largest |out - ref| / (tol * (|ref| + RMS of ref's last-dim
    row + 2^-6 RMS of ref)); the flash rule holds when it is at most 1.
    The last term covers rows whose exact value is 0 (dq of the first
    causal row), where both sides give rounding noise."""
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    sq = ref.square()
    bound = tol * (ref.abs() + sq.mean(-1, keepdim=True).sqrt()
                   + 2 ** -6 * sq.mean().sqrt())
    return float(((out - ref).abs() / bound).max())


def _close_rows(out, ref, dtype, what=""):
    tol = 1e-4 if dtype == torch.float32 else 2 ** -5
    ratio = _rows_ratio(out, ref, tol)
    assert ratio <= 1.0, f"{what}: |err| reaches {ratio:.3g} x its bound"


# (rows, d) of the RMSNorm kernels' tests: decode, prefill and training
# rows at the model widths, the contract's widest row, and rows that are
# not whole 16-byte chunks (4100 in bf16, 1002 in both types), which run
# the scalar instance
_NORM_SHAPES = [(1, 4096), (8, 4096), (6370, 4096), (16384, 2048),
                (8, 8192), (1024, 8192), (1, 12032), (512, 12032),
                (8, 4100), (6370, 4100), (8, 1002), (16384, 1002)]


def _norm_inputs(device, dtype, rows, d, seed, count, offset=0):
    """`count` (rows, d) tensors and a (d,) weight; with offset > 0 each
    is a contiguous view `offset` elements into a larger buffer, so its
    base pointer is not 16-byte aligned."""
    g = torch.Generator(device=device).manual_seed(seed)

    def one(*shape):
        buf = torch.randn(offset + int(np.prod(shape)), generator=g,
                          device=device).to(dtype)
        return buf[offset:].view(*shape)
    return [one(rows, d) for _ in range(count)], one(d)


def _check_norm_fwd(dtype, x, r, w):
    for res in (None, r):
        y, h = tfn.rms_norm_residual(x, w, res, 1e-5)
        ry, rh = tfn.rms_norm_residual_ref(x, w, res, 1e-5)
        torch.cuda.synchronize()
        assert torch.equal(h, rh)
        torch.testing.assert_close(y.float(), ry.float(), rtol=_tol(dtype),
                                   atol=_tol(dtype))
        again = tfn.rms_norm_residual(x, w, res, 1e-5)[0]
        assert torch.equal(again, y)            # the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", _NORM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_matches_ref(cuda, dtype, rows, d):
    (x, r), w = _norm_inputs(cuda, dtype, rows, d, 0, 2)
    _check_norm_fwd(dtype, x, r, w)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [1, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_kernel_matches_ref(cuda, dtype, seq):
    # bit for bit: the kernel rounds both products and their sum as the
    # twin does. seq 1: decode rows at scattered positions (one head a
    # thread); seq 1024: the batched prefill's q/k with positions arange
    # per row and one shared table pair (four heads a thread)
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
        assert torch.equal(out, ref)


def _check_norm_bwd(dtype, x, gy, gh, w):
    _, h, rstd = tfn._norm_fwd(x, w, None, 1e-5, want_rstd=True)
    _, ref_rstd = tfn._rmsn_fwd_math(x, w, 1e-5)
    torch.testing.assert_close(rstd, ref_rstd.reshape(-1), rtol=1e-5,
                               atol=1e-5)
    for gh_ in (None, gh):
        dh, dw = tfn.rms_norm_residual_bwd(h, w, rstd, gy, gh_)
        rdh, rdw = tfn.rms_norm_residual_bwd_ref(h, w, rstd, gy, gh_)
        torch.cuda.synchronize()
        torch.testing.assert_close(dh.float(), rdh.float(), rtol=_tol(dtype),
                                   atol=_tol(dtype))
        # dw sums n rows: tolerance relative to its largest entry
        _close_to_max(dw, rdw, dtype, "dw")
        again = tfn.rms_norm_residual_bwd(h, w, rstd, gy, gh_)[1]
        assert torch.equal(again, dw)           # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", _NORM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_backward_kernel_matches_ref(cuda, dtype, rows, d):
    (x, gy, gh), w = _norm_inputs(cuda, dtype, rows, d, 2, 3)
    _check_norm_bwd(dtype, x, gy, gh, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 6370])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernels_take_unaligned_views(cuda, dtype, rows):
    """Inputs one element into their buffers (`buf[1:].view(n, d)`):
    contiguous, but not 16-byte aligned, so the plan takes the scalar
    instance; both kernels still match their twins."""
    (x, r, gy), w = _norm_inputs(cuda, dtype, rows, 4096, 4, 3, offset=1)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert not tfn.plan(rows, 4096, dtype, tfn._aligned(x, r, w)).vector
    _check_norm_fwd(dtype, x, r, w)
    _check_norm_bwd(dtype, x, gy, r, w)


# the planted fault: the backward leaves the last warp of each row's team
# out of the row mean mean(gy * w * xhat)
_NORM_BWD_FAULT = (
    "    const float mean = team_sum(acc, tpr, slots[parity]) * inv_d;\n",
    "    if (t >= tpr - 32) acc = 0.f;\n"
    "    const float mean = team_sum(acc, tpr, slots[parity]) * inv_d;\n")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_bwd_rule_rejects_a_dropped_warp(cuda, dtype, tmp_path):
    """At the training shape (16384, 2048) the kernel passes the dh rule
    (|err| <= tol * (1 + |ref|)) and a copy whose row mean leaves out one
    warp's columns fails it (the factor by which it fails is printed). The
    faulty library is built from a copy of csrc/ in tmp_path."""
    (x, gy), w = _norm_inputs(cuda, dtype, 16384, 2048, 5, 2)
    assert tfn.plan(16384, 2048, dtype, backward=True).threads_per_row > 32
    _, h, rstd = tfn._norm_fwd(x, w, None, 1e-5, want_rstd=True)
    ref = tfn.rms_norm_residual_bwd_ref(h, w, rstd, gy)[0].float()
    tol = _tol(dtype)

    def ratio(dh):
        return float(((dh.float() - ref).abs() / (tol * (1 + ref.abs())))
                     .max())
    assert ratio(tfn.rms_norm_residual_bwd(h, w, rstd, gy)[0]) <= 1.0
    src = Path(_build.__file__).resolve().parent / "csrc"
    csrc = tmp_path / "csrc"
    shutil.copytree(src, csrc)
    cu = csrc / "fused_norm.cu"
    line, faulty = _NORM_BWD_FAULT
    text = cu.read_text()
    assert text.count(line) == 1, "the line to spoil moved"
    cu.write_text(text.replace(line, faulty))
    with _build.sources(csrc, tmp_path / "_build"):
        bad = tfn.rms_norm_residual_bwd(h, w, rstd, gy)[0]
        torch.cuda.synchronize()
    seen = ratio(bad)
    print(f"|err| / dh rule bound of the dropped warp: {seen}")
    assert seen > 1.0, seen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_backward_kernel_matches_ref(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    pos = torch.arange(512, dtype=torch.int32, device=cuda).repeat(2, 1)
    tables = tfn.rope_tables(pos.reshape(-1), 64, 10000.0)
    x = torch.randn(2, 512, 4, 64, generator=g, device=cuda).to(dtype)
    out = tfn.rope_apply_bwd(x, *tables)
    ref = tfn.rope_apply_bwd_ref(x, *tables)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    before = tfn.launches["rope_apply_bwd"]
    xr = x.clone().requires_grad_(True)
    tfn.rope_apply(xr, pos, 10000.0, tables=tables).backward(x)
    assert tfn.launches["rope_apply_bwd"] == before + 1
    assert torch.equal(xr.grad, ref)


# (d, element offset of x's view, heads) of the RoPE kernel's other
# instances: d 72 (bf16: half 36 is not a multiple of 8 values, the scalar
# instance; f32: the 16-byte one), a view one element into its buffer (not
# 16-byte aligned: the scalar instance), and d 2050 (1025 column pairs, so
# a thread walks more than one pair)
_ROPE_SCALAR = [(72, 0, 32), (128, 1, 8), (2050, 0, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,offset,heads", _ROPE_SCALAR)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_other_instances_match_ref_bit_for_bit(cuda, dtype, d, offset,
                                                    heads):
    g = torch.Generator(device=cuda).manual_seed(4)
    pos = torch.randint(0, 4096, (3, 37), generator=g, device=cuda,
                        dtype=torch.int32)
    tables = tfn.rope_tables(pos.reshape(-1), d, 500000.0)
    buf = torch.randn(offset + 3 * 37 * heads * d, generator=g,
                      device=cuda).to(dtype)
    x = buf[offset:].view(3, 37, heads, d)
    assert (x.data_ptr() % 16 != 0) == (offset > 0)
    for got, ref in ((tfn.rope_apply(x, pos, 500000.0, tables=tables),
                      tfn.rope_apply_ref(x, pos, 500000.0, tables=tables)),
                     (tfn.rope_apply_bwd(x, *tables),
                      tfn.rope_apply_bwd_ref(x, *tables))):
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_rope_backward_launches_no_neg(cuda):
    """The backward takes the sin table with sign -1 inside the kernel: no
    aten.neg (or any other op but the kernel's output allocation) runs in
    rope_apply_bwd or in the autograd backward of rope_apply."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.__name__)
            return func(*args, **(kwargs or {}))

    pos = torch.arange(64, dtype=torch.int32, device=cuda).repeat(2, 1)
    tables = tfn.rope_tables(pos.reshape(-1), 64, 10000.0)
    x = torch.randn(2, 64, 4, 64, device=cuda).to(torch.bfloat16)
    with Ops() as ops:
        tfn.rope_apply_bwd(x, *tables)
    assert not [n for n in ops.names if n.startswith("neg")], ops.names
    xr = x.clone().requires_grad_(True)
    out = tfn.rope_apply(xr, pos, 10000.0, tables=tables)
    with Ops() as ops:
        out.backward(x)
    assert not [n for n in ops.names if n.startswith("neg")], ops.names
    assert torch.equal(xr.grad, tfn.rope_apply_bwd_ref(x, *tables))


def _flash_inputs(device, dtype, b, s, hq, hk, d, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g, device=device).to(dtype)
            for h in (hq, hk, hk, hq)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hk,d,causal", [
    (2, 200, 8, 2, 64, True),       # ragged tail, GQA group of 4
    (2, 200, 8, 2, 64, False),
    (1, 256, 4, 4, 128, True),      # Llama-3's head width, no GQA
    (1, 96, 8, 1, 128, False),      # one kv head for all
])
def test_flash_kernels_match_ref(cuda, dtype, b, s, hq, hk, d, causal):
    q, k, v, do = _flash_inputs(cuda, dtype, b, s, hq, hk, d)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    _close_rows(o, ro, dtype, "o")
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    refs = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        _close_rows(got, want, dtype, name)


# Faults planted in the bf16 kernels of csrc/flash_attention.cu, each
# wrong on a few rows or keys only: (the outputs it spoils, the line, its
# faulty form)
_FAULTS = {
    # the last q block's o leaves out the values of keys 0-7 (P of the
    # first k tile packs zeros there; its row sums keep them, so the lse is
    # still right)
    "fwd_last_rows_drop_8_keys": (
        ("o",), "          fill_frag(p, j8, v, s[i], s[i + 1]);\n",
        "          const bool drop = q0 + kBlockRows >= a.seq && j == 0 &&\n"
        "                            j8 == 0;\n"
        "          fill_frag(p, j8, v, drop ? 0.f : s[i],\n"
        "                    drop ? 0.f : s[i + 1]);\n"),
    # the last q tile's dq leaves out the k tile of keys 0-63
    "dq_last_rows_drop_a_k_tile": (
        ("dq",),
        "    const bool live = qw0 < a.seq && (!a.causal || k0 <= qw0);\n",
        "    const bool live = qw0 < a.seq && (!a.causal || k0 <= qw0) &&\n"
        "                      !(q0 + kBlockRows >= a.seq && j == 0);\n"),
    # dk/dv leave out the last q tile of one query head of the group (but
    # for the block of the last keys, which no other q tile sees)
    "dkv_drop_one_heads_last_q_tile": (
        ("dk", "dv"),
        "    const bool live = kw0 < a.seq && (!a.causal || q0 >= kw0);\n",
        "    const bool live = kw0 < a.seq && (!a.causal || q0 >= kw0) &&\n"
        "                      !(q0 + kRows >= a.seq &&\n"
        "                        it / per_head == group - 1 &&\n"
        "                        k0 + kBlockRows < a.seq);\n"),
}


@pytest.mark.cuda
def test_flash_bf16_rule_rejects_planted_faults(cuda, tmp_path):
    """At the training shape (one sequence of 2048, 32/4 heads, d 64,
    causal), the kernels pass the row rule and each planted fault fails
    it: on an H100 the wgmma forward's (keys 0-7 left out of the last q
    block's o) by 28.8x, the wgmma dq's (a k tile left out of the last
    rows) by 50x, the wgmma dk/dv's (one head's last q tile left out) by
    36x (dk) and 28x (dv). A rule relative to the largest entry (2^-6 of
    it) barely sees them: the largest entries sit in the first rows and
    keys, the faults in the last ones (it fails them by 1.3-2.1x and
    passes dv's, at 0.55 of its bound; both ratios are printed). Each faulty library is built from a copy of csrc/ in
    tmp_path."""
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, 1, 2048, 32, 4, 64,
                                seed=7)

    def outputs():
        o, lse = tfa.flash_attention_fwd(q, k, v, True)
        dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}

    good = outputs()
    refs = dict(zip(("dq", "dk", "dv"), tfa.flash_attention_bwd_ref(
        q, k, v, good["o"], good["lse"], do, True)))
    refs["o"] = tfa.flash_attention_fwd_ref(q, k, v, True)[0]
    for name, ref in refs.items():
        _close_rows(good[name], ref, torch.bfloat16, name)
    src = Path(_build.__file__).resolve().parent / "csrc"
    seen = {}       # "fault output": (row-rule ratio, largest-entry ratio)
    for fault, (spoiled, line, faulty) in _FAULTS.items():
        csrc = tmp_path / fault / "csrc"
        shutil.copytree(src, csrc)
        cu = csrc / "flash_attention.cu"
        text = cu.read_text()
        assert text.count(line) == 1, f"{fault}: the line to spoil moved"
        cu.write_text(text.replace(line, faulty))
        with _build.sources(csrc, tmp_path / fault / "_build"):
            bad = outputs()
        for name in spoiled:
            err = (bad[name].float() - refs[name].float()).abs().max()
            seen[f"{fault} {name}"] = (
                _rows_ratio(bad[name], refs[name], 2 ** -5),
                float(err) / (2 ** -6 * max(
                    1.0, float(refs[name].float().abs().max()))))
    for what, (rows, to_max) in seen.items():
        print(f"{what}: |err| / row-rule bound {rows:.3g}, / largest-entry "
              f"bound {to_max:.3g}")
    assert all(rows > 1.0 for rows, _ in seen.values()), seen


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hk,d", [
    (1, 200, 32, 4, 64),        # ragged against the 128-row block tiles
    (1, 1000, 32, 4, 64),       # a group of 8, a ragged 8th block
    (1, 1000, 8, 2, 128),       # d 128, a group of 4
    (2, 136, 8, 1, 128),        # one kv head for 8 q heads, 8 ragged rows
    (1, 60, 4, 1, 64),          # one block, its second warpgroup all past s
])
def test_flash_backward_matches_ref_at_tile_edges(cuda, b, s, hq, hk, d,
                                                  causal):
    """The wgmma backward against the twin where its tiles are cut: blocks
    of 128 rows (two warpgroups of 64), k/v and q streams of 64, groups of
    1-8, both head widths."""
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, b, s, hq, hk, d,
                                seed=s + d)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    refs = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        _close_rows(got, want, torch.bfloat16, name)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hk,d", [
    (1, 200, 32, 4, 64),        # ragged against the 128-row block tiles
    (1, 1000, 32, 4, 64),       # a group of 8, a ragged 8th block
    (1, 1000, 8, 2, 128),       # d 128, a group of 4
    (2, 136, 8, 1, 128),        # one kv head for 8 q heads, 8 ragged rows
    (1, 60, 4, 1, 64),          # one block, its second warpgroup all past s
    (2, 129, 4, 2, 64),         # one key past the first 128-key tile
    (1, 129, 8, 8, 128),
])
def test_flash_forward_matches_ref_at_tile_edges(cuda, b, s, hq, hk, d,
                                                 causal):
    """The wgmma forward against the twin where its tiles are cut: blocks
    of 128 query rows (two warpgroups of 64), k/v tiles of 128 keys (s 129
    leaves one key in the second), groups of 1-8, both head widths. o
    within the bf16 row rule, lse within 1e-4."""
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, b, s, hq, hk, d,
                               seed=s + d + 1)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    _close_rows(o, ro, torch.bfloat16, "o")
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_forward_is_bit_identical_from_call_to_call(cuda):
    """The forward sums each row over its k tiles in a fixed order: a
    repeat gives the same o and lse bits, at both head widths."""
    for b, s, hq, hk, d in ((2, 1000, 32, 4, 64), (1, 1000, 8, 2, 128)):
        q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, b, s, hq, hk, d,
                                   seed=4)
        for causal in (True, False):
            o, lse = tfa.flash_attention_fwd(q, k, v, causal)
            for _ in range(3):
                o2, lse2 = tfa.flash_attention_fwd(q, k, v, causal)
                assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_flash_backward_reads_strided_views(cuda):
    """dq, dk, dv through flash_attention_bhsd's transposed views and
    through views of one fused qkv projection: bit-equal to the same
    gradients from contiguous copies (the kernels read through TMA maps
    over the tensors' own strides), and held to the twin."""
    b, s, hq, hk, d = 2, 200, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(11)
    do = torch.randn(b, s, hq, d, generator=g, device=cuda).bfloat16()
    bhsd = [torch.randn(b, h, s, d, generator=g, device=cuda).bfloat16()
            for h in (hq, hk, hk)]
    qkv = torch.randn(b, s, (hq + 2 * hk) * d, generator=g,
                      device=cuda).bfloat16()
    fused = [t.reshape(b, s, -1, d) for t in
             torch.split(qkv, [hq * d, hk * d, hk * d], dim=-1)]
    for views in ([t.transpose(1, 2) for t in bhsd], fused):
        assert not views[0].is_contiguous()
        dense = [t.contiguous() for t in views]
        o, lse = tfa.flash_attention_fwd(*dense, True)
        got = tfa.flash_attention_bwd(*views, o, lse, do, True)
        want = tfa.flash_attention_bwd(*dense, o, lse, do, True)
        refs = tfa.flash_attention_bwd_ref(*dense, o, lse, do, True)
        torch.cuda.synchronize()
        for name, x, y, r in zip(("dq", "dk", "dv"), got, want, refs):
            assert torch.equal(x, y), name
            _close_rows(x, r, torch.bfloat16, name)
    # the autograd entry on (B, H, S, D) tensors reaches the same kernels
    leaves = [t.detach().requires_grad_(True) for t in bhsd]
    out = tfa.flash_attention_bhsd(*leaves, causal=True)
    out.backward(do.transpose(1, 2))
    dense = [t.transpose(1, 2).contiguous() for t in bhsd]
    o, lse = tfa.flash_attention_fwd(*dense, True)
    for leaf, want in zip(leaves, tfa.flash_attention_bwd(*dense, o, lse,
                                                           do, True)):
        assert torch.equal(leaf.grad.transpose(1, 2), want)


@pytest.mark.cuda
def test_flash_backward_is_bit_identical_from_call_to_call(cuda):
    """No atomics: every sum of dq, dk and dv is taken in a fixed order."""
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, 2, 1000, 32, 4, 64,
                                seed=3)
    o, lse = tfa.flash_attention_fwd(q, k, v, True)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do, True)
    for _ in range(3):
        again = tfa.flash_attention_bwd(q, k, v, o, lse, do, True)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
def test_flash_reads_strided_views(cuda):
    # q/k/v as views of one fused qkv projection: no copy, same result
    b, s, hq, hk, d = 2, 128, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(b, s, (hq + 2 * hk) * d, generator=g,
                      device=cuda).bfloat16()
    q, k, v = (t.reshape(b, s, -1, d) for t in
               torch.split(qkv, [hq * d, hk * d, hk * d], dim=-1))
    assert not q.is_contiguous()
    o, _ = tfa.flash_attention_fwd(q, k, v, True)
    o2, _ = tfa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)


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


def _split_cases(lens_serving):
    """Decode geometries for the split-KV kernel: Llama-3-8B's serving
    heads; no GQA fold (g = 1), the widest fold of one tile (g = 8) and
    two and four tiles (g = 16, 32); the other head widths; page sizes
    that are not a multiple of the 16-row chunk (5, 40). Each
    geometry's block tables span several splits, and its lens sit at
    P * page_size - 1, P * page_size and P * page_size + 1 (the first
    split's last column, the second's first and the one after), at 0,
    and at the table's last position; then every slot at 0 and every
    slot at the last position."""
    cases = [dict(lens=lens_serving)]
    for hq, hk, d, ps in ((8, 8, 128, 16), (32, 8, 128, 16),
                          (16, 2, 128, 16), (16, 1, 128, 16),
                          (32, 1, 64, 16), (8, 2, 64, 16), (8, 4, 256, 16),
                          (4, 2, 128, 5), (4, 2, 128, 40)):
        mp = 3 * max(1, 64 // ps) + 1      # four splits, the last short
        per, n_split = tpa.plan(mp, ps)
        assert n_split > 1
        geo = dict(hq=hq, hk=hk, d=d, ps=ps, mp=mp, npages=5 * mp + 1)
        edge = per * ps
        for lens in ([edge - 1, edge, edge + 1, 0, mp * ps - 1], [0] * 5,
                     [mp * ps - 1] * 5):
            cases.append(dict(lens=lens, **geo))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_ref(cuda, dtype):
    for kw in _split_cases([0, 15, 16, 1000, 1279, 517, 64, 31]):
        args = _decode_inputs(cuda, dtype, **kw)
        before = tpa.launches["paged_decode_attention"]
        out = tpa.paged_decode_attention(*args)
        ref = tpa.paged_decode_attention_ref(*args)
        torch.cuda.synchronize()
        assert tpa.launches["paged_decode_attention"] == before + 1
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                   msg=str(kw))


@pytest.mark.cuda
def test_paged_decode_is_bit_identical_from_call_to_call(cuda):
    """The splits merge in a fixed order: two calls give the same bits,
    over bf16 and over int8 pools, at g = 4 and at g = 32."""
    lens = [0, 15, 16, 1000, 1279, 517, 64, 31]
    for hq in (32, 256):
        args = _decode_inputs(cuda, torch.bfloat16, lens, hq=hq)
        assert torch.equal(tpa.paged_decode_attention(*args),
                           tpa.paged_decode_attention(*args))
    q, kp, vp, bt, ln, ks, vs = _int8_decode_inputs(cuda, torch.bfloat16,
                                                    lens)
    a, b = (tpa.paged_decode_attention(q, kp, vp, bt, ln, k_scale=ks,
                                       v_scale=vs) for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_paged_decode_replays_in_a_cuda_graph(cuda):
    """The split plan reads no lens on the host: the wrapper captured in
    a CUDA graph, then lens and block tables changed in place and the
    graph replayed, gives the bits of an eager call on the new values
    (over bf16 and over int8 pools)."""
    rng = np.random.default_rng(3)
    for int8 in (False, True):
        if int8:
            q, kp, vp, bt, lens, ks, vs = _int8_decode_inputs(
                cuda, torch.bfloat16, [5, 300, 17, 1279])
            kw = dict(k_scale=ks, v_scale=vs)
        else:
            q, kp, vp, bt, lens = _decode_inputs(cuda, torch.bfloat16,
                                                 [5, 300, 17, 1279])
            kw = {}

        def run():
            return tpa.paged_decode_attention(q, kp, vp, bt, lens, **kw)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # warm-up, as capture wants
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        for new_lens in ([1279, 0, 640, 63], [64, 65, 1000, 16]):
            lens.copy_(torch.tensor(new_lens, dtype=torch.int32))
            bt.copy_(torch.from_numpy(rng.permutation(np.arange(
                1, kp.shape[0]))[:bt.numel()].reshape(bt.shape)
                .astype(np.int32)))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, run()), (int8, new_lens)
            torch.testing.assert_close(
                out, tpa.paged_decode_attention_ref(q, kp, vp, bt, lens,
                                                    **kw),
                rtol=1e-4, atol=1e-4)


# the planted fault: the combine leaves out the last non-empty split
_DECODE_FAULT = ("  for (int s = 0; s < used; ++s) {  // in split order\n",
                 "  for (int s = 0; s < used - 1; ++s) {  // in split order\n")


@pytest.mark.cuda
def test_decode_rule_rejects_a_dropped_split(cuda, tmp_path):
    """The kernel passes the 1e-4 rule and a copy whose combine leaves
    out each slot's last non-empty split fails it, over bf16 and int8
    pools (the factor by which it fails is printed). The faulty library
    is built from a copy of csrc/ in tmp_path."""
    lens = [0, 15, 16, 1000, 1279, 517, 64, 31]
    calls = [(_decode_inputs(cuda, torch.bfloat16, lens), {})]
    q, kp, vp, bt, ln, ks, vs = _int8_decode_inputs(cuda, torch.bfloat16,
                                                    lens)
    calls.append(((q, kp, vp, bt, ln), dict(k_scale=ks, v_scale=vs)))
    refs = [tpa.paged_decode_attention_ref(*a, **kw) for a, kw in calls]
    for (a, kw), ref in zip(calls, refs):
        torch.testing.assert_close(tpa.paged_decode_attention(*a, **kw),
                                   ref, rtol=1e-4, atol=1e-4)
    src = Path(_build.__file__).resolve().parent / "csrc"
    csrc = tmp_path / "csrc"
    shutil.copytree(src, csrc)
    cu = csrc / "paged_attention.cu"
    line, faulty = _DECODE_FAULT
    text = cu.read_text()
    assert text.count(line) == 1, "the line to spoil moved"
    cu.write_text(text.replace(line, faulty))
    with _build.sources(csrc, tmp_path / "_build"):
        bad = [tpa.paged_decode_attention(*a, **kw) for a, kw in calls]
        torch.cuda.synchronize()
    # |err| over the rule's bound, 1e-4 * (1 + |ref|), at its worst entry
    seen = [float(((b - r).abs() / (1e-4 * (1 + r.abs()))).max())
            for b, r in zip(bad, refs)]
    print(f"|err| / 1e-4 rule bound of the dropped split: {seen}")
    assert all(r > 1.0 for r in seen), seen


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
    # flash: unsupported head_dim, type, and a head dim that is not dense
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, 1, 64, 4, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(*(torch.zeros(1, 64, 2, 96, device=cuda)
                                  for _ in range(3)))
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="strides"):
        tfa.flash_attention_fwd(q.transpose(1, 3).contiguous()
                                .transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="sequence"):
        tfa.flash_attention_fwd(q, k[:, :32], v[:, :32])


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
    serving = ("rms_norm_residual", "rope_apply", "paged_decode_attention")
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
    assert all(after[k] > counts[k] for k in serving)


@pytest.mark.cuda
def test_training_step_on_the_card_matches_the_cpu(cuda):
    """One f32 Trainer step of a 2-layer model (flash attention, fused
    norm and RoPE, recompute) on the card through the kernels against the
    same state and batch on the CPU through the twins: the loss within
    1e-5 relative and every gradient within 1e-4 of its largest entry
    (the kernels sum the same f32 products in other orders). The updated
    parameters are not compared: Adam divides each gradient entry by its
    own magnitude, so an entry within the f32 noise of zero can step by
    the learning rate either way."""
    cfg = tiny_llama_config(num_hidden_layers=2, vocab_size=97,
                            hidden_size=256, num_attention_heads=4,
                            num_key_value_heads=2, use_flash_attention=True,
                            fused_norm=True, fused_rope=True, recompute=True)
    ids = np.random.RandomState(0).randint(0, 97, (2, 100)).astype(np.int32)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    gpu_model = LlamaForCausalLM(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    before = {**tfa.launches, **tfn.launches}
    results = []
    for model in (cpu_model, gpu_model):
        tr = Trainer(model, topt.AdamW(learning_rate=1e-3,
                                       parameters=model.named_parameters()),
                     TrainStepConfig(compute_dtype=None))
        loss = tr.step({"input_ids": ids, "labels": ids})
        results.append((float(loss), {n: p.grad.cpu() for n, p in
                                      model.named_parameters()}))
    after = {**tfa.launches, **tfn.launches}
    assert all(after[k] > before[k] for k in after), (before, after)
    assert abs(results[0][0] - results[1][0]) <= 1e-5 * abs(results[0][0])
    for name, g in results[0][1].items():
        err = float((results[1][1][name] - g).abs().max())
        assert err <= 1e-4 * float(g.abs().max()), (name, err)


@pytest.mark.cuda
def test_bf16_training_step_on_the_card_matches_the_cpu(cuda):
    """One bf16-compute Trainer step of the 2-layer model of the test
    above, on the card through the bf16 kernels against the CPU through
    the twins, which round p and dS to bf16 where the kernels do: the
    loss within 1e-3 relative and every gradient within 3e-2 of its own
    norm (cuBLAS and the CPU sum the same bf16 products in other orders,
    and a flipped rounding travels through the layers: measured 8e-5 and
    1.2e-2 on an H100)."""
    cfg = tiny_llama_config(num_hidden_layers=2, vocab_size=97,
                            hidden_size=256, num_attention_heads=4,
                            num_key_value_heads=2, use_flash_attention=True,
                            fused_norm=True, fused_rope=True, recompute=True)
    ids = np.random.RandomState(0).randint(0, 97, (2, 100)).astype(np.int32)
    state = LlamaForCausalLM(cfg, device="cpu", seed=0).state_dict()
    results = []
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(state)
        tr = Trainer(model, topt.AdamW(learning_rate=1e-3,
                                       parameters=model.named_parameters()),
                     TrainStepConfig(compute_dtype="bfloat16"))
        before = dict(tfa.launches)
        loss = tr.step({"input_ids": ids, "labels": ids})
        if dev is cuda:
            assert all(tfa.launches[k] > before[k] for k in before)
        results.append((float(loss), {n: p.grad.cpu() for n, p in
                                      model.named_parameters()}))
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = results
    print(f"bf16 step: loss card {gpu_loss} cpu {cpu_loss}; gradient "
          f"differences over their norms: " + ", ".join(
              f"{n} {float((gpu_g[n] - g).norm() / g.norm()):.3g}"
              for n, g in cpu_g.items()))
    assert abs(gpu_loss - cpu_loss) <= 1e-3 * abs(cpu_loss)
    for name, g in cpu_g.items():
        rel = float((gpu_g[name] - g).norm() / g.norm())
        assert rel <= 3e-2, (name, rel)


# -- blockwise cross-entropy ----------------------------------------------

def _ce_inputs(device, dtype, n=300, d=256, v=1000, seed=0):
    """x (n, d), W (v, d) at the model's init scale, labels with every
    tenth row ignored; V = 1000 leaves a 104-wide tail past the last
    128-wide tile."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(v, d)) * 0.02).astype(
        np.float32))
    lab = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    lab[::10] = -100
    return x.to(device, dtype), w.to(device, dtype), lab.to(device)


def _ce_close(out, ref, dtype, what):
    """The CE rule: entry by entry within tol * (|ref| + row RMS + 2^-6
    RMS), tol 2^-6 in bf16 and 1e-4 in f32."""
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    ratio = _rows_ratio(out, ref, tol)
    assert ratio <= 1.0, f"{what}: |err| reaches {ratio:.3g} x its bound"


def _ce_outputs(x, w, lab):
    loss, lse, count = tbce.ce_fwd(x, w, lab)
    g = torch.ones((), device=x.device)
    dx, dw = tbce.ce_bwd(x, w, lab, lse, count, g)
    torch.cuda.synchronize()
    return {"loss": loss, "lse": lse, "dx": dx, "dw": dw}


def _ce_refs(x, w, lab, chunk=64):
    loss, lse, count = tbce.ce_fwd_ref(x, w, lab, chunk)
    dx, dw = tbce.ce_bwd_ref(x, w, lab, lse, count,
                             torch.ones((), device=x.device), chunk)
    return {"loss": loss, "lse": lse, "dx": dx, "dw": dw}


def _ce_held(got, want, dtype):
    """lse and loss within 1e-5, dx and dW by the CE rule, ignored rows
    zero."""
    torch.testing.assert_close(got["lse"], want["lse"], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-5, atol=0)
    assert got["dx"].dtype == dtype and got["dw"].dtype == dtype
    _ce_close(got["dx"], want["dx"], dtype, "dx")
    _ce_close(got["dw"], want["dw"], dtype, "dW")
    assert not got["dx"][::10].float().any()      # ignored rows


@pytest.mark.cuda
@pytest.mark.parametrize("super_blocks", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_kernels_match_ref(cuda, dtype, super_blocks, monkeypatch):
    """The forward, dlogits, dx and dW kernels against the twin, with one
    backward super-block or eight (a 128-row workspace, so dx sums its
    super-blocks through the f32 accumulator)."""
    if super_blocks > 1:
        itemsize = torch.empty((), dtype=dtype).element_size()
        monkeypatch.setattr(tbce, "_WORKSPACE_BYTES", 300 * 128 * itemsize)
    x, w, lab = _ce_inputs(cuda, dtype)
    before = dict(tbce.launches)
    got = _ce_outputs(x, w, lab)
    want = _ce_refs(x, w, lab)
    launched = {k: tbce.launches[k] - before[k] for k in before}
    assert launched == {"ce_fwd": 1, "ce_dlogits": super_blocks,
                        "ce_dx": super_blocks, "ce_dw": super_blocks}
    _ce_held(got, want, dtype)
    again = _ce_outputs(x, w, lab)
    assert torch.equal(again["dx"], got["dx"])     # deterministic
    assert torch.equal(again["dw"], got["dw"])


# (n, d, v, vocab rows a super-block) of the bf16 backward's ragged edges
# (its tiles: 128 rows x 256 columns, k-tiles of 64): super-blocks of 384
# at V 1000 (the last 232 wide, narrower than a tile); ragged rows, D and
# V in one super-block (V 777: the workspace's last 8-column group half
# past V); three super-blocks of 128, each half a tile, with a 1-row tail
_CE_RAGGED = [(300, 256, 1000, 384), (333, 200, 777, None),
              (129, 64, 384, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,v,vs", _CE_RAGGED)
def test_ce_bf16_kernels_match_ref_at_ragged_edges(cuda, n, d, v, vs,
                                                   monkeypatch):
    if vs is not None:
        monkeypatch.setattr(tbce, "_WORKSPACE_BYTES", n * vs * 2)
    supers = -(-v // tbce.ce_super_block(n, v, 2))
    assert supers == (1 if vs is None else -(-v // vs))
    x, w, lab = _ce_inputs(cuda, torch.bfloat16, n=n, d=d, v=v)
    before = dict(tbce.launches)
    got = _ce_outputs(x, w, lab)
    launched = {k: tbce.launches[k] - before[k] for k in before}
    assert launched == {"ce_fwd": 1, "ce_dlogits": supers,
                        "ce_dx": supers, "ce_dw": supers}
    _ce_held(got, _ce_refs(x, w, lab), torch.bfloat16)
    again = _ce_outputs(x, w, lab)
    assert torch.equal(again["dx"], got["dx"])
    assert torch.equal(again["dw"], got["dw"])


def _picked_ref(x, w, lab):
    """x_i . W_{label_i} in f32 (0 for a label outside [0, V))."""
    ok = (lab >= 0) & (lab < w.shape[0])
    rows = w[lab.clamp(0, w.shape[0] - 1).long()].float()
    return torch.where(ok, (x.float() * rows).sum(-1), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("labels", ["random", "last_tile", "ignored"])
@pytest.mark.parametrize("n,d,v", [c[:3] for c in _CE_RAGGED])
def test_ce_bf16_forward_matches_ref(cuda, n, d, v, labels):
    """The forward's stats epilogue on the wgmma GEMM against the twin at
    ragged rows, D and V (V 1000 and 777: the last 256-wide vocab tile is
    232 and 9 columns wide, so the -inf mask of the columns past V
    counts), with random labels, every label in the last vocab tile, and
    every label ignore_index (nothing picked, loss 0): lse and picked
    within 1e-5, the same bits from call to call."""
    x, w, lab = _ce_inputs(cuda, torch.bfloat16, n=n, d=d, v=v)
    tile = _build.load_library().ptt_ce_vocab_tile(1)
    assert tile == 256
    if labels == "last_tile":
        first = (v - 1) // tile * tile
        lab = torch.arange(n, device=cuda, dtype=torch.int32) % (v - first) \
            + first
    elif labels == "ignored":
        lab = torch.full_like(lab, -100)
    lse, picked = tbce._launch_fwd(x, w, lab)
    loss = tbce.ce_fwd(x, w, lab)[0]
    torch.cuda.synchronize()
    ref_loss, ref_lse, _ = tbce.ce_fwd_ref(x, w, lab, 64)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(picked, _picked_ref(x, w, lab), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    if labels == "ignored":
        assert not picked.any() and float(loss) == 0.0
    again = tbce._launch_fwd(x, w, lab)
    assert torch.equal(again[0], lse) and torch.equal(again[1], picked)


@pytest.mark.cuda
def test_ce_kernels_past_the_old_int32_cap(cuda):
    """N 18432 = 9 x 2048 rows at Llama-3's vocab of 128256: n * v passes
    2^31, which `ce_shape_problems` used to refuse. Forward and backward
    against the twin, at a small D."""
    n, d, v = 18432, 64, 128256
    assert n * v >= 2 ** 31
    assert tbce.ce_shape_problems(n, d, v, torch.bfloat16) == []
    x, w, lab = _ce_inputs(cuda, torch.bfloat16, n=n, d=d, v=v)
    got = _ce_outputs(x, w, lab)
    _ce_held(got, _ce_refs(x, w, lab, chunk=2048), torch.bfloat16)


@pytest.mark.cuda
def test_ce_autograd_on_the_card(cuda):
    """blockwise_ce_loss on CUDA tensors runs the kernels through the
    autograd Function, with int64 labels."""
    x, w, lab = _ce_inputs(cuda, torch.bfloat16, n=64, d=128, v=500)
    xr, wr = (t.clone().requires_grad_(True) for t in (x, w))
    before = dict(tbce.launches)
    loss = tbce.blockwise_ce_loss(xr, wr, lab.long(), chunk=16)
    loss.backward()
    assert all(tbce.launches[k] == before[k] + 1 for k in before)
    want = _ce_refs(x, w, lab)
    torch.testing.assert_close(loss, want["loss"], rtol=1e-5, atol=0)
    _ce_close(xr.grad, want["dx"], torch.bfloat16, "dx")
    _ce_close(wr.grad, want["dw"], torch.bfloat16, "dW")


@pytest.mark.cuda
def test_ce_wrappers_raise_instead_of_falling_back(cuda):
    x, w, lab = _ce_inputs(cuda, torch.bfloat16, n=32, d=64, v=100)
    with pytest.raises(ValueError, match="contiguous"):
        tbce.ce_fwd(x.t().contiguous().t(), w, lab)
    with pytest.raises(ValueError, match="contiguous"):
        tbce.ce_fwd(x, w.t().contiguous().t(), lab)
    with pytest.raises(ValueError, match="float16"):
        tbce.ce_fwd(x.half(), w.half(), lab)
    with pytest.raises(ValueError, match="d=36"):
        tbce.ce_fwd(x[:, :36].contiguous(), w[:, :36].contiguous(), lab)
    with pytest.raises(ValueError, match="one type"):
        tbce.ce_fwd(x, w.float(), lab)
    with pytest.raises(ValueError, match="int32 or int64"):
        tbce.ce_fwd(x, w, lab.float())
    with pytest.raises(ValueError, match="not on"):
        tbce.ce_fwd(x, w, lab.cpu())


# Faults planted in csrc/blockwise_ce.cu's bf16 backward (wgmma), with a
# 128-row backward super-block: (the outputs it spoils, the line, its
# faulty form)
_CE_FAULTS = {
    # dx leaves out the vocab tile [320, 384) (the third super-block's
    # dS columns past 64 read as zeros in the dx product only)
    "dx_drop_one_vocab_tile": (
        ("dx",), "  const int k_cols = ws_cols(vcur);\n",
        "  const int k_cols = v0 == 256 ? 64 : ws_cols(vcur);\n"),
    # dW leaves out the last 64 rows (its last k-tile)
    "dw_drop_one_row_tile": (
        ("dw",), "  e.k = n;\n", "  e.k = n - 64;\n"),
    # the dS epilogue forgets the one-hot
    "ds_drop_onehot": (
        ("dx", "dw"),
        "        d0 = (d0 - (col == lab[v] ? 1.f : 0.f)) * sc[v];\n"
        "        d1 = (d1 - (col + 1 == lab[v] ? 1.f : 0.f)) * sc[v];\n",
        "        d0 = d0 * sc[v];\n        d1 = d1 * sc[v];\n"),
    # the forward's epilogue sums exp over each thread's own 64 columns
    # and leaves out the quad's other three (no shuffle of the sum)
    "fwd_sum_without_quad_shuffle": (
        ("lse",),
        "      sum += __shfl_xor_sync(0xffffffffu, sum, 1);\n"
        "      sum += __shfl_xor_sync(0xffffffffu, sum, 2);\n",
        ""),
}


def _lse_ratio(out, ref):
    """The largest |out - ref| / (1e-4 (1 + |ref|)): the lse rule holds when
    it is at most 1."""
    return float(((out - ref).abs() / (1e-4 * (1 + ref.abs()))).max())


@pytest.mark.cuda
def test_ce_bf16_rule_rejects_planted_faults(cuda, tmp_path, monkeypatch):
    """The kernels pass the entry-by-entry rule (dx, dW) and the lse rule
    and each planted fault fails its rule: the rows whose label lies in
    the dropped vocab tile lose their dominant term in dx, the vocab rows
    labelled by the dropped rows lose theirs in dW, without the one-hot
    every labelled row and vocab row does, and a forward that sums a
    quarter of each tile's columns gives every row an lse about log 4
    short. Each faulty library is built from a copy of csrc/ in
    tmp_path."""
    monkeypatch.setattr(tbce, "_WORKSPACE_BYTES", 320 * 128 * 2)
    x, w, lab = _ce_inputs(cuda, torch.bfloat16, n=320)
    good = _ce_outputs(x, w, lab)
    refs = _ce_refs(x, w, lab)
    for name in ("dx", "dw"):
        _ce_close(good[name], refs[name], torch.bfloat16, name)
    assert _lse_ratio(good["lse"], refs["lse"]) <= 1.0
    src = Path(_build.__file__).resolve().parent / "csrc"
    seen = {}
    for fault, (spoiled, line, faulty) in _CE_FAULTS.items():
        csrc = tmp_path / fault / "csrc"
        shutil.copytree(src, csrc)
        cu = csrc / "blockwise_ce.cu"
        text = cu.read_text()
        assert text.count(line) == 1, f"{fault}: the line to spoil moved"
        cu.write_text(text.replace(line, faulty))
        with _build.sources(csrc, tmp_path / fault / "_build"):
            bad = _ce_outputs(x, w, lab)
        for name in spoiled:
            seen[f"{fault} {name}"] = (
                _lse_ratio(bad[name], refs[name]) if name == "lse" else
                _rows_ratio(bad[name], refs[name], 2 ** -6))
    print(f"|err| / row-rule bound of the planted faults: {seen}")
    assert all(r > 1.0 for r in seen.values()), seen


@pytest.mark.cuda
def test_blockwise_training_step_on_the_card_matches_the_cpu(cuda):
    """One f32 Trainer step of a 2-layer model with the blockwise loss
    (loss_chunk 16, tied and untied head) on the card through the
    kernels against the CPU through the twins: the loss within 1e-5
    relative, every gradient within 1e-4 of its largest entry."""
    for tied in (False, True):
        cfg = tiny_llama_config(num_hidden_layers=2, vocab_size=500,
                                hidden_size=256, num_attention_heads=4,
                                num_key_value_heads=2,
                                use_flash_attention=True, recompute=True,
                                loss_chunk=16, tie_word_embeddings=tied)
        ids = np.random.RandomState(0).randint(0, 500, (2, 100)).astype(
            np.int32)
        state = LlamaForCausalLM(cfg, device="cpu", seed=0).state_dict()
        results = []
        for dev in ("cpu", cuda):
            model = LlamaForCausalLM(cfg, device=dev)
            model.load_state_dict(state)
            tr = Trainer(model, topt.AdamW(
                learning_rate=1e-3, parameters=model.named_parameters()),
                TrainStepConfig(compute_dtype=None))
            before = dict(tbce.launches)
            loss = tr.step({"input_ids": ids, "labels": ids})
            if dev is cuda:
                assert all(tbce.launches[k] > before[k] for k in before)
            results.append((float(loss), {n: p.grad.cpu() for n, p in
                                          model.named_parameters()}))
        (cpu_loss, cpu_g), (gpu_loss, gpu_g) = results
        assert abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
        for name, g in cpu_g.items():
            err = float((gpu_g[name] - g).abs().max())
            assert err <= 1e-4 * float(g.abs().max()), (tied, name, err)


# -- the prefetcher --------------------------------------------------------

@pytest.mark.cuda
def test_prefetcher_hands_over_on_the_side_stream(cuda):
    """A batch read right after next() equals its host copy: the
    consumer's stream waits for the side stream's copy. 64 MB batches,
    so a read that did not wait would see the copy unfinished."""
    rng = np.random.default_rng(0)
    host = [{"x": rng.normal(size=(4096, 4096)).astype(np.float32),
             "ids": rng.integers(0, 100, (8, 16)).astype(np.int32)}
            for _ in range(3)]
    # copies finished before the prefetcher starts
    placed = [torch.from_numpy(h["x"]).to(cuda) for h in host]
    torch.cuda.synchronize()
    with DevicePrefetcher(iter(host), device=cuda, depth=2) as it:
        for want, ref in zip(host, placed):
            got = next(it)
            assert got["x"].is_cuda and got["ids"].dtype == torch.int32
            # a kernel on the current stream right after next()
            assert torch.equal(got["x"], ref)
            assert np.array_equal(got["ids"].cpu().numpy(), want["ids"])
        with pytest.raises(StopIteration):
            next(it)


# -- int8 serving: the int8 decode kernel and W8A16 ----------------------------

def _int8_decode_inputs(device, qdtype, lens, hq=32, hk=8, d=128, ps=16,
                        mp=80, npages=641, seed=0):
    """int8 pools of random codes, positive (page, head) scales, q."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    kp, vp = (rng.integers(-127, 128, size=(npages, hk, ps, d))
              .astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.05, size=(npages, hk)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(np.arange(1, npages))[:b * mp].reshape(b, mp)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    t = [torch.from_numpy(a).to(device) for a in
         (q, kp, vp, bt.astype(np.int32), np.asarray(lens, np.int32), ks, vs)]
    t[0] = t[0].to(qdtype)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_paged_decode_int8_kernel_matches_ref(cuda, qdtype):
    # Llama-3-8B's serving heads at lens on both sides of page boundaries,
    # then d 64 and the other head widths and GQA folds; then the split
    # geometries of the float pools' test
    cases = [dict(lens=[0, 15, 16, 1000, 1279, 517, 64, 31])]
    for hq, hk, d, ps in ((8, 2, 64, 16), (4, 4, 64, 16), (16, 2, 128, 16),
                          (8, 4, 256, 16), (4, 2, 64, 5), (4, 2, 128, 40)):
        cases.append(dict(lens=[0, ps - 1, ps, 2 * ps + 1, 4 * ps - 1],
                          hq=hq, hk=hk, d=d, ps=ps, mp=4, npages=40))
    cases += _split_cases([0, 16, 1279, 300])[1:]
    for kw in cases:
        q, kp, vp, bt, lens, ks, vs = _int8_decode_inputs(cuda, qdtype, **kw)
        before = tpa.launches["paged_decode_attention_int8"]
        out = tpa.paged_decode_attention(q, kp, vp, bt, lens, k_scale=ks,
                                         v_scale=vs)
        ref = tpa.paged_decode_attention_ref(q, kp, vp, bt, lens,
                                             k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert tpa.launches["paged_decode_attention_int8"] == before + 1
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                   msg=str(kw))


def _w8a16_inputs(device, dtype, M, K, N, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=device).to(dtype)
    qw = torch.randint(-127, 128, (K, N), generator=g, device=device,
                       dtype=torch.int8)
    s = torch.rand(N, generator=g, device=device) * 0.01 + 1e-3
    return x, qw, s


def _w8a16_tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 8, 17, 64, tqm._SMALL_M + 1, 300, 1000,
                               5460])
def test_w8a16_kernel_matches_ref(cuda, dtype, M):
    # M on both sides of the route's threshold; ragged K (200: a last
    # k-tile of 8; 4104: 64 whole k-tiles and one of 8) and N (208: a last
    # column tile of 80 in the 16-row kernel, 208 of 256 in the wgmma
    # kernel; 1040: 16 of 256), a Llama-3 decode shape that splits K 32
    # ways, and f32 x (rounded to bf16 before the wgmma kernel) with a
    # bf16 output
    for K, N in ((200, 208), (4104, 1040), (4096, 1024), (1024, 4096)):
        x, qw, s = _w8a16_inputs(cuda, dtype, M, K, N)
        wgmma = tqm.plan(M, K, N, tqm._sm_count(cuda))[0] == "wgmma"
        before = dict(tqm.launches)
        out = tqm.weight_only_int8_matmul(x, qw, s)
        ref = tqm.weight_only_int8_matmul_ref(x, qw, s)
        torch.cuda.synchronize()
        assert tqm.launches["weight_only_int8_matmul"] == \
            before["weight_only_int8_matmul"] + 1
        assert tqm.launches["weight_only_int8_matmul_wgmma"] == \
            before["weight_only_int8_matmul_wgmma"] + wgmma
        assert out.dtype == dtype and out.shape == (M, N)
        ratio = _rows_ratio(out, ref, _w8a16_tol(dtype))
        assert ratio <= 1.0, (M, K, N, ratio)
    x3 = x.reshape(1, M, K)            # leading dims fold into M
    assert torch.equal(tqm.weight_only_int8_matmul(x3, qw, s)[0], out)
    if dtype == torch.float32:
        out16 = tqm.weight_only_int8_matmul(x, qw, s,
                                            out_dtype=torch.bfloat16)
        ref16 = tqm.weight_only_int8_matmul_ref(x, qw, s, torch.bfloat16)
        assert _rows_ratio(out16, ref16, 2 ** -7) <= 1.0


@pytest.mark.cuda
def test_w8a16_is_bit_identical_from_call_to_call(cuda):
    """Neither route splits K with atomics: a repeat gives the same bits
    (the wgmma kernel at a prefill shape, the split-K kernel at a decode
    shape)."""
    for M, K, N in ((5460, 4096, 1024), (8, 4096, 1024)):
        x, qw, s = _w8a16_inputs(cuda, torch.bfloat16, M, K, N)
        first = tqm.weight_only_int8_matmul(x, qw, s)
        for _ in range(3):
            assert torch.equal(tqm.weight_only_int8_matmul(x, qw, s), first)


@pytest.mark.cuda
def test_w8a16_wrapper_raises_instead_of_falling_back(cuda):
    x, qw, s = _w8a16_inputs(cuda, torch.bfloat16, 8, 256, 256)
    with pytest.raises(ValueError, match="K % 8"):
        tqm.weight_only_int8_matmul(x[:, :100], qw[:100], s)
    with pytest.raises(ValueError, match="N % 16"):
        tqm.weight_only_int8_matmul(x, qw[:, :40].contiguous(), s[:40])
    with pytest.raises(ValueError, match="contiguous"):
        tqm.weight_only_int8_matmul(x, qw.t().contiguous().t(), s)
    with pytest.raises(TypeError, match="not supported"):
        tqm.weight_only_int8_matmul(x.half(), qw, s)
    with pytest.raises(ValueError, match="on"):
        tqm.weight_only_int8_matmul(x, qw.cpu(), s)


# planted faults: (line to spoil, its faulty replacement, shapes it shows at)
_W8A16_FAULTS = {
    # every split whose k range holds k-tile 1 leaves it out
    "split_k_drops_a_k_tile": (
        "    __syncthreads();  // the B tile is whole\n",
        "    __syncthreads();  // the B tile is whole\n"
        "    if (kt == 1) continue;\n",
        ((8, 4096, 1024), (8, 14336, 4096))),
    # k-tile 1's products are not issued (both row tiles)
    "wgmma_drops_a_k_tile": (
        "        mma_step<BM>(acc, a[p], h::desc_sw128(xb + 32 * kk, 16, 1024));\n",
        "        if (kt != 1)\n"
        "          mma_step<BM>(acc, a[p], h::desc_sw128(xb + 32 * kk, 16, 1024));\n",
        ((300, 4096, 1024), (5460, 4104, 1040))),
    # the converter's byte lane 1 reads lane 0's byte
    "converter_lane_reads_its_neighbour": (
        "__byte_perm(u, kMagic, 0x7441)", "__byte_perm(u, kMagic, 0x7440)",
        ((300, 4096, 1024), (5460, 4104, 1040))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(_W8A16_FAULTS))
def test_w8a16_rule_rejects_a_dropped_k_tile(cuda, tmp_path, fault):
    """The kernels pass the entry-by-entry rule and a copy with a planted
    fault fails it: a k-tile of 64 left out by the 16-row split-K kernel
    (decode) or by the wgmma kernel (prefill), or one byte lane of the
    wgmma kernel's int8 -> bf16 converter reading its neighbour. The
    faulty library is built from a copy of csrc/ in tmp_path."""
    line, faulty, shapes = _W8A16_FAULTS[fault]
    inputs = [_w8a16_inputs(cuda, torch.bfloat16, *sh) for sh in shapes]
    refs = [tqm.weight_only_int8_matmul_ref(*a) for a in inputs]
    for a, ref in zip(inputs, refs):
        assert _rows_ratio(tqm.weight_only_int8_matmul(*a), ref,
                           2 ** -7) <= 1.0
    src = Path(_build.__file__).resolve().parent / "csrc"
    csrc = tmp_path / "csrc"
    shutil.copytree(src, csrc)
    cu = csrc / "quant_matmul.cu"
    text = cu.read_text()
    assert text.count(line) == 1, "the line to spoil moved"
    cu.write_text(text.replace(line, faulty))
    with _build.sources(csrc, tmp_path / "_build"):
        bad = [tqm.weight_only_int8_matmul(*a) for a in inputs]
        torch.cuda.synchronize()
    seen = [_rows_ratio(b, r, 2 ** -7) for b, r in zip(bad, refs)]
    print(f"|err| / rule bound, {fault}: {seen}")
    assert all(r > 1.0 for r in seen), seen


@pytest.mark.cuda
def test_tiny_int8_engine_on_the_card_matches_the_cpu(cuda):
    """W8A16 projections and int8 KV: the same greedy tokens on the card
    (the int8 decode kernel, W8A16, the norm and RoPE kernels) as on the
    CPU (their twins), from the same int8 state."""
    cfg = tiny_llama_config(num_hidden_layers=2, vocab_size=256,
                            hidden_size=256, intermediate_size=512,
                            num_attention_heads=4, num_key_value_heads=2,
                            fused_norm=True, fused_rope=True)
    cpu_model = quantize_weight_only(LlamaForCausalLM(cfg, device="cpu",
                                                      seed=0))
    gpu_model = quantize_weight_only(LlamaForCausalLM(cfg, device=cuda,
                                                      seed=1))
    gpu_model.load_state_dict(cpu_model.state_dict())
    geom = dict(max_slots=2, page_size=4, num_pages=24,
                max_pages_per_slot=6, steps_per_tick=2, kv_dtype="int8")
    path = ("paged_decode_attention_int8", "weight_only_int8_matmul",
            "rms_norm_residual", "rope_apply")
    counts = {**tfn.launches, **tpa.launches, **tqm.launches}
    outs = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda)):
        eng = PagedKVEngine(model, device=dev, **geom)
        ra = eng.submit([5, 9, 2, 14], max_new_tokens=10)
        eng.step()
        rb = eng.submit([17, 3, 11], max_new_tokens=6)
        eng.run_until_idle()
        outs.append((ra.result(), rb.result()))
        assert float(eng._scales[:, :, 1:-1].abs().sum()) == 0.0
    assert outs[0] == outs[1]
    after = {**tfn.launches, **tpa.launches, **tqm.launches}
    assert all(after[k] > counts[k] for k in path)
    assert after["paged_decode_attention"] == counts["paged_decode_attention"]


# -- the decode tick as one captured CUDA graph ---------------------------------

def _capture(run):
    """`run` warmed up once on a side stream, then captured; returns the
    graph and what the captured call returned (its static outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    return graph, out


def _wrapper_case(name, dev):
    """(static inputs, run, new inputs) for one wrapper of the decode
    path at a Llama-3-8B decode shape (8 slots)."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    if name == "rms_norm_residual":
        ins = [randn(8, 4096), randn(8, 4096), randn(4096)]
        return ins, lambda: tfn.rms_norm_residual(
            ins[0], ins[2], ins[1], 1e-5), \
            lambda: [randn(8, 4096), randn(8, 4096), randn(4096)]
    if name == "rope_apply":
        pos = torch.tensor([[3], [700], [16], [1279], [0], [64], [5], [900]],
                           dtype=torch.int32, device=dev)
        ins = [randn(8, 1, 32, 128), pos]
        return ins, lambda: tfn.rope_apply(ins[0], tables=tfn.rope_tables(
            ins[1].reshape(-1), 128, 500000.0)), \
            lambda: [randn(8, 1, 32, 128), pos.flip(0) + 11]
    if name == "weight_only_int8_matmul":
        assert tqm.plan(8, 4096, 14336)[0] == "split_k"
        assert tqm.plan(8, 4096, 14336)[2] > 1        # the ws workspace
        ins = [randn(8, 4096), codes(4096, 14336),
               torch.rand(14336, generator=g, device=dev) / 127]
        return ins, lambda: tqm.weight_only_int8_matmul(*ins), \
            lambda: [randn(8, 4096), codes(4096, 14336),
                     torch.rand(14336, generator=g, device=dev) / 127]
    from paddle_tpu_torch.inference.paged import _quant_scatter
    pages = 642

    def inputs():
        phys = torch.randperm(pages - 1, generator=g, device=dev)[:8] + 1
        return [codes(2, pages, 8, 16, 128),
                torch.rand(2, pages, 8, generator=g, device=dev) / 64,
                randn(2, 8, 8, 128),
                phys, torch.randint(0, 16, (8,), generator=g, device=dev)]

    ins = inputs()
    return ins, lambda: _quant_scatter(*ins), inputs


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rms_norm_residual", "rope_apply",
                                  "weight_only_int8_matmul",
                                  "quant_scatter"])
def test_decode_path_wrappers_replay_in_a_cuda_graph(cuda, name):
    """Each wrapper the captured tick runs, captured alone: after its
    inputs change in place, a replay gives the bits of an eager call on
    the new values (`_quant_scatter` updates its pools and scale planes
    in place: both runs start from the same copies of them)."""
    ins, run, fresh = _wrapper_case(name, cuda)
    graph, out = _capture(run)
    for _ in range(2):
        for t, new in zip(ins, fresh()):
            t.copy_(new)
        start = [t.clone() for t in ins]
        graph.replay()
        torch.cuda.synchronize()
        got = ([t.clone() for t in ins[:2]] if name == "quant_scatter"
               else [t.clone() for t in (out if isinstance(out, tuple)
                                          else (out,))])
        for t, s in zip(ins, start):
            t.copy_(s)
        want = run()
        if name == "quant_scatter":
            want = ins[:2]
        elif not isinstance(want, tuple):
            want = (want,)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name


_TICK_CFG = dict(num_hidden_layers=2, vocab_size=256, hidden_size=256,
                 intermediate_size=512, num_attention_heads=4,
                 num_key_value_heads=2, fused_norm=True, fused_rope=True)
# 11 allocatable pages for two slots of up to 6: later requests recycle
# the pages of earlier ones
_TICK_GEOM = dict(max_slots=2, page_size=4, num_pages=12,
                  max_pages_per_slot=6, steps_per_tick=3)


def _tick_model(dev, kv):
    model = LlamaForCausalLM(tiny_llama_config(**_TICK_CFG), device=dev,
                             dtype=torch.bfloat16, seed=0)
    return quantize_weight_only(model) if kv == "int8" else model


def _eager(eng):
    """The engine with its tick run eagerly (the yardstick)."""
    eng._tick_program = eng._eager_program
    return eng


def _drive_tick_scenario(eng, eos):
    """A mid-decode join, an eos stop, a queued request and, after a
    drain, a request on recycled pages."""
    ra = eng.submit([5, 9, 2, 14], max_new_tokens=10)
    eng.step()
    rb = eng.submit([17, 3, 11], max_new_tokens=6)          # joins
    rc = eng.submit([40, 41], max_new_tokens=8, eos_token_id=eos)
    eng.run_until_idle()
    rd = eng.submit([7, 8, 9], max_new_tokens=9)
    eng.run_until_idle()
    return [r.result() for r in (ra, rb, rc, rd)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_captured_tick_gives_the_eager_ticks_tokens(cuda, kv):
    model = _tick_model(cuda, kv)
    geom = dict(_TICK_GEOM, kv_dtype=kv)
    probe = _eager(PagedKVEngine(model, device=cuda, **geom))
    eos = probe.generate([[40, 41]], max_new_tokens=3)[0][-1]
    captured = PagedKVEngine(model, device=cuda, **geom)
    eager = _eager(PagedKVEngine(model, device=cuda, **geom))
    got = _drive_tick_scenario(captured, eos)
    want = _drive_tick_scenario(eager, eos)
    assert got == want
    assert [len(t) for t in got] == [10, 6, len(got[2]), 9]
    assert got[2][-1] == eos and len(got[2]) <= 3
    assert set(captured._programs) == {("tick", False)}
    assert not eager._programs
    assert captured.stats["warmup_ticks"] == 1
    assert eager.stats["warmup_ticks"] == 0
    assert captured.stats["ticks"] == eager.stats["ticks"] > 0
    for eng in (captured, eager):
        assert sorted(eng._free) == list(range(1, eng.num_pages))
        assert eng._reserved_unalloc == 0
        if kv == "int8":
            assert float(eng._scales[:, :, 1:-1].abs().sum()) == 0.0


@pytest.mark.cuda
def test_sampled_captured_tick_is_seeded(cuda):
    """The sampled variant (its own graph, the Gumbel noise drawn from
    the engine's generator inside it): in-vocab tokens, the same from
    two engines of one seed, greedy rows riding the same tick."""
    model = _tick_model(cuda, "bf16")
    outs = []
    for _ in range(2):
        eng = PagedKVEngine(model, device=cuda, seed=7, **_TICK_GEOM)
        rs = eng.submit([5, 9, 2], max_new_tokens=12, do_sample=True,
                        temperature=1.3, top_k=50, top_p=0.95)
        rg = eng.submit([5, 9, 2], max_new_tokens=12)
        eng.run_until_idle()
        assert ("tick", True) in eng._programs
        outs.append((rs.result(), rg.result()))
    assert outs[0] == outs[1]
    sampled, greedy = outs[0]
    assert len(sampled) == 12 and all(0 <= t < 256 for t in sampled)
    alone = PagedKVEngine(model, device=cuda, **_TICK_GEOM)
    assert alone.generate([[5, 9, 2]], max_new_tokens=12)[0] == greedy


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_captured_tick_launch_counts(cuda, kv):
    """A replay adds what its capture counted; the warm-up tick's
    launches are real and counted: after the run each kernel's count is
    (ticks + warm-up ticks) x its launches a tick, plus the prefill
    calls' own."""
    model = _tick_model(cuda, kv)
    eng = PagedKVEngine(model, device=cuda, kv_dtype=kv, **_TICK_GEOM)
    layers, n = _TICK_CFG["num_hidden_layers"], _TICK_GEOM["steps_per_tick"]
    decode = ("paged_decode_attention_int8" if kv == "int8"
              else "paged_decode_attention")
    before = {**tfn.launches, **tpa.launches, **tqm.launches}
    eng.generate([[5, 9, 2, 14], [17, 3, 11]], max_new_tokens=10)
    after = {**tfn.launches, **tpa.launches, **tqm.launches}
    grew = {k: after[k] - before[k] for k in after}
    steps = n * (eng.stats["ticks"] + eng.stats["warmup_ticks"])
    calls = eng.stats["prefill_calls"] + steps
    assert eng.stats["warmup_ticks"] == 1 and eng.stats["ticks"] >= 3
    assert grew[decode] == layers * steps
    assert grew["rms_norm_residual"] == (2 * layers + 1) * calls
    assert grew["rope_apply"] == 2 * layers * calls
    per_call = 7 * layers + 1
    assert grew["weight_only_int8_matmul"] == (per_call * calls
                                               if kv == "int8" else 0)
    delta = {k: v for _, k, v in eng._programs[("tick", False)].delta}
    want = {decode: layers * n, "rms_norm_residual": (2 * layers + 1) * n,
            "rope_apply": 2 * layers * n}
    if kv == "int8":
        want["weight_only_int8_matmul"] = per_call * n
    assert delta == want


@pytest.mark.cuda
def test_capture_counts_only_the_capturing_threads_launches(cuda):
    """While one engine captures its tick another thread keeps launching
    RMSNorm eagerly (a second replica's ticker on the same card): the
    capture's counts are its own tick's, and every eager launch of the
    other thread stays counted once."""
    import threading
    model = _tick_model(cuda, "bf16")
    eng = PagedKVEngine(model, device=cuda, **_TICK_GEOM)
    layers, n = _TICK_CFG["num_hidden_layers"], _TICK_GEOM["steps_per_tick"]
    x = torch.randn(8, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    stop, other = threading.Event(), [0]

    def launch():
        while not stop.is_set():
            tfn.rms_norm_residual(x, w, None, 1e-5)
            other[0] += 1
    before = dict(tfn.launches)
    t = threading.Thread(target=launch, daemon=True)
    t.start()
    try:
        eng.generate([[5, 9, 2, 14]], max_new_tokens=10)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and other[0] > 0
    delta = {k: v for _, k, v in eng._programs[("tick", False)].delta}
    assert delta == {"paged_decode_attention": layers * n,
                     "rms_norm_residual": (2 * layers + 1) * n,
                     "rope_apply": 2 * layers * n}
    steps = n * (eng.stats["ticks"] + eng.stats["warmup_ticks"])
    calls = eng.stats["prefill_calls"] + steps
    assert tfn.launches["rms_norm_residual"] - before["rms_norm_residual"] \
        == (2 * layers + 1) * calls + other[0]


@pytest.mark.cuda
def test_capture_unsafe_body_raises_and_runs_no_eager_tick(cuda,
                                                           monkeypatch):
    """A host sync planted in the tick body (an `.item()` on the card)
    makes the capture, and so step(), raise; the engine does not retreat
    to an eager tick."""
    model = _tick_model(cuda, "bf16")
    logits = model.logits

    def synced(h):
        float(h.sum().item())
        return logits(h)

    monkeypatch.setattr(model, "logits", synced)
    eng = PagedKVEngine(model, device=cuda, **_TICK_GEOM)
    r = eng.submit([5, 9, 2], max_new_tokens=6)
    with pytest.raises(RuntimeError):
        eng.step()
    assert eng.stats["ticks"] == 0 and eng.stats["decode_tokens"] == 0
    assert len(r.tokens) == 1          # the prefill's token, no tick's
    assert not eng._programs
    monkeypatch.undo()
    torch.cuda.synchronize()
    fresh = PagedKVEngine(model, device=cuda, **_TICK_GEOM)
    assert len(fresh.generate([[5, 9, 2]], max_new_tokens=6)[0]) == 6


@pytest.mark.cuda
def test_ticker_thread_captures_streams_and_cancels(cuda):
    """The ticker thread captures the tick (thread-local capture) and
    stream() gives each row generate()'s tokens (prompts in different
    prefill buckets, so each prefills alone either way); a request
    cancelled mid-decode returns its pages and reservation; stop()
    joins."""
    model = _tick_model(cuda, "bf16")
    geom = dict(_TICK_GEOM, max_pages_per_slot=8, num_pages=24)
    prompts = [[5, 9, 2, 14], [17, 3, 11, 4, 8, 1, 2, 7, 6]]
    want = PagedKVEngine(model, device=cuda, **geom).generate(
        prompts, max_new_tokens=12)
    eng = PagedKVEngine(model, device=cuda, **geom)
    try:
        ids = np.zeros((2, 9), np.int32)
        mask = np.zeros((2, 9), bool)
        for i, p in enumerate(prompts):
            ids[i, :len(p)], mask[i, :len(p)] = p, True
        rows = list(eng.stream(ids, max_new_tokens=12, attention_mask=mask))
        assert [[int(r[j]) for r in rows] for j in range(2)] == want
        assert ("tick", False) in eng._programs
        r = eng.submit([5, 9, 2], max_new_tokens=20)
        it = r.stream_tokens()
        next(it), next(it)
        r.cancel()
        assert r.done.wait(timeout=60)
        deadline = time.monotonic() + 60
        while eng.has_work() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(eng._free) == list(range(1, eng.num_pages))
        assert eng._reserved_unalloc == 0
        assert eng.stats["cancelled"] == 1
    finally:
        eng.stop()
    assert not eng._ticker.is_alive()


# the prefix cache and chunked prefill on the card: 31 pages of 4, two
# slots of up to 8, tails past 8 tokens in rounds of 8
_PREFIX_GEOM = dict(max_slots=2, page_size=4, num_pages=32,
                    max_pages_per_slot=8, steps_per_tick=3,
                    prefill_chunk=8, prefix_cache_pages=8)
_PREFIX = [5, 9, 2, 14, 17, 3, 11, 4]       # two full pages


def _prefix_scenario(eng):
    """A cold prompt that caches its two prefix pages, then a warm hit
    and, joining mid-decode of it, a long prompt prefilled in rounds."""
    ra = eng.submit(_PREFIX + [21, 22, 23], max_new_tokens=8)
    eng.run_until_idle()
    rb = eng.submit(_PREFIX + [31, 32], max_new_tokens=10)
    eng.step()
    rc = eng.submit(list(range(30, 51)), max_new_tokens=6)
    eng.run_until_idle()
    return [r.result() for r in (ra, rb, rc)]


def _settled(eng):
    cached = set(eng.prefix_cache.pages())
    assert set(eng._page_refs) == cached
    assert all(eng._page_refs[p] == 1 for p in cached)
    assert len(eng._free) + len(cached) == eng.num_pages - 1
    assert eng._reclaimable == len(cached) and eng._reserved_unalloc == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_warm_hit_and_chunked_prompt_captured_tick_gives_eager_tokens(cuda,
                                                                       kv):
    """A warm slot reads its shared pages through the block table the
    graph was captured over, and a chunked prompt joins mid-decode: the
    captured tick's greedy tokens equal the eager tick's."""
    model = _tick_model(cuda, kv)
    geom = dict(_PREFIX_GEOM, kv_dtype=kv)
    captured = PagedKVEngine(model, device=cuda, **geom)
    eager = _eager(PagedKVEngine(model, device=cuda, **geom))
    got = _prefix_scenario(captured)
    assert got == _prefix_scenario(eager)
    assert [len(t) for t in got] == [8, 10, 6]
    for eng in (captured, eager):
        assert eng.stats["prefix_hits"] == 1
        assert eng.stats["prefix_hit_tokens"] == 8
        # 11 tokens in rounds of 8 and 3, the warm 2-token tail whole,
        # 21 tokens in rounds of 8, 8 and 5
        assert eng.stats["prefill_tokens"] == 11 + 2 + 21
        assert eng.stats["prefill_calls"] == 2 + 1 + 3
        _settled(eng)
    assert set(captured._programs) == {("tick", False)}
    assert not eager._programs


@pytest.mark.cuda
def test_int8_warm_slot_keeps_the_shared_scale_rows(cuda):
    """The shared pages' int8 scale rows stay bit-equal through the warm
    request's tail prefill and its captured decode ticks."""
    model = _tick_model(cuda, "int8")
    eng = PagedKVEngine(model, device=cuda, kv_dtype="int8",
                        **_PREFIX_GEOM)
    eng.generate([_PREFIX + [21, 22, 23]], max_new_tokens=4)
    shared = [eng.prefix_cache.get(k) for k in chain_keys(_PREFIX, 4)]
    before = eng._scales[:, :, shared].clone()
    assert bool((before > 0).all())
    r = eng.submit(_PREFIX + [31, 32, 33], max_new_tokens=12)
    eng.step()
    assert eng._slots[0].pages[:2] == shared and eng._slots[0].shared == 2
    assert torch.equal(eng._scales[:, :, shared], before)
    eng.run_until_idle()
    assert len(r.result()) == 12
    assert torch.equal(eng._scales[:, :, shared], before)
    assert float(eng._scales[:, :, eng._free].abs().sum()) == 0.0
    _settled(eng)


@pytest.mark.cuda
def test_on_demand_eviction_between_replays_keeps_launch_counts(cuda):
    """A decode allocation that finds the free list dry evicts a cached
    page between two replays of the captured tick; the launch counts
    stay (ticks + warm-up ticks) x a tick's, plus the prefill calls',
    and the tokens equal the eager tick's."""
    model = _tick_model(cuda, "bf16")
    geom = dict(max_slots=1, page_size=4, num_pages=8, max_pages_per_slot=7,
                steps_per_tick=2, prefix_cache_pages=6)
    layers, n = _TICK_CFG["num_hidden_layers"], geom["steps_per_tick"]
    prompts = [list(range(1, 9)) + [40], [60 + i for i in range(12)]]
    outs = []
    for eng in (PagedKVEngine(model, device=cuda, **geom),
                _eager(PagedKVEngine(model, device=cuda, **geom))):
        evicted_at = []
        evict = eng._evict_prefix_entries

        def recorded(budget_only=True, eng=eng, evict=evict,
                     evicted_at=evicted_at):
            freed = evict(budget_only)
            if not budget_only and freed:
                evicted_at.append(eng.stats["ticks"])
            return freed
        eng._evict_prefix_entries = recorded
        before = {**tfn.launches, **tpa.launches}
        toks = [eng.generate([p], max_new_tokens=m)[0]
                for p, m in zip(prompts, (3, 12))]
        grew = {k: v - before[k] for k, v in {**tfn.launches,
                                              **tpa.launches}.items()}
        steps = n * (eng.stats["ticks"] + eng.stats["warmup_ticks"])
        calls = eng.stats["prefill_calls"] + steps
        assert evicted_at and min(evicted_at) > 1   # after replays ran
        assert grew["paged_decode_attention"] == layers * steps
        assert grew["rms_norm_residual"] == (2 * layers + 1) * calls
        assert grew["rope_apply"] == 2 * layers * calls
        outs.append(toks)
    assert outs[0] == outs[1]


# -- speculative decoding: the spec tick as one captured CUDA graph -------------

# a draft one layer deep at the target's widths, so the counts tell the
# two models apart
_SPEC_DRAFT_CFG = dict(_TICK_CFG, num_hidden_layers=1)
_SPEC_GEOM = dict(max_slots=2, page_size=4, num_pages=40,
                  max_pages_per_slot=8, spec_tokens=3)
_SAMPLE = dict(do_sample=True, temperature=1.3, top_k=50, top_p=0.95)


def _spec_models(dev, kv):
    draft = LlamaForCausalLM(tiny_llama_config(**_SPEC_DRAFT_CFG),
                             device=dev, dtype=torch.bfloat16, seed=5)
    if kv == "int8":
        draft = quantize_weight_only(draft)
    return _tick_model(dev, kv), draft


def _spec_scenario(eng, sample):
    """A mid-decode join and a queued request; with `sample`, the joiner
    samples beside the greedy slot."""
    ra = eng.submit([5, 9, 2, 14], max_new_tokens=9)
    eng.step()
    rb = eng.submit([17, 3, 11], max_new_tokens=12,
                    **(_SAMPLE if sample else {}))
    rc = eng.submit([40, 41], max_new_tokens=7)
    eng.run_until_idle()
    return [r.result() for r in (ra, rb, rc)]


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_captured_spec_tick_gives_the_eager_spec_bodys_tokens(cuda, kv,
                                                              sample):
    """Each spec tick is one replay of the graph cached under
    ("spec_tick", any_sample); its greedy rows equal the eager spec
    body's (the sampled row draws other noise: the warm-up tick consumed
    some), and every page returns with both models' int8 scale rows
    zeroed."""
    model, draft = _spec_models(cuda, kv)
    geom = dict(_SPEC_GEOM, kv_dtype=kv, seed=3)
    captured = PagedKVEngine(model, device=cuda, draft_model=draft, **geom)
    eager = _eager(PagedKVEngine(model, device=cuda, draft_model=draft,
                                 **geom))
    got = _spec_scenario(captured, sample)
    want = _spec_scenario(eager, sample)
    assert [len(t) for t in got] == [9, 12, 7]
    greedy = [0, 2] if sample else [0, 1, 2]
    assert [got[i] for i in greedy] == [want[i] for i in greedy]
    assert all(0 <= t < _TICK_CFG["vocab_size"] for t in got[1])
    assert ("spec_tick", sample) in captured._programs
    assert all(k[0] == "spec_tick" for k in captured._programs)
    assert not eager._programs and eager.stats["warmup_ticks"] == 0
    assert captured.stats["warmup_ticks"] == len(captured._programs)
    for eng in (captured, eager):
        st = eng.stats
        assert st["spec_ticks"] == st["ticks"] > 0
        assert 0 <= st["spec_accepted"] <= st["spec_proposed"]
        assert sorted(eng._free) == list(range(1, eng.num_pages))
        assert eng._reserved_unalloc == 0
        if kv == "int8":
            for planes in (eng._scales, eng._draft_scales):
                assert float(planes[:, :, 1:-1].abs().sum()) == 0.0
    if not sample:
        assert captured.stats["ticks"] == eager.stats["ticks"]


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_captured_spec_tick_launch_counts(cuda, kv, sample):
    """A spec tick launches, per replay: the decode kernel L_d (g + 1)
    times (g draft steps and the bonus write; the verify attends over
    `_attend_pages`), RMSNorm (2 L_d + 1)(g + 1) + 2 L_t + 1 and RoPE
    2 L_d (g + 1) + 2 L_t times, and for W8A16 models (7 L_d + 1) g + 7 L_d
    (the bonus step forms no logits) + 7 L_t + 1 products, the verify's
    7 L_t + 1 at M = 8 (g + 1) = 40 on the wgmma route. Each prefill call
    runs both models. The totals of a run are those counts times
    (ticks + warm-up ticks) plus the prefill calls'."""
    model, draft = _spec_models(cuda, kv)
    g = 4
    eng = PagedKVEngine(model, device=cuda, draft_model=draft, kv_dtype=kv,
                        **dict(_SPEC_GEOM, max_slots=8, spec_tokens=g))
    lt, ld = _TICK_CFG["num_hidden_layers"], _SPEC_DRAFT_CFG[
        "num_hidden_layers"]
    decode = ("paged_decode_attention_int8" if kv == "int8"
              else "paged_decode_attention")
    tick = {decode: ld * (g + 1),
            "rms_norm_residual": (2 * ld + 1) * (g + 1) + 2 * lt + 1,
            "rope_apply": 2 * ld * (g + 1) + 2 * lt}
    call = {"rms_norm_residual": 2 * lt + 1 + 2 * ld + 1,
            "rope_apply": 2 * lt + 2 * ld}
    if kv == "int8":
        tick["weight_only_int8_matmul"] = ((7 * ld + 1) * g + 7 * ld
                                           + 7 * lt + 1)
        tick["weight_only_int8_matmul_wgmma"] = 7 * lt + 1
        call["weight_only_int8_matmul"] = 7 * lt + 1 + 7 * ld
    before = {**tfn.launches, **tpa.launches, **tqm.launches}
    # two prompts of 4 tokens: one prefill call at M = 8 (split-K)
    kw = _SAMPLE if sample else {}
    eng.generate([[5, 9, 2, 14], [17, 3, 11, 4]], max_new_tokens=10, **kw)
    after = {**tfn.launches, **tpa.launches, **tqm.launches}
    grew = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    runs = eng.stats["ticks"] + eng.stats["warmup_ticks"]
    assert eng.stats["warmup_ticks"] == 1 and eng.stats["ticks"] >= 2
    calls = eng.stats["prefill_calls"]
    want = {k: n * runs + call.get(k, 0) for k, n in tick.items()}
    assert grew == want
    delta = {k: v for _, k, v in eng._programs[("spec_tick", sample)].delta}
    assert delta == tick
    assert calls == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_captured_graph_holds_the_counted_kernel_nodes(cuda, kv):
    """The engine keeps each captured cudaGraph_t beside its
    instantiation: the spec tick's graph, as the CUDA driver lists it,
    holds as many nodes of each port kernel as its capture counted
    (`chip_smoke.py` gates a replay's launches on this list)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model, draft = _spec_models(cuda, kv)
    eng = PagedKVEngine(model, device=cuda, draft_model=draft, kv_dtype=kv,
                        **dict(_SPEC_GEOM, max_slots=8, spec_tokens=4))
    eng.generate([[5, 9, 2, 14], [17, 3, 11, 4]], max_new_tokens=6)
    program = eng._programs[("spec_tick", False)]
    gain = dict.fromkeys({**tfn.launches, **tpa.launches, **tqm.launches}, 0)
    for _, k, n in program.delta:
        gain[k] += n
    want = smoke._trace_want(gain)
    nodes, kinds = smoke._graph_nodes(program, want)
    assert nodes == want
    assert want["paged_decode_split<"] > 0 and want["rope_kernel<"] > 0
    assert (want["w8a16_wgmma_kernel<"] > 0) == (kv == "int8")
    assert kinds["KERNEL"] > sum(want.values())


@pytest.mark.cuda
def test_two_sampled_spec_replays_from_one_state_draw_other_noise(cuda):
    """The sampled graph registers the engine's generator: two replays
    from the same pools and inputs give other tokens."""
    model, draft = _spec_models(cuda, "bf16")
    eng = PagedKVEngine(model, device=cuda, draft_model=draft, **_SPEC_GEOM)
    for p in ([5, 9, 2], [17, 3, 11]):
        eng.submit(p, max_new_tokens=20, **_SAMPLE)
    eng._admit()
    program = eng._tick_program(True)        # captures (idle inputs)
    eng._slot_arrays([0, 1])
    for k, t in eng._inputs.items():
        t.copy_(eng._staging[k])
    pools = [t for grp in eng.pools + eng.draft_pools for t in grp]
    saved = [t.clone() for t in pools]
    outs = []
    for _ in range(2):
        for t, s in zip(pools, saved):
            t.copy_(s)
        program()
        outs.append(eng._outputs.clone())
    assert not torch.equal(outs[0], outs[1])
    vocab = _TICK_CFG["vocab_size"]
    g = _SPEC_GEOM["spec_tokens"]
    for out in outs:
        assert bool(((out[:, :g + 1] >= 0) & (out[:, :g + 1] < vocab)).all())
        assert bool(((out[:, g + 1] >= 1) & (out[:, g + 1] <= g + 1)).all())


@pytest.mark.cuda
def test_draft_the_decode_kernel_refuses_raises_at_construction(cuda):
    """No fallback: a draft of head_dim 32 (the decode kernel takes 64,
    128 or 256) raises when the engine is built."""
    model = _tick_model(cuda, "bf16")
    draft = LlamaForCausalLM(
        tiny_llama_config(**dict(_TICK_CFG, hidden_size=128)), device=cuda,
        dtype=torch.bfloat16, seed=5)
    with pytest.raises(ValueError, match="head_dim"):
        PagedKVEngine(model, device=cuda, draft_model=draft, **_SPEC_GEOM)


# -- the host KV tier and disaggregated roles ---------------------------------

_TIER_GEOM = dict(max_slots=1, page_size=4, num_pages=32,
                  max_pages_per_slot=8, steps_per_tick=3,
                  prefix_cache_pages=2, host_tier_bytes=1 << 20)


def _tier_scenario(eng):
    """A prompt that caches its two prefix pages; two more prompts that
    evict them (spilled) and take and write over the recycled pages;
    the first prompt again, restored from the host tier."""
    pa = _PREFIX + [21, 22, 23]
    first = eng.generate([pa], max_new_tokens=6)[0]
    eng.generate([[60 + i for i in range(9)]], max_new_tokens=2)
    assert eng.host_tier.flush()
    eng.generate([[30 + i for i in range(10)]], max_new_tokens=6)
    again = eng.generate([pa], max_new_tokens=6)[0]
    return first, again


def _pool_ptrs(eng):
    return [t.data_ptr() for grp in eng.pools for t in grp] + [
        eng._kv.data_ptr(),
        None if eng._scales is None else eng._scales.data_ptr()]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_restore_keeps_pool_addresses_and_the_captured_ticks_tokens(cuda,
                                                                    kv):
    """A restore writes the pools in place: every pool's data_ptr() is
    unchanged, the tick captured before it is replayed after it (no
    recapture), and its tokens equal the eager tick's."""
    model = _tick_model(cuda, kv)
    geom = dict(_TIER_GEOM, kv_dtype=kv)
    captured = PagedKVEngine(model, device=cuda, **geom)
    eager = _eager(PagedKVEngine(model, device=cuda, **geom))
    try:
        captured.generate([[7, 8, 9]], max_new_tokens=4)   # captures
        ptrs = _pool_ptrs(captured)
        program = captured._programs[("tick", False)]
        got = _tier_scenario(captured)
        assert got == _tier_scenario(eager)
        assert got[0] == got[1] and len(got[0]) == 6
        assert _pool_ptrs(captured) == ptrs
        assert captured._programs[("tick", False)] is program
        assert captured.stats["warmup_ticks"] == 1
        for eng in (captured, eager):
            snap = eng.kvtier_stats()
            assert snap["restored_pages"] == 2 and snap["spill_errors"] == 0
            _settled(eng)
    finally:
        captured.stop()
        eager.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_spilled_bytes_equal_the_pool_page_at_capture(cuda, kv):
    """The host entry holds the page as it stood when it was evicted, in
    pinned memory, although the next request has written over the page
    (int8: its scales zeroed and grown again) by the time the worker
    commits."""
    model = _tick_model(cuda, kv)
    eng = PagedKVEngine(model, device=cuda, **dict(_TIER_GEOM, kv_dtype=kv))
    try:
        eng.generate([_PREFIX + [21, 22, 23]], max_new_tokens=6)
        keys = chain_keys(_PREFIX, 4)
        pages = eng.prefix_cache.match(keys)
        idx = torch.tensor(pages, device=cuda)
        kv0 = eng._kv[:, :, idx].cpu()
        sc0 = None if eng._scales is None else eng._scales[:, :, idx].cpu()
        eng.generate([[60 + i for i in range(9)]], max_new_tokens=2)
        eng.generate([[30 + i for i in range(10)]], max_new_tokens=6)
        assert eng.host_tier.flush()
        assert not torch.equal(eng._kv[:, :, idx].cpu(), kv0)
        for j, key in enumerate(keys):
            entry = eng.host_tier._entries[key]
            assert entry.draft is None
            for li, grp in enumerate(entry.layers):
                assert len(grp) == (4 if kv == "int8" else 2)
                for c in range(2):
                    assert grp[c].is_pinned()
                    assert torch.equal(grp[c], kv0[li, c, j])
                    if sc0 is not None:
                        assert torch.equal(grp[2 + c], sc0[li, c, j])
    finally:
        eng.stop()


@pytest.mark.cuda
def test_suspended_session_resumes_to_the_eager_tokens(cuda):
    """A session's pages spill when it idles, the device cache empties,
    and the next turn, restored, gives the eager tick's tokens."""
    model = _tick_model(cuda, "bf16")
    geom = dict(_TIER_GEOM, num_pages=64, max_pages_per_slot=16,
                prefix_cache_pages=16, suspend_after_s=0.3)
    outs = []
    for eager in (False, True):
        eng = PagedKVEngine(model, device=cuda, **geom)
        if eager:
            _eager(eng)
        try:
            turn1 = [int(x) for x in np.random.RandomState(3).randint(
                1, 97, 11)]
            out1 = eng.generate([turn1], max_new_tokens=8, session="s")[0]
            time.sleep(0.4)
            eng.step()                          # the sweep spills
            assert eng.host_tier.flush()
            assert len(eng.prefix_cache) == 0
            assert len(eng._free) == eng.num_pages - 1
            turn2 = turn1 + out1 + [3, 1, 4]
            out2 = eng.generate([turn2], max_new_tokens=6, session="s")[0]
            snap = eng.kvtier_stats()
            assert snap["suspends"] == 1 and snap["resumes"] == 1
            assert snap["restored_pages"] >= 4
            outs.append((out1, out2))
        finally:
            eng.stop()
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_disagg_handoff_on_the_card_gives_the_monolithic_tokens(cuda):
    """export -> pack -> unpack -> stage -> decode between two engines on
    the card, int8 KV: the monolithic engine's tokens and the prefill
    engine's page bytes."""
    from paddle_tpu_torch.inference.disagg import pack_bundle, unpack_bundle
    model = _tick_model(cuda, "int8")
    geom = dict(_TIER_GEOM, kv_dtype="int8", max_slots=2,
                prefix_cache_pages=8)
    geom.pop("host_tier_bytes")
    mono = PagedKVEngine(model, device=cuda, **geom)
    pre = PagedKVEngine(model, device=cuda, role="prefill",
                        host_tier_bytes=1 << 20, **geom)
    dec = PagedKVEngine(model, device=cuda, role="decode", **geom)
    try:
        prompt = _PREFIX + [21, 22, 23]
        want = mono.generate([prompt], max_new_tokens=6)[0]
        pre.generate([prompt], max_new_tokens=1)
        keys = chain_keys(prompt, 4)
        dec.stage_import(unpack_bundle(pack_bundle(pre.export_pages(keys))))
        assert dec.generate([prompt], max_new_tokens=6)[0] == want
        for key in keys:
            p, q = pre.prefix_cache.get(key), dec.prefix_cache.get(key)
            for gp, gd in zip(pre.pools, dec.pools):
                for a, b in zip(gp, gd):
                    assert torch.equal(a[p], b[q])
    finally:
        for e in (mono, pre, dec):
            e.stop()


@pytest.mark.cuda
def test_kernel_jnp_on_the_card_raises(cuda):
    """No plain decode path on the card: kernel='jnp' raises, None and
    'pallas' both take the hand-written kernel."""
    model = _tick_model(cuda, "bf16")
    with pytest.raises(ValueError, match="kernel='jnp'"):
        PagedKVEngine(model, device=cuda, kernel="jnp", **_TICK_GEOM)
    for kernel in (None, "pallas"):
        eng = PagedKVEngine(model, device=cuda, kernel=kernel, **_TICK_GEOM)
        assert eng.decode_kernel == "cuda"


def _http_generate(port, ids, max_new, stream, rid):
    """One /generate round trip to a local PredictorServer; the tokens
    of each row, and the echoed request id."""
    import json
    import urllib.request
    body = json.dumps({"ids": ids, "max_new_tokens": max_new,
                       "stream": stream}).encode()
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=body,
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    with urllib.request.urlopen(r, timeout=120) as resp:
        assert resp.status == 200
        echoed = resp.headers["X-Request-Id"]
        text = resp.read().decode()
    if not stream:
        return json.loads(text)["sequences"], echoed
    steps = [json.loads(ln)["tokens"] for ln in text.splitlines()
             if ln.strip() and "tokens" in json.loads(ln)]
    return [[s[b] for s in steps] for b in range(len(steps[0]))], echoed


@pytest.mark.cuda
def test_http_serving_over_the_captured_engine(cuda):
    """A tiny f32 model behind the port's PredictorServer on the card:
    HTTP tokens (unary and streamed, from concurrent clients) equal the
    same engine's direct generate() (the tick runs every slot whether
    idle or not, so a row's decode does not depend on its neighbours); the wave recaptures nothing (the
    captured program and every pool address unchanged); the
    decode-kernel counter counts one per tick on the "cuda" path; the
    request.* instruments count every request."""
    import threading
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference.serving import PredictorServer
    model = LlamaForCausalLM(tiny_llama_config(**_TICK_CFG), device=cuda,
                             dtype=torch.float32, seed=0)
    geom = dict(max_slots=4, page_size=4, num_pages=72,
                max_pages_per_slot=16, steps_per_tick=3)
    # prompts in four prefill buckets (8, 16, 32, 64), so each prefills
    # alone whether the clients arrive together or not
    rng = np.random.RandomState(0)
    prompts = [[int(x) for x in rng.randint(1, 256, n)]
               for n in (4, 9, 17, 33)]
    eng = PagedKVEngine(model, device=cuda, **geom)
    srv = None
    try:
        want = [eng.generate([p], max_new_tokens=8)[0] for p in prompts]
        program = eng._programs[("tick", False)]
        ptrs = _pool_ptrs(eng)
        warm = eng.stats["warmup_ticks"]
        ticks0 = eng.stats["ticks"]
        obs.enable(reset=True)
        srv = PredictorServer(lambda d: d, generator=eng).start()
        got, errs = {}, []

        def client(i):
            try:
                got[i] = _http_generate(srv.port, [prompts[i]], 8,
                                        stream=i % 2 == 0, rid=f"r{i}")
            except Exception as e:      # noqa: BLE001
                errs.append(e)
        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errs, errs
        for i, p in enumerate(prompts):
            rows, echoed = got[i]
            assert rows == [want[i]] and echoed == f"r{i}"
        deadline = time.monotonic() + 60
        while (eng.has_work() or obs.requests.live_count()) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng._programs[("tick", False)] is program
        assert list(eng._programs) == [("tick", False)]
        assert _pool_ptrs(eng) == ptrs
        assert eng.stats["warmup_ticks"] == warm
        reg = obs.REGISTRY
        assert reg.counter("inference.decode.kernel").value(path="cuda") \
            == eng.stats["ticks"] - ticks0
        assert reg.histogram("request.ttft.seconds").count() == len(prompts)
        # one terminal outcome a request: the engine's retire and the
        # HTTP handler race for it
        outcome = reg.counter("request.outcome")
        assert outcome.value(reason="finished") + outcome.value(
            reason="ok") == len(prompts) == sum(outcome.labeled().values())
        assert sorted(eng._free) == list(range(1, eng.num_pages))
        with pytest.raises(ValueError, match="kernel='jnp'"):
            PagedKVEngine(model, device=cuda, kernel="jnp", **geom)
    finally:
        obs.disable()
        if srv is not None:
            srv.stop()
        eng.stop()


# -- static-cache generation (models/generation.py) -------------------------------

def _smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _gen_batch():
    """Three prompts of 7, left-padded by 0, 2 and 4 tokens, and the keep
    mask."""
    rng = np.random.RandomState(1)
    ids = rng.randint(1, 256, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), bool)
    mask[1, :2] = mask[2, :4] = False
    return ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_captured_generation_gives_the_eager_bodies_tokens(cuda, int8,
                                                           monkeypatch):
    """The per-token decode step and the block as captured graphs give
    the tokens of the same bodies run eagerly, bf16 and W8A16; each graph
    holds exactly the kernel nodes its capture counted (one and four
    model calls' worth)."""
    from paddle_tpu_torch.core.graphs import CapturedProgram
    from paddle_tpu_torch.models import generation as tgen
    model = _tick_model(cuda, "int8" if int8 else "bf16")
    ids, mask = _gen_batch()
    captured = [tgen.generate(model, ids, 9, attention_mask=mask,
                              tokens_per_fetch=n).numpy() for n in (1, 4)]
    steps = tgen._compiled_steps(model, 3, 16, False)
    assert isinstance(steps.programs["decode"], CapturedProgram)
    assert isinstance(steps.programs[("block", 4)], CapturedProgram)
    assert np.array_equal(captured[0], captured[1])
    # each graph has a pool of its own, which the entry's size counts
    pools = [p.pool_bytes for p in steps.programs.values()]
    kv = sum(t.numel() * t.element_size() for pair in steps.caches
             for t in pair)
    assert min(pools) > 0 and steps.nbytes() > kv + sum(pools)
    smoke = _smoke()
    for key, n in (("decode", 1), (("block", 4), 4)):
        program = steps.programs[key]
        gain = dict.fromkeys({**tfn.launches, **tpa.launches,
                              **tqm.launches}, 0)
        for _, k, c in program.delta:
            gain[k] += c
        assert gain["rms_norm_residual"] == 5 * n
        assert gain["rope_apply"] == 4 * n
        assert gain["weight_only_int8_matmul"] == (15 * n if int8 else 0)
        assert gain["paged_decode_attention"] == 0
        want = smoke._trace_want(gain)
        assert smoke._graph_nodes(program, want)[0] == want
    model.__dict__.pop("_gen_step_cache")
    monkeypatch.setattr(tgen, "capture_graph", lambda body, device, **kw:
                        body)
    for n, want in zip((1, 4), captured):
        got = tgen.generate(model, ids, 9, attention_mask=mask,
                            tokens_per_fetch=n).numpy()
        assert np.array_equal(got, want), n


@pytest.mark.cuda
def test_tail_block_on_the_card_stays_inside_max_len(cuda):
    """max_new_tokens 7 at tokens_per_fetch 4: the last block's steps past
    its limit write only the buffers' last slot (an index past max_len
    would fault the card); tokens and the k/v below that slot are the
    per-token run's."""
    from paddle_tpu_torch.models import generation as tgen
    model = LlamaForCausalLM(tiny_llama_config(**_TICK_CFG), device=cuda,
                             dtype=torch.float32, seed=0)
    ids, mask = _gen_batch()
    per_token = tgen.generate(model, ids, 7, attention_mask=mask).numpy()
    steps = tgen._compiled_steps(model, 3, 14, False)
    kv = [t[:, :-1].clone() for pair in steps.caches for t in pair]
    blocked = tgen.generate(model, ids, 7, attention_mask=mask,
                            tokens_per_fetch=4).numpy()
    torch.cuda.synchronize()
    assert np.array_equal(blocked, per_token)
    for a, b in zip(kv, [t[:, :-1] for pair in steps.caches for t in pair]):
        assert torch.equal(a, b)
    assert steps.stats["block_steps"] == 8          # two runs of 4


@pytest.mark.cuda
def test_sampled_block_graph_is_seeded(cuda):
    """The sampled block's graph registers its generator, seeded per
    stream after the capture: one seed repeats (the capture's own first
    stream included), another differs, and top_k=1 gives greedy (f32: no
    ties). Seeded per-token sampling repeats too."""
    from paddle_tpu_torch.models import generation as tgen
    model = LlamaForCausalLM(tiny_llama_config(**_TICK_CFG), device=cuda,
                             dtype=torch.float32, seed=0)
    ids, mask = _gen_batch()
    kw = dict(attention_mask=mask, do_sample=True, temperature=0.8,
              top_k=20, tokens_per_fetch=4)
    s1 = tgen.generate(model, ids, 10, seed=11, **kw).numpy()
    s2 = tgen.generate(model, ids, 10, seed=11, **kw).numpy()
    s3 = tgen.generate(model, ids, 10, seed=12, **kw).numpy()
    assert np.array_equal(s1, s2) and not np.array_equal(s1, s3)
    greedy = tgen.generate(model, ids, 10, attention_mask=mask).numpy()
    k1 = tgen.generate(model, ids, 10, seed=3, **{**kw, "top_k": 1}).numpy()
    assert np.array_equal(k1, greedy)
    p1, p2 = (tgen.generate(model, ids, 10, attention_mask=mask,
                            do_sample=True, top_p=0.9, seed=4).numpy()
              for _ in range(2))
    assert np.array_equal(p1, p2)


@pytest.mark.cuda
def test_generation_capture_error_raises_and_runs_no_eager_step(
        cuda, monkeypatch):
    """A host sync planted in the model (an `.item()` on the card) makes
    the decode step's and the block's capture raise; generation does not
    retreat to the eager body, and a fresh model generates afterwards."""
    from paddle_tpu_torch.models import generation as tgen
    model = _tick_model(cuda, "bf16")
    logits = model.logits

    def synced(h):
        float(h.sum().item())
        return logits(h)

    monkeypatch.setattr(model, "logits", synced)
    ids, mask = _gen_batch()
    for n in (1, 3):
        it = tgen.generate_stream(model, ids, 6, attention_mask=mask,
                                  tokens_per_fetch=n)
        assert next(it).shape == (3,)      # the eager prefill
        with pytest.raises(RuntimeError):
            next(it)
    steps = tgen._compiled_steps(model, 3, 13, False)
    assert not steps.programs and steps.stats["decode_steps"] == 0
    monkeypatch.undo()
    torch.cuda.synchronize()
    fresh = _tick_model(cuda, "bf16")
    assert tgen.generate(fresh, ids, 6, attention_mask=mask).shape == (3, 13)


# -- checkpoints and training telemetry --------------------------------------

def _ckpt_trainer(dev, seed=0, **step_kw):
    cfg = tiny_llama_config(num_hidden_layers=2, vocab_size=500,
                            hidden_size=256, num_attention_heads=4,
                            num_key_value_heads=2, use_flash_attention=True,
                            recompute=True, loss_chunk=16)
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    return Trainer(model, topt.AdamW(learning_rate=1e-3,
                                     parameters=model.named_parameters()),
                   TrainStepConfig(compute_dtype="bfloat16", **step_kw))


def _ckpt_batch(dev):
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 500, (2, 128)).astype(np.int32)).to(dev)
    return {"input_ids": ids, "labels": ids}


def _card_state(tr):
    sd = tr.checkpoint_state()
    out = {f"p/{n}": t.clone() for n, t in sd["params"].items()}
    for n, st in sd["opt"].items():
        out.update({f"o/{n}/{k}": t.clone() for k, t in st.items()})
    return out


@pytest.mark.cuda
def test_checkpoint_of_cuda_tensors_round_trips_bit_equal(cuda, tmp_path):
    """f32, bf16, int32 and 0-d tensors on the card: saved through the
    pinned snapshot, loaded in place into card tensors (and into CPU
    ones) bit for bit."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    g = torch.Generator(device=cuda).manual_seed(0)
    sd = {"w": torch.randn(300, 70, device=cuda, generator=g),
          "n": {"b": torch.randn(33, device=cuda, generator=g).to(
                    torch.bfloat16),
                "i": torch.arange(-5, 6, device=cuda, dtype=torch.int32),
                "s": torch.tensor(0.25, device=cuda)},
          "t": torch.randn(64, 64, device=cuda, generator=g).t()}
    ckpt.save_state_dict(sd, str(tmp_path))
    assert ckpt.verify_checkpoint(str(tmp_path)) == {}
    for dev in (cuda, torch.device("cpu")):
        tgt = {"w": torch.zeros(300, 70, device=dev),
               "n": {"b": torch.zeros(33, device=dev, dtype=torch.bfloat16),
                     "i": torch.zeros(11, device=dev, dtype=torch.int32),
                     "s": torch.zeros((), device=dev)},
               "t": torch.zeros(64, 64, device=dev)}
        keep = tgt["w"]
        ckpt.load_state_dict(tgt, str(tmp_path))
        assert tgt["w"] is keep and keep.device.type == dev.type
        for a, b in ((tgt["w"], sd["w"]), (tgt["n"]["i"], sd["n"]["i"]),
                     (tgt["n"]["s"], sd["n"]["s"]), (tgt["t"], sd["t"]),
                     (tgt["n"]["b"].view(torch.int16),
                      sd["n"]["b"].view(torch.int16))):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_async_snapshot_is_immune_to_the_steps_that_follow(cuda, tmp_path,
                                                           monkeypatch):
    """AsyncCheckpointer.save returns after the host snapshot: two
    in-place steps run while the writer is held, and the checkpoint
    still loads as the state at save time; a fresh trainer resumed
    from it takes the uninterrupted run's next steps bit for bit."""
    import threading
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.async_checkpoint import (
        AsyncCheckpointer)
    gate = threading.Event()
    write = ckpt._write_files

    def held(*a, **k):
        assert gate.wait(60)
        return write(*a, **k)

    monkeypatch.setattr(ckpt, "_write_files", held)
    batch = _ckpt_batch(cuda)
    tr = _ckpt_trainer(cuda)
    for _ in range(2):
        tr.step(batch)
    with AsyncCheckpointer() as cp:
        tr.checkpointer = cp
        tr.save_checkpoint(str(tmp_path / "c"))
        at_save = _card_state(tr)
        after = [float(tr.step(batch)) for _ in range(2)]
        assert cp.pending == 1
        gate.set()
        cp.flush()
    fresh = _ckpt_trainer(cuda, seed=1)
    fresh.load_checkpoint(str(tmp_path / "c"))
    got = _card_state(fresh)
    assert got.keys() == at_save.keys()
    assert all(torch.equal(got[k], at_save[k]) for k in got)
    assert [float(fresh.step(batch)) for _ in range(2)] == after


@pytest.mark.cuda
def test_telemetry_loss_read_adds_no_stream_sync(cuda):
    """With observability on, steps on placed batches run under
    torch.cuda's sync debug mode "error": the telemetry stages each loss
    to pinned memory behind an event and reads it once the event has
    completed, so it adds no synchronizing call; flush() then publishes
    the lagged losses."""
    from paddle_tpu_torch import observability
    batch = _ckpt_batch(cuda)
    tr = _ckpt_trainer(cuda)
    tr.step(batch)
    torch.cuda.synchronize()
    with observability.scoped() as reg:
        losses = [tr.step(batch)]
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(12):             # past the 8-step loss lag
                losses.append(tr.step(batch))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        tel = tr.telemetry
        assert tel.steps == 12 and reg.counter("train.steps").value() == 12
        tel.flush()
        assert reg.gauge("train.loss").value() == float(losses[-2])
        assert reg.gauge("train.mfu").value() >= 0.0


def _wait_done(wd, op, timeout=30.0):
    """Until the completer has ended `op` (no longer registered)."""
    deadline = time.time() + timeout
    while op[1] in wd._py._ops:
        assert time.time() < deadline, f"{op[2]} never completed"
        time.sleep(0.005)


@pytest.mark.cuda
def test_complete_when_ready_makes_no_host_sync(cuda):
    """Under torch.cuda's sync debug mode "error" (any synchronizing call
    raises), complete_when_ready records its event and returns while the
    device still works; the completer ends the op once the work is done,
    inside its deadline (nothing counted expired)."""
    from paddle_tpu_torch.distributed import watchdog as wd
    wd.enable(poll_ms=10)
    x = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    before = wd.expired_count()
    op = wd.begin("matmul rank=0", timeout_ms=60_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = x
        for _ in range(8):
            y = y @ x
        wd.complete_when_ready(op, [y])
        assert op[1] in wd._py._ops        # the device is still working
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _wait_done(wd, op)
    assert wd.expired_count() == before


@pytest.mark.cuda
def test_op_held_past_its_deadline_on_the_card_is_counted_expired(cuda):
    """A kernel that spins for about half a second (torch.cuda._sleep)
    holds its op past a 50 ms deadline: the poller counts it expired,
    names it, and the completer still ends it."""
    from paddle_tpu_torch.distributed import watchdog as wd
    wd.enable(poll_ms=10)
    before = wd.expired_count()
    op = wd.begin("held rank=0", timeout_ms=50)
    torch.cuda._sleep(int(1e9))             # ~0.5 s at the H100's clocks
    wd.complete_when_ready(op, [torch.empty(1, device=cuda)])
    _wait_done(wd, op)
    assert wd.expired_count() == before + 1
    assert wd.last_expired() == "held rank=0"


@pytest.mark.cuda
def test_sentried_nan_step_on_the_card_leaves_the_state_bit_equal(
        cuda, tmp_path):
    """TrainingSentry.run (skip policy) on the card: the step where
    train.grad.nan fires is suppressed on the device, and every
    parameter and moment after it is bit-equal to before it (the state
    is copied when the run asks for that step's batch)."""
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.distributed.sentry import (SentryConfig,
                                                     TrainingSentry)
    batch = _ckpt_batch(cuda)
    tr = _ckpt_trainer(cuda, health_probe=True)
    k, before = 2, {}

    def batch_for(cursor):
        if cursor == k:
            before.update(_card_state(tr))
        return batch

    with chaos.scoped(seed=_nan_seed_at(k),
                      rates={"train.grad.nan": (0.3, 1)}):
        out = TrainingSentry(SentryConfig(policy="skip")).run(
            tr, batch_for, k + 1, str(tmp_path), checkpoint_interval=100)
    assert out["skips"] == 1 and out["triggers"] == {"nonfinite_grad": 1}
    after = _card_state(tr)
    assert after.keys() == before.keys()
    assert all(torch.equal(after[n], before[n]) for n in after)


def _nan_seed_at(k, rate=0.3):
    """A chaos seed at which `train.grad.nan` at `rate` first fires at
    decision k (the Trainer consults the site once a step)."""
    from paddle_tpu_torch.distributed import chaos
    for seed in range(10_000):
        with chaos.scoped(seed=seed, rates={"train.grad.nan": rate}):
            fires = [chaos.should_fire("train.grad.nan")
                     for _ in range(k + 1)]
        if True in fires and fires.index(True) == k:
            return seed
    raise AssertionError("no seed")


def _offload_trainer(cuda, offload):
    """A 2-layer Llama on the card, bf16 compute, AdamW with the global
    norm clip, the health probe; `offload_opt_state` on or off."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               tiny_llama_config)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = tiny_llama_config(num_hidden_layers=2, hidden_size=256,
                            intermediate_size=512, num_attention_heads=4,
                            num_key_value_heads=2, vocab_size=512)
    model = LlamaForCausalLM(cfg, device=cuda, seed=0)
    opt = topt.AdamW(learning_rate=1e-3, parameters=model.named_parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
    return Trainer(model, opt, TrainStepConfig(
        compute_dtype="bfloat16", health_probe=True,
        offload_opt_state=offload))


def _offload_batch(cuda):
    g = torch.Generator(device=cuda).manual_seed(26)
    ids = torch.randint(0, 512, (4, 64), generator=g, device=cuda)
    return {"input_ids": ids, "labels": ids}


@pytest.mark.cuda
def test_offloaded_optimizer_state_trains_bit_equal(cuda, monkeypatch):
    """offload_opt_state: the moments live in pinned host memory between
    steps and the update runs a chunk at a time on the card (chunks of
    64 KiB here, so several), by the same arithmetic: the losses, the
    probes, the parameters and the moments (read back through
    checkpoint_state) are bit-equal to the run without it."""
    from paddle_tpu_torch import optimizer as topt
    monkeypatch.setattr(topt, "PARK_CHUNK_BYTES", 1 << 16)
    batch = _offload_batch(cuda)
    runs = {}
    for offload in (False, True):
        tr = _offload_trainer(cuda, offload)
        losses, probes = [], []
        for _ in range(3):
            losses.append(float(tr.step(batch)))
            probes.append(tr.last_probe.tolist())
        assert tr.config.offload_opt_state is offload
        st = tr.optimizer.state["lm_head.weight"]
        assert st["moment1"].is_cuda is not offload
        assert st["moment1"].is_pinned() is offload
        flat = {}
        for part, tensors in tr.checkpoint_state().items():
            for n, v in tensors.items():
                if isinstance(v, dict):
                    flat.update({(part, n, k): t.cpu() for k, t in v.items()})
                else:
                    flat[(part, n)] = v.cpu()
        runs[offload] = (losses, probes, flat)
    (l0, p0, s0), (l1, p1, s1) = runs[False], runs[True]
    assert l0 == l1 and p0 == p1
    assert s0.keys() == s1.keys()
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.cuda
def test_offload_keeps_the_moments_off_the_card(cuda):
    """After a step the card holds the moments' bytes less with
    offload_opt_state (8 bytes a parameter; the beta powers stay)."""
    allocated = {}
    for offload in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        tr = _offload_trainer(cuda, offload)
        tr.step(_offload_batch(cuda))
        torch.cuda.synchronize()
        allocated[offload] = torch.cuda.memory_allocated() - base
        n = sum(p.numel() for p in tr.model.parameters())
        on_card = sum(v.numel() * v.element_size()
                      for st in tr.optimizer.state.values()
                      for v in st.values() if v.is_cuda)
        assert on_card == (8 * n + 8 * len(tr.optimizer.state)
                           if not offload else 8 * len(tr.optimizer.state))
        del tr
    assert allocated[False] - allocated[True] >= 8 * n
