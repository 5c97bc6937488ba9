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
"""
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.inference.paged import PagedKVEngine
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
