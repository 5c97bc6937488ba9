"""Blockwise cross-entropy: the hidden -> vocab projection fused with
softmax-CE, so the [N, V] logits never exist, forward or backward.

Counterpart of paddle_tpu/kernels/blockwise_ce.py. Per row i of x (N, D)
against W and int labels:

    lse_i    = logsumexp_v(x_i . W_v)
    picked_i = x_i . W_{label_i}
    loss     = sum_i valid_i * (lse_i - picked_i) / max(sum valid, 1)

and the backward recomputes the scores from (x, W) and the saved row lse:
dlogits = (softmax - onehot) * g * valid / count, rounded to x's type
before both products, dx = dlogits . W and dW = dlogitsᵀ . x with f32
accumulation, each cast once.

Layout: W is (V, D), vocab rows dense along D (the port's lm_head and
tied embedding both hold it so); the JAX package's is (D, V).

- The plain twins `ce_fwd_ref` and `ce_bwd_ref` reproduce `_fwd_jnp` /
  `_bwd_jnp`: row chunks of `chunk` (the last padded with ignore_index
  rows) and, with `vocab_block > 0`, vocab blocks under an online max /
  sum (the last block padded with zero rows of W, its columns masked).
  The peak logits-shaped intermediate is (chunk, vocab_block or V), as
  in JAX.
- The CUDA kernels (csrc/blockwise_ce.cu) choose their own tiles and
  ignore `chunk` and `vocab_block`: the result differs from the twin only
  in summation order. `ce_fwd` writes lse and picked; the backward runs
  per vocab super-block of `ce_super_block(N, V)` rows (the dS workspace
  is (N, that), never (N, V)): `ce_dlogits`, `ce_dx`, `ce_dw`. In bf16
  all four are one persistent wgmma GEMM over TMA-loaded tiles, each with
  its own epilogue.
- `_BlockwiseCE` is the `torch.autograd.Function` (JAX `_bce`
  custom_vjp): its forward keeps x, W, labels, the f32 row lse and the
  count, nothing logits-shaped.

The wrappers take the twins only for CPU tensors; a CUDA tensor goes to
the kernels or raises. `launches` counts kernel launches per kernel.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import _build

__all__ = ["blockwise_ce_loss", "ce_fwd", "ce_bwd", "ce_fwd_ref",
           "ce_bwd_ref", "ce_shape_problems", "check_ce_shapes",
           "ce_super_block", "dense_logits_bytes", "logits_bytes_saved",
           "launches"]

launches = {"ce_fwd": 0, "ce_dlogits": 0, "ce_dx": 0, "ce_dw": 0}

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the dS workspace of one backward super-block, (N, Vs) in x's type
_WORKSPACE_BYTES = 256 * 2 ** 20
_SUPER_ALIGN = 128              # Vs: whole 64-wide f32 dS tiles, 16-byte rows


# ---------------------------------------------------------------------------
# shape contract (paddle_tpu check_ce_shapes, for the CUDA kernels' limits)
# ---------------------------------------------------------------------------

def ce_shape_problems(n, d, v, dtype):
    """Reasons the CUDA blockwise-CE kernels cannot take x (n, d), W
    (v, d) of `dtype`; empty list = supported. Each of n, d and v is a
    C int; the kernels' offsets are 64-bit, so n * v and v * d may pass
    2^31 (9 x 2048 rows at Llama-3's vocab of 128256)."""
    problems = []
    if n < 1 or v < 1 or d < 1:
        problems.append(f"rows, hidden and vocab must be positive (got "
                        f"n={n}, d={d}, v={v})")
    if dtype not in _DTYPE_CODE:
        problems.append(f"dtype {dtype} not supported (float32 or "
                        "bfloat16)")
    elif dtype == torch.bfloat16 and d % 8:
        problems.append(f"hidden % 8 == 0 required in bf16 (16-byte row "
                        f"copies; got d={d})")
    return problems


def check_ce_shapes(n, d, v, dtype):
    """Raise a ValueError naming every unsupported dim; no-op when
    supported."""
    problems = ce_shape_problems(n, d, v, dtype)
    if problems:
        raise ValueError("blockwise_ce_loss: " + "; ".join(problems))


def ce_super_block(n, v, itemsize=2):
    """Vocab rows per backward super-block: as many as keep the (n, Vs)
    dS workspace within 256 MiB, a multiple of 128, at most V rounded up
    to 128."""
    vs = _WORKSPACE_BYTES // (max(int(n), 1) * int(itemsize))
    vs = max(_SUPER_ALIGN, vs // _SUPER_ALIGN * _SUPER_ALIGN)
    return min(vs, -(-int(v) // _SUPER_ALIGN) * _SUPER_ALIGN)


# ---------------------------------------------------------------------------
# memory accounting (copies of the JAX package's helpers)
# ---------------------------------------------------------------------------

def dense_logits_bytes(n_rows, vocab, itemsize=2):
    """Bytes of the [N, V] logits tensor the dense loss path
    materializes (forward AND as the dlogits cotangent in backward)."""
    return int(n_rows) * int(vocab) * int(itemsize)


def logits_bytes_saved(n_rows, vocab, chunk, vocab_block=0, itemsize=2):
    """Dense-path logits bytes minus the blockwise path's peak
    O(chunk x vocab_block) logits-shaped intermediate."""
    if chunk <= 0:
        return 0
    peak = min(int(chunk), int(n_rows)) * (
        min(int(vocab_block), int(vocab)) if vocab_block else int(vocab)
    ) * int(itemsize)
    return max(0, dense_logits_bytes(n_rows, vocab, itemsize) - peak)


# ---------------------------------------------------------------------------
# plain twins (JAX _fwd_jnp / _bwd_jnp)
# ---------------------------------------------------------------------------

def _row_chunks(x, labels, chunk, ignore_index):
    """(x chunk, label chunk) pairs; the last chunk padded to `chunk`
    rows with zero rows and ignore_index labels."""
    n = x.shape[0]
    for i in range(0, n, chunk):
        xc, lc = x[i:i + chunk], labels[i:i + chunk]
        if xc.shape[0] < chunk:
            pad = chunk - xc.shape[0]
            xc = torch.cat([xc, xc.new_zeros(pad, x.shape[1])])
            lc = torch.cat([lc, lc.new_full((pad,), ignore_index)])
        yield xc, lc


def _vocab_blocks(w, vocab_block):
    """(first vocab row, (bv, D) block of W) pairs; the last block padded
    with zero rows (its columns are masked by the caller)."""
    v = w.shape[0]
    for j in range(0, v, vocab_block):
        wj = w[j:j + vocab_block]
        if wj.shape[0] < vocab_block:
            wj = torch.cat([wj, wj.new_zeros(vocab_block - wj.shape[0],
                                              w.shape[1])])
        yield j, wj


def _scores(xc, wj):
    """f32 scores xc . wjᵀ: products of the input type, summed in f32."""
    return xc.float() @ wj.float().t()


def ce_fwd_ref(x, w, labels, chunk, vocab_block=0, ignore_index=-100):
    """Plain twin of the forward: (loss, lse (N,) f32, count)."""
    n, v = x.shape[0], w.shape[0]
    lses, loss_sum = [], x.new_zeros((), dtype=torch.float32)
    count = x.new_zeros((), dtype=torch.float32)
    for xc, lc in _row_chunks(x, labels.long(), chunk, ignore_index):
        if not vocab_block:
            s = _scores(xc, w)
            m = torch.amax(s, dim=-1)
            lse = m + torch.log(torch.sum(torch.exp(s - m[:, None]), dim=-1))
            picked = torch.gather(s, 1, lc.clamp(0, v - 1)[:, None])[:, 0]
        else:
            c = xc.shape[0]
            m = xc.new_full((c,), _NEG_INF, dtype=torch.float32)
            l = xc.new_zeros((c,), dtype=torch.float32)
            picked = xc.new_zeros((c,), dtype=torch.float32)
            for j, wj in _vocab_blocks(w, vocab_block):
                s = _scores(xc, wj)
                col = torch.arange(j, j + vocab_block, device=x.device)
                s_m = torch.where(col < v, s, _NEG_INF)
                m_new = torch.maximum(m, torch.amax(s_m, dim=-1))
                l = l * torch.exp(m - m_new) + torch.sum(
                    torch.exp(s_m - m_new[:, None]), dim=-1)
                picked = picked + torch.sum(
                    torch.where(col == lc[:, None], s, 0.0), dim=-1)
                m = m_new
            lse = m + torch.log(torch.clamp(l, min=1e-30))
        valid = lc != ignore_index
        loss_sum = loss_sum + torch.sum(torch.where(valid, lse - picked, 0.0))
        count = count + torch.sum(valid.float())
        lses.append(lse)
    count = torch.clamp(count, min=1.0)
    return loss_sum / count, torch.cat(lses)[:n], count


def ce_bwd_ref(x, w, labels, lse, count, g, chunk, vocab_block=0,
               ignore_index=-100):
    """Plain twin of the backward: (dx in x's type, dW (V, D) in w's)."""
    n, d = x.shape
    v = w.shape[0]
    gscale = g / count
    lse_pad = torch.cat([lse, lse.new_zeros(-n % chunk)])
    dxs = []
    v_pad = -(-v // vocab_block) * vocab_block if vocab_block else v
    dw = x.new_zeros((v_pad, d), dtype=torch.float32)
    for i, (xc, lc) in enumerate(_row_chunks(x, labels.long(), chunk,
                                             ignore_index)):
        lse_c = lse_pad[i * chunk:(i + 1) * chunk]
        scale = torch.where(lc != ignore_index, gscale, 0.0)
        if not vocab_block:
            s = _scores(xc, w)
            p = torch.exp(s - lse_c[:, None])
            onehot = (torch.arange(v, device=x.device) == lc[:, None])
            dvals = ((p - onehot.float()) * scale[:, None]).to(x.dtype)
            dxs.append(dvals.float() @ w.float())
            dw += dvals.float().t() @ xc.float()
            continue
        dx_c = xc.new_zeros((xc.shape[0], d), dtype=torch.float32)
        for j, wj in _vocab_blocks(w, vocab_block):
            s = _scores(xc, wj)
            col = torch.arange(j, j + vocab_block, device=x.device)
            p = torch.where(col < v, torch.exp(s - lse_c[:, None]), 0.0)
            dvals = ((p - (col == lc[:, None]).float())
                     * scale[:, None]).to(x.dtype)
            dx_c += dvals.float() @ wj.float()
            dw[j:j + vocab_block] += dvals.float().t() @ xc.float()
        dxs.append(dx_c)
    dx = torch.cat(dxs)[:n].to(x.dtype)
    return dx, dw[:v].to(w.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_args(what, x, w, labels):
    if x.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"{what}: wants x (N, D), w (V, D), labels (N,); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}")
    if x.shape[1] != w.shape[1] or x.shape[0] != labels.shape[0]:
        raise ValueError(f"{what}: shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, labels {tuple(labels.shape)}")
    if w.dtype != x.dtype:
        raise ValueError(f"{what}: x and w must share one type (got "
                         f"{x.dtype}, {w.dtype})")
    if labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: labels must be int32 or int64 (got "
                         f"{labels.dtype})")


def _check_cuda(what, x, w, labels):
    """The kernels' own limits on a CUDA call; raises, never falls back."""
    check_ce_shapes(x.shape[0], x.shape[1], w.shape[0], x.dtype)
    for name, t in (("x", x), ("w", w), ("labels", labels)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is not on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous (got "
                             f"strides {t.stride()}); the kernels read "
                             "dense rows")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start 16-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ce_fwd(x, w, labels, chunk=512, vocab_block=0, ignore_index=-100):
    """(loss, lse (N,) f32, count) of x (N, D) against w (V, D). On the
    CPU the twin runs with `chunk` / `vocab_block`; a CUDA tensor goes to
    the kernel, which ignores them."""
    _check_args("ce_fwd", x, w, labels)
    if x.device.type == "cpu":
        return ce_fwd_ref(x, w, labels, chunk, vocab_block, ignore_index)
    if x.device.type != "cuda":
        raise ValueError(f"ce_fwd: unsupported device {x.device}")
    _check_cuda("ce_fwd", x, w, labels)
    lab = labels.to(torch.int32).contiguous()
    lse, picked = _launch_fwd(x, w, lab)
    valid = lab != ignore_index
    count = torch.clamp(valid.float().sum(), min=1.0)
    loss = torch.where(valid, lse - picked, 0.0).sum() / count
    return loss, lse, count


def ce_bwd(x, w, labels, lse, count, g, chunk=512, vocab_block=0,
           ignore_index=-100):
    """(dx (N, D) in x's type, dW (V, D) in w's) for the loss gradient g
    (0-d f32), from the forward's lse (N,) f32 and count."""
    _check_args("ce_bwd", x, w, labels)
    if x.device.type == "cpu":
        return ce_bwd_ref(x, w, labels, lse, count, g, chunk, vocab_block,
                          ignore_index)
    if x.device.type != "cuda":
        raise ValueError(f"ce_bwd: unsupported device {x.device}")
    _check_cuda("ce_bwd", x, w, labels)
    n, d = x.shape
    v = w.shape[0]
    if lse.shape != (n,) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != x.device:
        raise ValueError(f"ce_bwd: lse must be a dense f32 ({n},) on "
                         f"{x.device}")
    lab = labels.to(torch.int32).contiguous()
    scale = torch.where(lab != ignore_index, g / count, 0.0).to(
        torch.float32).contiguous()
    vs = ce_super_block(n, v, x.element_size())
    n_super = -(-v // vs)
    ws = torch.empty((n, vs), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    acc = (torch.empty((n, d), dtype=torch.float32, device=x.device)
           if n_super > 1 else None)
    dw = torch.empty_like(w)
    for s in range(n_super):
        v0 = s * vs
        vcur = min(vs, v - v0)
        _launch_dlogits(x, w, lab, lse, scale, ws, v0, vcur)
        _launch_dx(ws, w, acc, dx, v0, vcur, s == 0, s == n_super - 1)
        _launch_dw(ws, x, dw, v0, vcur)
    return dx, dw


# The kernels one by one (checked inputs: x (n, d), w (v, d) dense in one
# type, int32 labels, f32 lse and scale (n,), the workspace ws (n, Vs)),
# for ce_fwd, ce_bwd and for timing or checking each alone.

def _launch_fwd(x, w, lab):
    """(lse, picked) (N,) f32: each row's lse over the vocab and its
    label's score (0 for a label outside [0, V))."""
    n, d = x.shape
    v = w.shape[0]
    lib = _build.load_library()
    nvt = -(-v // lib.ptt_ce_vocab_tile(_DTYPE_CODE[x.dtype]))
    part = torch.empty((2, n, nvt), dtype=torch.float32, device=x.device)
    picked = torch.zeros(n, dtype=torch.float32, device=x.device)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    status = lib.ptt_ce_fwd(x.data_ptr(), w.data_ptr(), lab.data_ptr(),
                            part.data_ptr(), picked.data_ptr(),
                            lse.data_ptr(), n, d, v, _DTYPE_CODE[x.dtype],
                            _stream(x))
    _build.check(status, "ce_fwd")
    launches["ce_fwd"] += 1
    return lse, picked


def _launch_dlogits(x, w, lab, lse, scale, ws, v0, vcur):
    status = _build.load_library().ptt_ce_dlogits(
        x.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
        scale.data_ptr(), ws.data_ptr(), x.shape[0], x.shape[1], w.shape[0],
        v0, vcur, ws.shape[1], _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(status, "ce_bwd (dlogits)")
    launches["ce_dlogits"] += 1


def _launch_dx(ws, w, acc, dx, v0, vcur, first, last):
    status = _build.load_library().ptt_ce_dx(
        ws.data_ptr(), w.data_ptr(), None if acc is None else acc.data_ptr(),
        dx.data_ptr(), dx.shape[0], dx.shape[1], w.shape[0], v0, vcur,
        ws.shape[1], int(first), int(last), _DTYPE_CODE[dx.dtype],
        _stream(dx))
    _build.check(status, "ce_bwd (dx)")
    launches["ce_dx"] += 1


def _launch_dw(ws, x, dw, v0, vcur):
    status = _build.load_library().ptt_ce_dw(
        ws.data_ptr(), x.data_ptr(), dw.data_ptr(), x.shape[0], x.shape[1],
        dw.shape[0], v0, vcur, ws.shape[1], _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(status, "ce_bwd (dW)")
    launches["ce_dw"] += 1


class _BlockwiseCE(torch.autograd.Function):
    """The forward keeps x, w, labels, the f32 row lse and the count; the
    backward recomputes the scores (JAX `_bce_fwd` / `_bce_bwd`)."""

    @staticmethod
    def forward(ctx, x, w, labels, chunk, vocab_block, ignore_index):
        loss, lse, count = ce_fwd(x, w, labels, chunk, vocab_block,
                                  ignore_index)
        ctx.save_for_backward(x, w, labels, lse, count)
        ctx.args = (chunk, vocab_block, ignore_index)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse, count = ctx.saved_tensors
        dx, dw = ce_bwd(x, w, labels, lse, count, g.float(), *ctx.args)
        return dx, dw, None, None, None, None


def blockwise_ce_loss(x, w, labels, *, chunk, vocab_block=0,
                      ignore_index=-100):
    """Mean softmax cross-entropy of x (N, D) . wᵀ against int labels
    (N,), w (V, D), rows labelled `ignore_index` left out of the mean,
    without materializing the [N, V] logits. A scalar f32, differentiable
    in x and w.

    On the CPU the twin streams `chunk` rows (and `vocab_block` vocab
    rows when > 0) at a time, so its peak logits-shaped intermediate is
    (chunk, vocab_block or V); on the card the kernels choose their own
    tiles, and the result differs only in summation order."""
    _check_args("blockwise_ce_loss", x, w, labels)
    if chunk < 1 or vocab_block < 0:
        raise ValueError(f"blockwise_ce_loss: chunk must be >= 1 and "
                         f"vocab_block >= 0 (got {chunk}, {vocab_block})")
    args = (x, w, labels, int(chunk), int(vocab_block), int(ignore_index))
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _BlockwiseCE.apply(*args)
    return ce_fwd(*args)[0]
