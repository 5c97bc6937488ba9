"""Context parallelism: ring attention and Ulysses (all-to-all) attention.

Counterpart of paddle_tpu/distributed/context_parallel.py. A sequence is
cut over the 'sp' group: rank r holds tokens [r S/n, (r+1) S/n) of its
rows (contiguous shards, as the JAX package lays them out), and its
attention must still see every earlier token. The port is
multi-controller, so each entry takes this rank's shard (B, S/n, H, D)
and returns its shard of the output:

- `ring_attention`: K/V rotate around the group (distributed/collective.py
  `ppermute_start`, rank i to rank i + 1) while q stays. The shard of
  rank src is, causal, the past (src < r: full attention), the diagonal
  (src = r: causal) or the future (src > r: skipped, no launch, weight
  zero). The flash ring (`use_flash`, the default) runs one
  kernels/flash_attention.py `flash_attention_fwd` per live block at
  (B, S/n, Hq/Hk, D), GQA native, and merges the blocks' (o, lse) into
  an f32 accumulator by `torch.logaddexp` of the natural-log lse (the
  JAX ring's base-2 `logaddexp2`); the next shard's hop is posted before
  the block's kernel. Its backward rotates (k, v, dk, dv) together, n
  hops, so each shard's gradients arrive home with it: each live block
  is one `flash_attention_bwd(q, k_cur, v_cur, o, lse, do)` with the
  global merged o and lse (the kernel's delta = rowsum(do o) is then
  the global one), and dq accumulates here in f32. `use_flash=False` is
  the plain ring (the JAX jnp ring, `_merge_block`'s online softmax in
  f32, differentiable through autograd), the plain version the tests
  hold the flash ring against.
- `ulysses_attention`: an all-to-all turns (B, S/n, H, D) into
  (B, S, H/n, D), attention runs causal over the whole sequence (the
  flash kernels, or with `use_flash=False` the plain attention), and a
  second all-to-all turns it back. It needs Hq % n == 0 (else
  ValueError naming the heads). K/V go at Hk heads when n divides Hk,
  since the kernel takes GQA (query group c reads kv group c), and are
  repeated to Hq heads first otherwise, as the JAX package always does:
  the same result.

On a CUDA tensor the flash path launches the kernels or raises; the
kernels' CPU twins serve CPU tensors. `context_parallel_guard(mesh,
axis, mode)` routes nn/functional.py's causal, mask-free
`flash_attention` (the flash path) and `scaled_dot_product_attention`
(the plain path) through `dispatch_context_parallel`, as
paddle_tpu/nn/functional/attention.py does. `counts` holds the hops and
all-to-alls run and the bytes this rank sent over them.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch

from paddle_tpu_torch.distributed import collective

__all__ = ["ring_attention", "ulysses_attention", "context_parallel_guard",
           "current_context_parallel", "dispatch_context_parallel",
           "counts"]

_NEG_INF = -1e30

# hops and all-to-alls run, and the bytes this rank sent over them
counts = {"hops": 0, "all_to_all": 0, "bytes": 0}


def _group(group, axis):
    if group is not None:
        return group
    st = _cp_state
    mesh = st["mesh"] if st["mode"] else None
    if mesh is None:
        from paddle_tpu_torch.distributed.mesh import get_mesh
        mesh = get_mesh()
    if mesh is None:
        raise ValueError(f"no mesh for axis {axis!r}: pass group=, enter "
                         "context_parallel_guard or set_mesh")
    return mesh.get_group(axis)


def _hop(t, group):
    """Post `t`'s hop from every rank i of the ring to rank i + 1."""
    n = group.nranks
    work = collective.ppermute_start(
        t, None, [(i, (i + 1) % n) for i in range(n)], group=group)
    counts["hops"] += 1
    counts["bytes"] += work.nbytes
    return work


def _mode(causal, src, idx):
    """0: attend to the whole shard, 1: the diagonal (causal), 2: skip."""
    if not causal:
        return 0
    return 1 if src == idx else (0 if src < idx else 2)


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


# ---------------------------------------------------------------------------
# the flash ring
# ---------------------------------------------------------------------------

def _merge_partial(acc, lse, o_j, lse_j):
    """(acc, lse) with one block's (o_j (B, S, H, D), lse_j (B, H, S))
    merged in: each weighted by exp(its lse - the sum's), natural log."""
    new = torch.logaddexp(lse, lse_j)
    w_old = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_j - new).transpose(1, 2)[..., None]
    return acc * w_old + o_j.float() * w_new, new


def _ring_flash_fwd(q, k, v, group, causal, sm_scale):
    """(o in q's type, lse (B, Hq, S/n) f32) of this rank's queries over
    every shard of the ring."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    n, idx = group.nranks, group.rank
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((q.shape[0], q.shape[2], q.shape[1]), float("-inf"),
                     dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for j in range(n):
        src = (idx - j) % n
        works = (_hop(k_cur, group), _hop(v_cur, group)) if j < n - 1 \
            else None
        mode = _mode(causal, src, idx)
        if mode != 2:
            acc, lse = _merge_partial(acc, lse, *flash_attention_fwd(
                q, k_cur, v_cur, mode == 1, sm_scale))
        if works is not None:
            k_cur, v_cur = works[0].wait(), works[1].wait()
    return acc.to(q.dtype), lse


def _ring_flash_bwd(q, k, v, o, lse, do, group, causal, sm_scale):
    """(dq, dk, dv) of the flash ring: (k, v, dk, dv) rotate together,
    so each shard's gradients end at their owner after n hops."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_bwd
    n, idx = group.nranks, group.rank
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k, v
    grads = None           # the (dk, dv) accumulators' hop in flight
    for j in range(n):
        src = (idx - j) % n
        kv = (_hop(k_cur, group), _hop(v_cur, group)) if j < n - 1 \
            else None
        mode = _mode(causal, src, idx)
        if mode != 2:
            dq_j, dk_j, dv_j = flash_attention_bwd(
                q, k_cur, v_cur, o, lse, do, mode == 1, sm_scale)
        if grads is not None:
            dk, dv = grads[0].wait(), grads[1].wait()
        if mode != 2:
            dq.add_(dq_j.float())
            dk.add_(dk_j.float())
            dv.add_(dv_j.float())
        grads = (_hop(dk, group), _hop(dv, group))
        if kv is not None:
            k_cur, v_cur = kv[0].wait(), kv[1].wait()
    dk, dv = grads[0].wait(), grads[1].wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        o, lse = _ring_flash_fwd(q, k, v, group, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = (group, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, sm_scale = ctx.ring
        dq, dk, dv = _ring_flash_bwd(q, k, v, o, lse, do.contiguous(),
                                     group, causal, sm_scale)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# the plain ring (the JAX jnp ring)
# ---------------------------------------------------------------------------

class _Hop(torch.autograd.Function):
    """One ring hop (rank i to i + 1); its backward sends the gradient
    back (rank i + 1 to i)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _hop(t, group).wait()

    @staticmethod
    def backward(ctx, g):
        n = ctx.group.nranks
        back = collective.ppermute_start(
            g.contiguous(), None, [((i + 1) % n, i) for i in range(n)],
            group=ctx.group)
        return back.wait(), None


def _merge_block(q, kj, vj, m, l, acc, sm_scale, causal, row_off, col_off):
    """Online-softmax merge of one K/V block into the running (m, l, acc)
    (JAX `_merge_block`). q: (B, H, Sq, D); kj / vj: (B, H, Sk, D);
    offsets are global positions."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * sm_scale, kj.float())
    if causal:
        sq, sk = q.shape[2], kj.shape[2]
        row = torch.arange(sq, device=q.device)[:, None] + row_off
        col = torch.arange(sk, device=q.device)[None, :] + col_off
        s = torch.where(col <= row, s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vj.float())
    return m_new, l_new, acc_new


def _repeat_kv(k, v, rep):
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def _plain_ring(q, k, v, group, causal, sm_scale):
    n, idx = group.nranks, group.rank
    if q.shape[2] != k.shape[2]:
        k, v = _repeat_kv(k, v, q.shape[2] // k.shape[2])
    qh, kc, vc = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    b, h, s, d = qh.shape
    m = torch.full((b, h, s, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for j in range(n):
        src = (idx - j) % n
        m, l, acc = _merge_block(qh, kc, vc, m, l, acc, sm_scale, causal,
                                 idx * s, src * s)
        if j < n - 1:
            kc, vc = _Hop.apply(kc.contiguous(), group), \
                _Hop.apply(vc.contiguous(), group)
    return (acc / l.clamp(min=1e-30)).to(q.dtype).transpose(1, 2)


def ring_attention(q, k, v, group=None, axis="sp", causal=True,
                   sm_scale=None, use_flash=True):
    """This rank's shard (B, S/n, Hq, D) of attention over the sequence
    cut over `group` (default: the guard's or the current mesh's `axis`
    group); k / v (B, S/n, Hk, D), Hk dividing Hq. Differentiable in q,
    k and v. `use_flash` (module docstring) runs the flash kernels,
    which must take the shard's shapes (ValueError naming them
    otherwise); False the plain ring."""
    g = _group(group, axis)
    scale = _scale(q, sm_scale)
    if not use_flash:
        return _plain_ring(q, k, v, g, bool(causal), scale)
    from paddle_tpu_torch.kernels.flash_attention import flash_shape_problems
    problems = flash_shape_problems(q.shape, k.shape, v.shape, q.dtype)
    if problems:
        raise ValueError("ring_attention: the shard cannot take the flash "
                         "kernels: " + "; ".join(problems)
                         + "; pass use_flash=False for the plain ring")
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            g, bool(causal), scale)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def _a2a(x, group, split_dim, cat_dim):
    """x cut into n along `split_dim`, piece c to rank c; what every rank
    sends comes back concatenated along `cat_dim` in rank order."""
    ins = [c.contiguous() for c in x.chunk(group.nranks, split_dim)]
    counts["all_to_all"] += 1
    counts["bytes"] += sum(c.numel() * c.element_size()
                           for i, c in enumerate(ins) if i != group.rank)
    return torch.cat(collective.alltoall(ins, group=group), cat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.a2a = (group, split_dim, cat_dim)
        return _a2a(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, cat_dim = ctx.a2a
        return _a2a(g, group, cat_dim, split_dim), None, None, None


def ulysses_attention(q, k, v, group=None, axis="sp", causal=True,
                      sm_scale=None, use_flash=True):
    """This rank's shard (B, S/n, Hq, D) of attention over the sequence
    cut over `group`, by all-to-all over the heads (module docstring).
    Differentiable in q, k and v."""
    g = _group(group, axis)
    n = g.nranks
    hq, hk = q.shape[2], k.shape[2]
    if hq % n:
        raise ValueError(f"ulysses_attention: {hq} query heads do not "
                         f"divide over the {n} ranks of the '{axis}' group")
    if hk % n:
        k, v = _repeat_kv(k, v, hq // hk)
    qg, kg, vg = (_AllToAll.apply(t, g, 2, 1) for t in (q, k, v))
    if use_flash:
        from paddle_tpu_torch.kernels.flash_attention import (
            flash_attention_bshd)
        out = flash_attention_bshd(qg, kg, vg, causal, sm_scale)
    else:
        from paddle_tpu_torch.nn.functional import _sdpa_plain
        out = _sdpa_plain(qg, kg, vg, is_causal=causal, scale=sm_scale)
    return _AllToAll.apply(out, g, 1, 2)


# ---------------------------------------------------------------------------
# model integration: a context that reroutes attention
# ---------------------------------------------------------------------------

_cp_state = {"mode": None, "mesh": None, "axis": "sp"}


@contextmanager
def context_parallel_guard(mesh, axis="sp", mode="ring"):
    """Inside this context, nn/functional.py's causal, mask-free
    `flash_attention` and `scaled_dot_product_attention` route through
    ring ("ring") or Ulysses ("ulysses") attention over `axis` of
    `mesh`."""
    if mode not in ("ring", "ulysses"):
        raise ValueError(f"mode must be 'ring' or 'ulysses' (got {mode!r})")
    prev = dict(_cp_state)
    _cp_state.update(mode=mode, mesh=mesh, axis=axis)
    try:
        yield
    finally:
        _cp_state.update(prev)


def current_context_parallel():
    return dict(_cp_state) if _cp_state["mode"] else None


def dispatch_context_parallel(q, k, v, causal, use_flash=True):
    """Called by the attention ops while a guard is active; q, k, v are
    this rank's shards (B, S/n, H, D)."""
    st = _cp_state
    f = ring_attention if st["mode"] == "ring" else ulysses_attention
    return f(q, k, v, group=st["mesh"].get_group(st["axis"]),
             axis=st["axis"], causal=causal, use_flash=use_flash)
