"""MoE gating, dispatch and the expert MLPs, in PyTorch.

Counterpart of paddle_tpu/nn/functional/moe.py (the gates, the (T, E, C)
dispatch and combine, the dropless grouped-product MLP) and of the
single-device paths of paddle_tpu/nn/layer/moe.py (`_moe_mlp`,
`_moe_mlp_dropless`, `MoEMLP`), with the JAX package's cast points:
router logits, softmax and gates in f32, silu(a) in f32 cast back before
the product with b.

- The capacity path (`moe_mlp`): GShard top-2 gating (`top2_gating`)
  when k == 2 and Switch top-1 (`switch_gating`) for every other k, as
  the JAX layer chooses; capacity c = max(4, ceil(k' T cf / E)), k' 2
  or 1; positions in each expert's buffer from a cumsum in token order,
  so every row of the batch, an idle engine slot's too, takes capacity
  in that order; the expert products are batched matmuls over (E, C, D).
  Every shape is static: `c` follows from T, so a captured program fixes
  its own c, as JAX's jit does.
- The dropless path (`moe_mlp_dropless`): softmax, top-k, the k gates
  renormalised; the T k (token, expert) pairs sorted stably by expert,
  three grouped products over the experts' contiguous row groups
  (`grouped_mm`), the rows unsorted and summed over k with their gates.
  Group sizes come from a `scatter_add_` into E counters and the
  offsets from a cumsum, on the device: the forward reads nothing back
  to the host (no `.item()`, no data-sized `bincount`, no `nonzero`), so
  the engine's decode tick captures it.

`grouped_mm(x, w, offsets)` is the JAX package's `jax.lax.ragged_dot`
(an XLA primitive, not a Pallas kernel): on a CUDA tensor it is
`torch._grouped_mm` (CUTLASS's sm_90 grouped GEMM, bf16 only, K and N
multiples of 8, the offsets read on the device) inside an autograd
Function whose backward is two more grouped products; any other CUDA
dtype or shape raises. On a CPU tensor it is `grouped_mm_plain`, a loop
over the experts. `launches["grouped_mm"]` counts the forward products
launched on the card, `launches["grouped_mm_bwd"]` the backward's.

Inside `batch_group(group, index, size)` (the Trainer's batch group on
'dp' / 'fsdp', parallel/trainer.py) every gate takes its statistics over
the group's tokens, as the JAX package's over the global batch: rank
`index` of `size` holds the group's tokens [index T, (index + 1) T), T
its own count (the Trainer cuts the rows evenly). The capacity is that of
size T tokens, each expert's buffer positions follow the earlier ranks'
assignments (their counts all-gathered, per expert), and the aux loss's
`ce` is the group's mean assignment. A rank's aux loss is then its share
of the group's: its tokens' router probabilities over the group's token
count times that `ce`, so the shares sum to the JAX aux loss and each
one's gradient is its tokens' part of the JAX gradient.

Ties in the top-k: `torch.topk` leaves the order of equal probabilities
open on CUDA, where `lax.top_k` takes the lower expert first.

Not here: the expert-parallel path (`moe_dropless_mlp_ep_local`,
`expert_parallel_guard`, `moe_dropless_ep`).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
from torch import nn

from paddle_tpu_torch.kernels import LaunchCounter

__all__ = ["top2_gating", "switch_gating", "moe_dispatch", "moe_combine",
           "topk_gating_dropless", "grouped_mm", "grouped_mm_plain",
           "moe_dropless_mlp", "moe_mlp", "moe_mlp_dropless", "MoEMLP",
           "batch_group", "sort_by_expert", "launches"]

launches = LaunchCounter(grouped_mm=0, grouped_mm_bwd=0)


# the batch group the gates take their statistics over (`batch_group`)
_batch = {"group": None, "index": 0, "size": 1}


@contextmanager
def batch_group(group, index, size):
    """Inside the block the gates take their statistics over the batch
    `group`, this rank holding its tokens' `index`-th slice of `size`
    (module doc)."""
    prev = dict(_batch)
    _batch.update(group=group, index=index, size=size)
    try:
        yield
    finally:
        _batch.update(prev)


def _group_counts(counts):
    """(the earlier ranks' sum, the group's sum) of `counts` (n, E), each
    rank's own; (zeros, counts) outside `batch_group`."""
    if _batch["size"] == 1:
        return torch.zeros_like(counts), counts
    from paddle_tpu_torch.distributed import collective
    mine = torch.cat([counts.new_full((1,), float(_batch["index"])),
                      counts.detach().reshape(-1)])
    every = torch.stack(collective.all_gather(mine, group=_batch["group"]))
    earlier = (every[:, 0] < _batch["index"]).to(counts.dtype)
    rest = every[:, 1:].reshape((-1,) + tuple(counts.shape))
    return (torch.einsum("r,r...->...", earlier, rest), rest.sum(dim=0))


def _one_hot(x, n):
    """f32 one-hot rows of `x` over n classes; an index outside [0, n)
    gives a zero row (jax.nn.one_hot)."""
    return (x.unsqueeze(-1) == torch.arange(n, device=x.device)).float()


def _aux(probs, assigned, tokens):
    """The GShard load-balancing loss E * sum(me * ce): `me` the mean
    router probability of each expert over the group's `tokens`, `ce`
    (`assigned`, no gradient) the group's mean assignment; inside
    `batch_group`, this rank's share (module doc)."""
    e = probs.shape[-1]
    return e * torch.sum(torch.sum(probs, dim=0) / tokens * assigned)


def top2_gating(logits, capacity_factor=1.25):
    """GShard top-2 gating. logits (T, E) -> (combine (T, E, C) f32,
    dispatch bool (T, E, C), aux_loss)."""
    t, e = logits.shape
    tokens = t * _batch["size"]
    c = max(4, int(math.ceil(2 * tokens * capacity_factor / e)))
    probs = torch.softmax(logits.float(), dim=-1)
    mask1 = _one_hot(torch.argmax(probs, dim=-1), e)
    mask2 = _one_hot(torch.argmax(probs * (1.0 - mask1), dim=-1), e)
    earlier, total = _group_counts(torch.stack([torch.sum(mask1, dim=0),
                                                torch.sum(mask2, dim=0)]))
    aux = _aux(probs, total[0] / tokens, tokens)
    # positions within each expert's capacity buffer, in token order: the
    # group's first choices, then its second ones
    pos1 = (torch.cumsum(mask1, dim=0) - 1.0 + earlier[0]) * mask1
    pos2 = (torch.cumsum(mask2, dim=0) - 1.0 + earlier[1]
            + total[0]) * mask2
    mask1 = mask1 * ((pos1 < c) & (mask1 > 0))
    mask2 = mask2 * ((pos2 < c) & (mask2 > 0))
    g1 = torch.sum(probs * mask1, dim=-1)
    g2 = torch.sum(probs * mask2, dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    cap1 = _one_hot(torch.sum(pos1 * mask1, dim=-1).to(torch.int32), c) \
        * (torch.sum(mask1, dim=-1) > 0)[:, None]
    cap2 = _one_hot(torch.sum(pos2 * mask2, dim=-1).to(torch.int32), c) \
        * (torch.sum(mask2, dim=-1) > 0)[:, None]
    combine = (g1[:, None, None] * mask1[:, :, None] * cap1[:, None, :]
               + g2[:, None, None] * mask2[:, :, None] * cap2[:, None, :])
    return combine, combine > 0, aux


def switch_gating(logits, capacity_factor=1.25):
    """Switch-Transformer top-1 gating. The JAX function's training
    jitter under an rng key is not ported: the JAX layer passes no key."""
    t, e = logits.shape
    tokens = t * _batch["size"]
    c = max(4, int(math.ceil(tokens * capacity_factor / e)))
    probs = torch.softmax(logits.float(), dim=-1)
    mask = _one_hot(torch.argmax(probs, dim=-1), e)
    earlier, total = _group_counts(torch.sum(mask, dim=0)[None])
    aux = _aux(probs, total[0] / tokens, tokens)
    pos = (torch.cumsum(mask, dim=0) - 1.0 + earlier[0]) * mask
    mask = mask * ((pos < c) & (mask > 0))
    gate = torch.sum(probs * mask, dim=-1)
    cap = _one_hot(torch.sum(pos * mask, dim=-1).to(torch.int32), c) \
        * (torch.sum(mask, dim=-1) > 0)[:, None]
    combine = gate[:, None, None] * mask[:, :, None] * cap[:, None, :]
    return combine, combine > 0, aux


def moe_dispatch(x, dispatch):
    """x (T, D), dispatch (T, E, C) -> expert inputs (E, C, D)."""
    return torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)


def moe_combine(expert_out, combine):
    """expert_out (E, C, D), combine (T, E, C) -> (T, D)."""
    return torch.einsum("tec,ecd->td", combine.to(expert_out.dtype),
                        expert_out)


def topk_gating_dropless(logits, k):
    """Dropless top-k gating: logits (T, E) -> (expert ids (T, k) int32,
    gates (T, k) f32 renormalised over the k, aux_loss with ce over the
    T k slots)."""
    t, e = logits.shape
    tokens = t * _batch["size"]
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True),
                                min=1e-9)
    _, total = _group_counts(torch.sum(_one_hot(idx, e), dim=(0, 1))[None])
    aux = _aux(probs, total[0] / (tokens * k), tokens)
    return idx.to(torch.int32), gates, aux


def grouped_mm_plain(x, w, offsets):
    """The plain grouped product: rows [offsets[e-1], offsets[e]) of x
    (N, K) times w[e] (K, M), for each expert e in turn -> (N, M)."""
    ends = offsets.tolist()
    out, start = [], 0
    for e, end in enumerate(ends):
        out.append(x[start:end] @ w[e])
        start = end
    return torch.cat(out, dim=0)


def _check_card_operands(x, w, offsets):
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"grouped_mm on the card takes bf16 operands "
                        f"(torch._grouped_mm's sm_90 route), got {x.dtype} "
                        f"x {w.dtype}")
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] \
            or offsets.shape != (w.shape[0],):
        raise ValueError(f"grouped_mm: x (N, K), w (E, K, M), offsets (E,); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(offsets.shape)}")
    if x.shape[1] % 8 or w.shape[2] % 8:
        raise ValueError(f"grouped_mm on the card needs K and M multiples "
                         f"of 8 (16-byte rows), got K {x.shape[1]}, M "
                         f"{w.shape[2]}")
    if offsets.dtype != torch.int32 or not offsets.is_cuda:
        raise TypeError("grouped_mm on the card takes int32 offsets on the "
                        "device")


class _GroupedMM(torch.autograd.Function):
    """torch._grouped_mm with its backward as two grouped products: dx =
    dy w[e]^T over the same row groups, dw[e] = x^T dy over them (an
    expert without rows gets a zero gradient)."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w, offsets)
        out = torch._grouped_mm(x, w, offs=offsets)
        launches.add("grouped_mm")
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch._grouped_mm(dy, w.transpose(1, 2), offs=offsets)
            launches.add("grouped_mm_bwd")
        if ctx.needs_input_grad[1]:
            dw = torch._grouped_mm(x.t(), dy, offs=offsets)
            launches.add("grouped_mm_bwd")
        return dx, dw, None


def grouped_mm(x, w, offsets):
    """`jax.lax.ragged_dot`: x (N, K) rows grouped by expert, w (E, K, M),
    offsets (E,) int32, each group's end row -> (N, M). On the card
    torch._grouped_mm (module doc), on the CPU `grouped_mm_plain`."""
    if x.is_cuda:
        _check_card_operands(x, w, offsets)
        return _GroupedMM.apply(x, w, offsets)
    return grouped_mm_plain(x, w, offsets)


def sort_by_expert(idx, e):
    """The T k (token, expert) pairs of `idx` (T, k) grouped by expert:
    (order (T k,), the pairs' flat indices stably sorted by expert id;
    offsets (E,) int32, each expert's end row in that order), both on
    the device, with no host read (a `scatter_add_` into E counters, not
    a data-sized `bincount`)."""
    flat_e = idx.reshape(-1).long()
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.zeros(e, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    return order, torch.cumsum(counts, dim=0, dtype=torch.int32)


def moe_dropless_mlp(xt, wg, wu, wd, idx, gates):
    """The sort-based grouped-product expert MLP, no token dropped: xt
    (T, D); wg / wu (E, D, F); wd (E, F, D); idx / gates (T, k) ->
    (T, D)."""
    t, d = xt.shape
    k = idx.shape[1]
    order, offsets = sort_by_expert(idx, wg.shape[0])
    sorted_x = xt.index_select(0, order // k)
    a = grouped_mm(sorted_x, wg.to(xt.dtype), offsets)
    b = grouped_mm(sorted_x, wu.to(xt.dtype), offsets)
    act = torch.nn.functional.silu(a.float()).to(xt.dtype) * b
    o = grouped_mm(act, wd.to(xt.dtype), offsets)
    # the inverse permutation: row i of `o` is pair order[i]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    rows = o.index_select(0, inv).reshape(t, k, d)
    return torch.sum(gates[..., None].to(xt.dtype) * rows, dim=1)


def _router_logits(xt, router_w):
    return xt.float() @ router_w.float()


def moe_mlp(x, router_w, wg, wu, wd, k, capacity_factor):
    """The capacity path (JAX `_moe_mlp`): x (..., D) -> ((..., D),
    aux_loss); top-2 gating when k == 2, top-1 for every other k."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    gate = top2_gating if k == 2 else switch_gating
    combine, dispatch, aux = gate(_router_logits(xt, router_w),
                                  capacity_factor=capacity_factor)
    h = moe_dispatch(xt, dispatch)                       # (E, C, D)
    a = torch.bmm(h, wg)
    b = torch.bmm(h, wu)
    act = torch.nn.functional.silu(a.float()).to(h.dtype) * b
    out = moe_combine(torch.bmm(act, wd), combine)
    return out.reshape(*lead, d), aux


def moe_mlp_dropless(x, router_w, wg, wu, wd, k):
    """The dropless path (JAX `_moe_mlp_dropless`): x (..., D) ->
    ((..., D), aux_loss)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    idx, gates, aux = topk_gating_dropless(_router_logits(xt, router_w), k)
    out = moe_dropless_mlp(xt, wg, wu, wd, idx, gates)
    return out.reshape(*lead, d), aux


class MoEMLP(nn.Module):
    """A drop-in for the dense SwiGLU MLP: the router (D, E) and the
    stacked expert weights experts_gate_weight / experts_up_weight
    (E, D, F) and experts_down_weight (E, F, D), in the JAX layout.
    `aux_loss` is set on every forward, for the caller's loss (inside
    `batch_group`, this rank's share of the group's)."""

    def __init__(self, hidden_size, intermediate_size, num_experts, top_k=2,
                 capacity_factor=1.25, dropless=False):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dropless = dropless
        d, f, e = hidden_size, intermediate_size, num_experts
        self.router_weight = nn.Parameter(torch.empty(d, e))
        self.experts_gate_weight = nn.Parameter(torch.empty(e, d, f))
        self.experts_up_weight = nn.Parameter(torch.empty(e, d, f))
        self.experts_down_weight = nn.Parameter(torch.empty(e, f, d))
        self.aux_loss = None

    def forward(self, x):
        w = (self.router_weight, self.experts_gate_weight,
             self.experts_up_weight, self.experts_down_weight)
        if self.dropless:
            out, aux = moe_mlp_dropless(x, *w, k=self.top_k)
        else:
            out, aux = moe_mlp(x, *w, k=self.top_k,
                               capacity_factor=self.capacity_factor)
        self.aux_loss = aux
        return out
