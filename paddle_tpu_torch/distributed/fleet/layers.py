"""Megatron-style model-parallel layers.

Counterpart of paddle_tpu/distributed/fleet/layers.py (reference:
python/paddle/distributed/fleet/layers/mpu/mp_layers.py:46
VocabParallelEmbedding, :335 ColumnParallelLinear, :542 RowParallelLinear,
:743 ParallelCrossEntropy; sequence_parallel_utils.py). The JAX layers
are plain layers whose weights carry a PartitionSpec, and GSPMD inserts
the collectives. The port is multi-controller, one process a device, so
each rank of the mp group holds plain local shards (dense tensors, which
the kernels launch on) and the layers issue Megatron's collectives
themselves, as autograd Functions over `collective.all_reduce` /
`all_gather` on the mp group:

- f, `copy_to_mp`: identity forward, all-reduce of the gradient
  backward, in front of a column-parallel product;
- g, `reduce_from_mp`: all-reduce forward, identity backward, after a
  row-parallel product;
- `gather_from_mp` / `scatter_to_mp`: the last dim gathered from the
  ranks / cut to this rank's part, each the other's backward.

Weights follow torch's layout: a Linear weight is (out, in), so the
column-parallel layer keeps rows [r·out/n, (r+1)·out/n) of it and the
row-parallel layer the same columns; the vocab-parallel embedding keeps
rows [r·V/n, (r+1)·V/n) of its (V, D) table. Every sharded parameter
carries `_mp_shard` (an `MPShard`: the group, the dim cut and, for a
fused projection, the parts cut one by one), which the optimizer's
norms, the Trainer's checkpoints and `gather_full` read.

Inside parallel/overlap.py's `overlap_fsdp_guard`, a column- or
row-parallel layer whose mp-local weight is also cut over 'fsdp' takes
its local product through the overlap ring (`overlap.ring_product`),
between the f-op and the g-op, which stay as they are.

`ParallelCrossEntropy` over vocab-sharded logits runs the reference
layer's three all-reduces: the row max, the sum of exponents and the
label's logit (the JAX layer is plain cross entropy under GSPMD). The
sequence-parallel layers compute what their parents compute: the JAX
versions only add a layout constraint on an 'sp' axis, which the port's
Trainer refuses until the context-parallel slice.

The group is `mp_group` (a collective.Group) or the current mesh's 'mp'
axis (distributed/mesh.py `get_mesh`); with neither, or one of extent 1,
every layer is the plain layer, as in JAX. A layer built with a group
initialises the whole weight as the plain layer does (torch's global
generator: every rank seeds it alike) and keeps this rank's part;
`from_linear` / `from_embedding` cut an existing layer's parameters in
place instead, keeping the parameter objects (parallel/plan.py
`apply_plan`). `weight_attr`, `fuse_matmul_bias` and `name` are the
reference's signature, accepted and unused.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as tF

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.parallel import overlap

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "MPShard", "gather_full", "copy_to_mp", "reduce_from_mp",
           "gather_from_mp", "scatter_to_mp", "parallel_cross_entropy"]


@dataclass(frozen=True)
class MPShard:
    """How a parameter is cut over the mp group: along `dim`, into
    contiguous equal parts in rank order, or, with `parts` (the whole
    tensor's part sizes along `dim`, e.g. q, k and v of a fused qkv
    weight), each part cut so, rank r holding its piece of every part."""
    group: object
    dim: int
    parts: tuple | None = None

    def local(self, full):
        """This rank's piece of the whole tensor `full`."""
        n, r = self.group.nranks, self.group.rank
        segs = ([full] if self.parts is None
                else torch.split(full, list(self.parts), self.dim))
        out = []
        for s in segs:
            size = s.shape[self.dim] // n
            out.append(s.narrow(self.dim, r * size, size))
        return out[0] if len(out) == 1 else torch.cat(out, self.dim)


def gather_full(local, shard: MPShard):
    """The whole tensor from every rank's `local` piece (a collective:
    every rank of the group calls it)."""
    pieces = collective.all_gather(local.contiguous(), group=shard.group)
    if shard.parts is None:
        return torch.cat(pieces, shard.dim)
    n = len(pieces)
    split = [torch.split(p, [s // n for s in shard.parts], shard.dim)
             for p in pieces]
    return torch.cat([split[r][i] for i in range(len(shard.parts))
                      for r in range(n)], shard.dim)


def _mp_group(mp_group=None):
    """`mp_group`, else the current mesh's 'mp' group; None when there
    is none or it holds one rank."""
    if mp_group is None:
        from paddle_tpu_torch.distributed.mesh import get_mesh
        mesh = get_mesh()
        if mesh is None or "mp" not in mesh.dim_names \
                or mesh.get_dim_size("mp") <= 1:
            return None
        mp_group = mesh.get_group("mp")
    return mp_group if mp_group.nranks > 1 else None


def _shard_param(p, shard: MPShard):
    """Cut parameter `p` to this rank's piece, in place (the Parameter
    object stays, so an optimizer built over it keeps it)."""
    with torch.no_grad():
        p.data = shard.local(p.data).clone(
            memory_format=torch.contiguous_format)
    p._mp_shard = shard
    return p


# ---------------------------------------------------------------------------
# Megatron's f and g (and the last-dim gather / scatter)
# ---------------------------------------------------------------------------

def _all_reduced(t, group):
    out = t.contiguous().clone()
    collective.all_reduce(out, group=group)
    return out


def _gathered_last(t, group):
    return torch.cat(collective.all_gather(t.contiguous(), group=group),
                     dim=-1)


def _own_last(t, group):
    size = t.shape[-1] // group.nranks
    return t.narrow(-1, group.rank * size, size).contiguous()


class _CopyToMP(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduced(g, ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gathered_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _own_last(g, ctx.group), None


class _ScatterToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gathered_last(g, ctx.group), None


def copy_to_mp(x, group):
    return x if group is None else _CopyToMP.apply(x, group)


def reduce_from_mp(x, group):
    return x if group is None else _ReduceFromMP.apply(x, group)


def gather_from_mp(x, group):
    return x if group is None else _GatherFromMP.apply(x, group)


def scatter_to_mp(x, group):
    return x if group is None else _ScatterToMP.apply(x, group)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class ColumnParallelLinear(nn.Linear):
    """Linear whose output features are cut over the mp group: rank r
    holds weight rows (and bias entries) [r·out/n, (r+1)·out/n); the
    output stays cut unless `gather_output` (reference: mp_layers.py:335)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__(in_features, out_features, bias=has_bias)
        self.gather_output = gather_output
        self.mp_group = _mp_group(mp_group)
        if self.mp_group is not None:
            self._cut(None)

    def _cut(self, parts):
        shard = MPShard(self.mp_group, 0, parts)
        _shard_param(self.weight, shard)
        if self.bias is not None:
            _shard_param(self.bias, shard)
        self.out_features = self.weight.shape[0]

    @classmethod
    def from_linear(cls, linear, mp_group, parts=None):
        """A column-parallel layer over `linear`'s own parameters, cut in
        place, its output left cut; `parts`: a fused weight's part sizes
        (MPShard)."""
        layer = _adopt(cls, linear)
        layer.gather_output = False
        layer.mp_group = mp_group
        layer._cut(parts)
        return layer

    def forward(self, x):
        if self.mp_group is None:
            return super().forward(x)
        out = overlap.ring_product(self, copy_to_mp(x, self.mp_group))
        return gather_from_mp(out, self.mp_group) if self.gather_output \
            else out


class RowParallelLinear(nn.Linear):
    """Linear whose input features are cut over the mp group: rank r
    holds weight columns [r·in/n, (r+1)·in/n) and the whole bias; the
    partial products are all-reduced, then the bias is added
    (reference: mp_layers.py:542). Without `input_is_parallel` the input
    is cut to this rank's part first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__(in_features, out_features, bias=has_bias)
        self.input_is_parallel = input_is_parallel
        self.mp_group = _mp_group(mp_group)
        if self.mp_group is not None:
            self._cut()

    def _cut(self):
        _shard_param(self.weight, MPShard(self.mp_group, 1))
        self.in_features = self.weight.shape[1]

    @classmethod
    def from_linear(cls, linear, mp_group):
        """A row-parallel layer over `linear`'s own parameters, cut in
        place, taking a cut input."""
        layer = _adopt(cls, linear)
        layer.input_is_parallel = True
        layer.mp_group = mp_group
        layer._cut()
        return layer

    def forward(self, x):
        g = self.mp_group
        if g is None:
            return super().forward(x)
        if not self.input_is_parallel:
            x = scatter_to_mp(x, g)
        if self.bias is None:
            return reduce_from_mp(overlap.ring_product(self, x), g)
        return reduce_from_mp(tF.linear(x, self.weight), g) + self.bias


class VocabParallelEmbedding(nn.Embedding):
    """Embedding table cut over the vocab on the mp group: rank r looks
    up the ids in [vocab_start_index, vocab_start_index + V/n), writes
    zeros for the rest, and the ranks' rows are all-reduced (reference:
    mp_layers.py:46)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__(num_embeddings, embedding_dim)
        self.mp_group = _mp_group(mp_group)
        self.vocab_start_index = 0
        if self.mp_group is not None:
            self._cut()

    def _cut(self):
        _shard_param(self.weight, MPShard(self.mp_group, 0))
        self.num_embeddings = self.weight.shape[0]
        self.vocab_start_index = self.mp_group.rank * self.num_embeddings

    @classmethod
    def from_embedding(cls, embedding, mp_group):
        """A vocab-parallel embedding over `embedding`'s own table, cut in
        place."""
        layer = _adopt(cls, embedding)
        layer.mp_group = mp_group
        layer._cut()
        return layer

    def forward(self, ids):
        if self.mp_group is None:
            return super().forward(ids)
        local = ids - self.vocab_start_index
        out_of_range = (local < 0) | (local >= self.weight.shape[0])
        out = tF.embedding(local.masked_fill(out_of_range, 0), self.weight)
        out = out.masked_fill(out_of_range[..., None], 0.0)
        return reduce_from_mp(out, self.mp_group)


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """(reference: sequence_parallel_utils.py:229) The column-parallel
    layer's function; the JAX layer adds only an 'sp' layout constraint."""


class RowSequenceParallelLinear(RowParallelLinear):
    """(reference: sequence_parallel_utils.py:339) The row-parallel
    layer's function; the JAX layer adds only an 'sp' layout constraint."""


def _adopt(cls, module):
    """An instance of `cls` holding `module`'s parameters (the same
    objects) and attributes, not yet cut."""
    layer = cls.__new__(cls)
    nn.Module.__init__(layer)
    for k, v in vars(module).items():
        if not k.startswith("_"):
            setattr(layer, k, v)
    for k, p in module.named_parameters(recurse=False):
        setattr(layer, k, p)
    if isinstance(module, nn.Linear) and module.bias is None:
        layer.register_parameter("bias", None)
    layer.train(module.training)
    return layer


class _ParallelCE(torch.autograd.Function):
    """Mean softmax-CE over vocab-cut logits (N, V/n): the row max, the
    sum of exponents and the label's logit each all-reduced over the
    group; the backward is this rank's slice of (softmax - onehot) · g ·
    valid / count, in the logits' type (port `_CrossEntropyMean`)."""

    @staticmethod
    def forward(ctx, logits, labels, group, vocab_start, ignore_index):
        vl = logits.shape[-1]
        m = torch.amax(logits, dim=-1).float()
        collective.all_reduce(m, collective.ReduceOp.MAX, group)
        sumexp = torch.sum(torch.exp(logits.float() - m[:, None]), dim=-1)
        collective.all_reduce(sumexp, group=group)
        lse = m + torch.log(sumexp)
        valid = labels != ignore_index
        local = labels.long() - vocab_start
        mine = valid & (local >= 0) & (local < vl)
        safe = torch.where(mine, local, torch.zeros_like(local))
        picked = torch.where(mine, torch.gather(logits, 1, safe[:, None])[
            :, 0].float(), 0.0)
        collective.all_reduce(picked, group=group)
        count = torch.clamp(valid.float().sum(), min=1.0)
        loss = torch.where(valid, lse - picked,
                           torch.zeros_like(lse)).sum() / count
        ctx.save_for_backward(logits, safe, mine, lse, valid, count)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, safe, mine, lse, valid, count = ctx.saved_tensors
        scale = (g / count) * valid.float()
        d = torch.exp(logits.float() - lse[:, None])
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, safe] -= mine.float()
        d *= scale[:, None]
        return d.to(logits.dtype), None, None, None, None


def parallel_cross_entropy(logits, labels, group, vocab_start,
                           ignore_index=-100):
    """Mean CE of vocab-cut logits (N, V/n), this rank's columns starting
    at global vocab id `vocab_start`, against global int labels (N,); rows
    labelled `ignore_index` left out. f32, equal on every rank."""
    if group is None:
        return F.cross_entropy(logits, labels, ignore_index=ignore_index)
    return _ParallelCE.apply(logits, labels, group, int(vocab_start),
                             int(ignore_index))


class ParallelCrossEntropy(nn.Module):
    """Cross entropy over mp-cut logits (reference: mp_layers.py:743):
    `loss_fn(logits, label)`, logits (..., V/n) this rank's vocab columns,
    label (...) global ids; the mean over the rows not labelled
    `ignore_index`, as the JAX layer returns it."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = _mp_group(mp_group)
        self._ignore_index = ignore_index

    def forward(self, input, label):
        logits = input.reshape(-1, input.shape[-1])
        start = 0 if self.mp_group is None \
            else self.mp_group.rank * logits.shape[-1]
        return parallel_cross_entropy(logits, label.reshape(-1),
                                      self.mp_group, start,
                                      self._ignore_index)


_PARALLEL = (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
