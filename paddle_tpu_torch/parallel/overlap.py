"""Decomposed FSDP collectives with comm/compute overlap.

Counterpart of paddle_tpu/parallel/overlap.py. Under FSDP
(distributed/sharding.py) a module all-gathers its weight before the
product that reads it and reduce-scatters the gradient after the dW
product: the transfers run ahead of the matmuls instead of under them.
Here those products become point-to-point rings over the weight's
'fsdp' group (overlap-via-decomposition, Wang et al. ASPLOS'23): each
ring step posts the next piece's hop (distributed/collective.py
`ppermute_start`, rank i to rank i + 1) before it launches the products
on the resident piece, and waits for the hop after them. The products
are `torch.matmul`, as the JAX package computes them outside any kernel.

The port is multi-controller: each rank holds its own batch rows and its
own weight piece, and a ring runs n - 1 hops (the JAX scan's n-th hop
carries nothing a rank reads). The port's Linear weight is (out, in),
the transpose of the JAX layout, so the JAX `shard_dim` i is the port's
dim 1 - i (parallel/plan.py `_fsdp_cuts`):

- contract ring (q/k/v/qkv/gate/up: the input features cut, JAX
  shard_dim 0): at step j the piece of rank (idx - j) mod n multiplies
  the matching columns of x, one sub-chunk at a time (`_sub_chunks`),
  the products accumulated in f32 (each product in f32 too, `_mm_f32`:
  the JAX ring rounds each to bf16 first; here the sum of bf16 pieces
  rounds once, as the gathered product does);
- assemble ring (o/down: the output features cut, JAX shard_dim 1): the
  resident piece fills its slice of the output;
- reduce-scatter ring (dW = gᵀ x): the accumulator hops, the local
  partial of block (idx + n - 1 - j) mod n is added, and after n - 1
  hops each rank holds its own piece of dW summed over the group.

`_RingLinear` pairs them as the JAX custom_vjp does: the backward's dx is
the sibling ring over the same pieces and dW the reduce-scatter ring, so
the gradients overlap too. The dW piece is summed over the fsdp group
only; the Trainer sums it over the other batch axes
(`sharding.summed_axes`), as for the gather-at-use path.

Routing: inside `overlap_fsdp_guard` (the Trainer enters it with
`TrainStepConfig.overlap_fsdp`), `linear(module, x)` (models/llama.py's
projections; the head stays gather-at-use, as in JAX) takes the ring
for a bias-free Linear whose weight is cut over the guard's axis and
whose shapes the contract takes (`ring_cut`), else calls the module. A
tensor-parallel layer (distributed/fleet/layers.py) is called with
`_fsdp_ring` set: its gather-at-use hook (sharding.py `_pre_forward`)
leaves the weight cut and its local product between the f-op and the
g-op is the ring (`ring_product`). `counts` holds
the rings run ({"contract", "assemble", "reduce_scatter"}) and the
bytes this rank sent over them ("bytes").

The public ops `overlap_all_gather_matmul` / `overlap_matmul_reduce_
scatter` take the JAX layout and this rank's share of the JAX global
arrays (x: its rows of the batch axes 'dp' x `axis`, its sequence
shard on 'sp', its feature shard on 'mp' where the JAX spec cuts it; w:
its piece), and return this rank's share of the JAX result: the mp and
the other batch axes' sums are taken as the JAX shard_map does.
`kernel=None` takes the ring when the shape contract holds and the
plain product otherwise; "ring" raises naming every misaligned dim;
"jnp" is the plain product. The contracts read the GLOBAL shapes, as in
JAX.

`overlap_fraction_from_spans` reads the `train.overlap.phase` spans that
`Trainer.measure_phase_seconds` records (observability/trace.py).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from paddle_tpu_torch.distributed import collective

__all__ = [
    "overlap_all_gather_matmul", "overlap_matmul_reduce_scatter",
    "overlap_shape_problems", "check_overlap_shapes",
    "overlap_rs_shape_problems", "check_overlap_rs_shapes",
    "overlap_fsdp_guard", "current_overlap", "resolve_overlap_mesh",
    "overlap_fraction_from_spans", "overlap_linear", "linear",
    "ring_cut", "ring_product", "counts",
]

# the rings run and the bytes this rank sent over them
counts = {"contract": 0, "assemble": 0, "reduce_scatter": 0, "bytes": 0}


# ---------------------------------------------------------------------------
# shape contracts (global shapes, JAX layout)
# ---------------------------------------------------------------------------

def _extent(mesh, axis):
    return mesh.get_dim_size(axis) if axis in mesh.dim_names else 1


def _mesh_axis_problems(x_shape, mesh, axis, chunks):
    """Checks shared by both ops: the mesh/axis exist, the ring is
    enabled, and x's batch(+seq) dims split over their mesh axes."""
    problems = []
    if mesh is None:
        problems.append("no device mesh is active (pass mesh=, enter a "
                        "mesh context, or set_mesh)")
        return problems
    names = mesh.dim_names
    if axis not in names:
        problems.append(f"mesh has no '{axis}' axis "
                        f"(axes: {tuple(names)})")
        return problems
    if chunks < 1:
        problems.append(f"chunks must be >= 1 to run the ring (got "
                        f"{chunks}; 0 disables overlap upstream)")
    if len(x_shape) < 2:
        problems.append(f"x must be rank-2+ (got shape {tuple(x_shape)})")
        return problems
    bsz = _extent(mesh, "dp") * _extent(mesh, axis)
    if x_shape[0] % bsz:
        problems.append(f"x dim 0 ({x_shape[0]}) % dp x {axis} extent "
                        f"{bsz} != 0")
    if len(x_shape) >= 3 and "sp" in names \
            and x_shape[1] % _extent(mesh, "sp"):
        problems.append(f"x dim 1 ({x_shape[1]}) % 'sp' size "
                        f"{_extent(mesh, 'sp')} != 0")
    return problems


def overlap_shape_problems(x_shape, w_shape, mesh, axis="fsdp",
                           chunks=1, shard_dim=0):
    """Reasons `overlap_all_gather_matmul` cannot take the decomposed
    ring for these global shapes (w in the JAX (K, N) layout); empty =
    supported."""
    problems = _mesh_axis_problems(x_shape, mesh, axis, chunks)
    if problems and (mesh is None or axis not in mesh.dim_names):
        return problems
    if len(w_shape) != 2:
        problems.append(f"w must be rank-2 (got shape {tuple(w_shape)})")
        return problems
    if shard_dim not in (0, 1):
        problems.append(f"shard_dim must be 0 (contracting) or 1 "
                        f"(output); got {shard_dim}")
        return problems
    if len(x_shape) >= 2 and x_shape[-1] != w_shape[0]:
        problems.append(f"contracting dims differ: x[-1]={x_shape[-1]} "
                        f"vs w[0]={w_shape[0]}")
    n = _extent(mesh, axis)
    if w_shape[shard_dim] % n:
        problems.append(f"w dim {shard_dim} ({w_shape[shard_dim]}) % "
                        f"'{axis}' size {n} != 0")
    mp_sz = _extent(mesh, "mp")
    if mp_sz > 1 and w_shape[1 - shard_dim] % mp_sz:
        problems.append(f"w dim {1 - shard_dim} "
                        f"({w_shape[1 - shard_dim]}) % 'mp' size "
                        f"{mp_sz} != 0")
    return problems


def check_overlap_shapes(x_shape, w_shape, mesh, axis="fsdp", chunks=1,
                         shard_dim=0):
    problems = overlap_shape_problems(x_shape, w_shape, mesh, axis,
                                      chunks, shard_dim)
    if problems:
        raise ValueError(
            "overlap_all_gather_matmul: shapes cannot take the "
            "decomposed-collective ring — " + "; ".join(problems)
            + '; use kernel="jnp" for the plain product')


def overlap_rs_shape_problems(x_shape, g_shape, mesh, axis="fsdp",
                              chunks=1, shard_dim=0):
    """Reasons `overlap_matmul_reduce_scatter` cannot take the ring:
    x (..., K) and g (..., N) contract over their shared leading dims
    into a (K, N) result whose `shard_dim` scatters over `axis`."""
    problems = _mesh_axis_problems(x_shape, mesh, axis, chunks)
    if problems and (mesh is None or axis not in mesh.dim_names):
        return problems
    if len(x_shape) != len(g_shape) \
            or tuple(x_shape[:-1]) != tuple(g_shape[:-1]):
        problems.append(f"x and g must share leading (batch) dims: "
                        f"x {tuple(x_shape)} vs g {tuple(g_shape)}")
        return problems
    if shard_dim not in (0, 1):
        problems.append(f"shard_dim must be 0 (rows = x's features) or "
                        f"1 (cols = g's features); got {shard_dim}")
        return problems
    n = _extent(mesh, axis)
    out_shape = (x_shape[-1], g_shape[-1])
    if out_shape[shard_dim] % n:
        problems.append(f"result dim {shard_dim} "
                        f"({out_shape[shard_dim]}) % '{axis}' size "
                        f"{n} != 0")
    mp_sz = _extent(mesh, "mp")
    if mp_sz > 1 and out_shape[1 - shard_dim] % mp_sz:
        problems.append(f"result dim {1 - shard_dim} "
                        f"({out_shape[1 - shard_dim]}) % 'mp' size "
                        f"{mp_sz} != 0")
    return problems


def check_overlap_rs_shapes(x_shape, g_shape, mesh, axis="fsdp",
                            chunks=1, shard_dim=0):
    problems = overlap_rs_shape_problems(x_shape, g_shape, mesh, axis,
                                         chunks, shard_dim)
    if problems:
        raise ValueError(
            "overlap_matmul_reduce_scatter: shapes cannot take the "
            "decomposed-collective ring — " + "; ".join(problems)
            + '; use kernel="jnp" for the plain product')


# ---------------------------------------------------------------------------
# the rings (this rank's pieces; port layout)
# ---------------------------------------------------------------------------

def _sub_chunks(size, chunks):
    """(offset, length) sub-pieces of one resident piece; the last piece
    absorbs the remainder (uneven chunk counts are legal)."""
    c = max(1, min(int(chunks), int(size)))
    step = -(-size // c)
    return [(off, min(step, size - off)) for off in range(0, size, step)]


def _mm_f32(a, b):
    """a @ b (2-D) in f32 without rounding the product to the operands'
    type: cuBLAS writes bf16 / f16 products straight to f32 on the card
    (`out_dtype`); elsewhere the operands are upcast."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _hop(t, group):
    """Post `t`'s hop from every rank i of the ring to rank i + 1."""
    n = group.nranks
    work = collective.ppermute_start(
        t, None, [(i, (i + 1) % n) for i in range(n)], group=group)
    counts["bytes"] += work.nbytes
    return work


def _ring_linear(x, piece, group, chunks, dim, t=False):
    """x @ Mᵀ over the ring, M (N, K) the whole matrix of which this rank
    holds a piece cut on M's dim `dim` over `group`: M is the cut weight
    (`t` False: `piece` is M's piece) or its transpose (`t` True:
    `piece` is the weight's piece, cut on its dim 1 - `dim`). dim 1 (K
    cut) is the contract ring, dim 0 (N cut) the assemble ring."""
    n, idx = group.nranks, group.rank
    pdim = 1 - dim if t else dim
    size = piece.shape[pdim]
    pieces = _sub_chunks(size, chunks)
    dtype = torch.result_type(x, piece)

    def rhs(cur, off, ln):
        """The sub-chunk of Mᵀ the product multiplies by: (K', N')."""
        s = cur.narrow(pdim, off, ln)
        return s if t else s.t()

    cur = piece
    if dim == 1:
        counts["contract"] += 1
        x2 = x.reshape(-1, x.shape[-1])
        acc = torch.zeros((x2.shape[0], piece.shape[1 - pdim]),
                          dtype=torch.float32, device=x.device)
    else:
        counts["assemble"] += 1
        out = torch.empty(x.shape[:-1] + (n * size,), dtype=dtype,
                          device=x.device)
    for j in range(n):
        src = (idx - j) % n                  # the resident piece's owner
        work = _hop(cur, group) if j < n - 1 else None
        if dim == 1:
            for off, ln in pieces:
                lo = src * size + off
                acc.add_(_mm_f32(x2[:, lo:lo + ln], rhs(cur, off, ln)))
        else:
            blk = [torch.matmul(x, rhs(cur, off, ln)) for off, ln in pieces]
            out[..., src * size:(src + 1) * size] = \
                blk[0] if len(blk) == 1 else torch.cat(blk, -1)
        if work is not None:
            cur = work.wait()
    if dim == 1:
        return acc.to(dtype).reshape(x.shape[:-1] + (acc.shape[1],))
    return out


def _ring_reduce_scatter(x, g, group, chunks, dim):
    """This rank's piece of gᵀ x (the port layout's dW, (N, K) for x
    (..., K) and g (..., N)) cut on `dim` over `group`, summed over the
    group: the f32 accumulator hops while the next block's partial
    product runs; block c ends at rank c after n - 1 hops."""
    n, idx = group.nranks, group.rank
    x2 = x.reshape(-1, x.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    bc = (x2.shape[1] if dim == 1 else g2.shape[1]) // n
    pieces = _sub_chunks(bc, chunks)

    def block(c):
        outs = []
        for off, ln in pieces:
            lo = c * bc + off
            outs.append(_mm_f32(g2.t(), x2[:, lo:lo + ln]) if dim == 1
                        else _mm_f32(g2[:, lo:lo + ln].t(), x2))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim)

    counts["reduce_scatter"] += 1
    acc = block((idx + n - 1) % n)
    for j in range(1, n):
        work = _hop(acc, group)
        part = block((idx + n - 1 - j) % n)
        acc = work.wait().add_(part)
    return acc.to(torch.result_type(x, g))


class _RingLinear(torch.autograd.Function):
    """x @ weightᵀ with the (out, in) weight's piece cut on `dim` over
    `group`. Backward: dx by the sibling ring over the same pieces, dW by
    the reduce-scatter ring (then summed over `grad_group` when given)."""

    @staticmethod
    def forward(ctx, x, piece, group, dim, chunks, grad_group):
        ctx.save_for_backward(x, piece)
        ctx.ring = (group, dim, chunks, grad_group)
        return _ring_linear(x, piece, group, chunks, dim)

    @staticmethod
    def backward(ctx, gy):
        x, piece = ctx.saved_tensors
        group, dim, chunks, grad_group = ctx.ring
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _ring_linear(gy, piece, group, chunks, 1 - dim,
                              t=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _ring_reduce_scatter(x, gy, group, chunks, dim)
            if grad_group is not None:
                collective.all_reduce(dw, group=grad_group)
            dw = dw.to(piece.dtype)
        return dx, dw, None, None, None, None


class _RingReduceScatter(torch.autograd.Function):
    """The JAX-layout (K, N) piece of xᵀ g cut on `sd` over `group`,
    summed over `red_group` too; its backward composes the all-gather
    rings as the JAX `rs_bwd` does (each output summed over `mp_group`
    where its contraction runs over mp-cut features)."""

    @staticmethod
    def forward(ctx, x, g, group, sd, chunks, red_group, mp_group):
        ctx.save_for_backward(x, g)
        ctx.ring = (group, sd, chunks, mp_group)
        out = _ring_reduce_scatter(x, g, group, chunks, 1 - sd).t()
        if red_group is not None:
            out = out.contiguous()
            collective.all_reduce(out, group=red_group)
        return out

    @staticmethod
    def backward(ctx, dr):
        x, g = ctx.saved_tensors
        group, sd, chunks, mp_group = ctx.ring
        dr = dr.contiguous()
        # dx = g @ drᵀ: M = dr (K, N) cut on sd; dg = x @ dr: M = drᵀ
        dx = _ring_linear(g, dr, group, chunks, sd)
        dg = _ring_linear(x, dr, group, chunks, 1 - sd, t=True)
        if mp_group is not None:
            collective.all_reduce(dx if sd == 0 else dg, group=mp_group)
        return dx.to(x.dtype), dg.to(g.dtype), None, None, None, None, None


# ---------------------------------------------------------------------------
# public ops (JAX layout, this rank's share)
# ---------------------------------------------------------------------------

def resolve_overlap_mesh(mesh=None):
    """The mesh the ring runs over: explicit arg > active guard > the
    current mesh (distributed/mesh.py `get_mesh`)."""
    if mesh is None and _state["on"]:
        mesh = _state["mesh"]
    if mesh is None:
        from paddle_tpu_torch.distributed.mesh import get_mesh
        return get_mesh()
    return mesh


def _group(mesh, axes):
    """The mesh's group over those of `axes` it has with extent > 1, or
    None."""
    axes = tuple(a for a in axes if _extent(mesh, a) > 1)
    return mesh.get_group(axes if len(axes) > 1 else axes[0]) \
        if axes else None


def _global_shape(shape, mesh, axis, feat_on_mp):
    """The JAX global shape of this rank's (batch, [seq, ...], feat)."""
    out = list(shape)
    out[0] *= _extent(mesh, "dp") * (_extent(mesh, axis) if axis != "dp"
                                     else 1)
    if len(out) >= 3:
        out[1] *= _extent(mesh, "sp")
    if feat_on_mp:
        out[-1] *= _extent(mesh, "mp")
    return out


def _check_kernel(kernel):
    if kernel not in (None, "ring", "jnp"):
        raise ValueError(f"kernel must be None, 'ring' or 'jnp' "
                         f"(got {kernel!r})")


def overlap_all_gather_matmul(x, w, axis="fsdp", chunks=1, mesh=None,
                              kernel=None, shard_dim=0):
    """x @ w, w (K, N) in the JAX layout cut on `shard_dim` over mesh
    axis `axis` (0: the contracting dim, the spec P(fsdp, mp); 1: the
    output dim, P(mp, fsdp)), as a chunked ring that overlaps the
    weight's all-gather with the products. x and w are this rank's
    shares (module docstring); differentiable in both. kernel: None =
    the ring when the shape contract holds, else the plain product;
    "ring" = forced (raises via check_overlap_shapes); "jnp" = the plain
    product of the local shares."""
    _check_kernel(kernel)
    if kernel == "jnp":
        return torch.matmul(x, w)
    mesh = resolve_overlap_mesh(mesh)
    mp = None if mesh is None else _group(mesh, ("mp",))
    gw = None
    if mesh is not None and axis in mesh.dim_names:
        gw = list(w.shape)
        gw[shard_dim] *= _extent(mesh, axis)
        gw[1 - shard_dim] *= _extent(mesh, "mp")
    problems = overlap_shape_problems(
        x.shape if mesh is None else _global_shape(
            x.shape, mesh, axis, shard_dim == 1 and mp is not None),
        w.shape if gw is None else gw, mesh, axis, chunks, shard_dim)
    if problems:
        if kernel == "ring":
            raise ValueError(
                "overlap_all_gather_matmul: shapes cannot take the "
                "decomposed-collective ring — " + "; ".join(problems)
                + '; use kernel="jnp" for the plain product')
        return torch.matmul(x, w)
    from paddle_tpu_torch.distributed.fleet.layers import (copy_to_mp,
                                                           reduce_from_mp)
    group = mesh.get_group(axis)
    red = _group(mesh, tuple(a for a in ("dp", "sp") if a != axis))
    if shard_dim == 0:
        return _RingLinear.apply(copy_to_mp(x, mp), w.t(), group, 1,
                                 int(chunks), red)
    return reduce_from_mp(_RingLinear.apply(x, w.t(), group, 0,
                                            int(chunks), red), mp)


def overlap_matmul_reduce_scatter(x, g, axis="fsdp", chunks=1, mesh=None,
                                  kernel=None, shard_dim=0):
    """The grad-side contraction xᵀ g (x (..., K), g (..., N) -> (K, N))
    with the result's `shard_dim` reduce-scattered over `axis` and
    summed over the other batch axes, as a ring whose accumulator hop
    overlaps the next block's product; this rank's shares in, its piece
    out. Same kernel contract as `overlap_all_gather_matmul`."""
    _check_kernel(kernel)
    lead = tuple(range(x.dim() - 1))
    if kernel == "jnp":
        return torch.tensordot(x, g, dims=(lead, lead))
    mesh = resolve_overlap_mesh(mesh)
    mp = None if mesh is None else _group(mesh, ("mp",))
    gx = gg = None
    if mesh is not None and axis in mesh.dim_names:
        gx = _global_shape(x.shape, mesh, axis,
                           shard_dim == 1 and mp is not None)
        gg = _global_shape(g.shape, mesh, axis,
                           shard_dim == 0 and mp is not None)
    problems = overlap_rs_shape_problems(
        x.shape if gx is None else gx, g.shape if gg is None else gg,
        mesh, axis, chunks, shard_dim)
    if problems:
        if kernel == "ring":
            raise ValueError(
                "overlap_matmul_reduce_scatter: shapes cannot take the "
                "decomposed-collective ring — " + "; ".join(problems)
                + '; use kernel="jnp" for the plain product')
        return torch.tensordot(x, g, dims=(lead, lead))
    red = _group(mesh, tuple(a for a in ("dp", "sp") if a != axis))
    return _RingReduceScatter.apply(x, g, mesh.get_group(axis),
                                    int(shard_dim), int(chunks), red, mp)


def overlap_linear(x, weight, axis="fsdp", chunks=1, shard_dim=0,
                   group=None):
    """`F.linear(x, weight)` through the ring (bias-free: the plan's FSDP
    projections carry none): `weight` is this rank's piece of a port
    (out, in) weight cut over `axis` on the JAX dim `shard_dim` (port
    dim 1 - shard_dim). `group` is the cut's group, else the mesh's
    `axis` group. The gradient of the piece is summed over the cut's
    group only."""
    if group is None:
        group = resolve_overlap_mesh().get_group(axis)
    return _RingLinear.apply(x, weight, group, 1 - int(shard_dim),
                             max(1, int(chunks)), None)


# ---------------------------------------------------------------------------
# model integration
# ---------------------------------------------------------------------------

_state = {"on": False, "mesh": None, "axis": "fsdp", "chunks": 1}


@contextmanager
def overlap_fsdp_guard(mesh, axis="fsdp", chunks=1):
    """Inside this context the model's FSDP-cut projections route
    through the rings over `axis` (module docstring); the Trainer enters
    it around its loss (TrainStepConfig.overlap_fsdp)."""
    prev = dict(_state)
    _state.update(on=True, mesh=mesh, axis=axis, chunks=max(1, int(chunks)))
    try:
        yield
    finally:
        _state.update(prev)


def current_overlap():
    return dict(_state) if _state["on"] else None


def ring_cut(module, x):
    """The FSDPShard whose ring carries `module`'s weight for input `x`
    inside the guard: a bias-free Linear whose weight is cut over the
    guard's axis on one of its two dims, and whose shapes the contract
    takes (the global ones: x's rows over the batch axes, its features
    over 'mp' for a row-parallel layer); else None, and the module keeps
    the gather-at-use path."""
    if not _state["on"]:
        return None
    cut = getattr(module, "_fsdp_cuts", {}).get("weight")
    if cut is None or cut.axis != _state["axis"] or cut.dim not in (0, 1) \
            or not isinstance(module, torch.nn.Linear) \
            or module.bias is not None:
        return None
    mesh = _state["mesh"]
    if mesh is not None:
        # the whole weight's shape from the module's cuts (the weight may
        # be the Trainer's compute-type copy of the piece)
        whole = list(module._parameters["weight"].shape)
        whole[cut.dim] *= cut.group.nranks
        mp = getattr(module, "mp_group", None)
        row_mp = False
        if mp is not None:
            from paddle_tpu_torch.distributed.fleet.layers import (
                RowParallelLinear)
            row_mp = isinstance(module, RowParallelLinear)
            whole[1 if row_mp else 0] *= mp.nranks
        if overlap_shape_problems(
                _global_shape(x.shape, mesh, cut.axis, row_mp), whole[::-1],
                mesh, cut.axis, _state["chunks"], 1 - cut.dim):
            return None
    return cut


def ring_product(module, x):
    """A tensor-parallel layer's local product x @ weightᵀ (+ bias),
    between its f-op and its g-op: through the ring while `linear` has
    put the layer on one (`module._fsdp_ring`), else F.linear."""
    cut = getattr(module, "_fsdp_ring", None)
    if cut is None:
        return torch.nn.functional.linear(x, module.weight, module.bias)
    return overlap_linear(x, module.weight, cut.axis, _state["chunks"],
                          1 - cut.dim, cut.group)


def linear(module, x):
    """A projection's output (JAX llama.py `_maybe_overlap_linear`):
    inside the guard, when `ring_cut` takes the module, a plain Linear's
    product is the ring, and a tensor-parallel layer runs its own forward
    with `_fsdp_ring` set, so its gather-at-use hook (distributed/
    sharding.py `_pre_forward`) leaves the weight cut and its product
    (`ring_product`) is the ring; else `module(x)`."""
    cut = ring_cut(module, x) if _state["on"] else None
    if cut is None:
        return module(x)
    if getattr(module, "mp_group", None) is None:
        return overlap_linear(x, module.weight, cut.axis, _state["chunks"],
                              1 - cut.dim, cut.group)
    module._fsdp_ring = cut
    try:
        return module(x)
    finally:
        module._fsdp_ring = None


# ---------------------------------------------------------------------------
# overlap fraction from the trace spans
# ---------------------------------------------------------------------------

def overlap_fraction_from_spans(span_list=None):
    """Overlap fraction from the `train.overlap.phase` spans
    `Trainer.measure_phase_seconds` records: comm time hidden under
    compute / total comm time, summed over the fwd/bwd phases, where

        total  = t(propagated) - t(nocomm)    per phase
        hidden = t(propagated) - t(overlapped)

    (`propagated` = gather-at-use, `overlapped` = the rings, `nocomm` =
    every fsdp weight whole on each rank, no weight collective). Reads
    the live span ring when `span_list` is None; the newest measurement
    of each (variant, phase) wins. A float in [0, 1], or None when the
    spans lack a complete measurement."""
    if span_list is None:
        from paddle_tpu_torch.observability import trace
        span_list = trace.spans()
    t = {}
    for s in span_list:
        if s.name != "train.overlap.phase":
            continue
        t[(s.attrs.get("variant"), s.attrs.get("phase"))] = s.dur_us / 1e6
    total = hidden = 0.0
    for ph in ("fwd", "bwd"):
        prop = t.get(("propagated", ph))
        ovl = t.get(("overlapped", ph))
        noc = t.get(("nocomm", ph))
        if prop is None or ovl is None or noc is None:
            return None
        total += max(0.0, prop - noc)
        hidden += max(0.0, prop - ovl)
    if total <= 0.0:
        return None
    return max(0.0, min(1.0, hidden / total))
