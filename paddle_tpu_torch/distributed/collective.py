"""Eager collective communication over ``torch.distributed``.

Counterpart of paddle_tpu/distributed/collective.py (reference:
python/paddle/distributed/communication/*.py over the C++ ProcessGroup,
process_group_nccl.h:37). The JAX facade is single-controller: one
process holds a rank-major ``(nranks, *local)`` array and each
collective is a compiled shard_map over a private mesh. This one is
multi-controller, as CUDA is: one process a device, each holding its own
local tensor, over one ``torch.distributed`` process group (NCCL on the
card, gloo on the CPU). The parity rule: for a rank-major input X, rank r
of an N-process job, given X[r], returns the JAX facade's row Y[r]. Where
the JAX facade can only lift one replicated value to every rank (the
list forms of `reduce_scatter` and `alltoall`, and `scatter`'s source),
the port takes each rank's own.

- `Group` wraps a torch process group over an ordered set of global
  ranks (held sorted, as torch numbers a group's members). `new_group`
  is called by every process of the world with the same ranks (torch's
  rule); a process outside the group gets a Group whose collectives
  return their input untouched.
- Without `init_parallel_env` (distributed/env.py) the default group is
  this one process, as the JAX default group is this process's devices:
  the first collective forms a one-rank world on a private in-process
  store, gloo for CPU tensors and NCCL for CUDA ones. `init_parallel_env`
  replaces it. Nothing falls back to another device.
- `all_reduce`, `broadcast` and `reduce` work in place on the local
  tensor and return it; `reduce` leaves every rank but `dst` its input,
  whatever the backend wrote into the buffer. PROD is the backend's
  product (the JAX facade's exp(psum(log x)) is NaN for a negative
  entry); AVG is the sum over the group divided by its size.
- `send` / `recv` are point-to-point (a small header carries the shape
  and dtype, so `recv(tensor=None)` works); a send to this process's own
  rank queues locally for its `recv`, as the JAX facade pairs them.
- `psum`, `pmean` and `ppermute(x, axis_name, perm)` work over the
  current mesh's (mesh.py `get_mesh`) group for `axis_name`;
  `ppermute_start` posts the same transfer and returns a `P2PWork`
  whose `wait()` gives the result, so a ring posts its next hop before
  it launches the work on the resident piece (parallel/overlap.py,
  distributed/context_parallel.py). The private `_p2p_start` posts a
  set of sends and receives of known shapes together (a pipeline
  stage's hop out and its next hop in: parallel/pipeline.py) and waits
  for the receives apart from the sends, each wait under a timeout.
- Gloo's point-to-point path reads and writes a tensor's memory from the
  host, and a gloo group's `alltoall` runs as point-to-point pairs (gloo
  has no all-to-all in every torch build), so for these a CUDA tensor on
  a gloo group is staged through pinned host buffers: copied out
  before the send, copied back onto the card after the receive, on the
  caller's stream. The result stays on the card; a
  group with NCCL for CUDA never stages (gloo's collectives stage CUDA
  tensors internally).
- Every collective registers with the watchdog for its dispatch and
  completion (`collective/<name>`), under the chaos site
  ``collective.dispatch/<name>`` while chaos is enabled, and completes
  through `watchdog.complete_when_ready`: an eager collective on the card
  adds no host sync. A group's `timeout` is its ops' watchdog deadline.
  `sync_op` is accepted for the reference's signature; every op is
  enqueued in order on the caller's stream.
"""
from __future__ import annotations

import contextlib
import datetime
import gc

import torch
import torch.distributed as tdist

from paddle_tpu_torch.distributed import chaos, env, watchdog

__all__ = ["ReduceOp", "Group", "new_group", "get_group",
           "destroy_process_group", "all_reduce", "all_gather", "broadcast",
           "reduce", "reduce_scatter", "alltoall", "scatter", "barrier",
           "send", "recv", "psum", "pmean", "ppermute", "ppermute_start",
           "P2PWork"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: tdist.ReduceOp.SUM,
              ReduceOp.MAX: tdist.ReduceOp.MAX,
              ReduceOp.MIN: tdist.ReduceOp.MIN,
              ReduceOp.PROD: tdist.ReduceOp.PRODUCT,
              ReduceOp.AVG: tdist.ReduceOp.SUM}     # then / nranks


def _torch_op(op):
    try:
        return _TORCH_OPS[op]
    except KeyError:
        raise ValueError(f"unknown reduce op {op!r}") from None


def _seconds(timeout):
    if isinstance(timeout, datetime.timedelta):
        return timeout.total_seconds()
    return None if timeout is None else float(timeout)


class Group:
    """A communication group (the reference's ProcessGroup): the sorted
    global `ranks`, this process's `rank` in it (-1 outside), and the
    torch process group its collectives run on."""

    _next_gid = [0]

    def __init__(self, ranks, pg, timeout=None):
        self.ranks = sorted(int(r) for r in ranks)
        self.nranks = len(self.ranks)
        self.process_group = pg
        me = tdist.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else -1
        self.timeout_ms = (None if timeout is None
                           else max(1, int(_seconds(timeout) * 1000)))
        self.id = Group._next_gid[0]
        Group._next_gid[0] += 1

    @property
    def world_size(self):
        return self.nranks

    @property
    def is_member(self):
        return self.rank >= 0

    def get_group_rank(self, global_rank):
        return self.ranks.index(global_rank)

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_default_group: list[Group | None] = [None]
# every Group made: destroy_process_group drops their torch groups while
# the interpreter runs (a torch group left to interpreter teardown can
# abort the process on its way out)
_group_registry: dict[int, Group] = {}
# the one-rank world a collective formed before init_parallel_env
_private_world = [False]
# send()s to this process's own rank, per group id, for its recv()s
_self_queue: dict[int, list] = {}


def _ensure_world():
    if tdist.is_initialized():
        return
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    tdist.init_process_group(backend, store=tdist.HashStore(), rank=0,
                             world_size=1)
    _private_world[0] = True


def _forget_groups():
    from paddle_tpu_torch.distributed import mesh
    _default_group[0] = None
    for g in _group_registry.values():
        g.process_group = None
    _group_registry.clear()
    _self_queue.clear()
    mesh._release_groups()
    gc.collect()


def _drop_private_world():
    """init_parallel_env is about to form the real world."""
    if _private_world[0]:
        _private_world[0] = False
        tdist.destroy_process_group()
    _forget_groups()


def destroy_process_group():
    """Tear down the world and every group; init_parallel_env may run
    again (reference: paddle.distributed destroy_process_group)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _private_world[0] = False
    env._destroy()
    _forget_groups()


def _get_group(group=None) -> Group:
    if group is not None:
        if group.process_group is None:
            raise RuntimeError(f"{group} belongs to a destroyed world")
        return group
    if _default_group[0] is None:
        _ensure_world()
        g = Group(range(tdist.get_world_size()), tdist.GroupMember.WORLD)
        _default_group[0] = g
        _group_registry[g.id] = g
    return _default_group[0]


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group over `ranks` (None: the world). Every process of the world
    calls it with the same ranks. `timeout` (seconds or a timedelta) is
    the watchdog deadline of its collectives (reference:
    communication/group.py new_group)."""
    _ensure_world()
    world = tdist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    bad = [r for r in ranks if not 0 <= r < world]
    if bad:
        raise ValueError(f"ranks {bad} are outside the world of {world}")
    pg = tdist.new_group(ranks=sorted(ranks), backend=backend)
    g = Group(ranks, pg, timeout)
    _group_registry[g.id] = g
    return g


def _adopt(pg) -> Group:
    """A Group over an existing torch process group (a mesh axis's)."""
    g = Group(tdist.get_process_group_ranks(pg), pg)
    _group_registry[g.id] = g
    return g


def get_group(id: int = 0) -> Group:
    if id == 0 and not _group_registry:
        return _get_group()
    return _group_registry[id]


def _device(g):
    """Where a collective without a tensor runs (barrier, recv's header):
    the world's CUDA device under NCCL, else the CPU."""
    dev = env.world_device()
    if dev is not None and dev.type == "cuda" and \
            tdist.get_backend(g.process_group) == "nccl":
        return dev
    return torch.device("cpu")


@contextlib.contextmanager
def _watched(name, g, *outs):
    """The op's dispatch inside the watchdog's window (module docstring);
    it completes once the device has finished `outs`. Each caller
    consults its literal chaos site first thing inside: a slow host in
    the registered window, so the watchdog's deadline is what catches
    the hang."""
    op = watchdog.begin(f"collective/{name} ranks={g.ranks}", g.timeout_ms)
    try:
        yield
    except BaseException:
        watchdog.end(op)
        raise
    watchdog.complete_when_ready(op, outs)


def _tensor(t):
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(t)


def _avg(t, op, g):
    if op == ReduceOp.AVG:
        t.div_(g.nranks)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce every rank's local tensor; every rank receives the result,
    in place (reference: communication/all_reduce.py)."""
    g = _get_group(group)
    t = _tensor(tensor)
    if g.is_member:
        with _watched("all_reduce", g, t):
            if chaos.ENABLED:
                chaos.maybe_delay("collective.dispatch/all_reduce")
            tdist.all_reduce(t, _torch_op(op), group=g.process_group)
            _avg(t, op, g)
    return t


def all_gather(tensor_list, tensor=None, group=None, sync_op=True):
    """Every rank's local tensor, in rank order, on every rank
    (reference: communication/all_gather.py); also the functional
    `all_gather(tensor)`. Fills `tensor_list` when given."""
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    g = _get_group(group)
    t = _tensor(tensor).contiguous()
    if not g.is_member:
        return [t]
    outs = [torch.empty_like(t) for _ in range(g.nranks)]
    with _watched("all_gather", g, *outs):
        if chaos.ENABLED:
            chaos.maybe_delay("collective.dispatch/all_gather")
        tdist.all_gather(outs, t, group=g.process_group)
    if tensor_list is not None:
        tensor_list.clear()
        tensor_list.extend(outs)
    return outs


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Every rank receives rank `src`'s tensor, in place (reference:
    communication/broadcast.py)."""
    g = _get_group(group)
    if src not in g.ranks:
        raise ValueError(f"src rank {src} is not in group ranks {g.ranks}")
    t = _tensor(tensor)
    if g.is_member:
        with _watched("broadcast", g, t):
            if chaos.ENABLED:
                chaos.maybe_delay("collective.dispatch/broadcast")
            tdist.broadcast(t, src, group=g.process_group)
    return t


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce onto rank `dst`, in place; every other rank keeps its
    input."""
    g = _get_group(group)
    if dst not in g.ranks:
        raise ValueError(f"dst rank {dst} is not in group ranks {g.ranks}")
    t = _tensor(tensor)
    if not g.is_member:
        return t
    buf = t.clone()
    with _watched("reduce", g, buf):
        if chaos.ENABLED:
            chaos.maybe_delay("collective.dispatch/reduce")
        tdist.reduce(buf, dst, _torch_op(op), group=g.process_group)
    if tdist.get_rank() == dst:
        _avg(buf, op, g)
        t.copy_(buf)
    return t


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Reduce across ranks, then rank r keeps chunk r (reference:
    communication/reduce_scatter.py). The chunks are `tensor_list` (one
    a rank; the result is also written into `tensor`, the reference's
    output, when its shape fits) or `tensor` split along dim 0."""
    g = _get_group(group)
    if tensor_list is not None:
        if len(tensor_list) != g.nranks:
            raise ValueError(
                f"tensor_list has {len(tensor_list)} entries for a "
                f"{g.nranks}-rank group")
        chunks = [_tensor(c).contiguous() for c in tensor_list]
    else:
        t = _tensor(tensor)
        if t.shape[0] % g.nranks:
            raise ValueError(
                f"dim0 ({t.shape[0]}) not divisible by nranks {g.nranks}")
        chunks = [c.contiguous() for c in t.chunk(g.nranks)]
    if not g.is_member:
        return chunks[0]
    out = torch.empty_like(chunks[0])
    with _watched("reduce_scatter", g, out):
        if chaos.ENABLED:
            chaos.maybe_delay("collective.dispatch/reduce_scatter")
        tdist.reduce_scatter(out, chunks, _torch_op(op),
                             group=g.process_group)
        _avg(out, op, g)
    if tensor_list is not None and isinstance(tensor, torch.Tensor) \
            and tensor.shape == out.shape:
        tensor.copy_(out)
    return out


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Rank r sends its chunk c to rank c and receives chunk r from every
    rank, in rank order (reference: communication/all_to_all.py). A list
    in gives a list out (also into `out_tensor_list`); a tensor of
    (nranks, *chunk) gives one."""
    g = _get_group(group)
    listed = isinstance(in_tensor_list, (list, tuple))
    ins = ([_tensor(c).contiguous() for c in in_tensor_list] if listed
           else [c.contiguous() for c in _tensor(in_tensor_list).unbind(0)])
    if len(ins) != g.nranks:
        raise ValueError(f"{len(ins)} chunks for a {g.nranks}-rank group")
    if not g.is_member:
        return ins if listed else _tensor(in_tensor_list)
    staged = _staged(g, ins[0].device)
    wire = [_to_host(c) for c in ins] if staged else ins
    outs = [_host_buffer(c) if staged else torch.empty_like(c)
            for c in wire]
    with _watched("alltoall", g, *outs):
        if chaos.ENABLED:
            chaos.maybe_delay("collective.dispatch/alltoall")
        if "gloo" in str(tdist.get_backend(g.process_group)):
            _alltoall_p2p(outs, wire, g)
        else:
            tdist.all_to_all(outs, wire, group=g.process_group)
    if staged:
        outs = [o.to(ins[0].device, non_blocking=True) for o in outs]
    if not listed:
        return torch.stack(outs)
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(outs)
    return outs


def _alltoall_p2p(outs, ins, g):
    """All-to-all as point-to-point pairs (gloo has no all_to_all in
    every torch build): this rank keeps its own chunk and exchanges one
    with each other rank."""
    me = g.rank
    outs[me].copy_(ins[me])
    ops = []
    for r in range(g.nranks):
        if r != me:
            ops.append(tdist.P2POp(tdist.isend, ins[r], g.ranks[r],
                                   g.process_group))
            ops.append(tdist.P2POp(tdist.irecv, outs[r], g.ranks[r],
                                   g.process_group))
    for w in tdist.batch_isend_irecv(ops) if ops else ():
        w.wait()


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank r receives entry r of rank `src`'s `tensor_list` into `tensor`
    and returns it (reference: communication/scatter.py; the list is read
    on `src` only). Without a list, `src`'s `tensor` is the whole
    (nranks, ...) source, split along dim 0, and `src` returns its row in
    a new tensor; the other ranks' `tensor` is their output either way."""
    g = _get_group(group)
    if src not in g.ranks:
        raise ValueError(f"src rank {src} is not in group ranks {g.ranks}")
    t = _tensor(tensor)
    parts, out = None, t
    if tdist.get_rank() == src:
        parts = ([_tensor(c).contiguous() for c in tensor_list]
                 if tensor_list is not None
                 else [c.contiguous() for c in t.unbind(0)])
        if len(parts) != g.nranks:
            raise ValueError(f"{len(parts)} entries for a {g.nranks}-rank "
                             "group")
        if tensor_list is None:
            out = torch.empty_like(parts[0])
    if g.is_member:
        with _watched("scatter", g, out):
            if chaos.ENABLED:
                chaos.maybe_delay("collective.dispatch/scatter")
            tdist.scatter(out, parts, src=src, group=g.process_group)
    return out


def barrier(group=None):
    """Return once every rank of the group reached it."""
    g = _get_group(group)
    if not g.is_member:
        return
    x = torch.zeros(1, device=_device(g))
    with _watched("barrier", g, x):
        if chaos.ENABLED:
            chaos.maybe_delay("collective.dispatch/barrier")
        tdist.all_reduce(x, group=g.process_group)
    x.cpu()


_HEADER = 10        # dtype code, ndim, up to 8 dims
_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool]


def _staged(g, dev):
    """Whether a tensor on `dev` crosses group `g` through host memory: a
    CUDA tensor on a group without NCCL for CUDA (module docstring)."""
    return dev.type == "cuda" and "nccl" not in str(
        tdist.get_backend(g.process_group))


def _to_host(t):
    """A pinned host copy of CUDA tensor `t`, complete when it returns."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _host_buffer(t):
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send to global rank `dst` (reference:
    communication/send.py), paired with its `recv`."""
    g = _get_group(group)
    t = _tensor(tensor).contiguous()
    if t.ndim > _HEADER - 2:
        raise ValueError(f"send takes at most {_HEADER - 2} dims")
    if dst == tdist.get_rank():
        _self_queue.setdefault(g.id, []).append(t.clone())
        return
    staged = _staged(g, t.device)
    head = torch.zeros(_HEADER, dtype=torch.int64,
                       device="cpu" if staged else t.device)
    head[0], head[1] = _DTYPES.index(t.dtype), t.ndim
    head[2:2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
    with _watched("send", g, t):
        if chaos.ENABLED:
            chaos.maybe_delay("collective.dispatch/send")
        tdist.send(head, dst, group=g.process_group)
        tdist.send(_to_host(t) if staged else t, dst, group=g.process_group)


def recv(tensor=None, src=0, group=None, sync_op=True):
    """Receive global rank `src`'s next `send`: into `tensor` when given,
    else into a new tensor on the world's device (the CPU before
    init_parallel_env). Returns it."""
    g = _get_group(group)
    if src == tdist.get_rank():
        queued = _self_queue.get(g.id)
        if not queued:
            raise RuntimeError("recv() from this process's own rank without "
                               "a matching send()")
        val = queued.pop(0)
        if tensor is None:
            return val
        tensor.copy_(val)
        return tensor
    dev = tensor.device if tensor is not None else (
        env.world_device() or torch.device("cpu"))
    staged = _staged(g, dev)
    wire = torch.device("cpu") if staged else dev
    head = torch.zeros(_HEADER, dtype=torch.int64, device=wire)
    with _watched("recv", g, head):
        if chaos.ENABLED:
            chaos.maybe_delay("collective.dispatch/recv")
        tdist.recv(head, src, group=g.process_group)
    code, ndim, *dims = head.tolist()
    shape, dtype = dims[:ndim], _DTYPES[code]
    buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
           else torch.empty(shape, dtype=dtype, device=dev))
    with _watched("recv", g, buf):
        tdist.recv(buf, src, group=g.process_group)
    if staged:
        buf = buf.to(dev, non_blocking=True)
    if tensor is None:
        return buf
    tensor.copy_(buf)
    return tensor


# -- over the current mesh's axis (the JAX module's in-jit helpers) ----------

def _axis_group(axis_name):
    from paddle_tpu_torch.distributed.mesh import get_mesh
    mesh = get_mesh()
    if mesh is None:
        raise ValueError(f"no current mesh for axis {axis_name!r}: enter "
                         "`with mesh:` or call set_mesh")
    return mesh.get_group(axis_name)


def psum(x, axis_name):
    """The sum of `x` over the current mesh's `axis_name`, out of place."""
    return all_reduce(_tensor(x).clone(), ReduceOp.SUM, _axis_group(axis_name))


def pmean(x, axis_name):
    return all_reduce(_tensor(x).clone(), ReduceOp.AVG, _axis_group(axis_name))


class P2PWork:
    """An in-flight `ppermute_start`. `wait()` waits for the transfer
    (on the card: orders the caller's stream after it) and returns what
    this rank's source sent, or zeros when nothing is sent to it; a
    second `wait()` returns the same tensor. `nbytes` is what this rank
    sent."""

    def __init__(self, out, works, host_out, keep, op, nbytes):
        self._out, self._works, self._host_out = out, works, host_out
        self._keep, self._op, self.nbytes = keep, op, nbytes

    def wait(self):
        if self._works is None:
            return self._out
        try:
            for w in self._works:
                w.wait()
        except BaseException:
            watchdog.end(self._op)
            raise
        if self._host_out is not None:
            self._out.copy_(self._host_out, non_blocking=True)
        self._works = self._keep = self._host_out = None
        watchdog.complete_when_ready(self._op, (self._out,))
        return self._out


def ppermute_start(x, axis_name, perm, group=None):
    """Post `ppermute(x, axis_name, perm)` and return its `P2PWork`
    without waiting for the transfer. `group` (a collective.Group) stands
    for the current mesh's `axis_name` group when given."""
    g = group if group is not None else _axis_group(axis_name)
    x = _tensor(x).contiguous()
    out = torch.zeros_like(x)
    me = g.rank
    staged = _staged(g, x.device)
    send_to = [d for s, d in perm if s == me and d != me]
    recv_from = [s for s, d in perm if d == me and s != me]
    src = x if not (staged and send_to) else _to_host(x)
    host_out = _host_buffer(x) if staged and recv_from else None
    if host_out is not None:
        host_out.zero_()
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(tdist.P2POp(tdist.isend, src, g.ranks[d],
                                   g.process_group))
        elif d == me:
            ops.append(tdist.P2POp(
                tdist.irecv, out if host_out is None else host_out,
                g.ranks[s], g.process_group))
    op = watchdog.begin(f"collective/ppermute ranks={g.ranks}", g.timeout_ms)
    try:
        if chaos.ENABLED:
            chaos.maybe_delay("collective.dispatch/ppermute")
        works = tdist.batch_isend_irecv(ops) if ops else []
    except BaseException:
        watchdog.end(op)
        raise
    return P2PWork(out, works, host_out, src, op,
                   len(send_to) * x.numel() * x.element_size())


def ppermute(x, axis_name, perm):
    """`perm` = [(source index, destination index)] along `axis_name`:
    this rank's `x` goes to its destinations; it returns what its source
    sent, or zeros when nothing is sent to it (jax.lax.ppermute)."""
    return ppermute_start(x, axis_name, perm).wait()


class _Hops:
    """Point-to-point transfers posted together by `_p2p_start`."""

    def __init__(self, works, n_sends, outs, keep, op):
        # one work an op (gloo): the receives' are the last; one for the
        # whole batch (a coalescing backend): every wait waits for it
        split = len(works) == n_sends + len(outs)
        self._recv_works = works[n_sends:] if split else works
        self._send_works = works[:n_sends] if split else []
        self._outs, self._keep, self._op = outs, keep, op
        self._done = False

    def wait(self, timeout=None):
        """Wait for the receives, each for at most `timeout` seconds
        (None: the backend's own), and return the received tensors in
        the order of `recvs`, on their devices; a second call returns
        them again."""
        self._wait(self._recv_works, timeout)
        self._recv_works = []
        if not self._done:
            self._outs = [buf if dev is None
                          else buf.to(dev, non_blocking=True)
                          for buf, dev in self._outs]
            self._done = True
        return self._outs

    def wait_all(self, timeout=None):
        """Wait for every transfer, the sends too (their buffers are
        kept until then); returns the received tensors."""
        outs = self.wait(timeout)
        if self._keep is not None:
            self._wait(self._send_works, timeout)
            self._send_works = self._keep = None
            watchdog.complete_when_ready(self._op, outs)
        return outs

    def _wait(self, works, timeout):
        kw = {} if timeout is None else {
            "timeout": datetime.timedelta(seconds=float(timeout))}
        try:
            for w in works:
                w.wait(**kw)
        except BaseException:
            watchdog.end(self._op)
            raise


def _p2p_start(sends, recvs, group):
    """Post point-to-point sends and receives over `group` together and
    return their `_Hops` without waiting (Megatron's `batch_isend_irecv`
    pairing: a send forward and a receive backward posted at once cannot
    block each other). `sends`: [(tensor, group rank, tag)]; `recvs`:
    [(shape, dtype, device, group rank, tag)], the shapes known to both
    sides, so no header crosses. A CUDA tensor on a gloo group is staged
    through pinned host buffers, as `ppermute_start` stages it. The
    caller waits for the receives (`wait`) before it reads them, and for
    the sends (`wait_all`) before it depends on their peers having
    them."""
    g = group
    ops, keep, outs = [], [], []
    for t, dst, tag in sends:
        t = _tensor(t).contiguous()
        wire = _to_host(t) if _staged(g, t.device) else t
        keep.append(wire)
        ops.append(tdist.P2POp(tdist.isend, wire, g.ranks[dst],
                               g.process_group, tag))
    for shape, dtype, dev, src, tag in recvs:
        staged = _staged(g, dev)
        buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
               else torch.empty(shape, dtype=dtype, device=dev))
        outs.append((buf, dev if staged else None))
        ops.append(tdist.P2POp(tdist.irecv, buf, g.ranks[src],
                               g.process_group, tag))
    # registered and delayed as `ppermute`'s: its hops are a permutation's
    op = watchdog.begin(f"collective/ppermute ranks={g.ranks}",
                        g.timeout_ms)
    try:
        if chaos.ENABLED:
            chaos.maybe_delay("collective.dispatch/ppermute")
        works = tdist.batch_isend_irecv(ops) if ops else []
    except BaseException:
        watchdog.end(op)
        raise
    return _Hops(works, len(keep), outs, keep, op)
