"""Continuous-batching paged-KV serving engine, in PyTorch.

Counterpart of the core of paddle_tpu/inference/paged.py:

- KV pages live in per-layer device pools (num_pages + 1, kv_heads,
  page_size, head_dim); block tables are int32 device tensors. Page 0 is
  the trash page: unallocated block-table entries point at it and it is
  only ever read (masked), never written. The extra last page is the
  sink that dropped writes land in; no block table points at it.
- Scheduling (admission, page allocation, retirement) is host-side
  Python between ticks; a request can join at any tick boundary, i.e.
  mid-decode of every other request.
- Admission is reservation-based: a request is admitted only when its
  worst-case page need fits the unreserved pool, so decode never runs
  out of pages; pages are still allocated lazily, tick by tick.
- A decode tick runs `steps_per_tick` steps over every slot as one
  program, as the JAX engine's `_tick_fn` does: one body
  (`_tick_body`) reads the slots' state from static device buffers the
  engine allocates once, and writes the (b, n) tokens and final lengths
  to a static output buffer. On the card the body is warmed up once and
  captured into a CUDA graph per sampling variant (`_programs[("tick",
  any_sample)]`), and each tick is one copy of pinned host staging into
  the input buffers, one replay and one copy of the outputs back. A
  capture or replay that fails raises; there is no retreat to an eager
  tick. On the CPU the same body runs eagerly over the same buffers.
- The kernel wrappers count their launches on the host, which a replay
  does not run: the engine takes a capture's counts back out and adds
  them once per replay, and counts the warm-up tick's real launches
  (`stats["warmup_ticks"]`).
- Prefill attention is the plain `_attend_pages`; decode attention
  (s == 1) goes through `kernels.paged_attention.paged_decode_attention`
  (the CUDA kernel on the card, its plain twin on the CPU).
- The pools are updated in place (`index_put_`), where the JAX engine
  returns new pools from a functional update and donates the old ones.
- `kv_dtype="int8"`: int8 pools with per-page-per-head f32 scales,
  quantized at scatter time as the JAX engine does (scales only grow;
  a touched page's earlier codes are rescaled to the new scale) and
  dequantized inside the attend; a page's scales are zeroed when it
  returns to the free list.
- Serving: `start()` runs the scheduler on a background thread until
  `stop()`; `stream()` yields generated tokens row by row and cancels
  its requests when the iterator closes; a request handle can be
  cancelled, streamed (`stream_tokens`) and waited on (`result`, with
  a stall guard that raises when nothing drives the engine).

Not in this slice (ROADMAP.md lists them): prefix cache, host tier,
disaggregated roles, tenancy, deadlines and overload shedding,
sessions, speculative decode, chunked prefill and observability.
"""
from __future__ import annotations

import functools
import math
import queue
import threading
import time
import warnings
import weakref
from typing import NamedTuple

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.kernels import launch_counters
from paddle_tpu_torch.kernels.paged_attention import (check_decode_shapes,
                                                      gather_window,
                                                      paged_decode_attention)

__all__ = ["PagedState", "paged_attention_update", "PagedKVEngine"]


class PagedState(NamedTuple):
    """Per-call paged-cache coordinates, passed through the model's
    forward as `cache_index`.

    block_tables: (b, max_pages) int32 — logical page j of slot i lives
        in physical page block_tables[i, j].
    lens: (b,) int32 — tokens already committed to the cache per slot.
    n_valid: (b,) int32 — how many of this call's s new tokens are real
        per slot (prefill: the unpadded prompt length; decode: 1 for live
        slots, 0 for finished or empty ones). Writes of the other rows
        are dropped into the pools' sink page.
    """
    block_tables: torch.Tensor
    lens: torch.Tensor
    n_valid: torch.Tensor


def _scatter_kv(kp, vp, k, v, state: PagedState, k_scale=None,
                v_scale=None):
    """Write this call's (b, s, hk, d) k/v into their pages, in place.

    Each pool holds one page more than block tables address: its last
    page is the sink. Rows past n_valid are written there, where no
    block table points, so they are dropped as the JAX engine drops
    them (`mode="drop"` past the pool) by one unconditional index_put_,
    with no host sync. They never reach page 0, which a caller's block
    table may legitimately hold.

    int8 pools (k_scale / v_scale (num_pages + 1, hk) f32 given) quantize
    here, as the JAX engine's `_scatter_kv` does, in the same expression
    order so the codes agree bit for bit: the touched pages' scales grow
    by a scatter-max of max|token| / 127, their earlier codes are
    rescaled by old / new scale in one gather -> round -> clip -> scatter
    pass, and the new tokens quantize with the final scale.
    """
    bt, lens, n_valid = state
    b, s, hk, d = k.shape
    sink, page_size = kp.shape[0] - 1, kp.shape[2]
    steps = torch.arange(s, dtype=torch.int32, device=k.device)
    pos = lens[:, None] + steps[None, :]                        # (b, s)
    logical = (pos // page_size).clamp(0, bt.shape[1] - 1)
    phys = torch.gather(bt, 1, logical.long())
    phys = torch.where(steps[None, :] < n_valid[:, None], phys, sink)
    phys = phys.reshape(-1).long()
    off = (pos % page_size).reshape(-1).long()
    if k_scale is None:
        kp[phys, :, off] = k.reshape(b * s, hk, d).to(kp.dtype)
        vp[phys, :, off] = v.reshape(b * s, hk, d).to(vp.dtype)
        return
    pools, planes = _pair(kp, vp), _pair(k_scale, v_scale)
    if pools is not None and planes is not None:
        # one pass for both pools: half the launches of a host-bound tick
        _quant_scatter(pools, planes, torch.stack([k, v]).reshape(
            2, b * s, hk, d), phys, off)
        return
    for pool, plane, toks in ((kp, k_scale, k), (vp, v_scale, v)):
        _quant_scatter(pool[None], plane[None],
                       toks.reshape(1, b * s, hk, d), phys, off)


def _pair(a, b):
    """a and b as one (2, ...) view when b directly follows a in one
    buffer (the engine allocates each layer's k and v pools, and their
    scale planes, that way); else None."""
    if (a.shape == b.shape and a.dtype == b.dtype and a.is_contiguous()
            and b.is_contiguous()
            and a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr()
            and b.storage_offset() == a.storage_offset() + a.numel()):
        return a.as_strided((2,) + tuple(a.shape), (a.numel(),) + a.stride(),
                            a.storage_offset())
    return None


def _quant_scatter(pools, planes, toks, phys, off):
    """G int8 pools (G, P, hk, ps, d) and their scale planes (G, P, hk),
    in place (`_scatter_kv`): toks (G, n, hk, d) go to rows (phys, :,
    off) of each. Rows of one page all compute the same rescaled page,
    so repeated indices write equal values."""
    g, n, hk = toks.shape[:3]
    toks = toks.float()
    cand = toks.abs().amax(dim=-1) / 127.0                   # (G, n, hk)
    old_g = planes[:, phys]
    planes.scatter_reduce_(1, phys[None, :, None].expand(g, n, hk), cand,
                           "amax")
    new_g = planes[:, phys]
    den = new_g.clamp_min(1e-30)
    ratio = torch.where(new_g > 0, old_g / den, 0.0)
    # int8 codes times the f32 ratio compute in f32, as .float() * ratio
    pages = (pools[:, phys] * ratio[..., None, None]).round()
    pools[:, phys] = pages.clamp(-127, 127).to(torch.int8)
    qtok = (toks / den[..., None]).round().clamp(-127, 127)
    sel = torch.arange(g, device=toks.device)[:, None]
    pools[sel, phys[None], :, off[None]] = qtok.to(torch.int8)


def _attend_pages(q, kp, vp, state: PagedState, k_scale=None,
                  v_scale=None):
    """Plain attend over each slot's paged window: gather in f32
    (dequantized for int8 pools), mask with -1e9, softmax, GQA by reshape
    (the window is never repeated per query head). q: (b, s, hq, d).
    Returns (b, s, hq*d) in q's type.

    The (b, hk, g, s, L) f32 scores live only for this layer's call."""
    bt, lens = state.block_tables.long(), state.lens.long()
    b, s, hq, d = q.shape
    hk = kp.shape[1]
    g = hq // hk
    pos = lens[:, None] + torch.arange(s, device=q.device)[None, :]
    # window column c IS logical position c, so the causal bound is c <= pos
    ks = gather_window(kp, k_scale, bt)
    vs = gather_window(vp, v_scale, bt)
    L = ks.shape[2]
    qg = q.transpose(1, 2).float().reshape(b, hk, g, s, d)
    scores = torch.einsum("bhgsd,bhcd->bhgsc", qg, ks) / math.sqrt(d)
    visible = torch.arange(L, device=q.device)[None, None, :] \
        <= pos[:, :, None]                                       # (b, s, L)
    scores.masked_fill_(~visible[:, None, None], -1e9)
    p = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bhgsc,bhcd->bhgsd", p, vs).reshape(b, hq, s, d)
    return out.transpose(1, 2).reshape(b, s, hq * d).to(q.dtype)


def paged_attention_update(q, k, v, cache, state: PagedState):
    """Write this call's k/v into the slots' pages, then attend over each
    slot's whole paged window. Prefill is s = prompt tokens, decode is
    s = 1 (the decode kernel).

    q: (b, s, hq, d), k/v: (b, s, hk, d), already position-encoded.
    cache: (k_pool, v_pool), each (num_pages + 1, hk, page_size, d), or
    for int8 KV (k_pool, v_pool, k_scale, v_scale) with int8 pools and
    (num_pages + 1, hk) f32 scale planes; updated in place. The last page
    is the sink for dropped writes and no block table may name it.
    Returns (b, s, hq*d) in q's type.
    """
    if len(cache) not in (2, 4):
        raise ValueError("cache must be (k_pool, v_pool) or, for int8 KV, "
                         "(k_pool, v_pool, k_scale, v_scale)")
    kp, vp = cache[0], cache[1]
    k_scale, v_scale = cache[2:] if len(cache) == 4 else (None, None)
    if kp.dtype == torch.int8 and k_scale is None:
        raise ValueError(
            "int8 k/v pools need a 4-tuple cache (k_pool, v_pool, k_scale, "
            "v_scale); got a 2-tuple (see PagedKVEngine(kv_dtype='int8'))")
    b, s, hq, d = q.shape
    _scatter_kv(kp, vp, k, v, state, k_scale, v_scale)
    if s == 1:
        # the query position is lens (this token's k/v just landed
        # there); the kernel attends cols <= lens and skips later pages
        out = paged_decode_attention(q[:, 0], kp, vp, state.block_tables,
                                     state.lens, k_scale=k_scale,
                                     v_scale=v_scale)
        return out.to(q.dtype).reshape(b, 1, hq * d)
    return _attend_pages(q, kp, vp, state, k_scale, v_scale)


def _np_process_logits(logits, temperature, top_k, top_p):
    """numpy temperature / top-k / top-p filter (a copy of the JAX
    package's models/generation.py `_np_process_logits`)."""
    x = np.asarray(logits, "float32")
    if temperature != 1.0:
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        x = x / float(temperature)
    v = x.shape[-1]
    if top_k and 0 < top_k < v:
        kth = np.sort(x, axis=-1)[:, -top_k][:, None]
        x = np.where(x < kth, -1e9, x)
    if top_p < 1.0:
        s = np.sort(x, axis=-1)[:, ::-1]
        e = np.exp(s - s.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        cum = np.cumsum(probs, axis=-1)
        keep = cum - probs < top_p
        masked = np.where(keep, s, np.inf)
        thresh = masked.min(-1, keepdims=True)
        x = np.where(x < thresh, -1e9, x)
    return x


def _process_logits_rowwise(x, temp, topk, topp):
    """Row-wise temperature / top-k / top-p with per-slot parameters
    (b,): filters disable themselves per row (top_k <= 0 or >= v,
    top_p >= 1). One sort serves both filters."""
    x = x.float() / temp[:, None]
    v = x.shape[-1]
    sd = torch.sort(x, dim=-1, descending=True).values
    kk = topk.long().clamp(1, v)
    kth = torch.gather(sd, 1, (kk - 1)[:, None])                  # (b, 1)
    use_k = (topk > 0) & (topk < v)
    kth = torch.where(use_k[:, None], kth, float("-inf"))
    x = torch.where(x < kth, -1e9, x)
    sp = torch.where(sd < kth, -1e9, sd)
    probs = torch.softmax(sp, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < topp[:, None]
    thresh = torch.where(keep, sp, float("inf")).min(dim=-1,
                                                     keepdim=True).values
    thresh = torch.where((topp < 1.0)[:, None], thresh, float("-inf"))
    return torch.where(x < thresh, -1e9, x)


class _Request:
    """One generation request: the engine's record and the caller's
    handle (thread-safe: tokens stream through a queue)."""

    def __init__(self, ids, max_new_tokens, eos_token_id, do_sample,
                 temperature, top_k, top_p, pages_needed, sample_index,
                 engine=None):
        self.prompt = np.asarray(ids, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = -1 if eos_token_id is None else int(eos_token_id)
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.pages_needed = pages_needed
        # engine-local submission index: the first sampled token derives
        # from (engine seed, this index)
        self.sample_index = sample_index
        # weak, so an abandoned handle does not keep the engine (and its
        # KV pools) alive; result() reads it for its stall guard
        self._engine = weakref.ref(engine) if engine is not None else None
        self.tokens: list[int] = []
        self.queue: queue.Queue = queue.Queue()   # token lists, then None
        self.done = threading.Event()
        self.cancelled = threading.Event()
        self.error = None

    def cancel(self):
        """Abandon the request: the engine retires its slot (returning
        its pages and reservation) at the next tick boundary."""
        self.cancelled.set()

    def stream_tokens(self):
        """Yield accepted token ids one at a time as they are produced;
        raises the engine's error if the request failed."""
        while True:
            item = self.queue.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield from item

    def result(self, stall_timeout=60.0):
        """Block until finished; return the generated tokens.

        Stall guard: submit() does not start the background ticker (only
        stream() does). If the request is unfinished and nothing drives
        the engine (no live ticker, no step() in flight, no new step()
        call) for `stall_timeout` seconds, raise, naming the fix,
        instead of blocking forever."""
        eng_ref = self._engine
        last_seq = None
        last_t = time.monotonic()
        while not self.done.wait(min(0.5, stall_timeout / 4)):
            if eng_ref is None:
                continue
            eng = eng_ref()
            if eng is None:
                if self.done.is_set():
                    break
                raise RuntimeError(
                    "result(): the engine owning this request was garbage-"
                    "collected before the request finished; keep the "
                    "PagedKVEngine alive and drive it (start() or "
                    "run_until_idle()) until result() returns")
            ticker, seq = eng._ticker, eng._step_seq
            progressing = ((ticker is not None and ticker.is_alive())
                           or eng._in_step or seq != last_seq)
            del eng, ticker     # do not pin the engine across the wait
            if progressing:
                last_seq, last_t = seq, time.monotonic()
                continue
            if time.monotonic() - last_t > stall_timeout:
                if self.done.is_set():
                    break
                raise RuntimeError(
                    "result(): request unfinished and no scheduler is "
                    "driving the engine (no ticker thread, no step() "
                    f"progress for {stall_timeout:.1f}s); call "
                    "engine.start() for background serving or "
                    "engine.run_until_idle() after submit(); submit() "
                    "does not start the ticker (stream() does)")
        if self.error is not None:
            raise self.error
        return list(self.tokens)


class _Slot:
    __slots__ = ("req", "lens", "tok", "pages", "emitted")

    def __init__(self, req, lens, tok):
        self.req = req
        self.lens = int(lens)       # tokens committed to the paged cache
        self.tok = int(tok)         # next decode input (last emitted)
        self.pages: list[int] = []  # physical pages in block-table order
        self.emitted = 0            # generated tokens accepted so far


# the tick program's per-slot inputs: name -> (type, an idle slot's value)
_TICK_INPUTS = {"tok": (torch.int32, 0), "lens": (torch.int32, 0),
                "active": (torch.bool, False), "limit": (torch.int32, 0),
                "eos": (torch.int32, -1), "temp": (torch.float32, 1.0),
                "topk": (torch.int32, 0), "topp": (torch.float32, 1.0),
                "wants": (torch.bool, False)}


class _CapturedTick:
    """One sampling variant of the tick program as a CUDA graph. A replay
    runs none of the wrappers that count launches, so it adds the counts
    its capture took (`delta`: (counter, name, launches) triples)."""

    def __init__(self, graph, delta):
        self.graph = graph
        self.delta = delta

    def __call__(self):
        self.graph.replay()
        for counter, name, n in self.delta:
            counter[name] += n


class PagedKVEngine:
    """Continuous-batching scheduler over paged KV pools (module doc).

    model: a port LlamaForCausalLM (its attention takes PagedState cache
        coordinates), on `device`.
    max_slots: decode batch width.
    page_size / num_pages: pool geometry; page 0 is the trash page, so
        num_pages - 1 pages are allocatable (each pool also holds one
        sink page past them, for dropped writes).
    max_pages_per_slot: block-table width; bounds prompt + generation
        per request at max_pages_per_slot * page_size tokens.
    steps_per_tick: decode steps per tick (admission granularity, and
        one host sync per tick).
    kv_dtype: None keeps the model's parameter type for the pools;
        "bf16" stores bf16 pools; "int8" stores int8 pools with f32
        (num_pages + 1, kv_heads) scale planes per layer, about half the
        KV bytes of bf16 (`kv_bytes_per_slot`).
    device: where the engine runs (default the CUDA card; "cpu" must be
        asked for) — the model must live there.
    """

    def __init__(self, model, *, max_slots=4, page_size=16, num_pages=64,
                 max_pages_per_slot=None, steps_per_tick=4, seed=0,
                 kv_dtype=None, device="cuda"):
        dev = resolve_device(device)
        mdev = model.device
        if dev.type != mdev.type or (dev.index is not None
                                     and dev.index != mdev.index):
            raise ValueError(f"model lives on {mdev}, engine asked for "
                             f"{dev}")
        self.device = mdev
        cfg = model.config
        self.model = model
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages_per_slot = int(
            max_pages_per_slot
            or min(num_pages - 1, max(1, (num_pages - 1) // max_slots)))
        self.steps_per_tick = int(steps_per_tick)
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"kv_dtype must be None, 'bf16' or 'int8' "
                             f"(got {kv_dtype!r})")
        self.kv_dtype = kv_dtype
        pool_dtype = {None: model.dtype, "bf16": torch.bfloat16,
                      "int8": torch.int8}[kv_dtype]
        n_kv, hd = cfg.num_key_value_heads, cfg.head_dim
        n_layers = cfg.num_hidden_layers
        if mdev.type == "cuda":      # the CPU twin takes any geometry
            check_decode_shapes(cfg.num_attention_heads, n_kv, hd,
                                self.page_size, pool_dtype)
        shape = (self.num_pages + 1, n_kv, self.page_size, hd)   # + sink
        # a layer's k and v pools are the two halves of one buffer: int8
        # KV quantizes both in one pass (_scatter_kv)
        pools = [tuple(torch.zeros((2,) + shape, dtype=pool_dtype,
                                   device=mdev))
                 for _ in range(n_layers)]
        # int8: every layer's k and v scale planes are views of one
        # tensor, so freed pages' scales reset in one launch (_retire)
        self._scales = None
        if kv_dtype == "int8":
            self._scales = torch.zeros((n_layers, 2, self.num_pages + 1,
                                        n_kv), dtype=torch.float32,
                                       device=mdev)
            pools = [(kp, vp, self._scales[i, 0], self._scales[i, 1])
                     for i, (kp, vp) in enumerate(pools)]
        self.pools = pools
        self._free = list(range(self.num_pages - 1, 0, -1))   # 0 = trash
        # pages promised to admitted slots but not yet popped from the
        # free list; admission headroom = len(_free) - _reserved_unalloc
        self._reserved_unalloc = 0
        self._slots: list[_Slot | None] = [None] * self.max_slots
        self._bt = np.zeros((self.max_slots, self.max_pages_per_slot),
                            np.int32)
        # the tick program's static buffers: inputs filled before each
        # tick from pinned host staging, the (b, n) tokens and final lens
        # written back (`_tick_body`)
        b = self.max_slots
        shapes = {k: ((b,), dt) for k, (dt, _) in _TICK_INPUTS.items()}
        shapes["bt"] = (self._bt.shape, torch.int32)
        pin = mdev.type == "cuda"
        self._staging = {k: torch.zeros(sh, dtype=dt, pin_memory=pin)
                         for k, (sh, dt) in shapes.items()}
        self._inputs = {k: torch.zeros(sh, dtype=dt, device=mdev)
                        for k, (sh, dt) in shapes.items()}
        self._outputs = torch.zeros((b, self.steps_per_tick + 1),
                                    dtype=torch.int32, device=mdev)
        self._programs = {}        # ("tick", any_sample) -> _CapturedTick
        self._graph_pool = None    # one memory pool for every variant
        self._pending: list[_Request] = []
        self._seed = int(seed)
        self._submitted = 0
        self._gen = torch.Generator(device=mdev).manual_seed(self._seed)
        # guards _pending, _submitted and _inflight
        self._lock = threading.Lock()
        # requests submitted and not yet retired or dropped: has_work()
        # cannot read idle while _admit holds a popped queue
        self._inflight = 0
        self._step_seq = 0      # step() calls ever made, and whether one
        self._in_step = False   # is in flight: result()'s stall guard
        self._ticker = None
        self._stop_flag = False
        self.stats = {"ticks": 0, "prefills": 0, "prefill_calls": 0,
                      "tokens_out": 0,
                      "admitted": 0, "finished": 0, "cancelled": 0,
                      "prefill_s": 0.0, "tick_s": 0.0, "prefill_tokens": 0,
                      "decode_tokens": 0, "warmup_ticks": 0,
                      "warmup_s": 0.0}

    def kv_bytes_per_slot(self):
        """Device bytes one fully grown slot pins across every layer's KV
        pools (and, for int8 KV, their scale rows), from the real buffer
        types."""
        per_page = sum(t[0].numel() * t.element_size()
                       for grp in self.pools for t in grp)
        return per_page * self.max_pages_per_slot

    # -- submission ------------------------------------------------------
    def admission_headroom(self):
        """Pages not promised to any admitted slot."""
        return len(self._free) - self._reserved_unalloc

    def submit(self, ids, max_new_tokens=32, *, eos_token_id=None,
               do_sample=False, temperature=1.0, top_k=0,
               top_p=1.0) -> _Request:
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("prompt must hold at least one token")
        total = ids.size + int(max_new_tokens)
        pages = -(-total // self.page_size)
        if pages > self.max_pages_per_slot:
            raise ValueError(
                f"request needs {pages} pages (prompt {ids.size} + "
                f"max_new {max_new_tokens}) > max_pages_per_slot "
                f"{self.max_pages_per_slot}")
        if pages > self.num_pages - 1:
            raise ValueError(f"request needs {pages} pages > pool size "
                             f"{self.num_pages - 1}")
        with self._lock:
            req = _Request(ids, max_new_tokens, eos_token_id, do_sample,
                           temperature, top_k, top_p, pages,
                           self._submitted, engine=self)
            self._submitted += 1
            self._inflight += 1
            self._pending.append(req)
        return req

    def has_work(self):
        with self._lock:
            return self._inflight > 0

    # -- scheduling core -------------------------------------------------
    @staticmethod
    def _bucket(n):
        return max(8, 1 << (n - 1).bit_length())

    def _alloc_pages(self, slot_idx, need_total):
        """Grow the slot's allocation to `need_total` pages (lazy; the
        reservation made at admission guarantees the free list covers
        it)."""
        slot = self._slots[slot_idx]
        while len(slot.pages) < need_total:
            if not self._free:
                raise RuntimeError(
                    "page pool exhausted despite reservation: free=0 "
                    f"reserved={self._reserved_unalloc}")
            page = self._free.pop()
            self._reserved_unalloc -= 1
            self._bt[slot_idx, len(slot.pages)] = page
            slot.pages.append(page)

    def _admit(self):
        with self._lock:
            pending, self._pending = self._pending, []
        requeue = []
        admitted = []
        for req in pending:
            if req.cancelled.is_set():        # cancelled while queued
                self.stats["cancelled"] += 1
                with self._lock:
                    self._inflight -= 1
                req.queue.put(None)
                req.done.set()
                continue
            idx = next((i for i, s in enumerate(self._slots) if s is None),
                       None)
            if idx is None or req.pages_needed > self.admission_headroom():
                requeue.append(req)
                continue
            self._reserved_unalloc += req.pages_needed
            self._slots[idx] = _Slot(req, lens=0, tok=0)
            self._alloc_pages(idx, -(-req.prompt.size // self.page_size))
            self.stats["admitted"] += 1
            admitted.append((idx, req))
        # back in the queue before any prefill runs: a prefill that
        # raises leaves every waiter where the ticker's failure path
        # finds it
        with self._lock:
            self._pending = requeue + self._pending
        # same-bucket prompts prefill together in one batched call
        groups = {}
        for idx, req in admitted:
            groups.setdefault(self._bucket(req.prompt.size),
                              []).append((idx, req))
        for grp in groups.values():
            self._prefill_group(grp)
        return len(admitted)

    def _first_token(self, logits, req):
        """A request's first token from its prefill logits, host-side,
        seeded from (engine seed, submission index) as the JAX engine
        does, so both engines pick the same first sampled token."""
        if req.do_sample:
            rng = np.random.default_rng(
                np.random.SeedSequence([self._seed, req.sample_index]))
            x = _np_process_logits(logits[None, :], req.temperature,
                                   req.top_k, req.top_p)[0]
            u = rng.uniform(1e-9, 1.0, size=x.shape).astype(np.float32)
            return int(np.argmax(x - np.log(-np.log(u))))
        return int(np.argmax(logits))

    def _prefill_group(self, grp):
        """Prefill every (slot, request) pair of one bucket in ONE model
        call. Eager PyTorch compiles nothing per shape, so the batch is
        padded only to its longest prompt (rows past n_valid drop their
        writes), not to the bucket."""
        t0 = time.perf_counter()
        bw = len(grp)
        plen = max(int(req.prompt.size) for _, req in grp)
        ids = np.zeros((bw, plen), np.int32)
        nv = np.zeros(bw, np.int32)
        bt = np.zeros((bw, self.max_pages_per_slot), np.int32)
        for row, (idx, req) in enumerate(grp):
            ids[row, :req.prompt.size] = req.prompt
            nv[row] = req.prompt.size
            bt[row] = self._bt[idx]
        dev = self.device
        nv_t = torch.from_numpy(nv).to(dev)
        state = PagedState(torch.from_numpy(bt).to(dev),
                           torch.zeros(bw, dtype=torch.int32, device=dev),
                           nv_t)
        pos = torch.arange(plen, dtype=torch.int32,
                           device=dev)[None, :].expand(bw, plen)
        h = self.model.model(torch.from_numpy(ids).to(dev), pos,
                             self.pools, state)
        # lm_head over each row's last real position only: the full
        # (bw, plen, vocab) logits are never formed
        last = h[torch.arange(bw, device=dev), nv_t.long() - 1]
        logits_np = self.model.logits(last).float().cpu().numpy()
        self.stats["prefills"] += bw
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += int(nv.sum())
        self.stats["prefill_s"] += time.perf_counter() - t0
        for row, (idx, req) in enumerate(grp):
            slot = self._slots[idx]
            slot.lens = int(req.prompt.size)
            slot.tok = self._first_token(logits_np[row], req)
            self._accept(idx, [slot.tok])

    def _accept(self, slot_idx, toks):
        """Feed accepted tokens to the request; retire the slot when the
        request is finished. Returns True if the slot stays live."""
        slot = self._slots[slot_idx]
        req = slot.req
        out = []
        finished = False
        for t in toks:
            out.append(int(t))
            slot.emitted += 1
            if (req.eos_token_id >= 0 and int(t) == req.eos_token_id) \
                    or slot.emitted >= req.max_new_tokens:
                finished = True
                break
        req.tokens.extend(out)
        self.stats["tokens_out"] += len(out)
        if out:
            req.queue.put(out)
        if finished:
            self._retire(slot_idx)
        return not finished

    def _retire(self, slot_idx, reason=None):
        """Return the slot's pages and the rest of its reservation, and
        wake its waiter. `reason` names an abnormal end ("error"); a
        request that finished (no reason, not cancelled) counts in
        stats["finished"]."""
        slot = self._slots[slot_idx]
        req = slot.req
        self._free.extend(reversed(slot.pages))
        # release the unallocated remainder of this slot's reservation
        self._reserved_unalloc -= req.pages_needed - len(slot.pages)
        self._bt[slot_idx, :] = 0
        self._slots[slot_idx] = None
        with self._lock:
            self._inflight -= 1
        if reason is None and not req.cancelled.is_set():
            self.stats["finished"] += 1
        try:
            if self._scales is not None and slot.pages:
                # scales only grow at scatter time: a recycled page
                # keeping its old scale would quantize its next request's
                # k/v on the largest magnitude any earlier request wrote
                # (JAX `_recycle_pages`). Between ticks, outside the graph
                idx = torch.tensor(slot.pages, device=self.device)
                self._scales[:, :, idx] = 0.0
        finally:
            req.queue.put(None)
            req.done.set()

    def _retire_each(self, idxs, reason=None):
        """Retire every slot of `idxs`, all of them even when one
        raises (int8's scale reset touches the device, which a sticky
        CUDA error fails), then re-raise the first error."""
        first = None
        for i in idxs:
            try:
                self._retire(i, reason)
            except Exception as e:      # noqa: BLE001 — retire the rest
                first = e if first is None else first
        if first is not None:
            raise first

    def _slot_arrays(self, live):
        """The live slots' state written into the tick's pinned host
        staging; returns numpy views of it."""
        arrs = {k: t.numpy() for k, t in self._staging.items()}
        for k, (_, idle) in _TICK_INPUTS.items():
            arrs[k].fill(idle)
        arrs["bt"][:] = self._bt
        for i in live:
            slot = self._slots[i]
            arrs["tok"][i] = slot.tok
            arrs["lens"][i] = slot.lens
            arrs["active"][i] = True
            arrs["limit"][i] = slot.req.max_new_tokens - slot.emitted
            arrs["eos"][i] = slot.req.eos_token_id
            arrs["temp"][i] = slot.req.temperature
            arrs["topk"][i] = slot.req.top_k
            arrs["topp"][i] = slot.req.top_p
            arrs["wants"][i] = slot.req.do_sample
        return arrs

    # -- the tick program ------------------------------------------------
    @torch.no_grad()
    def _tick_body(self, any_sample):
        """The tick program (JAX `_tick_fn`): `steps_per_tick` decode
        steps over every slot, from the static input buffers to the
        static output buffer ((b, n) tokens, then the final lens). It
        reads nothing back to the host — the finish mask stays on the
        device — so a CUDA graph can capture it."""
        x = self._inputs
        tok, lens, active = x["tok"], x["lens"], x["active"]
        limit, eos, bt = x["limit"], x["eos"], x["bt"]
        fin = ~active
        cnt = torch.zeros_like(lens)
        outs = []
        for _ in range(self.steps_per_tick):
            live = active & ~fin
            live_i = live.to(torch.int32)
            h = self.model.model(tok[:, None], lens[:, None], self.pools,
                                 PagedState(bt, lens, live_i))
            last = self.model.logits(h[:, -1])
            nxt = last.argmax(dim=-1).to(torch.int32)
            if any_sample:
                u = torch.rand(last.shape, generator=self._gen,
                               device=last.device)
                gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
                proc = _process_logits_rowwise(last, x["temp"], x["topk"],
                                               x["topp"])
                sampled = (proc + gumbel).argmax(dim=-1).to(torch.int32)
                nxt = torch.where(x["wants"], sampled, nxt)
            nxt = torch.where(live, nxt, 0)
            lens = lens + live_i
            cnt = cnt + live_i
            hit_eos = live & (eos >= 0) & (nxt == eos)
            fin = fin | hit_eos | (cnt >= limit)
            tok = nxt
            outs.append(nxt)
        torch.stack(outs + [lens], dim=1, out=self._outputs)

    def _eager_program(self, any_sample):
        """The tick body run eagerly: the CPU's program, and on the card
        the yardstick the captured tick is held against."""
        return functools.partial(self._tick_body, any_sample)

    def _tick_program(self, any_sample):
        """The tick program for this sampling variant: on the card a CUDA
        graph captured at first use and cached under ("tick",
        any_sample), as the JAX engine keys its programs; on the CPU the
        body itself."""
        if self.device.type != "cuda":
            return self._eager_program(any_sample)
        key = ("tick", any_sample)
        if key not in self._programs:
            self._programs[key] = self._capture(any_sample)
        return self._programs[key]

    def _idle_inputs(self):
        """Every slot idle in the tick's input buffers: a run of the
        program then writes KV only into the pools' sink page."""
        for k, (_, idle) in _TICK_INPUTS.items():
            self._inputs[k].fill_(idle)
        self._inputs["bt"].zero_()

    def _capture(self, any_sample):
        """Warm the tick body up once on a side stream, then capture it,
        both with every slot inactive: each KV write then lands in the
        pools' sink page and no live page is touched (int8 pools'
        quantize-at-scatter runs inside the graph). The warm-up's
        launches are real and stay counted; the capture's are taken
        back out and added again by every replay."""
        t0 = time.perf_counter()
        body = self._eager_program(any_sample)
        self._idle_inputs()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)
        self.stats["warmup_ticks"] += 1
        if self._graph_pool is None:
            # both variants share one pool: their replays never overlap
            # (one stream, one tick at a time) and no tensor made inside
            # a capture outlives it (the outputs go to `_outputs`)
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if any_sample:
            # each replay draws new Gumbel noise from the engine's
            # generator, as an eager tick would
            graph.register_generator_state(self._gen)
        counters = launch_counters()
        before = [dict(c) for c in counters]
        try:
            # thread_local: the ticker thread may be the one capturing
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  capture_error_mode="thread_local"):
                body()
        finally:
            delta = [(c, k, c[k] - b[k]) for c, b in
                     zip(counters, before) for k in c if c[k] != b[k]]
            for c, k, n in delta:
                c[k] -= n
        self.stats["warmup_s"] += time.perf_counter() - t0
        return _CapturedTick(graph, delta)

    def _accept_tick(self, live, out_np, counts, eos, lens_np):
        """Truncate by budget then eos, feed the request, advance slot
        state for survivors."""
        for i in live:
            slot = self._slots[i]
            emitted = list(out_np[i, :int(counts[i])])
            if eos[i] >= 0 and eos[i] in emitted:
                emitted = emitted[:emitted.index(eos[i]) + 1]
            self.stats["decode_tokens"] += len(emitted)
            if self._accept(i, emitted):
                slot.lens = int(lens_np[i])
                slot.tok = int(emitted[-1])

    def step(self):
        """One scheduler tick: retire cancelled requests, admit pending
        ones (prefill), then one run of the tick program over every live
        slot. Returns True if any work was done — an admission counts,
        even when every admitted request finished in its prefill and
        left nothing to decode."""
        self._step_seq += 1
        self._in_step = True     # a tick in flight counts as progress
        try:
            return self._step_tick()
        finally:
            self._in_step = False

    def _step_tick(self):
        gone = [i for i, s in enumerate(self._slots)
                if s is not None and s.req.cancelled.is_set()]
        self.stats["cancelled"] += len(gone)
        self._retire_each(gone)
        admitted = self._admit()
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if not live:
            return admitted > 0
        n = self.steps_per_tick
        for i in live:
            slot = self._slots[i]
            budget_tokens = slot.req.prompt.size + slot.req.max_new_tokens
            need = min(slot.lens + n, budget_tokens)
            self._alloc_pages(i, -(-need // self.page_size))
        a = self._slot_arrays(live)
        program = self._tick_program(bool(a["wants"].any()))
        t0 = time.perf_counter()
        for k, t in self._inputs.items():
            t.copy_(self._staging[k], non_blocking=True)
        program()
        back = self._outputs.to("cpu", copy=True).numpy()
        self.stats["ticks"] += 1
        self.stats["tick_s"] += time.perf_counter() - t0
        counts = np.minimum(a["limit"], n)
        self._accept_tick(live, back[:, :n], counts, a["eos"], back[:, n])
        return True

    def run_until_idle(self):
        """Drain every pending and active request. While the background
        ticker runs it owns the scheduler (stepping here too would race
        on pages and pools), so this waits for it to drain the work."""
        t = self._ticker
        if t is not None and t.is_alive():
            while t.is_alive() and self.has_work():
                time.sleep(0.005)
            if t.is_alive():
                return
            # the ticker ended (stop()) with work left: drive it here
        while self.has_work():
            if not self.step() and self._pending:
                raise RuntimeError(
                    "pending requests cannot be admitted: "
                    f"free={len(self._free)} "
                    f"reserved={self._reserved_unalloc}")

    def generate(self, prompts, max_new_tokens=32, **kw):
        """Submit all, drain, return token lists."""
        reqs = [self.submit(p, max_new_tokens, **kw) for p in prompts]
        self.run_until_idle()
        return [r.result() for r in reqs]

    # -- background ticker -----------------------------------------------
    def start(self):
        """Run the scheduler on a daemon thread until stop(). stream()
        starts it; submit() does not — pair submit() with start() or
        run_until_idle()."""
        with self._lock:
            if self._ticker is None or not self._ticker.is_alive():
                self._stop_flag = False
                self._ticker = threading.Thread(
                    target=self._ticker_loop, daemon=True,
                    name="PagedKVEngine-ticker")
                self._ticker.start()
        return self

    def stop(self):
        """Ask the ticker to end after its current tick and join it for
        at most 30 seconds."""
        self._stop_flag = True
        t = self._ticker
        if t is not None:
            t.join(timeout=30)

    def _ticker_loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        idle = 0.0
        while not self._stop_flag:
            try:
                if self.step():
                    idle = 0.0
                else:
                    idle = min(0.05, idle + 0.005)
                    time.sleep(idle)
            except Exception as e:      # noqa: BLE001 — fail all waiters
                self._fail_all(e)
                raise

    def _fail_all(self, error):
        """Fail every waiter with `error`: the queued requests, and the
        live ones, whose slots return their pages and reservations (a
        restarted ticker is not left short of capacity)."""
        with self._lock:
            doomed, self._pending = self._pending, []
            self._inflight -= len(doomed)       # dropped, not retired
        for req in doomed:
            req.error = error
            req.queue.put(None)
            req.done.set()
        live = [i for i, s in enumerate(self._slots) if s is not None]
        for i in live:
            self._slots[i].req.error = error
        self._retire_each(live, reason="error")

    def stream(self, input_ids, max_new_tokens=32, *, eos_token_id=None,
               pad_token_id=0, do_sample=False, temperature=1.0, top_k=0,
               top_p=1.0, attention_mask=None, seed=None, deadline=None,
               tenant=None, session=None, **_ignored):
        """Generate from a background ticker (started here), yielding
        one (rows,) int32 array per step: each row of `input_ids` (its
        `attention_mask` row selecting its tokens) is its own request in
        the continuous batch, and a finished row yields `pad_token_id`.
        Closing the iterator early cancels the requests, so the engine
        stops decoding for nobody."""
        for name, val in (("deadline", deadline), ("tenant", tenant),
                          ("session", session)):
            if val is not None:
                raise NotImplementedError(
                    f"stream(): {name}= is not ported yet (ROADMAP.md "
                    "queue 1 item 4: deadlines, tenancy, sessions)")
        if seed is not None and do_sample:
            warnings.warn(
                "PagedKVEngine ignores per-request seed: sampling noise in "
                "a continuous batch derives from the ENGINE seed and batch "
                "composition; construct the engine with seed= for "
                "reproducible replay", stacklevel=2)
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        if attention_mask is not None:
            m = np.asarray(attention_mask).astype(bool)
            rows = [ids[i][m[i]] for i in range(ids.shape[0])]
        else:
            rows = list(ids)
        self.start()
        reqs = []
        try:
            for r in rows:
                reqs.append(self.submit(
                    r, max_new_tokens, eos_token_id=eos_token_id,
                    do_sample=do_sample, temperature=temperature,
                    top_k=top_k, top_p=top_p))
        except BaseException:
            # a later row failed: the rows already submitted would decode
            # on for a caller that got an exception
            for r in reqs:
                r.cancel()
            raise
        streams = [r.stream_tokens() for r in reqs]
        try:
            for _ in range(int(max_new_tokens)):
                row = np.full(len(reqs), pad_token_id, np.int32)
                alive = False
                for j, it in enumerate(streams):
                    if it is None:
                        continue
                    try:
                        row[j] = next(it)
                        alive = True
                    except StopIteration:
                        streams[j] = None
                if not alive:
                    return
                yield row
        finally:
            for r in reqs:
                r.cancel()          # no-op if already finished
