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
- Prefix cache (`prefix_cache_pages=N`): full prompt pages are keyed by
  the hash chain of inference/prefix.py and REFCOUNTED across the slots
  that share them, so a warm submit points its leading block-table
  entries at cached pages and prefills only the uncached tail. Cold
  entries evict LRU at the budget, and on demand when allocation finds
  the free list dry; admission headroom counts the cached pages only
  the cache holds. A page returns to the free list (int8: scales
  zeroed) only when its last referent lets go, so a shared page keeps
  its scales frozen. Shared pages are only block-table entries, so the
  captured tick needs no recapture.
- Chunked prefill (`prefill_chunk=C`): a prompt whose uncached tail is
  longer than C prefills in lockstep rounds of C tokens that append at
  lens > 0, which bounds prefill attention's (b, hk, g, s, L) scores
  at s = C.
- Bounded admission (`max_pending`) sheds `submit` with
  `EngineOverloaded` when the request cannot start now and the queue is
  full; `submit(deadline=)` fails an expired request with
  `DeadlineExceeded` at submit, or at admission without a slot, pages
  or a prefill (inference/overload.py).
- Speculative decoding (`draft_model=`, `spec_tokens=g`): a draft model
  rides its own page pools over the same block tables, so a rejected
  proposal rolls back for free (lens does not advance; its stale
  positions are masked and later overwritten). Every prefill call also
  writes the draft's KV. Each tick is then the spec tick (`_spec_body`,
  the JAX engine's `_spec_tick_fn`): g draft steps at s = 1 through the
  decode kernel, one target verify at s = g + 1 over `_attend_pages`,
  acceptance on the device (greedy slots by token equality, which is
  lossless; sampled slots by Leviathan's rejection rule, which keeps the
  target's distribution), and the draft's KV at lens + g written for the
  rows that accepted all g. On the card it is captured per sampling
  variant as `_programs[("spec_tick", any_sample)]`.

- Tenancy (`tenancy=` a TenantTable of inference/tenancy.py): admission
  takes a weighted-fair pick across per-tenant queues (strict priority
  classes above the fair tiers), so decode slots divide by policy
  weight under saturation; a tenant past its own `max_queued` sheds
  with `TenantQuotaExceeded`; under `max_pending` pressure the newest
  queued request of the tenant most over its weighted share is evicted
  in a newcomer's favor. `tenant_snapshot()` gives each tenant's
  admissions, slot-ticks, sheds and pending count.
- Host KV tier (`host_tier_bytes=N`, inference/kvtier.py): evicting a
  cached page spills it to host RAM. The capture gathers the page's
  rows of every pool buffer into a fresh device tensor on the engine's
  stream, before the page is recycled, and copies it to pinned host
  memory on a side stream; the tier's worker waits on an event, never
  the scheduler. Admission extends a device-cache run with
  host-resident pages: one pinned host-to-device copy and one in-place
  `index_copy_` per pool buffer (k/v, int8 scales, the draft's), into
  the buffers the captured tick reads, between ticks on its stream, so
  no recapture follows; then the tail-only warm prefill runs.
- Sessions (`submit(session=)`, `suspend_after_s`): a finished turn's
  full pages (prompt and generated tokens) stay keyed in the cache;
  a session idle past `suspend_after_s` spills them to the host tier,
  freeing the device pages, and its next turn restores them.
- Disaggregated roles (`role="prefill"` / `"decode"`,
  inference/disagg.py): a prefill engine captures each prefilled
  request's full prompt pages to its host tier, and `export_pages`
  hands them out; a decode engine takes them through `stage_import`
  and inserts them into its prefix cache at the top of the next
  admission, through the same in-place upload.

- Serving integration: `concurrent_safe` tells inference/serving.py's
  `PredictorServer` not to serialize streams through its lock (the
  ticker thread is the only device user), and `export_metrics(registry)`
  publishes the engine's stats as the `engine.*` gauges of its
  /metrics.
- Observability (paddle_tpu_torch/observability, off by default; every
  site is one attribute check): `submit` adopts the request context the
  serving layer bound to its contextvar (or registers a fresh one) and
  the engine records the request's timeline into it, queued, scheduled,
  prefill start and end, every emission (`record_tokens`, up to
  `steps_per_tick` tokens a row at once) and the terminal outcome; a
  context shared by several rows finishes with the last. The counters
  `tenant.*`, `inference.prefix.*`, `inference.decode.kernel` (path
  "cuda" or "twin") and, in kvtier.py and disagg.py,
  `inference.kvtier.*` and `inference.disagg.*` count at the JAX
  engine's sites.
- Chaos (paddle_tpu_torch/distributed/chaos.py, off by default):
  `engine.tick.delay` sleeps on the host at the top of a tick, before
  any replay; `prefix.cache.bypass` turns a prefix hit into a miss;
  `kvtier.spill.fail` drops a spill, so the eviction destroys the page;
  `kvtier.restore.delay` slows a restore.
"""
from __future__ import annotations

import collections
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

from paddle_tpu_torch import observability
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.graphs import capture_graph
from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.inference.disagg import (DisaggStats,
                                               PageBundleEntry, dtype_name)
from paddle_tpu_torch.inference.kvtier import HostKVTier
from paddle_tpu_torch.inference.overload import (DeadlineExceeded,
                                                 EngineOverloaded,
                                                 OverloadError,
                                                 TenantQuotaExceeded)
from paddle_tpu_torch.inference.prefix import PrefixCache, chain_keys
from paddle_tpu_torch.inference.tenancy import WeightedFairScheduler
from paddle_tpu_torch.models.generation import _np_process_logits
from paddle_tpu_torch.observability import requests as obs_requests
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
    with no host sync. So are rows whose logical page lies past the
    block table (a speculative verify near the end of a slot's window):
    the JAX engine clamps those to the table's last column, where they
    overwrite committed k/v that the same call then reads. Rows past a
    slot's budget but inside its window (the verify's g + 1 positions
    near the budget) land in its unallocated entries, page 0, as in the
    JAX engine; page 0 is only ever read masked.

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
    logical = pos // page_size
    # the clamp keeps the gather in bounds; past-window rows go to the
    # sink below
    phys = torch.gather(bt, 1, logical.clamp(0, bt.shape[1] - 1).long())
    keep = (steps[None, :] < n_valid[:, None]) & (logical < bt.shape[1])
    phys = torch.where(keep, phys, sink)
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


def _torch_dtype(dtype, default):
    """The pool type a constructor's `dtype` names: a torch dtype, or
    its name as numpy spells it ("bfloat16", "float32"); None takes
    `default`. An unknown name raises numpy's TypeError text."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    got = getattr(torch, str(dtype), None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"data type {str(dtype)!r} not understood")
    return got


class _Request:
    """One generation request: the engine's record and the caller's
    handle (thread-safe: tokens stream through a queue)."""

    _next_id = 0
    _id_lock = threading.Lock()

    def __init__(self, ids, max_new_tokens, eos_token_id, do_sample,
                 temperature, top_k, top_p, pages_needed, deadline=None,
                 prefix_keys=(), engine=None, tenant=None, session=None):
        # process-wide row id: keys this row's clocks in a request
        # context that several rows share
        with _Request._id_lock:
            self.rid = _Request._next_id
            _Request._next_id += 1
        self.obs = None             # request-tracing context (or None)
        self.queued_at = time.monotonic()   # per-tenant queue-wait clock
        self.prompt = np.asarray(ids, np.int32).reshape(-1)
        self.deadline = deadline    # expire-in-queue (overload.Deadline)
        self.tenant = tenant        # tenant id (tenancy)
        self.session = session      # conversation id (host tier)
        # chain keys of the prompt's full pages (empty: no prefix cache)
        self.prefix_keys = list(prefix_keys)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = -1 if eos_token_id is None else int(eos_token_id)
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.pages_needed = pages_needed
        # engine-local submission index, set by submit(): the first
        # sampled token derives from (engine seed, this index)
        self.sample_index = 0
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


def _host_layers(kv, scales):
    """A page's (layers, 2, kv_heads, page_size, head_dim) k/v and
    (layers, 2, kv_heads) scale snapshot as the host entry's per-layer
    tuples: (k, v), or (k, v, k_scale_row, v_scale_row)."""
    if scales is None:
        return [(kv[i, 0], kv[i, 1]) for i in range(kv.shape[0])]
    return [(kv[i, 0], kv[i, 1], scales[i, 0], scales[i, 1])
            for i in range(kv.shape[0])]


def _groups_match(groups, pools):
    """True when host arrays `groups` (per-layer tuples) have the layer
    count, arity, page shape and element type of the engine pools
    `pools` (whose arrays carry a leading page axis)."""
    if len(groups) != len(pools):
        return False
    grp, ref = groups[0], pools[0]
    return (len(grp) == len(ref)
            and tuple(grp[0].shape) == tuple(ref[0].shape[1:])
            and dtype_name(grp[0]) == dtype_name(ref[0]))


class _Slot:
    __slots__ = ("req", "lens", "tok", "pages", "emitted", "shared")

    def __init__(self, req, lens, tok):
        self.req = req
        self.lens = int(lens)       # tokens committed to the paged cache
        self.tok = int(tok)         # next decode input (last emitted)
        self.pages: list[int] = []  # physical pages in block-table order
        self.emitted = 0            # generated tokens accepted so far
        self.shared = 0             # leading prefix-cache pages (not
        #                             drawn from the free list here)


# the tick program's per-slot inputs: name -> (type, an idle slot's value)
_TICK_INPUTS = {"tok": (torch.int32, 0), "lens": (torch.int32, 0),
                "active": (torch.bool, False), "limit": (torch.int32, 0),
                "eos": (torch.int32, -1), "temp": (torch.float32, 1.0),
                "topk": (torch.int32, 0), "topp": (torch.float32, 1.0),
                "wants": (torch.bool, False)}


class PagedKVEngine:
    """Continuous-batching scheduler over paged KV pools (module doc).

    model: a port LlamaForCausalLM or Qwen2MoeForCausalLM (its attention
        takes PagedState cache coordinates), on `device`. A Qwen2-MoE
        model's idle slots go through its MoE with the live ones, as in
        the JAX engine: on the capacity path they take capacity in token
        order.
    max_slots: decode batch width.
    page_size / num_pages: pool geometry; page 0 is the trash page, so
        num_pages - 1 pages are allocatable (each pool also holds one
        sink page past them, for dropped writes).
    max_pages_per_slot: block-table width; bounds prompt + generation
        per request at max_pages_per_slot * page_size tokens.
    steps_per_tick: decode steps per tick (admission granularity, and
        one host sync per tick).
    kv_dtype: None keeps `dtype` for the pools; "bf16" stores bf16
        pools; "int8" stores int8 pools with f32 (num_pages + 1,
        kv_heads) scale planes per layer, about half the KV bytes of
        bf16 (`kv_bytes_per_slot`).
    dtype: the pool type when `kv_dtype` is None, a torch dtype or its
        name ("bfloat16", "float32"); None (default) takes the model's
        parameter type.
    kernel: the decode attend, the JAX engine's choice of None,
        "pallas" or "jnp". On the card None and "pallas" both name the
        hand-written decode kernel (`check_decode_shapes` raises,
        naming the dims, for a geometry it refuses) and "jnp" raises:
        the port has no plain decode path on the card. On the CPU every
        value runs the kernel's plain twin. `decode_kernel` reads
        "cuda" or "twin".
    device: where the engine runs (default the CUDA card; "cpu" must be
        asked for) — the model must live there.
    prefill_chunk: prompts whose uncached tail is longer than this
        prefill in lockstep rounds of this many tokens (appending at
        lens > 0) instead of in one call; None (default) always
        prefills whole.
    max_pending: bound on the not-yet-admitted queue. None (default)
        queues unboundedly; with a bound, `submit` sheds with
        EngineOverloaded (retryable) when the request cannot start now
        and the queue is full.
    prefix_cache_pages: page budget of the prompt prefix cache (module
        doc; 0 = disabled, the default).
    draft_model: a port LlamaForCausalLM on the same device that
        proposes `spec_tokens` tokens a tick for the target to verify
        (module doc); its pools take the engine's pool type and its own
        head geometry. Not with `prefill_chunk`. Each tick then emits 1
        to spec_tokens + 1 tokens a slot, whatever `steps_per_tick`.
    tenancy: a tenancy.TenantTable (module doc); None (default) keeps
        FIFO admission and the tenant-free shed rules.
    host_tier_bytes: the host KV tier's byte budget (module doc; 0 =
        disabled, the default). Needs `prefix_cache_pages` > 0. Host
        entries are pinned when the engine is on the card.
    suspend_after_s: seconds a session may idle before its cached pages
        spill to the host tier (module doc; None = never). Needs
        `host_tier_bytes` > 0.
    role: "both" (default, the monolithic engine), "prefill" (needs
        `host_tier_bytes` > 0: committed pages export from the host
        tier) or "decode" (needs `prefix_cache_pages` > 0: imported
        pages land in the prefix cache); module doc.
    """

    def __init__(self, model, *, max_slots=4, page_size=16, num_pages=64,
                 max_pages_per_slot=None, steps_per_tick=4, seed=0,
                 prefill_chunk=None, draft_model=None, spec_tokens=4,
                 dtype=None, max_pending=None, kernel=None,
                 kv_dtype=None, prefix_cache_pages=0, tenancy=None,
                 host_tier_bytes=0, suspend_after_s=None, role="both",
                 device="cuda"):
        dev = resolve_device(device)
        mdev = model.device
        for what, m in (("model", model), ("draft_model", draft_model)):
            if m is None:
                continue
            if dev.type != m.device.type or (
                    dev.index is not None and dev.index != m.device.index):
                raise ValueError(f"{what} lives on {m.device}, engine "
                                 f"asked for {dev}")
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
        self.max_pending = (None if max_pending is None
                            else int(max_pending))
        self.prefill_chunk = (int(prefill_chunk) if prefill_chunk
                              else None)
        if self.prefill_chunk is not None and self.prefill_chunk < 0:
            # a negative round would never consume a token
            raise ValueError(f"prefill_chunk must be > 0 or None, got "
                             f"{prefill_chunk}")
        if int(prefix_cache_pages) < 0:
            raise ValueError(f"prefix_cache_pages must be >= 0, got "
                             f"{prefix_cache_pages}")
        self.prefix_cache = (PrefixCache(prefix_cache_pages)
                             if int(prefix_cache_pages) else None)
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"kv_dtype must be None, 'bf16' or 'int8' "
                             f"(got {kv_dtype!r})")
        self.kv_dtype = kv_dtype
        pool_dtype = {None: _torch_dtype(dtype, model.dtype),
                      "bf16": torch.bfloat16, "int8": torch.int8}[kv_dtype]
        if kernel not in (None, "pallas", "jnp"):
            raise ValueError(f"kernel must be None, 'pallas' or 'jnp' "
                             f"(got {kernel!r})")
        if kernel == "jnp" and dev.type == "cuda":
            raise ValueError(
                "kernel='jnp' asks for the plain decode attend, which the "
                "port runs only on the CPU (device='cpu'); on the card "
                "decode goes through the hand-written kernel (kernel=None "
                "or 'pallas')")
        # the decode attend: the hand-written kernel on the card (its
        # shapes are checked in _make_pools), the plain twin on the CPU
        self.decode_kernel = "cuda" if dev.type == "cuda" else "twin"
        if draft_model is not None and prefill_chunk:
            raise NotImplementedError(
                "speculative decoding + chunked prefill: the draft "
                "prefill mirrors the bucketed path only (compose later)")
        if draft_model is not None and \
                draft_model.config.vocab_size != cfg.vocab_size:
            # the verify holds the draft's tokens and q rows against the
            # target's logits column for column
            raise ValueError(f"draft_model's vocab_size "
                             f"{draft_model.config.vocab_size} != the "
                             f"model's {cfg.vocab_size}")
        self.draft_model = draft_model
        self.spec_tokens = int(spec_tokens)
        self.pools, self._kv, self._scales = self._make_pools(cfg,
                                                             pool_dtype)
        # the draft's pools share the block tables; its k/v and int8
        # scale planes are one tensor each beside `_kv` and `_scales`
        self.draft_pools = self._draft_kv = self._draft_scales = None
        if draft_model is not None:
            self.draft_pools, self._draft_kv, self._draft_scales = \
                self._make_pools(draft_model.config, pool_dtype)
        # host-RAM KV tier (module doc): spill and restore below the
        # device prefix cache, and session suspend/resume over them
        if int(host_tier_bytes) < 0:
            raise ValueError(f"host_tier_bytes must be >= 0, got "
                             f"{host_tier_bytes}")
        if int(host_tier_bytes) and self.prefix_cache is None:
            raise ValueError(
                "host_tier_bytes requires prefix_cache_pages > 0: the "
                "tier spills and restores PREFIX-CACHE pages (chain "
                "keys are the page identity)")
        self.host_tier = (HostKVTier(int(host_tier_bytes))
                          if int(host_tier_bytes) else None)
        self._tier_stream = None    # the spill copies' side stream (card)
        if suspend_after_s is not None and self.host_tier is None:
            raise ValueError(
                "suspend_after_s requires host_tier_bytes > 0: a "
                "suspended session's pages live in the host tier")
        self.suspend_after_s = (None if suspend_after_s is None
                                else float(suspend_after_s))
        # disaggregated prefill/decode (inference/disagg.py); "both" is
        # the monolithic engine, with every disagg path dormant
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"role must be 'prefill', 'decode' or "
                             f"'both' (got {role!r})")
        if role == "prefill" and self.host_tier is None:
            raise ValueError(
                "role='prefill' requires host_tier_bytes > 0: committed "
                "pages export through the host-snapshot path")
        if role == "decode" and self.prefix_cache is None:
            raise ValueError(
                "role='decode' requires prefix_cache_pages > 0: "
                "imported pages land in the prefix cache")
        self.role = role
        self.disagg = DisaggStats(role)
        # bundles staged by caller threads (stage_import), drained into
        # the pools at the top of _admit; guarded by _lock
        self._import_staged: list = []
        # session id -> {keys, last, suspended}; scheduler thread only
        self._sessions: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._free = list(range(self.num_pages - 1, 0, -1))   # 0 = trash
        # pages promised to admitted slots but not yet popped from the
        # free list (admission_headroom)
        self._reserved_unalloc = 0
        # the refcount of every allocated page (its slots, and the
        # prefix cache's one ref while it holds the page); without a
        # cache every allocated page has exactly one ref, its slot's
        self._page_refs: dict[int, int] = {}
        # the pages the cache holds, and how many of them only the cache
        # holds (evictable to free, so admission headroom), kept
        # current at each ref transition
        self._cached_pages: set[int] = set()
        self._reclaimable = 0
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
        # the program, fixed here: the tick writes (b, n) tokens, then
        # the final lens; the spec tick (b, g + 1) tokens, then n_emit
        # and the final lens. The body is looked up by name at each use
        # (a bound method kept here would make the engine a cycle)
        if draft_model is None:
            self._kind, self._body_name = "tick", "_tick_body"
            width = self.steps_per_tick + 1
        else:
            self._kind, self._body_name = "spec_tick", "_spec_body"
            width = self.spec_tokens + 3
        self._outputs = torch.zeros((b, width), dtype=torch.int32,
                                    device=mdev)
        # ("tick" or "spec_tick", any_sample) -> CapturedProgram
        self._programs = {}
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
        # multi-tenant QoS (module doc): the WFQ pick and per-tenant
        # shares; None keeps every scheduling path tenant-free
        self.tenancy = tenancy
        self._wfq = (WeightedFairScheduler(tenancy)
                     if tenancy is not None else None)
        self._tenant_lock = threading.Lock()
        self._tenant_stats: dict[str, dict] = {}
        # per-tenant queued counts (guarded by _lock): submit adds, every
        # way out of the queue (admit, cancel, expire, shed, _fail_all)
        # takes away. The quota reads this, not _pending, which _admit
        # swaps out while it prefills
        self._queued_by_tenant: dict[str, int] = {}
        self.stats = {"ticks": 0, "prefills": 0, "prefill_calls": 0,
                      "tokens_out": 0,
                      "admitted": 0, "finished": 0, "cancelled": 0,
                      "expired": 0, "overloaded": 0,
                      "prefill_s": 0.0, "tick_s": 0.0, "prefill_tokens": 0,
                      "decode_tokens": 0, "warmup_ticks": 0,
                      "warmup_s": 0.0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_hit_tokens": 0, "prefix_pages_shared": 0,
                      "prefix_evictions": 0, "spec_ticks": 0,
                      "spec_proposed": 0, "spec_accepted": 0}
        # serving integration: PredictorServer must not serialize
        # concurrent streams through its lock; the ticker thread is the
        # only device user
        self.concurrent_safe = True

    def _make_pools(self, cfg, pool_dtype):
        """One (k, v) pool pair per layer of a model of config `cfg`
        (+ the sink page), all views of one (layers, 2, num_pages + 1,
        kv_heads, page_size, head_dim) tensor, which is returned too;
        and for int8 KV the one tensor that holds every layer's scale
        planes (None otherwise)."""
        n_kv, hd = cfg.num_key_value_heads, cfg.head_dim
        n_layers = cfg.num_hidden_layers
        dev = self.device
        if dev.type == "cuda":      # the CPU twin takes any geometry
            check_decode_shapes(cfg.num_attention_heads, n_kv, hd,
                                self.page_size, pool_dtype)
        shape = (self.num_pages + 1, n_kv, self.page_size, hd)   # + sink
        # a layer's k and v pools are the two halves of one buffer (int8
        # KV quantizes both in one pass, _scatter_kv), and every layer's
        # are views of one tensor: a spill gathers a page of all of them
        # in one launch, a restore writes pages in one (_tier_upload)
        kv = torch.zeros((n_layers, 2) + shape, dtype=pool_dtype,
                         device=dev)
        pools = [tuple(kv[i]) for i in range(n_layers)]
        if pool_dtype != torch.int8:
            return pools, kv, None
        # every layer's k and v scale planes are views of one tensor, so
        # freed pages' scales reset in one launch (_recycle_pages)
        scales = torch.zeros((n_layers, 2, self.num_pages + 1, n_kv),
                             dtype=torch.float32, device=dev)
        return [(kp, vp, scales[i, 0], scales[i, 1])
                for i, (kp, vp) in enumerate(pools)], kv, scales

    def kv_bytes_per_slot(self):
        """Device bytes one fully grown slot pins across every layer's KV
        pools (and, for int8 KV, their scale rows), the draft model's
        included, from the real buffer types."""
        per_page = sum(t[0].numel() * t.element_size()
                       for grp in self.pools + (self.draft_pools or [])
                       for t in grp)
        return per_page * self.max_pages_per_slot

    def export_metrics(self, registry):
        """Publish the engine's stats into a metrics registry as
        scrape-time gauges (PredictorServer's GET /metrics calls this on
        its generator): absolute values sampled at the scrape."""
        s = self.stats
        registry.set_gauge("inference.kv.bytes_per_slot",
                           self.kv_bytes_per_slot())
        if self.host_tier is not None:
            registry.set_gauge("inference.kvtier.host_pages",
                               len(self.host_tier))
        registry.set_gauge("engine.ticks", s["ticks"])
        registry.set_gauge("engine.prefills", s["prefills"])
        registry.set_gauge("engine.tokens_out", s["tokens_out"])
        registry.set_gauge("engine.admitted", s["admitted"])
        registry.set_gauge("engine.finished", s["finished"])
        registry.set_gauge("engine.cancelled", s["cancelled"])
        registry.set_gauge("engine.expired", s["expired"])
        registry.set_gauge("engine.overloaded", s["overloaded"])
        # the ticker swaps _pending under _lock
        with self._lock:
            pending = len(self._pending)
        registry.set_gauge("engine.pending", pending)

    def prefix_stats(self):
        """The prefix cache's counters (the JAX engine's /stats block);
        None when the cache is disabled."""
        if self.prefix_cache is None:
            return None
        s = self.stats
        h, m = s["prefix_hits"], s["prefix_misses"]
        return {"enabled": True,
                "hits": h, "misses": m,
                "hit_rate": round(h / (h + m), 4) if (h + m) else 0.0,
                "hit_tokens": s["prefix_hit_tokens"],
                "pages_shared": s["prefix_pages_shared"],
                "evictions": s["prefix_evictions"],
                "cached_pages": len(self.prefix_cache),
                "page_budget": self.prefix_cache.page_budget}

    def kvtier_stats(self):
        """The host tier's /stats block; None when the tier is
        disabled."""
        return (None if self.host_tier is None
                else self.host_tier.snapshot())

    def disagg_stats(self):
        """The /stats `disagg` block; always present, since a router
        reads `role` from it."""
        return self.disagg.snapshot()

    # -- disaggregated handoff (inference/disagg.py) ---------------------
    def export_pages(self, keys):
        """Prefill side: PageBundleEntry objects for the longest leading
        run of `keys` resident in the host tier. Runs on a caller thread
        and touches only the host tier, never the device pools; queued
        captures are flushed first, so pages a prefill just committed
        are there."""
        if self.host_tier is None:
            return []
        self.host_tier.flush(timeout=10.0)
        return [PageBundleEntry(k, e.layers, e.draft)
                for k, e in self.host_tier.peek_run(keys)]

    def disagg_missing(self, keys):
        """Decode side: the suffix of `keys` resident neither in the
        prefix cache nor in the host tier, the pages a handoff has to
        move. Advisory (a caller thread, while the scheduler changes
        both tiers): a stale answer costs a redundant transfer or a
        shorter warm run, never a wrong token."""
        if self.prefix_cache is None:
            return list(keys)
        have = self.prefix_cache.leading_run(keys)
        if self.host_tier is not None:
            for k in keys[have:]:
                if not self.host_tier.has(k):
                    break
                have += 1
        return list(keys[have:])

    def stage_import(self, entries):
        """Queue peer page bundles for insertion (a caller thread; only
        appends under `_lock`). The scheduler inserts them at the top of
        its next `_admit`, before the prefix lookups of that pass."""
        if not entries:
            return
        if self.prefix_cache is None:
            raise RuntimeError("disagg import requires a prefix cache")
        with self._lock:
            self._import_staged.extend(entries)

    def _disagg_import(self, entries):
        """Scheduler thread: insert staged peer pages through the ledger
        steps of `_tier_restore` (a free page, evicting a cold cache
        entry on demand; the cache's ref; insert; one upload). Headroom
        is unchanged: each page taken is a cache-only, reclaimable page.
        Keys already resident are skipped."""
        cache = self.prefix_cache
        ents, pages = [], []
        skipped = 0
        for ent in entries:
            if ent.key in cache:
                skipped += 1
                continue
            if not self._tier_entry_compatible(ent):
                continue
            if not self._free and \
                    not self._evict_prefix_entries(budget_only=False):
                break               # the cache holds only pages in use
            page = self._free.pop()
            self._ref_page(page)
            cache.insert(ent.key, page)
            self._cached_pages.add(page)
            self._reclaimable += 1
            ents.append(ent)
            pages.append(page)
        if ents:
            self._tier_upload(ents, pages)
            self._evict_prefix_entries(budget_only=True)
            self.disagg.note_imported(
                len(ents), sum(e.nbytes for e in ents))
        if skipped:
            self.disagg.note_dedup(skipped)

    # -- submission ------------------------------------------------------
    def admission_headroom(self):
        """Pages not promised to any admitted slot: free pages plus the
        cached pages only the cache holds (evictable on demand), minus
        outstanding reservations. Exact on the scheduler thread,
        advisory from submit() callers."""
        return len(self._free) + self._reclaimable - self._reserved_unalloc

    def submit(self, ids, max_new_tokens=32, *, eos_token_id=None,
               do_sample=False, temperature=1.0, top_k=0,
               top_p=1.0, deadline=None, tenant=None, session=None,
               **_ignored) -> _Request:
        """Queue one request and return its handle. `deadline` (an
        overload.Deadline) fails it with DeadlineExceeded, here when it
        has already expired, or at admission when it expires while
        queued. With `max_pending`, a request that cannot start now
        behind a full queue is shed with EngineOverloaded; with
        `tenancy`, a tenant past its `max_queued` with
        TenantQuotaExceeded. `session` opts a conversation into turn
        retention and suspend/resume (inert without a prefix cache)."""
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded(
                "deadline exceeded before engine admission")
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
        # hash the prompt's full pages here, on the caller's thread; the
        # lookup happens at admission. The last full page is keyed too
        # (decode writes land in later pages); _prefix_lookup caps the
        # sharing so the prompt's last token is always prefilled
        keys = (chain_keys(ids, self.page_size)
                if self.prefix_cache is not None else [])
        sess = (str(session) if session is not None
                and self.prefix_cache is not None else None)
        req = _Request(ids, max_new_tokens, eos_token_id, do_sample,
                       temperature, top_k, top_p, pages,
                       deadline=deadline, prefix_keys=keys, engine=self,
                       tenant=tenant, session=sess)
        if observability.ENABLED:
            # adopt the serving layer's request context (its contextvar,
            # copied into the stream's producer thread) or start one for
            # a direct caller; claiming the token accounting keeps the
            # HTTP consumer from recording the emissions again
            ctx = obs_requests.current()
            if ctx is None:
                ctx = obs_requests.register(
                    obs_requests.RequestContext.new())
            if tenant is not None and ctx.tenant is None:
                ctx.tenant = tenant
            if self.tenancy is not None and tenant is not None \
                    and ctx.tenant_key is None:
                ctx.tenant_key = self.tenancy.key(tenant)
            ctx.claim_tokens()
            req.obs = ctx
            ctx.record("queued", rid=req.rid)
            # the ref comes before the request is visible to the ticker,
            # which may expire or cancel it at once
            ctx.adopt_engine()
        try:
            return self._submit_locked(req, pages)
        except OverloadError as e:
            if req.obs is not None:
                # the shed row never entered the queue, so nothing else
                # releases its ref
                req.obs.engine_finish(e.counter)
            raise

    def _submit_locked(self, req, pages):
        with self._lock:
            if self.tenancy is not None:
                # the tenant's own queue quota sheds first (a typed 429,
                # the bulkhead): its storm never reaches the global bound
                # other tenants share
                pol = self.tenancy.policy(req.tenant)
                tkey = self.tenancy.key(req.tenant)
                if pol.max_queued is not None \
                        and self._queued_by_tenant.get(tkey, 0) \
                        >= pol.max_queued:
                    self.stats["overloaded"] += 1
                    self._note_tenant_shed(tkey, "queue")
                    raise TenantQuotaExceeded(
                        f"tenant {tkey!r} over engine queue quota "
                        f"({pol.max_queued} pending)", retry_after=0.1)
            if self.max_pending is not None:
                # shed when the request can neither start now (a free
                # slot, page headroom, nothing queued ahead of it) nor
                # wait within the pending bound
                queued = len(self._pending)
                admissible_now = (
                    queued == 0
                    and any(s is None for s in self._slots)
                    and pages <= self.admission_headroom())
                if not admissible_now and queued >= self.max_pending:
                    victim = (self._pressure_victim_locked(req)
                              if self.tenancy is not None else None)
                    if victim is None:
                        self.stats["overloaded"] += 1
                        raise EngineOverloaded(
                            f"engine overloaded: {queued} pending >= "
                            f"max_pending {self.max_pending} and no "
                            "admission headroom", retry_after=0.1)
                    # the over-share tenant's newest queued request
                    # yields the place to the newcomer
                    self._shed_pending_locked(victim)
            req.sample_index = self._submitted
            self._submitted += 1
            self._inflight += 1
            self._pending.append(req)
            if self.tenancy is not None:
                k = self.tenancy.key(req.tenant)
                self._queued_by_tenant[k] = \
                    self._queued_by_tenant.get(k, 0) + 1
        return req

    def _queued_dec_locked(self, req):
        """A request left the queue (admitted, cancelled, expired, shed
        or failed). The caller holds `_lock`."""
        if self.tenancy is None:
            return
        k = self.tenancy.key(req.tenant)
        n = self._queued_by_tenant.get(k, 0) - 1
        if n > 0:
            self._queued_by_tenant[k] = n
        else:
            self._queued_by_tenant.pop(k, None)

    def _pressure_victim_locked(self, req):
        """Under global `max_pending` pressure, the queued request to
        evict in the newcomer's favor: the newest pending request of the
        tenant most over its weighted fair share of the queue, and only
        when that tenant's weighted backlog strictly exceeds the
        newcomer's own (so a storm never evicts itself a place, and
        equal-share tenants shed the newcomer). None when there is no
        such tenant, or when all its backlog is in an `_admit` pass
        (the shares count it; the victim must be in `_pending`)."""
        counts = dict(self._queued_by_tenant)
        nkey = self.tenancy.key(req.tenant)
        # the weighted backlog the newcomer would have, itself included
        nshare = (counts.get(nkey, 0) + 1) \
            / self.tenancy.policy(req.tenant).weight
        worst = None
        for k, n in counts.items():
            if k == nkey:
                continue
            share = n / self.tenancy.policy(k).weight
            if share > nshare and (worst is None or share > worst[1]):
                worst = (k, share)
        if worst is None:
            return None
        for r in reversed(self._pending):
            if self.tenancy.key(r.tenant) == worst[0]:
                return r
        return None

    def _shed_pending_locked(self, victim):
        """Evict one queued request under pressure (the caller holds
        `_lock`): the submit-shed contract, a typed retryable error and
        a woken waiter, for a request already queued."""
        self._pending.remove(victim)
        self._queued_dec_locked(victim)
        self._inflight -= 1
        self.stats["overloaded"] += 1
        self._note_tenant_shed(self.tenancy.key(victim.tenant), "engine")
        victim.error = EngineOverloaded(
            "engine overloaded: evicted from the pending queue under "
            "pressure (tenant over its weighted fair share)",
            retry_after=0.1)
        if victim.obs is not None:
            victim.obs.engine_finish("shed_engine")
        victim.queue.put(None)
        victim.done.set()

    def _tenant_row(self, tkey):
        """A tenant's stats row (the caller holds `_tenant_lock`)."""
        return self._tenant_stats.setdefault(
            tkey, {"admitted": 0, "slot_ticks": 0, "shed": 0})

    def _note_tenant_shed(self, tkey, reason):
        """One shed of `tkey`'s: over its quota ("queue"), or evicted
        under pressure ("engine")."""
        with self._tenant_lock:
            self._tenant_row(tkey)["shed"] += 1
        if observability.ENABLED:
            observability.inc("tenant.shed", tenant=tkey, reason=reason)

    def has_work(self):
        with self._lock:
            return self._inflight > 0

    # -- scheduling core -------------------------------------------------
    @staticmethod
    def _bucket(n):
        return max(8, 1 << (n - 1).bit_length())

    # -- the page refcount ledger ----------------------------------------
    def _ref_page(self, page):
        n = self._page_refs.get(page, 0)
        self._page_refs[page] = n + 1
        if n == 1 and page in self._cached_pages:
            # a cache-only page just got a slot ref: no longer
            # evictable to free
            self._reclaimable -= 1

    def _unref_page(self, page):
        """Drop one reference; True when the page just became free (the
        caller recycles it). A page is never freed while a live slot or
        the cache still references it."""
        n = self._page_refs.get(page, 1) - 1
        if n <= 0:
            self._page_refs.pop(page, None)
            return True
        self._page_refs[page] = n
        if n == 1 and page in self._cached_pages:
            # back to cache-only: evicting it would free a page
            self._reclaimable += 1
        return False

    def _recycle_pages(self, pages):
        """Return zero-ref pages to the free list. int8 KV: zero their
        scale rows in one launch over `_scales` (and one over the
        draft's `_draft_scales`), between ticks and
        outside the graph, on the stream the next replay runs on. Scales
        only grow at scatter time, so a recycled page keeping its old
        scale would quantize its next request's k/v on the largest
        magnitude any earlier request wrote. A shared page reaches here
        only when its last referent lets go, so its scales stay frozen
        while it is shared. The pages join the free list first: a
        reset that raises (a sticky device error) still leaves the
        ledger whole."""
        if not pages:
            return
        self._free.extend(reversed(pages))
        if self._scales is not None:
            idx = torch.tensor(pages, device=self.device)
            self._scales[:, :, idx] = 0.0
            if self._draft_scales is not None:
                self._draft_scales[:, :, idx] = 0.0

    def _evict_prefix_entries(self, budget_only=True):
        """Shrink the prefix cache: to its page budget (`budget_only`,
        LRU whether or not the page is shared; a page a slot still
        holds just leaves the key space and is freed by its slots'
        refcounts), or by ONE entry only the cache holds (the on-demand
        lever when the free list runs dry). Returns the pages freed."""
        cache = self.prefix_cache
        freed = []
        if cache is None:
            return freed
        if budget_only:
            while cache.over_budget():
                key_page = cache.pop_lru()
                if key_page is None:
                    break
                self._note_evicted(key_page[1], freed, key=key_page[0])
        else:
            key_page = cache.pop_lru_where(
                lambda p: self._page_refs.get(p, 0) == 1)
            if key_page is not None:
                self._note_evicted(key_page[1], freed, key=key_page[0])
        self._recycle_pages(freed)
        return freed

    def _note_evicted(self, page, freed, key=None):
        """An entry left the cache: spill the page to the host tier when
        there is one (the capture comes before the recycle, so it holds
        the page's content; a key already on the host is not captured
        again, since the chain key fixes the content), then leave the
        cached-page ledger, drop the cache's ref, collect the page if
        that freed it."""
        if key is not None and self.host_tier is not None \
                and not self.host_tier.has(key):
            if chaos.ENABLED and chaos.should_fire("kvtier.spill.fail"):
                # degraded mode: a plain (destructive) eviction, so the
                # next hit on this prefix is cold
                self.host_tier.note_spill_skipped()
            else:
                self._tier_capture(key, page)
        self._cached_pages.discard(page)
        if self._page_refs.get(page, 0) == 1:
            self._reclaimable -= 1      # was cache-only
        self.stats["prefix_evictions"] += 1
        if observability.ENABLED:
            observability.inc("inference.prefix.evictions")
        if self._unref_page(page):
            freed.append(page)

    def _alloc_pages(self, slot_idx, need_total):
        """Grow the slot's allocation to `need_total` pages (lazy; the
        reservation made at admission guarantees that the free list,
        plus the cached pages only the cache holds, evicted here on
        demand, covers it)."""
        slot = self._slots[slot_idx]
        while len(slot.pages) < need_total:
            if not self._free and not self._evict_prefix_entries(
                    budget_only=False):
                cached = (0 if self.prefix_cache is None
                          else len(self.prefix_cache))
                raise RuntimeError(
                    "page pool exhausted despite reservation: free=0 "
                    f"reserved={self._reserved_unalloc} cached={cached}")
            page = self._free.pop()
            self._ref_page(page)
            self._reserved_unalloc -= 1
            self._bt[slot_idx, len(slot.pages)] = page
            slot.pages.append(page)

    # -- the prefix cache ------------------------------------------------
    def _prefix_lookup(self, req):
        """The longest cached run of the prompt's full pages, capped at
        (prompt - 1) // page_size pages so at least the prompt's last
        token is prefilled (its logits pick the first token). The chaos
        site `prefix.cache.bypass` turns a hit into a miss."""
        if self.prefix_cache is None or not req.prefix_keys:
            return []
        shareable = (int(req.prompt.size) - 1) // self.page_size
        if shareable <= 0:
            return []
        if chaos.ENABLED and chaos.should_fire("prefix.cache.bypass"):
            return []
        return self.prefix_cache.match(req.prefix_keys[:shareable])

    def _note_prefix_outcome(self, req, h):
        """Hit or miss, counted at the admission decision (a requeued
        request looks up again next pass and must not count twice).
        Prompts too short ever to share count neither way."""
        if self.prefix_cache is None:
            return
        ps = self.page_size
        if h > 0:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += h * ps
            self.stats["prefix_pages_shared"] += h
            if observability.ENABLED:
                observability.inc("inference.prefix.hits")
                observability.inc("inference.prefix.hit_tokens", h * ps)
                observability.inc("inference.prefix.pages_shared", h)
        elif (int(req.prompt.size) - 1) // ps > 0:
            self.stats["prefix_misses"] += 1
            if observability.ENABLED:
                observability.inc("inference.prefix.misses")

    def _prefix_insert(self, slot_idx, req):
        """Register a freshly prefilled slot's full prompt pages in the
        cache, right after the prefill that wrote them and before
        `_accept` (a max_new_tokens=1 request retires inside it). An
        existing key wins: a duplicate prompt admitted in the same pass
        keeps the first copy canonical, and its own pages retire with
        its slot. Then the LRU page budget."""
        cache = self.prefix_cache
        if cache is None:
            return
        slot = self._slots[slot_idx]
        n_full = min(len(req.prefix_keys),
                     int(req.prompt.size) // self.page_size,
                     len(slot.pages))
        for j in range(n_full):
            if cache.insert(req.prefix_keys[j], slot.pages[j]):
                # the ref comes before the ledger: the slot still holds
                # the page, so it enters the cache not reclaimable and
                # turns reclaimable when the slot retires
                self._ref_page(slot.pages[j])
                self._cached_pages.add(slot.pages[j])
        self._evict_prefix_entries(budget_only=True)

    def _disagg_capture(self, req):
        """A prefill-role engine snapshots a request's committed full
        prompt pages into its host tier right after the prefill that
        wrote them: that host copy is what `export_pages` hands out, so
        an export never touches the device pools. A key already on the
        host is not captured again."""
        if self.role != "prefill":
            return
        cache = self.prefix_cache
        n_full = min(len(req.prefix_keys),
                     int(req.prompt.size) // self.page_size)
        for j in range(n_full):
            key = req.prefix_keys[j]
            if self.host_tier.has(key):
                continue
            page = cache.get(key)
            if page is not None:
                self._tier_capture(key, page)

    # -- the host tier ---------------------------------------------------
    def _pool_buffers(self):
        """(k/v tensor, scale tensor or None) of the target's pools, then
        the draft's: every buffer a page lives in."""
        out = [(self._kv, self._scales)]
        if self.draft_pools is not None:
            out.append((self._draft_kv, self._draft_scales))
        return out

    def _tier_capture(self, key, page):
        """Snapshot one page of every pool buffer and hand it to the
        tier. The page's rows are gathered into fresh device tensors on
        the engine's stream now, before the page is recycled (its int8
        scales zeroed, the next request's k/v written over it): a view
        would see those writes. On the card the snapshot then goes to
        pinned host memory on a side stream that waits on the engine's,
        and the tier's worker waits on the event recorded after it;
        nothing here waits for the copy. On the CPU the gather is the
        host copy."""
        snaps = [[None if t is None
                  else t[:, :, page].clone(memory_format=torch
                                           .contiguous_format)
                  for t in buf] for buf in self._pool_buffers()]
        ready = None
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            if self._tier_stream is None:
                self._tier_stream = torch.cuda.Stream(self.device)
            side = self._tier_stream
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for pair in snaps:
                    for j, t in enumerate(pair):
                        if t is None:
                            continue
                        host = torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=True)
                        host.copy_(t, non_blocking=True)
                        t.record_stream(side)   # read on the side stream
                        pair[j] = host
                ready = torch.cuda.Event()
                ready.record(side)
        groups = [_host_layers(kv, sc) for kv, sc in snaps]
        self.host_tier.spill(key, groups[0],
                             groups[1] if len(groups) > 1 else None,
                             ready=ready)

    def _tier_entry_compatible(self, entry):
        """A host entry must match this engine's pool geometry exactly
        (defensive: a stale entry after a reconfiguration, or a peer's
        bundle, must be dropped, not written over pages). Types are
        compared by numpy's name, so a JAX engine's bundle matches."""
        return _groups_match(entry.layers, self.pools)

    def _tier_upload(self, ents, pages):
        """Write host entries into `pages` in place: per pool buffer one
        host staging tensor (pinned on the card), one host-to-device
        copy and one `index_copy_`, into the buffers the captured tick
        programs read at fixed addresses, on the stream their replays
        run on, between ticks. The draft's pages of an entry without a
        usable draft mirror (shed by the tier's budget, or a peer
        without a draft) are zero-filled: speculation then proposes
        badly, and the verify keeps the tokens exact."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        per_buffer = [[e.layers for e in ents]]
        if self.draft_pools is not None:
            blank = None
            drafts = []
            for e in ents:
                if e.draft is not None and _groups_match(e.draft,
                                                         self.draft_pools):
                    drafts.append(e.draft)
                    continue
                if blank is None:
                    blank = [tuple(torch.zeros(a.shape[1:], dtype=a.dtype)
                                   for a in grp)
                             for grp in self.draft_pools]
                drafts.append(blank)
            per_buffer.append(drafts)
        for (kv, sc), per_entry in zip(self._pool_buffers(), per_buffer):
            for dst, cols in ((kv, (0, 1)), (sc, (2, 3))):
                if dst is not None:
                    dst.index_copy_(2, idx, self._staged(dst, per_entry,
                                                         cols))

    def _staged(self, dst, per_entry, cols):
        """The arrays `cols` of each entry's layers stacked as
        (layers, 2, entries, ...) in one host tensor (pinned on the
        card), then on the engine's device."""
        n_layers, n = dst.shape[0], len(per_entry)
        pin = self.device.type == "cuda"
        host = torch.empty((n_layers, 2, n) + tuple(dst.shape[3:]),
                           dtype=dst.dtype, pin_memory=pin)
        torch.stack([torch.as_tensor(per_entry[j][li][c])
                     for li in range(n_layers) for c in cols
                     for j in range(n)],
                    out=host.view((-1,) + tuple(dst.shape[3:])))
        return host.to(self.device, non_blocking=True) if pin else host

    def _tier_restore(self, req, shared_pages):
        """On a device miss or partial hit, extend the leading shared
        run with pages restored from host RAM. Each restored page comes
        off the free list and enters the ledger like a freshly inserted
        prefix page (the cache's ref only, reclaimable), so
        `admission_headroom()` stays truthful; `_admit` then refs the
        whole run for the slot like any warm hit, and the tail-only
        prefill runs unchanged."""
        tier = self.host_tier
        cache = self.prefix_cache
        if tier is None or cache is None or not req.prefix_keys:
            return shared_pages
        have = len(shared_pages)
        shareable = (int(req.prompt.size) - 1) // self.page_size
        keys = req.prefix_keys[have:shareable]
        if not keys:
            return shared_pages
        # restored pages leave the free list now instead of off the
        # reservation later (the same total draw), so consult the tier
        # only when the request fits anyway: a restore never pushes a
        # request past the headroom check _admit runs next
        if req.pages_needed - have > self.admission_headroom():
            return shared_pages
        run = tier.match_run(keys)
        if not run:
            return shared_pages
        if chaos.ENABLED:
            # a slow host-to-device restore: the warm-TTFT lever
            chaos.maybe_delay("kvtier.restore.delay")
        ents, pages = [], []
        for key, entry in run:
            if not self._tier_entry_compatible(entry):
                tier.discard(key)
                break
            if not self._free and \
                    not self._evict_prefix_entries(budget_only=False):
                break
            page = self._free.pop()
            self._ref_page(page)
            cache.insert(key, page)
            self._cached_pages.add(page)
            self._reclaimable += 1
            ents.append(entry)
            pages.append(page)
        if not ents:
            return shared_pages
        self._tier_upload(ents, pages)
        tier.note_restored(len(pages), sum(e.nbytes for e in ents))
        # restored entries joined the device cache hot: its page budget
        # evicts (and spills) the coldest entries
        self._evict_prefix_entries(budget_only=True)
        return shared_pages + pages

    # -- sessions ----------------------------------------------------------
    def _session_retain(self, slot):
        """A finished turn with a session id keeps its KV: the slot's
        full committed pages (prompt and generated tokens) go into the
        prefix cache under the chain over the committed token stream,
        and the session's idle clock restarts. The next turn's prompt
        replays those tokens, so its chain keys match and its prefill
        runs only the new text."""
        req = slot.req
        cache = self.prefix_cache
        if cache is None or req.session is None:
            return
        # slot.lens counts the tokens whose KV was committed (the last
        # emitted token's KV was never fed back)
        committed = (list(map(int, req.prompt)) + req.tokens)[:slot.lens]
        keys = chain_keys(committed, self.page_size)
        n = min(len(keys), len(slot.pages))
        for j in range(n):
            if cache.insert(keys[j], slot.pages[j]):
                self._ref_page(slot.pages[j])
                self._cached_pages.add(slot.pages[j])
        rec = self._sessions.pop(req.session, None) \
            or {"keys": [], "last": 0.0, "suspended": False}
        rec["keys"] = keys[:n]
        rec["last"] = time.monotonic()
        rec["suspended"] = False
        self._sessions[req.session] = rec
        while len(self._sessions) > 4096:   # bound the registry: the LRU
            self._sessions.popitem(last=False)  # session loses retention
        self._evict_prefix_entries(budget_only=True)

    def _session_touch(self, sid):
        """Admission saw this session again: restart its idle clock, and
        count a resume if it was suspended (its pages just came back
        through _tier_restore or the warm path)."""
        rec = self._sessions.get(sid)
        if rec is None:
            return
        rec["last"] = time.monotonic()
        self._sessions.move_to_end(sid)
        if rec["suspended"]:
            rec["suspended"] = False
            if self.host_tier is not None:
                self.host_tier.note_resume()

    def _suspend_sweep(self):
        """Once a step: spill each session idle past `suspend_after_s`
        to the host tier and free its device pages, by its own keys
        (PrefixCache.pop; LRU order does not matter). A session with a
        queued next turn is skipped: the admission about to run would
        restore it right back."""
        if not self._sessions:
            return
        now = time.monotonic()
        with self._lock:
            queued = {r.session for r in self._pending
                      if r.session is not None}
        freed = []
        for sid, rec in self._sessions.items():
            if rec["suspended"] or sid in queued \
                    or now - rec["last"] < self.suspend_after_s:
                continue
            for k in rec["keys"]:
                page = self.prefix_cache.pop(k)
                if page is not None:
                    self._note_evicted(page, freed, key=k)
            rec["suspended"] = True
            self.host_tier.note_suspend()
        self._recycle_pages(freed)

    # -- tenancy -----------------------------------------------------------
    def _admission_order(self, pending):
        """The order pending requests are considered for admission:
        arrival without a TenantTable; with one, an iterative
        weighted-fair pick across per-tenant FIFOs, each pick seeing the
        charges of the admissions made earlier in the same pass, with
        strict priority classes above the fair tiers."""
        if self._wfq is None or len(pending) <= 1:
            return pending
        queues: dict[str, collections.deque] = {}
        for r in pending:
            queues.setdefault(self.tenancy.key(r.tenant),
                              collections.deque()).append(r)

        def order():
            while queues:
                t = self._wfq.pick(queues)
                q = queues[t]
                r = q.popleft()
                if not q:
                    del queues[t]
                yield r
        return order()

    def _note_tenant_admitted(self, req):
        """The tenant's admission count and the WFQ charge, at the
        moment the request takes a slot (scheduler thread)."""
        tkey = self.tenancy.key(req.tenant)
        self._wfq.charge(tkey)
        with self._tenant_lock:
            self._tenant_row(tkey)["admitted"] += 1
        if observability.ENABLED:
            observability.inc("tenant.admitted", tenant=tkey)
            observability.observe("tenant.queue_wait.seconds",
                                  time.monotonic() - req.queued_at,
                                  tenant=tkey)

    def _note_slot_ticks(self, live):
        """One slot-tick per live slot per tick: the evidence of the
        weighted-fair share, counted per tenant under one lock pass."""
        counts: dict[str, int] = {}
        for i in live:
            k = self.tenancy.key(self._slots[i].req.tenant)
            counts[k] = counts.get(k, 0) + 1
        with self._tenant_lock:
            for k, n in counts.items():
                self._tenant_row(k)["slot_ticks"] += n
        if observability.ENABLED:
            for k, n in counts.items():
                observability.inc("tenant.decode.slots", n, tenant=k)

    def tenant_snapshot(self):
        """Each tenant's admissions, decode slot-ticks, sheds and pending
        count (the serving /stats rows); {} without tenancy."""
        if self.tenancy is None:
            return {}
        with self._lock:
            # the queued counter also covers requests an _admit pass is
            # holding, which _pending alone would miss
            pend = dict(self._queued_by_tenant)
        with self._tenant_lock:
            out = {k: dict(v) for k, v in self._tenant_stats.items()}
        for k in pend:
            out.setdefault(k, {"admitted": 0, "slot_ticks": 0, "shed": 0})
        for k in out:
            out[k]["pending"] = pend.get(k, 0)
        return out

    # -- admission and prefill -------------------------------------------
    def _drop_queued(self, req, reason, error=None):
        """A queued request leaves without a slot (`reason` "cancelled"
        or "expired"): wake its waiter."""
        with self._lock:
            self._inflight -= 1
            self._queued_dec_locked(req)
        req.error = error
        if req.obs is not None:
            req.obs.engine_finish(reason)
        req.queue.put(None)
        req.done.set()

    def _admit(self):
        with self._lock:
            pending, self._pending = self._pending, []
            staged, self._import_staged = self._import_staged, []
        if staged:
            # peer pages pulled ahead of a routed request land before
            # this pass's prefix lookups, so that request admits warm
            self._disagg_import(staged)
        requeue = []
        admitted = []
        for req in self._admission_order(pending):
            if req.cancelled.is_set():        # cancelled while queued
                self.stats["cancelled"] += 1
                self._drop_queued(req, "cancelled")
                continue
            if req.deadline is not None and req.deadline.expired():
                # expired while queued: fail it without spending a slot,
                # pages or a prefill on work nobody waits for
                self.stats["expired"] += 1
                self._drop_queued(req, "expired", DeadlineExceeded(
                    "deadline exceeded while queued for engine "
                    "admission"))
                continue
            idx = next((i for i, s in enumerate(self._slots) if s is None),
                       None)
            shared = self._prefix_lookup(req) if idx is not None else []
            if idx is not None and self.host_tier is not None:
                # a device miss or partial hit: extend the run from the
                # host tier (an upload; headroom unchanged)
                shared = self._tier_restore(req, shared)
            # refs BEFORE the headroom check: matched pages stop being
            # reclaimable, so the check sees the budget after the hit
            for p in shared:
                self._ref_page(p)
            h = len(shared)
            if idx is None or \
                    req.pages_needed - h > self.admission_headroom():
                for p in shared:
                    self._unref_page(p)     # the cache's ref remains
                requeue.append(req)
                continue
            self._note_prefix_outcome(req, h)
            if req.session is not None:
                self._session_touch(req.session)
            # only the uncached tail draws fresh pages from the pool
            self._reserved_unalloc += req.pages_needed - h
            slot = _Slot(req, lens=0, tok=0)
            slot.shared = h
            self._slots[idx] = slot
            for j, p in enumerate(shared):
                self._bt[idx, j] = p
                slot.pages.append(p)
            self._alloc_pages(idx, -(-req.prompt.size // self.page_size))
            self.stats["admitted"] += 1
            if self.tenancy is not None:
                with self._lock:
                    self._queued_dec_locked(req)
                self._note_tenant_admitted(req)
            if req.obs is not None:
                # rid pairs this row's scheduled with its own queued
                req.obs.record("scheduled", rid=req.rid, slot=idx)
            admitted.append((idx, req))
        # back in the queue before any prefill runs: a prefill that
        # raises leaves every waiter where the ticker's failure path
        # finds it
        with self._lock:
            self._pending = requeue + self._pending
        # prompts prefill together in one batched call per bucket of
        # their uncached tail (a warm request's whole prefill); tails
        # longer than prefill_chunk go through the chunked group
        groups = {}
        long_grp = []
        for idx, req in admitted:
            tail = req.prompt.size - self._slots[idx].shared * self.page_size
            if self.prefill_chunk and tail > self.prefill_chunk:
                long_grp.append((idx, req))
                continue
            groups.setdefault(self._bucket(tail), []).append((idx, req))
        if long_grp:
            self._prefill_chunked_group(long_grp)
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

    def _prefill_call(self, rows, with_logits):
        """One batched model call over `rows` of (slot, start, count)
        (with a draft, one draft call over the same rows after it):
        each row's prompt tokens [start, start + count) append to its
        slot's pages at lens = start, at positions from start. Eager
        PyTorch compiles nothing per shape, so the batch is padded only
        to its longest row (writes past n_valid drop into the sink
        page). Returns, for the rows flagged in `with_logits`, the
        logits at each row's last real token (host, f32): the full
        (b, s, vocab) logits are never formed."""
        bw = len(rows)
        width = max(n for _, _, n in rows)
        ids = np.zeros((bw, width), np.int32)
        lens = np.zeros(bw, np.int32)
        nv = np.zeros(bw, np.int32)
        bt = np.zeros((bw, self.max_pages_per_slot), np.int32)
        for r, (idx, start, n) in enumerate(rows):
            ids[r, :n] = self._slots[idx].req.prompt[start:start + n]
            lens[r], nv[r] = start, n
            bt[r] = self._bt[idx]
        dev = self.device
        lens_t = torch.from_numpy(lens).to(dev)
        state = PagedState(torch.from_numpy(bt).to(dev), lens_t,
                           torch.from_numpy(nv).to(dev))
        pos = lens_t[:, None] + torch.arange(width, dtype=torch.int32,
                                             device=dev)[None, :]
        ids_t = torch.from_numpy(ids).to(dev)
        h = self.model.model(ids_t, pos, self.pools, state)
        if self.draft_model is not None:
            # the draft's KV for the same rows (k/v only, no lm_head);
            # shared pages already hold the prefix's draft KV, since
            # both models' pools share the block tables
            self.draft_model.model(ids_t, pos, self.draft_pools, state)
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += int(nv.sum())
        sel = [r for r in range(bw) if with_logits[r]]
        if not sel:
            return {}
        last = h[torch.tensor(sel, device=dev),
                 torch.from_numpy(nv[sel] - 1).to(dev).long()]
        logits_np = self.model.logits(last).float().cpu().numpy()
        return dict(zip(sel, logits_np))

    def _prefilled(self, grp, logits):
        """Each (slot, request) of a finished prefill: its first token,
        its full prompt pages into the prefix cache, then `_accept`."""
        for row, (idx, req) in enumerate(grp):
            slot = self._slots[idx]
            slot.lens = int(req.prompt.size)
            slot.tok = self._first_token(logits[row], req)
            self._prefix_insert(idx, req)
            self._disagg_capture(req)
            self._accept(idx, [slot.tok])

    def _prefill_group(self, grp):
        """Prefill every (slot, request) pair of one tail bucket in ONE
        model call. A warm row (prefix-cache hit) prefills only its
        uncached tail: lens and positions start past the shared pages,
        and the tail attends over their KV through the block table."""
        t0 = time.perf_counter()
        self._note_prefill(grp, "prefill_start")
        rows = []
        for idx, req in grp:
            off = self._slots[idx].shared * self.page_size
            rows.append((idx, off, int(req.prompt.size) - off))
        logits = self._prefill_call(rows, [True] * len(rows))
        self.stats["prefills"] += len(grp)
        self.stats["prefill_s"] += time.perf_counter() - t0
        self._note_prefill(grp, "prefill_end")
        self._prefilled(grp, logits)

    def _prefill_chunked_group(self, grp):
        """Feed long prompts through lockstep rounds of `prefill_chunk`
        tokens, each round one call appending at lens > 0 (a warm row
        starts past its shared pages), so the scores of the attend stay
        (b, hk, g, chunk, L). An exhausted row drops out of later rounds
        (eager PyTorch keeps no static batch shape); only the round
        that consumes a row's last token takes its logits, at
        n_valid - 1."""
        t0 = time.perf_counter()
        self._note_prefill(grp, "prefill_start")
        chunk = self.prefill_chunk
        done = [self._slots[idx].shared * self.page_size for idx, _ in grp]
        plens = [int(req.prompt.size) for _, req in grp]
        final = {}
        while True:
            live = [r for r in range(len(grp)) if done[r] < plens[r]]
            if not live:
                break
            rows, last = [], []
            for r in live:
                take = min(chunk, plens[r] - done[r])
                rows.append((grp[r][0], done[r], take))
                last.append(done[r] + take >= plens[r])
            for j, lg in self._prefill_call(rows, last).items():
                final[live[j]] = lg
            for r, (_, _, take) in zip(live, rows):
                done[r] += take
        self.stats["prefills"] += len(grp)
        self.stats["prefill_s"] += time.perf_counter() - t0
        self._note_prefill(grp, "prefill_end")
        self._prefilled(grp, final)

    @staticmethod
    def _note_prefill(grp, event):
        """A prefill's start or end on each traced row's timeline."""
        for _, req in grp:
            if req.obs is not None:
                req.obs.record(event, rid=req.rid)

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
            if req.obs is not None:
                # the first emission records first_token (TTFT), later
                # ones a tick's tokens (ITL); the row id keys the gap
                # clock, so sibling rows do not read each other's times
                req.obs.record_tokens(len(out), stream=req.rid)
        if finished:
            self._retire(slot_idx)
        return not finished

    def _retire(self, slot_idx, reason=None):
        """Release the slot's pages by refcount and the rest of its
        reservation, and wake its waiter. A page returns to the free
        list (`_recycle_pages`) only when its last referent lets go: a
        page another slot or the prefix cache still holds stays
        allocated, its int8 scales unchanged. `reason` names an abnormal
        end ("error"); a request that finished (no reason, not
        cancelled) counts in stats["finished"]."""
        slot = self._slots[slot_idx]
        req = slot.req
        if reason is None and not req.cancelled.is_set() \
                and req.session is not None:
            # before the release below: the cache refs it adds keep the
            # conversation's pages alive through the slot's unref
            self._session_retain(slot)
        freeable = [p for p in slot.pages if self._unref_page(p)]
        # the unallocated remainder of this slot's reservation (shared
        # pages were neither reserved nor drawn from the free list)
        self._reserved_unalloc -= req.pages_needed - len(slot.pages)
        self._bt[slot_idx, :] = 0
        self._slots[slot_idx] = None
        with self._lock:
            self._inflight -= 1
        cancelled = req.cancelled.is_set()
        if reason is None and not cancelled:
            self.stats["finished"] += 1
        try:
            self._recycle_pages(freeable)
        finally:
            if req.obs is not None:
                req.obs.engine_finish(
                    reason or ("cancelled" if cancelled else "finished"))
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
                proc = _process_logits_rowwise(last, x["temp"], x["topk"],
                                               x["topp"])
                sampled = (proc + self._gumbel(proc.shape)).argmax(
                    dim=-1).to(torch.int32)
                nxt = torch.where(x["wants"], sampled, nxt)
            nxt = torch.where(live, nxt, 0)
            lens = lens + live_i
            cnt = cnt + live_i
            hit_eos = live & (eos >= 0) & (nxt == eos)
            fin = fin | hit_eos | (cnt >= limit)
            tok = nxt
            outs.append(nxt)
        torch.stack(outs + [lens], dim=1, out=self._outputs)

    def _gumbel(self, shape):
        """Gumbel noise drawn from the engine's generator (a captured
        program registers it, so each replay draws anew)."""
        u = torch.rand(shape, generator=self._gen, device=self.device)
        return -torch.log(-torch.log(u.clamp_(min=1e-20)))

    @torch.no_grad()
    def _spec_body(self, any_sample):
        """The spec tick (JAX `_spec_tick_fn`): g draft steps at s = 1 on
        the draft pools, one target verify over the g + 1 candidate
        positions, acceptance on the device, and the draft's KV at
        lens + g for the rows that accepted all g. From the static input
        buffers to the static output buffer ((b, g + 1) tokens, n_emit,
        the final lens), with no read-back, so a CUDA graph can capture
        it. The greedy-only variant sorts nothing and keeps no q rows."""
        x = self._inputs
        tok, lens, active, bt = x["tok"], x["lens"], x["active"], x["bt"]
        temp, topk, topp, wants = x["temp"], x["topk"], x["topp"], \
            x["wants"]
        draft, target, g = self.draft_model, self.model, self.spec_tokens
        live = active.to(torch.int32)
        cur, d_toks, q_rows = tok, [], []
        for j in range(g):
            pos = lens + j
            h = draft.model(cur[:, None], pos[:, None], self.draft_pools,
                            PagedState(bt, pos, live))
            last = draft.logits(h[:, -1])
            nxt = last.argmax(dim=-1).to(torch.int32)
            if any_sample:
                proc = _process_logits_rowwise(last, temp, topk, topp)
                sampled = (proc + self._gumbel(proc.shape)).argmax(
                    dim=-1).to(torch.int32)
                nxt = torch.where(wants, sampled, nxt)
                onehot = torch.zeros_like(proc).scatter_(
                    1, nxt[:, None].long(), 1.0)
                q_rows.append(torch.where(wants[:, None],
                                          torch.softmax(proc, dim=-1),
                                          onehot))
            d_toks.append(nxt)
            cur = nxt
        d = torch.stack(d_toks, dim=1)                         # (b, g)
        ids = torch.cat([tok[:, None], d], dim=1)
        steps = torch.arange(g + 1, dtype=torch.int32, device=tok.device)
        h = target.model(ids, lens[:, None] + steps[None, :], self.pools,
                         PagedState(bt, lens, live * (g + 1)))
        lv = target.logits(h)                               # (b, g + 1, v)
        picks = lv.argmax(dim=-1).to(torch.int32)
        acc = picks[:, :g] == d
        if any_sample:
            b, v = lv.shape[0], lv.shape[-1]
            xt = _process_logits_rowwise(
                lv.reshape(b * (g + 1), v), temp.repeat_interleave(g + 1),
                topk.repeat_interleave(g + 1),
                topp.repeat_interleave(g + 1)).reshape(b, g + 1, v)
            p_rows = torch.softmax(xt, dim=-1)
            q = torch.stack(q_rows, dim=1)                 # (b, g, v)
            p_at = p_rows[:, :g].gather(2, d[..., None].long())[..., 0]
            q_at = q.gather(2, d[..., None].long())[..., 0]
            u = torch.rand(d.shape, generator=self._gen, device=d.device)
            acc = torch.where(wants[:, None],
                              u * q_at.clamp_min(1e-30) < p_at, acc)
        n_acc = acc.to(torch.int32).cumprod(dim=1).sum(dim=1,
                                                       dtype=torch.int32)
        corr = picks.gather(1, n_acc[:, None].long())[:, 0]
        if any_sample:
            # the correction from the residual max(p - q, 0) at row
            # n_acc (the bonus row has q = 0); p where it is empty
            at = n_acc[:, None, None].long().expand(b, 1, v)
            q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
            p_corr = p_rows.gather(1, at)[:, 0]
            res = (p_corr - q_pad.gather(1, at)[:, 0]).clamp_min(0.0)
            has_res = res.sum(dim=-1, keepdim=True) > 1e-30
            res = torch.where(has_res, res, p_corr)
            sampled = (torch.log(res.clamp_min(1e-30))
                       + self._gumbel(res.shape)).argmax(dim=-1)
            corr = torch.where(wants, sampled.to(torch.int32), corr)
        col = steps[None, :]
        padded = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
        out = torch.where(col < n_acc[:, None], padded,
                          torch.where(col == n_acc[:, None], corr[:, None],
                                      0))
        out = torch.where(active[:, None], out, 0)
        n_emit = torch.where(active, n_acc + 1, 0)
        lens_f = lens + live * (1 + n_acc)
        # full acceptance commits lens + g (token d_{g-1}), the one
        # position no draft step wrote: one more draft step writes it,
        # the other rows drop the write (n_valid 0)
        bonus = (active & (n_acc == g)).to(torch.int32)
        draft.model(d[:, g - 1:], (lens + g)[:, None], self.draft_pools,
                    PagedState(bt, lens + g, bonus))
        torch.cat([out, n_emit[:, None], lens_f[:, None]], dim=1,
                  out=self._outputs)

    def _eager_program(self, any_sample):
        """The tick body run eagerly (the spec tick's when a draft is
        set): the CPU's program, and on the card the yardstick the
        captured tick is held against."""
        return functools.partial(getattr(self, self._body_name),
                                 any_sample)

    def _tick_program(self, any_sample):
        """The tick program for this sampling variant: on the card a CUDA
        graph captured at first use and cached under ("tick",
        any_sample), or ("spec_tick", any_sample) with a draft, as the
        JAX engine keys its programs; on the CPU the body itself."""
        if self.device.type != "cuda":
            return self._eager_program(any_sample)
        key = (self._kind, any_sample)
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
        """Warm the tick body (or the spec tick's) up once on a side
        stream, then capture it, both with every slot inactive: each KV
        write of the target's and the draft's then lands in the pools'
        sink page and no live page is touched (int8 pools'
        quantize-at-scatter runs inside the graph). The warm-up's
        launches are real and stay counted; the capture's are taken
        back out and added again by every replay."""
        t0 = time.perf_counter()
        self._idle_inputs()
        if self._graph_pool is None:
            # both variants share one pool: their replays never overlap
            # (one stream, one tick at a time) and no tensor made inside
            # a capture outlives it (the outputs go to `_outputs`)
            self._graph_pool = torch.cuda.graph_pool_handle()
        # a sampled variant's replays draw new Gumbel noise from the
        # engine's generator each time, as an eager tick would
        program = capture_graph(self._eager_program(any_sample), self.device,
                                pool=self._graph_pool,
                                generator=self._gen if any_sample else None)
        self.stats["warmup_ticks"] += 1
        self.stats["warmup_s"] += time.perf_counter() - t0
        return program

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
        if chaos.ENABLED:
            # a slow tick (a congested card, a straggling host), on the
            # host before any replay: stretches TTFT and ITL
            chaos.maybe_delay("engine.tick.delay")
        gone = [i for i, s in enumerate(self._slots)
                if s is not None and s.req.cancelled.is_set()]
        self.stats["cancelled"] += len(gone)
        self._retire_each(gone)
        if self.suspend_after_s is not None:
            self._suspend_sweep()
        admitted = self._admit()
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if not live:
            return admitted > 0
        if self.tenancy is not None:
            self._note_slot_ticks(live)
        if self.draft_model is not None:
            return self._step_spec(live)
        n = self.steps_per_tick
        a, back = self._run_tick(live, n)
        counts = np.minimum(a["limit"], n)
        self._accept_tick(live, back[:, :n], counts, a["eos"], back[:, n])
        return True

    def _run_tick(self, live, ahead):
        """Grow each live slot's pages to cover the next `ahead`
        positions (within its budget), then one run of the tick
        program: one staging copy in, one replay (or eager body), one
        copy of the outputs back. Returns (the slot arrays, the
        outputs on the host)."""
        for i in live:
            slot = self._slots[i]
            budget_tokens = slot.req.prompt.size + slot.req.max_new_tokens
            need = min(slot.lens + ahead, budget_tokens)
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
        if observability.ENABLED:
            observability.inc("inference.decode.kernel",
                              path=self.decode_kernel)
        return a, back

    def _step_spec(self, live):
        """One spec tick (JAX `_step_spec`): greedy and sampled slots
        ride it together. Pages cover lens + g + 1 within the budget;
        each slot takes min(n_emit, its limit) tokens."""
        g = self.spec_tokens
        a, back = self._run_tick(live, g + 1)
        n_emit = back[:, g + 1]
        self.stats["spec_ticks"] += 1
        self.stats["spec_proposed"] += g * len(live)
        self.stats["spec_accepted"] += int(sum(n_emit[i] - 1 for i in live))
        counts = np.minimum(n_emit, a["limit"])
        self._accept_tick(live, back[:, :g + 1], counts, a["eos"],
                          back[:, g + 2])
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
        if self.host_tier is not None:
            # drain and join the spill worker (a later spill starts it
            # again, so stop()/start() cycles keep working)
            self.host_tier.stop()

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
                self._queued_dec_locked(req)
        for req in doomed:
            req.error = error
            if req.obs is not None:
                req.obs.engine_finish("error")
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
        stops decoding for nobody. `deadline`, `tenant` and `session`
        go to each row's submit()."""
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
        # a guard ref across the submission window: the ticker already
        # runs, so a fast first row could retire, dropping the shared
        # context's last ref, before the next row submits. "finished"
        # never beats an abnormal row's reason, so the guard may go last
        guard_ctx = obs_requests.current() if observability.ENABLED \
            else None
        if guard_ctx is not None:
            guard_ctx.adopt_engine()
        reqs = []
        try:
            for r in rows:
                reqs.append(self.submit(
                    r, max_new_tokens, eos_token_id=eos_token_id,
                    do_sample=do_sample, temperature=temperature,
                    top_k=top_k, top_p=top_p, deadline=deadline,
                    tenant=tenant, session=session))
        except BaseException:
            # a later row failed: the rows already submitted would decode
            # on for a caller that got an exception
            for r in reqs:
                r.cancel()
            raise
        finally:
            if guard_ctx is not None:
                guard_ctx.engine_finish("finished")
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
