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
- A decode tick runs `steps_per_tick` steps over every slot. The JAX
  engine fuses them into one `lax.scan` program; here a Python loop
  launches them over tensors that stay on the device (finish mask
  included), and the tick syncs with the host once, at its end.
- Prefill attention is the plain `_attend_pages`; decode attention
  (s == 1) goes through `kernels.paged_attention.paged_decode_attention`
  (the CUDA kernel on the card, its plain twin on the CPU).
- The pools are updated in place (`index_put_`), where the JAX engine
  returns new pools from a functional update and donates the old ones.

Not in this slice (ROADMAP.md lists them): prefix cache, host tier,
disaggregated roles, tenancy, deadlines and overload shedding,
speculative decode, chunked prefill, int8 KV, observability and the
background ticker (`start` / `stream`).
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.kernels.paged_attention import (check_decode_shapes,
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


def _scatter_kv(kp, vp, k, v, state: PagedState):
    """Write this call's (b, s, hk, d) k/v into their pages, in place.

    Each pool holds one page more than block tables address: its last
    page is the sink. Rows past n_valid are written there, where no
    block table points, so they are dropped as the JAX engine drops
    them (`mode="drop"` past the pool) by one unconditional index_put_,
    with no host sync. They never reach page 0, which a caller's block
    table may legitimately hold.
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
    kp[phys, :, off] = k.reshape(b * s, hk, d).to(kp.dtype)
    vp[phys, :, off] = v.reshape(b * s, hk, d).to(vp.dtype)


def _attend_pages(q, kp, vp, state: PagedState):
    """Plain attend over each slot's paged window: gather in f32, mask
    with -1e9, softmax, GQA by reshape (the window is never repeated per
    query head). q: (b, s, hq, d). Returns (b, s, hq*d) in q's type.

    The (b, hk, g, s, L) f32 scores live only for this layer's call."""
    bt, lens = state.block_tables.long(), state.lens.long()
    b, s, hq, d = q.shape
    hk = kp.shape[1]
    g = hq // hk
    pos = lens[:, None] + torch.arange(s, device=q.device)[None, :]
    # window column c IS logical position c, so the causal bound is c <= pos
    ks = kp[bt].permute(0, 2, 1, 3, 4).reshape(b, hk, -1, d).float()
    vs = vp[bt].permute(0, 2, 1, 3, 4).reshape(b, hk, -1, d).float()
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
    cache: (k_pool, v_pool), each (num_pages + 1, hk, page_size, d),
    updated in place; the last page is the sink for dropped writes and no
    block table may name it. Returns (b, s, hq*d) in q's type.
    """
    if len(cache) != 2:
        raise ValueError("cache must be a (k_pool, v_pool) pair; int8 KV "
                         "(scale planes) is not ported yet")
    kp, vp = cache
    b, s, hq, d = q.shape
    _scatter_kv(kp, vp, k, v, state)
    if s == 1:
        # the query position is lens (this token's k/v just landed
        # there); the kernel attends cols <= lens and skips later pages
        out = paged_decode_attention(q[:, 0], kp, vp, state.block_tables,
                                     state.lens)
        return out.to(q.dtype).reshape(b, 1, hq * d)
    return _attend_pages(q, kp, vp, state)


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
    handle."""

    def __init__(self, ids, max_new_tokens, eos_token_id, do_sample,
                 temperature, top_k, top_p, pages_needed, sample_index):
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
        self.tokens: list[int] = []
        self.done = False

    def result(self):
        """The generated tokens; the engine must have finished the
        request (run_until_idle() or step() until done)."""
        if not self.done:
            raise RuntimeError("request unfinished: drive the engine with "
                               "run_until_idle() (or step()) first")
        return list(self.tokens)


class _Slot:
    __slots__ = ("req", "lens", "tok", "pages", "emitted")

    def __init__(self, req, lens, tok):
        self.req = req
        self.lens = int(lens)       # tokens committed to the paged cache
        self.tok = int(tok)         # next decode input (last emitted)
        self.pages: list[int] = []  # physical pages in block-table order
        self.emitted = 0            # generated tokens accepted so far


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
        "bf16" stores bf16 pools.
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
        if kv_dtype not in (None, "bf16"):
            raise ValueError(f"kv_dtype must be None or 'bf16' (got "
                             f"{kv_dtype!r}; int8 KV is not ported yet)")
        self.kv_dtype = kv_dtype
        pool_dtype = torch.bfloat16 if kv_dtype == "bf16" else model.dtype
        n_kv, hd = cfg.num_key_value_heads, cfg.head_dim
        if mdev.type == "cuda":      # the CPU twin takes any geometry
            check_decode_shapes(cfg.num_attention_heads, n_kv, hd,
                                self.page_size)
        shape = (self.num_pages + 1, n_kv, self.page_size, hd)   # + sink
        self.pools = [(torch.zeros(shape, dtype=pool_dtype, device=mdev),
                       torch.zeros(shape, dtype=pool_dtype, device=mdev))
                      for _ in range(cfg.num_hidden_layers)]
        self._free = list(range(self.num_pages - 1, 0, -1))   # 0 = trash
        # pages promised to admitted slots but not yet popped from the
        # free list; admission headroom = len(_free) - _reserved_unalloc
        self._reserved_unalloc = 0
        self._slots: list[_Slot | None] = [None] * self.max_slots
        self._bt = np.zeros((self.max_slots, self.max_pages_per_slot),
                            np.int32)
        self._pending: list[_Request] = []
        self._seed = int(seed)
        self._submitted = 0
        self._gen = torch.Generator(device=mdev).manual_seed(self._seed)
        self.stats = {"ticks": 0, "prefills": 0, "tokens_out": 0,
                      "admitted": 0, "finished": 0, "prefill_s": 0.0,
                      "tick_s": 0.0, "prefill_tokens": 0,
                      "decode_tokens": 0}

    def kv_bytes_per_slot(self):
        """Device bytes one fully grown slot pins across every layer's KV
        pools, from the real buffer types."""
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
        req = _Request(ids, max_new_tokens, eos_token_id, do_sample,
                       temperature, top_k, top_p, pages, self._submitted)
        self._submitted += 1
        self._pending.append(req)
        return req

    def has_work(self):
        return bool(self._pending) or any(s is not None for s in self._slots)

    # -- scheduling core -------------------------------------------------
    def _bucket(self, n):
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
        pending, self._pending = self._pending, []
        requeue = []
        admitted = []
        for req in pending:
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
        # same-bucket prompts prefill together in one batched call
        groups = {}
        for idx, req in admitted:
            groups.setdefault(self._bucket(req.prompt.size),
                              []).append((idx, req))
        for grp in groups.values():
            self._prefill_group(grp)
        self._pending = requeue + self._pending
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
        if finished:
            self._retire(slot_idx)
        return not finished

    def _retire(self, slot_idx):
        slot = self._slots[slot_idx]
        self._free.extend(reversed(slot.pages))
        # release the unallocated remainder of this slot's reservation
        self._reserved_unalloc -= slot.req.pages_needed - len(slot.pages)
        self._bt[slot_idx, :] = 0
        self._slots[slot_idx] = None
        self.stats["finished"] += 1
        slot.req.done = True

    def _slot_arrays(self, live):
        b = self.max_slots
        arrs = dict(tok=np.zeros(b, np.int32),
                    lens=np.zeros(b, np.int32),
                    active=np.zeros(b, bool),
                    limit=np.zeros(b, np.int32),
                    eos=np.full(b, -1, np.int32),
                    temp=np.ones(b, np.float32),
                    topk=np.zeros(b, np.int32),
                    topp=np.ones(b, np.float32),
                    wants=np.zeros(b, bool))
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

    def _decode_tick(self, a):
        """`steps_per_tick` decode steps over every slot. Everything in
        the loop stays on the device — the finish mask too — and the
        tick reads back tokens and lengths with one sync at its end.
        Returns (tokens (b, n), lens (b,)) as numpy."""
        dev = self.device
        dt = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        tok, lens, active = dt["tok"], dt["lens"], dt["active"]
        limit, eos = dt["limit"], dt["eos"]
        any_sample = bool(a["wants"].any())
        bt = torch.from_numpy(self._bt).to(dev)
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
                u = torch.rand(last.shape, generator=self._gen, device=dev)
                gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
                proc = _process_logits_rowwise(last, dt["temp"], dt["topk"],
                                               dt["topp"])
                sampled = (proc + gumbel).argmax(dim=-1).to(torch.int32)
                nxt = torch.where(dt["wants"], sampled, nxt)
            nxt = torch.where(live, nxt, 0)
            lens = lens + live_i
            cnt = cnt + live_i
            hit_eos = live & (eos >= 0) & (nxt == eos)
            fin = fin | hit_eos | (cnt >= limit)
            tok = nxt
            outs.append(nxt)
        back = torch.cat([torch.stack(outs, dim=1), lens[:, None]],
                         dim=1).cpu().numpy()
        return back[:, :-1], back[:, -1]

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
        """One scheduler tick: admit pending requests (prefill), then one
        multi-step decode over every live slot. Returns True if any work
        was done — an admission counts, even when every admitted request
        finished in its prefill and left nothing to decode."""
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
        t0 = time.perf_counter()
        toks_np, lens_np = self._decode_tick(a)
        self.stats["ticks"] += 1
        self.stats["tick_s"] += time.perf_counter() - t0
        counts = np.minimum(a["limit"], n)
        self._accept_tick(live, toks_np, counts, a["eos"], lens_np)
        return True

    def run_until_idle(self):
        """Drain every pending and active request."""
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
