"""Autoregressive generation with a static KV cache, in PyTorch.

Counterpart of paddle_tpu/models/generation.py (PaddleNLP's
GenerationMixin surface: greedy and sampled decode with temperature,
top-k and top-p, eos, `attention_mask`, `use_cache`, `tokens_per_fetch`,
and speculative decoding), without the exported generation bundle. The
design is the JAX module's:

- The KV cache is a fixed-size (batch, max_len, kv_heads, head_dim)
  buffer per layer, written in place at a position index that stays on
  the device (`kv_cache_update`), so the decode step has one shape for
  every generated token.
- Sampling parameters enter the decode programs as 0-d device tensors,
  so one program serves every (temperature, top_k, top_p). Per-token
  sampling noise is Gumbel noise drawn on the host from
  np.random.RandomState(seed) in the JAX module's order, so a seeded
  per-token stream draws the JAX module's numbers.
- Prompt padding: `attention_mask` (batch, prompt_len), 1 = real token,
  LEFT padding. RoPE positions derive from it on the device (cumsum -
  1), so a padded batch generates what each row generates alone.
- The programs of one (batch, max_len, cache type, do_sample) are one
  entry of an LRU kept in the model's __dict__, so they die with the
  model. An entry owns the static device buffers its programs run over:
  the KV buffers, the token and index, the keep mask over every cache
  slot, the noise and the sampling scalars; a prompt's length enters
  only through the keep mask and the index, so prompts of every length
  with one max_len share an entry. The LRU holds at most 32 entries and
  at most `_GEN_CACHE_BYTES` of their buffers and graph pools, the
  newest entry always (where the JAX module keeps only compiled
  programs, an entry here keeps its KV buffers). On the card, prefill
  runs eagerly (its shape changes with each prompt) and writes the
  entry's KV buffers; the per-token decode step and the
  `tokens_per_fetch` block are each one captured CUDA graph, warmed up
  and captured at first use with inputs that write only the buffers'
  last slot. A capture that fails raises. On the CPU the same bodies
  run eagerly over the same buffers. A stream that finds its entry in
  use by another stream runs on an entry of its own.
- The block runs `tokens_per_fetch` decode steps in one program, so one
  host round trip fetches them: the counterpart of the JAX module's
  `lax.while_loop`. A graph has no early exit, so every step runs, but
  a step changes the state only while the JAX loop's condition holds
  (step < limit and some row unfinished); the others write their k/v
  into the buffer's last slot, max_len - 1, which no step reads (the
  last decode step writes max_len - 2). `n_done` counts the steps that
  changed the state, as the JAX loop counts its iterations. Sampled
  blocks draw Gumbel noise on the device from a torch.Generator seeded
  from the stream's rng and registered with the graph: seed-
  deterministic and another stream than tokens_per_fetch=1, as in JAX.
- `generate_speculative` runs eagerly, at batch 1.

Models opt in by accepting `caches=`/`cache_index=` in forward and
returning (logits, caches) for dense buffers (models/llama.py does).
Other models generate through the full-recompute path
(`use_cache=False`).
"""
from __future__ import annotations

import functools
import inspect
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from paddle_tpu_torch.core.graphs import capture_graph

__all__ = ["init_kv_cache", "kv_cache_update", "process_logits",
           "generate", "generate_stream", "generate_speculative"]

# programs kept per model (the JAX module reads this cap from an
# environment variable; the port keeps its default), and the bytes their
# entries may hold together
_GEN_CACHE_CAP = 32
_GEN_CACHE_BYTES = 8 << 30


def kv_cache_update(buf, new, index):
    """Write `new` (b, s, h, d) into the cache buffer (b, max_len, h, d)
    at positions index .. index + s - 1, in place. `index` is an int or a
    0-d tensor, read on the buffer's device, not on the host. Returns
    `buf`."""
    pos = torch.arange(new.shape[1], device=buf.device) + index
    return buf.index_copy_(1, pos.long(), new.to(buf.dtype))


def _model_device(model):
    dev = getattr(model, "device", None)
    if isinstance(dev, torch.device):
        return dev
    return next(iter(model.parameters())).device


def _model_dtype(model):
    """The model's compute type: `model.dtype` where it has one (a W8A16
    model's first parameter can be int8), else its first floating
    parameter's type."""
    dt = getattr(model, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt
    return next(p.dtype for p in model.parameters() if p.is_floating_point())


def init_kv_cache(model, batch_size, max_len, dtype=None):
    """Per-layer (k, v) zero buffers (batch_size, max_len, kv_heads,
    head_dim) for `model` (a CausalLM with .config holding
    num_hidden_layers / num_key_value_heads / head_dim), on its device,
    in its compute type unless `dtype` is given."""
    cfg = model.config
    n_kv = getattr(cfg, "num_key_value_heads", None) \
        or cfg.num_attention_heads
    hd = getattr(cfg, "head_dim", None) \
        or cfg.hidden_size // cfg.num_attention_heads
    dtype = dtype or _model_dtype(model)
    dev = _model_device(model)
    shape = (batch_size, max_len, n_kv, hd)
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(cfg.num_hidden_layers)]


def process_logits(logits, temperature=1.0, top_k=0, top_p=1.0):
    """The logits pipeline (temperature, top-k, top-p) with Python
    parameters, for (b, v) logits. Filtered entries become -1e9, so
    Gumbel-max never picks them. The decode programs use
    `_process_logits_traced`, whose parameters are device tensors."""
    if temperature != 1.0:
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        logits = logits / float(temperature)
    v = logits.shape[-1]
    if top_k and 0 < top_k < v:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]   # (b, 1)
        logits = torch.where(logits < kth, torch.full_like(logits, -1e9),
                             logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the smallest prefix with cumulative probability >= top_p (the
        # top-1 token always stays); the threshold is its smallest logit
        keep_sorted = cum - probs < top_p
        thresh = torch.where(keep_sorted, sorted_logits, float("inf")) \
            .amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, torch.full_like(logits, -1e9),
                             logits)
    return logits


def _process_logits_traced(logits, temperature, top_k, top_p):
    """`process_logits` with 0-d device tensors for temperature, top_k
    and top_p, and no host sync, so one program serves every sampling
    configuration. Each filter switches itself off on the device: top_k
    <= 0 or >= v, top_p >= 1. f32 result."""
    x = logits.float() / temperature
    b, v = x.shape
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    kk = top_k.long().clamp(1, v)
    kth = sorted_desc.gather(1, (kk - 1).reshape(1, 1).expand(b, 1))
    use_k = (top_k > 0) & (top_k < v)
    kth = torch.where(use_k, kth, float("-inf"))
    x = torch.where(x < kth, -1e9, x)
    # top-p over the top-k-masked logits, the order of process_logits
    sorted_p = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(sorted_p, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < top_p
    thresh = torch.where(keep_sorted, sorted_p, float("inf")).amin(
        dim=-1, keepdim=True)
    thresh = torch.where(top_p < 1.0, thresh, float("-inf"))
    return torch.where(x < thresh, -1e9, x)


def _select_token(logits, do_sample, temperature, top_k, top_p, noise):
    """(b, v) logits -> (b,) int32 ids with Python sampling parameters
    (the recompute path): Gumbel-max over the processed logits."""
    if do_sample:
        logits = process_logits(logits, temperature, top_k, top_p) + noise
    return logits.argmax(dim=-1).to(torch.int32)


def _select_traced(logits, do_sample, samp):
    """Token selection inside a program. samp = () for greedy, else
    (noise, temperature, top_k, top_p) device tensors."""
    if not do_sample:
        return logits.argmax(dim=-1).to(torch.int32)
    noise, temp, topk, topp = samp
    x = _process_logits_traced(logits, temp, topk, topp)
    return (x + noise).argmax(dim=-1).to(torch.int32)


def _accepts(model, name):
    try:
        sig = inspect.signature(type(model).forward)
    except (TypeError, ValueError):
        return False
    return name in sig.parameters


def _model_supports_cache(model):
    return _accepts(model, "caches")


def _mask_capable(model):
    return _accepts(model, "attn_mask") and _accepts(model, "position_ids")


def _gumbel(rng, shape):
    u = rng.uniform(1e-9, 1.0, size=shape).astype("float32")
    return -np.log(-np.log(u))


def _device_gumbel(gen, shape, device):
    """Gumbel noise drawn on the device from `gen` (the sampled block)."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_(min=1e-9)))


def _norm_attention_mask(attention_mask, b, s):
    """-> numpy bool (b, s) keep-mask, or None when no mask was given.
    Takes a tensor or an array-like of 1/0 or bool. LEFT padding is the
    supported layout for cached decode (every row then ends at the same
    cache slot)."""
    if attention_mask is None:
        return None
    m = attention_mask.cpu().numpy() if isinstance(
        attention_mask, torch.Tensor) else np.asarray(attention_mask)
    if m.shape != (b, s):
        raise ValueError(f"attention_mask must be (batch, prompt_len) = "
                         f"({b}, {s}), got {m.shape}")
    m = m.astype(bool)
    if not m[:, -1].all():
        raise ValueError(
            "attention_mask must be LEFT-padded (every row's last prompt "
            "position real): decode positions and the final-logit select "
            "assume rows end at the same slot. Right-padded rows would "
            "generate from a pad embedding. Re-pad on the left.")
    return m


def _graph_mask(keep):
    """(b, max_len) bool keep over the cache slots, the prompt's mask
    followed by ones (generated slots are always real) -> the attention
    mask (b, 1, 1, max_len), on the device."""
    return keep.reshape(keep.shape[0], 1, 1, keep.shape[1])


def _as_ids(input_ids):
    if isinstance(input_ids, torch.Tensor):
        return input_ids
    return torch.from_numpy(np.asarray(input_ids, "int32"))


def generate_stream(model, input_ids, max_new_tokens=32, *,
                    attention_mask=None, eos_token_id=None, pad_token_id=0,
                    do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                    use_cache=True, seed=None, tokens_per_fetch=1):
    """Yield one (batch,) numpy int32 array of token ids per generated
    position. Sequences that hit `eos_token_id` keep yielding
    `pad_token_id`; the stream ends early once every sequence finished.
    The serving /generate endpoint streams from this iterator.

    attention_mask: (batch, prompt_len) 1/0 prompt padding mask (LEFT
    padding). tokens_per_fetch > 1 runs that many decode steps in one
    program per host round trip (module doc): greedy block decode emits
    the per-token stream; sampled block decode draws its noise on the
    device, seed-deterministic but another stream than
    tokens_per_fetch=1."""
    ids = _as_ids(input_ids)
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError("input_ids must be integer ids, got "
                         f"{str(ids.dtype).replace('torch.', '')}")
    b, s = ids.shape[0], ids.shape[1]
    if max_new_tokens <= 0:
        return                      # a 0-token request streams nothing
    if do_sample and temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    keep_np = _norm_attention_mask(attention_mask, b, s)
    rng = np.random.RandomState(seed)
    use_cache = use_cache and _model_supports_cache(model)

    was_training = getattr(model, "training", False)
    model.eval()
    try:
        if use_cache:
            yield from _stream_cached(
                model, ids, b, s, max_new_tokens, eos_token_id,
                pad_token_id, do_sample, temperature, top_k, top_p, rng,
                keep_np, tokens_per_fetch)
        else:
            yield from _stream_recompute(
                model, ids, b, s, max_new_tokens, eos_token_id,
                pad_token_id, do_sample, temperature, top_k, top_p, rng,
                keep_np)
    finally:
        if was_training:
            model.train()


def _finish_step(tok, finished, eos_token_id, pad_token_id):
    """Host-side eos bookkeeping: returns (emitted tokens, finished)."""
    if eos_token_id is None:
        return tok, finished
    tok = np.where(finished, pad_token_id, tok)
    finished = finished | (tok == eos_token_id)
    return tok, finished


def _gen_cache_get(model, key, build):
    """The model's LRU of programs (module doc), under a lock of its own:
    streams on other threads look up and evict together. Entries are
    sized at each lookup, since their graphs are captured after they
    enter; a stream still running on an evicted entry keeps it alive
    until it ends."""
    lock = model.__dict__.setdefault("_gen_step_lock", threading.Lock())
    with lock:
        cache = model.__dict__.setdefault("_gen_step_cache", OrderedDict())
        if key in cache:
            cache.move_to_end(key)
        else:
            cache[key] = build()
        held = sum(e.nbytes() for e in cache.values())
        while len(cache) > _GEN_CACHE_CAP or (
                len(cache) > 1 and held > _GEN_CACHE_BYTES):
            held -= cache.popitem(last=False)[1].nbytes()
        return cache[key]


# -- the step bodies ----------------------------------------------------------

def _prefill_logits(model, s, masked, ids, keep, caches):
    """Prefill the prompt (b, s) into `caches` at slot 0; -> the last
    position's logits (b, v). `keep` (b, max_len) bool covers every cache
    slot (`_graph_mask`); RoPE positions derive from it."""
    zero = torch.zeros((), dtype=torch.int32, device=ids.device)
    if masked:
        attn = _graph_mask(keep)
        posids = (torch.cumsum(keep[:, :s].to(torch.int32), dim=1,
                               dtype=torch.int32) - 1).clamp(0, s)
        logits, _ = model(ids, caches=caches, attn_mask=attn,
                          position_ids=posids, cache_index=zero)
    else:
        posids = torch.arange(s, dtype=torch.int32, device=ids.device)[None]
        logits, _ = model(ids, caches=caches, position_ids=posids,
                          cache_index=zero)
    return logits[:, -1]


def _prefill_fn(model, s, do_sample, masked, ids, keep, caches, samp):
    """Prefill (`_prefill_logits`); -> (b,) int32 first tokens."""
    return _select_traced(_prefill_logits(model, s, masked, ids, keep,
                                          caches), do_sample, samp)


def _step_logits(model, b, masked, tok, index, keep, caches):
    """The logits (b, v) of one decode step: `tok` (b,) enters the cache
    at the 0-d `index`. A padded row's position is its real tokens so
    far, the kept slots below `index` (the JAX module's n_real + (index -
    s), generated slots being real). A finished row feeds
    `pad_token_id`, which may lie outside the vocabulary: it is clamped
    into it, as the JAX gather clamps, and the row's output is replaced
    by pad anyway."""
    tok = tok.clamp(0, model.config.vocab_size - 1)
    if masked:
        attn = _graph_mask(keep)
        below = torch.arange(keep.shape[1], device=keep.device) < index
        pos = (keep & below).sum(dim=1, dtype=torch.int32).reshape(b, 1)
        logits, _ = model(tok.reshape(b, 1), caches=caches, attn_mask=attn,
                          position_ids=pos, cache_index=index)
    else:
        logits, _ = model(tok.reshape(b, 1), caches=caches,
                          position_ids=index.reshape(1, 1),
                          cache_index=index)
    return logits[:, -1]


def _decode_fn(model, b, do_sample, masked, tok, index, keep, caches, samp):
    """One decode step: `tok` (b,) enters the cache at the 0-d `index`;
    -> (b,) int32 next tokens."""
    return _select_traced(_step_logits(model, b, masked, tok, index, keep,
                                       caches), do_sample, samp)


def _block_fn(model, b, n_steps, do_sample, masked, tok, index0, limit,
              keep, caches, fin, eos, pad, samp, gen):
    """`n_steps` decode steps (module doc), the JAX `_block_impl`. tok
    (b,) int32, fin (b,) bool; index0, limit, eos (< 0: none) and pad
    0-d int32 tensors; samp the sampling scalars (temperature, top_k,
    top_p), gen the noise's generator. -> (out (b, n_steps) int32, pad
    past n_done; n_done () int32; fin (b,); tok (b,), the last emitted
    token)."""
    max_len = caches[0][0].shape[1]
    running = torch.ones((), dtype=torch.bool, device=tok.device)
    n_done = torch.zeros((), dtype=torch.int32, device=tok.device)
    has_eos = eos >= 0
    cols = []
    for i in range(n_steps):
        # the JAX loop's condition, at the top of step i; once false it
        # stays false (fin does not change while it is)
        running = running & (limit > i) & ~fin.all()
        # a step that does not run writes the last slot, which no step
        # reads: the tail block would otherwise write past max_len
        index = (index0 + i).clamp(max=max_len - 1)
        x = _step_logits(model, b, masked, tok, index, keep, caches)
        if do_sample:
            x = _process_logits_traced(x, *samp)
            x = x + _device_gumbel(gen, x.shape, x.device)
        nxt = torch.where(fin, pad, x.argmax(dim=-1).to(torch.int32))
        newfin = fin | (has_eos & (nxt == eos))
        cols.append(torch.where(running, nxt, pad))
        tok = torch.where(running, nxt, tok)
        fin = torch.where(running, newfin, fin)
        n_done = n_done + running.to(torch.int32)
    return torch.stack(cols, dim=1), n_done, fin, tok


# -- the programs of one shape ------------------------------------------------

class _Steps:
    """The prefill, decode and block programs of one (batch, max_len,
    cache type, do_sample) and the static device buffers they run over
    (module doc). `programs` maps "decode" and ("block", n) to
    the program: a CapturedProgram on the card, the eager body on the
    CPU. `stats`: the prefills, the decode steps run per token, the
    steps the block programs ran (n a run, whether a step changed the
    state or not) and the steps the warm-ups ran, whose launches are
    real (so the model calls are their sum), and each capture's
    seconds, warm-up included."""

    def __init__(self, model, b, max_len, do_sample):
        self.model = model
        self.b, self.max_len = b, max_len
        self.do_sample = do_sample
        self.masked = _mask_capable(model)
        self.device = dev = _model_device(model)
        self.caches = init_kv_cache(model, b, max_len)
        self.keep = torch.ones((b, max_len), dtype=torch.bool, device=dev)
        # temperature, top_k, top_p
        self.samp = (torch.ones((), device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev),
                     torch.ones((), device=dev))
        self.noise = (torch.zeros((b, model.config.vocab_size), device=dev)
                      if do_sample else None)
        # decode: [index, tokens...] in, the next tokens out
        self.step_in = torch.zeros(b + 1, dtype=torch.int32, device=dev)
        self.step_out = torch.zeros(b, dtype=torch.int32, device=dev)
        # block n: [index0, limit, eos, pad, tokens..., fin...] in;
        # [tokens (n) | fin | last token | n_done] a row out
        self.block_io = {}
        self.gen = torch.Generator(device=dev)
        self.programs = {}
        self.stats = {"prefills": 0, "decode_steps": 0, "block_steps": 0,
                      "warmup_steps": 0, "capture_s": {}}
        self.lock = threading.Lock()

    def nbytes(self):
        """Bytes this entry holds: its static buffers (the KV buffers
        first of all) and its graphs' pools. A stream on another thread
        may add a program meanwhile, so the dicts are copied first."""
        bufs = [t for kv in self.caches for t in kv]
        bufs += [self.keep, *self.samp, self.step_in, self.step_out]
        bufs += [t for io in list(self.block_io.values()) for t in io]
        if self.noise is not None:
            bufs.append(self.noise)
        return sum(t.numel() * t.element_size() for t in bufs) + sum(
            getattr(p, "pool_bytes", 0) for p in list(self.programs.values()))

    def start(self, keep_np, temperature, top_k, top_p):
        """A new stream: its prompt's keep mask (b, s) and sampling
        parameters. The slots past the prompt are kept."""
        s = keep_np.shape[1]
        keep = np.ones((self.b, self.max_len), bool)
        keep[:, :s] = keep_np
        self.keep.copy_(torch.from_numpy(keep))
        if self.do_sample:
            for t, v in zip(self.samp, (temperature, top_k, top_p)):
                t.fill_(v)

    def _samp(self):
        return (self.noise, *self.samp) if self.do_sample else ()

    @torch.no_grad()
    def prefill(self, ids, noise):
        """The prompt into freshly zeroed buffers (eager); -> the first
        tokens, numpy (b,)."""
        for k, v in self.caches:
            k.zero_()
            v.zero_()
        if noise is not None:
            self.noise.copy_(torch.from_numpy(noise))
        tok = _prefill_fn(self.model, ids.shape[1], self.do_sample,
                          self.masked, ids.to(self.device), self.keep,
                          self.caches, self._samp())
        self.stats["prefills"] += 1
        return tok.cpu().numpy()

    def _decode_body(self):
        self.step_out.copy_(_decode_fn(
            self.model, self.b, self.do_sample, self.masked,
            self.step_in[1:], self.step_in[0], self.keep, self.caches,
            self._samp()))

    def _idle_decode(self):
        self.step_in.zero_()
        self.step_in[0] = self.max_len - 1
        if self.noise is not None:
            self.noise.zero_()
        return 1

    @torch.no_grad()
    def decode(self, tok, index, noise):
        """One decode step: tokens `tok` (numpy (b,)) at cache position
        `index`; -> the next tokens, numpy (b,)."""
        program = self._program("decode", self._decode_body,
                                self._idle_decode)
        self.step_in.copy_(torch.from_numpy(
            np.concatenate([[index], tok]).astype(np.int32)))
        if noise is not None:
            self.noise.copy_(torch.from_numpy(noise))
        program()
        self.stats["decode_steps"] += 1
        # a copy: on the CPU, .cpu() would hand out the static buffer
        return self.step_out.to("cpu", copy=True).numpy()

    def _block_body(self, n):
        inp, out = self.block_io[n]
        b = self.b
        toks, n_done, fin, tok = _block_fn(
            self.model, b, n, self.do_sample, self.masked,
            inp[4:4 + b], inp[0], inp[1], self.keep, self.caches,
            inp[4 + b:].bool(), inp[2], inp[3], self.samp, self.gen)
        out.copy_(torch.cat([toks, fin[:, None].to(torch.int32),
                             tok[:, None], n_done.expand(b, 1)], dim=1))

    def _idle_block(self, n):
        # limit 0: no step runs, and every write lands in the last slot
        inp = self.block_io[n][0]
        inp.zero_()
        inp[0] = self.max_len - 1
        inp[4 + self.b:] = 1
        return n

    @torch.no_grad()
    def block(self, n):
        """The n-step block program, captured at first use on the card
        (the stream seeds `gen` after this, so a capture's warm-up draws
        do not shift a seeded stream)."""
        if n not in self.block_io:
            dev, b = self.device, self.b
            self.block_io[n] = (
                torch.zeros(2 * b + 4, dtype=torch.int32, device=dev),
                torch.zeros((b, n + 3), dtype=torch.int32, device=dev))
        return self._program(("block", n),
                             functools.partial(self._block_body, n),
                             functools.partial(self._idle_block, n))

    @torch.no_grad()
    def run_block(self, n, tok, index0, limit, fin, eos, pad):
        """One block from numpy state -> (out (b, n), n_done, fin, tok),
        numpy: one copy in, one program run, one copy out."""
        program = self.block(n)
        inp, out = self.block_io[n]
        inp.copy_(torch.from_numpy(np.concatenate(
            [[index0, limit, eos, pad], tok, fin]).astype(np.int32)))
        program()
        self.stats["block_steps"] += n
        o = out.to("cpu", copy=True).numpy()
        return o[:, :n], int(o[0, n + 2]), o[:, n].astype(bool), o[:, n + 1]

    def _program(self, key, body, idle):
        program = self.programs.get(key)
        if program is not None:
            return program
        if self.device.type != "cuda":
            program = body
        else:
            t0 = time.perf_counter()
            self.stats["warmup_steps"] += idle()
            sampled_block = self.do_sample and key != "decode"
            program = capture_graph(
                body, self.device,
                generator=self.gen if sampled_block else None)
            self.stats["capture_s"][key] = time.perf_counter() - t0
        self.programs[key] = program
        return program


def _compiled_steps(model, b, max_len, do_sample):
    """The cached `_Steps` entry of this shape (module doc)."""
    key = ("steps", b, max_len, _model_dtype(model), str(
        _model_device(model)), do_sample)
    return _gen_cache_get(model, key, lambda: _Steps(model, b, max_len,
                                                     do_sample))


def _stream_cached(model, ids, b, s, max_new_tokens, eos_token_id,
                   pad_token_id, do_sample, temperature, top_k, top_p, rng,
                   keep_np, tokens_per_fetch):
    if keep_np is not None and keep_np.all():
        keep_np = None              # an all-ones mask is no mask
    if keep_np is not None and not _mask_capable(model):
        raise ValueError(
            f"{type(model).__name__} accepts caches= but not attn_mask=/"
            "position_ids=; attention_mask needs both (or use "
            "use_cache=False)")
    max_len = s + max_new_tokens
    steps = _compiled_steps(model, b, max_len, do_sample)
    if not steps.lock.acquire(blocking=False):
        # another stream runs on the cached entry's buffers
        steps = _Steps(model, b, max_len, do_sample)
        steps.lock.acquire()
    try:
        steps.start(keep_np if keep_np is not None else np.ones((b, s), bool),
                    temperature, top_k, top_p)
        vocab = model.config.vocab_size

        def noise():
            return _gumbel(rng, (b, vocab)) if do_sample else None

        tok = steps.prefill(ids, noise()).astype("int32")
        finished = np.zeros((b,), bool)
        tok, finished = _finish_step(tok, finished, eos_token_id,
                                     pad_token_id)
        yield tok

        block = int(tokens_per_fetch or 1)
        if block > 1:
            steps.block(block)
            if do_sample:
                # one seed a stream, drawn where the JAX module draws
                # its block key
                steps.gen.manual_seed(int(rng.randint(0, 2 ** 31 - 1)))
            eos = -1 if eos_token_id is None else int(eos_token_id)
            produced = 1
            while produced < max_new_tokens and not finished.all():
                limit = min(block, max_new_tokens - produced)
                outb, n_done, finished, tok = steps.run_block(
                    block, tok, s + produced - 1, limit, finished, eos,
                    int(pad_token_id))
                for j in range(n_done):
                    yield outb[:, j]
                produced += n_done
                if n_done == 0:     # every row had already finished
                    return
            return

        for step in range(1, max_new_tokens):
            if finished.all():
                return
            tok = steps.decode(tok, s + step - 1, noise())
            tok, finished = _finish_step(tok, finished, eos_token_id,
                                         pad_token_id)
            yield tok
    finally:
        steps.lock.release()


def _stream_recompute(model, ids, b, s, max_new_tokens, eos_token_id,
                      pad_token_id, do_sample, temperature, top_k, top_p,
                      rng, keep_np):
    """Cache-less path: the full prefix again per token. Works with any
    CausalLM forward(input_ids) -> logits; the correctness and
    compatibility path, not the serving path. attention_mask needs a
    model that accepts attn_mask= (a combined causal and padding keep
    mask is passed)."""
    masked = keep_np is not None and not keep_np.all()
    if masked and not _accepts(model, "attn_mask"):
        raise ValueError(
            f"{type(model).__name__} does not accept attn_mask=; "
            "cannot honor attention_mask on the recompute path")
    dev = _model_device(model)
    cur = ids.to(dev)
    finished = np.zeros((b,), bool)
    for _ in range(max_new_tokens):
        if finished.all():
            return
        kwargs = {}
        if masked:
            cl = cur.shape[1]
            kf = np.concatenate(
                [keep_np, np.ones((b, cl - s), bool)], axis=1)
            causal = np.tril(np.ones((cl, cl), bool))
            kwargs["attn_mask"] = torch.from_numpy(
                causal[None, None] & kf[:, None, None, :]).to(dev)
            if _accepts(model, "position_ids"):
                kwargs["position_ids"] = torch.from_numpy(
                    np.maximum(np.cumsum(kf, 1) - 1, 0).astype("int32")) \
                    .to(dev)
        with torch.no_grad():
            logits = model(cur, **kwargs)
            if isinstance(logits, tuple):
                logits = logits[-1]
            last = logits[:, -1]
            noise = torch.from_numpy(_gumbel(rng, tuple(last.shape))).to(dev)
            tok = _select_token(last, do_sample, temperature, top_k, top_p,
                                noise).cpu().numpy()
        tok, finished = _finish_step(tok, finished, eos_token_id,
                                     pad_token_id)
        yield tok
        cur = torch.cat([cur, torch.from_numpy(tok.reshape(b, 1)).to(
            device=dev, dtype=cur.dtype)], dim=1)


def generate(model, input_ids, max_new_tokens=32, **kwargs):
    """Batch generation: an int32 CPU tensor (batch, prompt_len +
    n_generated) of prompt and generated ids (n_generated <
    max_new_tokens when every sequence hits eos early). Keyword
    arguments as in generate_stream."""
    ids = _as_ids(input_ids)
    steps = list(generate_stream(model, ids, max_new_tokens, **kwargs))
    prompt = ids.cpu().numpy().astype("int32")
    if not steps:
        return torch.from_numpy(prompt)
    gen = np.stack(steps, axis=1).astype("int32")
    return torch.from_numpy(np.concatenate([prompt, gen], axis=1))


# -- speculative decoding -----------------------------------------------------

def generate_speculative(target, draft, input_ids, max_new_tokens=32, *,
                         num_speculative_tokens=4, eos_token_id=None,
                         do_sample=False, temperature=1.0, top_k=0,
                         top_p=1.0, seed=None, stats=None):
    """Speculative decoding (the JAX `generate_speculative`; Leviathan et
    al. 2211.17192): the DRAFT proposes `num_speculative_tokens` tokens
    one by one, the TARGET scores the block in one cached forward and
    accepts a prefix.

    Greedy: the longest prefix matching the target's own argmax, then
    the target's correction or bonus token, so the output is the
    target's greedy continuation. Sampled: rejection sampling (accept x_i
    with probability min(1, p_i(x_i) / q_i(x_i)), resample from
    norm(max(p - q, 0)) at the first rejection, a bonus from p when all
    pass), which samples the target's processed distribution exactly;
    the test and the resample run on the device, and only the accepted
    count and the emitted token reach the host. Stale cache slots of
    rejected proposals stay hidden by the position mask until a later
    write. Eager, batch 1. Returns int32 ids (1, prompt + generated);
    pass a dict as `stats` for {'target_forwards', 'generated',
    'accepted_drafts'}."""
    ids = _as_ids(input_ids)
    b, s = ids.shape[0], ids.shape[1]
    if b != 1:
        raise ValueError("speculative decoding is batch-1 "
                         f"(got batch {b}); rows diverge in acceptance")
    g = int(num_speculative_tokens)
    if g < 1:
        raise ValueError("num_speculative_tokens must be >= 1")
    if not (_model_supports_cache(target) and _model_supports_cache(draft)):
        raise ValueError("both target and draft need KV-cache support")
    if do_sample and temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    prompt = ids.cpu().numpy().astype("int32")
    if max_new_tokens <= 0:
        return torch.from_numpy(prompt)
    rng = np.random.RandomState(seed)

    was_t, was_d = getattr(target, "training", False), \
        getattr(draft, "training", False)
    target.eval()
    draft.eval()
    n_target_fwd = 0
    vocab = target.config.vocab_size
    dev_t, dev_d = _model_device(target), _model_device(draft)
    masked_t, masked_d = _mask_capable(target), _mask_capable(draft)

    def i32(x, dev):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def noise(shape):
        return torch.from_numpy(_gumbel(rng, shape)).to(dev_t)

    try:
        with torch.no_grad():
            max_len = s + max_new_tokens + g
            t_caches = init_kv_cache(target, 1, max_len)
            d_caches = init_kv_cache(draft, 1, max_len)
            keep_t = torch.ones((1, max_len), dtype=torch.bool, device=dev_t)
            keep_d = torch.ones((1, max_len), dtype=torch.bool, device=dev_d)
            tk = (torch.tensor(float(temperature), device=dev_t),
                  i32(int(top_k), dev_t),
                  torch.tensor(float(top_p), device=dev_t))
            pre_samp = (noise((1, vocab)), *tk) if do_sample else ()
            tok_t = _prefill_fn(target, s, do_sample, masked_t,
                                ids.to(dev_t), keep_t, t_caches, pre_samp)
            n_target_fwd += 1
            _prefill_fn(draft, s, False, masked_d, ids.to(dev_d), keep_d,
                        d_caches, ())
            pending = int(tok_t.cpu()[0])
            out = [pending]
            p = s                       # both caches hold positions < p
            accepted_total = 0
            while len(out) < max_new_tokens and \
                    (eos_token_id is None or pending != eos_token_id):
                # the draft consumes block[i] at position p + i and
                # proposes block[i + 1]; the last feed (i = g - 1) drops
                # its proposal but writes d_{g-1}'s k/v into slot
                # p + g - 1, which the next round reads when every
                # proposal is accepted
                block = [pending]
                q_rows = []
                for i in range(g):
                    cur = i32([block[i]], dev_d)
                    if do_sample:
                        nxt, q = _spec_draft_step(
                            draft, cur, i32(p + i, dev_d), d_caches,
                            noise((1, vocab)).to(dev_d),
                            *(t.to(dev_d) for t in tk))
                    else:
                        nxt = _decode_fn(draft, 1, False, masked_d, cur,
                                         i32(p + i, dev_d), keep_d,
                                         d_caches, ())
                    if i < g - 1:
                        block.append(int(nxt.cpu()[0]))
                        if do_sample:
                            q_rows.append(q.to(dev_t))
                block_t = i32([block], dev_t)
                p_t = i32(p, dev_t)
                if do_sample:
                    q_stack = (torch.cat(q_rows, dim=0) if q_rows else
                               torch.zeros((0, vocab), device=dev_t))
                    u_t = torch.from_numpy(
                        rng.uniform(size=(g - 1,)).astype("float32")) \
                        .to(dev_t)
                    gn_t = noise((vocab,))
                    n_acc, emit = (int(x) for x in _spec_verify_step(
                        target, g, block_t, q_stack, u_t, gn_t, p_t,
                        t_caches, *tk).cpu())
                    n_target_fwd += 1
                    emitted = block[1:1 + n_acc] + [emit]
                else:
                    preds = _verify_step(target, g, block_t, p_t,
                                         t_caches).cpu().numpy().ravel()
                    n_target_fwd += 1
                    # the longest prefix of proposals the target agrees
                    # with, then its own next token (the correction on a
                    # mismatch, the bonus when all are accepted)
                    n_acc = 0
                    while n_acc < g - 1 and \
                            block[n_acc + 1] == int(preds[n_acc]):
                        n_acc += 1
                    emitted = block[1:1 + n_acc] + [int(preds[n_acc])]
                accepted_total += n_acc
                # the accepted prefix fills p .. p + n_acc of both
                # caches; later slots are position-masked until
                # overwritten, and `pending` enters both next round at p
                p += n_acc + 1
                pending = emitted[-1]
                out.extend(emitted)
                if eos_token_id is not None and eos_token_id in emitted:
                    out = out[:out.index(eos_token_id) + 1]
                    break
            out = out[:max_new_tokens]
    finally:
        if was_t:
            target.train()
        if was_d:
            draft.train()
    if stats is not None:
        stats.update(target_forwards=n_target_fwd, generated=len(out),
                     accepted_drafts=accepted_total)
    return torch.from_numpy(
        np.concatenate([prompt, np.array([out], "int32")], axis=1))


def _verify_step(model, g, block_t, index_t, caches):
    """Width-g greedy verify: the g tokens of `block_t` (1, g) enter the
    cache at `index_t`; -> the argmax after each of them, (1, g) int32."""
    pos = (index_t + torch.arange(g, dtype=torch.int32,
                                  device=block_t.device)).reshape(1, g)
    logits, _ = model(block_t, position_ids=pos, caches=caches,
                      cache_index=index_t)
    return logits.argmax(dim=-1).to(torch.int32)


def _spec_draft_step(model, tok_t, index_t, caches, noise_t, temp_t, topk_t,
                     topp_t):
    """Sampling draft step: one token, and the processed distribution q
    it was sampled from (the rejection test needs it). -> (tok (1,), q
    (1, v) f32)."""
    logits, _ = model(tok_t.reshape(1, 1),
                      position_ids=index_t.reshape(1, 1), caches=caches,
                      cache_index=index_t)
    x = _process_logits_traced(logits[:, -1], temp_t, topk_t, topp_t)
    return (x + noise_t).argmax(dim=-1).to(torch.int32), \
        torch.softmax(x, dim=-1)


def _spec_verify_step(model, g, block_t, q_t, u_t, gnoise_t, index_t, caches,
                      temp_t, topk_t, topp_t):
    """Rejection-sampling verify: one target forward over the block, the
    test and the resample on the device. block (1, g), q (g - 1, v), u
    (g - 1,), gumbel (v,) -> [n_acc, emitted] int32 (2,).

    p_i is the target's processed distribution after block[:i + 1];
    proposal x_i = block[i + 1] is accepted iff u_i q_i(x_i) < p_i(x_i).
    The emitted token samples max(p - q, 0), renormalized, at row n_acc,
    with q padded by a zero row, so when every proposal passes it samples
    the bonus from p_{g-1}."""
    v = q_t.shape[-1]
    dev = block_t.device
    pos = (index_t + torch.arange(g, dtype=torch.int32,
                                  device=dev)).reshape(1, g)
    logits, _ = model(block_t, position_ids=pos, caches=caches,
                      cache_index=index_t)
    p = torch.softmax(_process_logits_traced(
        logits.reshape(g, v), temp_t, topk_t, topp_t), dim=-1)   # (g, v)
    props = block_t[0, 1:].long()                                # (g - 1,)
    pi = p[:g - 1].gather(1, props[:, None])[:, 0]
    qi = q_t.gather(1, props[:, None])[:, 0]
    accept = (u_t * qi < pi).to(torch.int32)
    # the leading run of accepts: positions with no rejection yet
    n_acc = (torch.cumsum(1 - accept, dim=0) == 0).sum(dtype=torch.int32)
    row = n_acc.reshape(1).long()
    p_row = p.index_select(0, row)[0]
    q_row = torch.cat([q_t, torch.zeros((1, v), device=dev)]) \
        .index_select(0, row)[0]
    r = torch.clamp_min(p_row - q_row, 0.0)
    # p == q at the rejected row leaves no residual (a rejection there
    # has probability zero): sample p_row instead
    r = torch.where(r.sum() > 0, r, p_row)
    emitted = (torch.log(r + 1e-20) + gnoise_t).argmax(dim=-1)
    return torch.stack([n_acc, emitted.to(torch.int32)])


# -- the numpy filter (the paged engine's first sampled token) ----------------

def _np_process_logits(logits, temperature, top_k, top_p):
    """numpy twin of process_logits (the paged engine's first sampled
    token)."""
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


def _np_select_token(logits, do_sample, temperature, top_k, top_p, rng):
    x = np.asarray(logits, "float32")
    if do_sample:
        x = _np_process_logits(x, temperature, top_k, top_p)
        x = x + _gumbel(rng, x.shape)
    return x.argmax(-1).astype("int32")
