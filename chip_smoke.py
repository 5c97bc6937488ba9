#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py [--profile] [--out results.json]

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi);
2. the CUDA kernels built from paddle_tpu_torch/kernels/csrc;
3. every kernel of the serving path held against its plain PyTorch twin
   on the card at the shapes the path gives it (bf16 and f32), timed
   beside the twin, one library call where there is one, and the least
   time the card could take (bytes / 3.35 TB/s, or operations / peak);
   with them the int8 serving path's kernels: the int8 decode kernel at
   the same shapes (bf16 and f32 q; SDPA over the gathered, dequantized
   window as yardstick), both decode kernels also at the full window
   (every slot at its block table's last position), and W8A16 at every
   distinct Llama-3-8B projection shape at M = 8 (the 16-row split-K
   kernel), at the M of the engine's first batched prefill call and at
   the late joiner's (the wgmma kernel) and at phase 12's spec verify's
   M = 40 (the wgmma kernel), each row with its route
   (torch.matmul over the dequantized bf16 weight, the unquantized
   layer's cost, as yardstick), and in f32 at a small ragged shape;
4. the same for the training path's kernels: flash attention forward,
   dq and dk/dv at TinyLlama-1.1B's training shape (8, 2048, 32/4, 64)
   and at Llama-3-8B's head shape (1, 4096, 32/8, 128), bf16, and in f32
   at small shapes, each entry held to its own size and its head_dim
   row's (`_check_rows`); the RMSNorm backward at (16384, 2048) with and
   without the residual's gradient, and its forward at the prefill
   call's (6370, 4096) and the training (16384, 2048) shapes with a
   residual (x + residual, then F.rms_norm, as yardstick; each norm entry
   carries the launch plan it ran); RoPE, forward and backward, bit-equal
   to its twin in f32 and bf16 and timed at the decode (8, 1, 32|8, 128),
   first prefill call's (1, M, 32|8, 128) and training (8, 2048, 32|4, 64)
   shapes. SDPA (enable_gqa) is the flash yardstick;
5. Llama-3-8B at full width (32 layers, bf16, weights from a seed) behind
   a PagedKVEngine serving 8 requests of 128..1024 prompt tokens and 64
   new tokens each, one of them joining mid-decode. Each decode tick is
   one replay of the engine's captured CUDA graph (the warm-up tick and
   the capture come first, at the first tick); the launch counters of
   the three kernels show that path went through them, as exact counts
   over every decode step, the warm-up's included. A replay adds the
   counts its capture took, so two more replays of the captured tick run
   under torch.profiler, and each decode-path kernel's rows in that trace
   must equal what the counters gained (the replays' kernel time is
   printed beside the untraced tick's host wall). A second run gives
   the same greedy tokens, and so does a run through the engine's
   private eager tick (`_eager_program`), whose decode tokens/s and tick
   ms are printed beside the captured path's. Then the serving loop:
   `stream()` over two requests with the background ticker running
   (which captures the tick on its own thread) gives each the tokens
   `generate()` gave it, a request cancelled mid-decode returns every
   page and its reservation, and `stop()` joins the ticker;
6. continuous-batching parity on a 2-layer full-width f32 model: a
   request's greedy tokens alone equal its tokens when it joins
   mid-decode of 7 others (or, at a near-tie, the two tokens' logits
   agree within 1e-3);
7. TinyLlama-1.1B (22 layers, full width) trained through the Trainer:
   f32 weights from a seed, bf16 compute, AdamW, flash attention, fused
   RMSNorm and RoPE, recompute; one batch of 8 x 2048 tokens, one
   warm-up step and 5 timed steps. The loss must be finite and fall, and
   each kernel's launches per step must equal the count worked out from
   the model's code;
8. training parity: one Trainer step of a 2-layer model at TinyLlama's
   full width on the card through the kernels against the same state and
   batch on the CPU through the twins, in f32 and with bf16 compute, and
   an f32 step with the blockwise loss, ClipGradByGlobalNorm, a
   LinearWarmup schedule and skip_nonfinite_grads;
9. bench.py's own training configuration (bench.py:1182-1254):
   TinyLlama-1.1B, 22 layers, recompute, flash attention, the blockwise
   loss (loss_chunk=512), plain norm and RoPE; f32 weights from a seed,
   AdamW(1e-4, weight decay 0.01), bf16 compute; one batch of 8 x 2048
   ids fed through `trainer.data_iter(itertools.repeat(data, 11),
   depth=3)`: a warm-up step, then 10 timed steps closed by
   float(loss). The losses must be finite and fall, and each kernel's
   launches per step must equal the count from the code;
10. int8 serving: Llama-3-8B (seed 0, bf16) converted by
   `quantize_weight_only` on the card (every Linear, the lm_head
   included, W8A16), behind PagedKVEngine(kv_dtype="int8") with phase
   5's geometry, prompts and late joiner. Each of layer 0's seven
   projections must stay within 2 % (mean |q - f| / mean |f|) of the
   float layer on a prefill activation; tokens in vocabulary, pages
   back with their scale rows zeroed, int8 decode launches = 32 x decode
   steps, W8A16 launches = 225 x model calls, of which the wgmma route's
   = 224 x prefill calls above its threshold (decode steps counted with
   the warm-up tick's), the kernel rows of two traced replays equal to
   what the counters gained (W8A16's split-K kernel among them), a
   second run the same tokens, the private eager
   tick the same tokens (its decode tokens/s and tick ms printed beside
   the captured path's), KV bytes per slot at most 0.51 x phase 5's. It
   reports the top-1 agreement of the first tokens with phase 5's bf16
   model;
11. prefix-cached, chunked serving on phase 5's model (run right after
   it): PagedKVEngine(max_slots=8, page_size=16, max_pages_per_slot=256,
   prefix_cache_pages=512, prefill_chunk=512, bf16 KV). Wave 1, eight
   requests of a shared 1024-token system prompt plus a 32-256-token
   tail, admits together (all miss); wave 2, eight more on the same
   system prompt, hits 64 pages each (one joins mid-decode); two prompts
   of 3000-4000 tokens prefill in lockstep rounds of 512 while wave 2's
   last request decodes; 32 new tokens each. Gates: 8 hits of 1024
   tokens, prefill tokens = the cold prompts' plus wave 2's tails, the
   prefill calls the rounds and buckets need, the page ledger settled
   when idle (every cached page refcount 1, free + cached = the pool),
   decode, RMSNorm and RoPE launches exact, a second run and the eager
   tick the same tokens. It prints wave 1's and wave 2's prefill wall
   and tokens/s, the decode rates (wave 2 also on a cold engine) and
   prefix_stats(); the two long prompts' peak memory and prefill time
   chunked against whole (fresh engines, in turns); then an expired
   deadline refused at submit, a request expiring in the queue of a full
   engine with no prefill, and a submit past max_pending shed. Its
   parity runs on phase 6's 2-layer f32 model with f32 and int8 KV: a
   warm hit's tokens equal a cold, unchunked engine's and a chunked
   3000-4000-token prompt's the whole prompt's (or, at a near tie, the
   two tokens' logits agree within 1e-3 on a cold engine); int8 shared
   pages' scale rows bit-unchanged through the warm request;
12. speculative decoding: PagedKVEngine(draft_model=..., spec_tokens=4)
   with phase 5's geometry, prompts, 64 new tokens and late joiner, each
   spec tick one replay of the graph cached under ("spec_tick",
   any_sample). (a) Phase 5's Llama-3-8B as its own draft, request 3
   sampling (temperature 0.8, top-k 50) beside the greedy ones, run
   right after phase 11; (b) a draft at Llama-3.2-1B's published widths
   (hidden 2048, 16 layers, 32/8 heads of 64, FFN 8192, vocab 128256,
   tied, rope theta 500000; seed 1); (c) phase 10's W8A16 model as its
   own draft with int8 KV, right after phase 10 (its verify's 40 rows
   take the wgmma W8A16 route). Gates: tokens in vocabulary, pages back
   (int8: both models' freed scale rows zeroed), the launch counts exact
   per spec tick and prefill call over every tick and warm-up
   (`_spec_counts`), accepted <= proposed, the kernel rows of two traced
   replays equal to what the counters gained, a second run the same
   tokens, the eager spec body the same greedy tokens. It prints decode
   tokens/s, spec-tick ms and the acceptance rate of each part beside
   phase 5's, and the verify's device ms (alone, captured) over a
   replay's kernels (with `--profile`, over two traced spec ticks').
   Its parity runs on phase 6's 2-layer f32 model with f32 and int8 KV,
   with the target as its own draft and with a 2-layer
   Llama-3.2-1B-width draft: the spec engine's greedy tokens against the
   spec-off engine's (phase 6's near-tie rule; at int8 KV the bound is
   at least twice int8's own logit error at that prefix, since the spec
   tick writes a page's codes in another order), every proposal accepted
   with the target as draft at f32 KV, and 400 replays of the sampled
   spec tick from one state within total variation 0.25 of the
   target's processed softmax (temperature 0.8, top-k 20);
13. the engine's tenancy, host KV tier with sessions and disaggregated
   roles on phase 5's model and geometry, with the captured tick (run
   right after phase 12 (b)): (a) tenants a and b at weights 3:1 submit
   24 and 8 requests of phase 5's prompt lengths at once (64 new
   tokens): the admission order a CPU WeightedFairScheduler's for that
   queue, the slot-ticks 2.5-3.5 while both are queued, the greedy
   tokens those of a tenancy-free engine fed the admitted order; (b) 8
   sessions (`prefix_cache_pages=512`, a 2 GiB host tier,
   `suspend_after_s=2`): turn 1 is phase 5's prompts, then every
   session page spills (the device cache empty, the free list whole),
   and turn 2 (turn 1, its output and 32 new tokens; 32 to generate)
   restores them byte-equal, the pools at their addresses and no
   recapture, with the tokens of sessions that stayed on the device; it
   prints the bytes and ms of the spill and the restore beside the PCIe
   bound of one pinned copy, and turn 2's prefill warm from the host
   against cold; (c) a role="prefill" and a role="decode" engine over
   the model at bf16 and int8 KV: export, pack_bundle, unpack_bundle,
   stage_import, decode, the tokens those of a monolithic engine
   serving the same two hops and the imported pages the prefill
   engine's, byte for byte; it prints the bundle bytes and the pack,
   unpack and import ms. Each part's launches are held to the counts
   per decode step and prefill call (phase 11's rule) and go to its own
   path ("tenancy", "kvtier", "disagg");
14. HTTP serving on phase 5's model and geometry (run right after phase
   13): the port's PredictorServer on 127.0.0.1 over a captured-tick
   engine, with the port's observability on. (a) 8 client threads POST
   /generate with phase 5's prompts (64 new tokens; 4 ndjson streams, 4
   unary; each with X-Request-Id and traceparent; the last posts after
   another's first streamed line): every request gets 64 in-vocabulary
   tokens, the tokens its engine request recorded; both headers come
   back; the wave leaves the captured programs and the pools' addresses
   as they were; the launches are held to the counts per decode step
   and prefill call (phase 11's rule). (b) /metrics parses, its engine
   gauges are engine.stats, request.ttft.seconds counts 8,
   request.tokens sums 512, request.outcome counts 8 ("finished" and
   "ok" together: the engine's retire and the handler race for it),
   inference.decode.kernel{path="cuda"} counts the wave's ticks, and
   /debug/requests is empty when idle. (c) timeout_ms=1 behind a 20 ms
   `serving.admit.delay` chaos fault gives 504; on a server with
   max_concurrent=1 and max_queue_depth=0 a /generate sent while a
   stream is in flight gives 429 with Retry-After and /readyz says
   "saturated"; drain() during a stream finishes it, /readyz says
   "draining" meanwhile, and the server stops. It prints the HTTP
   decode rate (tokens over the wave's wall, first request sent to last
   byte read) beside phase 5's, and TTFT and ITL p50/p99. Its launches
   go to the path "http";
15. static-cache generation (models/generation.py) on phase 5's model
   (run right after phase 14) and on phase 10's W8A16 model (after phase
   12 (c)): phase 5's 8 prompts left-padded with a mask to the longest.
   (a) greedy, 64 new tokens, at tokens_per_fetch 1 (the per-token
   decode step, one captured graph) and 16 (the block, 16 steps in one
   captured graph): the two streams equal, a second run of each equal
   (it times prefill and decode), each row against phase 5's engine
   tokens: equal, or at the first difference a near tie (GEN_TIE_RMS);
   every row's prefill logits and one teacher-forced decode step's
   within GEN_LOGITS_RMS of a cold engine's, where two planted faults
   (the decode step's position one too far, the padding mask ignored)
   must read above it and a third (bf16 scores) is reported;
   the decode and block graphs hold exactly the RMSNorm and RoPE nodes
   their captures counted, one and 16 model calls' worth. (b) 37 new
   tokens, which 16 does not divide: both runs equal, the tail block's
   k/v the per-token run's below the buffer's last slot, each row
   against (a)'s first 37 by the near-tie rule. (c) sampled (temperature
   0.8, top-k 50, seed 5) per-token runs repeat bit for bit; a sampled
   block at top_k=1 equals (a) but at exact ties of the bf16 logits. (d)
   the W8A16 model at tokens_per_fetch 1 and 16, equal (W8A16 on its
   wgmma route in prefill, split-K in the graphs). (e)
   generate_speculative at batch 1, g = 4, the 8B as its own draft,
   against greedy by the near-tie rule; it prints target_forwards and
   accepted_drafts. (f) PredictorServer(generator=model) answers
   /generate, streamed and unary, tokens_per_fetch 16, with (a)'s tokens
   and no recapture. Every run's launches equal a model call's counts
   times its model calls (prefills, decode and block steps, warm-ups;
   the W8A16 wgmma route's per prefill), and the decode kernel none. It
   prints prefill ms, decode tokens/s at tokens_per_fetch 1 and 16
   beside phase 5's engine, the captures' seconds, the cache bytes and
   the launches a decode step and a prefill call. Its launches go to the
   paths "generation" and "generation_int8".
16. the replica router (inference/router.py) over the port's servers on
   phase 5's model (run right after phase 15), every engine with its own
   pools and captured tick, servers and routers on 127.0.0.1 with the
   port's observability on and the background prober running. (a) Two
   monolithic replicas (phase 11's geometry, whole-prompt prefill) behind
   `ReplicaRouter(prefix_page_size=16)`: phase 14's wave of 8 (4 streams,
   4 unary, one late) gets, on each request, X-Routed-To, both trace
   headers and the 64 in-vocabulary tokens its replica's engine recorded,
   both replicas serving; then phase 11's wave 2 (the 1024-token system
   prompt, 32 new tokens), its first request alone and the other 7
   together: the 7 follow it to its replica, router.prefix.hits counts 7
   and that engine 7 hits of 1024 tokens. (c) On the same router: one
   `router.connect.fail` replays on the other replica (router.retries
   counts it); a `kill_hook` kills r1 (its listener, its engine's loop,
   every waiter failed) after the first relayed chunk of a stream pinned
   to it: the client gets a prefix of the engine's tokens and the typed
   `{"error", "reason": "replica_failed", "retryable": true, "replica":
   "r1"}` chunk, r1's engine gets every page and reservation back, the
   prober ejects r1, and the next 4 requests go to r0 while /readyz says
   200. (b) A role="prefill" replica (2 GiB host tier) and a
   role="decode" one (phase 13 (c)'s geometry, bf16 KV) behind a second
   router that learns the roles from its probes: phase 5's 8 prompts one
   at a time take two hops each (8 handoffs, 8 pulls over /kv/pull, the
   imported pages byte-equal to the prefill replica's, the tokens those
   of a monolithic engine serving each prompt alone over the same two
   hops); a warm repeat of two pulls nothing; with
   `disagg.transfer.fail` two requests decode on the prefill replica with
   the same tokens. Launches are held to the counts per decode step and
   prefill call (phase 11's rule) and go to the path "router". It prints
   the HTTP decode rate, TTFT and ITL through the router beside phase
   14's, wave 2's warm prefill beside phase 11's, TTFT through the two
   hops, the bytes, pull and import ms of each handoff, and how long the
   ejection took after the kill.
17. the fleet autopilot (inference/autopilot.py) and the fleet plane and
   flight recorder (observability/fleet.py) over the port's servers on
   phase 5's model (run right after phase 16) and a second Llama-3-8B
   from seed 1 ("v2"), with the port's observability on and bundles in a
   temporary flight directory. Each supervised replica is an engine at
   phase 13's geometry (641 pages), its tick captured before it serves,
   behind a PredictorServer, with a heartbeat into a
   `torch.distributed.TCPStore` on 127.0.0.1; its stop stops and drops the
   engine. The router and the supervisor are driven by hand
   (`probe_all()`, `tick()`), as in the JAX tests. (a) Two v1 replicas
   under 4 streaming clients (phase 5's prompts, 16 new tokens): r0 is
   killed as in phase 16; no client hangs, every failed request ends in
   r0's typed chunk, the router ejects r0 with a `replica_ejected` bundle,
   the supervisor relaunches it through probation, its probe tokens equal
   a cold engine's, and the allocated bytes come back within 64 MiB; it
   prints kill to ejection, kill to rotation, the relaunch's build and
   capture seconds and the other replica's /healthz latency during them.
   (b) A rolling swap to v2 under the same traffic (min_in_rotation 1):
   no failed request, never below 1 in rotation, each slot's tokens a cold
   v2 engine's, `autopilot.rollouts{completed}` 1, /debug/autopilot, the
   bytes within 64 MiB of two engines over both weights. (c) A third slot
   under `autopilot.launch.fail`: quarantined after exactly 3 attempts
   with a `replica_crash_loop` bundle, no byte allocated. (e)
   `Autoscaler.tick()` by hand: a TTFT target the traffic burns scales out
   to a third engine after 2 burning samples, which serves; with the
   traffic stopped 3 idle samples scale it in, the bytes back within
   64 MiB. (d) r0's server answers /debug/fleet with both ranks fresh;
   `fleet.heartbeat.drop` on rank 1 makes it stale once its age passes
   1 s; every bundle of the phase (ejection, drains, crash loop) holds
   the six files and `tools/obs_dump.py` renders it. Launches are held to
   phase 11's counts over every engine built and go to the path
   "autopilot".
18. training telemetry, the fleet heartbeat, training chaos and
   checkpoints (run right after phase 9). (a) Phase 9's configuration and
   loop (a warm-up and 10 steps through `data_iter(depth=3)`) under the
   port's observability: the telemetry's mean tokens/s over its last 8
   reports within 5 % of the CUDA-event window of the same steps,
   `train.mfu` = tokens/s x `flops_per_token_for(model, 2048)` /
   `detect_peak_flops()` (989e12 on an H100 SXM), `train.steps` 10,
   `train.loss` after `flush()` the last reported step's loss,
   `train.loss.logits_bytes_saved` = `logits_bytes_saved(...)`, one
   `train.recompiles` label, the launches phase 9's; two steps with
   observability on make as many synchronizing calls as two with it off
   (torch.cuda's sync debug mode); it prints the median step beside phase
   9's. (b) `trainer.fleet_heartbeat` into a TCPStore during (a): after a
   last beat the FleetAggregator's row holds the registry's step, tokens/s
   and MFU, and no `fleet-` thread is left after stop. (c) A 2-layer model
   at TinyLlama-1.1B's widths (fused norm and RoPE, the blockwise loss),
   health_probe: a step where `train.grad.nan` fires, and one where
   `train.loss.spike` fires under a loss cap, report applied 0 and leave
   every parameter and moment bit-equal; under skip_nonfinite_grads
   `train.nonfinite_skips` counts both poisoned steps. (d) The same model:
   3 steps, `save_checkpoint` (sync) and `verify_checkpoint` clean; an
   `AsyncCheckpointer` save of the same state, a step right after it
   returns, and files byte-identical to the sync save's; a trainer built
   from other weights loads the checkpoint bit-equal and takes the
   uninterrupted run's next 3 losses (bit-equal, or within twice the
   spread of two uninterrupted runs); a shard torn by `ckpt.write.shards`
   is quarantined and `load_newest_complete` falls back to the first
   save. It prints the free disk, the bytes, the sync save's and the async
   save's return times beside one pinned copy of the same bytes, and the
   load time. Launches go to the paths "training_obs" ((a)) and
   "training_ckpt" ((c), (d): every step at the count from the code).
19. the training sentry, run_resilient and a relaunch (run right after
   phase 18). (a) Phase 9's configuration at SENTRY_LAYERS of its 22
   layers with `health_probe=True`:
   bench.py's A/B (bench.py:863-939) in interleaved rounds of the step
   without the probe, the probe step reading its loss (off), the step
   under the sentry's host plane (cap, the one read of loss and probe,
   the detector: on) and off again; the 2nd-percentile step of each,
   `host_us_per_step`, `overhead_pct`, the A/A floor and the probe's own
   cost (`probe_compile_delta_pct`); two steps on make as many
   synchronizing calls as two off. (b) bench.py's chip configuration of
   its sentry extra (bench.py:833-838: hidden 1024, 4 layers, vocab
   32000, 4 x 1024 ids, 8 steps, bf16 compute) with an AsyncCheckpointer:
   rollback with one `train.grad.nan` (bench.py:941-968: one rollback,
   the trigger, the restore and run seconds, the promoted step; the end
   state bit-equal to the fault-free run's 8 steps); skip with one fired
   step, bit-equal to the run without that batch; quarantine after 2
   rollbacks with a `sentry_quarantine` bundle, re-raised by
   run_resilient with 0 restarts; run_resilient over the sentried
   trainer with a preemption (`elastic.preempt`), a raised fault and a
   watchdog abort (an op held open past 1 ms around a step on the card,
   `complete_when_ready`): one restart each, the `restart_fault` and
   `watchdog_abort` bundles, `elastic.*` counters, the end state
   bit-equal to the fault-free run. (c) An ElasticSupervisor runs one
   worker (this script, `--relaunch-worker`) on the card at (b)'s
   configuration: attempt 0 exits at the end of step 5, attempt 1
   resumes from step 4's checkpoint; its final checkpoint's files equal
   the fault-free run's; it prints the time from the kill to the resumed
   first step. It prints the free disk, the checkpoint bytes, the save
   and load times. Launches go to the path "training_sentry" ((a) and
   (b), every step at the count from the code).
20. data-parallel training across processes (run right after phase 19),
   the workers started through the port's launcher
   (`python -m paddle_tpu_torch.distributed.launch ... chip_smoke.py
   --dp-worker ...`). (a) `--devices 0`: one worker whose
   `init_parallel_env()` forms an NCCL world of one; every collective of
   distributed/collective.py on CUDA tensors gives its one-rank result,
   with 0 watchdog expiries, and exactly 1 under a
   `collective.dispatch/all_reduce` delay past a 200 ms deadline; then
   phase 9's configuration at DP_A_LAYERS of its 22 layers for 6 steps
   over `init_mesh({"dp": 1})`, its
   losses bit-equal to a mesh-free Trainer's 6 steps in the same worker
   and its launches per step the count from the code, and 0 all-reduce
   bytes a step (a dp axis of extent 1 runs no collective: phase 22
   (c)); it prints the step ms of both. (b)
   Two workers (`--nnodes 2 --rank r`, both on device 0; NCCL takes one
   rank a device, so `init_parallel_env(backend="gloo")`): TinyLlama's
   width at 2 layers, 8 x 2048 ids split 4 + 4, rows 0-3 labelled -100
   from column 1024, 3 steps; the losses, step 1's gradient and the
   parameters after step 3 within their tolerances of one process's run
   of the same global batches, the two ranks' parameters bit-equal, and a
   planted fault (gradients averaged over ranks, not tokens) reading
   outside the gradient's and the parameters' tolerances. Launches go to the path "training_dp" ((a)'s dp run).
21. tensor-parallel training across processes (run right after phase 20).
   (a) Two workers (`python -m paddle_tpu_torch.distributed.launch
   --nnodes 2 --rank r --devices 0 chip_smoke.py --tp-worker DIR`, both
   on device 0, gloo): `fleet.init` with mp_degree 2,
   `fleet.distributed_model`, the Trainer on the fleet mesh with its
   plan; TinyLlama-1.1B at full width and TP_LAYERS of its 22 layers
   (the whole run's time: every step sums the mp partials through the
   host), flash,
   recompute, fused norm and RoPE, `loss_chunk=512` (the vocab-parallel
   blockwise loss on each rank's 16000-row shard), AdamW(1e-4, wd 0.01),
   bf16 compute; a global batch of 2 x 2048 ids (phase 9's 8 cut to 2),
   row 0 labelled -100 from column 1024, 1 + 3 steps. Each worker first
   runs the same model and batches through a mesh-free Trainer (the
   one-process reference) and keeps its own pieces of it. Gates: the
   loss gap, step 1's gradient (the pieces of both ranks over the whole
   model) and the parameters after the last step within their
   tolerances; the parameters that are not cut (the norms) bit-equal on
   the two ranks; each rank's launches per step the count from the code
   at its 16000-row vocab shard; two planted faults (the loss from each
   rank's local lse; a column-parallel f-op whose backward skips its
   all-reduce) outside the loss's and the gradient's tolerances. It
   prints each rank's peak memory against the one process's, the step
   ms and the gloo bytes a step. (b) In this process, the blockwise CE
   kernels on the two (16000, 2048) shards of a (32000, 2048) bf16 head,
   x (4096, 2048), labels on both shards and some ignored: each shard
   against its twin, the combination (lse over the shards, the picked
   logits and dx summed, dW stacked) against the whole-vocab kernels,
   and shard 0's kernels timed beside their bound and torch.matmul of the
   bare product (the kernels' entries carry them as `vocab_shard`).
   Launches go to the path "training_tp" ((a)'s tensor-parallel run on
   rank 0).
22. FSDP (ZeRO-3) training across processes and optimizer-state offload
   (run right after phase 21). (a) Two workers (`--nnodes 2 --rank r
   --devices 0 chip_smoke.py --fsdp-worker DIR`, gloo on device 0):
   `fleet.init` with sharding_degree 2, `fleet.distributed_model` (the
   plan's 'fsdp' entries: every projection, the embedding and the head
   cut in two, the norms whole), the Trainer on the fleet mesh; phase
   21's model, optimizer, compute type and batches (the batch split
   1 + 1 over the fsdp ranks), 1 + FSDP_STEPS steps. Each worker first
   runs the mesh-free reference and keeps its own pieces. Gates, at
   phase 20's DP_LOSS_TOL, DP_GRAD_TOL and DP_PARAM_TOL: the loss gap,
   step 1's gradient and the parameters after the last step (each over
   the whole model, the ranks' pieces summed); the norms bit-equal on
   the two ranks; each rank's parameter and optimizer-state bytes the
   count from the code (half the whole, the norms whole); the launches
   per step the count from the code at a rank's 1 x 2048 rows; two
   planted faults, one step each (a reducer that sums the
   reduce-scattered gradients again over the batch group; a gather whose
   backward keeps its own piece without the reduce-scatter), each outside
   the gradient's and the parameters' tolerances. It prints each rank's
   peak memory against the one process's and phase 21's tensor-parallel
   rank's, the step ms and the gloo bytes a step. (b) In this process,
   phase 9's configuration for 1 + OFFLOAD_STEPS steps with
   `offload_opt_state` off and on: losses and parameters bit-equal, the
   device peak lower by at least the moments' bytes from the code; both
   step times printed. (c) is phase 20 (a)'s 0 all-reduce bytes. Launches
   go to the paths "training_fsdp" ((a) on rank 0) and
   "training_offload" ((b)).
23. the ring paths (run right after phase 22). (a) The FSDP overlap
   (parallel/overlap.py): two workers (`--overlap-worker DIR`, gloo on
   device 0) on `init_mesh({"fsdp": 2})`: first `ppermute` and `send` /
   `recv` of seeded random bits (bf16 and f32, 1 and 128 MB) held bit
   for bit; then, with `llama_sharding_plan`,
   phase 21's model, optimizer, compute type and batches, 1 + OVL_STEPS
   steps with `overlap_fsdp=True, overlap_chunks=OVL_CHUNKS` against the
   same run with the overlap off, at phase 20's DP_LOSS_TOL, DP_GRAD_TOL
   and DP_PARAM_TOL; every fsdp-cut projection's rings and the bytes a
   rank sends over them a step the count from the code
   (ring_smoke.py `ring_counts_per_step`); the launches per step the
   count from the code; a planted contract ring that multiplies its own
   piece twice, one step, outside the gradient tolerance; and
   `measure_phase_seconds`' fwd_comm, bwd_comm and overlap_fraction at
   OVL_PHASE_LAYERS layers (gloo through the host: no rate). (b) Context
   parallelism (distributed/context_parallel.py): two workers
   (`--cp-worker DIR`) on `init_mesh({"sp": 2})`, the same model at
   full width and CP_LAYERS layers (the whole run's time: every step
   all-reduces every gradient through the host), 1 x CP_SEQ ids (labels
   -100 from CP_PAD), "ring" and then "ulysses", 1 + CP_STEPS steps
   each, against each worker's one-process run of the whole sequence at
   phase 20's tolerances; the launches per step each rank's count from
   the code (the ring: one flash forward, dq and dk/dv a live block,
   rank r attending to r + 1 shards); two planted faults, one ring step
   each (a merge that sums the blocks without their lse weights; a
   future shard that is not skipped), outside the tolerances. (c) In
   this process, the flash ring's per-block forward, lse merge and
   backward over RING_N shards of RING_BLOCKS bf16, causal (no
   transport): o, lse, dq, dk and dv against the whole-sequence kernels
   by the flash row rule, the blocks' ms beside the whole sequence's.
   Launches go to the paths "training_overlap" ((a) rank 0),
   "training_cp_ring" and "training_cp_ulysses" ((b) rank 0).
24. pipeline parallelism (parallel/pipeline.py; run right after phase
   23): two workers (`--pp-worker DIR`, gloo on device 0) on
   `init_mesh({"pp": 2})`, one stage each, activations and gradients
   crossing between them point to point. (a) TinyLlama-1.1B at full
   width and all 22 layers (11 a stage; flash, recompute, the fused norm
   and RoPE, the dense tail), phase 9's optimizer and bf16 compute,
   PP_BATCH ids (row 0 labelled -100 from PP_PAD's column) in PP_M
   microbatches of one row, 1F1B, 1 + PP_STEPS steps, against each
   worker's one-process mesh-free Trainer of the same model and batches
   (loss_chunk=0: the same function) at phase 20's DP_LOSS_TOL,
   DP_GRAD_TOL and DP_PARAM_TOL; each rank's launches per step and its
   hops and bytes per step the count from the code; each rank's peak
   memory beside one process's. (b) At PP_B_LAYERS layers, PP_B_BATCH
   ids in PP_B_M microbatches: GPipe and 1F1B (stage 0's 1F1B peak below
   its GPipe peak; the microbatches each rank held), VPP with
   interleave=2 and stage_boundaries=(0, 3, 8), each against one
   process at the same tolerances. (c) A planted fault, one 1F1B step of
   (b)'s model: the backward pairs an incoming gradient with the newest
   saved microbatch, not its own, outside the gradient tolerance. One
   card shows no rate across cards and no real bubble. Launches go to
   the path "training_pp" ((a), both ranks).
25. the Qwen2-MoE family (models/qwen2_moe.py, nn/moe.py) at
   Qwen1.5-MoE-A2.7B's published width (hidden 2048, 24 layers, 16/16
   heads of 128, 60 experts, 4 a token, expert FFN 1408, shared expert
   5632, vocab 151936; dropless, fused RoPE, plain norms; 14.3 B
   parameters, bf16 from a seed; run last, after phase 10's model is
   freed). (a) A PagedKVEngine (MOE_GEOM) serves 8 prompts of 128-512
   tokens, MOE_MAX_NEW new tokens each, one joining mid-decode, through
   the captured tick: the decode kernel's launches L a decode step, RoPE
   2 L and the expert products (torch._grouped_mm) 3 L a model call, the
   norms none; the private eager tick the same tokens; prefill ms, tick
   ms and decode tokens/s. (b) `generate` on prompts 0 and 1 (one
   left-padded batch): its captured steps' tokens bit for bit those of
   their eager bodies; with its routing pinned to a cold engine's, its
   logits at each row's prefill and one teacher-forced decode step
   within MOE_GEN_LOGITS_RMS of that engine's, the planted faults above
   it; where its tokens leave the engine's, the routers' top-k flips
   between the two bf16 paths on the common prefix, and the pinned
   logits there the engine's token (or a tie in the engine's logits)
   within the limit (bf16 noise flips this random router; the token
   equality is held at f32 in (d)). (c) Layer MOE_LAYER's MoE on the served model's own inputs (8
   prompts' first 128 tokens, and their last rows as a decode step's
   8): each grouped product against the plain per-expert loop
   (BF16_TOL), the whole dropless output and the capacity path at k = 2
   against their plain versions (MOE_BF16_TOL), the products' ms beside
   the plain loop's and their bound (the bytes of the experts the
   tokens touch over 3.35 TB/s). (d) MOE_TRAIN_LAYERS layers at the same
   widths, f32 weights: first the engine's eager tick with f32 KV and
   `generate` on prompts 0 and 1 give the same greedy tokens (the expert
   products through the plain loop: torch._grouped_mm takes bf16 only);
   then the Trainer (bf16 compute, AdamW, flash attention, fused RoPE)
   on MOE_TRAIN_BATCH ids for 1 + MOE_TRAIN_STEPS steps: step 1's loss
   within TRAIN_BF16_LOSS_TOL of an f32 forward on the card, the loss
   falling, the flash and RoPE launches and the expert products (3 L
   forward, 6 L backward a step) the count from the code; tokens/s.
   Launches go to the paths "serving_moe" ((a)) and "training_moe"
   ((d)).

Phase 4 also holds the blockwise cross-entropy kernels (forward, dS,
dx, dW) against their twin at the training shape (N 16384, D 2048,
V 32000) in bf16 and at a small shape in f32, beside the dense path
(torch.matmul logits and the port's dense cross_entropy) and torch.matmul
of each bare product as yardsticks, the forward and the backward the same
bits on two calls, and once more in bf16 past the
old int32 cap (N 18432 = 9 x 2048 rows, Llama-3-8B's head: D 4096,
V 128256, so N x V > 2^31).

`--profile` also traces one prefill and two decode ticks of phases 5 and
10 (two replays of the captured tick, after one untraced tick that
captures it), the same for phase 11's wave 2 warm (after wave 1) and
cold and for each part of phase 12, phase 15 (a)'s prefill and two of
its captured decode steps, and one step of each training
configuration.

The last line is {"ok": true, "device": {...}}; it is printed only when
every phase passed. Without a CUDA device the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings

import numpy as np
import torch

from paddle_tpu_torch.observability.telemetry import PEAK_FLOPS

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TENSOR_FLOPS = PEAK_FLOPS["H100 80GB HBM3"]   # H100 SXM dense bf16
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_TOL = 2 ** -7             # one bf16 rounding step, relative
F32_TOL = 1e-4
# flash kernels in bf16, entry by entry against |ref| + the RMS of its
# head_dim row (`_check_rows`): four bf16 steps. The kernel and the twin
# may round an output to neighbouring bf16 values (one step), and the
# kernel rounds p against the running row max where the twin rounds the
# normalised p: noise of about a third of a step of the row's RMS per
# entry, which over millions of entries reaches 1.7 steps in o and 0.9 in
# dq, dk and dv
FLASH_BF16_TOL = 2 ** -5
# the blockwise cross-entropy's dx and dW, entry by entry (`_check_rows`):
# both sides round dS to bf16 once, and a dS that rounds the other way
# moves a row by 2^-8 of its size
CE_BF16_TOL = 2 ** -6
SERVING_KERNELS = ("paged_decode_attention", "rms_norm_residual",
                   "rope_apply")
# the decode-path kernels as a profiler trace names them (`traced_replays`)
TRACED_DECODE = ("paged_decode_split<", "paged_decode_combine<",
                 "rmsn_fwd_kernel<", "rope_kernel<")
TRACED_INT8 = TRACED_DECODE + ("w8a16_kernel<",)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, inputs, iters=50):
    """Device ms per call of fn(*inputs[i % len(inputs)]): `iters` calls
    captured in one CUDA graph, so the host's launch overhead is not in
    the time, and the replay timed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up, as capture wants
        for i in range(3):
            fn(*inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_eager_ms(fn, inputs, iters=3):
    """Device ms per call without a graph, for calls whose own time
    dwarfs launch overhead (the plain twins at training shapes, which
    allocate gigabytes per call, and autograd yardsticks)."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _check(name, out, ref, tol):
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol, msg=name)
    return float((out - ref).abs().max())


def _check_to_max(name, out, ref, tol):
    """|out - ref| <= tol * max(1, max |ref|); returns max |out - ref|."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((out - ref).abs().max())
    bound = tol * max(1.0, float(ref.abs().max()))
    if err > bound:
        raise AssertionError(f"{name}: max |err| {err} > {bound}")
    return err


def _check_rows(name, out, ref, tol):
    """Entry by entry, |out - ref| <= tol * (|ref| + the RMS of ref's row
    along the last dim + 2^-6 of the RMS of all of ref), so a row or key
    of small values is held to its own size, not to the largest entry.
    The last term covers rows whose exact value is 0 (dq of the first
    causal row), where both sides give rounding noise. Returns (max |out
    - ref|, the largest |out - ref| / bound)."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (out - ref).abs()
    sq = ref.square()
    bound = tol * (ref.abs() + sq.mean(-1, keepdim=True).sqrt()
                   + 2 ** -6 * sq.mean().sqrt())
    ratio = float((diff / bound).max())
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: |err| reaches {ratio:.3g} x its bound "
                             f"{tol:.3g} * (|ref| + row RMS + 2^-6 RMS)")
    return float(diff.max()), ratio


# -- phase 3: kernels against their twins ---------------------------------

def _plan_json(p):
    """The RMSNorm launch plan a timed call ran (fused_norm.plan)."""
    return {"threads_per_row": p.threads_per_row,
            "rows_per_block": p.rows_per_block,
            "instance": "vector" if p.vector else "scalar",
            "chunks": p.chunks, "blocks": p.blocks}


def norm_phases(dev, fn):
    """The rms_norm_residual and rms_norm_residual_bwd entries: each kernel
    held against its twin (h bit-equal to x + residual, y and dh within one
    rounding step in bf16 and 1e-4 in f32, rstd within 1e-4, dw within the
    tolerance of its largest entry and the same bits twice), then timed
    beside its twin, its bound and a library yardstick at the decode
    (8, 4096), prefill (6370, 4096) and training (16384, 2048) shapes;
    each shape's entry carries the launch plan it ran."""
    g = torch.Generator(device=dev).manual_seed(0)
    eps, d = 1e-5, 4096
    rms = torch.nn.functional.rms_norm

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def held(tag, x, r, w, tol):
        y, h = fn.rms_norm_residual(x, w, r, eps)
        ry, rh = fn.rms_norm_residual_ref(x, w, r, eps)
        torch.cuda.synchronize()
        if not torch.equal(h, rh):
            raise AssertionError(f"rms_norm {tag}: h != x + residual")
        return _check(f"rms_norm {tag}", y, ry, tol)

    # decode rows, a 4096-row block, the prefill call's 6370 rows and
    # the decode rows of phase 12's Llama-3.2-1B-width draft
    err = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for n, dd in ((8, d), (4096, d), (6370, d), (8, 2048)):
            x, r, w = randn(n, dd, dtype=dtype), \
                randn(n, dd, dtype=dtype), randn(dd, dtype=dtype)
            for res in (None, r):
                e = held(f"{dtype} ({n}, {dd}) res={res is not None}", x,
                         res, w, tol)
                if dtype == torch.bfloat16:
                    err = max(err, e)
    rows = 8
    sets = [(randn(rows, d), randn(rows, d), randn(d)) for _ in range(4)]
    nores = [(s[0], s[2]) for s in sets]
    elem = rows * d
    norm = dict(
        name="rms_norm_residual", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/fused_norm.cu",
        replaces="paddle_tpu/kernels/fused_norm.py:185",
        ms=_time_ms(lambda a, b: fn.rms_norm_residual(a, b, None, eps),
                    nores),
        plain_ms=_time_ms(lambda a, b: fn.rms_norm_residual_ref(a, b, None,
                                                                eps), nores),
        library_ms=_time_ms(lambda a, b: rms(a, (d,), b, eps), nores),
        shape=f"x ({rows}, {d}) bf16, no residual",
        plan=_plan_json(fn.plan(rows, d, torch.bfloat16,
                                sms=fn._sm_count(dev))),
        residual_ms=_time_ms(lambda a, b, c: fn.rms_norm_residual(
            a, c, b, eps), sets),
        residual_plain_ms=_time_ms(lambda a, b, c: fn.rms_norm_residual_ref(
            a, c, b, eps), sets),
        # the library yardstick with a residual: the add, then F.rms_norm
        # of the sum (two calls)
        residual_library_ms=_time_ms(lambda a, b, c: rms(a + b, (d,), c,
                                                         eps), sets))
    norm["bound_ms"], norm["bound_by"] = _bound(
        2 * elem * 2 + d * 2, 4 * elem, F32_FLOPS)
    norm["residual_bound_ms"] = _bound(4 * elem * 2 + d * 2, 5 * elem,
                                       F32_FLOPS)[0]

    def timed_fwd(tag, n, dd, want_rstd):
        x, r, w = randn(n, dd), randn(n, dd), randn(dd)
        e = held(f"bf16 {tag} ({n}, {dd}) res=True", x, r, w, BF16_TOL)
        one = [(x, r, w)]
        out = {f"{tag}_ms": _time_ms(
                   lambda a, b_, c: fn._norm_fwd(a, c, b_, eps, want_rstd),
                   one, iters=20),
               f"{tag}_plain_ms": _time_ms(
                   lambda a, b_, c: fn.rms_norm_residual_ref(a, c, b_, eps),
                   one, iters=5),
               f"{tag}_library_ms": _time_ms(
                   lambda a, b_, c: rms(a + b_, (dd,), c, eps), one,
                   iters=20),
               f"{tag}_bound_ms": _bound(
                   4 * n * dd * 2 + dd * 2 + (n * 4 if want_rstd else 0),
                   5 * n * dd, F32_FLOPS)[0],
               f"{tag}_shape": f"x, residual ({n}, {dd}) bf16"
                               + (", with rstd" if want_rstd else ""),
               f"{tag}_plan": _plan_json(fn.plan(n, dd, torch.bfloat16,
                                                 sms=fn._sm_count(dev)))}
        return e, out

    e, pre = timed_fwd("prefill", 6370, d, False)
    norm.update(pre)
    e2, train = timed_fwd("train", 16384, 2048, True)
    norm.update(train)
    norm["library_note"] = (
        "decode without a residual: F.rms_norm, the same function; with a "
        "residual (residual_, prefill_, train_library_ms): x + residual, "
        "then F.rms_norm, two calls that write no rstd")
    norm["max_abs_err"] = max(err, e, e2)
    print(f"[kernel] rms_norm_residual bf16 (8, 4096): {norm['ms']:.4f} ms, "
          f"plain {norm['plain_ms']:.4f} ms, torch rms_norm "
          f"{norm['library_ms']:.4f} ms, bound {norm['bound_ms']:.5f} ms; "
          f"with residual {norm['residual_ms']:.4f} ms, plain "
          f"{norm['residual_plain_ms']:.4f} ms, x + r and rms_norm "
          f"{norm['residual_library_ms']:.4f} ms, bound "
          f"{norm['residual_bound_ms']:.5f} ms; prefill (6370, 4096) "
          f"{norm['prefill_ms']:.4f} ms, x + r and rms_norm "
          f"{norm['prefill_library_ms']:.4f} ms, bound "
          f"{norm['prefill_bound_ms']:.4f} ms; training (16384, 2048) "
          f"{norm['train_ms']:.4f} ms, x + r and rms_norm "
          f"{norm['train_library_ms']:.4f} ms, bound "
          f"{norm['train_bound_ms']:.4f} ms; max |err| "
          f"{norm['max_abs_err']:.3g}; plans {norm['plan']}, "
          f"{norm['prefill_plan']}, {norm['train_plan']}")

    # the backward at the training shape, with and without gh
    n, d = 16384, 2048
    err = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        h, gy, gh = randn(n, d, dtype=dtype), randn(n, d, dtype=dtype), \
            randn(n, d, dtype=dtype)
        w = randn(d, dtype=dtype)
        _, _, rstd = fn._norm_fwd(h, w, None, eps, want_rstd=True)
        _check(f"rms_norm rstd {dtype}", rstd,
               fn._rmsn_fwd_math(h, w, eps)[1].reshape(-1), F32_TOL)
        for gh_ in (None, gh):
            dh, dw = fn.rms_norm_residual_bwd(h, w, rstd, gy, gh_)
            rdh, rdw = fn.rms_norm_residual_bwd_ref(h, w, rstd, gy, gh_)
            torch.cuda.synchronize()
            tag = f"{dtype} gh={gh_ is not None}"
            e = _check(f"rms_norm_bwd dh {tag}", dh, rdh, tol)
            # dw sums 16384 rows: held to its largest entry
            e = max(e, _check_to_max(f"rms_norm_bwd dw {tag}", dw, rdw, tol))
            if not torch.equal(fn.rms_norm_residual_bwd(h, w, rstd, gy,
                                                         gh_)[1], dw):
                raise AssertionError("rms_norm_bwd: dw not deterministic")
            if dtype == torch.bfloat16:
                err = max(err, e)
    sets = [(h, w, rstd, gy)]
    gsets = [(h, w, rstd, gy, gh)]
    elem = n * d
    bwd = dict(
        name="rms_norm_residual_bwd", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/fused_norm.cu",
        replaces="paddle_tpu/kernels/fused_norm.py:225", max_abs_err=err,
        ms=_time_ms(fn.rms_norm_residual_bwd, sets, iters=20),
        plain_ms=_time_ms(fn.rms_norm_residual_bwd_ref, sets, iters=5),
        library_ms=None,
        library_note="no single PyTorch call computes the RMSNorm backward",
        shape=f"h ({n}, {d}) bf16, no residual gradient; ms includes the "
              "sum of the dw partials",
        plan=_plan_json(fn.plan(n, d, torch.bfloat16, backward=True,
                                sms=fn._sm_count(dev))),
        gh_ms=_time_ms(fn.rms_norm_residual_bwd, gsets, iters=20),
        gh_plain_ms=_time_ms(fn.rms_norm_residual_bwd_ref, gsets, iters=5))
    bwd["bound_ms"], bwd["bound_by"] = _bound(
        3 * elem * 2 + n * 4 + 2 * d * 2, 8 * elem, F32_FLOPS)
    bwd["gh_bound_ms"] = _bound(4 * elem * 2 + n * 4 + 2 * d * 2, 9 * elem,
                                F32_FLOPS)[0]
    print(f"[kernel] rms_norm_residual_bwd bf16 ({n}, {d}): "
          f"{bwd['ms']:.4f} ms, plain {bwd['plain_ms']:.4f} ms, bound "
          f"{bwd['bound_ms']:.4f} ms; with gh {bwd['gh_ms']:.4f} ms, plain "
          f"{bwd['gh_plain_ms']:.4f} ms, bound {bwd['gh_bound_ms']:.4f} ms; "
          f"max |err| {err:.3g}; plan {bwd['plan']}")
    del h, gy, gh, dh, rdh, sets, gsets
    torch.cuda.empty_cache()
    return {"rms_norm_residual": norm, "rms_norm_residual_bwd": bwd}


def kernel_phases(dev, pa):
    """Returns {kernel name: JSON entry without launches}."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # paged decode: b=8, hq=32, hk=8, d=128, page 16, 641 pages, 80 per slot
    b, hq, hk, hd, ps, npages, mp = 8, 32, 8, 128, 16, 641, 80
    lens_l = [0, 15, 16, 1000, 1279, 517, 64, 300]
    rng = np.random.default_rng(0)
    bt = torch.from_numpy(rng.permutation(np.arange(1, npages))[:b * mp]
                          .reshape(b, mp).astype(np.int32)).to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp = randn(b, hq, hd, dtype=dtype), \
            randn(npages, hk, ps, hd, dtype=dtype), \
            randn(npages, hk, ps, hd, dtype=dtype)
        e = _check(f"paged_decode {dtype}",
                   pa.paged_decode_attention(q, kp, vp, bt, lens),
                   pa.paged_decode_attention_ref(q, kp, vp, bt, lens),
                   F32_TOL)
        if dtype == torch.bfloat16:
            err = e
    # 4 distinct pool sets (42 MB each) so the timed reads miss the 50 MB
    # L2, as each layer's pools do on the serving path
    psets = [(randn(b, hq, hd), randn(npages, hk, ps, hd),
              randn(npages, hk, ps, hd)) for _ in range(4)]

    def kern(q, kp, vp):
        return pa.paged_decode_attention(q, kp, vp, bt, lens)

    def plain(q, kp, vp):
        return pa.paged_decode_attention_ref(q, kp, vp, bt, lens)

    # the yardstick: one SDPA call over each slot's gathered dense window
    # (gathered outside the timing), masked to its length
    L = mp * ps
    visible = (torch.arange(L, device=dev)[None, :]
               <= lens[:, None].long())[:, None, None, :]
    dense = []
    for q, kp, vp in psets:
        kd = kp[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hk, L, hd)
        vd = vp[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hk, L, hd)
        dense.append((q[:, :, None, :], kd.contiguous(), vd.contiguous()))

    def library(q4, kd, vd):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=visible, enable_gqa=True)

    ref_lib = library(*dense[0])[:, :, 0].float()
    _check("sdpa yardstick", ref_lib, plain(*psets[0]), 2e-2)
    vis = sum(x + 1 for x in lens_l)
    per, n_split = pa.plan(mp, ps)
    dec = dict(
        name="paged_decode_attention", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        replaces="paddle_tpu/kernels/paged_attention.py:274",
        max_abs_err=err, ms=_time_ms(kern, psets),
        plain_ms=_time_ms(plain, psets, iters=20),
        library_ms=_time_ms(library, dense),
        shape=f"b={b} hq={hq} hk={hk} d={hd} page={ps} lens={lens_l} bf16",
        pages_per_split=per, n_split=n_split)
    nbytes = (vis * hk * hd * 2 * 2 + b * hq * hd * 2 + b * hq * hd * 4
              + b * mp * 4 + b * 4)
    dec["bound_ms"], dec["bound_by"] = _bound(
        nbytes, 4 * vis * hq * hd, BF16_TENSOR_FLOPS)
    dec.update(_full_window(pa, psets, dense, bt, mp * ps, hq, hk, hd,
                            kv_bytes=2))
    dec.update(_draft_decode(pa, randn, bt, lens, lens_l, hq, hk, ps,
                             npages))
    dec["max_abs_err"] = max(err, dec["draft_max_abs_err"])
    print(f"[kernel] paged_decode_attention bf16 {dec['shape']}: "
          f"{dec['ms']:.4f} ms, plain {dec['plain_ms']:.4f} ms, sdpa "
          f"{dec['library_ms']:.4f} ms, bound {dec['bound_ms']:.5f} ms; "
          f"max |err| {err:.3g}; P {per} pages, {n_split} splits; full "
          f"window (lens {mp * ps - 1} x {b}) {dec['full_window_ms']:.4f} "
          f"ms, sdpa {dec['full_window_library_ms']:.4f} ms, bound "
          f"{dec['full_window_bound_ms']:.5f} ms; {dec['draft_shape']}: "
          f"{dec['draft_ms']:.4f} ms, plain {dec['draft_plain_ms']:.4f} "
          f"ms, sdpa {dec['draft_library_ms']:.4f} ms, bound "
          f"{dec['draft_bound_ms']:.5f} ms, max |err| "
          f"{dec['draft_max_abs_err']:.3g}")
    return {dec["name"]: dec}


def _draft_decode(pa, randn, bt, lens, lens_l, hq, hk, ps, npages):
    """The decode kernel at the decode shape of phase 12's Llama-3.2-1B-
    width draft (head_dim 64, its 32 q / 8 kv heads, the target's slots,
    pages and block tables): held against its twin in f32 and bf16 at
    the phase's lens and with the whole window visible, then timed over
    4 pool sets (21 MB each) beside its twin, its bound and SDPA over
    each slot's gathered window masked to its length (the d-128 entry's
    yardstick)."""
    (b, mp), hd = bt.shape, 64
    full = torch.full_like(lens, mp * ps - 1)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp = randn(b, hq, hd, dtype=dtype), \
            randn(npages, hk, ps, hd, dtype=dtype), \
            randn(npages, hk, ps, hd, dtype=dtype)
        for tag, ln in (("lens", lens), ("full window", full)):
            e = _check(f"paged_decode d={hd} {tag} {dtype}",
                       pa.paged_decode_attention(q, kp, vp, bt, ln),
                       pa.paged_decode_attention_ref(q, kp, vp, bt, ln),
                       F32_TOL)
            if dtype == torch.bfloat16:
                err = max(err, e)
    psets = [(randn(b, hq, hd), randn(npages, hk, ps, hd),
              randn(npages, hk, ps, hd)) for _ in range(4)]
    L = mp * ps
    visible = (torch.arange(L, device=bt.device)[None, :]
               <= lens[:, None].long())[:, None, None, :]
    dense = []
    for q, kp, vp in psets:
        kd = kp[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hk, L, hd)
        vd = vp[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, hk, L, hd)
        dense.append((q[:, :, None, :], kd.contiguous(), vd.contiguous()))

    def library(q4, kd, vd):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=visible, enable_gqa=True)

    q, kp, vp = psets[0]
    _check(f"sdpa yardstick d={hd}", library(*dense[0])[:, :, 0].float(),
           pa.paged_decode_attention_ref(q, kp, vp, bt, lens), 2e-2)
    vis = sum(x + 1 for x in lens_l)
    nbytes = (vis * hk * hd * 2 * 2 + b * hq * hd * 2 + b * hq * hd * 4
              + b * mp * 4 + b * 4)
    return dict(
        draft_shape=f"b={b} hq={hq} hk={hk} d={hd} page={ps} "
                    f"lens={lens_l} bf16",
        draft_max_abs_err=err,
        draft_library_ms=_time_ms(library, dense),
        draft_ms=_time_ms(lambda q, kp, vp: pa.paged_decode_attention(
            q, kp, vp, bt, lens), psets),
        draft_plain_ms=_time_ms(lambda q, kp, vp:
                                pa.paged_decode_attention_ref(
                                    q, kp, vp, bt, lens), psets, iters=20),
        draft_bound_ms=_bound(nbytes, 4 * vis * hq * hd,
                              BF16_TENSOR_FLOPS)[0])


def _full_window(pa, psets, dense, bt, L, hq, hk, hd, kv_bytes):
    """The decode kernel with every slot at lens L - 1 (the whole window
    of every block table visible, the steady state of long generation):
    held against its twin, timed over the same pool sets beside SDPA over
    the gathered windows (`dense`, as the caller built them), and its
    bytes bound. int8 pools (kv_bytes 1) also read a scale pair per page
    and head."""
    b, mp = bt.shape
    lens = torch.full((b,), L - 1, dtype=torch.int32, device=bt.device)
    ps = L // mp

    def kw(sc):
        return dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}

    def kern(q, kp, vp, *sc):
        return pa.paged_decode_attention(q, kp, vp, bt, lens, **kw(sc))

    def library(q4, kd, vd):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, enable_gqa=True)

    q, kp, vp, *sc = psets[0]
    _check("paged_decode full window", kern(*psets[0]),
           pa.paged_decode_attention_ref(q, kp, vp, bt, lens, **kw(sc)),
           F32_TOL)
    nbytes = (b * L * hk * hd * kv_bytes * 2 + b * hq * hd * 2
              + b * hq * hd * 4 + b * mp * 4 + b * 4
              + (b * mp * hk * 2 * 4 if kv_bytes == 1 else 0))
    return dict(full_window_ms=_time_ms(kern, psets),
                full_window_bound_ms=_bound(nbytes, 4 * b * L * hq * hd,
                                            BF16_TENSOR_FLOPS)[0],
                full_window_library_ms=_time_ms(library, dense))


# -- phase 3, int8 serving: the int8 decode kernel and W8A16 -------------------

# Llama-3-8B's distinct projection shapes (K, N): the layers that use them
W8A16_SHAPES = (("q_proj, o_proj", 4096, 4096, 2),
                ("k_proj, v_proj", 4096, 1024, 2),
                ("gate_proj, up_proj", 4096, 14336, 2),
                ("down_proj", 14336, 4096, 1),
                ("lm_head", 4096, 128256, 0))


def _prefill_call_ms(prompts, late, bucket):
    """M (rows of x) of each of the engine's batched prefill calls when
    `prompts` but `late` are submitted at once and `late` joins later:
    same-bucket prompts go together in admission order, padded to the
    group's longest (PagedKVEngine._admit); the late joiner comes alone."""
    groups = {}
    for i, p in enumerate(prompts):
        if i != late:
            groups.setdefault(bucket(p.size), []).append(p.size)
    return [len(g) * max(g) for g in groups.values()] + [prompts[late].size]


def int8_kernel_phases(dev, pa, qm, prefill_m, late_m):
    """paged_decode_attention_int8 and weight_only_int8_matmul entries,
    each held against its twin on the card and timed; the W8A16 entries
    also at the M of the first prefill call and of the late joiner's."""
    g = torch.Generator(device=dev).manual_seed(20)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 0.02 + 1e-3

    # int8 decode at the serving shapes of row 1 (kernel_phases)
    b, hq, hk, hd, ps, npages, mp = 8, 32, 8, 128, 16, 641, 80
    lens_l = [0, 15, 16, 1000, 1279, 517, 64, 300]
    rng = np.random.default_rng(0)
    bt = torch.from_numpy(rng.permutation(np.arange(1, npages))[:b * mp]
                          .reshape(b, mp).astype(np.int32)).to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)

    def pool_set(dtype=torch.bfloat16):
        return (randn(b, hq, hd, dtype=dtype), codes(npages, hk, ps, hd),
                codes(npages, hk, ps, hd), scales(npages, hk),
                scales(npages, hk))

    def kern(q, kp, vp, ks, vs):
        return pa.paged_decode_attention(q, kp, vp, bt, lens, k_scale=ks,
                                         v_scale=vs)

    def plain(q, kp, vp, ks, vs):
        return pa.paged_decode_attention_ref(q, kp, vp, bt, lens,
                                             k_scale=ks, v_scale=vs)

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = pool_set(dtype)
        e = _check(f"paged_decode_int8 q {dtype}", kern(*args), plain(*args),
                   F32_TOL)
        if dtype == torch.bfloat16:
            err = e
    # 4 pool sets (21 MB each) so the timed reads miss the 50 MB L2
    psets = [pool_set() for _ in range(4)]
    L = mp * ps
    visible = (torch.arange(L, device=dev)[None, :]
               <= lens[:, None].long())[:, None, None, :]
    dense = []
    for q, kp, vp, ks, vs in psets:     # gathered and dequantized, untimed
        kd = pa.gather_window(kp, ks, bt.long()).to(torch.bfloat16)
        vd = pa.gather_window(vp, vs, bt.long()).to(torch.bfloat16)
        dense.append((q[:, :, None, :], kd.contiguous(), vd.contiguous()))

    def library(q4, kd, vd):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=visible, enable_gqa=True)

    _check("sdpa yardstick int8", library(*dense[0])[:, :, 0].float(),
           plain(*psets[0]), 2e-2)
    vis = sum(x + 1 for x in lens_l)
    pages = sum(x // ps + 1 for x in lens_l)
    per, n_split = pa.plan(mp, ps)
    dec = dict(
        name="paged_decode_attention_int8", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        replaces="paddle_tpu/kernels/paged_attention.py:274",
        max_abs_err=err, ms=_time_ms(kern, psets),
        plain_ms=_time_ms(plain, psets, iters=20),
        library_ms=_time_ms(library, dense),
        shape=f"b={b} hq={hq} hk={hk} d={hd} page={ps} lens={lens_l} int8 "
              "pools, bf16 q; library: SDPA over the gathered, dequantized "
              "bf16 window",
        pages_per_split=per, n_split=n_split)
    nbytes = (vis * hk * hd * 2 + pages * hk * 2 * 4 + b * hq * hd * 2
              + b * hq * hd * 4 + b * mp * 4 + b * 4)
    dec["bound_ms"], dec["bound_by"] = _bound(
        nbytes, 4 * vis * hq * hd, BF16_TENSOR_FLOPS)
    dec.update(_full_window(pa, psets, dense, bt, L, hq, hk, hd,
                            kv_bytes=1))
    print(f"[kernel] paged_decode_attention_int8 {dec['shape']}: "
          f"{dec['ms']:.4f} ms, plain {dec['plain_ms']:.4f} ms, sdpa "
          f"{dec['library_ms']:.4f} ms, bound {dec['bound_ms']:.5f} ms; "
          f"max |err| {err:.3g}; P {per} pages, {n_split} splits; full "
          f"window (lens {L - 1} x {b}) {dec['full_window_ms']:.4f} ms, "
          f"sdpa {dec['full_window_library_ms']:.4f} ms, bound "
          f"{dec['full_window_bound_ms']:.5f} ms")
    del psets, dense

    # W8A16 at every distinct projection shape, at the decode step's M = 8,
    # at the spec verify's M = 8 (g + 1), at the M of the engine's first
    # batched prefill call and at the late joiner's
    print(f"[kernel] W8A16 at M = 8, M = {SPEC_VERIFY_M} (phase 12's verify: "
          f"8 slots x {SPEC_G + 1} positions), M = {prefill_m} (the first "
          f"prefill call: its prompts x their longest length) and M = "
          f"{late_m} (the late joiner's prefill)")
    sms = qm._sm_count(torch.device(dev))
    per_shape, err, ratio = [], 0.0, 0.0
    for what, K, N, per_layer in W8A16_SHAPES:
        n_sets = max(1, min(40, -(-150 * 2 ** 20 // (K * N))))
        weights = [(codes(K, N), scales(N)) for _ in range(n_sets)]
        deq = [((qw.float() * s).to(torch.bfloat16),) for qw, s in
               weights[:max(1, n_sets // 2)]]
        for M in (8, SPEC_VERIFY_M, prefill_m, late_m):
            x = randn(M, K)
            out = qm.weight_only_int8_matmul(x, *weights[0])
            ref = qm.weight_only_int8_matmul_ref(x, *weights[0])
            e, r = _check_rows(f"w8a16 {what} M={M}", out, ref, BF16_TOL)
            err, ratio = max(err, e), max(ratio, r)
            iters = 50 if M <= SPEC_VERIFY_M else 10
            row = dict(layers=what, M=M, K=K, N=N, per_layer=per_layer,
                       err=e, rule_ratio=r,
                       ms=_time_ms(lambda qw, s: qm.weight_only_int8_matmul(
                           x, qw, s), weights, iters=iters),
                       plain_ms=_time_eager_ms(
                           lambda qw, s: qm.weight_only_int8_matmul_ref(
                               x, qw, s), weights, iters=2),
                       library_ms=_time_ms(lambda w: torch.matmul(x, w), deq,
                                           iters=iters))
            row["route"], row["tile_rows"], row["splits"] = qm.plan(M, K, N,
                                                                   sms)
            row["bound_ms"], row["bound_by"] = _bound(
                M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * N * K,
                BF16_TENSOR_FLOPS)
            per_shape.append(row)
            print(f"[kernel] w8a16 {what} (M {M}, K {K}, N {N}, route "
                  f"{row['route']}, {row['tile_rows']}-row tile, "
                  f"{row['splits']} splits): {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, bf16 matmul of the dequantized "
                  f"weight {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}); |err| / "
                  f"bound {r:.3g}")
            del x, out, ref
        del weights, deq
    # f32 x at a small ragged shape (a last k-tile of 8, a last column
    # tile of 80), both output types
    x, qw, s = randn(37, 200, dtype=torch.float32), codes(200, 208), \
        scales(208)
    for out_dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16,
                                                       BF16_TOL)):
        _check_rows(f"w8a16 f32 x -> {out_dtype} (37, 200, 208)",
                    qm.weight_only_int8_matmul(x, qw, s, out_dtype),
                    qm.weight_only_int8_matmul_ref(x, qw, s, out_dtype), tol)
    # the entry: one decode step's W8A16 work (M = 8): 32 layers of seven
    # projections and the lm_head once
    def step_sum(key, m=8):
        return sum(r[key] * (32 * r["per_layer"] if r["per_layer"] else 1)
                   for r in per_shape if r["M"] == m)

    mm = dict(
        name="weight_only_int8_matmul", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
        replaces="paddle_tpu/kernels/quant_matmul.py:85",
        max_abs_err=err, ms=step_sum("ms"), plain_ms=step_sum("plain_ms"),
        bound_ms=step_sum("bound_ms"), bound_by="bytes",
        library_ms=step_sum("library_ms"),
        shape="one decode step at M = 8: 32 x (q, k, v, o, gate, up, down) "
              "+ lm_head, bf16 x; library: torch.matmul over the "
              "dequantized bf16 weights (the unquantized layers' cost)",
        rule_ratio=ratio, prefill_m=prefill_m, shapes=per_shape)
    print(f"[kernel] weight_only_int8_matmul, {mm['shape']}: {mm['ms']:.4f} "
          f"ms, plain {mm['plain_ms']:.4f} ms, bf16 matmul "
          f"{mm['library_ms']:.4f} ms, bound {mm['bound_ms']:.4f} ms; "
          f"|err| / bound at most {ratio:.3g} (bound 2^-7 (|ref| + row RMS "
          "+ 2^-6 RMS))")
    # the wgmma route's entry: one first prefill call's projections (32
    # layers of seven; its lm_head runs at M = the group's prompt count)
    pre = [r for r in per_shape if r["M"] == prefill_m and r["per_layer"]]
    if any(r["route"] != "wgmma" for r in pre):
        raise AssertionError(f"W8A16 at M = {prefill_m} did not take the "
                             f"wgmma route: {[r['route'] for r in pre]}")

    def call_sum(key):
        return sum(r[key] * 32 * r["per_layer"] for r in pre)

    wg = dict(
        name="weight_only_int8_matmul_wgmma", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
        replaces="paddle_tpu/kernels/quant_matmul.py:85",
        max_abs_err=max(r["err"] for r in pre), ms=call_sum("ms"),
        plain_ms=call_sum("plain_ms"), bound_ms=call_sum("bound_ms"),
        bound_by="operations", library_ms=call_sum("library_ms"),
        shape=f"one prefill call at M = {prefill_m}: 32 x (q, k, v, o, gate, "
              "up, down), bf16 x; library: torch.matmul over the dequantized "
              "bf16 weights (the unquantized layers' cost)",
        rule_ratio=max(r["rule_ratio"] for r in pre), prefill_m=prefill_m)
    # and one spec verify's W8A16 work (phase 12 (c)): 32 layers of seven
    # and the lm_head, all at M = 8 (g + 1)
    ver = [r for r in per_shape if r["M"] == SPEC_VERIFY_M]
    if any(r["route"] != "wgmma" for r in ver):
        raise AssertionError(f"W8A16 at M = {SPEC_VERIFY_M} did not take "
                             f"the wgmma route: {[r['route'] for r in ver]}")
    wg.update({f"spec_verify_{k}": step_sum(k, SPEC_VERIFY_M)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")})
    wg["spec_verify_m"] = SPEC_VERIFY_M
    print(f"[kernel] weight_only_int8_matmul_wgmma, {wg['shape']}: "
          f"{wg['ms']:.4f} ms, plain {wg['plain_ms']:.4f} ms, bf16 matmul "
          f"{wg['library_ms']:.4f} ms, bound {wg['bound_ms']:.4f} ms; one "
          f"spec verify at M = {SPEC_VERIFY_M} (224 projections + lm_head) "
          f"{wg['spec_verify_ms']:.4f} ms, bf16 matmul "
          f"{wg['spec_verify_library_ms']:.4f} ms, bound "
          f"{wg['spec_verify_bound_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return {k["name"]: k for k in (dec, mm, wg)}


# -- phase 4: the training path's kernels ---------------------------------------

def _flash_cost(b, s, hq, hk, d, causal):
    """Visible (query, key) pairs and the bf16 bytes of one q-sized and
    one k-sized (B, S, H, D) tensor."""
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    return pairs, b * s * hq * d * 2, b * s * hk * d * 2


def flash_phases(dev, fa):
    """flash_fwd, flash_bwd_dq, flash_bwd_dkv entries: checked in f32 at
    small shapes and in bf16 at the training and Llama-3 head shapes
    (the twins at b <= 2 there: at b = 8 their (b, h, s, s) f32 scores
    would take ~25 GB), timed at both shapes."""
    g = torch.Generator(device=dev).manual_seed(10)

    def inputs(b, s, hq, hk, d, dtype):
        return [torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                for h in (hq, hk, hk, hq)]

    ratios = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}

    def held(kernel, name, got, want, tol):
        e, r = _check_rows(name, got, want, tol)
        ratios[kernel] = max(ratios[kernel], r)
        return e

    for b, s, hq, hk, d in ((2, 200, 8, 2, 64), (1, 160, 8, 2, 128)):
        for causal in (True, False):
            q, k, v, do = inputs(b, s, hq, hk, d, torch.float32)
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            ro, rlse = fa.flash_attention_fwd_ref(q, k, v, causal)
            tag = f"f32 {(b, s, hq, hk, d)} causal={causal}"
            held("flash_fwd", f"flash fwd {tag}", o, ro, F32_TOL)
            _check(f"flash lse {tag}", lse, rlse, F32_TOL)
            for kern, name, got, want in zip(
                    ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"),
                    ("dq", "dk", "dv"),
                    fa.flash_attention_bwd(q, k, v, o, lse, do, causal),
                    fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)):
                held(kern, f"flash {name} {tag}", got, want, F32_TOL)
    print(f"[kernel] flash f32 at small shapes: |err| / bound at most "
          f"{ratios} (bound {F32_TOL} * (|ref| + row RMS + 2^-6 RMS))")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for tag, (b, s, hq, hk, d) in (("train", (8, 2048, 32, 4, 64)),
                                   ("llama3", (1, 4096, 32, 8, 128))):
        ratios = dict.fromkeys(ratios, 0.0)
        q, k, v, do = inputs(b, s, hq, hk, d, torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        cb = min(b, 2)
        q2, k2, v2, do2 = (t[:cb] for t in (q, k, v, do))
        ro, rlse = fa.flash_attention_fwd_ref(q2, k2, v2, True)
        err = {"flash_fwd": max(
            held("flash_fwd", f"flash fwd {tag}", o[:cb], ro,
                 FLASH_BF16_TOL),
            _check(f"flash lse {tag}", lse[:cb], rlse, F32_TOL))}
        del ro, rlse
        rdq, rdk, rdv = fa.flash_attention_bwd_ref(q2, k2, v2, o[:cb],
                                                   lse[:cb], do2, True)
        err["flash_bwd_dq"] = held("flash_bwd_dq", f"flash dq {tag}",
                                   dq[:cb], rdq, FLASH_BF16_TOL)
        err["flash_bwd_dkv"] = max(
            held("flash_bwd_dkv", f"flash dk {tag}", dk[:cb], rdk,
                 FLASH_BF16_TOL),
            held("flash_bwd_dkv", f"flash dv {tag}", dv[:cb], rdv,
                 FLASH_BF16_TOL))
        del rdq, rdk, rdv, q2, k2, v2, do2
        torch.cuda.empty_cache()
        # the two backward kernels alone, for their times
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_o = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        _check_to_max(f"sdpa yardstick {tag}", lib_o.transpose(1, 2), o,
                      FLASH_BF16_TOL)
        del lib_o
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            res = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
            torch.autograd.grad(res, (qr, kr, vr), dot)

        lib_fwd = _time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True), [()], iters=20)
        lib_bwd = _time_eager_ms(sdpa_fwd_bwd, [()], iters=10) - lib_fwd
        ms = {"flash_fwd": _time_ms(
                  lambda: fa.flash_attention_fwd(q, k, v, True), [()],
                  iters=20),
              "flash_bwd_dq": _time_ms(lambda: fa._launch_dq(
                  q, k, v, do, lse, delta, True, None), [()], iters=20),
              "flash_bwd_dkv": _time_ms(lambda: fa._launch_dkv(
                  q, k, v, do, lse, delta, True, None), [()], iters=20)}
        fwd_plain = _time_eager_ms(
            lambda: fa.flash_attention_fwd_ref(q, k, v, True), [()], iters=2)
        bwd_plain = _time_eager_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, o, lse, do, True), [()], iters=2)
        pairs, qbytes, kbytes = _flash_cost(b, s, hq, hk, d, True)
        rows = b * hq * s * 4                       # one f32 per query row
        bounds = {
            "flash_fwd": _bound(2 * qbytes + 2 * kbytes + rows,
                                4 * pairs * d, BF16_TENSOR_FLOPS),
            "flash_bwd_dq": _bound(3 * qbytes + 2 * kbytes + 2 * rows,
                                   6 * pairs * d, BF16_TENSOR_FLOPS),
            "flash_bwd_dkv": _bound(2 * qbytes + 4 * kbytes + 2 * rows,
                                    8 * pairs * d, BF16_TENSOR_FLOPS)}
        shape = f"(b {b}, s {s}, hq {hq}, hk {hk}, d {d}) causal bf16"
        for name in ms:
            e = out.setdefault(name, {})
            pre = "" if tag == "train" else "llama3_"
            e[pre + "ms"] = ms[name]
            e[pre + "plain_ms"] = (fwd_plain if name == "flash_fwd"
                                   else bwd_plain)
            e[pre + "bound_ms"], e[pre + "bound_by"] = bounds[name]
            e[pre + "library_ms"] = (lib_fwd if name == "flash_fwd"
                                     else lib_bwd)
            e[pre + "shape"] = shape
            # the largest |err| over its bound, FLASH_BF16_TOL * (|ref| +
            # row RMS): under 1, or the run has failed
            e[pre + "err_over_bound"] = ratios[name]
            e["max_abs_err"] = max(e.get("max_abs_err", 0.0), err[name])
        print(f"[kernel] flash {shape}: fwd {ms['flash_fwd']:.4f} ms "
              f"(bound {bounds['flash_fwd'][0]:.4f}), dq "
              f"{ms['flash_bwd_dq']:.4f} ms (bound "
              f"{bounds['flash_bwd_dq'][0]:.4f}), dk/dv "
              f"{ms['flash_bwd_dkv']:.4f} ms (bound "
              f"{bounds['flash_bwd_dkv'][0]:.4f}); plain fwd "
              f"{fwd_plain:.2f} ms, plain bwd {bwd_plain:.2f} ms; sdpa fwd "
              f"{lib_fwd:.4f} ms, sdpa bwd {lib_bwd:.4f} ms; max |err| "
              f"{err}, |err| / bound at most {ratios}")
        del q, k, v, do, o, lse, delta, dq, dk, dv, qr, kr, vr
        torch.cuda.empty_cache()
    replaces = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:529",
                "flash_bwd_dq": "paddle_tpu/kernels/flash_attention.py:998",
                "flash_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:1016"}
    # the kernels in flash_attention.cu and the instructions they run on
    kernel = {"flash_fwd": "wg::flash_fwd_wgmma (wgmma m64n128k16 S = Q K^T, "
                           "Q from shared memory at d 64 and in registers at "
                           "d 128; m64nDk16 O += P V with P in registers; "
                           "TMA, 128-byte swizzle; a persistent grid of 3 "
                           "warpgroups a block at d 64, 2 at d 128)",
              "flash_bwd_dq": "wg::flash_dq_wgmma (wgmma m64n64k16, TMA, "
                              "128-byte swizzle)",
              "flash_bwd_dkv": "wg::flash_dkv_wgmma (wgmma m64n64k16, TMA, "
                               "128-byte swizzle)"}
    for name, e in out.items():
        e.update(name=name, route="cuda",
                 source="paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                 replaces=replaces[name], kernel=kernel[name])
        if name != "flash_fwd":
            e["library_note"] = ("the SDPA backward computes dq, dk and dv "
                                 "together")
    out["flash_bwd_dq"]["also_replaces"] = [
        "paddle_tpu/kernels/flash_attention.py:980",
        "paddle_tpu/kernels/flash_attention.py:945 (with flash_bwd_dkv)"]
    return out


def _check_equal(name, out, ref):
    """out must have ref's bits; returns max |out - ref| (0.0)."""
    if not torch.equal(out, ref):
        err = float((out.float() - ref.float()).abs().max())
        raise AssertionError(f"{name}: not bit-equal to the twin (max |err| "
                             f"{err})")
    return 0.0


def rope_phases(dev, fn, prefill_m):
    """The rope_apply and rope_apply_bwd entries. Both are held bit for bit
    against their twins (the kernel rounds each product and the sum as the
    twin does) in f32 and bf16 at the decode shapes (8, 1, 32|8, 128) at
    scattered positions, the first batched prefill call's (1, prefill_m,
    32|8, 128) and the training shapes (8, 2048, 32|4, 64), forward and
    backward, then timed in bf16 at each shape, q and k, beside the twin
    and the bound (x read and written once, the two f32 tables read
    once). The forward entry's own time is decode's q, the backward's
    training's q."""
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def seq_pos(b, s):
        return torch.arange(s, dtype=torch.int32, device=dev).repeat(b)

    decode_pos = torch.randint(0, 1280, (8,), generator=g, device=dev,
                               dtype=torch.int32)
    # tag: (b, s, q heads, k heads, d, theta, flat positions)
    shapes = {"decode": (8, 1, 32, 8, 128, 500000.0, decode_pos),
              "prefill": (1, prefill_m, 32, 8, 128, 500000.0,
                          seq_pos(1, prefill_m)),
              "train": (8, 2048, 32, 4, 64, 10000.0, seq_pos(8, 2048))}
    fwd = dict(name="rope_apply", route="cuda",
               source="paddle_tpu_torch/kernels/csrc/fused_norm.cu",
               replaces="paddle_tpu/kernels/fused_norm.py:380",
               library_ms=None,
               library_note="no single PyTorch call computes the RoPE "
                            "rotation")
    bwd = dict(fwd, name="rope_apply_bwd",
               also_replaces="paddle_tpu/kernels/fused_norm.py:415 (the "
                             "same kernel launched on -sin_f)")
    for tag, (b, s, hq, hk, d, theta, pos) in shapes.items():
        tables = fn.rope_tables(pos, d, theta)
        for dtype in (torch.float32, torch.bfloat16):
            for heads in (hq, hk):
                x = randn(b, s, heads, d, dtype=dtype)
                _check_equal(f"rope {tag} {dtype} h={heads}",
                             fn.rope_apply(x, tables=tables),
                             fn.rope_apply_ref(x, tables=tables))
                _check_equal(f"rope_bwd {tag} {dtype} h={heads}",
                             fn.rope_apply_bwd(x, *tables),
                             fn.rope_apply_bwd_ref(x, *tables))
                del x
        for heads, kv in ((hq, ""), (hk, "k_")):
            xs = [(randn(b, s, heads, d),) for _ in range(4 if s == 1
                                                          else 1)]
            elem = b * s * heads * d
            bound = _bound(2 * elem * 2 + 2 * b * s * d * 4, 3 * elem,
                           F32_FLOPS)
            iters, plain_iters = (50, 50) if s == 1 else (20, 5)
            for e, kern, plain in (
                    (fwd, lambda a: fn.rope_apply(a, tables=tables),
                     lambda a: fn.rope_apply_ref(a, tables=tables)),
                    (bwd, lambda a: fn.rope_apply_bwd(a, *tables),
                     lambda a: fn.rope_apply_bwd_ref(a, *tables))):
                pre = f"{tag}_{kv}"
                e[pre + "ms"] = _time_ms(kern, xs, iters=iters)
                e[pre + "plain_ms"] = _time_ms(plain, xs, iters=plain_iters)
                e[pre + "bound_ms"], e[pre + "bound_by"] = bound
                e[pre + "shape"] = f"({b}, {s}, {heads}, {d}) bf16"
            del xs
        del tables
    for e, main in ((fwd, "decode_"), (bwd, "train_")):
        e.update(max_abs_err=0.0, ms=e[main + "ms"],
                 plain_ms=e[main + "plain_ms"], bound_ms=e[main + "bound_ms"],
                 bound_by=e[main + "bound_by"], shape=e[main + "shape"])
        print(f"[kernel] {e['name']} bf16, bit-equal to the twin in f32 and "
              f"bf16 at every shape: " + "; ".join(
                  f"{tag} {kv[:-1] or 'q'} {e[f'{tag}_{kv}shape']} "
                  f"{e[f'{tag}_{kv}ms']:.4f} ms (plain "
                  f"{e[f'{tag}_{kv}plain_ms']:.4f}, bound "
                  f"{e[f'{tag}_{kv}bound_ms']:.5f})"
                  for tag in shapes for kv in ("", "k_")))
    return {"rope_apply": fwd, "rope_apply_bwd": bwd}


def ce_phases(dev, bce, fnl):
    """ce_fwd, ce_dlogits, ce_dx, ce_dw entries: f32 at a small shape with
    one and with eight backward super-blocks, bf16 at the training shape
    (N 16384 = 8 x 2048 rows, D 2048, V 32000, every 2048th row ignored as
    the shifted labels leave it) and past the old int32 cap (N 18432, D
    4096, V 128256), each held against the twin (chunk 512), the backward
    the same bits twice; timed beside the twin and the dense path
    (torch.matmul logits and the port's dense cross_entropy, `fnl`), with
    the peak memory of both."""
    g = torch.Generator(device=dev).manual_seed(12)
    one = torch.ones((), device=dev)

    def inputs(n, d, v, dtype):
        x = torch.randn(n, d, generator=g, device=dev).to(dtype)
        w = (torch.randn(v, d, generator=g, device=dev) * 0.02).to(dtype)
        lab = torch.randint(0, v, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        return x, w, lab

    def kernels(x, w, lab):
        loss, lse, count = bce.ce_fwd(x, w, lab)
        return (loss, lse) + bce.ce_bwd(x, w, lab, lse, count, one)

    def twins(x, w, lab):
        loss, lse, count = bce.ce_fwd_ref(x, w, lab, 512)
        return (loss, lse) + bce.ce_bwd_ref(x, w, lab, lse, count, one, 512)

    def held(tag, got, want, tol):
        if abs(float(got[0]) - float(want[0])) > 1e-5 * abs(float(want[0])):
            raise AssertionError(f"ce loss {tag}: {float(got[0])} against "
                                 f"{float(want[0])}")
        err = {"lse": _check(f"ce lse {tag}", got[1], want[1], F32_TOL)}
        ratio = {}
        for name, a, b in (("dx", got[2], want[2]), ("dw", got[3], want[3])):
            err[name], ratio[name] = _check_rows(f"ce {name} {tag}", a, b, tol)
        return err, ratio

    budget = bce._WORKSPACE_BYTES
    f32_ratio = {}
    for supers in (1, 8):
        x, w, lab = inputs(300, 256, 1000, torch.float32)
        lab[::10] = -100
        bce._WORKSPACE_BYTES = 300 * 128 * 4 if supers > 1 else budget
        try:
            got = kernels(x, w, lab)
        finally:
            bce._WORKSPACE_BYTES = budget
        _, r = held(f"f32 (300, 256, 1000) {supers} super-blocks", got,
                    twins(x, w, lab), F32_TOL)
        f32_ratio[supers] = r
    print(f"[kernel] blockwise CE f32 (300, 256, 1000), 1 and 8 backward "
          f"super-blocks: |err| / bound at most {f32_ratio} (bound "
          f"{F32_TOL} * (|ref| + row RMS + 2^-6 RMS))")

    n, d, v = 16384, 2048, 32000
    x, w, lab = inputs(n, d, v, torch.bfloat16)
    lab[2047::2048] = -100
    got = kernels(x, w, lab)
    torch.cuda.synchronize()
    err, ratio = held("train", got, twins(x, w, lab), CE_BF16_TOL)
    again = kernels(x, w, lab)
    if not torch.equal(again[1], got[1]):
        raise AssertionError("ce forward: two calls differ")
    if not (torch.equal(again[2], got[2]) and torch.equal(again[3], got[3])):
        raise AssertionError("ce backward: two calls differ")
    del again
    loss, lse, count = bce.ce_fwd(x, w, lab)
    # one super-block's dS against the twin's, on its first 512 rows:
    # entry by entry within one bf16 step
    vs = bce.ce_super_block(n, v, 2)
    n_super = -(-v // vs)
    scale = torch.where(lab != -100, one / count, 0.0).contiguous()
    ws = torch.empty((n, vs), dtype=x.dtype, device=dev)
    bce._launch_dlogits(x, w, lab, lse, scale, ws, 0, vs)
    s_ref = x[:512].float() @ w[:vs].float().t()
    p_ref = torch.exp(s_ref - lse[:512, None])
    onehot = torch.arange(vs, device=dev)[None, :] == lab[:512, None]
    ds_ref = ((p_ref - onehot.float()) * scale[:512, None]).to(x.dtype)
    ds_err = (ws[:512].float() - ds_ref.float()).abs()
    if not (ds_err <= BF16_TOL * ds_ref.float().abs() + 1e-12).all():
        raise AssertionError(f"ce dS: |err| {float(ds_err.max())} past one "
                             "bf16 step")
    err["ds"] = float(ds_err.max())
    del s_ref, p_ref, onehot, ds_ref, ds_err

    acc = torch.empty((n, d), dtype=torch.float32, device=dev)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    blocks = [(i * vs, min(vs, v - i * vs)) for i in range(n_super)]
    ms = {"ce_fwd": _time_ms(lambda: bce.ce_fwd(x, w, lab), [()], iters=10),
          "ce_dlogits": _time_ms(lambda: [bce._launch_dlogits(
              x, w, lab, lse, scale, ws, v0, vc) for v0, vc in blocks],
              [()], iters=4),
          "ce_dx": _time_ms(lambda: [bce._launch_dx(
              ws, w, acc, dx, v0, vc, i == 0, i == n_super - 1)
              for i, (v0, vc) in enumerate(blocks)], [()], iters=4),
          "ce_dw": _time_ms(lambda: [bce._launch_dw(ws, x, dw, v0, vc)
                                     for v0, vc in blocks], [()], iters=4)}
    bwd_ms = _time_ms(lambda: bce.ce_bwd(x, w, lab, lse, count, one), [()],
                      iters=4)
    # torch.matmul of each bare product at the same shapes (bf16 out): a
    # yardstick of GEMM efficiency without the epilogues, never called by
    # the port
    s_out = {vc: torch.empty((n, vc), dtype=x.dtype, device=dev)
             for _, vc in blocks + [(0, v)]}
    matmul_ms = {
        "ce_fwd": _time_ms(lambda: torch.matmul(x, w.t(), out=s_out[v]),
                           [()], iters=10),
        "ce_dlogits": _time_ms(lambda: [torch.matmul(
            x, w[v0:v0 + vc].t(), out=s_out[vc]) for v0, vc in blocks],
            [()], iters=4),
        "ce_dx": _time_ms(lambda: [torch.matmul(ws[:, :vc], w[v0:v0 + vc],
                                                out=dx) for v0, vc in blocks],
                          [()], iters=4),
        "ce_dw": _time_ms(lambda: [torch.matmul(
            ws[:, :vc].t(), x, out=dw[v0:v0 + vc]) for v0, vc in blocks],
            [()], iters=4)}
    del s_out
    fwd_plain = _time_eager_ms(lambda: bce.ce_fwd_ref(x, w, lab, 512), [()],
                               iters=2)
    bwd_plain = _time_eager_ms(lambda: bce.ce_bwd_ref(
        x, w, lab, lse, count, one, 512), [()], iters=1)
    # the dense path at the same shape: logits, then the port's dense CE
    xr, wr = (t.detach().requires_grad_(True) for t in (x, w))

    def dense_fwd():
        return fnl.cross_entropy(x @ w.t(), lab)

    def dense_fwd_bwd():
        torch.autograd.grad(fnl.cross_entropy(xr @ wr.t(), lab), (xr, wr))

    def blockwise_fwd_bwd():
        torch.autograd.grad(bce.blockwise_ce_loss(xr, wr, lab, chunk=512),
                            (xr, wr))

    dense_fwd_ms = _time_eager_ms(dense_fwd, [()], iters=3)
    dense_fwd_bwd_ms = _time_eager_ms(dense_fwd_bwd, [()], iters=3)
    peak = {}
    for name, fn_ in (("dense", dense_fwd_bwd),
                      ("blockwise", blockwise_fwd_bwd)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn_()
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    flops = 2 * n * d * v
    in_bytes = n * d * 2 + v * d * 2 + n * 4
    bounds = {"ce_fwd": _bound(in_bytes + 2 * n * 4, flops,
                               BF16_TENSOR_FLOPS),
              "ce_dlogits": _bound(in_bytes + 2 * n * 4 + n * v * 2, flops,
                                   BF16_TENSOR_FLOPS),
              "ce_dx": _bound(n * v * 2 + v * d * 2 + n * d * 2, flops,
                              BF16_TENSOR_FLOPS),
              "ce_dw": _bound(n * v * 2 + n * d * 2 + v * d * 2, flops,
                              BF16_TENSOR_FLOPS)}
    replaces = {"ce_fwd": "paddle_tpu/kernels/blockwise_ce.py:426",
                "ce_dlogits": "paddle_tpu/kernels/blockwise_ce.py:467",
                "ce_dx": "paddle_tpu/kernels/blockwise_ce.py:467",
                "ce_dw": "paddle_tpu/kernels/blockwise_ce.py:485"}
    errs = {"ce_fwd": err["lse"], "ce_dlogits": err["ds"], "ce_dx": err["dx"],
            "ce_dw": err["dw"]}
    shape = f"x ({n}, {d}), W ({v}, {d}) bf16, {n_super} super-blocks of {vs}"
    out = {}
    for name in ms:
        out[name] = dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/kernels/csrc/blockwise_ce.cu",
            replaces=replaces[name], max_abs_err=errs[name], ms=ms[name],
            plain_ms=fwd_plain if name == "ce_fwd" else bwd_plain,
            bound_ms=bounds[name][0], bound_by=bounds[name][1],
            library_ms=None,
            library_note=("no single PyTorch call computes the lm_head "
                          "projection fused with the cross entropy or its "
                          "gradient; the dense path is the yardstick"),
            shape=shape, dense_fwd_ms=dense_fwd_ms,
            dense_fwd_bwd_ms=dense_fwd_bwd_ms, backward_ms=bwd_ms,
            backward_bound_ms=3 * flops / BF16_TENSOR_FLOPS * 1e3,
            dense_peak_gb=peak["dense"], blockwise_peak_gb=peak["blockwise"],
            f32_err_over_bound=f32_ratio, matmul_ms=matmul_ms[name])
        if name != "ce_fwd":
            out[name]["plain_note"] = "the twin's backward computes dx and dW"
    out["ce_dlogits"]["also_replaces"] = [
        "paddle_tpu/kernels/blockwise_ce.py:485 (the recompute of S)"]
    out["ce_dx"]["err_over_bound"] = ratio["dx"]
    out["ce_dw"]["err_over_bound"] = ratio["dw"]
    print(f"[kernel] blockwise CE {shape}: fwd {ms['ce_fwd']:.4f} ms (bound "
          f"{bounds['ce_fwd'][0]:.4f}), dS {ms['ce_dlogits']:.4f}, dx "
          f"{ms['ce_dx']:.4f}, dW {ms['ce_dw']:.4f} ms (bound "
          f"{bounds['ce_dx'][0]:.4f} each); torch.matmul of the bare "
          f"products: fwd {matmul_ms['ce_fwd']:.4f}, dS "
          f"{matmul_ms['ce_dlogits']:.4f}, dx {matmul_ms['ce_dx']:.4f}, dW "
          f"{matmul_ms['ce_dw']:.4f} ms; whole backward {bwd_ms:.4f} ms "
          f"(least work {3 * flops / BF16_TENSOR_FLOPS * 1e3:.4f}); plain "
          f"fwd {fwd_plain:.2f} ms, plain bwd {bwd_plain:.2f} ms; dense "
          f"logits + CE fwd {dense_fwd_ms:.2f} ms, fwd + bwd "
          f"{dense_fwd_bwd_ms:.2f} ms; peak memory of fwd + bwd beyond the "
          f"inputs: dense {peak['dense']:.3f} GB, blockwise "
          f"{peak['blockwise']:.3f} GB; max |err| {errs}, dx / dW |err| / "
          f"bound {ratio}")
    del x, w, lab, got, ws, acc, dx, dw, xr, wr
    torch.cuda.empty_cache()
    out["ce_dx"]["past_old_cap"] = out["ce_dw"]["past_old_cap"] = \
        _ce_past_old_cap(inputs, kernels, twins, held)
    torch.cuda.empty_cache()
    return out


def _ce_past_old_cap(inputs, kernels, twins, held):
    """The blockwise CE forward and backward at N 18432 = 9 x 2048 rows of
    Llama-3-8B's head (D 4096, V 128256): N x V = 2.36e9 offsets past
    the int32 cap that `ce_shape_problems` refused until the kernels'
    offsets were 64-bit. Held against the twin by phase 4's rules."""
    n, d, v = 18432, 4096, 128256
    x, w, lab = inputs(n, d, v, torch.bfloat16)
    lab[2047::2048] = -100
    got = kernels(x, w, lab)
    torch.cuda.synchronize()
    err, ratio = held("past the old cap", got, twins(x, w, lab),
                      CE_BF16_TOL)
    del got
    torch.cuda.empty_cache()
    fwd_bwd_ms = _time_eager_ms(lambda: kernels(x, w, lab), [()], iters=2)
    shape = f"x ({n}, {d}), W ({v}, {d}) bf16"
    print(f"[kernel] blockwise CE past the old int32 cap, {shape} (N x V = "
          f"{n * v}): forward + backward {fwd_bwd_ms:.2f} ms; max |err| "
          f"{err}, dx / dW |err| / bound {ratio}")
    del x, w, lab
    return dict(shape=shape, n_times_v=n * v, max_abs_err=err,
                err_over_bound=ratio, fwd_bwd_ms=fwd_bwd_ms)


# -- phase 5: Llama-3-8B serving ----------------------------------------------

def _prompts(n, vocab, seed, lo=128, hi=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def _engine(model, eager=False, **geom):
    """An engine on the model's card; `eager` runs every tick through
    the engine's private eager tick instead of its captured graph."""
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    eng = PagedKVEngine(model, device=model.device, **geom)
    if eager:
        eng._tick_program = eng._eager_program
    return eng


def _release():
    """Free the pools of an engine just dropped (an eager engine holds
    its own bound method, a cycle)."""
    gc.collect()
    torch.cuda.empty_cache()


def _serve(model, prompts, max_new, late, eager=False, sampled=(),
           **geom):
    """Submit all but `late` prompts, run one tick, submit the late one
    (it joins mid-decode), drain. `eager` runs every tick through the
    engine's private eager tick instead of its captured graph; the
    requests in `sampled` sample (`SPEC_SAMPLE`). Returns (engine, token
    lists)."""
    eng = _engine(model, eager, **geom)

    def submit(i):
        return eng.submit(prompts[i], max_new,
                          **(SPEC_SAMPLE if i in sampled else {}))
    reqs = {i: submit(i) for i in range(len(prompts)) if i != late}
    eng.step()
    reqs[late] = submit(late)
    eng.run_until_idle()
    return eng, [reqs[i].result() for i in range(len(prompts))]


def serving_phase(dev, counters, reset, card, profile=False):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    cfg = llama3_8b_config(fused_norm=True, fused_rope=True)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    print(f"[serve] Llama-3-8B bf16 built on the card in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
          "params)")
    geom = dict(max_slots=8, page_size=16, num_pages=641,
                max_pages_per_slot=80, steps_per_tick=4, kv_dtype="bf16")
    prompts = _prompts(8, cfg.vocab_size, seed=0)
    max_new = 64
    reset()
    t0 = time.perf_counter()
    eng, toks = _serve(model, prompts, max_new, late=7, **geom)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in counters().items() if k in SERVING_KERNELS}
    for i, t in enumerate(toks):
        if len(t) != max_new or not all(0 <= x < cfg.vocab_size for x in t):
            raise AssertionError(f"request {i}: {len(t)} tokens, want "
                                 f"{max_new} in-vocab")
    if sorted(eng._free) != list(range(1, eng.num_pages)) \
            or eng._reserved_unalloc != 0:
        raise AssertionError(f"pages not returned: free {len(eng._free)}, "
                             f"reserved {eng._reserved_unalloc}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    steps = _decode_steps(eng)
    if launches["paged_decode_attention"] != cfg.num_hidden_layers * steps:
        raise AssertionError(f"decode launches {launches} != 32 x {steps}")
    st = dict(eng.stats)
    traced = traced_replays(eng, counters, reset, card, "serve",
                            TRACED_DECODE)
    kv_slot = eng.kv_bytes_per_slot()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    eng2, toks2 = _serve(model, prompts, max_new, late=7, **geom)
    if toks2 != toks:
        raise AssertionError("second identical run gave other tokens")
    st2 = dict(eng2.stats)
    del eng2
    metrics = dict(
        card=card, prompt_lens=[int(p.size) for p in prompts],
        **_tick_metrics(st),
        prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
        # the same work again: host-clock rates vary from run to run
        repeat_decode_tokens_per_s=st2["decode_tokens"] / st2["tick_s"],
        repeat_prefill_tokens_per_s=(st2["prefill_tokens"]
                                     / st2["prefill_s"]),
        decode_steps=steps, kv_bytes_per_slot=kv_slot, wall_s=wall,
        peak_mem_gb=peak, launches=launches, tokens=toks,
        traced_replays=traced)
    metrics["eager"] = _eager_run(model, prompts, max_new, geom, toks,
                                  "serve")
    print(f"[serve] {card}: captured tick: decode "
          f"{metrics['decode_tokens_per_s']:.1f} tok/s, prefill "
          f"{metrics['prefill_tokens_per_s']:.1f} tok/s, tick "
          f"{metrics['tick_ms']:.2f} ms ({geom['steps_per_tick']} steps "
          f"of 8 slots; warm-up ticks {st['warmup_ticks']}, warm-up and "
          f"capture {st['warmup_s']:.2f} s), KV {kv_slot} B/slot, wall "
          f"{wall:.2f} s, peak {peak:.2f} GB, launches {launches}; second "
          f"run identical, decode "
          f"{metrics['repeat_decode_tokens_per_s']:.1f} tok/s, prefill "
          f"{metrics['repeat_prefill_tokens_per_s']:.1f} tok/s; eager tick "
          f"identical, decode "
          f"{metrics['eager']['decode_tokens_per_s']:.1f} tok/s, tick "
          f"{metrics['eager']['tick_ms']:.2f} ms")
    metrics["serving_loop"] = serving_loop(model, prompts, geom, card)
    if profile:
        metrics["profile"] = profile_serving(model, prompts, max_new, geom,
                                             card)
    # phase 11 serves the same model
    return metrics, model


def _decode_steps(eng):
    """Decode steps the engine launched: its ticks' and the warm-up
    ticks' that preceded each capture."""
    return (eng.stats["ticks"] + eng.stats["warmup_ticks"]) \
        * eng.steps_per_tick


def _tick_metrics(st):
    return dict(decode_tokens_per_s=st["decode_tokens"] / st["tick_s"],
                tick_ms=st["tick_s"] / st["ticks"] * 1e3,
                ticks=st["ticks"], warmup_ticks=st["warmup_ticks"],
                warmup_s=st["warmup_s"])


def _eager_run(model, prompts, max_new, geom, toks, tag, sampled=()):
    """The same requests through the engine's private eager tick: the
    greedy tokens must equal the captured path's (a sampled request's
    draw other noise: the captured engine's warm-up ticks drew some)."""
    eng, got = _serve(model, prompts, max_new, late=7, eager=True,
                      sampled=sampled, **geom)
    bad = [i for i, (a, b) in enumerate(zip(got, toks))
           if a != b and i not in sampled]
    if bad:
        raise AssertionError(f"{tag}: the eager tick gave other tokens "
                             f"than the captured tick (requests {bad})")
    if eng.stats["warmup_ticks"] or eng._programs:
        raise AssertionError(f"{tag}: the eager engine captured a graph")
    out = _tick_metrics(eng.stats)
    del eng
    gc.collect()            # the engine holds its own bound method
    return out


def _trace_want(c):
    """The kernel rows a trace must hold for launch counts `c`: a wrapper
    call launches each of its kernels once (the decode kernel's split and
    combine), and the W8A16 counter counts both routes. The split-K
    reduce runs only where K is split, so no count holds it."""
    decode = c["paged_decode_attention"] + c["paged_decode_attention_int8"]
    wgmma = c["weight_only_int8_matmul_wgmma"]
    return {"paged_decode_split<": decode, "paged_decode_combine<": decode,
            "rmsn_fwd_kernel<": c["rms_norm_residual"],
            "rope_kernel<": c["rope_apply"],
            "w8a16_kernel<": c["weight_only_int8_matmul"] - wgmma,
            "w8a16_wgmma_kernel<": wgmma}


# the profiler sessions a traced replay may take (`traced_replays`)
TRACE_TRIES = 3


def _graph_nodes(program, syms):
    """The captured tick's own graph as the CUDA driver lists it
    (cudaGraphDebugDotPrint; the engine keeps each captured cudaGraph_t
    beside its instantiation): its kernel nodes counted by the rows
    `_trace_want` names, matched as identifiers in the mangled kernel
    names, and its nodes by kind (KERNEL, MEMSET, MEMCPY, ...)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tick.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            program.graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    pats = {sym: re.compile(r"(?<![A-Za-z_])" + re.escape(sym.rstrip("<"))
                            + r"(?![a-z0-9_])") for sym in syms}
    rows, kinds = dict.fromkeys(syms, 0), {}
    for block in re.split(r'\n(?="graph_\d+_node_\d+"\[)', text):
        kind = re.match(r'"graph_\d+_node_\d+"\[[^\n]*label="\{(\w+)', block)
        if kind is None:
            continue
        kinds[kind[1]] = kinds.get(kind[1], 0) + 1
        name = re.search(r"\| (\S+?)\\<\\<\\<", block)
        if kind[1] != "KERNEL" or name is None:
            continue
        for sym, pat in pats.items():
            if pat.search(name[1]):
                rows[sym] += 1
    return rows, kinds


def _trace_replay(program, counters, reset):
    """One replay of `program` under torch.profiler: the counters' gain,
    the kernel rows the trace must hold for it (`_trace_want`), the rows
    it holds, the replay's device time in µs and its device events."""
    from torch.profiler import ProfilerActivity, profile
    reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        program()
        torch.cuda.synchronize()
    counted = counters()
    want = _trace_want(counted)
    rows = dict.fromkeys(want, 0)
    busy_us, events = 0.0, 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or _device_us(e) <= 0:
            continue
        busy_us += _device_us(e)
        events += e.count
        for sym in rows:
            if sym in e.key:
                rows[sym] += e.count
    return counted, want, rows, busy_us, events


def traced_replays(eng, counters, reset, card, tag, path, n=2):
    """The launch gates read from the card. A captured tick's counts come
    from its capture (each replay adds them), so the tick's graph, as
    the CUDA driver lists it, must hold exactly as many nodes of each
    kernel as the counters gain a replay, and every kernel of `path`
    must be among them: a replay runs every node of its graph. Then
    each of `n` replays of the engine's greedy tick runs under
    torch.profiler, to see the kernels run on the card and to time them:
    a row above the counters, a counter off the decode path, or a kernel
    of `path` that no trace saw fails. The profiler can lose records of
    a replay this long (CUPTI drops some when its device buffer fills):
    a trace that holds fewer rows than the graph's nodes is taken again,
    up to TRACE_TRIES sessions, and every short trace is reported under
    `lost_traces`; a short trace with as many device events as a whole
    trace of the same replay fails. Every slot is idle (KV writes land
    in the sink page, and the decode kernel reads no page), so the
    replays do less work than a served tick. Also the replays' kernel
    time beside the host wall of `n` untraced replays of the same
    inputs: an idle estimate (busy traced, wall untraced)."""
    # the greedy tick, or spec tick, captured here if no tick needed it
    program = eng._tick_program(False)
    gain = dict.fromkeys(counters(), 0)
    for _, k, c in program.delta:
        gain[k] += c
    want = _trace_want(gain)
    nodes, kinds = _graph_nodes(program, want)
    if nodes != want or min(want[k] for k in path) <= 0:
        raise AssertionError(
            f"{tag}: the captured tick's graph holds kernel nodes {nodes}, "
            f"the counters gain {want} a replay (path {path})")
    eng._idle_inputs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        program.graph.replay()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) / n * 1e3
    rows, busy_us, whole, lost, events_n = {}, 0.0, [], [], []
    for i in range(n):
        for _ in range(TRACE_TRIES):
            counted, want_i, got, us, events = _trace_replay(
                program, counters, reset)
            others = {k: v for k, v in counted.items() if v and k not in (
                "paged_decode_attention", "paged_decode_attention_int8",
                "rms_norm_residual", "rope_apply", "weight_only_int8_matmul",
                "weight_only_int8_matmul_wgmma")}
            if others or want_i != want or any(got[k] > want[k]
                                               for k in want):
                raise AssertionError(
                    f"{tag}: replay {i}'s trace ran kernels {got}, the "
                    f"counters say {want_i}, the graph {want} (other "
                    f"counters {others})")
            if got == want:
                whole.append(events)
                break
            lost.append(dict(replay=i, kernel_rows=got, want=want,
                             device_events=events))
        rows = {k: rows.get(k, 0) + v for k, v in got.items()}
        busy_us += us
        events_n.append(events)
    if min(rows[k] for k in path) <= 0:
        raise AssertionError(f"{tag}: no trace saw a kernel of {path} run: "
                             f"{rows}")
    for t in lost:
        if whole and t["device_events"] >= min(whole):
            raise AssertionError(
                f"{tag}: a trace of replay {t['replay']} held "
                f"{t['device_events']} device events, as many as a whole "
                f"trace ({min(whole)}), yet kernel rows {t['kernel_rows']} "
                f"below the counters' {t['want']}")
    busy_ms = busy_us / 1e3 / n
    out = dict(replays=n, graph_kernel_nodes=nodes, graph_nodes=kinds,
               kernel_rows=rows, busy_ms=busy_ms, replay_ms=replay_ms,
               device_events=events_n, whole_traces=len(whole),
               lost_traces=lost,
               replay_idle_estimate=1 - busy_ms / replay_ms)
    print(f"[{tag}] {card}: the captured "
          f"{'spec tick' if eng.draft_model is not None else 'tick'}'s "
          f"graph holds {nodes}, as the counters say (nodes by kind "
          f"{kinds}); {n} traced replays (every slot idle) ran {rows}; "
          f"kernels {busy_ms:.3f} ms a replay; untraced a replay takes "
          f"{replay_ms:.3f} ms (idle estimate "
          f"{out['replay_idle_estimate']:.3f}); device events a replay "
          f"{events_n}; traces that lost records and were taken again: "
          f"{[(t['replay'], t['device_events']) for t in lost]}")
    return out


def serving_loop(model, prompts, geom, card):
    """stream() over two requests with the background ticker running
    gives each the tokens generate() gave it; a request cancelled
    mid-decode returns every page and its reservation; stop() joins the
    ticker within its timeout. The two prompts lie in different prefill
    buckets, so each prefills alone whenever the ticker admits it."""
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    by_bucket = {}
    for p in prompts:
        by_bucket.setdefault(PagedKVEngine._bucket(p.size), p)
    pair = list(by_bucket.values())[:2]
    max_new = 16
    want = PagedKVEngine(model, device=model.device, **geom).generate(
        pair, max_new)
    eng = PagedKVEngine(model, device=model.device, **geom)
    ids = np.zeros((2, max(p.size for p in pair)), np.int32)
    mask = np.zeros(ids.shape, bool)
    for i, p in enumerate(pair):
        ids[i, :p.size], mask[i, :p.size] = p, True
    try:
        t0 = time.perf_counter()
        rows = list(eng.stream(ids, max_new_tokens=max_new,
                               attention_mask=mask))
        stream_s = time.perf_counter() - t0
        got = [[int(r[j]) for r in rows] for j in range(2)]
        if got != want:
            raise AssertionError("stream(): rows differ from generate()'s "
                                 f"tokens: {got} vs {want}")
        if ("tick", False) not in eng._programs:
            raise AssertionError("stream(): the ticker captured no tick")
        req = eng.submit(pair[0], 64)
        it = req.stream_tokens()
        next(it), next(it)
        req.cancel()
        if not req.done.wait(timeout=60):
            raise AssertionError("cancel: the request did not end")
        deadline = time.monotonic() + 60
        while eng.has_work() and time.monotonic() < deadline:
            time.sleep(0.01)
        if sorted(eng._free) != list(range(1, eng.num_pages)) \
                or eng._reserved_unalloc != 0 \
                or eng.stats["cancelled"] != 1:
            raise AssertionError(
                f"cancel: free {len(eng._free)}, reserved "
                f"{eng._reserved_unalloc}, cancelled "
                f"{eng.stats['cancelled']}")
    finally:
        t1 = time.perf_counter()
        eng.stop()
        stop_s = time.perf_counter() - t1
    if eng._ticker.is_alive():
        raise AssertionError("stop(): the ticker did not join in 30 s")
    print(f"[serve-loop] {card}: stream() of 2 requests x {max_new} tokens "
          f"(prompts {[int(p.size) for p in pair]}) equal to generate() in "
          f"{stream_s:.2f} s; a request cancelled after "
          f"{len(req.tokens)} tokens returned its pages and reservation; "
          f"stop() joined in {stop_s * 1e3:.1f} ms")
    return dict(stream_s=stream_s, stop_s=stop_s,
                cancelled_after=len(req.tokens))


def _device_us(evt):
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0))


def _norm_rows(kernels):
    """The RMSNorm and RoPE kernels' own profiler rows, in or out of the
    top."""
    return [(e.key[:90], _device_us(e) / 1e3, e.count) for e in kernels
            if "rms" in e.key or "rope" in e.key]


def _trace_window(card, label, run):
    """torch.profiler over run(): its host wall, the kernels' device time
    (one stream, so they do not overlap), idle share = 1 - busy / wall,
    the top 12 kernel rows and the RMSNorm and RoPE rows, printed."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel rows only: an operator's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    out = dict(
        wall_s=wall, device_busy_s=busy,
        idle_share=max(0.0, 1 - busy / wall) if wall else None,
        top=[(e.key[:90], _device_us(e) / 1e3, e.count) for e in top],
        norm=_norm_rows(kernels))
    print(f"[profile] {card} {label}: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy * 1e3:.1f} ms, idle share {out['idle_share']:.3f}")
    for name, ms, n in out["top"]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<6} {name}")
    for name, ms, n in out["norm"]:
        print(f"[profile] norm {ms:9.3f} ms  x{n:<6} {name}")
    return out


def profile_serving(model, prompts, max_new, geom, card, label="",
                    prime=()):
    """Where the time goes (`--profile`): torch.profiler over the prefill
    of all prompts and over two decode ticks, replays of the captured
    tick (one untraced tick first warms it up and captures it); device
    busy time is the sum of the kernels' device times (one stream, so
    they do not overlap), idle share = 1 - busy / host wall time.
    `prime` prompts are served to the end first (untraced), so a prefix
    cache holds their pages when the traced prefill runs."""
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    eng = PagedKVEngine(model, device=model.device, **geom)
    eng.generate(prime, max_new)
    for p in prompts:
        eng.submit(p, max_new)
    out = {}

    def trace(phase, run):
        out[phase] = _trace_window(card, label + phase, run)

    trace("prefill", eng._admit)
    eng.step()          # untraced: the warm-up tick and the capture
    trace("decode_2_ticks", lambda: (eng.step(), eng.step()))
    eng.run_until_idle()
    return out


# -- phase 6: continuous-batching parity ---------------------------------------

def parity_phase(dev):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_8b_config(num_hidden_layers=2, fused_norm=True,
                           fused_rope=True)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=1)
    geom = dict(max_slots=8, page_size=16, num_pages=641,
                max_pages_per_slot=80, steps_per_tick=4)
    target = _prompts(1, cfg.vocab_size, seed=2, lo=200, hi=200)[0]
    others = _prompts(7, cfg.vocab_size, seed=3, lo=64, hi=512)
    max_new = 32
    _, (alone,) = _serve(model, [target], max_new, late=0, **geom)
    _, joined = _serve(model, others + [target], max_new, late=7, **geom)
    joined = joined[7]
    if joined == alone:
        print(f"[parity] 2-layer f32: {max_new} greedy tokens identical "
              "alone and joined mid-decode of 7 others")
        return {"identical": True}
    t = next(i for i, (a, j) in enumerate(zip(alone, joined)) if a != j)
    ids = torch.from_numpy(np.concatenate(
        [target, np.asarray(alone[:t], np.int32)]))[None].to(dev)
    logits = model(ids)[0, -1]
    gap = abs(float(logits[alone[t]] - logits[joined[t]]))
    print(f"[parity] tokens differ at step {t}: {alone[t]} vs {joined[t]}, "
          f"logit gap {gap:.3g}")
    if gap > 1e-3:
        raise AssertionError(f"parity: step {t} differs by a logit gap "
                             f"{gap} > 1e-3")
    return {"identical": False, "step": t, "logit_gap": gap}


# -- phase 7: TinyLlama-1.1B training ---------------------------------------

def _tinyllama_config(**overrides):
    """bench.py's TinyLlama-1.1B (paddle_tpu bench.py:1182-1192) with the
    dense loss (loss_chunk=0) and the fused norm and RoPE kernels; phase
    9 overrides these back to bench.py's own values."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    base = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                num_hidden_layers=22, num_attention_heads=32,
                num_key_value_heads=4, max_position_embeddings=2048,
                rope_theta=10000.0, seq_length=2048, recompute=True,
                use_flash_attention=True, loss_chunk=0, fused_norm=True,
                fused_rope=True)
    base.update(overrides)
    return LlamaConfig(**base)


def expected_train_launches(cfg, tokens):
    """Kernel launches per training step of `cfg` on `tokens` rows, from
    the model's code. Each decoder layer runs one flash forward, and with
    `fused_norm` two RMSNorms and with `fused_rope` RoPE on q and k; with
    recompute all of these run twice (the forward, then again in the
    backward), and one backward of each. The final norm runs once each
    way. With `loss_chunk` > 0 the loss is one blockwise-CE forward and,
    per backward super-block of `ce_super_block` vocab rows, one dS, one
    dx and one dW kernel."""
    from paddle_tpu_torch.kernels.blockwise_ce import ce_super_block
    layers = cfg.num_hidden_layers
    passes = 2 if cfg.recompute else 1
    norm, rope = int(cfg.fused_norm), int(cfg.fused_rope)
    supers = (-(-cfg.vocab_size // ce_super_block(tokens, cfg.vocab_size))
              if cfg.loss_chunk else 0)
    return {"flash_fwd": passes * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers,
            "rms_norm_residual": norm * (2 * passes * layers + 1),
            "rms_norm_residual_bwd": norm * (2 * layers + 1),
            "rope_apply": rope * 2 * passes * layers,
            "rope_apply_bwd": rope * 2 * layers,
            "paged_decode_attention": 0,
            "ce_fwd": int(bool(cfg.loss_chunk)), "ce_dlogits": supers,
            "ce_dx": supers, "ce_dw": supers}


def training_phase(dev, counters, reset, card, profile=False):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, flops_per_token
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = _tinyllama_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    trainer = Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] TinyLlama-1.1B f32 built on the card in "
          f"{time.perf_counter() - t0:.1f} s ({n_params / 1e9:.3f} B params)")
    batch, seq, timed = 8, 2048, 5
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq)) \
        .astype(np.int32)
    data = {"input_ids": torch.from_numpy(ids).to(dev),
            "labels": torch.from_numpy(ids).to(dev)}
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    losses = [trainer.step(data)]                    # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(trainer.step(data))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall {losses}")
    steps = timed + 1
    want = expected_train_launches(cfg, batch * seq)
    per_step = {k: launches[k] / steps for k in want}
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"train: launches per step {per_step} != the "
                             f"count from the code {want}")
    tokens_per_s = batch * seq * timed / wall
    ftok = flops_per_token(cfg, seq) * 8.0 / 6.0     # recompute: ~8N
    metrics = dict(
        card=card, batch=batch, seq=seq, steps_timed=timed,
        tokens_per_s=tokens_per_s, step_ms=wall / timed * 1e3,
        warmup_s=warm, mfu=tokens_per_s * ftok / BF16_TENSOR_FLOPS,
        flops_per_token=ftok,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        losses=losses, launches=launches, launches_per_step=per_step)
    print(f"[train] {card}: {tokens_per_s:.1f} tokens/s, step "
          f"{metrics['step_ms']:.1f} ms, MFU {metrics['mfu']:.4f} (of 989 "
          f"TF/s, {ftok:.4g} flops/token with recompute), peak memory "
          f"{metrics['peak_mem_gb']:.2f} GB, warm-up step {warm:.2f} s")
    print(f"[train] losses {losses}")
    print(f"[train] launches per step {per_step} (= the count from the "
          "code)")
    if profile:
        metrics["profile"] = profile_training(trainer, data, card)
    del trainer, opt, model, data
    torch.cuda.empty_cache()
    return metrics


def bench_training_phase(dev, counters, reset, card, profile=False):
    """Phase 9: bench.py's own training loop (bench.py:1182-1254) through
    the port, with its configuration: the blockwise loss
    (loss_chunk=512), plain norm and RoPE, recompute, flash attention;
    the batch fed by `trainer.data_iter(..., depth=3)`, a warm-up step,
    then 10 timed steps closed by float(loss)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, flops_per_token
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = _tinyllama_config(loss_chunk=512, loss_vocab_block=0,
                            fused_norm=False, fused_rope=False)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    trainer = Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16"))
    torch.cuda.synchronize()
    print(f"[bench-train] TinyLlama-1.1B f32, bench.py's config (loss_chunk "
          f"512, plain norm and RoPE) built in "
          f"{time.perf_counter() - t0:.1f} s")
    batch, seq, steps = 8, 2048, 10
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq)) \
        .astype(np.int32)
    data = {"input_ids": ids, "labels": ids}
    torch.cuda.reset_peak_memory_stats()
    reset()
    it = trainer.data_iter(itertools.repeat(data, steps + 1), depth=3)
    t0 = time.perf_counter()
    losses = [float(trainer.step(next(it)))]          # warm-up
    warm = time.perf_counter() - t0
    step_losses, stamps = [], []
    t0 = time.perf_counter()
    for b in it:
        stamps.append(time.perf_counter())
        loss = trainer.step(b)
        step_losses.append(loss)
    loss = float(loss)          # the last step's output closes the chain
    dt = time.perf_counter() - t0
    it.close()
    launches = counters()
    losses += [float(x) for x in step_losses]
    if len(losses) != steps + 1 or not all(np.isfinite(losses)):
        raise AssertionError(f"bench-train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"bench-train: the loss did not fall {losses}")
    want = expected_train_launches(cfg, batch * seq)
    per_step = {k: launches[k] / (steps + 1) for k in want}
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"bench-train: launches per step {per_step} != "
                             f"the count from the code {want}")
    tokens_per_s = batch * seq * steps / dt
    ftok = flops_per_token(cfg, seq) * 8.0 / 6.0       # recompute: ~8N
    metrics = dict(
        card=card, batch=batch, seq=seq, steps_timed=steps,
        tokens_per_s=tokens_per_s, step_ms=dt / steps * 1e3, warmup_s=warm,
        mfu=tokens_per_s * ftok / BF16_TENSOR_FLOPS, flops_per_token=ftok,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses,
        launches=launches, launches_per_step=per_step,
        step_ms_median=_median(np.diff(stamps).tolist()) * 1e3)
    print(f"[bench-train] {card}: {tokens_per_s:.1f} tokens/s, step "
          f"{metrics['step_ms']:.1f} ms, MFU {metrics['mfu']:.4f} (of 989 "
          f"TF/s, {ftok:.4g} flops/token with recompute), peak memory "
          f"{metrics['peak_mem_gb']:.2f} GB, warm-up step {warm:.2f} s")
    print(f"[bench-train] losses {losses}")
    print(f"[bench-train] launches per step {per_step} (= the count from "
          "the code)")
    placed = trainer._place(data)
    metrics["phase_seconds"] = trainer.measure_phase_seconds(placed, iters=2)
    print(f"[bench-train] {card}: measure_phase_seconds "
          f"{metrics['phase_seconds']}")
    if profile:
        metrics["profile"] = profile_training(trainer, placed, card)
    del trainer, opt, model, placed
    torch.cuda.empty_cache()
    return metrics


def profile_training(trainer, data, card):
    """Where the time goes (`--profile`): torch.profiler over one
    training step; device busy time is the sum of the kernels' device
    times (one stream), idle share = 1 - busy / host wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=_device_us, reverse=True)[:20]
    out = dict(wall_s=wall, device_busy_s=busy,
               idle_share=max(0.0, 1 - busy / wall) if wall else None,
               top=[(e.key[:90], _device_us(e) / 1e3, e.count) for e in top],
               norm=_norm_rows(kernels))
    print(f"[profile] {card} train step: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy * 1e3:.1f} ms, idle share {out['idle_share']:.3f}")
    for name, ms, n in out["top"]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<6} {name}")
    for name, ms, n in out["norm"]:
        print(f"[profile] norm {ms:9.3f} ms  x{n:<6} {name}")
    return out


# -- phase 18: training telemetry, heartbeat, chaos and checkpoints ---------

OBS_STEPS = 10              # (a): timed steps after one warm-up, as phase 9
OBS_WINDOW = 8              # (a): the last reported steps the rate gate reads
OBS_RATE_TOL = 0.05         # (a): telemetry tokens/s against the event window
HB_INTERVAL_S = 0.5         # (b): the heartbeat's publish interval
CKPT_STEPS = 3              # (d): steps before the save, and after the load
OBS_BATCH = (8, 2048)       # every part's batch: bench.py's 8 x 2048 ids


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return (xs[n // 2] + xs[(n - 1) // 2]) / 2 if n else None


def _sync_warnings(run):
    """How many synchronizing CUDA calls `run()` makes, read through
    torch.cuda's sync debug mode ("warn") and the warnings it raises."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def _telemetry_part(dev, counters, reset, card, bench):
    """(a) + (b): phase 9's configuration and loop under observability,
    with a fleet heartbeat into a TCPStore running beside it."""
    import datetime
    import torch.distributed as tdist
    from paddle_tpu_torch import observability
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.kernels.blockwise_ce import logits_bytes_saved
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.observability import fleet
    from paddle_tpu_torch.observability.telemetry import (
        detect_peak_flops, flops_per_token_for)
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = _tinyllama_config(loss_chunk=512, loss_vocab_block=0,
                            fused_norm=False, fused_rope=False)
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    trainer = Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16"))
    batch, seq = OBS_BATCH
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq)) \
        .astype(np.int32)
    data = {"input_ids": ids, "labels": ids}
    store = tdist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=30))
    out = {"card": card}
    with observability.scoped() as reg:
        hb = trainer.fleet_heartbeat(store, 0, 1, interval=HB_INTERVAL_S)
        try:
            reset()
            it = trainer.data_iter(itertools.repeat(data, OBS_STEPS + 1),
                                   depth=3)
            losses = [trainer.step(next(it))]           # warm-up
            float(losses[0])
            events, reported = [], []
            t0 = time.perf_counter()
            for b in it:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
                losses.append(trainer.step(b))
                reported.append(reg.gauge("train.tokens_per_sec").value())
            float(losses[-1])       # the last step's output closes the chain
            wall = time.perf_counter() - t0
            it.close()
            launches = counters()
            hb.publish()                    # the last beat, after the run
            row = fleet.FleetAggregator(store, 1).scan()["ranks"][0]
            beat = {"step": reg.counter("train.steps").value(),
                    "tokens_per_sec": reg.gauge(
                        "train.tokens_per_sec").value(),
                    "mfu": reg.gauge("train.mfu").value()}
            mfu = beat["mfu"]
        finally:
            hb.stop()
        left = [t.name for t in threading.enumerate()
                if t.name.startswith("fleet-") and t.is_alive()]
        tel = trainer.telemetry
        tel.flush()
        losses = [float(x) for x in losses]
        tokens = batch * seq
        # the event recorded before call k to the one before call k + 8:
        # the device time of the steps the last 8 reports cover
        ev_ms = events[1].elapsed_time(events[-1])
        window = reported[-OBS_WINDOW:]
        tel_rate = sum(window) / len(window)
        ev_rate = tokens * OBS_WINDOW / (ev_ms / 1e3)
        peak = detect_peak_flops()
        want_mfu = reported[-1] * flops_per_token_for(model, seq) / peak
        want = expected_train_launches(cfg, tokens)
        per_step = {k: launches[k] / (OBS_STEPS + 1) for k in want}
        recompiles = reg.counter("train.recompiles").labeled()
        problems = []
        if abs(tel_rate - ev_rate) > OBS_RATE_TOL * ev_rate:
            problems.append(f"telemetry {tel_rate:.1f} tokens/s against "
                            f"the event window's {ev_rate:.1f}")
        if peak != 989e12:
            problems.append(f"detected peak {peak}")
        if mfu != want_mfu:
            problems.append(f"train.mfu {mfu} != {want_mfu}")
        if reg.counter("train.steps").value() != OBS_STEPS:
            problems.append("train.steps "
                            f"{reg.counter('train.steps').value()}")
        # the last call's interval and loss are reported at a next call
        if reg.gauge("train.loss").value() != losses[-2]:
            problems.append(f"train.loss {reg.gauge('train.loss').value()} "
                            f"!= the last reported step's {losses[-2]}")
        saved = logits_bytes_saved(tokens, cfg.vocab_size, 512, 0, 2)
        if reg.gauge("train.loss.logits_bytes_saved").value() != saved:
            problems.append("logits_bytes_saved")
        if len(recompiles) != 1:
            problems.append(f"train.recompiles {recompiles}")
        if per_step != {k: float(v) for k, v in want.items()}:
            problems.append(f"launches per step {per_step} != {want}")
        for k in ("step", "tokens_per_sec", "mfu"):
            if row.get(k) != fleet._json_value(beat[k]):
                problems.append(f"heartbeat {k} {row.get(k)} != the "
                                f"registry's {beat[k]}")
        if left:
            problems.append(f"threads left after stop: {left}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            problems.append(f"losses {losses}")
        # syncs: two steps with observability on, then two with it off
        placed = trainer._place(data)
        on = _sync_warnings(lambda: [trainer.step(placed)
                                     for _ in range(2)])
    off = _sync_warnings(lambda: [trainer.step(placed) for _ in range(2)])
    torch.cuda.synchronize()
    if on != off:
        problems.append(f"{on} syncs in two steps with observability on, "
                        f"{off} with it off")
    dev_step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(len(events) - 1)]
    step_s = [tokens / r for r in reported]
    out.update(
        tokens_per_s_telemetry=tel_rate, tokens_per_s_events=ev_rate,
        tokens_per_s_synced=tokens * OBS_STEPS / wall,
        step_ms_median_on=_median(step_s[-OBS_WINDOW:]) * 1e3,
        step_ms_median_off=bench.get("step_ms_median"),
        device_step_ms=dev_step_ms, reported_tokens_per_s=reported,
        mfu=mfu, peak_flops=peak,
        losses=losses, recompiles={str(k): v for k, v in recompiles.items()},
        heartbeat=row, syncs_on=on, syncs_off=off, launches=launches,
        launches_per_step=per_step)
    print(f"[train-obs] {card}: telemetry {tel_rate:.1f} tokens/s over the "
          f"last {OBS_WINDOW} reports against {ev_rate:.1f} by CUDA events "
          f"({100 * (tel_rate / ev_rate - 1):+.2f} %), "
          f"{out['tokens_per_s_synced']:.1f} over the synced window of "
          f"{OBS_STEPS}; MFU {out['mfu']:.4f} of {peak / 1e12:.0f} TF/s")
    print(f"[train-obs] {card}: median step {out['step_ms_median_on']:.1f} ms "
          f"with observability on, phase 9's {out['step_ms_median_off']} ms "
          f"off; syncs in two steps: {on} on, {off} off")
    print(f"[train-obs] heartbeat row {row}")
    print(f"[train-obs] launches per step {per_step}")
    del trainer, opt, model, placed
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("train-obs: " + "; ".join(problems))
    return out


def _small_trainer(dev, seed, **step_kw):
    """A 2-layer model at TinyLlama-1.1B's widths with the fused norm and
    RoPE and the blockwise loss (every training kernel), AdamW, bf16
    compute."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = _tinyllama_config(num_hidden_layers=2, loss_chunk=512)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=seed)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    return Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16",
                                               **step_kw))


def _train_state(tr):
    """A copy on the card of every parameter and optimizer-state tensor."""
    sd = tr.checkpoint_state()
    out = {f"p/{n}": t.clone() for n, t in sd["params"].items()}
    for n, st in sd["opt"].items():
        out.update({f"o/{n}/{k}": t.clone() for k, t in st.items()})
    return out


def _same_state(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _chaos_part(dev, data, steps):
    """(c): the chaos sites on a full-width 2-layer model."""
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.distributed import chaos
    problems, out = [], {}
    tr = _small_trainer(dev, 0, health_probe=True)
    steps.append(float(tr.step(data)))
    for site, cap in (("train.grad.nan", None), ("train.loss.spike", 0.0)):
        if cap is not None:
            cap = 10 * steps[-1]
            tr.set_loss_cap(cap)
        before = _train_state(tr)
        with chaos.scoped(seed=0, rates={site: (1.0, 1)}):
            loss = float(tr.step(data))
            steps.append(loss)
            fired = chaos.fire_count(site)
        probe = tr.last_probe.tolist()
        kept = _same_state(_train_state(tr), before)
        out[site] = dict(fired=fired, loss=loss, probe=probe,
                         state_unchanged=kept, cap=cap)
        if fired != 1 or probe[1] != 0.0 or not kept:
            problems.append(f"{site}: {out[site]}")
        tr.set_loss_cap(float("inf"))
        steps.append(float(tr.step(data)))
        if tr.last_probe.tolist()[1] != 1.0:
            problems.append(f"{site}: the next step was not applied")
        print(f"[train-chaos] {site}: fired {fired}, loss {loss:.4f}, "
              f"probe {probe}, parameters and moments unchanged: {kept}")
    del tr, before
    tr = _small_trainer(dev, 0, skip_nonfinite_grads=True)
    with observability.scoped() as reg:
        with chaos.scoped(seed=0, rates={"trainer.grad": (1.0, 2)}):
            for _ in range(3):
                steps.append(float(tr.step(data)))
        skips = reg.counter("train.nonfinite_skips").value()
    out["skip"] = dict(skipped=tr.nonfinite_skipped, counted=skips)
    if not tr.nonfinite_skipped == skips == 2:
        problems.append(f"skip: {out['skip']}")
    print(f"[train-chaos] trainer.grad under skip_nonfinite_grads: "
          f"{tr.nonfinite_skipped} skipped, train.nonfinite_skips {skips}")
    return out, problems


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)
               if os.path.isfile(os.path.join(path, f)))


def _pinned_copy_gbs(nbytes):
    """GB/s of one device-to-host copy of `nbytes` into pinned memory."""
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    return nbytes / (time.perf_counter() - t0) / 1e9


def _ckpt_part(dev, data, steps):
    """(d): save, verify, load and resume, async against sync, a torn
    shard, on a full-width 2-layer model."""
    import filecmp
    import shutil
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.async_checkpoint import AsyncCheckpointer
    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    free = shutil.disk_usage(root).free
    print(f"[train-ckpt] {root}: {free / 1e9:.1f} GB free")
    problems, out = [], {"free_gb": free / 1e9}
    try:
        a = _small_trainer(dev, 0)
        got = [float(a.step(data)) for _ in range(CKPT_STEPS)]
        steps.extend(got)
        first = os.path.join(root, f"step_{CKPT_STEPS:08d}")
        torch.cuda.synchronize()
        with observability.scoped() as reg:
            t0 = time.perf_counter()
            a.save_checkpoint(first)
            out["save_s"] = time.perf_counter() - t0
            # the save's split: the host snapshot, then the files
            out["save_snapshot_s"] = reg.histogram(
                "checkpoint.snapshot.seconds").percentile(50)
            out["save_files_s"] = reg.histogram(
                "ckpt.save.seconds").percentile(50)
        out["bytes"] = _dir_bytes(first)
        issues = ckpt.verify_checkpoint(first)
        if issues:
            problems.append(f"verify: {issues}")
        saved = _train_state(a)
        # async: the same state, then a step in place right after save()
        cp = AsyncCheckpointer()
        a.checkpointer = cp
        second = os.path.join(root, "async")
        try:
            t0 = time.perf_counter()
            a.save_checkpoint(second)
            out["snapshot_s"] = time.perf_counter() - t0
            after = [float(a.step(data))]
            steps.append(after[0])
            t1 = time.perf_counter()
            cp.flush()
            out["async_write_s"] = out["snapshot_s"] + time.perf_counter() - t1
        finally:
            cp.close()
            a.checkpointer = None
        same = {f: filecmp.cmp(os.path.join(first, f),
                               os.path.join(second, f), shallow=False)
                for f in sorted(os.listdir(first))}
        out["async_files_identical"] = same
        if not all(same.values()):
            problems.append(f"async files differ from the sync save's: {same}")
        shutil.rmtree(second)
        after += [float(a.step(data)) for _ in range(CKPT_STEPS - 1)]
        steps.extend(after[1:])
        del a
        # a second uninterrupted run: the run-to-run spread of the losses
        b = _small_trainer(dev, 0)
        again = [float(b.step(data)) for _ in range(2 * CKPT_STEPS)]
        steps.extend(again)
        del b
        spread = max(abs(x - y) for x, y in zip(got + after, again))
        # resume into a trainer built from other weights
        r = _small_trainer(dev, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.load_checkpoint(first)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        if not _same_state(_train_state(r), saved):
            problems.append("loaded state differs from the saved one")
        resumed = [float(r.step(data)) for _ in range(CKPT_STEPS)]
        steps.extend(resumed)
        gap = max(abs(x - y) for x, y in zip(resumed, after))
        out.update(losses=got + after, again=again, resumed=resumed,
                   spread=spread, gap=gap, bit_equal=resumed == after)
        if resumed != after and gap > 2 * spread:
            problems.append(f"resumed losses {resumed} against {after}: gap "
                            f"{gap} > twice the spread {spread}")
        # a torn shard: quarantined, and the fallback loads the first
        torn = os.path.join(root, f"step_{2 * CKPT_STEPS:08d}")
        with chaos.scoped(seed=0, rates={"ckpt.write.shards": (1.0, 1)}):
            r.save_checkpoint(torn)
        issues = ckpt.verify_checkpoint(torn)
        loaded = ckpt.load_newest_complete(r.checkpoint_state(), root)
        quarantined = os.path.exists(os.path.join(
            torn, ".quarantine", "shards_0.npz"))
        back = _same_state(_train_state(r), saved)
        out.update(torn_issues=issues, fallback=loaded,
                   quarantined=quarantined, fallback_state_equal=back)
        if not issues or loaded != first or not quarantined or not back:
            problems.append(f"torn shard: issues {issues}, loaded {loaded}, "
                            f"quarantined {quarantined}, state {back}")
        del r, saved
    finally:
        shutil.rmtree(root, ignore_errors=True)
    nb = out["bytes"]
    out["pinned_copy_gbs"] = _pinned_copy_gbs(nb)
    out["snapshot_gbs"] = nb / out["snapshot_s"] / 1e9
    out["sync_write_gbs"] = nb / out["save_s"] / 1e9
    print(f"[train-ckpt] {nb / 1e9:.3f} GB: sync save_checkpoint "
          f"{out['save_s']:.2f} s ({out['sync_write_gbs']:.2f} GB/s; snapshot "
          f"{out['save_snapshot_s']:.2f} s, files {out['save_files_s']:.2f} "
          f"s), async "
          f"returns in {out['snapshot_s']:.3f} s ({out['snapshot_gbs']:.2f} "
          f"GB/s device to host; one pinned copy {out['pinned_copy_gbs']:.2f} "
          f"GB/s), written in {out['async_write_s']:.2f} s; load "
          f"{out['load_s']:.2f} s")
    print(f"[train-ckpt] losses {out['losses']}, resumed {out['resumed']} "
          f"(bit-equal: {out['bit_equal']}; gap {out['gap']}, spread of two "
          f"runs {out['spread']})")
    return out, problems


def training_obs_phase(dev, counters, reset, card, bench):
    """Phase 18: training telemetry and the fleet heartbeat at full width
    ((a), (b): phase 9's configuration), then the chaos sites and the
    checkpoints on a full-width 2-layer model ((c), (d))."""
    t0 = time.perf_counter()
    out = {"obs": _telemetry_part(dev, counters, reset, card, bench)}
    cfg = _tinyllama_config(num_hidden_layers=2, loss_chunk=512)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, OBS_BATCH) \
        .astype(np.int32)
    data = {"input_ids": torch.from_numpy(ids).to(dev),
            "labels": torch.from_numpy(ids).to(dev)}
    steps = []
    reset()
    out["chaos"], problems = _chaos_part(dev, data, steps)
    out["ckpt"], more = _ckpt_part(dev, data, steps)
    problems += more
    launches = counters()
    want = expected_train_launches(cfg, OBS_BATCH[0] * OBS_BATCH[1])
    launches_ok = all(launches[k] == v * len(steps) for k, v in want.items())
    if not launches_ok:
        problems.append(f"chaos and checkpoint launches {launches} != "
                        f"{len(steps)} x {want}")
    out.update(launches=launches, steps=len(steps),
               seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    print(f"[train-ckpt] {len(steps)} steps, launches = {len(steps)} x the "
          f"count from the code: {launches_ok}; phase 18 "
          f"{out['seconds']:.1f} s")
    if problems:
        raise AssertionError("train-chaos/ckpt: " + "; ".join(problems))
    return out


# -- phase 19: the sentry, run_resilient and a relaunch ---------------------

SENTRY_AB_BLOCK = 4         # (a): steps an arm runs a round (bench.py, chip)
SENTRY_LAYERS = 8           # (a): the model's depth, of 22 (the phase's time)
SENTRY_AB_ROUNDS = 2        # (a): rounds of plain, off, on, off
RECOVER_BATCH = (4, 1024)   # (b), (c): bench.py's recovery batch on the chip
RECOVER_STEPS = 8           # (b), (c): bench.py's recovery run on the chip
RECOVER_INTERVAL = 2        # (b): the sentry's saves (bench.py: max(2, 8 // 4))
RESILIENT_INTERVAL = 4      # (b), (c): run_resilient's chunk and save interval
QUARANTINE_K = 2            # (b): rollbacks before the sentry quarantines
SKIP_AT = 3                 # (b): the step whose gradients train.grad.nan poisons
RELAUNCH_KILL_AT = 5        # (c): attempt 0 exits at the end of this step


def _recover_config():
    """bench.py's chip configuration of its sentry extra (bench.py:833-838:
    hidden 1024, 4 layers, 16/4 heads, FFN 2816, vocab 32000, sequence
    1024) with phase 9's loss (loss_chunk=512), flash attention, plain
    norm and RoPE."""
    return _tinyllama_config(hidden_size=1024, intermediate_size=2816,
                             num_hidden_layers=4, num_attention_heads=16,
                             num_key_value_heads=4,
                             max_position_embeddings=1024, seq_length=1024,
                             loss_chunk=512, loss_vocab_block=0,
                             fused_norm=False, fused_rope=False)


def _counted(tr, steps, key):
    """Count `tr`'s steps into steps[key] (the launch gate's divisor)."""
    step = tr.step

    def counted(batch):
        steps[key] += 1
        return step(batch)
    tr.step = counted
    return tr


def _recover_trainer(dev, steps=None, checkpointer=None):
    """(b)'s trainer: f32 weights from seed 0, bf16 compute, AdamW(1e-4,
    wd 0.01), the health probe."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    model = LlamaForCausalLM(_recover_config(), device=dev,
                             dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    tr = Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16",
                                             health_probe=True),
                 checkpointer=checkpointer)
    return tr if steps is None else _counted(tr, steps, "b")


def _recover_batch(dev, seed=0):
    ids = np.random.RandomState(seed).randint(
        0, _recover_config().vocab_size, RECOVER_BATCH).astype(np.int32)
    ids = torch.from_numpy(ids).to(dev)
    return {"input_ids": ids, "labels": ids}


def _nan_seed_at(k, rate=0.3):
    """A chaos seed at which `train.grad.nan` at `rate` first fires at
    decision k (the Trainer consults the site once a step)."""
    from paddle_tpu_torch.distributed import chaos
    for seed in range(10_000):
        with chaos.scoped(seed=seed, rates={"train.grad.nan": rate}):
            fires = [chaos.should_fire("train.grad.nan")
                     for _ in range(k + 1)]
        if True in fires and fires.index(True) == k:
            return seed
    raise AssertionError(f"no seed fires train.grad.nan first at {k}")


def _bundle_reasons(flight):
    from paddle_tpu_torch.observability import fleet
    out = []
    for b in fleet.flight_records(flight):
        with open(os.path.join(b, "manifest.json")) as f:
            out.append(json.load(f)["reason"])
    return out


def _sentry_config():
    """(a)'s model: phase 9's configuration at SENTRY_LAYERS layers."""
    return _tinyllama_config(loss_chunk=512, loss_vocab_block=0,
                             fused_norm=False, fused_rope=False,
                             num_hidden_layers=SENTRY_LAYERS)


def _sentry_cost_part(dev, steps, card, bench):
    """(a): the sentry's host work and the probe's cost at phase 9's
    configuration cut to SENTRY_LAYERS layers, bench.py's interleaved
    A/B (bench.py:863-939)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import sentry
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = _sentry_config()
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    # one model and optimizer, stepped with the probe and without it
    plain = _counted(Trainer(model, opt, TrainStepConfig(
        compute_dtype="bfloat16")), steps, "a")
    probed = _counted(Trainer(model, opt, TrainStepConfig(
        compute_dtype="bfloat16", health_probe=True)), steps, "a")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, OBS_BATCH) \
        .astype(np.int32)
    batch = probed._place({"input_ids": ids, "labels": ids})
    losses = [float(plain.step(batch)), float(probed.step(batch))]   # warm
    # ONE long-lived sentry across the on arm's rounds (bench.py): the
    # steady-state per-step cost, not a re-warming detector's
    s_on = sentry.TrainingSentry(sentry.SentryConfig(policy="skip",
                                                     warmup_steps=4))
    on_i, host_us, capped = [0], [], [0]

    def run_off(tr, n):
        # reads the loss each step, like any loop that logs it: the
        # sentry's contract is no sync BEYOND that read
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            losses.append(float(tr.step(batch)))
            ts.append(time.perf_counter() - t0)
        return ts

    def run_on(n):
        # run()'s host plane a step: the cap, the step and its one read,
        # the detector; the added segments timed on their own
        ts = []
        for _ in range(n):
            i = on_i[0]
            on_i[0] += 1
            t0 = time.perf_counter()
            probed.set_loss_cap(s_on.loss_cap())
            t1 = time.perf_counter()
            loss, gn, applied = sentry._read_step(probed.step(batch),
                                                  probed.last_probe)
            t2 = time.perf_counter()
            s_on.observe_step(i, i, loss, gn, applied)
            t3 = time.perf_counter()
            host_us.append(((t1 - t0) + (t3 - t2)) * 1e6)
            ts.append(t3 - t0)
            losses.append(loss)
            capped[0] += not applied
        return ts

    plains, offs, ons, offs2 = [], [], [], []
    for _ in range(SENTRY_AB_ROUNDS):
        plains += run_off(plain, SENTRY_AB_BLOCK)
        offs += run_off(probed, SENTRY_AB_BLOCK)
        ons += run_on(SENTRY_AB_BLOCK)
        offs2 += run_off(probed, SENTRY_AB_BLOCK)
    syncs_on = _sync_warnings(lambda: run_on(2))
    syncs_off = _sync_warnings(lambda: run_off(probed, 2))
    torch.cuda.synchronize()

    def p2(ts):
        return float(np.percentile(ts, 2))
    base, on, bare = p2(offs + offs2), p2(ons), p2(plains)
    tokens = OBS_BATCH[0] * OBS_BATCH[1]
    out = dict(
        card=card, steps_per_arm=SENTRY_AB_BLOCK * SENTRY_AB_ROUNDS,
        step_ms_p2_off=base * 1e3, step_ms_p2_on=on * 1e3,
        step_ms_p2_plain=bare * 1e3,
        tokens_per_sec_sentry_off=tokens / base,
        tokens_per_sec_sentry_on=tokens / on,
        host_us_per_step=float(np.median(host_us)),
        overhead_pct=float(np.median(host_us)) / (base * 1e6) * 100.0,
        ab_delta_pct=(on - base) / base * 100.0,
        aa_floor_pct=abs(p2(offs2) - p2(offs)) / p2(offs) * 100.0,
        probe_compile_delta_pct=(base - bare) / bare * 100.0,
        syncs_on=syncs_on, syncs_off=syncs_off,
        capped_on_steps=capped[0], on_steps=on_i[0],
        phase9_step_ms_median=bench.get("step_ms_median"))
    print(f"[sentry] {card}: (a) {SENTRY_LAYERS} layers: step p2 "
          f"{out['step_ms_p2_off']:.2f} ms "
          f"off, {out['step_ms_p2_on']:.2f} on, {out['step_ms_p2_plain']:.2f} "
          f"without the probe; host {out['host_us_per_step']:.1f} us a step "
          f"= overhead {out['overhead_pct']:.4f} %; A/B "
          f"{out['ab_delta_pct']:+.3f} % (A/A floor "
          f"{out['aa_floor_pct']:.3f} %); probe {out['probe_compile_delta_pct']:+.3f} "
          f"%; syncs in two steps {syncs_on} on, {syncs_off} off; the cap "
          f"suppressed {capped[0]} of {on_i[0]} on-arm updates")
    problems = []
    if syncs_on != syncs_off:
        problems.append(f"(a) {syncs_on} syncs in two sentried steps, "
                        f"{syncs_off} in two plain ones")
    if not all(np.isfinite(losses)):
        problems.append(f"(a) losses {losses}")
    del plain, probed, opt, model, batch
    torch.cuda.empty_cache()
    return out, problems


def _recover_part(dev, steps, card, root):
    """(b): recovery at bench.py's chip configuration, with an
    AsyncCheckpointer: rollback, skip, quarantine and run_resilient."""
    import shutil
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.distributed import chaos, watchdog
    from paddle_tpu_torch.distributed.async_checkpoint import AsyncCheckpointer
    from paddle_tpu_torch.distributed.elastic import run_resilient
    from paddle_tpu_torch.distributed.sentry import (
        SentryConfig, SentryQuarantine, TrainingSentry, _read_step)
    from paddle_tpu_torch.observability import fleet
    problems, out = [], {"card": card}
    batch = _recover_batch(dev)

    # the fault-free run: 8 steps, then a sync save ((c)'s yardstick)
    ref = _recover_trainer(dev, steps)
    for _ in range(RECOVER_STEPS):
        ref.step(batch)
    ref_dir = os.path.join(root, "ref", f"step_{RECOVER_STEPS:08d}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.save_checkpoint(ref_dir)
    out["save_s"] = time.perf_counter() - t0
    out["bytes"] = _dir_bytes(ref_dir)
    want = _train_state(ref)
    del ref

    cp = AsyncCheckpointer()
    try:
        # rollback with one train.grad.nan at step 0 (bench.py:941-968)
        tr = _recover_trainer(dev, steps, checkpointer=cp)
        restore = {}
        real_load = tr.load_checkpoint

        def timed_load(path):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_load(path)
            torch.cuda.synchronize()
            restore["s"] = time.perf_counter() - t0
        tr.load_checkpoint = timed_load
        s = TrainingSentry(SentryConfig(policy="rollback", warmup_steps=4,
                                        promote_after=2))
        rb_dir = os.path.join(root, "rollback")
        t0 = time.perf_counter()
        t_save = []
        real_save = tr.save_checkpoint

        def timed_save(path):
            t1 = time.perf_counter()
            real_save(path)
            t_save.append(time.perf_counter() - t1)
        tr.save_checkpoint = timed_save
        with chaos.scoped(seed=7, rates={"train.grad.nan": (1.0, 1)}):
            res = s.run(tr, lambda c: batch, RECOVER_STEPS, rb_dir,
                        checkpoint_interval=RECOVER_INTERVAL)
        cp.flush()
        run_s = time.perf_counter() - t0
        same = _same_state(_train_state(tr), want)
        out["rollback"] = dict(
            rollbacks=res["rollbacks"], triggers=res["triggers"],
            restore_seconds=restore.get("s"), run_seconds=run_s,
            promoted_step=res["promoted_step"], saves=len(t_save),
            async_save_return_s=t_save, state_equal_fault_free=same)
        if res["rollbacks"] != 1 or res["triggers"] != {
                "nonfinite_grad": 1} or res["promoted_step"] is None \
                or not same:
            problems.append(f"(b) rollback: {out['rollback']}")
        print(f"[sentry] {card}: (b) rollback {res['rollbacks']}, triggers "
              f"{res['triggers']}, restore {restore.get('s') or 0:.2f} s, run "
              f"{run_s:.2f} s, promoted step {res['promoted_step']}, "
              f"{len(t_save)} async saves back in "
              f"{[round(x, 3) for x in t_save]} s; final state bit-equal "
              f"to the fault-free run: {same}")
        del tr
        shutil.rmtree(rb_dir, ignore_errors=True)

        # skip: the step whose gradients are NaN is dropped on the device;
        # the end state is the run that never saw that batch
        batches = [_recover_batch(dev, seed=c) for c in range(RECOVER_STEPS)]
        tr = _recover_trainer(dev, steps, checkpointer=cp)
        sk_dir = os.path.join(root, "skip")
        with chaos.scoped(seed=_nan_seed_at(SKIP_AT),
                          rates={"train.grad.nan": (0.3, 1)}):
            res = TrainingSentry(SentryConfig(policy="skip")).run(
                tr, lambda c: batches[c], RECOVER_STEPS, sk_dir,
                checkpoint_interval=100)
        cp.flush()
        got = _train_state(tr)
        del tr
        omit = _recover_trainer(dev, steps)
        for c in range(RECOVER_STEPS):
            if c != SKIP_AT:
                omit.step(batches[c])
        same = _same_state(got, _train_state(omit))
        del omit, got
        out["skip"] = dict(skips=res["skips"], triggers=res["triggers"],
                           cursor=res["cursor"], state_equal_omitted=same)
        if res["skips"] != 1 or res["triggers"] != {"nonfinite_grad": 1} \
                or not same:
            problems.append(f"(b) skip: {out['skip']}")
        print(f"[sentry] {card}: (b) skip {res['skips']} at step {SKIP_AT}, "
              f"triggers {res['triggers']}; bit-equal to the run without "
              f"that batch: {same}")
        shutil.rmtree(sk_dir, ignore_errors=True)

        flight = os.path.join(root, "flight")
        with observability.scoped() as reg:
            fleet.configure_flight_recorder(dir=flight, max_keep=100)
            try:
                # quarantine under run_resilient: NaN at every step
                tr = _recover_trainer(dev, steps, checkpointer=cp)
                s = TrainingSentry(SentryConfig(
                    policy="rollback", warmup_steps=2, promote_after=1,
                    quarantine_rollbacks=QUARANTINE_K))
                q_dir = os.path.join(root, "quarantine")
                raised = None
                with chaos.scoped(seed=3, rates={"train.grad.nan": 1.0}):
                    try:
                        run_resilient(
                            lambda a, b: s.run(
                                tr, lambda c: batch, RECOVER_STEPS, q_dir,
                                checkpoint_interval=RECOVER_INTERVAL),
                            RECOVER_STEPS, q_dir,
                            lambda step, path: tr.save_checkpoint(path),
                            tr.load_checkpoint,
                            checkpoint_interval=RECOVER_STEPS,
                            checkpointer=cp)
                    except SentryQuarantine as e:
                        raised = e
                cp.flush()
                reasons = _bundle_reasons(flight)
                out["quarantine"] = dict(
                    raised=raised is not None, rollbacks=s.rollbacks,
                    restarts=reg.counter("elastic.restarts").value(),
                    bundles=reasons)
                if raised is None or s.rollbacks != QUARANTINE_K \
                        or out["quarantine"]["restarts"] != 0 \
                        or reasons.count("sentry_quarantine") != 1:
                    problems.append(f"(b) quarantine: {out['quarantine']}")
                print(f"[sentry] {card}: (b) quarantine after "
                      f"{s.rollbacks} rollbacks, re-raised by run_resilient "
                      f"with {out['quarantine']['restarts']} restarts; "
                      f"bundles {reasons}")
                del tr
                shutil.rmtree(q_dir, ignore_errors=True)
                shutil.rmtree(flight, ignore_errors=True)

                # run_resilient over the sentried trainer: one preemption
                # (before the first chunk), one raised fault (the end of
                # the first chunk run) and one watchdog abort (an op held
                # open past 1 ms around step 4's step on the card)
                watchdog.enable(poll_ms=10)
                tr = _recover_trainer(dev, steps, checkpointer=cp)
                s = TrainingSentry(SentryConfig(policy="rollback",
                                                warmup_steps=4))
                calls = {"n": 0, "watch": True}
                seen = []

                def train_fn(start, end):
                    calls["n"] += 1
                    for st in range(start, end):
                        if st == RESILIENT_INTERVAL and calls["watch"]:
                            calls["watch"] = False
                            op = watchdog.begin("train step rank=0",
                                                timeout_ms=1)
                            loss = tr.step(batch)
                            watchdog.complete_when_ready(op, [loss])
                        else:
                            loss = tr.step(batch)
                        reason = s.observe_step(
                            st, st, *_read_step(loss, tr.last_probe))
                        if reason is not None:
                            seen.append((st, reason))
                    if calls["n"] == 1:
                        raise RuntimeError("a planted fault")

                r_dir = os.path.join(root, "resilient")
                t0 = time.perf_counter()
                with chaos.scoped(seed=0,
                                  rates={"elastic.preempt": (1.0, 1)}):
                    res = run_resilient(
                        train_fn, RECOVER_STEPS, r_dir,
                        lambda step, path: tr.save_checkpoint(path),
                        tr.load_checkpoint,
                        checkpoint_interval=RESILIENT_INTERVAL,
                        checkpointer=cp)
                    fired = chaos.fires()
                run_s = time.perf_counter() - t0
                same = _same_state(_train_state(tr), want)
                reasons = _bundle_reasons(flight)
                out["resilient"] = dict(
                    restarts=res["restarts"],
                    resumed_from=os.path.basename(res["resumed_from"]),
                    bundles=reasons, fired=fired, triggers=seen,
                    counters={n: reg.counter(n).value() for n in (
                        "elastic.restarts", "elastic.preemptions")},
                    run_seconds=run_s, state_equal_fault_free=same)
                if res["restarts"] != 3 or sorted(reasons) != [
                        "restart_fault", "watchdog_abort"] or seen \
                        or out["resilient"]["counters"] != {
                            "elastic.restarts": 3,
                            "elastic.preemptions": 1} or not same:
                    problems.append(f"(b) run_resilient: "
                                    f"{out['resilient']}")
                print(f"[sentry] {card}: (b) run_resilient "
                      f"{res['restarts']} restarts, resumed from "
                      f"{out['resilient']['resumed_from']}, bundles "
                      f"{reasons}, counters {out['resilient']['counters']},"
                      f" {run_s:.2f} s; bit-equal to the fault-free run: "
                      f"{same}")
                del tr
                shutil.rmtree(r_dir, ignore_errors=True)
            finally:
                fleet.configure_flight_recorder(dir=None)
    finally:
        cp.close()
    return out, problems, ref_dir


def _relaunch_part(card, root, ref_dir):
    """(c): an ElasticSupervisor runs one worker on the card at (b)'s
    configuration; attempt 0 exits at the end of step RELAUNCH_KILL_AT,
    attempt 1 resumes from the newest complete checkpoint and finishes."""
    import filecmp
    from paddle_tpu_torch.distributed.elastic import ElasticSupervisor
    ckdir = os.path.join(root, "relaunch")
    here = os.path.dirname(os.path.abspath(__file__))
    sup = ElasticSupervisor(
        [sys.executable, os.path.abspath(__file__), "--relaunch-worker",
         ckdir, root], world_size=1,
        env=dict(os.environ, PYTHONPATH=here), max_restarts=1,
        heartbeat_grace=120.0, startup_grace=240.0, poll_interval=0.2,
        verbose=True)
    t0 = time.perf_counter()
    try:
        restarts = sup.run()
    finally:
        sup.close()
    wall = time.perf_counter() - t0

    def read(name):
        with open(os.path.join(root, name)) as f:
            return json.load(f)
    kill, resume, result = (read("relaunch_kill.json"),
                            read("relaunch_resume.json"),
                            read("relaunch_result.json"))
    final = os.path.join(ckdir, f"step_{RECOVER_STEPS:08d}")
    files = sorted(os.listdir(ref_dir))
    same = {f: filecmp.cmp(os.path.join(ref_dir, f), os.path.join(final, f),
                           shallow=False) for f in files}
    out = dict(card=card, restarts=restarts, wall_s=wall,
               kill_to_resumed_first_step_s=resume["t"] - kill["t"],
               resume=resume, result=result, files_equal=same)
    print(f"[sentry] {card}: (c) relaunch: {restarts} restart, attempt "
          f"{result['attempt']} resumed from {result['resumed_from']}; kill "
          f"(end of step {kill['step']}) to the resumed first step "
          f"{out['kill_to_resumed_first_step_s']:.2f} s; the job "
          f"{wall:.1f} s; final checkpoint files equal to the fault-free "
          f"run's: {same}")
    problems = []
    if restarts != 1 or result["attempt"] != 1 \
            or result["resumed_from"] != f"step_{RESILIENT_INTERVAL:08d}" \
            or not all(same.values()):
        problems.append(f"(c) relaunch: {out}")
    return out, problems


def relaunch_worker(ckdir, outdir, dev="cuda"):
    """(c)'s worker, started by the ElasticSupervisor: it reads the
    supervisor's variables and hands rank, world size, master and attempt
    to the port as arguments; run_resilient over (b)'s fault-free
    steps, sync saves every RESILIENT_INTERVAL steps."""
    from paddle_tpu_torch.distributed.elastic import (StoreHeartbeat,
                                                      run_resilient)
    from paddle_tpu_torch.distributed.store import TCPStore
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
    attempt = int(os.environ["PADDLE_ELASTIC_ATTEMPT"])
    store = TCPStore(host, int(port), world_size=world,
                     prefix=f"a{attempt}/", attempt=attempt)
    hb = StoreHeartbeat(store, rank, world, interval=0.5).start()
    dev = torch.device(dev)
    tr = _recover_trainer(dev)
    batch = _recover_batch(dev)
    first = []

    def write(name, obj):
        with open(os.path.join(outdir, name), "w") as f:
            json.dump(obj, f)

    def train_fn(start, end):
        for s in range(start, end):
            loss = float(tr.step(batch))
            if attempt > 0 and not first:
                first.append(s)
                write("relaunch_resume.json", {"t": time.time(), "step": s,
                                               "attempt": attempt,
                                               "loss": loss})
            if attempt == 0 and s == RELAUNCH_KILL_AT:
                write("relaunch_kill.json", {"t": time.time(), "step": s})
                os._exit(17)                # a crash: no flush, no cleanup
    res = run_resilient(train_fn, RECOVER_STEPS, ckdir,
                        lambda step, path: tr.save_checkpoint(path),
                        tr.load_checkpoint,
                        checkpoint_interval=RESILIENT_INTERVAL)
    write("relaunch_result.json", {
        "attempt": attempt, "restarts": res["restarts"],
        "resumed_from": os.path.basename(res["resumed_from"] or "")})
    hb.stop()
    store.close()
    return 0


def sentry_phase(dev, counters, reset, card, bench):
    """Phase 19: the sentry's cost at phase 9's configuration (a),
    recovery at bench.py's chip configuration (b), a relaunch (c)."""
    import shutil
    t_phase = time.perf_counter()
    steps = {"a": 0, "b": 0}
    root = tempfile.mkdtemp(prefix="chip-smoke-sentry-")
    free = shutil.disk_usage(root).free
    print(f"[sentry] {root}: {free / 1e9:.1f} GB free")
    reset()
    try:
        out, problems = {}, []
        out["cost"], more = _sentry_cost_part(dev, steps, card, bench)
        problems += more
        out["recover"], more, ref_dir = _recover_part(dev, steps, card, root)
        problems += more
        launches = counters()
        torch.cuda.empty_cache()
        out["relaunch"], more = _relaunch_part(card, root, ref_dir)
        problems += more
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tokens_a = OBS_BATCH[0] * OBS_BATCH[1]
    want_a = expected_train_launches(_sentry_config(), tokens_a)
    want_b = expected_train_launches(_recover_config(),
                                     RECOVER_BATCH[0] * RECOVER_BATCH[1])
    want = {k: steps["a"] * want_a[k] + steps["b"] * want_b[k]
            for k in want_a}
    launches_ok = all(launches[k] == v for k, v in want.items())
    if not launches_ok:
        problems.append(f"launches {launches} != {steps} steps x the count "
                        f"from the code {want}")
    rec = out["recover"]
    out.update(launches=launches, steps=steps, free_gb=free / 1e9,
               seconds=time.perf_counter() - t_phase)
    print(f"[sentry] {card}: checkpoint {rec['bytes'] / 1e9:.3f} GB, sync "
          f"save {rec['save_s']:.2f} s, restore "
          f"{rec['rollback']['restore_seconds'] or 0:.2f} s; "
          f"{free / 1e9:.1f} GB free; {steps} steps, launches = the count "
          f"from the code: {launches_ok}; phase 19 {out['seconds']:.1f} s")
    if problems:
        raise AssertionError("sentry: " + "; ".join(problems))
    return out


# -- phase 20: data-parallel training across processes -----------------------

DP_STEPS = 6                # (a): steps of each Trainer, phase 9's batch
DP_A_LAYERS = 8             # (a): the model's depth, of 22 (the phase's time)
DP_B_STEPS = 3              # (b): steps of the two-rank job
DP_B_PAD = (4, 1024)        # (b): rows below 4 labelled -100 from column 1024
# (b), against one process's run of the same global batches, bf16 compute:
# each loss within this fraction of its own (the ranks' halves round their
# bf16 products in other GEMM shapes than the whole batch)
DP_LOSS_TOL = 2e-3
# step 1's global gradient, ||dp - one|| / ||one||: phase 8's bf16 rule
# (TRAIN_BF16_GRAD_TOL)
DP_GRAD_TOL = 4e-2
# the parameters after the last step, ||dp - one|| / ||one - init||: Adam
# moves an entry by about the learning rate whatever its gradient's size,
# so an entry whose gradient is near the bf16 noise may move either way
# (0.040 on an H100 80GB HBM3 at 700 W; the planted fault's 0.419)
DP_PARAM_TOL = 0.2
DP_WORKER_TIMEOUT_S = 300


def _dp_config(**overrides):
    """Phase 9's configuration (bench.py's: the blockwise loss, plain norm
    and RoPE)."""
    return _tinyllama_config(loss_chunk=512, loss_vocab_block=0,
                             fused_norm=False, fused_rope=False, **overrides)


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _dp_collectives(dev):
    """(a): every collective of distributed/collective.py on CUDA tensors
    in the one-rank NCCL world, each its one-rank result; the watchdog's
    expiries over them, then under a `collective.dispatch/all_reduce`
    delay past a 200 ms deadline."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import chaos, watchdog
    watchdog.disable()
    watchdog.enable(poll_ms=50)
    before = watchdog.expired_count()
    x = torch.randn(4, 256, device=dev,
                    generator=torch.Generator(dev).manual_seed(20))
    ok = {}
    for op in ("sum", "max", "min", "avg", "prod"):
        t = x.clone()
        ok[f"all_reduce_{op}"] = dist.all_reduce(t, op) is t and \
            torch.equal(t, x)
    got = []
    dist.all_gather(got, x)
    ok["all_gather"] = len(got) == 1 and torch.equal(got[0], x)
    t = x.clone()
    ok["broadcast"] = torch.equal(dist.broadcast(t, src=0), x)
    t = x.clone()
    ok["reduce"] = torch.equal(dist.reduce(t, dst=0), x)
    ok["reduce_scatter"] = torch.equal(dist.reduce_scatter(x), x)
    ok["alltoall"] = torch.equal(dist.alltoall(x[None]), x[None])
    got = []
    dist.alltoall([x], got)
    ok["alltoall_list"] = torch.equal(got[0], x)
    ok["scatter"] = torch.equal(dist.scatter(x[None], src=0), x)
    dist.barrier()
    dist.send(x, dst=0)
    ok["send_recv"] = torch.equal(dist.recv(src=0), x)
    with dist.init_mesh({"dp": 1}):
        ok["psum"] = torch.equal(dist.psum(x, "dp"), x)
        ok["pmean"] = torch.equal(dist.pmean(x, "dp"), x)
        ok["ppermute"] = torch.equal(dist.ppermute(x, "dp", [(0, 0)]), x)
    torch.cuda.synchronize()
    time.sleep(0.3)
    expired = watchdog.expired_count() - before
    g = dist.new_group([0], timeout=0.2)
    with chaos.scoped(rates={"collective.dispatch/all_reduce": 1.0},
                      delay_ms=400):
        dist.all_reduce(x.clone(), group=g)
        fired = chaos.fire_count("collective.dispatch/all_reduce")
    torch.cuda.synchronize()
    time.sleep(0.3)
    return dict(ok=ok, backend=torch.distributed.get_backend(),
                expired=expired, fired=fired,
                expired_chaos=watchdog.expired_count() - before - expired,
                last_expired=watchdog.last_expired())


def _dp_trainer_run(dev, cfg, data, mesh, counters, reset):
    """(a): DP_STEPS steps of phase 9's Trainer (over `mesh`, or none),
    fed by data_iter; each step timed to its end on the card, the bytes
    of its collectives counted."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    tr = Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16"),
                 mesh=mesh, plan=None if mesh is None
                 else llama_sharding_plan(mesh.dim_names))
    torch.cuda.synchronize()
    reset()
    losses, step_s, counts = [], [], {}
    with _gloo_bytes(counts), \
            tr.data_iter(itertools.repeat(data, DP_STEPS), depth=2) as it:
        for b in it:
            t0 = time.perf_counter()
            losses.append(tr.step(b))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    launches = counters()
    out = dict(losses=[float(x) for x in losses], launches=launches,
               step_ms=_median(step_s[1:]) * 1e3,
               allreduce_bytes=sum(counts.values()) / DP_STEPS)
    del tr, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_worker_a(outdir):
    """Phase 20 (a)'s worker, one rank on NCCL (started by the port's
    launcher with --devices 0)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.kernels import launch_counters

    def reset():
        for d in launch_counters():
            for k in d:
                d[k] = 0

    def counters():
        return {k: v for d in launch_counters() for k, v in d.items()}
    dist.init_parallel_env()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"collectives": _dp_collectives(dev)}
    cfg = _dp_config(num_hidden_layers=DP_A_LAYERS)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 2048)) \
        .astype(np.int32)
    data = {"input_ids": ids, "labels": ids}
    out["dp"] = _dp_trainer_run(dev, cfg, data, dist.init_mesh({"dp": 1}),
                                counters, reset)
    out["plain"] = _dp_trainer_run(dev, cfg, data, None, counters, reset)
    _write_json(os.path.join(outdir, "dp_a.json"), out)
    dist.destroy_process_group()
    return 0


def _dp_b_batches(vocab):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(DP_B_STEPS):
        ids = rng.randint(0, vocab, (8, 2048)).astype(np.int32)
        labels = ids.copy()
        labels[:DP_B_PAD[0], DP_B_PAD[1]:] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def _dp_b_run(dev, cfg, batches, mesh, fault=False):
    """(b): DP_B_STEPS steps from seed-0 weights; returns the losses, the
    parameters at the start and the end, and step 1's gradients."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    init = [p.detach().clone() for p in model.parameters()]
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    tr = Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16"),
                 mesh=mesh, plan=None if mesh is None
                 else llama_sharding_plan(mesh.dim_names))
    if fault:
        # the planted fault: each rank's mean loss weighted 1/dp, not by
        # its share of the valid tokens (gradients averaged over ranks)
        dp = tr._dp["size"]
        tr._token_scales = lambda mbs: torch.full((len(mbs),), 1.0 / dp,
                                                  device=dev)
    losses, grad1 = [], None
    for b in batches:
        losses.append(float(tr.step(b)))
        if grad1 is None:
            grad1 = [p.grad.detach().clone() for p in model.parameters()]
    params = [p.detach().clone() for p in model.parameters()]
    del tr, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, init=init, params=params, grad1=grad1)


def _rel(a, b, scale):
    """||a - b|| / ||scale|| over lists of tensors, in f64."""
    num = sum(float((x.double() - y.double()).pow(2).sum())
              for x, y in zip(a, b))
    den = sum(float(s.double().pow(2).sum()) for s in scale)
    return (num / den) ** 0.5


def _dp_gaps(run, ref):
    return dict(
        loss=max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                       ref["losses"])),
        grad=_rel(run["grad1"], ref["grad1"], ref["grad1"]),
        param=_rel(run["params"], ref["params"],
                   [p - q for p, q in zip(ref["params"], ref["init"])]))


def dp_worker_b(outdir):
    """Phase 20 (b)'s worker: one of two ranks on the one card, gloo."""
    import hashlib
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _dp_config(num_hidden_layers=2)
    batches = _dp_b_batches(cfg.vocab_size)
    mesh = dist.init_mesh({"dp": world})
    t0 = time.perf_counter()
    run = _dp_b_run(dev, cfg, batches, mesh)
    run_s = time.perf_counter() - t0
    digest = hashlib.sha256(torch.cat([
        p.reshape(-1).view(torch.uint8) for p in run["params"]]).cpu()
        .numpy().tobytes()).digest()
    digests = dist.all_gather(torch.frombuffer(bytearray(digest),
                                               dtype=torch.uint8))
    fault = _dp_b_run(dev, cfg, batches, mesh, fault=True)
    if rank == 0:
        ref = _dp_b_run(dev, cfg, batches, None)
        _write_json(os.path.join(outdir, "dp_b.json"), dict(
            backend=torch.distributed.get_backend(), world=world,
            losses=run["losses"], ref_losses=ref["losses"],
            fault_losses=fault["losses"], gap=_dp_gaps(run, ref),
            fault_gap=_dp_gaps(fault, ref), run_s=run_s,
            ranks_bit_equal=all(torch.equal(d, digests[0])
                                for d in digests)))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_launch(args, root):
    """The port's launcher running this script as `--dp-worker ...`."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", *args,
         os.path.abspath(__file__), "--dp-worker", *root],
        env=dict(os.environ, PYTHONPATH=here), cwd=here)


def _dp_wait(procs, what):
    try:
        codes = [p.wait(timeout=DP_WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise AssertionError(f"dp: {what} exited {codes}")


def dp_phase(card):
    """Phase 20: data-parallel training across processes, the workers
    started through the port's launcher: (a) one rank on NCCL, (b) two
    gloo ranks on the one card."""
    import shutil
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-dp-")
    gc.collect()
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        _dp_wait([_dp_launch(["--devices", "0"], ["a", root])], "(a)")
        a_s = time.perf_counter() - t0
        port = _free_port()
        t0 = time.perf_counter()
        _dp_wait([_dp_launch(["--master", f"127.0.0.1:{port}", "--nnodes",
                              "2", "--rank", str(r), "--devices", "0"],
                             ["b", root]) for r in range(2)], "(b)")
        b_s = time.perf_counter() - t0
        with open(os.path.join(root, "dp_a.json")) as f:
            a = json.load(f)
        with open(os.path.join(root, "dp_b.json")) as f:
            b = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    problems = []
    coll = a["collectives"]
    bad = [k for k, v in coll["ok"].items() if not v]
    if bad or coll["backend"] != "nccl":
        problems.append(f"(a) collectives {bad} on {coll['backend']}")
    if coll["expired"] != 0 or coll["fired"] != 1 \
            or coll["expired_chaos"] != 1:
        problems.append(f"(a) watchdog {coll}")
    dp, plain = a["dp"], a["plain"]
    if dp["losses"] != plain["losses"]:
        problems.append(f"(a) dp losses {dp['losses']} != the mesh-free "
                        f"Trainer's {plain['losses']}")
    want = expected_train_launches(
        _dp_config(num_hidden_layers=DP_A_LAYERS), 8 * 2048)
    per_step = {k: dp["launches"][k] / DP_STEPS for k in want}
    if per_step != {k: float(v) for k, v in want.items()}:
        problems.append(f"(a) launches per step {per_step} != the count "
                        f"from the code {want}")
    if dp["allreduce_bytes"] != 0:
        problems.append(f"(a) a dp axis of extent 1 moved "
                        f"{dp['allreduce_bytes']} collective bytes a step")
    gap, fault = b["gap"], b["fault_gap"]
    if b["backend"] != "gloo" or not b["ranks_bit_equal"]:
        problems.append(f"(b) backend {b['backend']}, ranks bit-equal "
                        f"{b['ranks_bit_equal']}")
    if gap["loss"] > DP_LOSS_TOL or gap["grad"] > DP_GRAD_TOL \
            or gap["param"] > DP_PARAM_TOL:
        problems.append(f"(b) against one process: {gap}")
    if not (fault["grad"] > DP_GRAD_TOL and fault["param"] > DP_PARAM_TOL):
        problems.append(f"(b) the planted mean-of-means fault reads inside "
                        f"the tolerances: {fault}")
    out = dict(card=card, a=a, b=b, a_s=a_s, b_s=b_s,
               launches=dp["launches"], launches_per_step=per_step,
               seconds=time.perf_counter() - t_phase)
    print(f"[dp] {card}: (a) one rank on {coll['backend']}: "
          f"{len(coll['ok'])} collectives equal to their one-rank results; "
          f"watchdog expiries {coll['expired']}, under the dispatch delay "
          f"{coll['expired_chaos']} ({coll['last_expired']})")
    print(f"[dp] {card}: (a) phase 9's Trainer at {DP_A_LAYERS} layers, "
          f"{DP_STEPS} steps: losses "
          f"over init_mesh({{'dp': 1}}) bit-equal to the mesh-free run's: "
          f"{dp['losses'] == plain['losses']} {dp['losses']}; step "
          f"{dp['step_ms']:.1f} ms with the mesh, {plain['step_ms']:.1f} ms "
          f"without; collective bytes a step {dp['allreduce_bytes']:.0f} "
          f"(a dp axis of extent 1 runs none); launches per step "
          f"{per_step}")
    print(f"[dp] {card}: (b) 2 ranks on {b['backend']} on the one card, "
          f"TinyLlama width at 2 layers, 8 x 2048 split 4 + 4, rows 0-3 "
          f"-100 from column {DP_B_PAD[1]}, {DP_B_STEPS} steps in "
          f"{b['run_s']:.1f} s: losses {b['losses']} against one process "
          f"{b['ref_losses']}; gaps: loss {gap['loss']:.3e} (tol "
          f"{DP_LOSS_TOL}), step 1 gradient {gap['grad']:.3e} (tol "
          f"{DP_GRAD_TOL}), parameters after step {DP_B_STEPS} "
          f"{gap['param']:.3e} of the update (tol {DP_PARAM_TOL}); ranks "
          f"bit-equal "
          f"{b['ranks_bit_equal']}")
    print(f"[dp] {card}: (b) planted mean-of-means fault: loss "
          f"{fault['loss']:.3e}, step 1 gradient {fault['grad']:.3e}, "
          f"parameters {fault['param']:.3e}; phase 20 "
          f"{out['seconds']:.1f} s ((a) {a_s:.1f} s, (b) {b_s:.1f} s)")
    if problems:
        raise AssertionError("dp: " + "; ".join(problems))
    return out


# -- phase 21: tensor-parallel training across processes ---------------------

TP_WARMUP = 1               # (a): the untimed first step
TP_STEPS = 3                # (a): timed steps after it
TP_BATCH = (2, 2048)        # (a): the global batch, phase 9's 8 x 2048 cut to 2
TP_PAD = (1, 1024)          # (a): row 0 labelled -100 from column 1024
# (a), and phases 22 (a) and 23 (a): the model's depth, of 22 (the whole
# run's time: a gloo step of these phases moves its sums through the host)
TP_LAYERS = 8
# (a), each against one process's run of the same model and batches, bf16
# compute, set from a first run on an H100 80GB HBM3 at 700 W (PERF.md): each
# loss within this fraction of its own (1.15e-4 there; the local-lse
# fault's 6.4e-2): the mp ranks' partial products, activations and input
# gradients are rounded to bf16 before their sum
TP_LOSS_TOL = 2e-3
# step 1's gradient over the whole model, ||tp - one|| / ||one|| (0.040
# there, phase 8's bf16 rule; the dropped f-op's 0.936)
TP_GRAD_TOL = 6e-2
# the parameters after the last step, ||tp - one|| / ||one - init|| (0.114
# there)
TP_PARAM_TOL = 0.2
TP_WORKER_TIMEOUT_S = 420
TP_CE = (4096, 2048, 32000)   # (b): x rows (phase 21's batch), hidden, vocab


def _tp_config(**overrides):
    """Phase 21's model: TinyLlama-1.1B at full width and TP_LAYERS of its
    22 layers, flash, recompute, the fused norm and RoPE, the blockwise
    loss."""
    base = dict(loss_chunk=512, num_hidden_layers=TP_LAYERS)
    base.update(overrides)
    return _tinyllama_config(**base)


def _tp_batches(vocab):
    rng = np.random.RandomState(21)
    out = []
    for _ in range(TP_WARMUP + TP_STEPS):
        ids = rng.randint(0, vocab, TP_BATCH).astype(np.int32)
        labels = ids.copy()
        labels[:TP_PAD[0], TP_PAD[1]:] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def _tp_trainer(dev, cfg, fleet=None):
    """Phase 9's optimizer and compute type over a seed-0 model: mesh-free,
    or cut by `fleet.distributed_model` and trained on the fleet mesh."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    if fleet is not None:
        model = fleet.distributed_model(model)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    if fleet is not None:
        opt = fleet.distributed_optimizer(opt)
    return Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16"),
                   mesh=None if fleet is None else fleet.get_mesh(),
                   plan=None if fleet is None else model._fleet_plan)


def _cut(shards, name, t):
    """This rank's piece of a whole tensor `t` of parameter `name`
    (`shards[name]`: its cuts, distributed/sharding.py `cuts_of`)."""
    from paddle_tpu_torch.distributed.sharding import cut_whole
    return cut_whole(t, shards[name]) if shards[name] else t


def _tp_sq_gaps(rank, shards, pairs, dev):
    """(sum of |a - b|^2, sum of |b|^2) over this rank's pieces of (a, b)
    pairs by parameter name (host tensors, summed in f64 on `dev`), summed
    over the ranks; a parameter that is not cut counts on rank 0 only."""
    from paddle_tpu_torch.distributed import collective
    acc = torch.zeros(2, dtype=torch.float64, device=dev)
    for name, a, b in pairs:
        if not shards[name] and rank != 0:
            continue
        a64, b64 = a.to(dev).double(), b.to(dev).double()
        acc[0] += (a64 - b64).pow(2).sum()
        acc[1] += b64.pow(2).sum()
    acc = acc.cpu()
    collective.all_reduce(acc)
    return float(acc[0]), float(acc[1])


def _tp_gaps(rank, shards, run, ref, dev):
    """The (a) gaps of one run against the one-process reference: losses,
    step 1's gradient over its norm, the parameters after the last step
    over the update's norm (each over the whole model)."""
    out = {"loss": max(abs(a - b) / abs(b) for a, b in
                       zip(run["losses"], ref["losses"]))}
    num, den = _tp_sq_gaps(rank, shards, [
        (n, run["grad1"][n], ref["grad1"][n]) for n in shards], dev)
    out["grad"] = (num / den) ** 0.5
    if "params" in run:
        num, _ = _tp_sq_gaps(rank, shards, [
            (n, run["params"][n], ref["params"][n]) for n in shards], dev)
        _, upd = _tp_sq_gaps(rank, shards, [
            (n, ref["init"][n], ref["params"][n] - ref["init"][n])
            for n in shards], dev)
        out["param"] = (num / upd) ** 0.5
    return out


def _host(t):
    """A host copy of `t` (never a view of a live tensor)."""
    return t.to("cpu", copy=True)


def _tp_steps(tr, batches, shards, params=True, first=False):
    """The steps of one run, each to its end on the card: losses, step
    ms, step 1's gradients and the last parameters (with `first`, also
    those after step 1) as this rank's pieces on the host (a mesh-free
    run's tensors cut by `shards`)."""
    if tr.mesh is not None:
        shards = dict.fromkeys(shards)       # its tensors are the pieces
    losses, step_s, grad1 = [], [], None
    for b in batches:
        t0 = time.perf_counter()
        losses.append(float(tr.step(b)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if grad1 is None:
            grad1 = {n: _host(_cut(shards, n, p.grad.detach()))
                     for n, p in tr.model.named_parameters()}
            if first:
                params1 = {n: _host(_cut(shards, n, p.detach()))
                           for n, p in tr.model.named_parameters()}
    out = dict(losses=losses, step_s=step_s, grad1=grad1)
    if first:
        out["params1"] = params1
    if params:
        out["params"] = {n: _host(_cut(shards, n, p.detach()))
                         for n, p in tr.model.named_parameters()}
    return out


@contextlib.contextmanager
def _gloo_bytes(counts):
    """Count the bytes of every all-reduce, all-gather and reduce-scatter
    (each rank's input) while inside, by the group's rank count."""
    from paddle_tpu_torch.distributed import collective
    saved = (collective.all_reduce, collective.all_gather,
             collective.reduce_scatter)

    def _add(ts, group):
        n = collective._get_group(group).nranks
        counts[n] = counts.get(n, 0) + sum(t.numel() * t.element_size()
                                           for t in ts)

    def all_reduce(tensor, op=collective.ReduceOp.SUM, group=None,
                   sync_op=True):
        _add([tensor], group)
        return saved[0](tensor, op, group, sync_op)

    def all_gather(tensor_list, tensor=None, group=None, sync_op=True):
        _add([tensor if tensor is not None else tensor_list], group)
        return saved[1](tensor_list, tensor, group, sync_op)

    def reduce_scatter(tensor, tensor_list=None, op=collective.ReduceOp.SUM,
                       group=None, sync_op=True):
        _add(tensor_list if tensor_list is not None else [tensor], group)
        return saved[2](tensor, tensor_list, op, group, sync_op)

    (collective.all_reduce, collective.all_gather,
     collective.reduce_scatter) = all_reduce, all_gather, reduce_scatter
    try:
        yield counts
    finally:
        (collective.all_reduce, collective.all_gather,
         collective.reduce_scatter) = saved


def tp_worker(outdir, device="cuda"):
    """Phase 21 (a)'s worker: one of two mp ranks on the one card, gloo
    (started by the port's launcher, `--nnodes 2 --rank r`); NCCL takes
    one rank a device."""
    import dataclasses
    import hashlib
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.launch.smoke import planted
    from paddle_tpu_torch.kernels import launch_counters
    from paddle_tpu_torch.distributed import env
    dist.init_parallel_env(device=device, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = env.world_device()
    cfg = _tp_config()
    batches = _tp_batches(cfg.vocab_size)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": world}
    fleet.init(is_collective=True, strategy=strategy)
    t_phase = time.perf_counter()
    stage = {}                # seconds since t_phase at each stage's end

    # the shards' layout, from a cut model
    from paddle_tpu_torch.distributed.sharding import cuts_of
    tr = _tp_trainer(dev, cfg, fleet)
    shards = {n: cuts_of(p) for n, p in tr.model.named_parameters()}
    local_bytes = sum(p.numel() * p.element_size()
                      for p in tr.model.parameters())
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the reference: one process, the mesh-free Trainer, the same seed-0
    # model and batches (each rank runs it, and keeps its own pieces)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = _tp_trainer(dev, cfg)
    ref = _tp_steps(tr, batches, shards)
    ref_peak = torch.cuda.max_memory_allocated()
    stage["reference"] = time.perf_counter() - t_phase
    whole_bytes = sum(p.numel() * p.element_size()
                      for p in tr.model.parameters())
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the tensor-parallel run, its launches and its gloo bytes counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = _tp_trainer(dev, cfg, fleet)
    # the seed-0 init, this rank's pieces (the reference starts from it)
    ref["init"] = {n: _host(p.detach())
                   for n, p in tr.model.named_parameters()}
    for d in launch_counters():
        for k in d:
            d[k] = 0
    counts = {}
    with _gloo_bytes(counts):
        run = _tp_steps(tr, batches, shards)
    launches = {k: v for d in launch_counters() for k, v in d.items()}
    tp_peak = torch.cuda.max_memory_allocated()
    digest = hashlib.sha256()
    for n, p in tr.model.named_parameters():
        if not shards[n]:
            digest.update(_host(p.detach()).numpy().tobytes())
    mine = torch.frombuffer(bytearray(digest.digest()), dtype=torch.uint8)
    replicated_equal = all(torch.equal(d, mine)
                           for d in dist.all_gather(mine))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    stage["tp_run"] = time.perf_counter() - t_phase
    gap = _tp_gaps(rank, shards, run, ref, dev)
    stage["gaps"] = time.perf_counter() - t_phase

    # the planted faults, each one step from the same weights
    faults = {}
    for fault in ("local_lse", "fop"):
        tr = _tp_trainer(dev, cfg, fleet)
        with planted(fault):
            one = _tp_steps(tr, batches[:1], shards, params=False)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        faults[fault] = _tp_gaps(rank, shards, one, ref, dev)
        stage[fault] = time.perf_counter() - t_phase
    peaks = dist.all_gather(torch.tensor([tp_peak, ref_peak],
                                         dtype=torch.float64))
    steps = len(batches)
    want = expected_train_launches(
        dataclasses.replace(cfg, vocab_size=cfg.vocab_size // world),
        TP_BATCH[0] * TP_BATCH[1])
    if rank == 0:
        _write_json(os.path.join(outdir, "tp_a.json"), dict(
            backend=torch.distributed.get_backend(), world=world,
            losses=run["losses"], ref_losses=ref["losses"], gap=gap,
            faults=faults, replicated_equal=replicated_equal,
            launches=launches,
            launches_per_step={k: launches.get(k, 0) / steps for k in want},
            want_per_step=want,
            step_ms=_median(run["step_s"][TP_WARMUP:]) * 1e3,
            ref_step_ms=_median(ref["step_s"][TP_WARMUP:]) * 1e3,
            gloo_bytes_per_step={str(k): v / steps
                                 for k, v in counts.items()},
            peak_gb=[[float(p[0]) / 1e9, float(p[1]) / 1e9] for p in peaks],
            param_bytes=[local_bytes, whole_bytes], stages=stage,
            seconds=time.perf_counter() - t_phase))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _tp_ce_part(dev):
    """(b): the blockwise CE kernels on the two vocab shards of a
    (32000, 2048) head, in one process: each shard's forward and backward
    against its twin (phase 4's rules), the combination (the lse over the
    shards, the picked logits and dx summed, dW stacked) against the
    whole-vocab kernels, and shard 0's kernels timed beside their bound
    and torch.matmul of the bare product."""
    from paddle_tpu_torch.kernels import blockwise_ce as bce
    n, d, v = TP_CE
    vl = v // 2
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(v, d, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    lab = torch.randint(0, v, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    lab[2047::2048] = -100            # each row's last position, shifted
    lab[5::97] = -100
    one = torch.ones((), device=dev)
    whole_loss, whole_lse, count = bce.ce_fwd(x, w, lab)
    whole_dx, whole_dw = bce.ce_bwd(x, w, lab, whole_lse, count, one)
    ws = [w[r * vl:(r + 1) * vl] for r in range(2)]
    labs = [bce.local_labels(lab, r * vl, vl) for r in range(2)]
    on_shard = [int(((labs[r] >= 0) & (labs[r] < vl)).sum()) for r in (0, 1)]
    err, ratio, rows = {}, {}, []
    for r in range(2):
        loss_r, lse_r, _ = bce.ce_fwd(x, ws[r], labs[r])
        t_loss, t_lse, _ = bce.ce_fwd_ref(x, ws[r], labs[r], 512)
        if abs(float(loss_r) - float(t_loss)) > 1e-5 * abs(float(t_loss)):
            raise AssertionError(f"tp ce shard {r}: loss {float(loss_r)} "
                                 f"against the twin's {float(t_loss)}")
        err[f"lse{r}"] = _check(f"tp ce shard {r} lse", lse_r, t_lse,
                                F32_TOL)
        rows.append(bce.ce_fwd_rows(x, ws[r], labs[r]))
    lse = bce.combine_lse([r[0] for r in rows])
    picked = rows[0][1] + rows[1][1]
    valid = lab != -100
    loss = torch.where(valid, lse - picked, 0.0).sum() / count
    dxs, dws = [], []
    for r in range(2):
        dx_r, dw_r = bce.ce_bwd(x, ws[r], labs[r], lse, count, one)
        t_dx, t_dw = bce.ce_bwd_ref(x, ws[r], labs[r], lse, count, one, 512)
        for name, a, b in (("dx", dx_r, t_dx), ("dw", dw_r, t_dw)):
            err[f"{name}{r}"], ratio[f"{name}{r}"] = _check_rows(
                f"tp ce shard {r} {name}", a, b, CE_BF16_TOL)
        dxs.append(dx_r)
        dws.append(dw_r)
        del t_dx, t_dw
    if abs(float(loss) - float(whole_loss)) > 1e-5 * abs(float(whole_loss)):
        raise AssertionError(f"tp ce combined loss {float(loss)} against the "
                             f"whole vocab's {float(whole_loss)}")
    err["lse"] = _check("tp ce combined lse", lse, whole_lse, F32_TOL)
    err["dx"], ratio["dx"] = _check_rows("tp ce combined dx", dxs[0] + dxs[1],
                                         whole_dx, CE_BF16_TOL)
    err["dw"], ratio["dw"] = _check_rows(
        "tp ce combined dW", torch.cat(dws), whole_dw, CE_BF16_TOL)
    # shard 0's kernels alone (the shards are the same work)
    x0, w0, l0 = x, ws[0], labs[0]
    vs = bce.ce_super_block(n, vl, 2)
    blocks = [(i * vs, min(vs, vl - i * vs)) for i in range(-(-vl // vs))]
    scale = torch.where(l0 != -100, one / count, 0.0).contiguous()
    wsp = torch.empty((n, vs), dtype=x.dtype, device=dev)
    acc = torch.empty((n, d), dtype=torch.float32, device=dev)
    dx, dw = torch.empty_like(x), torch.empty_like(w0)
    last = len(blocks) - 1
    ms = {"ce_fwd": _time_ms(lambda: bce.ce_fwd(x0, w0, l0), [()], iters=10),
          "ce_dlogits": _time_ms(lambda: [bce._launch_dlogits(
              x0, w0, l0, lse, scale, wsp, a, c) for a, c in blocks], [()],
              iters=4),
          "ce_dx": _time_ms(lambda: [bce._launch_dx(
              wsp, w0, acc, dx, a, c, i == 0, i == last)
              for i, (a, c) in enumerate(blocks)], [()], iters=4),
          "ce_dw": _time_ms(lambda: [bce._launch_dw(wsp, x0, dw, a, c)
                                     for a, c in blocks], [()], iters=4)}
    s_out = torch.empty((n, vl), dtype=x.dtype, device=dev)
    matmul_ms = {
        "ce_fwd": _time_ms(lambda: torch.matmul(x0, w0.t(), out=s_out), [()],
                           iters=10),
        "ce_dlogits": _time_ms(lambda: [torch.matmul(
            x0, w0[a:a + c].t(), out=s_out[:, :c]) for a, c in blocks],
            [()], iters=4),
        "ce_dx": _time_ms(lambda: [torch.matmul(wsp[:, :c], w0[a:a + c],
                                                out=dx) for a, c in blocks],
                          [()], iters=4),
        "ce_dw": _time_ms(lambda: [torch.matmul(
            wsp[:, :c].t(), x0, out=dw[a:a + c]) for a, c in blocks], [()],
            iters=4)}
    flops = 2 * n * d * vl
    in_bytes = n * d * 2 + vl * d * 2 + n * 4
    bounds = {"ce_fwd": _bound(in_bytes + 2 * n * 4, flops,
                               BF16_TENSOR_FLOPS),
              "ce_dlogits": _bound(in_bytes + 2 * n * 4 + n * vl * 2, flops,
                                   BF16_TENSOR_FLOPS),
              "ce_dx": _bound(n * vl * 2 + vl * d * 2 + n * d * 2, flops,
                              BF16_TENSOR_FLOPS),
              "ce_dw": _bound(n * vl * 2 + n * d * 2 + vl * d * 2, flops,
                              BF16_TENSOR_FLOPS)}
    shape = (f"x ({n}, {d}), W shard ({vl}, {d}) of ({v}, {d}) bf16, "
             f"{len(blocks)} super-block(s) of {vs}")
    out = {k: dict(shape=shape, ms=ms[k], bound_ms=bounds[k][0],
                   bound_by=bounds[k][1], matmul_ms=matmul_ms[k])
           for k in ms}
    del x, w, lab, whole_dx, whole_dw, dxs, dws, wsp, acc, dx, dw, s_out
    torch.cuda.empty_cache()
    return dict(kernels=out, err=err, err_over_bound=ratio,
                labels_on_shard=on_shard, ignored=int((~valid).sum()),
                shape=shape)


def _tp_launch(args, root):
    """The port's launcher running this script as `--tp-worker DIR`."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", *args,
         os.path.abspath(__file__), "--tp-worker", root],
        env=dict(os.environ, PYTHONPATH=here), cwd=here)


def tp_phase(card, dev):
    """Phase 21: tensor-parallel training across processes: (a) two gloo
    mp ranks on the one card, the workers started through the port's
    launcher; (b) the CE kernels on a vocab shard, in this process."""
    import shutil
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-tp-")
    gc.collect()
    torch.cuda.empty_cache()
    try:
        port = _free_port()
        t0 = time.perf_counter()
        procs = [_tp_launch(["--master", f"127.0.0.1:{port}", "--nnodes",
                             "2", "--rank", str(r), "--devices", "0"], root)
                 for r in range(2)]
        try:
            codes = [p.wait(timeout=TP_WORKER_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise AssertionError(f"tp: (a)'s workers exited {codes}")
        a_s = time.perf_counter() - t0
        with open(os.path.join(root, "tp_a.json")) as f:
            a = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    b = _tp_ce_part(dev)
    b_s = time.perf_counter() - t0
    problems = []
    gap = a["gap"]
    if a["backend"] != "gloo" or a["world"] != 2 or not a["replicated_equal"]:
        problems.append(f"(a) backend {a['backend']}, world {a['world']}, "
                        f"replicated bit-equal {a['replicated_equal']}")
    if gap["loss"] > TP_LOSS_TOL or gap["grad"] > TP_GRAD_TOL \
            or gap["param"] > TP_PARAM_TOL:
        problems.append(f"(a) against one process: {gap}")
    want = {k: float(v) for k, v in a["want_per_step"].items()}
    if a["launches_per_step"] != want:
        problems.append(f"(a) launches per step {a['launches_per_step']} != "
                        f"the count from the code {want}")
    lse_f, fop_f = a["faults"]["local_lse"], a["faults"]["fop"]
    if not lse_f["loss"] > TP_LOSS_TOL:
        problems.append(f"(a) the planted local-lse fault reads inside the "
                        f"loss tolerance: {lse_f}")
    if not fop_f["grad"] > TP_GRAD_TOL:
        problems.append(f"(a) the planted dropped f-op reads inside the "
                        f"gradient tolerance: {fop_f}")
    out = dict(card=card, a=a, b=b, a_s=a_s, b_s=b_s,
               launches=a["launches"], seconds=time.perf_counter() - t_phase)
    peak = a["peak_gb"]
    gb = {k: v / 1e9 for k, v in a["gloo_bytes_per_step"].items()}
    print(f"[tp] {card}: (a) 2 mp ranks on {a['backend']} on the one card "
          f"(fleet.init mp_degree 2, distributed_model, the Trainer on the "
          f"fleet mesh), TinyLlama-1.1B at {TP_LAYERS} layers, "
          f"{TP_BATCH[0]} x "
          f"{TP_BATCH[1]} ids, row 0 -100 from column {TP_PAD[1]}, "
          f"{TP_WARMUP} + {TP_STEPS} steps: losses {a['losses']} against one "
          f"process {a['ref_losses']}; gaps: loss {gap['loss']:.3e} (tol "
          f"{TP_LOSS_TOL}), step 1 gradient {gap['grad']:.3e} (tol "
          f"{TP_GRAD_TOL}), parameters {gap['param']:.3e} of the update (tol "
          f"{TP_PARAM_TOL}); replicated parameters bit-equal across the ranks "
          f"{a['replicated_equal']}; launches per step = the count from the "
          f"code {a['launches_per_step'] == want}")
    print(f"[tp] {card}: (a) planted faults: the loss from each rank's local "
          f"lse reads loss {lse_f['loss']:.3e}, gradient {lse_f['grad']:.3e}; "
          f"a column-parallel f-op without its backward all-reduce reads "
          f"loss {fop_f['loss']:.3e}, gradient {fop_f['grad']:.3e}")
    print(f"[tp] {card}: (a) peak memory per rank {peak[0][0]:.2f} and "
          f"{peak[1][0]:.2f} GB against one process's {peak[0][1]:.2f} GB; "
          f"parameters {a['param_bytes'][0] / 1e9:.3f} GB a rank against "
          f"{a['param_bytes'][1] / 1e9:.3f} GB whole; step "
          f"{a['step_ms']:.1f} ms against one process's "
          f"{a['ref_step_ms']:.1f} ms (both ranks' references share the "
          f"card; the fleet mesh's dp axis of extent 1 reduces nothing); "
          f"gloo bytes a step by group size "
          f"{gb} GB; worker {a['seconds']:.1f} s, stages (s from its start) "
          f"{ {k: round(v, 1) for k, v in a['stages'].items()} }")
    ker = b["kernels"]
    print(f"[tp] {card}: (b) blockwise CE on a vocab shard, {b['shape']}, "
          f"labels on shard 0 / 1 {b['labels_on_shard']}, {b['ignored']} "
          f"ignored: each shard against its twin and the combination against "
          f"the whole vocab's kernels, max |err| {b['err']}, |err| / bound "
          f"{b['err_over_bound']}; shard 0: "
          + ", ".join(f"{k} {e['ms']:.4f} ms (bound {e['bound_ms']:.4f}, "
                      f"matmul {e['matmul_ms']:.4f})" for k, e in ker.items())
          + f"; phase 21 {out['seconds']:.1f} s ((a) {a_s:.1f} s, (b) "
          f"{b_s:.1f} s)")
    if problems:
        raise AssertionError("tp: " + "; ".join(problems))
    return out


# -- phase 22: FSDP (ZeRO-3) training across processes, optimizer offload ----

FSDP_STEPS = 3              # (a): timed steps after phase 21's warm-up step
FSDP_WORKER_TIMEOUT_S = 600
OFFLOAD_STEPS = 3           # (b): steps after the warm-up, each way


def _state_bytes(opt):
    """Bytes of the optimizer's state tensors."""
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values())


def _param_tensors(cfg):
    """How many parameter tensors an unfused, untied Llama of `cfg` has:
    9 a layer, the embedding, the final norm and the head."""
    return 9 * cfg.num_hidden_layers + 3


def _fsdp_want_bytes(cfg, world):
    """(a rank's parameter bytes, the whole model's) from the code: every
    parameter the plan puts on 'fsdp' (the projections, the embedding and
    the head) cut in `world`, the norms whole; f32."""
    from paddle_tpu_torch.models.llama import param_count
    d, layers = cfg.hidden_size, cfg.num_hidden_layers
    whole = param_count(cfg)
    norms = (2 * layers + 1) * d
    return 4 * ((whole - norms) // world + norms), 4 * whole


def fsdp_worker(outdir, device="cuda"):
    """Phase 22 (a)'s worker: one of two fsdp ranks on the one card, gloo
    (started by the port's launcher, `--nnodes 2 --rank r`)."""
    import hashlib
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.distributed.launch.smoke import planted
    from paddle_tpu_torch.distributed.sharding import cuts_of
    from paddle_tpu_torch.kernels import launch_counters
    dist.init_parallel_env(device=device, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = env.world_device()
    cfg = _tp_config()
    batches = _tp_batches(cfg.vocab_size)[:1 + FSDP_STEPS]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sharding_degree": world}
    fleet.init(is_collective=True, strategy=strategy)
    t_phase = time.perf_counter()
    stage = {}                # seconds since t_phase at each stage's end

    def drop():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # the reference: one process, the mesh-free Trainer, the same seed-0
    # model and batches (each rank runs it, and keeps its own pieces)
    drop()
    tr = _tp_trainer(dev, cfg, fleet)
    shards = {n: cuts_of(p) for n, p in tr.model.named_parameters()}
    del tr
    drop()
    tr = _tp_trainer(dev, cfg)
    ref = _tp_steps(tr, batches, shards, first=True)
    ref_peak = torch.cuda.max_memory_allocated()
    ref_bytes = [sum(p.numel() * p.element_size()
                     for p in tr.model.parameters()),
                 _state_bytes(tr.optimizer)]
    del tr
    drop()
    stage["reference"] = time.perf_counter() - t_phase

    # the FSDP run, its launches and its gloo bytes counted
    tr = _tp_trainer(dev, cfg, fleet)
    ref["init"] = {n: _host(p.detach())
                   for n, p in tr.model.named_parameters()}
    for d in launch_counters():
        for k in d:
            d[k] = 0
    counts = {}
    with _gloo_bytes(counts):
        run = _tp_steps(tr, batches, shards)
    launches = {k: v for d in launch_counters() for k, v in d.items()}
    peak = torch.cuda.max_memory_allocated()
    local_bytes = [sum(p.numel() * p.element_size()
                       for p in tr.model.parameters()),
                   _state_bytes(tr.optimizer)]
    digest = hashlib.sha256()
    for n, p in tr.model.named_parameters():
        if not shards[n]:
            digest.update(_host(p.detach()).numpy().tobytes())
    mine = torch.frombuffer(bytearray(digest.digest()), dtype=torch.uint8)
    norms_equal = all(torch.equal(d, mine) for d in dist.all_gather(mine))
    del tr
    drop()
    stage["fsdp_run"] = time.perf_counter() - t_phase
    gap = _tp_gaps(rank, shards, run, ref, dev)

    # the planted faults, one step each from the same weights, against
    # the reference's first step
    faults = {}
    ref1 = dict(ref, losses=ref["losses"][:1], params=ref["params1"])
    for fault in ("fsdp_double", "fsdp_local"):
        with planted(fault):
            tr = _tp_trainer(dev, cfg, fleet)
            one = _tp_steps(tr, batches[:1], shards)
        del tr
        drop()
        faults[fault] = _tp_gaps(rank, shards, one, ref1, dev)
        stage[fault] = time.perf_counter() - t_phase
    peaks = dist.all_gather(torch.tensor([peak, ref_peak],
                                         dtype=torch.float64))
    steps = len(batches)
    want = expected_train_launches(cfg, TP_BATCH[0] * TP_BATCH[1] // world)
    want_bytes = _fsdp_want_bytes(cfg, world)
    if rank == 0:
        _write_json(os.path.join(outdir, "fsdp_a.json"), dict(
            backend=torch.distributed.get_backend(), world=world,
            losses=run["losses"], ref_losses=ref["losses"], gap=gap,
            faults=faults, norms_equal=norms_equal, launches=launches,
            launches_per_step={k: launches.get(k, 0) / steps for k in want},
            want_per_step=want,
            step_ms=_median(run["step_s"][TP_WARMUP:]) * 1e3,
            ref_step_ms=_median(ref["step_s"][TP_WARMUP:]) * 1e3,
            gloo_bytes_per_step={str(k): v / steps
                                 for k, v in counts.items()},
            peak_gb=[[float(p[0]) / 1e9, float(p[1]) / 1e9] for p in peaks],
            bytes=dict(local=local_bytes, whole=ref_bytes,
                       want_params=want_bytes), stages=stage,
            seconds=time.perf_counter() - t_phase))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _offload_run(dev, cfg, data, offload):
    """(b): 1 + OFFLOAD_STEPS steps of phase 9's Trainer from seed-0
    weights; the losses, the parameters on the host, the device peak
    over the steps and the steps' ms."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    tr = Trainer(model, opt, TrainStepConfig(
        compute_dtype="bfloat16", offload_opt_state=offload))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(1 + OFFLOAD_STEPS):
        t0 = time.perf_counter()
        losses.append(float(tr.step(data)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    out = dict(losses=losses, peak=torch.cuda.max_memory_allocated(),
               step_ms=_median(step_s[1:]) * 1e3,
               on_device=sum(v.numel() * v.element_size()
                             for st in opt.state.values()
                             for v in st.values() if v.is_cuda),
               params=[_host(p.detach()) for p in model.parameters()],
               offload=tr.config.offload_opt_state)
    del tr, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fsdp_phase(card, dev, counters, reset, tp):
    """Phase 22: (a) FSDP on two gloo ranks on the one card, the workers
    started through the port's launcher; (b) optimizer-state offload in
    this process. `tp` is phase 21's result (its peak per rank)."""
    import shutil
    from paddle_tpu_torch.models.llama import param_count
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-fsdp-")
    gc.collect()
    torch.cuda.empty_cache()
    try:
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--master", f"127.0.0.1:{port}", "--nnodes", "2", "--rank",
             str(r), "--devices", "0", os.path.abspath(__file__),
             "--fsdp-worker", root],
            env=dict(os.environ, PYTHONPATH=os.path.dirname(
                os.path.abspath(__file__))),
            cwd=os.path.dirname(os.path.abspath(__file__)))
            for r in range(2)]
        try:
            codes = [p.wait(timeout=FSDP_WORKER_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise AssertionError(f"fsdp: (a)'s workers exited {codes}")
        a_s = time.perf_counter() - t0
        with open(os.path.join(root, "fsdp_a.json")) as f:
            a = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (b): offload off, then on, phase 9's configuration
    t0 = time.perf_counter()
    cfg = _dp_config()
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 2048)) \
        .astype(np.int32)
    data = {"input_ids": torch.from_numpy(ids).to(dev),
            "labels": torch.from_numpy(ids).to(dev)}
    off = _offload_run(dev, cfg, data, False)
    reset()
    on = _offload_run(dev, cfg, data, True)
    b_launches = counters()
    b_s = time.perf_counter() - t0
    moments = 8 * param_count(cfg)
    params_equal = all(torch.equal(x, y)
                       for x, y in zip(off["params"], on["params"]))
    drop = off["peak"] - on["peak"]
    del off["params"], on["params"]

    problems = []
    gap = a["gap"]
    if a["backend"] != "gloo" or a["world"] != 2 or not a["norms_equal"]:
        problems.append(f"(a) backend {a['backend']}, world {a['world']}, "
                        f"norms bit-equal {a['norms_equal']}")
    if gap["loss"] > DP_LOSS_TOL or gap["grad"] > DP_GRAD_TOL \
            or gap["param"] > DP_PARAM_TOL:
        problems.append(f"(a) against one process: {gap}")
    want = {k: float(v) for k, v in a["want_per_step"].items()}
    if a["launches_per_step"] != want:
        problems.append(f"(a) launches per step {a['launches_per_step']} != "
                        f"the count from the code {want}")
    by = a["bytes"]
    want_params, whole_params = by["want_params"]
    if by["local"][0] != want_params or by["whole"][0] != whole_params \
            or by["local"][1] != 2 * want_params + 8 * _param_tensors(
                _tp_config()):
        problems.append(f"(a) bytes a rank {by['local']} (whole "
                        f"{by['whole']}) against the code's parameters "
                        f"{want_params} of {whole_params}")
    for name, f in a["faults"].items():
        if not (f["grad"] > DP_GRAD_TOL and f["param"] > DP_PARAM_TOL):
            problems.append(f"(a) the planted fault {name} reads inside the "
                            f"gradient's or the parameters' tolerance: {f}")
    if off["losses"] != on["losses"] or not params_equal:
        problems.append(f"(b) offload changed the run: losses "
                        f"{off['losses']} against {on['losses']}, parameters "
                        f"bit-equal {params_equal}")
    if not on["offload"] or on["on_device"] != 8 * _param_tensors(cfg) \
            or drop < moments:
        problems.append(f"(b) offload: flag {on['offload']}, state bytes on "
                        f"the card {on['on_device']}, peak {on['peak']} "
                        f"against {off['peak']} (a drop of {drop}, the "
                        f"moments are {moments})")
    out = dict(card=card, a=a, b=dict(off=off, on=on, peak_drop=drop,
                                      moment_bytes=moments,
                                      params_equal=params_equal),
               a_s=a_s, b_s=b_s, launches=a["launches"],
               offload_launches=b_launches,
               seconds=time.perf_counter() - t_phase)
    peak = a["peak_gb"]
    tp_peak = tp["a"]["peak_gb"]
    gb = {k: v / 1e9 for k, v in a["gloo_bytes_per_step"].items()}
    state_rank = 4 * want_params / 1e9
    print(f"[fsdp] {card}: (a) 2 fsdp ranks on {a['backend']} on the one "
          f"card (fleet.init sharding_degree 2, distributed_model, the "
          f"Trainer on the fleet mesh), TinyLlama-1.1B at {TP_LAYERS} "
          f"layers, "
          f"{TP_BATCH[0]} x {TP_BATCH[1]} ids split 1 + 1, row 0 -100 from "
          f"column {TP_PAD[1]}, {TP_WARMUP} + {FSDP_STEPS} steps: losses "
          f"{a['losses']} against one process {a['ref_losses']}; gaps: loss "
          f"{gap['loss']:.3e} (tol {DP_LOSS_TOL}), step 1 gradient "
          f"{gap['grad']:.3e} (tol {DP_GRAD_TOL}), parameters "
          f"{gap['param']:.3e} of the update (tol {DP_PARAM_TOL}); norms "
          f"bit-equal across the ranks {a['norms_equal']}; launches per "
          f"step = the count from the code {a['launches_per_step'] == want}")
    print(f"[fsdp] {card}: (a) planted faults, one step each: "
          + "; ".join(f"{k}: loss {f['loss']:.3e}, gradient "
                      f"{f['grad']:.3e}, parameters {f['param']:.3e}"
                      for k, f in a["faults"].items()))
    print(f"[fsdp] {card}: (a) bytes a rank: parameters "
          f"{by['local'][0] / 1e9:.4f} GB (the code's {want_params / 1e9:.4f})"
          f" against {by['whole'][0] / 1e9:.4f} GB whole, optimizer state "
          f"{by['local'][1] / 1e9:.4f} against {by['whole'][1] / 1e9:.4f} GB; "
          f"f32 parameters, gradients and moments {state_rank:.2f} GB a rank "
          f"against {4 * whole_params / 1e9:.2f} GB; peak memory per rank "
          f"{peak[0][0]:.2f} and {peak[1][0]:.2f} GB against one process's "
          f"{peak[0][1]:.2f} GB and phase 21's mp rank's {tp_peak[0][0]:.2f} "
          f"GB; step {a['step_ms']:.1f} ms against one process's "
          f"{a['ref_step_ms']:.1f} ms (both ranks' references share the "
          f"card); gloo bytes a step by group size {gb} GB; worker "
          f"{a['seconds']:.1f} s, stages (s from its start) "
          f"{ {k: round(v, 1) for k, v in a['stages'].items()} }")
    print(f"[fsdp] {card}: (b) offload_opt_state, phase 9's configuration, "
          f"1 + {OFFLOAD_STEPS} steps: losses bit-equal "
          f"{off['losses'] == on['losses']}, parameters bit-equal "
          f"{params_equal}; device peak {off['peak'] / 1e9:.2f} GB without, "
          f"{on['peak'] / 1e9:.2f} GB with (a drop of {drop / 1e9:.2f} GB; "
          f"the moments are {moments / 1e9:.2f} GB); step "
          f"{off['step_ms']:.1f} ms without, {on['step_ms']:.1f} ms with "
          f"(a memory feature: no speed is claimed); phase 22 "
          f"{out['seconds']:.1f} s ((a) {a_s:.1f} s, (b) {b_s:.1f} s)")
    if problems:
        raise AssertionError("fsdp: " + "; ".join(problems))
    return out


# -- phase 23: the ring paths: FSDP overlap and context parallelism ----------

OVL_STEPS = 3               # (a): steps after the warm-up, each way
OVL_CHUNKS = 2              # (a): overlap_chunks
OVL_PHASE_LAYERS = 2        # (a): measure_phase_seconds' model, 2 of 22 layers
CP_SEQ = 4096               # (b): one row of 4096 ids, 2048 a rank
CP_PAD = 3072               # (b): labels -100 from this column
CP_STEPS = 2                # (b): steps after the warm-up, each mode
CP_LAYERS = 4               # (b): the model's depth, of 22 (the phase's time)
RING_BLOCKS = (1, 16384, 32, 8, 128)   # (c): b, S, hq, hk, d (Llama-3-8B)
RING_N = 4                  # (c): sequence shards
RING_WORKER_TIMEOUT_S = 600


def _drop():
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def _ring_trainer(dev, cfg, mesh, **step_kw):
    """Phase 9's optimizer and compute type over a seed-0 model cut by
    `llama_sharding_plan` on `mesh` (None: mesh-free)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    return Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16",
                                               **step_kw),
                   mesh=mesh, plan=None if mesh is None
                   else llama_sharding_plan(mesh.dim_names))


@contextlib.contextmanager
def _planted_ring(fault):
    """One planted fault of the ring paths for the block: `own_twice`
    (the contract ring multiplies its own piece at every step, never the
    piece that arrived), `unweighted_merge` (the flash ring sums its
    blocks' outputs without their lse weights), `future_shard` (the
    flash ring attends to the shards after its own)."""
    from paddle_tpu_torch.distributed import context_parallel as cp
    from paddle_tpu_torch.parallel import overlap as ov
    if fault == "own_twice":
        target, attr = ov, "_ring_linear"
        orig = ov._ring_linear

        def new(x, piece, group, chunks, dim, t=False):
            if dim != 1 or t:
                return orig(x, piece, group, chunks, dim, t)
            n, idx, size = group.nranks, group.rank, piece.shape[1]
            acc = torch.zeros(x.shape[:-1] + (piece.shape[0],),
                              dtype=torch.float32, device=x.device)
            for j in range(n):
                lo = ((idx - j) % n) * size
                acc.add_(torch.matmul(x[..., lo:lo + size],
                                      piece.t()).float())
            return acc.to(torch.result_type(x, piece))
    elif fault == "unweighted_merge":
        target, attr = cp, "_merge_partial"

        def new(acc, lse, o_j, lse_j):
            return acc + o_j.float(), torch.logaddexp(lse, lse_j)
    elif fault == "future_shard":
        target, attr = cp, "_mode"
        orig = cp._mode

        def new(causal, src, idx):
            return 0 if src > idx else orig(causal, src, idx)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    saved = getattr(target, attr)
    setattr(target, attr, new)
    try:
        yield
    finally:
        setattr(target, attr, saved)


def _stage_note(rank, what, stage):
    """Rank 0's progress line: the stages' seconds so far."""
    if rank == 0:
        print(f"[ring] {what} done: "
              f"{ {k: round(v, 1) for k, v in stage.items()} }", flush=True)


def _launches_reset():
    from paddle_tpu_torch.kernels import launch_counters
    for d in launch_counters():
        for k in d:
            d[k] = 0


def _launches():
    from paddle_tpu_torch.kernels import launch_counters
    return {k: v for d in launch_counters() for k, v in d.items()}


def _p2p_bit_exact(rank, dev, axis):
    """Whether `collective.ppermute` (each rank of the mesh's 2-rank
    `axis` group to the other) and `send` / `recv` carry seeded random
    bits, bf16 and f32, 1 MB and 128 MB, bit for bit (the port stages a
    gloo group's CUDA tensors through pinned host memory)."""
    from paddle_tpu_torch.distributed import collective

    def bits(nbytes, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(-2 ** 15, 2 ** 15, (nbytes // 2,),
                             dtype=torch.int16, device=dev,
                             generator=g).view(dtype)

    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        for nbytes in (1 << 20, 128 << 20):
            got = collective.ppermute(bits(nbytes, dtype, rank), axis,
                                      [(0, 1), (1, 0)])
            ok &= got.is_cuda and torch.equal(
                got.view(torch.int16),
                bits(nbytes, dtype, 1 - rank).view(torch.int16))
            if rank == 0:
                collective.send(bits(nbytes, dtype, 7), dst=1)
            else:
                got = collective.recv(src=0)
                ok &= got.is_cuda and torch.equal(
                    got.view(torch.int16),
                    bits(nbytes, dtype, 7).view(torch.int16))
    flags = collective.all_gather(torch.tensor([float(ok)], device=dev))
    return all(bool(f[0]) for f in flags)


def overlap_worker(outdir, device="cuda"):
    """Phase 23 (a)'s worker: one of two fsdp ranks on the one card, gloo
    (started by the port's launcher, `--nnodes 2 --rank r`)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.launch.ring_smoke import (
        ring_counts_per_step)
    from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
    from paddle_tpu_torch.distributed.sharding import cuts_of
    from paddle_tpu_torch.parallel import overlap as ov
    dist.init_parallel_env(device=device, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = env.world_device()
    mesh = init_mesh({"fsdp": world})
    set_mesh(mesh)
    cfg = _tp_config()
    batches = _tp_batches(cfg.vocab_size)[:1 + OVL_STEPS]
    t_phase = time.perf_counter()
    stage = {}
    p2p = _p2p_bit_exact(rank, dev, "fsdp")

    # the reference: the same FSDP run with the overlap off
    tr = _ring_trainer(dev, cfg, mesh, overlap_fsdp=False)
    shards = {n: cuts_of(p) for n, p in tr.model.named_parameters()}
    init = {n: _host(p.detach()) for n, p in tr.model.named_parameters()}
    ref = _tp_steps(tr, batches, shards, first=True)
    ref["init"] = init
    del tr
    _drop()
    stage["off"] = time.perf_counter() - t_phase
    _stage_note(rank, "(a) overlap off", stage)

    # the overlap run, its launches and its rings counted
    tr = _ring_trainer(dev, cfg, mesh, overlap_fsdp=True,
                       overlap_chunks=OVL_CHUNKS)
    _launches_reset()
    rings0 = dict(ov.counts)
    run = _tp_steps(tr, batches, shards)
    launches = _launches()
    steps = len(batches)
    rings = {k: (ov.counts[k] - rings0[k]) / steps for k in ov.counts}
    del tr
    _drop()
    stage["on"] = time.perf_counter() - t_phase
    _stage_note(rank, "(a) overlap on", stage)
    gap = _tp_gaps(rank, shards, run, ref, dev)

    # the planted fault, one step against the reference's first
    ref1 = dict(ref, losses=ref["losses"][:1], params=ref["params1"])
    with _planted_ring("own_twice"):
        tr = _ring_trainer(dev, cfg, mesh, overlap_fsdp=True,
                           overlap_chunks=OVL_CHUNKS)
        one = _tp_steps(tr, batches[:1], shards)
    del tr
    _drop()
    fault = _tp_gaps(rank, shards, one, ref1, dev)
    stage["fault"] = time.perf_counter() - t_phase

    # the phase timing's comm columns, at OVL_PHASE_LAYERS layers
    tr = _ring_trainer(dev, _tp_config(num_hidden_layers=OVL_PHASE_LAYERS),
                       mesh, overlap_fsdp=True, overlap_chunks=OVL_CHUNKS)
    phases = tr.measure_phase_seconds(batches[0], iters=1)
    del tr
    _drop()
    stage["phases"] = time.perf_counter() - t_phase
    want = expected_train_launches(cfg, TP_BATCH[0] * TP_BATCH[1] // world)
    if rank == 0:
        _write_json(os.path.join(outdir, "ring_a.json"), dict(
            backend=torch.distributed.get_backend(), world=world,
            p2p_bit_exact=p2p, losses=run["losses"],
            ref_losses=ref["losses"], gap=gap,
            fault=fault, launches=launches,
            launches_per_step={k: launches.get(k, 0) / steps for k in want},
            want_per_step=want, rings_per_step=rings,
            want_rings=ring_counts_per_step(cfg, world, 2, recompute=True),
            step_ms=_median(run["step_s"][TP_WARMUP:]) * 1e3,
            ref_step_ms=_median(ref["step_s"][TP_WARMUP:]) * 1e3,
            phases=phases, stages=stage,
            seconds=time.perf_counter() - t_phase))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _cp_batches(vocab):
    rng = np.random.RandomState(23)
    out = []
    for _ in range(1 + CP_STEPS):
        ids = rng.randint(0, vocab, (1, CP_SEQ)).astype(np.int32)
        labels = ids.copy()
        labels[:, CP_PAD:] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def _cp_want(cfg, mode, rank):
    """Kernel launches per step of sp rank `rank` (of 2): the training
    step's count on its 2048 rows, the ring's flash kernels once a live
    block (rank r attends to r + 1 shards)."""
    want = expected_train_launches(cfg, CP_SEQ // 2)
    if mode == "ring":
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            want[k] *= rank + 1
    return want


def cp_worker(outdir, device="cuda"):
    """Phase 23 (b)'s worker: one of two sp ranks on the one card, gloo
    (started by the port's launcher, `--nnodes 2 --rank r`)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import context_parallel as cp
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
    dist.init_parallel_env(device=device, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = env.world_device()
    mesh = init_mesh({"sp": world})
    set_mesh(mesh)
    cfg = _tp_config(num_hidden_layers=CP_LAYERS)
    batches = _cp_batches(cfg.vocab_size)
    t_phase = time.perf_counter()
    stage = {}

    # the reference: one process over the whole 4096 tokens, mesh-free
    # (each rank runs it); no parameter is cut
    tr = _ring_trainer(dev, cfg, None)
    shards = {n: () for n, _ in tr.model.named_parameters()}
    init = {n: _host(p.detach()) for n, p in tr.model.named_parameters()}
    ref = _tp_steps(tr, batches, shards, first=True)
    ref["init"] = init
    del tr
    _drop()
    stage["reference"] = time.perf_counter() - t_phase
    modes, faults = {}, {}
    for mode in ("ring", "ulysses"):
        tr = _ring_trainer(dev, cfg, mesh, context_parallel=mode)
        _launches_reset()
        cp0 = dict(cp.counts)
        run = _tp_steps(tr, batches, shards)
        launches = _launches()
        steps = len(batches)
        del tr
        _drop()
        want = _cp_want(cfg, mode, rank)
        got = {k: launches.get(k, 0) / steps for k in want}
        mine = torch.tensor([float(got[k] == want[k]) for k in want]
                            + [float(launches.get("flash_fwd", 0))])
        every = dist.all_gather(mine)
        modes[mode] = dict(
            losses=run["losses"], gap=_tp_gaps(rank, shards, run, ref, dev),
            launches=launches, launches_per_step=got, want_per_step=want,
            launches_ok=all(bool(t[:-1].all()) for t in every),
            flash_fwd_by_rank=[float(t[-1]) / steps for t in every],
            counts_per_step={k: (cp.counts[k] - cp0[k]) / steps
                             for k in cp.counts},
            step_ms=_median(run["step_s"][TP_WARMUP:]) * 1e3)
        stage[mode] = time.perf_counter() - t_phase
        _stage_note(rank, f"(b) {mode}", stage)
    ref1 = dict(ref, losses=ref["losses"][:1], params=ref["params1"])
    for fault in ("unweighted_merge", "future_shard"):
        with _planted_ring(fault):
            tr = _ring_trainer(dev, cfg, mesh, context_parallel="ring")
            one = _tp_steps(tr, batches[:1], shards)
        del tr
        _drop()
        faults[fault] = _tp_gaps(rank, shards, one, ref1, dev)
        stage[fault] = time.perf_counter() - t_phase
    if rank == 0:
        _write_json(os.path.join(outdir, "ring_b.json"), dict(
            backend=torch.distributed.get_backend(), world=world,
            ref_losses=ref["losses"], modes=modes, faults=faults,
            ref_step_ms=_median(ref["step_s"][TP_WARMUP:]) * 1e3,
            stages=stage, seconds=time.perf_counter() - t_phase))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _ring_blocks_part(dev):
    """(c): the flash ring's per-block forward, merge and backward over
    RING_N shards of one sequence, in this process (no transport), against
    the whole-sequence flash kernels."""
    from paddle_tpu_torch.distributed import context_parallel as cp
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, s, hq, hk, d = RING_BLOCKS
    n, sl = RING_N, RING_BLOCKS[1] // RING_N
    gen = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v, do = (randn(b, s, hq, d), randn(b, s, hk, d),
                   randn(b, s, hk, d), randn(b, s, hq, d))

    def shard(t, r):
        return t[:, r * sl:(r + 1) * sl]

    def ring_fwd(q, k, v):
        outs = []
        for r in range(n):
            acc = torch.zeros((b, sl, hq, d), dtype=torch.float32,
                              device=dev)
            lse = torch.full((b, hq, sl), float("-inf"), device=dev)
            for j in range(n):
                src = (r - j) % n
                mode = cp._mode(True, src, r)
                if mode != 2:
                    acc, lse = cp._merge_partial(
                        acc, lse, *fa.flash_attention_fwd(
                            shard(q, r), shard(k, src), shard(v, src),
                            mode == 1))
            outs.append((acc.to(torch.bfloat16), lse))
        return outs

    def ring_bwd(q, k, v, outs, do):
        dq = [None] * n
        dk = [torch.zeros((b, sl, hk, d), dtype=torch.float32, device=dev)
              for _ in range(n)]
        dv = [torch.zeros_like(t) for t in dk]
        for r in range(n):
            o_r, lse_r = outs[r]
            do_r = shard(do, r).contiguous()
            acc = torch.zeros((b, sl, hq, d), dtype=torch.float32,
                              device=dev)
            for src in range(n):
                mode = cp._mode(True, src, r)
                if mode == 2:
                    continue
                dq_j, dk_j, dv_j = fa.flash_attention_bwd(
                    shard(q, r), shard(k, src), shard(v, src), o_r, lse_r,
                    do_r, mode == 1)
                acc += dq_j.float()
                dk[src] += dk_j.float()
                dv[src] += dv_j.float()
            dq[r] = acc
        return dq, dk, dv

    o, lse = fa.flash_attention_fwd(q, k, v, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    outs = ring_fwd(q, k, v)
    rdq, rdk, rdv = ring_bwd(q, k, v, outs, do)
    got = {"o": torch.cat([t[0] for t in outs], 1),
           "lse": torch.cat([t[1] for t in outs], 2),
           "dq": torch.cat(rdq, 1).to(torch.bfloat16),
           "dk": torch.cat(rdk, 1).to(torch.bfloat16),
           "dv": torch.cat(rdv, 1).to(torch.bfloat16)}
    want = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    errs = {name: _check_rows(f"ring blocks {name}", got[name], want[name],
                              FLASH_BF16_TOL) for name in want}
    ms = {"whole_fwd": _time_eager_ms(
              lambda: fa.flash_attention_fwd(q, k, v, True), [()], 5),
          "whole_bwd": _time_eager_ms(
              lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True),
              [()], 5),
          "ring_fwd": _time_eager_ms(lambda: ring_fwd(q, k, v), [()], 5),
          "ring_bwd": _time_eager_ms(
              lambda: ring_bwd(q, k, v, outs, do), [()], 5)}
    return dict(shape=list(RING_BLOCKS), shards=n,
                blocks=n * (n + 1) // 2,
                err={k: e[0] for k, e in errs.items()},
                err_over_bound={k: e[1] for k, e in errs.items()}, ms=ms)


def _ring_launch(flag, port, root):
    """The two ranks of one (a) or (b) job: the port's launcher running
    this script as `flag root`, `--nnodes 2 --rank r` on device 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--master", f"127.0.0.1:{port}", "--nnodes", "2", "--rank", str(r),
         "--devices", "0", os.path.abspath(__file__), flag, root],
        env=dict(os.environ, PYTHONPATH=here), cwd=here) for r in range(2)]
    try:
        codes = [p.wait(timeout=RING_WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise AssertionError(f"ring: {flag}'s workers exited {codes}")


def ring_phase(card, dev):
    """Phase 23: (a) the FSDP overlap on two gloo fsdp ranks, (b) the
    ring and Ulysses on two gloo sp ranks, both on the one card through
    the port's launcher; (c) the flash ring's blocks in this process."""
    import shutil
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-ring-")
    _drop()
    try:
        t0 = time.perf_counter()
        _ring_launch("--overlap-worker", _free_port(), root)
        a_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _ring_launch("--cp-worker", _free_port(), root)
        b_s = time.perf_counter() - t0
        with open(os.path.join(root, "ring_a.json")) as f:
            a = json.load(f)
        with open(os.path.join(root, "ring_b.json")) as f:
            b = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _drop()
    t0 = time.perf_counter()
    c = _ring_blocks_part(dev)
    c_s = time.perf_counter() - t0

    problems = []
    for name, part in (("(a)", a), ("(b)", b)):
        if part["backend"] != "gloo" or part["world"] != 2:
            problems.append(f"{name} backend {part['backend']}, world "
                            f"{part['world']}")

    def within(gap):
        return gap["loss"] <= DP_LOSS_TOL and gap["grad"] <= DP_GRAD_TOL \
            and gap["param"] <= DP_PARAM_TOL

    if not a["p2p_bit_exact"]:
        problems.append("(a) point-to-point between the gloo ranks on the "
                        "card is not bit-exact")
    if not within(a["gap"]):
        problems.append(f"(a) overlap on against off: {a['gap']}")
    want = {k: float(v) for k, v in a["want_per_step"].items()}
    if a["launches_per_step"] != want:
        problems.append(f"(a) launches per step {a['launches_per_step']} != "
                        f"the count from the code {want}")
    if a["rings_per_step"] != {k: float(v)
                               for k, v in a["want_rings"].items()}:
        problems.append(f"(a) rings and bytes per step {a['rings_per_step']}"
                        f" != the count from the code {a['want_rings']}")
    if not a["fault"]["grad"] > DP_GRAD_TOL:
        problems.append(f"(a) the planted contract ring that multiplies its "
                        f"own piece twice reads inside the gradient "
                        f"tolerance: {a['fault']}")
    for mode, m in b["modes"].items():
        if not within(m["gap"]):
            problems.append(f"(b) {mode} against one process: {m['gap']}")
        if not m["launches_ok"]:
            problems.append(f"(b) {mode} launches per step "
                            f"{m['launches_per_step']} != the count from the "
                            f"code {m['want_per_step']} (rank 0)")
    for name, f in b["faults"].items():
        if within(f):
            problems.append(f"(b) the planted fault {name} reads inside the "
                            f"tolerances: {f}")
    ph = a["phases"]
    out = dict(card=card, a=a, b=b, c=c, a_s=a_s, b_s=b_s, c_s=c_s,
               launches={"overlap": a["launches"],
                         **{mode: m["launches"]
                            for mode, m in b["modes"].items()}},
               seconds=time.perf_counter() - t_phase)
    gap, rings = a["gap"], a["rings_per_step"]
    print(f"[ring] {card}: (a) 2 fsdp ranks on {a['backend']} on the one "
          f"card, TinyLlama-1.1B at {TP_LAYERS} layers, {TP_BATCH[0]} x "
          f"{TP_BATCH[1]} ids, overlap_fsdp with {OVL_CHUNKS} chunks, "
          f"{TP_WARMUP} + {OVL_STEPS} steps: losses {a['losses']} against "
          f"overlap off {a['ref_losses']}; gaps: loss {gap['loss']:.3e} (tol "
          f"{DP_LOSS_TOL}), step 1 gradient {gap['grad']:.3e} (tol "
          f"{DP_GRAD_TOL}), parameters {gap['param']:.3e} of the update (tol "
          f"{DP_PARAM_TOL}); rings per step {rings} (the code's "
          f"{a['want_rings']}); point-to-point bit-exact "
          f"{a['p2p_bit_exact']}; launches per step = the count from the code "
          f"{a['launches_per_step'] == want}; step {a['step_ms']:.1f} ms on, "
          f"{a['ref_step_ms']:.1f} ms off (gloo through the host: no rate)")
    print(f"[ring] {card}: (a) planted contract ring that multiplies its own "
          f"piece twice: loss {a['fault']['loss']:.3e}, gradient "
          f"{a['fault']['grad']:.3e}, parameters {a['fault']['param']:.3e}; "
          f"measure_phase_seconds at {OVL_PHASE_LAYERS} layers: fwd "
          f"{ph['fwd']:.3f} s, bwd {ph['bwd']:.3f} s, fwd_comm "
          f"{ph['fwd_comm']:.3f} s, bwd_comm {ph['bwd_comm']:.3f} s, "
          f"overlap_fraction {ph['overlap_fraction']} (gloo through the "
          f"host, staged through pinned buffers: not a rate); worker "
          f"{a['seconds']:.1f} s, stages "
          f"{ {k: round(v, 1) for k, v in a['stages'].items()} }")
    for mode, m in b["modes"].items():
        print(f"[ring] {card}: (b) {mode}, 2 sp ranks on {b['backend']}, "
              f"the same model at {CP_LAYERS} layers, 1 x {CP_SEQ} ids "
              f"(2048 a rank), -100 from column {CP_PAD}, {TP_WARMUP} + "
              f"{CP_STEPS} steps: losses {m['losses']} against one process "
              f"{b['ref_losses']}; gaps "
              f"{ {k: float(f'{v:.3e}') for k, v in m['gap'].items()} }; "
              f"launches per step = the code's {m['launches_ok']}, flash "
              f"forwards a step by rank {m['flash_fwd_by_rank']}; transport "
              f"a step {m['counts_per_step']}; step {m['step_ms']:.1f} ms "
              f"against one process's {b['ref_step_ms']:.1f} ms")
    print(f"[ring] {card}: (b) planted faults, one step each: "
          + "; ".join(f"{k}: loss {f['loss']:.3e}, gradient {f['grad']:.3e}, "
                      f"parameters {f['param']:.3e}"
                      for k, f in b["faults"].items())
          + f"; worker {b['seconds']:.1f} s, stages "
          f"{ {k: round(v, 1) for k, v in b['stages'].items()} }")
    print(f"[ring] {card}: (c) the flash ring's {c['blocks']} live blocks "
          f"over {c['shards']} shards of {RING_BLOCKS} bf16, causal, in this "
          f"process: max |err| {c['err']}, |err| / bound "
          f"{ {k: round(v, 3) for k, v in c['err_over_bound'].items()} } "
          f"(the flash row rule, 2^-5) against the whole-sequence kernels; "
          f"ms {c['ms']}; phase 23 {out['seconds']:.1f} s ((a) {a_s:.1f} s, "
          f"(b) {b_s:.1f} s, (c) {c_s:.1f} s)")
    if problems:
        raise AssertionError("ring: " + "; ".join(problems))
    return out


# -- phase 24: pipeline parallelism on two gloo stage ranks ------------------

PP_BATCH = (4, 2048)        # (a): the global batch, four microbatches of a row
PP_PAD = (1, 1024)          # (a), (b): row 0 labelled -100 from column 1024
PP_M = 4                    # (a): microbatches
PP_STEPS = 2                # (a), (b): steps after the warm-up
PP_B_LAYERS = 8             # (b), (c): the model's depth, of 22
PP_B_BATCH = (8, 2048)      # (b), (c): eight microbatches of a row
PP_B_M = 8


def _pp_batches(vocab, shape, steps):
    rng = np.random.RandomState(24)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, shape).astype(np.int32)
        labels = ids.copy()
        labels[:PP_PAD[0], PP_PAD[1]:] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def expected_pp_launches(cfg, layers, microbatches, last):
    """Kernel launches per step of a stage holding `layers` of `cfg`'s
    layers over `microbatches` microbatches: each microbatch the
    training step's count for those layers (`expected_train_launches`),
    the final norm on the last stage only (the dense tail: no CE
    kernel)."""
    import dataclasses
    want = expected_train_launches(
        dataclasses.replace(cfg, num_hidden_layers=layers, loss_chunk=0),
        PP_BATCH[1])
    if not last and cfg.fused_norm:
        want["rms_norm_residual"] -= 1
        want["rms_norm_residual_bwd"] -= 1
    return {k: v * microbatches for k, v in want.items()}


@contextlib.contextmanager
def _planted_pp():
    """The planted fault of (c): each backward takes the newest saved
    microbatch of its rank, not its own."""
    from paddle_tpu_torch.parallel import pipeline as pl
    saved = pl._take_saved
    pl._take_saved = lambda held, key: held.pop(list(held)[-1])
    try:
        yield
    finally:
        pl._take_saved = saved


def _pp_steps(tr, batches, names):
    """One run's losses, step seconds, and step 1's gradients, the
    parameters before and after the steps of `names` (None: every
    parameter) on the host."""
    def keep(n):
        return names is None or n in names
    model = tr.model
    init = {n: _host(p.detach()) for n, p in model.named_parameters()
            if keep(n)}
    losses, step_s, grad1 = [], [], None
    for b in batches:
        t0 = time.perf_counter()
        losses.append(float(tr.step(b)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if grad1 is None:
            grad1 = {n: _host(p.grad.detach())
                     for n, p in model.named_parameters() if keep(n)}
    return dict(losses=losses, step_s=step_s, grad1=grad1, init=init,
                params={n: _host(p.detach())
                        for n, p in model.named_parameters() if keep(n)})


def _pp_reference(dev, cfg, batches, names=None):
    """Each rank's one-process mesh-free run, one rank at a time (two
    whole models would share the card): phase 9's optimizer and bf16
    compute, `names`' tensors kept."""
    import paddle_tpu_torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            tr = _ring_trainer(dev, cfg, None)
            torch.cuda.reset_peak_memory_stats()
            out = _pp_steps(tr, batches, names)
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del tr
            _drop()
        dist.barrier()
    return out


def _pp_run(dev, cfg, batches, mesh, fault=False, **pp_kw):
    """One PipelineTrainer run of phase 9's optimizer and bf16 compute:
    `_pp_steps`' record, this rank's launches, hops and bytes per step,
    peak microbatches held, layers and peak memory (from after the
    stage cut)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel import pipeline as pl
    from paddle_tpu_torch.parallel.plan import llama_sharding_plan
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    tr = pl.PipelineTrainer(model, opt, mesh,
                            llama_sharding_plan(mesh.dim_names),
                            pl.PipelineConfig(compute_dtype="bfloat16",
                                              **pp_kw))
    del model, opt
    _drop()
    torch.cuda.reset_peak_memory_stats()
    _launches_reset()
    hops0, peak = dict(pl.counts), 0
    with _planted_pp() if fault else contextlib.nullcontext():
        run = _pp_steps(tr, batches, None)
    steps = len(batches)
    run.update(
        launches=_launches(), in_flight=tr.last_schedule["in_flight"],
        hops={k: (pl.counts[k] - hops0[k]) / steps for k in pl.counts},
        layers=sum(len(c) for c in tr._layer_ids),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        stage=tr._s)
    del tr
    _drop()
    return run


def _pp_gaps(run, ref, dev):
    """The gaps of a pipeline run against the one-process run, each over
    the whole model (this rank's stage summed over the ranks, in f64 on
    `dev`): the losses, step 1's gradient over its norm, the parameters
    after the last step over the update's norm."""
    from paddle_tpu_torch.distributed import collective
    acc = torch.zeros(4, dtype=torch.float64, device=dev)
    for n in run["params"]:
        g, gr = run["grad1"][n].to(dev).double(), ref["grad1"][n].to(dev)
        p, pr = run["params"][n].to(dev).double(), ref["params"][n].to(dev)
        acc[0] += (g - gr.double()).pow(2).sum()
        acc[1] += gr.double().pow(2).sum()
        acc[2] += (p - pr.double()).pow(2).sum()
        acc[3] += (pr.double() - ref["init"][n].to(dev).double()).pow(2).sum()
    acc = acc.cpu()
    collective.all_reduce(acc)
    return {"loss": max(abs(a - b) / abs(b) for a, b in
                        zip(run["losses"], ref["losses"])),
            "grad": float(acc[0] / acc[1]) ** 0.5,
            "param": float(acc[2] / acc[3]) ** 0.5}


def _pp_summary(run, gap, want=None):
    out = {k: run[k] for k in ("losses", "in_flight", "hops", "layers",
                                "peak_gb", "stage")}
    steps = len(run["losses"])
    out.update(gap=gap, step_ms=_median(run["step_s"][1:]) * 1e3,
               launches=run["launches"],
               launches_per_step={k: run["launches"].get(k, 0) / steps
                                  for k in (want or {})},
               want_per_step=want)
    return out


def pp_worker(outdir, device="cuda"):
    """Phase 24's worker: one of two stage ranks on the one card, gloo
    (started by the port's launcher, `--nnodes 2 --rank r`)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.mesh import init_mesh
    from paddle_tpu_torch.parallel import pipeline as pl
    dist.init_parallel_env(device=device, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = env.world_device()
    mesh = init_mesh({"pp": world})
    t_phase = time.perf_counter()
    stage, out = {}, {"rank": rank, "world": world,
                      "backend": torch.distributed.get_backend()}

    # (a) 22 layers, 11 a stage, 1F1B, four microbatches of one row
    cfg = _tinyllama_config()
    batches = _pp_batches(cfg.vocab_size, PP_BATCH, 1 + PP_STEPS)
    run = _pp_run(dev, cfg, batches, mesh, num_microbatches=PP_M)
    ref = _pp_reference(dev, cfg, batches, set(run["params"]))
    want = expected_pp_launches(cfg, run["layers"], PP_M, rank == world - 1)
    out["a"] = _pp_summary(run, _pp_gaps(run, ref, dev), want)
    out["a"].update(ref_losses=ref["losses"], ref_peak_gb=ref["peak_gb"],
                    ref_step_ms=_median(ref["step_s"][1:]) * 1e3,
                    want_hops=pl.hops_per_step(world, rank, PP_M),
                    hop_bytes=PP_BATCH[1] * cfg.hidden_size * 2)
    del run, ref
    stage["a"] = time.perf_counter() - t_phase

    # (b) 8 layers: GPipe, 1F1B, VPP, custom boundaries; (c) the fault
    cfg = _tinyllama_config(num_hidden_layers=PP_B_LAYERS)
    batches = _pp_batches(cfg.vocab_size, PP_B_BATCH, 1 + PP_STEPS)
    ref = _pp_reference(dev, cfg, batches)
    out["b_ref"] = dict(losses=ref["losses"], peak_gb=ref["peak_gb"],
                        step_ms=_median(ref["step_s"][1:]) * 1e3)
    variants = {"gpipe": dict(schedule="gpipe"), "1f1b": {},
                "vpp": dict(interleave=2),
                "bounds": dict(stage_boundaries=(0, 3, PP_B_LAYERS))}
    out["b"] = {}
    for name, kw in variants.items():
        run = _pp_run(dev, cfg, batches, mesh, num_microbatches=PP_B_M,
                      **kw)
        want = expected_pp_launches(cfg, run["layers"], PP_B_M,
                                    rank == world - 1)
        out["b"][name] = _pp_summary(run, _pp_gaps(run, ref, dev), want)
        del run
        stage[name] = time.perf_counter() - t_phase
    ref1 = dict(ref, losses=ref["losses"][:1])
    run = _pp_run(dev, cfg, batches[:1], mesh, fault=True,
                  num_microbatches=PP_B_M)
    out["c"] = _pp_gaps(run, dict(ref1, params=run["params"],
                                  init=run["init"]), dev)
    del run, ref
    stage["fault"] = time.perf_counter() - t_phase
    out.update(stages=stage, seconds=time.perf_counter() - t_phase)
    _write_json(os.path.join(outdir, f"pp_rank{rank}.json"), out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def pipeline_phase(card):
    """Phase 24: the pipeline on two gloo stage ranks of the one card,
    started through the port's launcher."""
    import shutil
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-pp-")
    _drop()
    try:
        _ring_launch("--pp-worker", _free_port(), root)
        ranks = []
        for r in range(2):
            with open(os.path.join(root, f"pp_rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return _pp_report(card, ranks, t_phase)


def _pp_report(card, ranks, t_phase):
    """Phase 24's gates and readings over the two workers' records."""
    problems = []

    def within(gap):
        return gap["loss"] <= DP_LOSS_TOL and gap["grad"] <= DP_GRAD_TOL \
            and gap["param"] <= DP_PARAM_TOL

    for w in ranks:
        r = w["rank"]
        if w["backend"] != "gloo" or w["world"] != 2:
            problems.append(f"rank {r}: backend {w['backend']}, world "
                            f"{w['world']}")
        a = w["a"]
        if not within(a["gap"]):
            problems.append(f"(a) against one process: {a['gap']}")
        want = {k: float(v) for k, v in a["want_per_step"].items()}
        if a["launches_per_step"] != want:
            problems.append(f"(a) rank {r} launches per step "
                            f"{a['launches_per_step']} != the count from "
                            f"the code {want}")
        if a["hops"] != {"hops": float(a["want_hops"]),
                         "bytes": float(a["want_hops"] * a["hop_bytes"])}:
            problems.append(f"(a) rank {r} hops and bytes per step "
                            f"{a['hops']} != the code's {a['want_hops']} "
                            f"x {a['hop_bytes']}")
        for name, b in w["b"].items():
            if not within(b["gap"]):
                problems.append(f"(b) {name} against one process: "
                                f"{b['gap']}")
        if w["c"]["grad"] <= DP_GRAD_TOL:
            problems.append(f"(c) the planted pairing of a gradient with "
                            f"the newest microbatch reads inside the "
                            f"gradient tolerance: {w['c']}")
    s0 = next(w for w in ranks if w["b"]["1f1b"]["stage"] == 0)["b"]
    if not s0["1f1b"]["peak_gb"] < s0["gpipe"]["peak_gb"]:
        problems.append(f"(b) stage 0's 1F1B peak {s0['1f1b']['peak_gb']} GB "
                        f"is not below its GPipe peak "
                        f"{s0['gpipe']['peak_gb']} GB")
    launches = {}
    for w in ranks:
        for k, v in w["a"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out = dict(card=card, ranks=ranks, launches=launches,
               seconds=time.perf_counter() - t_phase)
    for w in ranks:
        a = w["a"]
        print(f"[pp] {card}: (a) rank {w['rank']} (stage {a['stage']}, "
              f"{a['layers']} layers), TinyLlama-1.1B at 22 layers, "
              f"{PP_BATCH[0]} x {PP_BATCH[1]} ids in {PP_M} microbatches, "
              f"1F1B, {1 + PP_STEPS} steps: losses {a['losses']} against "
              f"one process {a['ref_losses']}; gaps: loss "
              f"{a['gap']['loss']:.3e} (tol {DP_LOSS_TOL}), step 1 gradient "
              f"{a['gap']['grad']:.3e} (tol {DP_GRAD_TOL}), parameters "
              f"{a['gap']['param']:.3e} of the update (tol {DP_PARAM_TOL}); "
              f"launches per step = the code's "
              f"{a['launches_per_step'] == a['want_per_step']} "
              f"{a['launches_per_step']}; hops a step {a['hops']} (the "
              f"code's {a['want_hops']} of {a['hop_bytes']} bytes); "
              f"microbatches held {a['in_flight']}; peak memory "
              f"{a['peak_gb']:.2f} GB against one process's "
              f"{a['ref_peak_gb']:.2f}; step {a['step_ms']:.1f} ms against "
              f"one process's {a['ref_step_ms']:.1f} (gloo through the "
              f"host, both stages on one card: no rate, no real bubble)")
    for w in ranks:
        print(f"[pp] {card}: (b) rank {w['rank']}, {PP_B_LAYERS} layers, "
              f"{PP_B_BATCH[0]} x {PP_B_BATCH[1]} ids in {PP_B_M} "
              f"microbatches (one process: losses "
              f"{w['b_ref']['losses']}, peak {w['b_ref']['peak_gb']:.2f} "
              f"GB, step {w['b_ref']['step_ms']:.1f} ms): " + "; ".join(
                  f"{k}: stage {b['stage']} of {b['layers']} layers, gaps "
                  f"{ {g: float(f'{v:.3e}') for g, v in b['gap'].items()} }"
                  f", held {b['in_flight']}, peak {b['peak_gb']:.2f} GB, "
                  f"hops {b['hops']['hops']:.0f}, step {b['step_ms']:.1f} "
                  f"ms, launches per step = the code's "
                  f"{b['launches_per_step'] == b['want_per_step']}"
                  for k, b in w["b"].items()))
    print(f"[pp] {card}: (c) planted pairing of each gradient with the "
          f"newest saved microbatch, one step: "
          f"{ {g: float(f'{v:.3e}') for g, v in ranks[0]['c'].items()} }; "
          f"phase 24 {out['seconds']:.1f} s (worker stages "
          f"{ {k: round(v, 1) for k, v in ranks[0]['stages'].items()} })")
    if problems:
        raise AssertionError("pp: " + "; ".join(problems))
    return out


# -- phase 8: training parity, card against CPU -----------------------------

# bf16-compute parity: the loss within this fraction of itself, and each
# gradient within this fraction of its own norm (||card - cpu|| <=
# tol * ||cpu||): the card's cuBLAS and the CPU round the same bf16
# products after sums in other orders, and each flip of a rounding
# travels through the layers
TRAIN_BF16_LOSS_TOL = 1e-3
TRAIN_BF16_GRAD_TOL = 4e-2


def _parity_step(cfg, state, ids, dev, compute_dtype, opt_kw=dict,
                 **step_kw):
    """(loss, {name: gradient on the CPU}) of one Trainer step from
    `state`, on the CPU through the twins and on the card through the
    kernels. `opt_kw()` gives extra AdamW arguments (a fresh schedule per
    device), `step_kw` extra TrainStepConfig fields."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    results = []
    for device in ("cpu", dev):
        model = LlamaForCausalLM(cfg, device=device)
        model.load_state_dict(state)
        kw = {"learning_rate": 1e-4, **opt_kw()}
        trainer = Trainer(model, topt.AdamW(
            parameters=model.named_parameters(), **kw),
            TrainStepConfig(compute_dtype=compute_dtype, **step_kw))
        loss = float(trainer.step({"input_ids": ids, "labels": ids}))
        if step_kw.get("skip_nonfinite_grads") and trainer.nonfinite_skipped:
            raise AssertionError(f"train parity: a finite step on {device} "
                                 "was skipped")
        results.append((loss, {n: p.grad.cpu() for n, p in
                               model.named_parameters()}))
        del trainer, model
    torch.cuda.empty_cache()
    return results


def training_parity_phase(dev):
    """One Trainer step of a 2-layer model at TinyLlama's full width: the
    card through the kernels against the CPU through the twins, with the
    same state and batch, first in f32 and then with bf16 compute (the
    twins round p and dS to bf16 where the kernels do, so this holds the
    bf16 kernels against an independent path).

    f32: the loss within 1e-5 relative; every gradient within 1e-4 of its
    largest entry (the same f32 products summed in other orders). bf16:
    TRAIN_BF16_LOSS_TOL and TRAIN_BF16_GRAD_TOL. The updated parameters
    are not compared: Adam divides each gradient entry by its own
    magnitude, so an entry within the noise of zero can step by the
    learning rate either way."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _tinyllama_config(num_hidden_layers=2)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 256)) \
        .astype(np.int32)
    state = LlamaForCausalLM(cfg, device="cpu", seed=0).state_dict()
    out = {}
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = _parity_step(cfg, state, ids, dev,
                                                         None)
    if abs(gpu_loss - cpu_loss) > 1e-5 * abs(cpu_loss):
        raise AssertionError(f"train parity: loss {gpu_loss} on the card, "
                             f"{cpu_loss} on the CPU")
    worst = 0.0
    for name, g in cpu_g.items():
        rel = float((gpu_g[name] - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        if rel > 1e-4:
            raise AssertionError(f"train parity: {name} gradient differs by "
                                 f"{rel:.3g} of its largest entry")
        worst = max(worst, rel)
    print(f"[train-parity] 2-layer TinyLlama width f32: loss card "
          f"{gpu_loss:.7f} cpu {cpu_loss:.7f}; worst gradient difference "
          f"{worst:.3g} of its largest entry (tolerance 1e-4)")
    out["f32"] = {"loss_card": gpu_loss, "loss_cpu": cpu_loss,
                  "worst_grad_rel": worst}
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = _parity_step(cfg, state, ids, dev,
                                                         "bfloat16")
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    if loss_rel > TRAIN_BF16_LOSS_TOL:
        raise AssertionError(f"train parity bf16: loss {gpu_loss} on the "
                             f"card, {cpu_loss} on the CPU")
    rels = {name: float((gpu_g[name] - g).norm() / g.norm().clamp_min(1e-30))
            for name, g in cpu_g.items()}
    name = max(rels, key=rels.get)
    if rels[name] > TRAIN_BF16_GRAD_TOL:
        raise AssertionError(f"train parity bf16: {name} gradient differs by "
                             f"{rels[name]:.3g} of its norm")
    print(f"[train-parity] 2-layer TinyLlama width bf16 compute: loss card "
          f"{gpu_loss:.7f} cpu {cpu_loss:.7f} ({loss_rel:.3g} relative, "
          f"tolerance {TRAIN_BF16_LOSS_TOL}); worst gradient difference "
          f"{rels[name]:.3g} of its norm, {name} (tolerance "
          f"{TRAIN_BF16_GRAD_TOL}); median "
          f"{float(np.median(list(rels.values()))):.3g}")
    out["bf16"] = {"loss_card": gpu_loss, "loss_cpu": cpu_loss,
                   "loss_rel": loss_rel, "worst_grad_rel_norm": rels[name],
                   "grad_rel_norm": rels}
    out["blockwise_f32"] = _blockwise_parity(cfg, state, ids, dev)
    return out


def _blockwise_parity(cfg, state, ids, dev):
    """Phase 8's blockwise-loss step: the 2-layer model with loss_chunk
    512, AdamW with ClipGradByGlobalNorm(1.0) and a LinearWarmup
    schedule, skip_nonfinite_grads on; f32, the card's CE kernels against
    the CPU's twin. The loss within 1e-5 relative, every gradient within
    1e-4 of its largest entry (as the f32 step above)."""
    from dataclasses import replace
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.kernels import blockwise_ce as bce
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    def opt_kw():
        return dict(learning_rate=topt.lr.LinearWarmup(
            learning_rate=1e-4, warmup_steps=10, start_lr=1e-5, end_lr=1e-4),
            grad_clip=ClipGradByGlobalNorm(1.0))

    before = dict(bce.launches)
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = _parity_step(
        replace(cfg, loss_chunk=512), state, ids, dev, None, opt_kw,
        skip_nonfinite_grads=True)
    if not all(bce.launches[k] > before[k] for k in before):
        raise AssertionError(f"train parity: the blockwise step did not "
                             f"launch every CE kernel {bce.launches}")
    if abs(gpu_loss - cpu_loss) > 1e-5 * abs(cpu_loss):
        raise AssertionError(f"train parity blockwise: loss {gpu_loss} on "
                             f"the card, {cpu_loss} on the CPU")
    worst = 0.0
    for name, g in cpu_g.items():
        rel = float((gpu_g[name] - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        if rel > 1e-4:
            raise AssertionError(f"train parity blockwise: {name} gradient "
                                 f"differs by {rel:.3g} of its largest entry")
        worst = max(worst, rel)
    print(f"[train-parity] 2-layer TinyLlama width f32, blockwise loss "
          f"(chunk 512), global-norm clip, LinearWarmup, skip_nonfinite: "
          f"loss card {gpu_loss:.7f} cpu {cpu_loss:.7f}; worst gradient "
          f"difference {worst:.3g} of its largest entry (tolerance 1e-4)")
    return {"loss_card": gpu_loss, "loss_cpu": cpu_loss,
            "worst_grad_rel": worst}


# -- phase 10: Llama-3-8B int8 serving ------------------------------------------

INT8_SERVING_KERNELS = ("paged_decode_attention_int8", "weight_only_int8_matmul",
                        "weight_only_int8_matmul_wgmma", "rms_norm_residual",
                        "rope_apply")
# mean |quantized - float| / mean |float| of one projection on a prefill
# activation (the pin of tests/test_quantization_int8.py:63-74)
W8A16_REL_TOL = 0.02


def int8_serving_phase(dev, counters, reset, card, bf16_serving,
                       profile=False):
    """Phase 10: Llama-3-8B (seed 0, bf16) converted by
    `quantize_weight_only` on the card, served through
    PagedKVEngine(kv_dtype="int8") with phase 5's geometry, prompts and
    late joiner."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn import functional as fnl
    from paddle_tpu_torch.quantization import quantize_weight_only
    cfg = llama3_8b_config(fused_norm=True, fused_rope=True)
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    prompts = _prompts(8, cfg.vocab_size, seed=0)
    # layer 0's float projections and a prefill activation of each width,
    # kept for the per-projection check
    layer = model.model.layers[0]
    projs = {n: getattr(layer.self_attn, n) for n in
             ("q_proj", "k_proj", "v_proj", "o_proj")}
    projs.update({n: getattr(layer.mlp, n) for n in
                  ("gate_proj", "up_proj", "down_proj")})
    floats = {n: m.weight.detach().clone() for n, m in projs.items()}
    ids = torch.from_numpy(prompts[0].astype(np.int64)).to(dev)
    x = layer.input_layernorm(model.model.embed_tokens(ids))
    h = fnl.swiglu(x @ floats["gate_proj"].t(), x @ floats["up_proj"].t())
    del projs
    t0 = time.perf_counter()
    quantize_weight_only(model)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    convert_peak = torch.cuda.max_memory_allocated() / 1e9
    layer = model.model.layers[0]
    rel = {}
    for name, w in floats.items():
        mod = getattr(layer.mlp if name in ("gate_proj", "up_proj",
                                            "down_proj") else
                      layer.self_attn, name)
        xin = h if name == "down_proj" else x
        ref = torch.nn.functional.linear(xin.float(), w.float())
        got = mod(xin).float()
        rel[name] = float((got - ref).abs().mean() / ref.abs().mean())
    del floats, x, h
    print(f"[int8] Llama-3-8B converted to W8A16 on the card in {convert_s:.1f}"
          f" s (peak {convert_peak:.2f} GB); layer 0 mean |q - f| / mean |f| "
          f"on a prefill activation: "
          + ", ".join(f"{k} {v:.4f}" for k, v in rel.items()))
    if not max(rel.values()) < W8A16_REL_TOL:
        raise AssertionError(f"int8: a projection is off by more than "
                             f"{W8A16_REL_TOL}: {rel}")
    weight_gb = sum(t.numel() * t.element_size() for t in
                    itertools.chain(model.parameters(), model.buffers())) / 1e9
    geom = dict(max_slots=8, page_size=16, num_pages=641,
                max_pages_per_slot=80, steps_per_tick=4, kv_dtype="int8")
    max_new = 64
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    eng, toks = _serve(model, prompts, max_new, late=7, **geom)
    wall = time.perf_counter() - t0
    all_counts = counters()
    launches = {k: all_counts[k] for k in INT8_SERVING_KERNELS}
    for i, t in enumerate(toks):
        if len(t) != max_new or not all(0 <= v < cfg.vocab_size for v in t):
            raise AssertionError(f"int8 request {i}: {len(t)} tokens, want "
                                 f"{max_new} in-vocab")
    if sorted(eng._free) != list(range(1, eng.num_pages)) \
            or eng._reserved_unalloc != 0:
        raise AssertionError(f"int8: pages not returned: free "
                             f"{len(eng._free)}, reserved "
                             f"{eng._reserved_unalloc}")
    # every page but the sink went back with its scale rows zeroed (page
    # 0 is never written)
    left = float(eng._scales[:, :, :-1].abs().sum())
    if left != 0.0:
        raise AssertionError(f"int8: freed pages kept scales (sum {left})")
    steps = _decode_steps(eng)
    calls = eng.stats["prefill_calls"] + steps
    per_call = 7 * cfg.num_hidden_layers + 1
    if launches["paged_decode_attention_int8"] != cfg.num_hidden_layers * steps:
        raise AssertionError(f"int8 decode launches {launches} != 32 x "
                             f"{steps}")
    if launches["weight_only_int8_matmul"] != per_call * calls:
        raise AssertionError(f"W8A16 launches {launches} != {per_call} x "
                             f"{calls} model calls")
    # the projections of every prefill call above the route's threshold
    # take the wgmma kernel (the lm_head runs at M = the group's size)
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    call_ms = _prefill_call_ms(prompts, 7, PagedKVEngine._bucket)
    big = sum(m > qm._SMALL_M for m in call_ms)
    if eng.stats["prefill_calls"] != len(call_ms):
        raise AssertionError(f"int8: {eng.stats['prefill_calls']} prefill "
                             f"calls, want {len(call_ms)} ({call_ms})")
    if launches["weight_only_int8_matmul_wgmma"] != \
            7 * cfg.num_hidden_layers * big:
        raise AssertionError(f"wgmma W8A16 launches {launches} != 7 x "
                             f"{cfg.num_hidden_layers} x {big} prefill calls "
                             f"of M {call_ms}")
    if all_counts["paged_decode_attention"] != 0:
        raise AssertionError("int8 serving launched the float decode kernel")
    kv_slot = eng.kv_bytes_per_slot()
    kv_ratio = kv_slot / bf16_serving["kv_bytes_per_slot"]
    if not kv_ratio <= 0.51:
        raise AssertionError(f"int8 KV bytes per slot {kv_slot} = "
                             f"{kv_ratio:.4f} x bf16's, want <= 0.51")
    st = dict(eng.stats)
    traced = traced_replays(eng, counters, reset, card, "int8", TRACED_INT8)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    eng2, toks2 = _serve(model, prompts, max_new, late=7, **geom)
    if toks2 != toks:
        raise AssertionError("int8: a second identical run gave other tokens")
    st2 = dict(eng2.stats)
    del eng2
    # top-1 agreement with phase 5's bf16 model (same seed, same prompts):
    # its prefill token and its first decode step's token, per request
    ref = bf16_serving["tokens"]
    agree = {f"token_{j}": sum(a[j] == b[j] for a, b in zip(toks, ref))
             / len(ref) for j in (0, 1)}
    metrics = dict(
        card=card, **_tick_metrics(st),
        prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
        repeat_decode_tokens_per_s=st2["decode_tokens"] / st2["tick_s"],
        repeat_prefill_tokens_per_s=(st2["prefill_tokens"]
                                     / st2["prefill_s"]),
        decode_steps=steps,
        prefill_calls=st["prefill_calls"], kv_bytes_per_slot=kv_slot,
        kv_ratio_to_bf16=kv_ratio, weight_gb=weight_gb, wall_s=wall,
        peak_mem_gb=peak, convert_s=convert_s, convert_peak_gb=convert_peak,
        projection_rel_err=rel, top1_agreement_with_bf16=agree,
        launches=launches, tokens=toks, traced_replays=traced)
    metrics["eager"] = _eager_run(model, prompts, max_new, geom, toks, "int8")
    print(f"[int8] {card}: captured tick: decode "
          f"{metrics['decode_tokens_per_s']:.1f} tok/s, prefill "
          f"{metrics['prefill_tokens_per_s']:.1f} tok/s, tick "
          f"{metrics['tick_ms']:.2f} ms ({geom['steps_per_tick']} steps of 8 "
          f"slots; warm-up ticks {st['warmup_ticks']}, warm-up and capture "
          f"{st['warmup_s']:.2f} s), KV {kv_slot} B/slot ({kv_ratio:.4f} x "
          f"bf16), weights {weight_gb:.2f} GB, peak {peak:.2f} GB, wall "
          f"{wall:.2f} s, launches {launches} ({per_call} W8A16 x {calls} "
          f"model calls); second run identical, decode "
          f"{metrics['repeat_decode_tokens_per_s']:.1f} tok/s, prefill "
          f"{metrics['repeat_prefill_tokens_per_s']:.1f} tok/s; eager tick "
          f"identical, decode "
          f"{metrics['eager']['decode_tokens_per_s']:.1f} tok/s, tick "
          f"{metrics['eager']['tick_ms']:.2f} ms; top-1 agreement with "
          f"phase 5's bf16 tokens {agree}")
    if profile:
        metrics["profile"] = profile_serving(model, prompts, max_new, geom,
                                             card, label="int8 ")
    # phase 12 (c) serves the converted model
    return metrics, model


# -- phase 11: prefix-cached, chunked serving ------------------------------------

SYSTEM_TOKENS = 1024            # the shared system prompt: 64 full pages
# 8 full slots of 4096 tokens plus the cache's budget (+ page 0, the trash)
PREFIX_GEOM = dict(max_slots=8, page_size=16, max_pages_per_slot=256,
                   num_pages=8 * 256 + 512 + 1, steps_per_tick=4,
                   prefix_cache_pages=512, prefill_chunk=512,
                   kv_dtype="bf16")
# the same engine cold: no cache, whole prompts
COLD_GEOM = dict(PREFIX_GEOM, prefix_cache_pages=0, prefill_chunk=None)
PREFIX_MAX_NEW = 32


def _prefix_traffic(vocab, seed=11):
    """Phase 11's prompts from a numpy seed: wave 1 and wave 2, eight
    each, the shared system prompt plus a distinct 32-256-token tail, and
    two long prompts of 3000-4000 tokens."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, SYSTEM_TOKENS)

    def wave():
        return [np.concatenate([system, rng.integers(
            0, vocab, int(rng.integers(32, 257)))]).astype(np.int32)
            for _ in range(8)]
    wave1, wave2 = wave(), wave()
    long = [rng.integers(0, vocab, int(rng.integers(3000, 4001)))
            .astype(np.int32) for _ in range(2)]
    return wave1, wave2, long


def _serve_prefix(model, traffic, eager=False, **geom):
    """Wave 1's eight requests admit together (all miss, one copy of the
    system prompt's pages is cached) and drain. Then seven of wave 2
    admit warm, one tick runs, and the eighth joins mid-decode. The two
    long prompts wait behind a full engine and prefill together, in
    lockstep rounds, when the first seven retire, while the eighth still
    decodes. Returns (engine, tokens, stats at each mark)."""
    eng = _engine(model, eager, **geom)
    wave1, wave2, long = traffic
    marks = {}
    reqs = [eng.submit(p, PREFIX_MAX_NEW) for p in wave1]
    eng.run_until_idle()
    marks["wave1"] = dict(eng.stats)
    w2 = [eng.submit(p, PREFIX_MAX_NEW) for p in wave2[:7]]
    eng.step()
    w2.append(eng.submit(wave2[7], PREFIX_MAX_NEW))
    rl = [eng.submit(p, PREFIX_MAX_NEW) for p in long]
    eng.step()
    marks["wave2_admitted"] = dict(eng.stats)
    if any(r.tokens for r in rl):
        raise AssertionError("prefix: a long prompt admitted before wave "
                             "2's first seven retired")
    while not all(r.done.is_set() for r in w2[:7]):
        eng.step()
    marks["wave2_decoded"] = dict(eng.stats)
    if w2[7].done.is_set():
        raise AssertionError("prefix: wave 2's last request ended before "
                             "the long prompts joined")
    eng.run_until_idle()
    return eng, [r.result() for r in reqs + w2 + rl], marks


def _prefix_calls(traffic, chunk, bucket):
    """Prefill calls the traffic needs: wave 1's prompts (longer than
    the chunk) in lockstep rounds, wave 2's first seven tails one call
    per tail bucket and the eighth's alone, the long prompts in
    rounds."""
    wave1, wave2, long = traffic
    tails = [p.size - SYSTEM_TOKENS for p in wave2]
    rounds = lambda ps: -(-max(p.size for p in ps) // chunk)  # noqa: E731
    return (rounds(wave1) + len({bucket(t) for t in tails[:7]}) + 1
            + rounds(long))


def _settled_ledger(eng, tag):
    """After the engine is idle only the cache holds pages: each cached
    page has refcount 1, and free plus cached pages is the whole pool."""
    cached = eng.prefix_cache.pages()
    refs = eng._page_refs
    if set(refs) != set(cached) or any(refs[p] != 1 for p in cached) \
            or len(eng._free) + len(cached) != eng.num_pages - 1 \
            or eng._reserved_unalloc != 0 \
            or eng._reclaimable != len(cached):
        raise AssertionError(
            f"{tag}: ledger not settled: {len(refs)} pages with refs, "
            f"{len(cached)} cached, {len(eng._free)} free, reserved "
            f"{eng._reserved_unalloc}, reclaimable {eng._reclaimable}")


def _seg_rate(a, b, num, den):
    return (b[num] - a[num]) / (b[den] - a[den])


def prefix_serving_phase(dev, model, counters, reset, card, profile=False):
    """Phase 11 on phase 5's Llama-3-8B (seed 0, bf16, fused norm and
    RoPE): the prefix cache, chunked prefill, deadlines and bounded
    admission (module doc)."""
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    cfg = model.config
    layers = cfg.num_hidden_layers
    traffic = _prefix_traffic(cfg.vocab_size)
    wave1, wave2, long = traffic
    reset()
    t0 = time.perf_counter()
    eng, toks, marks = _serve_prefix(model, traffic, **PREFIX_GEOM)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in counters().items() if k in SERVING_KERNELS}
    st = dict(eng.stats)
    for i, t in enumerate(toks):
        if len(t) != PREFIX_MAX_NEW or not all(0 <= x < cfg.vocab_size
                                               for x in t):
            raise AssertionError(f"prefix: request {i}: {len(t)} tokens, "
                                 f"want {PREFIX_MAX_NEW} in-vocab")
    cold_tokens = sum(p.size for p in wave1 + long)
    tails = sum(p.size - SYSTEM_TOKENS for p in wave2)
    pages = SYSTEM_TOKENS // eng.page_size
    want = dict(prefix_hits=8, prefix_hit_tokens=8 * SYSTEM_TOKENS,
                prefix_pages_shared=8 * pages, prefix_misses=10,
                prefill_tokens=cold_tokens + tails,
                prefill_calls=_prefix_calls(traffic, eng.prefill_chunk,
                                            PagedKVEngine._bucket),
                prefills=18, finished=18)
    got = {k: st[k] for k in want}
    if got != want:
        raise AssertionError(f"prefix: stats {got}, want {want}")
    _settled_ledger(eng, "prefix")
    steps = _decode_steps(eng)
    calls = st["prefill_calls"] + steps
    want_l = {"paged_decode_attention": layers * steps,
              "rms_norm_residual": (2 * layers + 1) * calls,
              "rope_apply": 2 * layers * calls}
    if launches != want_l:
        raise AssertionError(f"prefix: launches {launches}, want {want_l} "
                             f"({steps} decode steps, "
                             f"{st['prefill_calls']} prefill calls)")
    stats_block = eng.prefix_stats()
    del eng
    _release()
    eng2, toks2, marks2 = _serve_prefix(model, traffic, **PREFIX_GEOM)
    if toks2 != toks:
        raise AssertionError("prefix: a second identical run gave other "
                             "tokens")
    st2 = dict(eng2.stats)
    del eng2
    _release()
    eng3, toks3, _ = _serve_prefix(model, traffic, eager=True,
                                   **PREFIX_GEOM)
    if toks3 != toks:
        bad = [i for i, (a, b) in enumerate(zip(toks3, toks)) if a != b]
        raise AssertionError(f"prefix: the eager tick gave other tokens "
                             f"than the captured tick (requests {bad})")
    if eng3.stats["warmup_ticks"] or eng3._programs:
        raise AssertionError("prefix: the eager engine captured a graph")
    eager = _tick_metrics(eng3.stats)
    del eng3
    _release()
    # wave 2 cold (no cache, whole prompts), with the same late joiner:
    # top-1 agreement with the warm rows, and the decode rate of the same
    # ticks cold (until the first seven retire)
    cold = _engine(model, **COLD_GEOM)
    creqs = [cold.submit(p, PREFIX_MAX_NEW) for p in wave2[:7]]
    cold.step()
    creqs.append(cold.submit(wave2[7], PREFIX_MAX_NEW))
    while not all(r.done.is_set() for r in creqs[:7]):
        cold.step()
    cst = dict(cold.stats)
    cold.run_until_idle()
    ctoks = [r.result() for r in creqs]
    del cold
    _release()
    warm = toks[8:16]
    agree = dict(
        first_token=sum(a[0] == b[0] for a, b in zip(warm, ctoks)) / 8,
        all_tokens=sum(a == b for a, b in zip(warm, ctoks)) / 8)
    m1, m2a, m2d = marks["wave1"], marks["wave2_admitted"], \
        marks["wave2_decoded"]
    metrics = dict(
        card=card, wall_s=wall, stats=st, prefix_stats=stats_block,
        launches=launches, decode_steps=steps, tokens=toks,
        prompt_lens=dict(wave1=[int(p.size) for p in wave1],
                         wave2=[int(p.size) for p in wave2],
                         long=[int(p.size) for p in long]),
        wave1_prefill_s=m1["prefill_s"],
        wave1_prefill_tokens=m1["prefill_tokens"],
        wave1_prefill_tokens_per_s=m1["prefill_tokens"] / m1["prefill_s"],
        wave2_prefill_s=m2a["prefill_s"] - m1["prefill_s"],
        wave2_prefill_tokens=m2a["prefill_tokens"] - m1["prefill_tokens"],
        wave2_prefill_tokens_per_s=_seg_rate(m1, m2a, "prefill_tokens",
                                             "prefill_s"),
        long_prefill_s=st["prefill_s"] - m2d["prefill_s"],
        wave1_decode_tokens_per_s=m1["decode_tokens"] / m1["tick_s"],
        wave2_decode_tokens_per_s=_seg_rate(m1, m2d, "decode_tokens",
                                            "tick_s"),
        decode_tokens_per_s=st["decode_tokens"] / st["tick_s"],
        repeat_decode_tokens_per_s=st2["decode_tokens"] / st2["tick_s"],
        # the same work again: host-clock walls vary from run to run
        repeat_wave1_prefill_s=marks2["wave1"]["prefill_s"],
        repeat_wave2_prefill_s=(marks2["wave2_admitted"]["prefill_s"]
                                - marks2["wave1"]["prefill_s"]),
        cold_wave2_prefill_s=cst["prefill_s"],
        cold_wave2_prefill_tokens=cst["prefill_tokens"],
        cold_wave2_decode_tokens_per_s=(cst["decode_tokens"]
                                        / cst["tick_s"]),
        warm_top1_agreement_with_cold=agree, eager=eager)
    print(f"[prefix] {card}: Llama-3-8B bf16, 8 + 8 requests on a "
          f"{SYSTEM_TOKENS}-token system prompt and 2 long prompts "
          f"{[int(p.size) for p in long]}, {PREFIX_MAX_NEW} new tokens "
          f"each: wave 1 prefill {m1['prefill_tokens']} tokens in "
          f"{m1['prefill_s'] * 1e3:.1f} ms "
          f"({metrics['wave1_prefill_tokens_per_s']:.1f} tok/s); wave 2 "
          f"(warm) {metrics['wave2_prefill_tokens']} tokens in "
          f"{metrics['wave2_prefill_s'] * 1e3:.1f} ms "
          f"({metrics['wave2_prefill_tokens_per_s']:.1f} tok/s; cold "
          f"{cst['prefill_tokens']} tokens in "
          f"{cst['prefill_s'] * 1e3:.1f} ms); long prompts chunked "
          f"{metrics['long_prefill_s'] * 1e3:.1f} ms (second run: wave 1 "
          f"{metrics['repeat_wave1_prefill_s'] * 1e3:.1f} ms, wave 2 "
          f"{metrics['repeat_wave2_prefill_s'] * 1e3:.1f} ms); decode "
          f"{metrics['decode_tokens_per_s']:.1f} tok/s (wave 1 "
          f"{metrics['wave1_decode_tokens_per_s']:.1f}, wave 2 warm "
          f"{metrics['wave2_decode_tokens_per_s']:.1f}, wave 2 cold "
          f"{metrics['cold_wave2_decode_tokens_per_s']:.1f}; second run "
          f"{metrics['repeat_decode_tokens_per_s']:.1f}; eager tick "
          f"{eager['decode_tokens_per_s']:.1f}), wall {wall:.2f} s, "
          f"launches {launches}; second run and eager tick identical; "
          f"warm rows' top-1 agreement with cold {agree}")
    print(f"[prefix] {card}: prefix_stats() {json.dumps(stats_block)}")
    metrics["long_memory"] = _long_prefill_memory(model, long, card)
    metrics["admission"] = _admission_checks(model)
    if profile:
        # wave 2's prefill warm (wave 1 served first) and cold
        metrics["profile"] = {
            "warm": profile_serving(model, wave2, PREFIX_MAX_NEW,
                                    PREFIX_GEOM, card, "prefix warm ",
                                    prime=wave1),
            "cold": profile_serving(model, wave2, PREFIX_MAX_NEW,
                                    COLD_GEOM, card, "prefix cold ")}
        _release()
    return metrics


def _long_prefill_memory(model, long, card):
    """The two long prompts prefilled alone (one new token each, so no
    tick runs) on fresh engines, chunked and whole, in turns: peak device
    memory above the engine's own, and the prefill's host wall."""
    out = {"chunked": [], "whole": []}
    for kind in ("chunked", "whole", "whole", "chunked"):
        geom = dict(PREFIX_GEOM, prefix_cache_pages=0)
        if kind == "whole":
            geom["prefill_chunk"] = None
        eng = _engine(model, **geom)
        reqs = [eng.submit(p, 1) for p in long]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if not all(len(r.result()) == 1 for r in reqs) \
                or eng.stats["ticks"]:
            raise AssertionError(f"long prompts {kind}: not one token each")
        out[kind].append(dict(peak_gb=peak / 1e9,
                              prefill_s=eng.stats["prefill_s"],
                              calls=eng.stats["prefill_calls"]))
        del eng, reqs
        _release()
    c = min(r["peak_gb"] for r in out["chunked"])
    w = min(r["peak_gb"] for r in out["whole"])
    ct = [r["prefill_s"] * 1e3 for r in out["chunked"]]
    wt = [r["prefill_s"] * 1e3 for r in out["whole"]]
    print(f"[prefix] {card}: long prompts {[int(p.size) for p in long]} "
          f"prefilled chunked ({PREFIX_GEOM['prefill_chunk']}) peak "
          f"+{c:.2f} GB in "
          f"{', '.join(f'{t:.1f}' for t in ct)} ms "
          f"({out['chunked'][0]['calls']} calls), whole peak +{w:.2f} GB "
          f"in {', '.join(f'{t:.1f}' for t in wt)} ms "
          f"({out['whole'][0]['calls']} calls); saved {w - c:.2f} GB")
    return out


def _admission_checks(model):
    """Deadlines and max_pending on a small engine: an expired deadline
    raises at submit; a request queued behind a full engine expires
    there with no prefill; a submit past max_pending is shed."""
    from paddle_tpu_torch.inference.overload import (Deadline,
                                                     DeadlineExceeded,
                                                     EngineOverloaded)
    eng = _engine(model, max_slots=1, page_size=16, num_pages=33,
                  max_pages_per_slot=16, steps_per_tick=4, kv_dtype="bf16",
                  max_pending=1)
    ids = (np.arange(100) % model.config.vocab_size).astype(np.int32)
    try:
        eng.submit(ids, 8, deadline=Deadline(time.monotonic() - 1.0))
        raise AssertionError("admission: an expired deadline was queued")
    except DeadlineExceeded:
        pass
    busy = eng.submit(ids, 64)
    eng.step()
    prefills = eng.stats["prefills"]
    late = eng.submit(ids[:50], 8, deadline=Deadline.after_ms(200))
    eng.step()
    if late.done.is_set():
        raise AssertionError("admission: the late request ended early")
    time.sleep(0.25)
    eng.step()
    if not late.done.is_set() \
            or not isinstance(late.error, DeadlineExceeded) \
            or eng.stats["expired"] != 1 \
            or eng.stats["prefills"] != prefills:
        raise AssertionError(f"admission: a request expired in the queue "
                             f"was not failed without a prefill "
                             f"({eng.stats})")
    queued = eng.submit(ids[:30], 8)
    try:
        eng.submit(ids[:40], 8)
        raise AssertionError("admission: a submit past max_pending was "
                             "queued")
    except EngineOverloaded as e:
        if e.retry_after != 0.1 or eng.stats["overloaded"] != 1:
            raise AssertionError(f"admission: shed {e.retry_after}, "
                                 f"{eng.stats}") from e
    for r in (busy, queued):
        r.cancel()
    eng.run_until_idle()
    if sorted(eng._free) != list(range(1, eng.num_pages)):
        raise AssertionError("admission: pages not returned")
    out = {k: eng.stats[k] for k in ("expired", "overloaded", "cancelled",
                                     "prefills")}
    del eng
    _release()
    print(f"[prefix] admission: expired deadline refused at submit; a "
          f"request queued behind a full engine expired with no prefill; "
          f"a submit past max_pending=1 shed (retry_after 0.1): {out}")
    return out


def _engine_logits(model, ids, geom):
    """The logits a cold engine of `geom` gives at the end of `ids` (its
    prefill's last row): the yardstick of a near tie."""
    eng = _engine(model, **dict(geom, prefix_cache_pages=0,
                                prefill_chunk=None))
    seen = []
    eng._first_token = lambda logits, req: (seen.append(logits), 0)[1]
    eng.generate([ids], 1)
    del eng
    _release()
    return seen[0]


def _same_or_near_tie(model, geom, prompt, got, want, tag, exact_geom=None):
    """Greedy tokens equal, or at their first difference the two tokens'
    logits agree within 1e-3 (phase 6's rule), on a cold engine of the
    same KV type. With `exact_geom` (int8 KV against f32 KV), the bound
    is at least the sum of the two tokens' own int8 errors: the
    differences of their logits between cold engines of the two KV types
    at that prefix. Two int8 engines that commit the same tokens can
    hold other codes (a spec tick's rejected verify rows grow a page's
    scale, which later tokens on the page keep:
    tests/test_torch_spec_decode.py
    `test_int8_rejected_verify_rows_grow_the_pages_scales`), so each
    of the two logits may move by about its int8 error."""
    if got == want:
        return {"identical": True}
    t = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    ids = np.concatenate([prompt, np.asarray(want[:t], np.int32)])
    logits = _engine_logits(model, ids, geom)
    gap = abs(float(logits[want[t]] - logits[got[t]]))
    tol = 1e-3
    if exact_geom is not None:
        delta = np.abs(logits - _engine_logits(model, ids, exact_geom))
        tol = max(tol, float(delta[want[t]] + delta[got[t]]))
    print(f"[parity] {tag}: tokens differ at step {t}: {want[t]} vs "
          f"{got[t]}, logit gap {gap:.3g} (bound {tol:.3g})")
    if gap > tol:
        raise AssertionError(f"parity {tag}: step {t} differs by a logit "
                             f"gap {gap} > {tol}")
    return {"identical": False, "step": t, "logit_gap": gap, "bound": tol}


def prefix_parity_phase(dev):
    """Phase 11's parity on phase 6's 2-layer full-width f32 model: a
    warm hit's tokens equal a cold, unchunked engine's, and a chunked
    long prompt's the whole prompt's; with int8 KV the shared pages'
    scale rows are bit-unchanged across the warm request's prefill and
    decode."""
    from paddle_tpu_torch.inference.prefix import chain_keys
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_8b_config(num_hidden_layers=2, fused_norm=True,
                           fused_rope=True)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=1)
    wave1, wave2, long = _prefix_traffic(cfg.vocab_size, seed=12)
    cold_p, warm_p, long_p = wave1[0], wave2[0], long[0]
    out = {}
    for kv in (None, "int8"):
        geom = dict(PREFIX_GEOM, kv_dtype=kv)
        tag = kv or "f32"
        eng = _engine(model, **geom)
        eng.generate([cold_p], PREFIX_MAX_NEW)
        ps = eng.page_size
        shared = [eng.prefix_cache.get(k) for k in
                  chain_keys(warm_p, ps)[:SYSTEM_TOKENS // ps]]
        scales = (None if kv is None
                  else eng._scales[:, :, shared].clone())
        got = eng.generate([warm_p, long_p], PREFIX_MAX_NEW)
        st = dict(eng.stats)
        if st["prefix_hits"] != 1 or None in shared:
            raise AssertionError(f"prefix parity {tag}: {st} shared "
                                 f"{len(shared)}")
        if scales is not None and not torch.equal(
                eng._scales[:, :, shared], scales):
            raise AssertionError(f"prefix parity {tag}: the shared pages' "
                                 "scale rows moved")
        _settled_ledger(eng, f"prefix parity {tag}")
        del eng
        _release()
        ref = _engine(model, **dict(geom, prefix_cache_pages=0,
                                    prefill_chunk=None))
        want = ref.generate([warm_p, long_p], PREFIX_MAX_NEW)
        del ref
        _release()
        out[tag] = dict(
            warm=_same_or_near_tie(model, geom, warm_p, got[0], want[0],
                                   f"{tag} warm hit"),
            chunked=_same_or_near_tie(model, geom, long_p, got[1], want[1],
                                      f"{tag} chunked {long_p.size}"),
            scales_frozen=scales is not None)
    print(f"[prefix-parity] 2-layer f32 model, f32 and int8 KV: a warm hit "
          f"({warm_p.size} tokens, {SYSTEM_TOKENS} shared) and a chunked "
          f"{long_p.size}-token prompt against a cold, unchunked engine: "
          f"{out}; int8 shared scale rows bit-unchanged")
    del model
    torch.cuda.empty_cache()
    return out


# -- phase 12: speculative decoding ---------------------------------------------

SPEC_G = 4
SPEC_VERIFY_M = 8 * (SPEC_G + 1)    # the verify's rows: 8 slots x g + 1
# the sampled request of part (a); the parity's TV check filters harder
SPEC_SAMPLE = dict(do_sample=True, temperature=0.8, top_k=50)
SPEC_TV_SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20)
SPEC_TV_TRIALS = 400


def _llama32_1b_config(**overrides):
    """meta-llama/Llama-3.2-1B's config.json widths: hidden 2048, 16
    layers, 32 q / 8 kv heads (head_dim 64), FFN 8192, vocab 128256, tied
    embeddings, rope theta 500000 (its llama3 RoPE scaling is not
    modelled: neither package has it)."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    base = dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
                num_hidden_layers=16, num_attention_heads=32,
                num_key_value_heads=8, max_position_embeddings=131072,
                rope_theta=500000.0, tie_word_embeddings=True,
                fused_norm=True, fused_rope=True)
    base.update(overrides)
    return LlamaConfig(**base)


def _spec_counts(lt, ld, g, int8):
    """The launches of one spec tick and of one prefill call, from the
    code: g draft steps and the bonus step at s = 1 (the decode kernel,
    2 L_d + 1 RMSNorms with the final norm, 2 L_d RoPEs; logits on the g
    draft steps only), one verify at s = g + 1 (`_attend_pages`: no
    decode kernel; 2 L_t + 1 RMSNorms, 2 L_t RoPEs, the lm_head over all
    g + 1 rows); a prefill call runs both models, the lm_head only on
    the target's last rows. W8A16 (7 projections a layer + the lm_head):
    the verify's b (g + 1) = 40 rows take the wgmma route."""
    decode = ("paged_decode_attention_int8" if int8
              else "paged_decode_attention")
    tick = {decode: ld * (g + 1),
            "rms_norm_residual": (2 * ld + 1) * (g + 1) + 2 * lt + 1,
            "rope_apply": 2 * ld * (g + 1) + 2 * lt}
    call = {decode: 0, "rms_norm_residual": 2 * lt + 1 + 2 * ld + 1,
            "rope_apply": 2 * lt + 2 * ld}
    if int8:
        tick["weight_only_int8_matmul"] = ((7 * ld + 1) * g + 7 * ld
                                           + 7 * lt + 1)
        tick["weight_only_int8_matmul_wgmma"] = 7 * lt + 1
        call["weight_only_int8_matmul"] = 7 * lt + 1 + 7 * ld
        call["weight_only_int8_matmul_wgmma"] = 7 * lt + 7 * ld
    return tick, call


def _verify_ms(eng):
    """Device ms of the spec tick's verify alone (the target at s = g + 1
    over every slot, lm_head included), captured and replayed with every
    slot idle (its writes go to the sink; the attend gathers the whole
    window whatever lens is)."""
    from paddle_tpu_torch.inference.paged import PagedState
    b, g, dev = eng.max_slots, eng.spec_tokens, eng.device
    ids = torch.zeros((b, g + 1), dtype=torch.int32, device=dev)
    pos = torch.arange(g + 1, dtype=torch.int32, device=dev)[None].expand(
        b, g + 1)
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    state = PagedState(torch.zeros((b, eng.max_pages_per_slot),
                                   dtype=torch.int32, device=dev),
                       zero, zero)

    def verify():
        with torch.no_grad():
            eng.model.logits(eng.model.model(ids, pos, eng.pools, state))
    return _time_ms(verify, [()], iters=5)


def _spec_part(tag, model, draft, prompts, geom, counters, reset, card,
               int8=False, sampled=(), profile=False):
    """One part of phase 12: phase 5's requests (64 new tokens, the late
    joiner) through PagedKVEngine(draft_model=draft, spec_tokens=4);
    the gates of the module doc. Returns the part's metrics."""
    cfg = model.config
    lt, ld = cfg.num_hidden_layers, draft.config.num_hidden_layers
    max_new = 64
    sgeom = dict(geom, draft_model=draft, spec_tokens=SPEC_G)
    tick, call = _spec_counts(lt, ld, SPEC_G, int8)
    reset()
    t0 = time.perf_counter()
    eng, toks = _serve(model, prompts, max_new, late=7, sampled=sampled,
                       **sgeom)
    wall = time.perf_counter() - t0
    counted = counters()
    launches = {k: counted[k] for k in tick}
    for i, t in enumerate(toks):
        if len(t) != max_new or not all(0 <= x < cfg.vocab_size for x in t):
            raise AssertionError(f"{tag}: request {i}: {len(t)} tokens, "
                                 f"want {max_new} in-vocab")
    if sorted(eng._free) != list(range(1, eng.num_pages)) \
            or eng._reserved_unalloc != 0:
        raise AssertionError(f"{tag}: pages not returned: free "
                             f"{len(eng._free)}, reserved "
                             f"{eng._reserved_unalloc}")
    if int8:
        # every freed page's scale rows zeroed in both models' planes
        # (page 0 takes past-budget verify rows, the sink dropped ones)
        left = [float(t[:, :, 1:-1].abs().sum())
                for t in (eng._scales, eng._draft_scales)]
        if left != [0.0, 0.0]:
            raise AssertionError(f"{tag}: freed pages kept scales {left}")
    st = dict(eng.stats)
    runs = st["ticks"] + st["warmup_ticks"]
    want = {k: n * runs + call[k] * st["prefill_calls"]
            for k, n in tick.items()}
    if launches != want or st["spec_ticks"] != st["ticks"]:
        raise AssertionError(
            f"{tag}: launches {launches}, want {want} ({st['ticks']} spec "
            f"ticks + {st['warmup_ticks']} warm-up x {tick}, "
            f"{st['prefill_calls']} prefill calls x {call})")
    if not 0 <= st["spec_accepted"] <= st["spec_proposed"]:
        raise AssertionError(f"{tag}: accepted {st['spec_accepted']} of "
                             f"{st['spec_proposed']} proposed")
    keys = sorted(eng._programs)
    if ("spec_tick", bool(sampled)) not in keys or \
            any(k[0] != "spec_tick" for k in keys):
        raise AssertionError(f"{tag}: captured programs {keys}")
    kv_slot = eng.kv_bytes_per_slot()
    path = TRACED_INT8 if int8 else TRACED_DECODE
    traced = traced_replays(eng, counters, reset, card, tag, path)
    verify_ms = _verify_ms(eng)
    del eng
    _release()
    eng2, toks2 = _serve(model, prompts, max_new, late=7, sampled=sampled,
                         **sgeom)
    if toks2 != toks:
        raise AssertionError(f"{tag}: a second identical run gave other "
                             "tokens")
    st2 = dict(eng2.stats)
    del eng2
    _release()
    metrics = dict(
        card=card, **_tick_metrics(st), wall_s=wall,
        repeat_decode_tokens_per_s=st2["decode_tokens"] / st2["tick_s"],
        spec_ticks=st["spec_ticks"], spec_proposed=st["spec_proposed"],
        spec_accepted=st["spec_accepted"],
        acceptance=st["spec_accepted"] / st["spec_proposed"],
        tokens_per_slot_tick=st["decode_tokens"] / max(
            1, st["spec_proposed"] // SPEC_G),
        kv_bytes_per_slot=kv_slot, launches=launches, tick_launches=tick,
        traced_replays=traced, verify_ms=verify_ms,
        verify_share_idle_replay=verify_ms / traced["busy_ms"],
        tokens=toks, sampled=list(sampled))
    metrics["eager"] = _eager_run(model, prompts, max_new, sgeom, toks, tag,
                                  sampled)
    print(f"[{tag}] {card}: spec tick (g {SPEC_G}, draft {ld} layers of "
          f"{draft.config.hidden_size}): decode "
          f"{metrics['decode_tokens_per_s']:.1f} tok/s, spec tick "
          f"{metrics['tick_ms']:.2f} ms over {st['ticks']} ticks (warm-up "
          f"{st['warmup_ticks']}, {st['warmup_s']:.2f} s), accepted "
          f"{st['spec_accepted']} of {st['spec_proposed']} "
          f"({metrics['acceptance']:.4f}), "
          f"{metrics['tokens_per_slot_tick']:.3f} tokens a slot a tick; "
          f"verify alone {verify_ms:.3f} ms = "
          f"{metrics['verify_share_idle_replay']:.3f} of an idle replay's "
          f"kernels; launches {launches} exact; second run identical "
          f"({metrics['repeat_decode_tokens_per_s']:.1f} tok/s); eager spec "
          f"body's greedy tokens identical, decode "
          f"{metrics['eager']['decode_tokens_per_s']:.1f} tok/s, tick "
          f"{metrics['eager']['tick_ms']:.2f} ms")
    if profile:
        prof = profile_serving(model, prompts, max_new, sgeom, card,
                               label=f"{tag} ")
        busy = prof["decode_2_ticks"]["device_busy_s"] * 1e3 / 2
        prof["verify_share"] = verify_ms / busy
        print(f"[{tag}] {card}: the verify takes {verify_ms:.3f} ms of a "
              f"traced spec tick's {busy:.3f} kernel ms "
              f"({prof['verify_share']:.3f})")
        metrics["profile"] = prof
    return metrics


def spec_serving_phase(model, counters, reset, card, bf16_serving,
                       profile=False):
    """Phase 12 (a) and (b) on phase 5's Llama-3-8B (seed 0, bf16, fused
    norm and RoPE), with phase 5's geometry and requests: (a) the target
    as its own draft, one request sampling; (b) a Llama-3.2-1B-width
    draft from seed 1."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    geom = dict(max_slots=8, page_size=16, num_pages=641,
                max_pages_per_slot=80, kv_dtype="bf16")
    prompts = _prompts(8, model.config.vocab_size, seed=0)
    out = {"a": _spec_part("spec-a", model, model, prompts, geom, counters,
                           reset, card, sampled=(3,), profile=profile)}
    t0 = time.perf_counter()
    draft = LlamaForCausalLM(_llama32_1b_config(), device=model.device,
                             dtype=torch.bfloat16, seed=1)
    torch.cuda.synchronize()
    print(f"[spec-b] Llama-3.2-1B-width draft built in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in draft.parameters()) / 1e9:.3f} B "
          "params)")
    out["b"] = _spec_part("spec-b", model, draft, prompts, geom, counters,
                          reset, card, profile=profile)
    del draft
    _release()
    base = bf16_serving["decode_tokens_per_s"]
    print(f"[spec] {card}: decode tok/s, non-spec (phase 5) {base:.1f}, "
          f"(a) self-draft {out['a']['decode_tokens_per_s']:.1f}, (b) "
          f"1B-width draft {out['b']['decode_tokens_per_s']:.1f}; tick ms "
          f"{bf16_serving['tick_ms']:.2f} (4 steps) / "
          f"{out['a']['tick_ms']:.2f} / {out['b']['tick_ms']:.2f}")
    return out


def spec_int8_part(model, counters, reset, card, profile=False):
    """Phase 12 (c), right after phase 10 on the model it converted: the
    W8A16 Llama-3-8B as its own draft with int8 KV."""
    geom = dict(max_slots=8, page_size=16, num_pages=641,
                max_pages_per_slot=80, kv_dtype="int8")
    prompts = _prompts(8, model.config.vocab_size, seed=0)
    return _spec_part("spec-c", model, model, prompts, geom, counters,
                      reset, card, int8=True, profile=profile)


def _spec_tv(model, draft, geom, prompt, tag):
    """Leviathan's rule on the card: 400 replays of the sampled spec tick
    from one state (the pools restored before each) against the
    target's processed softmax at that position; returns the total-
    variation distance, which must stay under 0.25."""
    from paddle_tpu_torch.inference.paged import (PagedState,
                                                  _process_logits_rowwise)
    eng = _engine(model, **dict(geom, max_slots=1, draft_model=draft,
                                spec_tokens=SPEC_G))
    eng.submit(prompt, 32, **SPEC_TV_SAMPLE)
    eng._admit()
    program = eng._tick_program(True)       # captured on idle inputs
    eng._slot_arrays([0])
    x = eng._inputs
    for k, t in x.items():
        t.copy_(eng._staging[k])
    pools = [t for grp in eng.pools + eng.draft_pools for t in grp]
    saved = [t.clone() for t in pools]
    with torch.no_grad():
        h = model.model(x["tok"][:, None], x["lens"][:, None],
                        [tuple(t.clone() for t in grp) for grp in eng.pools],
                        PagedState(x["bt"], x["lens"],
                                   x["active"].to(torch.int32)))
        want = torch.softmax(_process_logits_rowwise(
            model.logits(h[:, -1]), x["temp"], x["topk"], x["topp"]),
            dim=-1)[0].double().cpu()
    counts = torch.zeros_like(want)
    for _ in range(SPEC_TV_TRIALS):
        for t, s in zip(pools, saved):
            t.copy_(s)
        program()
        counts[int(eng._outputs[0, 0])] += 1
    tv = 0.5 * float((counts / SPEC_TV_TRIALS - want).abs().sum())
    del eng
    _release()
    if not tv < 0.25:
        raise AssertionError(f"spec parity {tag}: the sampled first token "
                             f"strays {tv:.4f} >= 0.25 (TV) from the "
                             "target's distribution")
    return tv


def spec_parity_phase(dev):
    """Phase 12's parity on phase 6's 2-layer full-width f32 model, f32
    and int8 KV, with the target as its own draft and with a 2-layer
    Llama-3.2-1B-width f32 draft (seed 2): the spec engine's greedy tokens
    against the spec-off engine's (phase 6's requests, or a near tie by
    phase 6's rule; at int8 KV within int8's own error at the prefix,
    `_same_or_near_tie`), every proposal accepted with the target as
    draft at f32 KV, and the sampled tick's first token within TV 0.25
    of the target's processed softmax."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_8b_config(num_hidden_layers=2, fused_norm=True,
                           fused_rope=True)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=1)
    small = LlamaForCausalLM(_llama32_1b_config(num_hidden_layers=2),
                             device=dev, dtype=torch.float32, seed=2)
    prompts = (_prompts(7, cfg.vocab_size, seed=3, lo=64, hi=512)
               + _prompts(1, cfg.vocab_size, seed=2, lo=200, hi=200))
    max_new = 32
    out = {}
    for kv in (None, "int8"):
        geom = dict(max_slots=8, page_size=16, num_pages=641,
                    max_pages_per_slot=80, kv_dtype=kv)
        _, want = _serve(model, prompts, max_new, late=7, **geom)
        _release()
        for dname, draft in (("self", model), ("1b", small)):
            tag = f"{kv or 'f32'} {dname}"
            eng, got = _serve(model, prompts, max_new, late=7,
                              draft_model=draft, spec_tokens=SPEC_G, **geom)
            st = dict(eng.stats)
            del eng
            _release()
            exact = None if kv is None else dict(geom, kv_dtype=None)
            rows = [_same_or_near_tie(model, geom, p, a, b, f"spec {tag}",
                                      exact)
                    for p, a, b in zip(prompts, got, want)]
            if dname == "self" and kv is None and \
                    st["spec_accepted"] != st["spec_proposed"]:
                raise AssertionError(
                    f"spec parity {tag}: the target as its own draft had "
                    f"{st['spec_accepted']} of {st['spec_proposed']} "
                    "proposals accepted")
            tv = _spec_tv(model, draft, geom, prompts[7], tag)
            out[tag] = dict(
                identical=sum(r["identical"] for r in rows),
                near_ties=[r for r in rows if not r["identical"]],
                spec_accepted=st["spec_accepted"],
                spec_proposed=st["spec_proposed"], tv=tv)
    print(f"[spec-parity] 2-layer f32 model, f32 and int8 KV, self and "
          f"1B-width drafts against the spec-off engine: {out}")
    del model, small
    torch.cuda.empty_cache()
    return out


# -- phase 13: tenancy, the host KV tier with sessions, disaggregated roles ---

# phase 5's engine geometry, with the captured tick
FEATURE_GEOM = dict(max_slots=8, page_size=16, num_pages=641,
                    max_pages_per_slot=80, steps_per_tick=4, kv_dtype="bf16")
FEATURE_MAX_NEW = 64
TURN2_NEW = 32              # turn 2's new prompt tokens and new tokens
SUSPEND_S = 2.0             # (b)'s suspend_after_s
HOST_TIER_BYTES = 2 << 30


def _feature_launches(tag, counted, engines, layers, decode):
    """Phase 11's launch gate over `engines`' runs since the counters were
    reset: the decode kernel `decode` L launches a decode step (the
    warm-up tick's counted), RMSNorm 2 L + 1 and RoPE 2 L a decode step
    and a prefill call, the other decode kernel and W8A16 none."""
    steps = sum(_decode_steps(e) for e in engines)
    calls = sum(e.stats["prefill_calls"] for e in engines) + steps
    want = {"paged_decode_attention": 0, "paged_decode_attention_int8": 0,
            "rms_norm_residual": (2 * layers + 1) * calls,
            "rope_apply": 2 * layers * calls,
            "weight_only_int8_matmul": 0}
    want[decode] = layers * steps
    got = {k: counted[k] for k in want}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, want {want} ({steps} "
                             f"decode steps, {calls - steps} prefill calls)")
    return {k: v for k, v in got.items() if v}


def _check_tokens(tag, toks, n, vocab):
    for i, t in enumerate(toks):
        if len(t) != n or not all(0 <= x < vocab for x in t):
            raise AssertionError(f"{tag}: request {i}: {len(t)} tokens, "
                                 f"want {n} in-vocab")


def _timed(eng, name, log):
    """Wrap the engine method `name` so each call appends (host s, a CUDA
    event pair around it on the engine's stream, its arguments) to
    `log`; returns a function that takes the wrapper off again (it would
    keep the engine in a cycle)."""
    orig = getattr(eng, name)

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = orig(*args)
        end.record()
        log.append((time.perf_counter() - t0, start, end, args))
        return out
    setattr(eng, name, timed)
    return lambda: delattr(eng, name)


def _device_ms(log):
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for _, a, b, _ in log)


def _pcie_rates(nbytes=256 << 20):
    """Host-to-device and device-to-host bytes/s of one pinned copy of
    `nbytes` (the best of three, timed between CUDA events)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    rates = {}
    for kind, (dst, src) in (("h2d", (dev, host)), ("d2h", (host, dev))):
        best = None
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            best = ms if best is None else min(best, ms)
        rates[kind] = nbytes / (best / 1e3)
    return rates


def _tenancy_part(model, counters, reset, card, base_rate):
    """(a): tenants a and b at weights 3:1 submit 24 and 8 requests of
    phase 5's prompt lengths at once. The admission order must be a CPU
    WeightedFairScheduler's for that queue, the slot-ticks split 2.5-3.5
    while both tenants are queued, and the greedy tokens those of a
    tenancy-free engine fed the same requests in the admitted order (so
    each batch holds the same rows)."""
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    from paddle_tpu_torch.inference.tenancy import (TenantPolicy,
                                                    TenantTable,
                                                    WeightedFairScheduler)
    cfg = model.config
    lens = [int(p.size) for p in _prompts(8, cfg.vocab_size, seed=0)]
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, lens[i % 8]).astype(np.int32)
               for i in range(32)]
    tenants = ["a"] * 24 + ["b"] * 8
    table = TenantTable([TenantPolicy("a", weight=3.0),
                         TenantPolicy("b", weight=1.0)])
    wfq, left, want_order = WeightedFairScheduler(table), \
        {"a": 24, "b": 8}, []
    while any(left.values()):
        t = wfq.pick([k for k, n in left.items() if n])
        wfq.charge(t)
        left[t] -= 1
        want_order.append(t)
    reset()
    t0 = time.perf_counter()
    eng = PagedKVEngine(model, device=model.device, tenancy=table,
                        **FEATURE_GEOM)
    seen = []
    orig = eng._note_tenant_admitted
    eng._note_tenant_admitted = lambda req: (seen.append(req), orig(req))
    reqs = [eng.submit(p, FEATURE_MAX_NEW, tenant=t)
            for p, t in zip(prompts, tenants)]
    both = None
    while eng.has_work():
        eng.step()
        snap = eng.tenant_snapshot()
        if snap["a"]["pending"] and snap["b"]["pending"]:
            both = snap
    wall = time.perf_counter() - t0
    launches = _feature_launches("tenancy", counters(), [eng],
                                 cfg.num_hidden_layers,
                                 "paged_decode_attention")
    del eng._note_tenant_admitted, orig
    toks = [r.result() for r in reqs]
    _check_tokens("tenancy", toks, FEATURE_MAX_NEW, cfg.vocab_size)
    order = [r.tenant for r in seen]
    if order != want_order:
        raise AssertionError(f"tenancy: admitted {order}, the CPU "
                             f"WeightedFairScheduler gives {want_order}")
    ratio = both["a"]["slot_ticks"] / both["b"]["slot_ticks"]
    if not 2.5 <= ratio <= 3.5:
        raise AssertionError(f"tenancy: slot-ticks {both} split {ratio}")
    st, final = dict(eng.stats), eng.tenant_snapshot()
    del eng
    _release()
    plain = PagedKVEngine(model, device=model.device, **FEATURE_GEOM)
    preqs = [plain.submit(r.prompt, FEATURE_MAX_NEW) for r in seen]
    plain.run_until_idle()
    index = {id(r): i for i, r in enumerate(reqs)}
    bad = [index[id(r)] for r, q in zip(seen, preqs)
           if r.result() != q.result()]
    if bad:
        raise AssertionError(f"tenancy: requests {bad} gave other tokens "
                             "than a tenancy-free engine fed the admitted "
                             "order")
    plain_rate = plain.stats["decode_tokens"] / plain.stats["tick_s"]
    del plain
    _release()
    out = dict(card=card, wall_s=wall, launches=launches, stats=st,
               **_tick_metrics(st), slot_ticks_both_queued=both,
               slot_tick_ratio=ratio, tenant_snapshot=final,
               admission_order="".join(order),
               tenancy_free_decode_tokens_per_s=plain_rate)
    print(f"[tenancy] {card}: 24 + 8 requests, weights 3:1, admitted "
          f"{out['admission_order']} (the CPU WeightedFairScheduler's); "
          f"slot-ticks while both queued {both['a']['slot_ticks']} : "
          f"{both['b']['slot_ticks']} = {ratio:.3f}; tokens equal to a "
          f"tenancy-free engine fed the admitted order; decode "
          f"{out['decode_tokens_per_s']:.1f} tok/s (tenancy-free "
          f"{plain_rate:.1f}, phase 5 {base_rate:.1f}), tick "
          f"{out['tick_ms']:.2f} ms, wall {wall:.2f} s, launches {launches}")
    return out


def _turns(eng, prompts, extra, outs1=None):
    """Turn 1 of 8 sessions (phase 5's prompts), or with `outs1` turn 2
    (turn 1, its output and TURN2_NEW new tokens; TURN2_NEW to
    generate). Returns the token lists."""
    if outs1 is None:
        batch = [(p, FEATURE_MAX_NEW) for p in prompts]
    else:
        batch = [(np.concatenate([p, np.asarray(o, np.int32), x]),
                  TURN2_NEW) for p, o, x in zip(prompts, outs1, extra)]
    reqs = [eng.submit(p, n, session=f"s{i}")
            for i, (p, n) in enumerate(batch)]
    eng.run_until_idle()
    return [r.result() for r in reqs]


def _kvtier_part(model, counters, reset, card):
    """(b): 8 sessions. Turn 1, then SUSPEND_S idle: every session page
    spills, the device cache empties and the free list is whole. Turn 2
    restores them: byte-equal to the pages before the spill, the pools
    at their addresses, no recapture, and the tokens of an engine whose
    sessions never suspended. Spill and restore ms beside the PCIe
    bound; turn 2's prefill warm from the host against cold."""
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    cfg = model.config
    prompts = _prompts(8, cfg.vocab_size, seed=0)
    rng = np.random.default_rng(14)
    extra = [rng.integers(0, cfg.vocab_size, TURN2_NEW).astype(np.int32)
             for _ in prompts]
    rates = _pcie_rates()
    geom = dict(FEATURE_GEOM, prefix_cache_pages=512)
    reset()
    t0 = time.perf_counter()
    eng = PagedKVEngine(model, device=model.device,
                        host_tier_bytes=HOST_TIER_BYTES,
                        suspend_after_s=SUSPEND_S, **geom)
    outs1 = _turns(eng, prompts, extra)
    keys = [k for i in range(8) for k in eng._sessions[f"s{i}"]["keys"]]
    pages = torch.tensor([eng.prefix_cache.get(k) for k in keys],
                         device=model.device)
    before = eng._kv[:, :, pages].clone()
    ptrs = [t.data_ptr() for grp in eng.pools for t in grp]
    programs, warmups = dict(eng._programs), eng.stats["warmup_ticks"]
    time.sleep(SUSPEND_S)
    t1 = time.perf_counter()
    eng.step()                              # the suspend sweep
    sweep_s = time.perf_counter() - t1
    eng.host_tier.flush()
    spill_s = time.perf_counter() - t1
    mid = eng.kvtier_stats()
    if mid["suspends"] != 8 or mid["spilled_pages"] != len(keys) \
            or len(eng.prefix_cache) or mid["spill_errors"] \
            or sorted(eng._free) != list(range(1, eng.num_pages)):
        raise AssertionError(f"kvtier: after the sweep {mid}, cached "
                             f"{len(eng.prefix_cache)}, free "
                             f"{len(eng._free)}")
    log, staging = [], []
    untime = _timed(eng, "_tier_upload", log)
    unstage = _timed(eng, "_staged", staging)
    pre_prefill = eng.stats["prefill_s"]
    outs2 = _turns(eng, prompts, extra, outs1)
    untime()
    unstage()
    restore_ms = _device_ms(log)
    restore_host_s = sum(x[0] for x in log)
    staging_s = sum(x[0] for x in staging)
    warm_prefill_s = eng.stats["prefill_s"] - pre_prefill
    wall = time.perf_counter() - t0
    launches = _feature_launches("kvtier", counters(), [eng],
                                 cfg.num_hidden_layers,
                                 "paged_decode_attention")
    snap = eng.kvtier_stats()
    after = eng._kv[:, :, torch.tensor(
        [eng.prefix_cache.get(k) for k in keys], device=model.device)]
    if snap["restored_pages"] != len(keys) or snap["resumes"] != 8 \
            or not torch.equal(after, before):
        raise AssertionError(f"kvtier: restored {snap['restored_pages']} "
                             f"of {len(keys)} pages, resumes "
                             f"{snap['resumes']}, byte-equal "
                             f"{torch.equal(after, before)}")
    if [t.data_ptr() for grp in eng.pools for t in grp] != ptrs \
            or eng._programs != programs \
            or eng.stats["warmup_ticks"] != warmups:
        raise AssertionError("kvtier: a restore moved a pool or the tick "
                             "was captured again")
    _settled_ledger(eng, "kvtier")
    st = dict(eng.stats)
    del eng, before, after
    _release()
    plain = PagedKVEngine(model, device=model.device, **geom)
    if _turns(plain, prompts, extra) != outs1 \
            or _turns(plain, prompts, extra, outs1) != outs2:
        raise AssertionError("kvtier: the suspended sessions' tokens differ "
                             "from an engine whose sessions stayed on the "
                             "device")
    del plain
    _release()
    cold = PagedKVEngine(model, device=model.device, **FEATURE_GEOM)
    cold_outs = _turns(cold, prompts, extra, outs1)
    cold_prefill_s = cold.stats["prefill_s"]
    del cold
    _release()
    _check_tokens("kvtier turn 1", outs1, FEATURE_MAX_NEW, cfg.vocab_size)
    _check_tokens("kvtier turn 2", outs2, TURN2_NEW, cfg.vocab_size)
    nb_spill, nb_restore = snap["spill_bytes"], snap["restore_bytes"]
    out = dict(
        card=card, wall_s=wall, launches=launches, stats=st,
        kvtier_stats=snap, pcie_bytes_per_s=rates, pages=len(keys),
        spill_bytes=nb_spill, restore_bytes=nb_restore,
        spill_ms=spill_s * 1e3, spill_sweep_ms=sweep_s * 1e3,
        spill_bound_ms=nb_spill / rates["d2h"] * 1e3,
        restore_device_ms=restore_ms, restore_host_ms=restore_host_s * 1e3,
        restore_staging_ms=staging_s * 1e3,
        restore_bound_ms=nb_restore / rates["h2d"] * 1e3,
        turn2_warm_prefill_ms=warm_prefill_s * 1e3,
        turn2_cold_prefill_ms=cold_prefill_s * 1e3,
        turn2_cold_agreement=sum(a == b for a, b in zip(outs2, cold_outs))
        / 8)
    print(f"[kvtier] {card}: 8 sessions, {len(keys)} pages "
          f"({nb_spill} B) spilled after {SUSPEND_S} s idle in "
          f"{out['spill_ms']:.1f} ms (sweep to last commit, the sweep's "
          f"step {out['spill_sweep_ms']:.1f} ms; D2H bound "
          f"{out['spill_bound_ms']:.1f} ms at {rates['d2h'] / 1e9:.2f} GB/s); "
          f"{nb_restore} B restored in {out['restore_host_ms']:.1f} ms of "
          f"host wall, {out['restore_staging_ms']:.1f} of them stacking the "
          f"entries into pinned staging ({restore_ms:.1f} ms between the "
          f"uploads' device events, staging included; H2D "
          f"bound {out['restore_bound_ms']:.1f} ms at "
          f"{rates['h2d'] / 1e9:.2f} GB/s), byte-equal, pools in place, no "
          f"recapture; turn 2 prefill warm from the host "
          f"{out['turn2_warm_prefill_ms']:.1f} ms (+ the restore) against "
          f"cold {out['turn2_cold_prefill_ms']:.1f} ms; tokens equal to "
          f"unsuspended sessions' (cold agreement "
          f"{out['turn2_cold_agreement']}); launches {launches}")
    return out


def _disagg_part(model, counters, reset, card, kv):
    """(c) at one KV type: role="prefill" and role="decode" engines over
    the same model, export -> pack_bundle -> unpack_bundle ->
    stage_import -> decode of phase 5's prompts. The tokens must equal a
    monolithic engine's serving the same two hops (a one-token prefill,
    then the request warm on its cached pages), and the imported pages
    the prefill engine's, byte for byte (scales included)."""
    from paddle_tpu_torch.inference.disagg import pack_bundle, unpack_bundle
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    from paddle_tpu_torch.inference.prefix import chain_keys
    cfg = model.config
    geom = dict(FEATURE_GEOM, kv_dtype=kv, prefix_cache_pages=512)
    prompts = _prompts(8, cfg.vocab_size, seed=0)
    keys = [k for p in prompts for k in chain_keys(p, geom["page_size"])]
    mono = PagedKVEngine(model, device=model.device, **geom)
    mono.generate(prompts, 1)
    want = mono.generate(prompts, FEATURE_MAX_NEW)
    del mono
    _release()
    reset()
    pre = PagedKVEngine(model, device=model.device, role="prefill",
                        host_tier_bytes=HOST_TIER_BYTES, **geom)
    pre.generate(prompts, 1)
    t0 = time.perf_counter()
    entries = pre.export_pages(keys)
    export_s = time.perf_counter() - t0
    raw = pack_bundle(entries)
    pack_s = time.perf_counter() - t0 - export_s
    t1 = time.perf_counter()
    got = unpack_bundle(raw)
    unpack_s = time.perf_counter() - t1
    dec = PagedKVEngine(model, device=model.device, role="decode", **geom)
    if dec.disagg_missing(keys) != keys:
        raise AssertionError(f"disagg {kv}: a cold decode engine has pages")
    dec.stage_import(got)
    log = []
    untime = _timed(dec, "_disagg_import", log)
    toks = dec.generate(prompts, FEATURE_MAX_NEW)
    untime()
    import_ms = _device_ms(log)
    decode = ("paged_decode_attention_int8" if kv == "int8"
              else "paged_decode_attention")
    launches = _feature_launches(f"disagg {kv}", counters(), [pre, dec],
                                 cfg.num_hidden_layers, decode)
    _check_tokens(f"disagg {kv}", toks, FEATURE_MAX_NEW, cfg.vocab_size)
    if toks != want:
        bad = [i for i, (a, b) in enumerate(zip(toks, want)) if a != b]
        raise AssertionError(f"disagg {kv}: requests {bad} gave other "
                             "tokens than the monolithic engine's")
    snap = dec.disagg_stats()
    if len(entries) != len(keys) or snap["imported_pages"] != len(keys) \
            or dec.stats["prefix_hits"] != 8:
        raise AssertionError(f"disagg {kv}: exported {len(entries)} of "
                             f"{len(keys)} pages, {snap}, hits "
                             f"{dec.stats['prefix_hits']}")
    src = torch.tensor([pre.prefix_cache.get(k) for k in keys],
                       device=model.device)
    dst = torch.tensor([dec.prefix_cache.get(k) for k in keys],
                       device=model.device)
    for a, b in ((pre._kv, dec._kv), (pre._scales, dec._scales)):
        if a is not None and not torch.equal(a[:, :, src], b[:, :, dst]):
            raise AssertionError(f"disagg {kv}: imported pages differ from "
                                 "the prefill engine's")
    st = {"prefill": dict(pre.stats), "decode": dict(dec.stats)}
    del pre, dec, entries, got
    _release()
    out = dict(kv=kv, pages=len(keys), bundle_bytes=len(raw),
               export_ms=export_s * 1e3, pack_ms=pack_s * 1e3,
               unpack_ms=unpack_s * 1e3,
               import_device_ms=import_ms,
               import_host_ms=sum(x[0] for x in log) * 1e3,
               disagg_stats=snap, stats=st, launches=launches,
               decode_tokens_per_s=(st["decode"]["decode_tokens"]
                                    / st["decode"]["tick_s"]))
    print(f"[disagg] {card}: {kv} KV, {len(keys)} pages, bundle "
          f"{len(raw)} B: export {out['export_ms']:.1f} ms, pack "
          f"{out['pack_ms']:.1f} ms, unpack {out['unpack_ms']:.1f} ms, "
          f"import {import_ms:.1f} device ms ({out['import_host_ms']:.1f} ms "
          f"host); imported pages byte-equal to the prefill engine's, "
          f"tokens equal to the monolithic engine's; decode "
          f"{out['decode_tokens_per_s']:.1f} tok/s; launches {launches}")
    return out


def feature_phase(model, counters, reset, card, bf16_serving):
    """Phase 13 on phase 5's Llama-3-8B (module doc): (a) tenancy, (b) the
    host KV tier with sessions, (c) disaggregated roles at bf16 and int8
    KV. Each part's launches go to its own path."""
    out = {"tenancy": _tenancy_part(model, counters, reset, card,
                                    bf16_serving["decode_tokens_per_s"]),
           "kvtier": _kvtier_part(model, counters, reset, card)}
    parts = [_disagg_part(model, counters, reset, card, kv)
             for kv in ("bf16", "int8")]
    launches = {}
    for part in parts:
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["disagg"] = {"parts": parts, "launches": launches}
    return out


# -- phase 14: HTTP serving ---------------------------------------------------

HTTP_TIMEOUT = 300          # each client socket's timeout, s
WAVE_TRACEPARENT = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
PROM_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                         r'([0-9.eE+-]+|\+Inf)$')


def _http_json(port, path, obj=None, headers=None):
    """(status, JSON body, headers) of one request to the local server."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    try:
        if obj is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, json.dumps(obj),
                         {"Content-Type": "application/json",
                          **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        body = json.loads(raw) if path != "/metrics" else raw.decode()
        return resp.status, body, dict(resp.getheaders())
    finally:
        conn.close()


def _generate(port, obj, headers, first=None):
    """POST /generate, reading a stream line by line; `first` is set at
    its first line. Returns the status, each row's tokens, the headers
    and the host times of the send, the first line and the last byte."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", json.dumps(obj),
                     {"Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        hdrs = dict(resp.getheaders())
        t_first = None
        if not obj.get("stream"):
            body = json.loads(resp.read())
            rows = body.get("sequences", body)
        else:
            steps = []
            while True:
                line = resp.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                if t_first is None:
                    t_first = time.perf_counter()
                    if first is not None:
                        first.set()
                item = json.loads(line)
                if "error" in item:
                    raise AssertionError(f"http: stream error {item}")
                if "tokens" in item:
                    steps.append(item["tokens"])
            rows = [[st[b] for st in steps] for b in range(len(steps[0]))]
        return dict(status=resp.status, rows=rows, headers=hdrs, t0=t0,
                    t_first=t_first, t_end=time.perf_counter())
    finally:
        conn.close()


def _in_threads(fns):
    """Run each function on its own thread; re-raise the first error."""
    import threading
    out, errs = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            errs.append(e)
    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=2 * HTTP_TIMEOUT)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in ts):
        raise AssertionError("http: a client thread did not finish")
    return out


def _prom(text):
    """{(name, labels): value} of a Prometheus text body; raises on a line
    that is not a comment or a sample."""
    out = {}
    for line in text.strip().split("\n"):
        if line.startswith("#"):
            continue
        m = PROM_SAMPLE.match(line)
        if m is None:
            raise AssertionError(f"http: /metrics line {line!r} does not "
                                 "parse")
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def _pool_addresses(eng):
    return [t.data_ptr() for grp in eng.pools for t in grp] \
        + [eng._kv.data_ptr()]


def _idle(eng, obs):
    t_end = time.monotonic() + HTTP_TIMEOUT
    while eng.has_work() or obs.requests.live_count():
        if time.monotonic() > t_end:
            raise AssertionError("http: the engine did not go idle")
        time.sleep(0.01)


def _refusals(eng, port, prompt, chaos):
    """(c): a 504 from a 1 ms budget behind a 20 ms admission delay; on a
    server of one slot, a 429 with Retry-After and /readyz "saturated"
    while a stream is in flight; drain() during a stream."""
    import threading
    from paddle_tpu_torch.inference.serving import PredictorServer
    req = {"ids": [prompt.tolist()], "max_new_tokens": FEATURE_MAX_NEW}
    with chaos.scoped(rates={"serving.admit.delay": 1.0}, delay_ms=20.0):
        code, body, _h = _http_json(port, "/generate",
                                    dict(req, timeout_ms=1))
    if code != 504:
        raise AssertionError(f"http: timeout_ms=1 gave {code} {body}")
    srv = PredictorServer(lambda d: d, generator=eng, max_concurrent=1,
                          max_queue_depth=0).start()
    try:
        first = threading.Event()

        def probe():
            if not first.wait(timeout=HTTP_TIMEOUT):
                raise AssertionError("http: no first streamed line")
            shed = _http_json(srv.port, "/generate", req)
            ready = _http_json(srv.port, "/readyz")
            return shed, ready
        streamed, (shed, ready) = _in_threads([
            lambda: _generate(srv.port, dict(req, stream=True), {}, first),
            probe])
        if shed[0] != 429 or "Retry-After" not in shed[2]:
            raise AssertionError(f"http: second request gave {shed[:2]}, "
                                 "want 429 with Retry-After")
        if ready[0] != 503 or ready[1]["reason"] != "saturated":
            raise AssertionError(f"http: /readyz gave {ready[:2]}")
        first = threading.Event()

        def drain():
            if not first.wait(timeout=HTTP_TIMEOUT):
                raise AssertionError("http: no first streamed line")
            result = {}
            t = threading.Thread(
                target=lambda: result.update(clean=srv.drain(timeout=120)),
                daemon=True)
            t.start()
            t_end = time.monotonic() + 60
            while not srv._draining and time.monotonic() < t_end:
                time.sleep(0.005)
            readyz = _http_json(srv.port, "/readyz")
            t.join(timeout=150)
            return readyz, result.get("clean")
        drained, (readyz, clean) = _in_threads([
            lambda: _generate(srv.port, dict(req, stream=True), {}, first),
            drain])
        if readyz[0] != 503 or readyz[1]["reason"] != "draining":
            raise AssertionError(f"http: /readyz while draining gave "
                                 f"{readyz[:2]}")
        if clean is not True or srv._thread.is_alive():
            raise AssertionError(f"http: drain() returned {clean}, server "
                                 f"thread alive {srv._thread.is_alive()}")
        for tag, r in (("saturated", streamed), ("drained", drained)):
            if r["status"] != 200 or len(r["rows"][0]) != FEATURE_MAX_NEW:
                raise AssertionError(f"http: the {tag} stream gave "
                                     f"{r['status']}, "
                                     f"{len(r['rows'][0])} tokens")
        return dict(timeout_504=code, saturated_429=shed[0],
                    retry_after=shed[2]["Retry-After"],
                    readyz_saturated=ready[1]["reason"],
                    readyz_draining=readyz[1]["reason"],
                    drain_clean=clean)
    finally:
        if srv._thread.is_alive():
            srv.stop()


def _record_submits(eng, obs, handles):
    """Wrap eng.submit so each request's engine handle is kept under its
    X-Request-Id; `del eng.submit` takes it off."""
    submit = eng.submit

    def recording_submit(*args, **kw):
        r = submit(*args, **kw)
        ctx = obs.requests.current()
        handles[None if ctx is None else ctx.request_id] = r
        return r
    eng.submit = recording_submit


def http_phase(model, counters, reset, card, bf16_serving):
    """Phase 14 on phase 5's Llama-3-8B (module doc): (a) one wave of 8
    requests through HTTP, (b) /metrics and /debug/requests after it,
    (c) the front end's refusals."""
    import threading
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.inference.serving import PredictorServer
    cfg = model.config
    prompts = _prompts(8, cfg.vocab_size, seed=0)
    t_phase = time.perf_counter()
    reset()
    eng = _engine(model, **FEATURE_GEOM)
    srv = None
    try:
        # the tick is captured before the wave, which must not capture
        eng.generate([prompts[0][:16]], max_new_tokens=8)
        programs = dict(eng._programs)
        addresses = _pool_addresses(eng)
        ticks0 = eng.stats["ticks"]
        handles = {}
        _record_submits(eng, obs, handles)
        obs.enable(reset=True)
        srv = PredictorServer(lambda d: d, generator=eng).start()
        first = threading.Event()

        def client(i):
            if i == 7 and not first.wait(timeout=HTTP_TIMEOUT):
                raise AssertionError("http: no first streamed line")
            return _generate(
                srv.port, {"ids": [prompts[i].tolist()],
                           "max_new_tokens": FEATURE_MAX_NEW,
                           "stream": i % 2 == 0},
                {"X-Request-Id": f"wave-{i}",
                 "traceparent": WAVE_TRACEPARENT},
                first if i == 0 else None)
        res = _in_threads([lambda i=i: client(i) for i in range(8)])
        _idle(eng, obs)
        del eng.submit
        toks = []
        for i, r in enumerate(res):
            rid = r["headers"].get("X-Request-Id")
            tp = (r["headers"].get("traceparent") or "").split("-")
            if r["status"] != 200 or rid != f"wave-{i}" or len(tp) != 4 \
                    or tp[1] != "ab" * 16 or tp[2] == "cd" * 8:
                raise AssertionError(f"http: request {i}: {r['status']}, "
                                     f"echoed {rid!r} {tp}")
            if r["rows"] != [handles[rid].tokens]:
                raise AssertionError(f"http: request {i}'s reply is not "
                                     "its engine request's tokens")
            toks.append(r["rows"][0])
        _check_tokens("http", toks, FEATURE_MAX_NEW, cfg.vocab_size)
        if dict(eng._programs) != programs \
                or _pool_addresses(eng) != addresses:
            raise AssertionError(f"http: the wave recaptured: programs "
                                 f"{list(eng._programs)}, pools moved "
                                 f"{_pool_addresses(eng) != addresses}")
        wall = max(r["t_end"] for r in res) - min(r["t0"] for r in res)
        rate = 8 * FEATURE_MAX_NEW / wall
        ttft = [r["t_first"] - r["t0"] for r in res if r["t_first"]]
        agree = sum(a == b for a, b in zip(toks, bf16_serving["tokens"]))
        # (b) /metrics, /stats and /debug/requests, idle
        code, text, hdrs = _http_json(srv.port, "/metrics")
        vals = _prom(text)
        st = eng.stats
        want = {f"paddle_tpu_engine_{k}": st[k]
                for k in ("ticks", "prefills", "tokens_out", "admitted",
                          "finished", "cancelled", "expired", "overloaded")}
        want["paddle_tpu_engine_pending"] = 0
        got = {k: vals.get((k, "")) for k in want}
        if code != 200 or got != {k: float(v) for k, v in want.items()}:
            raise AssertionError(f"http: /metrics engine gauges {got}, "
                                 f"engine.stats {want}")
        checks = {
            ("paddle_tpu_request_ttft_seconds_count", ""): 8.0,
            ("paddle_tpu_request_tokens_sum", ""): 8.0 * FEATURE_MAX_NEW,
            ("paddle_tpu_inference_decode_kernel_total", '{path="cuda"}'):
                float(st["ticks"] - ticks0)}
        bad = {k: (vals.get(k), v) for k, v in checks.items()
               if vals.get(k) != v}
        # one terminal outcome a request: the engine's "finished" or,
        # when the handler reads the last tokens first, its "ok"
        done = {k[1]: v for k, v in vals.items()
                if k[0] == "paddle_tpu_request_outcome_total"}
        if sum(done.values()) != 8.0 or not set(done) <= {
                '{reason="finished"}', '{reason="ok"}'}:
            bad["paddle_tpu_request_outcome_total"] = (done, 8.0)
        if bad:
            raise AssertionError(f"http: /metrics (got, want) {bad}")
        code, stats, _h = _http_json(srv.port, "/stats")
        code2, live, _h = _http_json(srv.port, "/debug/requests")
        if code != 200 or stats["requests"] != {"total": 8, "ok": 8} \
                or code2 != 200 or live["count"] != 0:
            raise AssertionError(f"http: /stats requests "
                                 f"{stats['requests']}, /debug/requests "
                                 f"{live}")
        reg = obs.REGISTRY
        pct = {name: {p: reg.histogram(f"request.{name}.seconds")
                      .percentile(p) for p in (50, 99)}
               for name in ("ttft", "itl")}
        wave = dict(ticks=st["ticks"] - ticks0, tokens_out=st["tokens_out"])
        # (c) the front end's refusals
        refusals = _refusals(eng, srv.port, prompts[1], chaos)
        _idle(eng, obs)
        launches = _feature_launches("http", counters(), [eng],
                                     cfg.num_hidden_layers,
                                     "paged_decode_attention")
    finally:
        obs.disable()
        if srv is not None:
            srv.stop()
        eng.stop()
        eng.__dict__.pop("submit", None)
    out = dict(card=card, wall_s=wall, decode_tokens_per_s=rate,
               direct_decode_tokens_per_s=bf16_serving[
                   "decode_tokens_per_s"],
               client_ttft_s=ttft, ttft_s=pct["ttft"], itl_s=pct["itl"],
               agree_with_phase5=agree, launches=launches, wave=wave,
               refusals=refusals, engine_stats=dict(eng.stats))
    del eng
    _release()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[http] {card}: 8 requests x {FEATURE_MAX_NEW} tokens through "
          f"PredictorServer (4 streamed, 4 unary, one late): decode "
          f"{rate:.1f} tok/s over the wave's wall {wall:.3f} s (phase 5 "
          f"direct {out['direct_decode_tokens_per_s']:.1f} tok/s); TTFT "
          f"p50 {pct['ttft'][50]:.4f} s p99 {pct['ttft'][99]:.4f} s, ITL "
          f"p50 {pct['itl'][50]:.5f} s p99 {pct['itl'][99]:.5f} s "
          f"(per-token gap of a tick's emission); {wave['ticks']} ticks, "
          f"no recapture; {agree} of 8 equal to phase 5's tokens; "
          f"refusals {refusals}; launches {launches}; phase "
          f"{out['phase_s']:.1f} s")
    return out


# -- phase 15: static-cache generation ------------------------------------------

GEN_MAX_NEW = 64            # (a), (c), (d), (e), (f): phase 5's new tokens
GEN_TAIL_NEW = 37           # (b): a max_new_tokens that GEN_TPF does not divide
GEN_TPF = 16                # the block's decode steps (tokens_per_fetch)
GEN_SPEC_G = 4
GEN_SAMPLE = dict(do_sample=True, temperature=0.8, top_k=50, seed=5)
# the generation path's logits, at every row's prefill and at one
# teacher-forced decode step, and at each near tie's prefix, stay within
# GEN_LOGITS_RMS x the RMS of a cold engine's logits at the same prefix
# (RMS of the difference); a planted fault in the decode step's RoPE
# position must read above it (`_gen_logits_check`)
GEN_LOGITS_RMS = 2 ** -3
# a difference between two paths' tokens passes as a near tie when the
# chosen token's lead on the exact path is within the larger of 1e-3, two
# bf16 steps of the two logits, and GEN_TIE_RMS x the RMS difference of
# that path's logits and a cold engine's at the prefix. The bound must
# sit below the median top-two gap of the cold engine's logits, so that a
# token that is second by a typical margin fails
GEN_TIE_RMS = 1.75


def _keep_slots(mask, max_len):
    """A prompt's keep mask (b, s) over a cache of `max_len` slots: the
    slots past the prompt are kept (models/generation.py `_graph_mask`)."""
    keep = np.ones((mask.shape[0], max_len), bool)
    keep[:, :mask.shape[1]] = mask
    return keep


def _left_pad(prompts):
    """The prompts left-padded with id 0 to the longest, and the keep
    mask."""
    s = max(p.size for p in prompts)
    ids = np.zeros((len(prompts), s), np.int32)
    mask = np.zeros((len(prompts), s), bool)
    for i, p in enumerate(prompts):
        ids[i, s - p.size:], mask[i, s - p.size:] = p, True
    return ids, mask


def _gen_steps(model, b, s, max_new, do_sample):
    """The cached programs and buffers generate() uses at this shape."""
    from paddle_tpu_torch.models.generation import _compiled_steps
    return _compiled_steps(model, b, s + max_new, do_sample)


def _gen_calls(st0, st1):
    """(model calls, prefills) between two snapshots of a `_Steps.stats`:
    prefills, per-token decode steps, block steps and warm-up steps."""
    calls = sum(st1[k] - st0[k] for k in ("prefills", "decode_steps",
                                          "block_steps", "warmup_steps"))
    return calls, st1["prefills"] - st0["prefills"]


def _gen_check_launches(tag, counted, calls, prefills, per_call,
                        wgmma_per_prefill=0):
    """Every launch of the run is one of a model call's: `per_call` a
    call, and the W8A16 wgmma route's at each prefill (M = b x s); the
    decode kernel none (the dense cache attends in PyTorch)."""
    want = {k: n * calls for k, n in per_call.items() if n}
    if wgmma_per_prefill:
        want["weight_only_int8_matmul_wgmma"] = wgmma_per_prefill * prefills
    got = {k: v for k, v in counted.items() if v}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, want {want} ({calls} "
                             f"model calls, {prefills} prefills)")
    return got


def _gen_run(tag, model, steps, ids, n, counters, reset, per_call,
             wgmma_per_prefill=0, **kw):
    """One generate_stream() to its end, its launches held to the model
    calls it made: (tokens (b, n), seconds to the first token on the
    host (the prefill), seconds of the rest, launches)."""
    from paddle_tpu_torch.models.generation import generate_stream
    st0 = dict(steps.stats)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = generate_stream(model, ids, n, **kw)
    rows = [next(it)]
    t1 = time.perf_counter()
    rows += list(it)
    t2 = time.perf_counter()
    toks = np.stack(rows, axis=1)
    vocab = model.config.vocab_size
    if toks.shape != (ids.shape[0], n) or toks.min() < 0 \
            or toks.max() >= vocab:
        raise AssertionError(f"{tag}: tokens {toks.shape}, want "
                             f"{(ids.shape[0], n)} in-vocab")
    calls, prefills = _gen_calls(st0, steps.stats)
    got = _gen_check_launches(tag, counters(), calls, prefills, per_call,
                              wgmma_per_prefill)
    return toks, t1 - t0, t2 - t1, got


def _gen_graph(tag, steps, key, per_call, n_steps, counters, path):
    """The captured program's graph as the CUDA driver lists it holds, of
    each kernel, exactly the nodes its capture counted, and those are
    `n_steps` model calls' counts (`per_call`)."""
    from paddle_tpu_torch.core.graphs import CapturedProgram
    program = steps.programs[key]
    if not isinstance(program, CapturedProgram):
        raise AssertionError(f"{tag}: {key} ran without a captured graph")
    gain = dict.fromkeys(counters(), 0)
    for _, k, c in program.delta:
        gain[k] += c
    want_gain = {k: (n_steps * per_call.get(k, 0)) for k in gain}
    if gain != want_gain:
        raise AssertionError(f"{tag}: the capture of {key} counted {gain}, "
                             f"want {n_steps} x {per_call}")
    want = _trace_want(gain)
    nodes, kinds = _graph_nodes(program, want)
    if nodes != want or min(want[k] for k in path) <= 0:
        raise AssertionError(f"{tag}: the graph of {key} holds kernel nodes "
                             f"{nodes}, its capture counted {want}")
    return dict(launches={k: v for k, v in gain.items() if v},
                kernel_nodes=nodes, nodes=kinds)


def _gen_exact_logits(model, ids, mask, toks, max_len, need):
    """The generation path's own logits (f32 numpy (v,)) at each (row,
    step) of `need`, recomputed eagerly over a fresh cache of `max_len`
    slots: the bodies the captured graphs hold, on the same shapes, so
    the same bits (tests/test_torch_cuda.py holds the captured steps to
    the eager bodies). `toks` (b, n) are that path's tokens; step 0 is
    the prefill."""
    from paddle_tpu_torch.models import generation as tgen
    dev = model.device
    b, s = ids.shape
    caches = tgen.init_kv_cache(model, b, max_len)
    keep = torch.from_numpy(_keep_slots(mask, max_len)).to(dev)
    out = {}
    with torch.no_grad():
        last = tgen._prefill_logits(model, s, True,
                                    torch.from_numpy(ids).to(dev), keep,
                                    caches)
        for t in range(max(t for _, t in need) + 1):
            if t:
                last = tgen._step_logits(
                    model, b, True, torch.from_numpy(toks[:, t - 1])
                    .to(dev), torch.tensor(s + t - 1, dtype=torch.int32,
                                           device=dev), keep, caches)
            for r, tt in need:
                if tt == t:
                    out[(r, t)] = last[r].float().cpu().numpy()
    del caches
    return out


def _first_diff(a, b):
    return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)


def _ref_logits(model):
    """ids -> the logits a cold engine of phase 5's geometry gives at the
    end of `ids` (its prefill's last row), one engine for every call (no
    prefix cache, so each prefill is cold)."""
    eng = _engine(model, **dict(FEATURE_GEOM, prefix_cache_pages=0,
                                prefill_chunk=None))
    seen = []
    eng._first_token = lambda logits, req: (seen.append(logits), 0)[1]

    def logits(ids):
        eng.generate([ids], 1)
        return seen.pop()
    return logits


def _rms_rel(x, ref):
    """RMS of x - ref over the RMS of ref (f64)."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((x - ref) ** 2) / np.mean(ref ** 2)))


class _DecodePositionFault:
    """A planted fault: the model's one-token (decode) calls get RoPE
    positions one past the right ones."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        forward = type(self.model).forward.__get__(self.model)

        def shifted(input_ids, *args, position_ids=None, **kw):
            if input_ids.shape[1] == 1:
                position_ids = position_ids + 1
            return forward(input_ids, *args, position_ids=position_ids, **kw)
        self.model.forward = shifted

    def __exit__(self, *exc):
        del self.model.forward


class _Bf16ScoresFault:
    """A planted fault: the plain attention (every attention of the
    dense-cache path) rounds its q kᵀ scores to bf16 before the mask and
    the softmax; the rest is `scaled_dot_product_attention`'s."""

    def __enter__(self):
        from paddle_tpu_torch.nn import functional as fnl
        self.fnl, self.sdpa = fnl, fnl.scaled_dot_product_attention

        def bf16_scores(q, k, v, attn_mask=None, is_causal=False,
                        scale=None):
            b, sq, hq, d = q.shape
            kl, hk = k.shape[1], k.shape[2]
            qg = q.transpose(1, 2).reshape(b, hk, hq // hk * sq, d)
            scores = (qg.float() @ k.transpose(1, 2).float().transpose(
                -1, -2)).to(torch.bfloat16).float()
            scores = scores.reshape(b, hq, sq, kl) * (scale or d ** -0.5)
            if is_causal:
                keep = torch.ones(sq, kl, dtype=torch.bool,
                                  device=q.device).tril(kl - sq)
                scores = scores.masked_fill(~keep, float("-inf"))
            if attn_mask is not None:
                scores = (scores.masked_fill(~attn_mask, float("-inf"))
                          if attn_mask.dtype == torch.bool
                          else scores + attn_mask.float())
            probs = torch.softmax(scores, dim=-1).to(q.dtype).masked_fill(
                torch.isneginf(scores).all(-1, keepdim=True), 0.0)
            out = probs.reshape(b, hk, hq // hk * sq, kl) @ v.transpose(1, 2)
            return out.reshape(b, hq, sq, d).transpose(1, 2)
        fnl.scaled_dot_product_attention = bf16_scores

    def __exit__(self, *exc):
        self.fnl.scaled_dot_product_attention = self.sdpa


def _gen_logits_readings(model, prompts, ids, mask, greedy, ref_logits):
    """Every row's prefill logits and one teacher-forced decode step's
    (the step fed (a)'s first token) on the generation path (the eager
    bodies of `_gen_exact_logits`) against a cold engine's at the same
    prefix, as `_rms_rel` ({step: [a row's reading]}): the sound path,
    and three planted faults: the decode step's RoPE position one too
    far, the padding mask ignored (its readings only for padded rows),
    bf16 scores. Also the median top-two gap of the engine's logits
    (GEN_TIE_RMS)."""
    b, s = ids.shape
    need = [(r, t) for r in range(b) for t in (0, 1)]
    refs = {(r, t): np.asarray(ref_logits(np.concatenate(
        [prompts[r], greedy[r, :t]]).astype(np.int32)), np.float64)
        for r, t in need}
    padded = [r for r in range(b) if not mask[r].all()]

    def readings(fault, keep=mask, rows=range(b)):
        with fault:
            ex = _gen_exact_logits(model, ids, keep, greedy,
                                   s + GEN_MAX_NEW, need)
        return {t: [_rms_rel(ex[(r, t)], refs[(r, t)]) for r in rows]
                for t in (0, 1)}
    none = contextlib.nullcontext()
    sound = readings(none)
    position = readings(_DecodePositionFault(model))
    pad = readings(none, np.ones_like(mask), padded)
    bf16 = readings(_Bf16ScoresFault())
    top2 = [np.sort(x)[-2:] for x in refs.values()]
    gap = float(np.median([hi - lo for lo, hi in top2]))
    out = dict(sound=sound, decode_position_fault=position,
               pad_mask_fault=pad, bf16_scores_fault=bf16,
               limit=GEN_LOGITS_RMS, sound_max=max(sound[0] + sound[1]),
               position_fault_min=min(position[1]),
               pad_fault_min=min(pad[0] + pad[1]),
               bf16_fault_max=max(bf16[0] + bf16[1]),
               median_top2_gap=gap)
    print(f"[gen] logits against a cold engine (RMS difference / RMS), "
          f"{b} rows, prefill and one teacher-forced decode step: sound "
          f"{sound}; planted decode-position fault {position}; planted "
          f"pad-mask fault (rows {padded}) {pad}; planted bf16-scores "
          f"fault {bf16}; limit {GEN_LOGITS_RMS}; the engine logits' "
          f"median top-two gap {gap:.4g}")
    return out


def _gen_logits_check(model, prompts, ids, mask, greedy, ref_logits):
    """`_gen_logits_readings`, held: the sound path's readings all within
    GEN_LOGITS_RMS, every reading of the decode-position and pad-mask
    faults above it (the bf16-scores fault's are reported)."""
    out = _gen_logits_readings(model, prompts, ids, mask, greedy,
                               ref_logits)
    if out["sound_max"] > GEN_LOGITS_RMS:
        raise AssertionError(f"gen: the generation path's logits are "
                             f"{out['sound_max']:.4g} of RMS from a cold "
                             f"engine's (limit {GEN_LOGITS_RMS})")
    for name in ("position_fault_min", "pad_fault_min"):
        if out[name] <= GEN_LOGITS_RMS:
            raise AssertionError(f"gen: a planted fault reads {name} "
                                 f"{out[name]:.4g}, within the limit "
                                 f"{GEN_LOGITS_RMS}: the check is blind")
    return out


def _gen_near_tie(tag, ref_logits, prompt, chosen_toks, other_toks, exact,
                  typical_gap):
    """At the first difference t of two token lists, the exact path (the
    one that gave `chosen_toks`, logits `exact` at t) leads the other
    token by a near tie (GEN_TIE_RMS's rule, its bound below
    `typical_gap`, the engine logits' median top-two gap), measured
    against a cold engine's logits at the same prefix (`ref_logits`)."""
    t = _first_diff(chosen_toks, other_toks)
    chosen, other = chosen_toks[t], other_toks[t]
    ref = ref_logits(np.concatenate(
        [prompt, np.asarray(chosen_toks[:t], np.int32)]))
    lx, lr = exact.astype(np.float64), np.asarray(ref, np.float64)
    gap = float(lx[chosen] - lx[other])
    rms_diff = float(np.sqrt(np.mean((lx - lr) ** 2)))
    rms_ref = float(np.sqrt(np.mean(lr ** 2)))
    top = max(abs(lx[chosen]), abs(lx[other]), 2.0 ** -126)
    bf16_step = 2.0 ** (np.floor(np.log2(top)) - 7)
    bound = float(max(1e-3, 2 * bf16_step, GEN_TIE_RMS * rms_diff))
    out = dict(step=t, chosen=int(chosen), other=int(other), gap=gap,
               bound=bound, rms_diff=rms_diff, rms_logits=rms_ref)
    print(f"[gen] {tag}: differs at step {t}: {chosen} vs {other}, lead "
          f"{gap:.4g} (bound {bound:.4g}, median top-two gap "
          f"{typical_gap:.4g}); logits' RMS difference to a cold engine "
          f"{rms_diff:.4g} of RMS {rms_ref:.4g}")
    if (not 0 <= gap <= bound or bound >= typical_gap
            or rms_diff > GEN_LOGITS_RMS * rms_ref):
        raise AssertionError(f"gen {tag}: not a near tie: {out}")
    return out


def _gen_rows(tag, exact_toks, other_toks, need):
    """The rows of `exact_toks` (token lists of (a)'s path, whose logits
    `_gen_exact_logits` recomputes) equal to `other_toks`'; each other
    row's first difference is queued in `need` for the near-tie rule."""
    same = 0
    for r, (g, w) in enumerate(zip(exact_toks, other_toks)):
        g, w = [int(x) for x in g], [int(x) for x in w]
        if g == w:
            same += 1
        else:
            need.append((tag, r, _first_diff(g, w), g, w))
    return same


def _dense_attn_ms(model, mask, max_len):
    """Device ms of one layer's dense-cache attention (models/llama.py
    `_dense_cache_attention`: the k/v writes, the masks, the f32 scores,
    the softmax and the value product) at the decode step's shape (b
    queries at slot max_len - 2) and at the prefill's (the padded prompt
    at slot 0), over random buffers of the model's cache type, replayed
    in a graph (`_time_ms`)."""
    from paddle_tpu_torch.models.generation import _graph_mask
    from paddle_tpu_torch.models.llama import _dense_cache_attention
    cfg, dev, dt = model.config, model.device, model.dtype
    hq, hk, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    b, s = mask.shape
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)
    cache = (randn(b, max_len, hk, d), randn(b, max_len, hk, d))
    attn = _graph_mask(torch.from_numpy(_keep_slots(mask, max_len)).to(dev))
    out = {}
    for name, sq, index, iters in (("decode", 1, max_len - 2, 50),
                                   ("prefill", s, 0, 5)):
        idx = torch.tensor(index, dtype=torch.int32, device=dev)
        out[name] = _time_ms(
            lambda q, k, v: _dense_cache_attention(q, k, v, cache, idx,
                                                   attn),
            [(randn(b, sq, hq, d), randn(b, sq, hk, d),
              randn(b, sq, hk, d))], iters=iters)
    return out


def _gen_greedy(tag, model, steps, ids, mask, counters, reset, per_call,
                path, add, wgmma_per_prefill=0):
    """Greedy generation of GEN_MAX_NEW tokens at tokens_per_fetch 1 and
    GEN_TPF, two runs each (the first captures, the second is timed): all
    four give the same tokens, and the decode and block graphs hold
    exactly the kernel nodes their captures counted. -> ({tpf: tokens,
    prefill ms, decode tokens/s}, the graphs' node counts)."""
    b = ids.shape[0]
    runs = {}
    for tpf in (1, GEN_TPF):
        toks = []
        for _ in range(2):
            t, pre_s, dec_s, got = _gen_run(
                f"{tag} tpf {tpf}", model, steps, ids, GEN_MAX_NEW, counters,
                reset, per_call, wgmma_per_prefill, attention_mask=mask,
                tokens_per_fetch=tpf)
            add(got)
            toks.append(t)
        if not np.array_equal(toks[0], toks[1]):
            raise AssertionError(f"gen {tag} tpf {tpf}: a second run gave "
                                 "other tokens")
        runs[tpf] = dict(tokens=toks[1], prefill_ms=pre_s * 1e3,
                         decode_tokens_per_s=b * (GEN_MAX_NEW - 1) / dec_s)
    if not np.array_equal(runs[1]["tokens"], runs[GEN_TPF]["tokens"]):
        raise AssertionError(f"gen {tag}: tokens_per_fetch {GEN_TPF} gave "
                             "other tokens than 1")
    graphs = {"decode": _gen_graph(tag, steps, "decode", per_call, 1,
                                   counters, path),
              "block": _gen_graph(tag, steps, ("block", GEN_TPF), per_call,
                                  GEN_TPF, counters, path)}
    return runs, graphs


def generation_phase(model, counters, reset, card, bf16_serving,
                     profile=False):
    """Phase 15 (a), (b), (c), (e), (f) on phase 5's Llama-3-8B (module
    doc); with `profile`, torch.profiler over (a)'s prefill and two of
    its decode steps."""
    from paddle_tpu_torch.inference.serving import PredictorServer
    from paddle_tpu_torch.models.generation import generate_speculative
    cfg = model.config
    n_layers = cfg.num_hidden_layers
    per_call = {"rms_norm_residual": 2 * n_layers + 1,
                "rope_apply": 2 * n_layers}
    path = ("rmsn_fwd_kernel<", "rope_kernel<")
    t_phase = time.perf_counter()
    prompts = _prompts(8, cfg.vocab_size, seed=0)
    ids, mask = _left_pad(prompts)
    b, s = ids.shape
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # (a) greedy, tokens_per_fetch 1 and GEN_TPF
    steps = _gen_steps(model, b, s, GEN_MAX_NEW, False)
    runs, graphs = _gen_greedy("(a)", model, steps, ids, mask, counters,
                               reset, per_call, path, add)
    greedy = runs[1]["tokens"]
    attn_ms = _dense_attn_ms(model, mask, s + GEN_MAX_NEW)
    traced = None
    if profile:
        from paddle_tpu_torch.models.generation import generate_stream
        it = generate_stream(model, ids, GEN_MAX_NEW, attention_mask=mask)
        traced = {"prefill": _trace_window(card, "gen prefill",
                                           lambda: next(it)),
                  "decode_2_steps": _trace_window(
                      card, "gen decode_2_steps",
                      lambda: (next(it), next(it)))}
        it.close()
    need = []
    engine_tokens = bf16_serving["tokens"]
    same_engine = _gen_rows("(a) against phase 5's engine", greedy.tolist(),
                            engine_tokens, need)
    cache_bytes = steps.nbytes()
    capture_s = dict(steps.stats["capture_s"])

    parts = {"a": time.perf_counter() - t_phase}

    # (b) a tail block: the steps past `limit` of the last block write
    # only the buffers' last slot
    steps_b = _gen_steps(model, b, s, GEN_TAIL_NEW, False)
    tail = {}
    for tpf in (1, GEN_TPF):
        t, _, _, got = _gen_run(f"(b) tpf {tpf}", model, steps_b, ids,
                                GEN_TAIL_NEW, counters, reset, per_call,
                                attention_mask=mask, tokens_per_fetch=tpf)
        add(got)
        tail[tpf] = t
        if tpf == 1:
            per_token_kv = [x[:, :-1].clone() for kv in steps_b.caches
                            for x in kv]
    if not np.array_equal(tail[1], tail[GEN_TPF]):
        raise AssertionError("gen (b): the tail block gave other tokens")
    for x, y in zip(per_token_kv, [x[:, :-1] for kv in steps_b.caches
                                   for x in kv]):
        if not torch.equal(x, y):
            raise AssertionError("gen (b): the block left other k/v than "
                                 "per-token decode below the last slot")
    del per_token_kv
    same_tail = _gen_rows("(b) against (a)",
                          greedy[:, :GEN_TAIL_NEW].tolist(),
                          tail[1].tolist(), need)

    parts["b"] = time.perf_counter() - t_phase - sum(parts.values())

    # (c) sampled: seeded per-token runs repeat; a block at top_k=1 is
    # greedy, but for exact ties (bf16 logits: top_k=1 keeps every entry
    # equal to the largest, and the noise picks among them)
    steps_c = _gen_steps(model, b, s, GEN_MAX_NEW, True)
    sampled = []
    for _ in range(2):
        t, _, _, got = _gen_run("(c) sampled", model, steps_c, ids,
                                GEN_MAX_NEW, counters, reset, per_call,
                                attention_mask=mask, **GEN_SAMPLE)
        add(got)
        sampled.append(t)
    if not np.array_equal(sampled[0], sampled[1]):
        raise AssertionError("gen (c): a seeded sampled run did not repeat")
    k1, _, _, got = _gen_run("(c) top_k=1 block", model, steps_c, ids,
                             GEN_MAX_NEW, counters, reset, per_call,
                             attention_mask=mask, do_sample=True, top_k=1,
                             seed=6, tokens_per_fetch=GEN_TPF)
    add(got)
    ties = []
    for r in range(b):
        if not np.array_equal(k1[r], greedy[r]):
            ties.append((r, _first_diff(greedy[r], k1[r])))

    parts["c"] = time.perf_counter() - t_phase - sum(parts.values())

    # the near ties and exact ties, on (a)'s exact logits
    want_logits = {(r, t) for _, r, t, _, _ in need} | set(ties)
    exact = (_gen_exact_logits(model, ids, mask, greedy, s + GEN_MAX_NEW,
                               sorted(want_logits)) if want_logits else {})
    tie_checks = []
    ref_logits = _ref_logits(model)
    logits_check = _gen_logits_check(model, prompts, ids, mask, greedy,
                                     ref_logits)
    typical_gap = logits_check["median_top2_gap"]
    for tag, r, t, g, w in need:
        tie_checks.append(dict(tag=tag, row=r, **_gen_near_tie(
            f"{tag} row {r}", ref_logits, prompts[r], g, w,
            exact[(r, t)], typical_gap)))
    for r, t in ties:
        lx = exact[(r, t)]
        a, c = int(greedy[r, t]), int(k1[r, t])
        if not lx[a] == lx[c] == lx.max():
            raise AssertionError(f"gen (c): the top_k=1 block differs from "
                                 f"greedy at row {r} step {t} without a "
                                 f"tie: {lx[a]} vs {lx[c]} (max "
                                 f"{lx.max()})")
    del exact

    parts["ties"] = time.perf_counter() - t_phase - sum(parts.values())

    # (e) speculative decoding at batch 1, the 8B as its own draft
    prompt = prompts[0]
    steps_e = _gen_steps(model, 1, prompt.size, GEN_MAX_NEW, False)
    ref_e, _, _, got = _gen_run("(e) greedy, batch 1", model, steps_e,
                                prompt[None], GEN_MAX_NEW, counters, reset,
                                per_call)
    add(got)
    reset()
    spec_stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec = generate_speculative(model, model, prompt[None], GEN_MAX_NEW,
                                num_speculative_tokens=GEN_SPEC_G,
                                stats=spec_stats).numpy()[0, prompt.size:]
    spec_s = time.perf_counter() - t0
    rounds = spec_stats["target_forwards"] - 1
    got = _gen_check_launches("(e) speculative", counters(),
                              2 + (GEN_SPEC_G + 1) * rounds, 2, per_call)
    add(got)
    if spec.size != GEN_MAX_NEW or spec_stats["generated"] != GEN_MAX_NEW:
        raise AssertionError(f"gen (e): {spec.size} tokens, stats "
                             f"{spec_stats}")
    spec_tie = None
    if not np.array_equal(spec, ref_e[0]):
        t = _first_diff(ref_e[0], spec)
        ex = _gen_exact_logits(model, prompt[None], np.ones((1, prompt.size),
                               bool), ref_e, prompt.size + GEN_MAX_NEW,
                               [(0, t)])
        spec_tie = _gen_near_tie("(e) spec against greedy", ref_logits,
                                 prompt, ref_e[0].tolist(), spec.tolist(),
                                 ex[(0, t)], typical_gap)

    del ref_logits              # its engine's pools
    _release()

    parts["e"] = time.perf_counter() - t_phase - sum(parts.values())

    # (f) HTTP: PredictorServer(generator=model), tokens_per_fetch 16
    programs = dict(steps.programs)
    st0 = dict(steps.stats)
    reset()
    srv = PredictorServer(lambda d: d, generator=model).start()
    try:
        http = {}
        for stream in (True, False):
            r = _generate(srv.port, {
                "ids": ids.tolist(), "attention_mask": mask.astype(
                    int).tolist(), "max_new_tokens": GEN_MAX_NEW,
                "tokens_per_fetch": GEN_TPF, "stream": stream}, {})
            if r["status"] != 200 or r["rows"] != greedy.tolist():
                raise AssertionError(f"gen (f): HTTP (stream {stream}) "
                                     f"gave status {r['status']} and other "
                                     "tokens than (a)")
            http["stream" if stream else "unary"] = r["t_end"] - r["t0"]
    finally:
        srv.stop()
    calls, prefills = _gen_calls(st0, steps.stats)
    add(_gen_check_launches("(f) http", counters(), calls, prefills,
                            per_call))
    if steps.programs != programs:
        raise AssertionError("gen (f): the HTTP requests captured again")

    parts["f"] = time.perf_counter() - t_phase - sum(parts.values())
    held = model.__dict__["_gen_step_cache"]
    cache_held = dict(entries=len(held), bytes=sum(e.nbytes()
                                                   for e in held.values()))
    pool_bytes = {str(k): p.pool_bytes for k, p in steps.programs.items()}
    engine_rate = bf16_serving["decode_tokens_per_s"]
    decode_delta = graphs["decode"]["launches"]
    out = dict(
        card=card, batch=b, prompt_len=s, max_new_tokens=GEN_MAX_NEW,
        prefill_ms=runs[1]["prefill_ms"],
        prefill_ms_tpf16=runs[GEN_TPF]["prefill_ms"],
        decode_tokens_per_s={str(k): v["decode_tokens_per_s"]
                             for k, v in runs.items()},
        engine_decode_tokens_per_s=engine_rate,
        capture_s={str(k): v for k, v in capture_s.items()},
        dense_attention_layer_ms=attn_ms,
        cache_bytes=cache_bytes, cache_held=cache_held,
        graph_pool_bytes=pool_bytes, launches_per_decode_step=decode_delta,
        launches_per_prefill=per_call, graphs=graphs,
        rows_equal_engine=same_engine, tail_rows_equal=same_tail,
        logits_check=logits_check, top_k1_ties=ties, near_ties=tie_checks, spec_stats=spec_stats,
        spec_s=spec_s, spec_equal_greedy=spec_tie is None,
        spec_near_tie=spec_tie, http_s=http, launches=total,
        profile=traced, part_s=parts)
    model.__dict__.pop("_gen_step_cache", None)
    _release()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[gen] {card}: generate() on Llama-3-8B, 8 left-padded prompts "
          f"({b} x {s}), {GEN_MAX_NEW} new tokens: prefill "
          f"{out['prefill_ms']:.1f} ms; decode "
          f"{runs[1]['decode_tokens_per_s']:.1f} tok/s at tokens_per_fetch "
          f"1, {runs[GEN_TPF]['decode_tokens_per_s']:.1f} at {GEN_TPF} "
          f"(phase 5's engine {engine_rate:.1f}); one layer's dense-cache "
          f"attention {attn_ms['decode']:.4f} ms a decode step, "
          f"{attn_ms['prefill']:.3f} ms a prefill (x {n_layers} layers); "
          f"capture s (warm-up "
          f"included) {out['capture_s']}; cache {cache_bytes} B (graph pools "
          f"{pool_bytes}; the step cache at the end {cache_held}); launches a "
          f"decode step {decode_delta}, a prefill {per_call}; graphs "
          f"{ {k: v['kernel_nodes'] for k, v in graphs.items()} }; "
          f"logits against a cold engine: sound at most "
          f"{logits_check['sound_max']:.4g} of RMS, a decode-position fault "
          f"at least {logits_check['position_fault_min']:.4g}, bf16 scores "
          f"at most {logits_check['bf16_fault_max']:.4g} (limit "
          f"{GEN_LOGITS_RMS}); "
          f"{same_engine} of 8 rows equal to phase 5's engine, the tail run "
          f"{same_tail} of 8 equal to (a)'s first {GEN_TAIL_NEW}, near ties "
          f"{[(c['tag'], c['row'], c['step']) for c in tie_checks]}; "
          f"sampled runs repeat; top_k=1 block equal to greedy but at exact "
          f"ties {ties}; speculative (g {GEN_SPEC_G}, the 8B as its own "
          f"draft) {spec_stats} in {spec_s:.2f} s, "
          f"{'equal to greedy' if spec_tie is None else 'a near tie'}; "
          f"HTTP stream and unary equal to (a) in {http}; phase "
          f"{out['phase_s']:.1f} s (s a part: {parts})")
    return out


def generation_int8_part(model, counters, reset, card, bf16_serving):
    """Phase 15 (d) on phase 10's W8A16 model: greedy at tokens_per_fetch
    1 and GEN_TPF, equal; the W8A16 kernel in prefill (wgmma) and decode
    (split-K), in the captured graphs."""
    cfg = model.config
    n_layers = cfg.num_hidden_layers
    per_call = {"rms_norm_residual": 2 * n_layers + 1,
                "rope_apply": 2 * n_layers,
                "weight_only_int8_matmul": 7 * n_layers + 1}
    path = ("rmsn_fwd_kernel<", "rope_kernel<", "w8a16_kernel<")
    t_phase = time.perf_counter()
    ids, mask = _left_pad(_prompts(8, cfg.vocab_size, seed=0))
    b, s = ids.shape
    steps = _gen_steps(model, b, s, GEN_MAX_NEW, False)
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    runs, graphs = _gen_greedy("(d)", model, steps, ids, mask, counters,
                               reset, per_call, path, add,
                               wgmma_per_prefill=7 * n_layers + 1)
    out = dict(
        card=card, prefill_ms=runs[1]["prefill_ms"],
        decode_tokens_per_s={str(k): v["decode_tokens_per_s"]
                             for k, v in runs.items()},
        engine_decode_tokens_per_s=bf16_serving["decode_tokens_per_s"],
        capture_s={str(k): v for k, v in steps.stats["capture_s"].items()},
        cache_bytes=steps.nbytes(), graphs=graphs, launches=total)
    model.__dict__.pop("_gen_step_cache", None)
    _release()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[gen-int8] {card}: generate() on the W8A16 Llama-3-8B ({b} x "
          f"{s}, {GEN_MAX_NEW} new tokens): prefill {out['prefill_ms']:.1f} "
          f"ms; decode {runs[1]['decode_tokens_per_s']:.1f} tok/s at "
          f"tokens_per_fetch 1, {runs[GEN_TPF]['decode_tokens_per_s']:.1f} "
          f"at {GEN_TPF}, equal tokens; capture s {out['capture_s']}; "
          f"graphs {({k: v['kernel_nodes'] for k, v in graphs.items()})}; "
          f"launches {total}; phase {out['phase_s']:.1f} s")
    return out


# -- phase 16: the replica router -----------------------------------------------

# phase 11's geometry with whole-prompt prefill (two monolithic replicas)
ROUTER_GEOM = {k: v for k, v in PREFIX_GEOM.items() if k != "prefill_chunk"}
# phase 13 (c)'s geometry at bf16 KV (the prefill and decode replicas)
HANDOFF_GEOM = dict(FEATURE_GEOM, prefix_cache_pages=512)
ROUTER_SHORT_NEW = 16       # (c)'s requests
ROUTER_EJECT_S = 10.0       # how long (c) waits for the prober to eject


def _prime(eng, vocab):
    """Capture the engine's tick before traffic, on a 15-token prompt: no
    full page, so nothing enters the prefix cache."""
    eng.generate([_prompts(1, vocab, seed=99, lo=15, hi=15)[0]],
                 max_new_tokens=8)


def _stream_lines(port, obj, headers):
    """POST a streamed /generate and return (status, headers, every ndjson
    line), error lines included."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    try:
        conn.request("POST", "/generate", json.dumps({**obj, "stream": True}),
                     {"Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        lines = [json.loads(ln) for ln in resp.read().splitlines()
                 if ln.strip()]
        return resp.status, dict(resp.getheaders()), lines
    finally:
        conn.close()


def _routed_reply(tag, r, handles, vocab, n, rid=None):
    """One routed reply: 200, X-Routed-To a replica (`rid` when given),
    `n` in-vocabulary tokens that its engine recorded for the request."""
    to = r["headers"].get("X-Routed-To")
    req = r["headers"].get("X-Request-Id")
    if r["status"] != 200 or to not in handles or (rid and to != rid):
        raise AssertionError(f"router {tag}: {r['status']}, routed to "
                             f"{to!r}, want {rid or 'a replica'}")
    toks = r["rows"][0]
    _check_tokens(f"router {tag}", [toks], n, vocab)
    if r["rows"] != [handles[to][req].tokens]:
        raise AssertionError(f"router {tag}: the reply is not the tokens "
                             f"{to}'s engine recorded for {req}")
    return to


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def _router_monolithic(model, counters, reset, card, obs, chaos, http_out,
                       prefix_out):
    """(a) two monolithic replicas behind one router, then (c) failover on
    that router."""
    import threading
    from paddle_tpu_torch.inference.router import ReplicaRouter
    from paddle_tpu_torch.inference.serving import PredictorServer
    cfg = model.config
    vocab = cfg.vocab_size
    prompts = _prompts(8, vocab, seed=0)
    wave2 = _prefix_traffic(vocab)[1]
    reset()
    engines = {rid: _engine(model, **ROUTER_GEOM) for rid in ("r0", "r1")}
    handles = {rid: {} for rid in engines}
    servers, router = {}, None
    kill = {}

    def kill_hook(rid):
        # the replica dies: its listener goes (connects and probes fail),
        # its engine's loop stops and every waiter fails, as when the
        # ticker raises (`_fail_all`: the slots return their pages)
        kill.setdefault("t", time.perf_counter())
        kill["rid"] = rid
        servers[rid].stop()
        engines[rid].stop()
        engines[rid]._fail_all(RuntimeError(f"replica {rid} killed"))

    try:
        for rid, eng in engines.items():
            _prime(eng, vocab)
            _record_submits(eng, obs, handles[rid])
            servers[rid] = PredictorServer(lambda d: d, model_name=rid,
                                           generator=eng).start()
        obs.enable(reset=True)
        router = ReplicaRouter(
            [(rid, f"127.0.0.1:{s.port}") for rid, s in servers.items()],
            prefix_page_size=ROUTER_GEOM["page_size"],
            kill_hook=kill_hook).start()
        # (a) wave 1: phase 14's wave through the router
        first = threading.Event()

        def client(i):
            if i == 7 and not first.wait(timeout=HTTP_TIMEOUT):
                raise AssertionError("router: no first streamed line")
            return _generate(
                router.port, {"ids": [prompts[i].tolist()],
                              "max_new_tokens": FEATURE_MAX_NEW,
                              "stream": i % 2 == 0},
                {"X-Request-Id": f"router-{i}",
                 "traceparent": WAVE_TRACEPARENT},
                first if i == 0 else None)
        res = _in_threads([lambda i=i: client(i) for i in range(8)])
        for eng in engines.values():
            _idle(eng, obs)
        wave1_to = []
        for i, r in enumerate(res):
            tp = (r["headers"].get("traceparent") or "").split("-")
            if r["headers"].get("X-Request-Id") != f"router-{i}" \
                    or len(tp) != 4 or tp[1] != "ab" * 16 \
                    or tp[2] == "cd" * 8:
                raise AssertionError(f"router: request {i} echoed "
                                     f"{r['headers'].get('X-Request-Id')!r}"
                                     f" {tp}")
            wave1_to.append(_routed_reply(f"wave 1 request {i}", r,
                                          handles, vocab, FEATURE_MAX_NEW))
        if set(wave1_to) != set(engines):
            raise AssertionError(f"router: wave 1 went to {wave1_to}")
        wall = max(r["t_end"] for r in res) - min(r["t0"] for r in res)
        reg = obs.REGISTRY
        wave1 = dict(
            routed_to=wave1_to, wall_s=wall,
            decode_tokens_per_s=8 * FEATURE_MAX_NEW / wall,
            client_ttft_s=[r["t_first"] - r["t0"] for r in res
                           if r["t_first"]],
            ttft_s={p: reg.histogram("request.ttft.seconds").percentile(p)
                    for p in (50, 99)},
            itl_s={p: reg.histogram("request.itl.seconds").percentile(p)
                   for p in (50, 99)})
        # (a) wave 2: phase 11's shared system prompt, the first request
        # alone, then seven together: they follow it to its replica
        hits = router.metrics.counter("router.prefix.hits")
        if hits.value() != 0:
            raise AssertionError(f"router: {hits.value()} prefix hits in "
                                 "wave 1 (distinct prompts)")

        def sys_req(i):
            return _generate(router.port, {"ids": [wave2[i].tolist()],
                                           "max_new_tokens": PREFIX_MAX_NEW},
                             {"X-Request-Id": f"system-{i}"})
        home = _routed_reply("wave 2 request 0", sys_req(0), handles, vocab,
                             PREFIX_MAX_NEW)
        _idle(engines[home], obs)
        before = {rid: dict(e.stats) for rid, e in engines.items()}
        res2 = _in_threads([lambda i=i: sys_req(i) for i in range(1, 8)])
        for eng in engines.values():
            _idle(eng, obs)
        for i, r in enumerate(res2, 1):
            _routed_reply(f"wave 2 request {i}", r, handles, vocab,
                          PREFIX_MAX_NEW, rid=home)
        got = {rid: {k: e.stats[k] - before[rid][k]
                     for k in ("prefix_hits", "prefix_hit_tokens")}
               for rid, e in engines.items()}
        want = {rid: {"prefix_hits": 7 if rid == home else 0,
                      "prefix_hit_tokens": 7 * SYSTEM_TOKENS
                      if rid == home else 0} for rid in engines}
        if hits.value() != 7 or got != want:
            raise AssertionError(f"router: wave 2 router.prefix.hits "
                                 f"{hits.value()} (want 7), engine hits "
                                 f"{got}, want {want}")
        wave2_out = dict(
            home=home, prefix_stats=engines[home].prefix_stats(),
            prefill_s=(engines[home].stats["prefill_s"]
                       - before[home]["prefill_s"]),
            prefill_calls=(engines[home].stats["prefill_calls"]
                           - before[home]["prefill_calls"]),
            prefill_tokens=(engines[home].stats["prefill_tokens"]
                            - before[home]["prefill_tokens"]))
        # (c) failover: one dropped connect replays on the other replica
        j = 2
        with chaos.scoped(rates={"router.connect.fail": (1.0, 1)}):
            r = _generate(router.port, {"ids": [prompts[j].tolist()],
                                        "max_new_tokens": ROUTER_SHORT_NEW},
                          {"X-Request-Id": "failover-0"})
            fired = chaos.fire_count("router.connect.fail")
        other = next(rid for rid in engines if rid != wave1_to[j])
        _routed_reply("connect.fail", r, handles, vocab, ROUTER_SHORT_NEW,
                      rid=other)
        retries = router.metrics.counter("router.retries").value(
            kind="connect")
        if fired != 1 or retries != 1:
            raise AssertionError(f"router: router.connect.fail fired "
                                 f"{fired}, router.retries{{connect}} "
                                 f"{retries}")
        # (c) a replica killed mid-stream: a prompt pinned to r1 since
        # wave 1 goes back to r1, which dies after the first relayed chunk
        victim = "r1"
        k = wave1_to.index(victim)
        with chaos.scoped(rates={"router.replica.kill": (1.0, 1)}):
            status, _h, lines = _stream_lines(
                router.port, {"ids": [prompts[k].tolist()],
                              "max_new_tokens": FEATURE_MAX_NEW},
                {"X-Request-Id": "kill-0"})
            fired = chaos.fire_count("router.replica.kill")
        relayed = [ln["tokens"][0] for ln in lines if "tokens" in ln]
        last = lines[-1] if lines else {}
        typed = {key: last.get(key) for key in
                 ("reason", "retryable", "replica")}
        if status != 200 or fired != 1 or kill.get("rid") != victim \
                or "error" not in last or typed != {
                    "reason": "replica_failed", "retryable": True,
                    "replica": victim}:
            raise AssertionError(f"router: kill gave {status}, fired "
                                 f"{fired} on {kill.get('rid')}, last line "
                                 f"{last}")
        recorded = handles[victim]["kill-0"].tokens
        if not relayed or relayed != recorded[:len(relayed)] \
                or len(relayed) >= FEATURE_MAX_NEW:
            raise AssertionError(f"router: the killed stream relayed "
                                 f"{len(relayed)} tokens, not a proper "
                                 f"prefix of the {len(recorded)} its engine "
                                 "made")
        t_end = time.perf_counter() + ROUTER_EJECT_S
        while router.replica(victim).in_rotation:
            if time.perf_counter() > t_end:
                raise AssertionError(f"router: {victim} still in rotation "
                                     f"{ROUTER_EJECT_S} s after the kill")
            time.sleep(0.005)
        eject_s = time.perf_counter() - kill["t"]
        _settled_ledger(engines[victim], "router kill")
        if engines[victim].has_work():
            raise AssertionError("router: the killed engine has work left")
        code, view, _h = _http_json(router.port, "/debug/replicas")
        rows = {row["id"]: row for row in view["replicas"]}
        if code != 200 or rows[victim]["in_rotation"] \
                or not rows["r0"]["in_rotation"]:
            raise AssertionError(f"router: /debug/replicas {view}")
        after = _in_threads([
            lambda i=i: _generate(router.port,
                                  {"ids": [prompts[4 + i].tolist()],
                                   "max_new_tokens": ROUTER_SHORT_NEW},
                                  {"X-Request-Id": f"after-{i}"})
            for i in range(4)])
        for i, r in enumerate(after):
            _routed_reply(f"after the kill {i}", r, handles, vocab,
                          ROUTER_SHORT_NEW, rid="r0")
        code, ready, _h = _http_json(router.port, "/readyz")
        if code != 200:
            raise AssertionError(f"router: /readyz {code} {ready}")
        _idle(engines["r0"], obs)
        failover = dict(connect_retries=retries, killed=victim,
                        relayed_tokens=len(relayed),
                        engine_tokens=len(recorded), typed_chunk=last,
                        eject_s=eject_s,
                        eject_reason=rows[victim]["reason"])
        stats = router.stats()
    finally:
        obs.disable()
        if router is not None:
            router.stop()
        for s in servers.values():
            s.stop()
        for eng in engines.values():
            eng.stop()
            eng.__dict__.pop("submit", None)
    launches = _feature_launches("router (a)", counters(),
                                 list(engines.values()),
                                 cfg.num_hidden_layers,
                                 "paged_decode_attention")
    engine_stats = {rid: dict(e.stats) for rid, e in engines.items()}
    del engines, handles, servers, router
    _release()
    out = dict(wave1=wave1, wave2=wave2_out, failover=failover,
               router_stats=stats, engine_stats=engine_stats,
               launches=launches)
    ttft = wave1["client_ttft_s"]
    print(f"[router] {card}: (a) 8 requests x {FEATURE_MAX_NEW} tokens "
          f"through the router to {wave1_to}: decode "
          f"{wave1['decode_tokens_per_s']:.1f} tok/s over the wave's wall "
          f"{wall:.3f} s (phase 14 direct "
          f"{http_out['decode_tokens_per_s']:.1f}); client TTFT of the "
          f"streams p50 {_pct(ttft, 50):.4f} s max {max(ttft):.4f} s "
          f"(phase 14 {[round(x, 4) for x in http_out['client_ttft_s']]}); "
          f"replica TTFT p50 {wave1['ttft_s'][50]:.4f} s p99 "
          f"{wave1['ttft_s'][99]:.4f} s (phase 14 "
          f"{http_out['ttft_s'][50]:.4f} / {http_out['ttft_s'][99]:.4f}), "
          f"ITL p50 {wave1['itl_s'][50]:.5f} s p99 {wave1['itl_s'][99]:.5f} "
          f"s (phase 14 {http_out['itl_s'][50]:.5f} / "
          f"{http_out['itl_s'][99]:.5f}); wave 2: 7 of 7 followed the "
          f"system prompt to {home} (router.prefix.hits 7, engine hits 7 x "
          f"{SYSTEM_TOKENS} tokens), warm prefill {wave2_out['prefill_tokens']}"
          f" tokens in {wave2_out['prefill_s'] * 1e3:.1f} ms over "
          f"{wave2_out['prefill_calls']} calls (phase 11's wave 2 "
          f"{prefix_out['wave2_prefill_s'] * 1e3:.1f} ms); (c) connect.fail "
          f"replayed on {other}; {victim} killed after {len(relayed)} "
          f"relayed tokens, typed chunk {typed}, ejected "
          f"({failover['eject_reason']}) {eject_s * 1e3:.1f} ms after the "
          f"kill, pages back, the next 4 on r0; launches {launches}")
    return out


def _router_handoff(model, counters, reset, card, obs, chaos, ttft_a):
    """(b) a prefill and a decode replica behind their own router: every
    request takes two hops, the decode server pulls the pages over
    /kv/pull and imports them while its captured tick runs."""
    from paddle_tpu_torch.inference.prefix import chain_keys
    from paddle_tpu_torch.inference.router import ReplicaRouter
    from paddle_tpu_torch.inference.serving import PredictorServer
    cfg = model.config
    vocab = cfg.vocab_size
    ps = HANDOFF_GEOM["page_size"]
    prompts = _prompts(8, vocab, seed=0)
    keys = [chain_keys(p, ps, max_pages=(p.size - 1) // ps) for p in prompts]
    reset()
    # each prompt alone on a monolithic engine, over the same two hops: a
    # one-token prefill, then the request warm on its cached pages
    mono = _engine(model, **HANDOFF_GEOM)
    want = []
    for p in prompts:
        mono.generate([p], 1)
        want.append(mono.generate([p], FEATURE_MAX_NEW)[0])
    p0 = _engine(model, role="prefill", host_tier_bytes=HOST_TIER_BYTES,
                 **HANDOFF_GEOM)
    d0 = _engine(model, role="decode", **HANDOFF_GEOM)
    servers, router, log = {}, None, []
    untime = None
    try:
        for rid, eng in (("p0", p0), ("d0", d0)):
            _prime(eng, vocab)
            servers[rid] = PredictorServer(lambda d: d, model_name=rid,
                                           generator=eng).start()
        obs.enable(reset=True)
        router = ReplicaRouter(
            [(rid, f"127.0.0.1:{s.port}") for rid, s in servers.items()],
            prefix_page_size=ps, prefix_max_pages=max(len(k) for k in keys)
        ).start()
        roles = {row["id"]: row["role"]
                 for row in router.debug_replicas()["replicas"]}
        if roles != {"p0": "prefill", "d0": "decode"}:
            raise AssertionError(f"router (b): roles from the probes {roles}")
        untime = _timed(d0, "_disagg_import", log)
        per = []
        for i, p in enumerate(prompts):
            s0 = d0.disagg.snapshot()
            r = _generate(router.port, {"ids": [p.tolist()],
                                        "max_new_tokens": FEATURE_MAX_NEW,
                                        "stream": True},
                          {"X-Request-Id": f"hop-{i}"})
            s1 = d0.disagg.snapshot()
            if r["status"] != 200 or r["headers"].get("X-Routed-To") != "d0" \
                    or r["rows"] != [want[i]]:
                raise AssertionError(
                    f"router (b): request {i} gave {r['status']} from "
                    f"{r['headers'].get('X-Routed-To')}, tokens equal to the "
                    f"monolithic engine's: {r['rows'] == [want[i]]}")
            if s1["pulled_pages"] - s0["pulled_pages"] != len(keys[i]) \
                    or len(log) != i + 1:
                raise AssertionError(f"router (b): request {i} pulled "
                                     f"{s1['pulled_pages'] - s0['pulled_pages']}"
                                     f" of {len(keys[i])} pages in "
                                     f"{len(log) - i} imports")
            per.append(dict(
                pages=len(keys[i]),
                bytes=s1["pulled_bytes"] - s0["pulled_bytes"],
                ttft_s=r["t_first"] - r["t0"],
                pull_ms=(s1["transfer_s"] - s0["transfer_s"]) * 1e3))
        untime()
        untime = None
        torch.cuda.synchronize()
        import_ms = [a.elapsed_time(b) for _, a, b, _ in log]
        for row, (host_s, *_rest), ms in zip(per, log, import_ms):
            row["import_device_ms"] = ms
            row["import_host_ms"] = host_s * 1e3
        snap = d0.disagg.snapshot()
        pulls = obs.REGISTRY.histogram(
            "inference.disagg.transfer_seconds").count()
        handoffs = router.metrics.counter("router.disagg.handoffs").value()
        if handoffs != 8 or pulls != 8 \
                or snap["imported_pages"] != sum(map(len, keys)):
            raise AssertionError(f"router (b): handoffs {handoffs}, pulls "
                                 f"{pulls}, {snap}")
        for i, ks in enumerate(keys):
            src = torch.tensor([p0.prefix_cache.get(k) for k in ks],
                               device=model.device)
            dst = torch.tensor([d0.prefix_cache.get(k) for k in ks],
                               device=model.device)
            if not torch.equal(p0._kv[:, :, src], d0._kv[:, :, dst]):
                raise AssertionError(f"router (b): prompt {i}'s imported "
                                     "pages differ from the prefill "
                                     "replica's")
        # the warm repeat: d0 holds every page, so the hop moves nothing
        for i in (0, 1):
            r = _generate(router.port, {"ids": [prompts[i].tolist()],
                                        "max_new_tokens": FEATURE_MAX_NEW},
                          {"X-Request-Id": f"warm-{i}"})
            if r["headers"].get("X-Routed-To") != "d0" \
                    or r["rows"] != [want[i]]:
                raise AssertionError(f"router (b): warm repeat {i} from "
                                     f"{r['headers'].get('X-Routed-To')}")
        warm = d0.disagg.snapshot()
        if warm["pulled_pages"] != snap["pulled_pages"] \
                or warm["dedup_skipped_pages"] - snap["dedup_skipped_pages"] \
                != len(keys[0]) + len(keys[1]):
            raise AssertionError(f"router (b): the warm repeat pulled: "
                                 f"{snap} -> {warm}")
        # the transfer down: the prefill replica decodes, warm
        with chaos.scoped(rates={"disagg.transfer.fail": 1.0}):
            fb = [_generate(router.port, {"ids": [prompts[i].tolist()],
                                          "max_new_tokens": FEATURE_MAX_NEW},
                            {"X-Request-Id": f"fallback-{i}"})
                  for i in (2, 3)]
        fallbacks = router.metrics.counter("router.disagg.fallbacks").value(
            reason="transfer_fail")
        if fallbacks != 2 or any(
                r["headers"].get("X-Routed-To") != "p0"
                or r["rows"] != [want[i]] for r, i in zip(fb, (2, 3))) \
                or d0.disagg.snapshot()["pulled_pages"] != \
                snap["pulled_pages"]:
            raise AssertionError(
                f"router (b): transfer_fail fallbacks {fallbacks}, routed "
                f"{[r['headers'].get('X-Routed-To') for r in fb]}")
        for eng in (p0, d0):
            _idle(eng, obs)
        stats = router.stats()
    finally:
        if untime is not None:
            untime()
        obs.disable()
        if router is not None:
            router.stop()
        for s in servers.values():
            s.stop()
        for eng in (p0, d0):
            eng.stop()
    launches = _feature_launches("router (b)", counters(), [mono, p0, d0],
                                 cfg.num_hidden_layers,
                                 "paged_decode_attention")
    out = dict(requests=per, disagg_stats=snap,
               prefill_stats=p0.disagg.snapshot(),
               bundle_bytes=sum(r["bytes"] for r in per),
               router_stats=stats, launches=launches,
               engine_stats={"mono": dict(mono.stats),
                             "p0": dict(p0.stats), "d0": dict(d0.stats)})
    del mono, p0, d0, servers, router
    _release()
    ttft = [r["ttft_s"] for r in per]
    print(f"[router] {card}: (b) 8 requests x {FEATURE_MAX_NEW} tokens, one "
          f"at a time, prefill on p0 and decode on d0 (roles from the "
          f"probes): 8 handoffs, {snap['pulled_pages']} pages, "
          f"{out['bundle_bytes']} B pulled, imported pages byte-equal to "
          f"p0's, tokens equal to the monolithic engine's; TTFT through the "
          f"two hops p50 {_pct(ttft, 50):.4f} s max {max(ttft):.4f} s "
          f"((a)'s streams p50 {_pct(ttft_a, 50):.4f} s); per request pull "
          f"ms {[round(r['pull_ms'], 1) for r in per]}, import device ms "
          f"{[round(r['import_device_ms'], 2) for r in per]} (host ms "
          f"{[round(r['import_host_ms'], 2) for r in per]}); the warm "
          f"repeat pulled nothing; disagg.transfer.fail: 2 fallbacks "
          f"decoded on p0, same tokens; launches {launches}")
    return out


def router_phase(model, counters, reset, card, http_out, prefix_out):
    """Phase 16 on phase 5's Llama-3-8B (module doc): (a) two monolithic
    replicas behind one router, (c) failover on it, (b) the two-pool
    handoff behind a second router. Launches go to the path "router"."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import chaos
    t_phase = time.perf_counter()
    mono = _router_monolithic(model, counters, reset, card, obs, chaos,
                              http_out, prefix_out)
    handoff = _router_handoff(model, counters, reset, card, obs, chaos,
                              mono["wave1"]["client_ttft_s"])
    launches = dict(mono["launches"])
    for k, v in handoff["launches"].items():
        launches[k] = launches.get(k, 0) + v
    out = dict(card=card, monolithic=mono, handoff=handoff,
               launches=launches, phase_s=time.perf_counter() - t_phase)
    print(f"[router] {card}: phase 16 {out['phase_s']:.1f} s; launches "
          f"{launches}")
    return out


# -- phase 17: the fleet autopilot and the fleet plane -------------------------

AUTOPILOT_NEW = 16          # each live request's and each probe's new tokens
AUTOPILOT_CLIENTS = 4
# the launcher's /healthz timeout. InProcessLauncher keeps the JAX module's
# 1.0 s default; here a relaunch builds and captures an engine on the
# supervisor's thread while the other replica serves, so the phase passes
# a bound above the /healthz latency (a) measures during that build
AUTOPILOT_PROBE_TIMEOUT_S = 5.0
AUTOPILOT_MEM_SLACK = 64 << 20      # the memory gates' slack, bytes
AUTOPILOT_WAIT_S = 120.0    # the bound of every wait of the phase
FLEET_BEAT_S = 0.2          # each replica's heartbeat interval
FLEET_STALE_S = 1.0         # the aggregator's stale_after_s
AUTOSCALE_TTFT_S = 1e-3     # (e)'s TTFT p95 target: an 8B prefill burns it
FLEET_RANKS = {"r0": 0, "r1": 1}


def _mem():
    return torch.cuda.memory_allocated()


def _ap_blocks():
    """Live allocations by (bytes, stream, pool): what a memory gate that
    fails names."""
    out = {}
    for seg in torch.cuda.memory_snapshot():
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                key = (b["size"], seg["stream"], str(seg.get(
                    "segment_pool_id")))
                out[key] = out.get(key, 0) + 1
    return out


def _ap_mark():
    """(allocated bytes, live blocks) after freeing what was dropped."""
    _release()
    return _mem(), _ap_blocks()


class _Replica:
    """One supervised replica on the card, in the launcher's duck-typed
    contract (start, stop, drain, mark_warming, host, port): a
    PagedKVEngine at FEATURE_GEOM, its tick captured before it takes
    traffic (`_prime`), behind a PredictorServer, with a FleetHeartbeat
    carrying its queue depth when `heartbeat` makes one. stop and drain
    also stop the engine and drop it: the server's own stop leaves its
    generator running, and the pools and the graph pool go back only with
    the engine's last reference."""

    def __init__(self, model, fleet=None, heartbeat=None):
        from paddle_tpu_torch.inference.serving import PredictorServer
        t0 = time.perf_counter()
        self.engine = _engine(model, **FEATURE_GEOM)
        t1 = time.perf_counter()
        _prime(self.engine, model.config.vocab_size)
        self.build_s, self.prime_s = t1 - t0, time.perf_counter() - t1
        # what the launch gate reads; neither holds the engine
        self.spent = types.SimpleNamespace(
            stats=self.engine.stats, steps_per_tick=self.engine.steps_per_tick)
        self.server = PredictorServer(lambda d: d, generator=self.engine,
                                      fleet=fleet)
        self.host, self.port = self.server.host, self.server.port
        self.heartbeat = heartbeat(self.server) if heartbeat else None

    def start(self):
        self.server.start()
        if self.heartbeat is not None:
            self.heartbeat.start()
        return self

    def mark_warming(self):
        self.server.mark_warming()

    def kill(self):
        """Die as phase 16's killed replica does: the listener stops, the
        engine's loop stops and every waiter fails (`_fail_all`)."""
        self.server.stop()
        self.engine.stop()
        self.engine._fail_all(RuntimeError("replica killed"))

    def drain(self, timeout=30.0):
        try:
            return self.server.drain(timeout=timeout)
        finally:
            self._drop()

    def stop(self):
        self.server.stop()
        self._drop()

    def _drop(self):
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.engine is not None:
            self.engine.stop()
            self.server.generator = None
            self.engine = None


class _LiveTraffic:
    """AUTOPILOT_CLIENTS threads streaming /generate requests of phase 5's
    prompts (AUTOPILOT_NEW new tokens) through the router until `stop`;
    each request's outcome is kept: "ok" (every token), "typed" (a typed
    `replica_failed` chunk last, after a prefix of the tokens), "failed"
    (a replica's own 5xx, relayed: its engine failed the request before
    the stream's first line) or "bad"."""

    def __init__(self, port, prompts, tag):
        import threading
        self.port, self.prompts, self.tag = port, prompts, tag
        self.log = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(k,),
                                          daemon=True)
                         for k in range(AUTOPILOT_CLIENTS)]
        for t in self._threads:
            t.start()

    def _run(self, k):
        i = k
        while not self._stop.is_set():
            rid = f"{self.tag}-{k}-{i}"
            t0 = time.perf_counter()
            try:
                status, hdrs, lines = _stream_lines(
                    self.port,
                    {"ids": [self.prompts[i % len(self.prompts)].tolist()],
                     "max_new_tokens": AUTOPILOT_NEW},
                    {"X-Request-Id": rid})
                toks = [ln["tokens"][0] for ln in lines if "tokens" in ln]
                last = lines[-1] if lines else {}
                if status == 200 and "error" not in last \
                        and len(toks) == AUTOPILOT_NEW:
                    kind = "ok"
                elif status == 200 and last.get("reason") == \
                        "replica_failed" and last.get("retryable") is True \
                        and len(toks) < AUTOPILOT_NEW:
                    kind = "typed"
                elif status >= 500 and not toks and "error" in last \
                        and hdrs.get("X-Routed-To"):
                    kind = "failed"
                else:
                    kind = "bad"
                rec = dict(kind=kind, status=status, tokens=len(toks),
                           to=hdrs.get("X-Routed-To"), last=last)
            except Exception as e:      # noqa: BLE001 — the gates read the log
                rec = dict(kind="bad", error=repr(e))
            rec.update(rid=rid, t0=t0, t_end=time.perf_counter())
            with self._lock:
                self.log.append(rec)
            i += AUTOPILOT_CLIENTS

    def count(self, kind="ok", to=None):
        with self._lock:
            return sum(1 for r in self.log if r["kind"] == kind
                       and (to is None or r.get("to") == to))

    def stop(self):
        """Stop and join every client; a client still running after
        AUTOPILOT_WAIT_S is a hung client."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=AUTOPILOT_WAIT_S)
        if any(t.is_alive() for t in self._threads):
            raise AssertionError(f"autopilot {self.tag}: a client hung")
        return list(self.log)


def _ap_wait(cond, tick, what):
    t_end = time.perf_counter() + AUTOPILOT_WAIT_S
    while True:
        if tick is not None:
            tick()
        if cond():
            return
        if time.perf_counter() > t_end:
            raise AssertionError(f"autopilot: timed out waiting for {what}")
        time.sleep(0.005)


def _ap_idle(launcher, obs, slots):
    for slot in slots:
        eng = launcher.server(slot).engine
        _ap_wait(lambda: not eng.has_work(), None, f"{slot} idle")
    _ap_wait(lambda: obs.requests.live_count() == 0, None,
             "no live request")


def _ap_probe_tokens(tag, launcher, slots, want):
    """The probe prompt alone to each slot's own server: its greedy tokens
    must be the cold engine's."""
    probe, toks = want
    for slot in slots:
        r = _generate(launcher.server(slot).port,
                      {"ids": [probe.tolist()],
                       "max_new_tokens": AUTOPILOT_NEW}, {})
        if r["status"] != 200 or r["rows"] != [toks]:
            raise AssertionError(f"autopilot {tag}: {slot} gave "
                                 f"{r['status']} {r['rows']}, want a cold "
                                 f"engine's {toks}")


def _ap_mem(tag, mark, what):
    """Allocated bytes now, within AUTOPILOT_MEM_SLACK of `mark`'s; a miss
    names the blocks that came or went."""
    now, blocks = _ap_mark()
    if abs(now - mark[0]) > AUTOPILOT_MEM_SLACK:
        came = {k: n - mark[1].get(k, 0) for k, n in blocks.items()
                if n > mark[1].get(k, 0)}
        went = {k: n - blocks.get(k, 0) for k, n in mark[1].items()
                if n > blocks.get(k, 0)}
        raise AssertionError(f"autopilot {tag}: {now} B allocated, "
                             f"{(now - mark[0]) / 2**20:.1f} MiB from "
                             f"{what} ({mark[0]} B); blocks (bytes, stream, "
                             f"pool) that came {came}, went {went}")
    return now


def _ap_bundles(fleet, flight_dir, reason):
    out = []
    for b in fleet.flight_records(flight_dir):
        with open(os.path.join(b, "manifest.json")) as f:
            man = json.load(f)
        if man["reason"] == reason:
            out.append((b, man))
    return out


def _ap_kill(ctx):
    """(a) two supervised v1 replicas under live traffic; r0 killed, the
    router ejects it, the supervisor relaunches it through probation."""
    import threading
    router, launcher, sup = ctx.router, ctx.launcher, ctx.sup
    pre = _mem()
    for slot in ("r0", "r1"):
        sup.add_slot(slot, version="v1")
    _ap_wait(lambda: all(sup.slot_state(s) == "serving"
                         for s in ("r0", "r1"))
             and router.in_rotation_count() == 2, ctx.pump,
             "r0 and r1 in rotation")
    engine_bytes = (_ap_mark()[0] - pre) / 2
    # the baseline is taken idle after a first burst of the same traffic:
    # each serving thread's first GEMM leaves a cuBLAS workspace that the
    # process keeps, whichever engine it served (PERF.md §6)
    warm = _LiveTraffic(router.port, ctx.prompts, "warm")
    try:
        _ap_wait(lambda: warm.count() >= 2 * AUTOPILOT_CLIENTS, None,
                 "the warm-up burst")
    finally:
        warm.stop()
    _ap_idle(launcher, ctx.obs, ("r0", "r1"))
    mark_two = _ap_mark()
    traffic = _LiveTraffic(router.port, ctx.prompts, "kill")
    try:
        _ap_wait(lambda: traffic.count() >= AUTOPILOT_CLIENTS, None,
                 "requests before the kill")
        # r1's /healthz latency while r0's relaunch builds and captures
        healthz, done = [], threading.Event()
        port1 = launcher.server("r1").port

        def poll():
            import http.client
            while not done.is_set():
                t0 = time.perf_counter()
                conn = http.client.HTTPConnection("127.0.0.1", port1,
                                                  timeout=HTTP_TIMEOUT)
                try:
                    conn.request("GET", "/healthz")
                    ok = conn.getresponse().status == 200
                except (OSError, http.client.HTTPException):
                    ok = False
                finally:
                    conn.close()
                healthz.append((time.perf_counter() - t0,
                                ctx.building.is_set(), ok))
                time.sleep(0.01)
        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        dead = launcher.server("r0")
        n_built = len(ctx.builds)
        t_kill = time.perf_counter()
        dead.kill()
        _ap_wait(lambda: not router.replica("r0").in_rotation,
                 router.probe_all, "the router to eject r0")
        eject_s = time.perf_counter() - t_kill
        _ap_wait(lambda: sup.slot_state("r0") == "serving"
                 and router.in_rotation_count() == 2
                 and launcher.server("r0") is not dead, ctx.pump,
                 "r0 relaunched and back in rotation")
        rotation_s = time.perf_counter() - t_kill
        after = traffic.count(to="r0")
        _ap_wait(lambda: traffic.count(to="r0") > after, None,
                 "a request on the relaunched r0")
        done.set()
        poller.join(timeout=HTTP_TIMEOUT)
    finally:
        log = traffic.stop()
    relaunch = ctx.builds[n_built:]
    # a request r0 had admitted but not yet streamed gets r0's own 500 with
    # the kill's error, which the router relays and does not replay (a
    # replica's 5xx, router.py `_forward_once`; ROADMAP queue 3): that and
    # the typed chunk are the only failures the kill may cause
    bad = [r for r in log if r["kind"] == "bad"
           or (r["kind"] == "typed" and r["last"].get("replica") != "r0")
           or (r["kind"] == "failed" and (
               r["to"] != "r0" or r["status"] != 500
               or r["last"] != {"error": "replica killed"}))]
    if bad or len(relaunch) != 1 or dead.engine is not None \
            or not all(ok for _, _, ok in healthz):
        raise AssertionError(f"autopilot (a): failed requests {bad[:4]}, "
                             f"relaunches {relaunch}, dead engine dropped "
                             f"{dead.engine is None}, /healthz "
                             f"{[x for x in healthz if not x[2]][:4]}")
    during = [s for s, b, _ in healthz if b] or [0.0]
    if max(during) >= AUTOPILOT_PROBE_TIMEOUT_S:
        raise AssertionError(f"autopilot (a): r1's /healthz took "
                             f"{max(during):.3f} s during the relaunch, the "
                             f"launcher's bound is {AUTOPILOT_PROBE_TIMEOUT_S}")
    m = router.metrics
    restarts = m.counter("autopilot.restarts").value(rid="r0")
    ejected = [(b, man) for b, man in _ap_bundles(ctx.fleet, ctx.flight_dir,
                                                  "replica_ejected")
               if man["extra"]["replica"] == "r0"]
    if restarts != 2 or len(ejected) != 1 \
            or sorted(os.listdir(ejected[0][0])) != sorted(
                ctx.fleet.BUNDLE_FILES):
        raise AssertionError(f"autopilot (a): autopilot.restarts{{r0}} "
                             f"{restarts}, replica_ejected bundles "
                             f"{[b for b, _ in ejected]}")
    _ap_idle(launcher, ctx.obs, ("r0", "r1"))
    _ap_probe_tokens("(a)", launcher, ("r0",), ctx.want["v1"])
    mem_after = _ap_mem("(a)", mark_two, "before the kill")
    out = dict(engine_bytes=engine_bytes, eject_s=eject_s,
               rotation_s=rotation_s,
               build_s=relaunch[0][2], prime_s=relaunch[0][3],
               eject_reason=ejected[0][1]["extra"]["reason"],
               requests=len(log),
               typed=sum(1 for r in log if r["kind"] == "typed"),
               failed_500=sum(1 for r in log if r["kind"] == "failed"),
               healthz_build_s=dict(n=len(during), p50=_pct(during, 50),
                                    max=max(during)),
               healthz_other_max_s=max([s for s, b, _ in healthz if not b]
                                       or [0.0]),
               restart_s=m.histogram("autopilot.restart.seconds").percentile(
                   50),
               mem_two=mark_two[0], mem_after=mem_after)
    print(f"[autopilot] {ctx.card}: (a) r0 killed under {AUTOPILOT_CLIENTS} "
          f"streaming clients: ejected ({out['eject_reason']}) "
          f"{eject_s * 1e3:.1f} ms after the kill, back in rotation after "
          f"{rotation_s:.3f} s (relaunch build {out['build_s']:.3f} s, prime "
          f"and capture {out['prime_s']:.3f} s; autopilot.restart.seconds "
          f"{out['restart_s']:.3f}); {len(log)} requests: {out['typed']} "
          f"ended in r0's typed chunk, {out['failed_500']} got r0's own 500 "
          f"(admitted, not yet streamed), none failed otherwise; r1's /healthz "
          f"during the relaunch p50 {out['healthz_build_s']['p50'] * 1e3:.1f}"
          f" ms max {out['healthz_build_s']['max'] * 1e3:.1f} ms over "
          f"{len(during)} probes (otherwise max "
          f"{out['healthz_other_max_s'] * 1e3:.1f} ms); the relaunched r0's "
          f"probe tokens equal a cold engine's; allocated {mark_two[0]} B before "
          f"the kill, {mem_after} B after the relaunch; a replica_ejected "
          f"bundle")
    return out


def _ap_rollout(ctx):
    """(b) a rolling swap v1 -> v2 under live traffic, min_in_rotation 1."""
    from paddle_tpu_torch.inference.autopilot import (FleetAutopilot,
                                                      RolloutController)
    router, launcher, sup = ctx.router, ctx.launcher, ctx.sup
    samples = []

    def pump():
        ctx.pump()
        samples.append(router.in_rotation_count())
    rc = RolloutController(router, sup, min_in_rotation=1,
                           step_timeout_s=AUTOPILOT_WAIT_S, probe_fn=pump)
    router.attach_autopilot(FleetAutopilot(sup, rollout=rc))
    mark_two = _ap_mark()           # v1 + v2 weights + two engines, idle
    n_built = len(ctx.builds)
    traffic = _LiveTraffic(router.port, ctx.prompts, "roll")
    try:
        _ap_wait(lambda: traffic.count() >= AUTOPILOT_CLIENTS, None,
                 "requests before the rollout")
        t0 = time.perf_counter()
        done = rc.run("v2")
        wave_s = time.perf_counter() - t0
        _ap_wait(lambda: all(sup.slot_state(s) == "serving"
                             for s in ("r0", "r1")), pump,
                 "both slots serving after the wave")
    finally:
        log = traffic.stop()
    st = rc.state()
    failed = [r for r in log if r["kind"] != "ok"]
    completed = router.metrics.counter("autopilot.rollouts").value(
        outcome="completed")
    code, dbg, _h = _http_json(router.port, "/debug/autopilot")
    if not done or st["done"] != ["r0", "r1"] or failed or not samples \
            or min(samples) < 1 or completed != 1 \
            or [v for _s, v, _b, _p in ctx.builds[n_built:]] != ["v2"] * 2 \
            or code != 200 or dbg["rollout"]["state"] != "completed" \
            or router.stats()["rollout"]["version"] != "v2":
        raise AssertionError(f"autopilot (b): run {done}, state {st}, failed "
                             f"{failed[:4]}, in rotation min "
                             f"{min(samples or [None])}, rollouts completed "
                             f"{completed}, builds {ctx.builds[n_built:]}, "
                             f"/debug/autopilot {code}")
    _ap_idle(launcher, ctx.obs, ("r0", "r1"))
    _ap_probe_tokens("(b)", launcher, ("r0", "r1"), ctx.want["v2"])
    mem_after = _ap_mem("(b)", mark_two, "v1 + v2 weights + two engines")
    out = dict(wave_s=wave_s, requests=len(log),
               in_rotation_min=min(samples), samples=len(samples),
               builds=[dict(slot=s, build_s=b, prime_s=p)
                       for s, _v, b, p in ctx.builds[n_built:]],
               mem_after=mem_after)
    print(f"[autopilot] {ctx.card}: (b) rolling swap v1 -> v2 under "
          f"{AUTOPILOT_CLIENTS} streaming clients in {wave_s:.3f} s: "
          f"{len(log)} requests, none failed, in rotation never below "
          f"{min(samples)} over {len(samples)} samples; builds "
          f"{[(s, round(b, 3), round(p, 3)) for s, _v, b, p in ctx.builds[n_built:]]}"
          f"; each slot's probe tokens equal a cold v2 engine's; allocated "
          f"{mem_after} B (v1 + v2 + two engines: {mark_two[0]} B)")
    return out


def _ap_crash_loop(ctx):
    """(c) a third slot whose every launch fails (`autopilot.launch.fail`
    at rate 1): quarantined after exactly crash_loop_restarts attempts."""
    router, sup, chaos = ctx.router, ctx.sup, ctx.chaos
    n_built = len(ctx.builds)
    mem0 = _mem()
    t0 = time.perf_counter()
    with chaos.scoped(rates={"autopilot.launch.fail": 1.0}):
        sup.add_slot("r2", version="v2")
        _ap_wait(lambda: sup.slot_state("r2") == "quarantined", sup.tick,
                 "r2 quarantined")
        fired = chaos.fire_count("autopilot.launch.fail")
    quarantine_s = time.perf_counter() - t0
    for _ in range(5):
        sup.tick()
    m = router.metrics
    got = dict(fired=fired,
               failures=m.counter("autopilot.launch.failures").value(
                   rid="r2"),
               quarantines=m.counter("autopilot.quarantines").value(rid="r2"),
               gauge=m.gauge("autopilot.replicas.quarantined").value(),
               builds=len(ctx.builds) - n_built, state=sup.slot_state("r2"))
    k = sup.crash_loop_restarts
    want = dict(fired=k, failures=k, quarantines=1, gauge=1.0, builds=0,
                state="quarantined")
    crash = _ap_bundles(ctx.fleet, ctx.flight_dir, "replica_crash_loop")
    extra = crash[0][1]["extra"] if len(crash) == 1 else {}
    mem1 = _mem()
    if got != want or extra.get("slot") != "r2" \
            or extra.get("attempts_in_window") != k or mem1 != mem0:
        raise AssertionError(f"autopilot (c): {got}, want {want}; "
                             f"replica_crash_loop bundles {crash}; allocated "
                             f"{mem0} -> {mem1} B")
    sup.remove_slot("r2", stop=False)
    print(f"[autopilot] {ctx.card}: (c) r2 quarantined after exactly {k} "
          f"failed launches in {quarantine_s:.3f} s (no engine built, "
          f"allocated {mem0} B before and after), autopilot.quarantines{{r2}}"
          f" 1, a replica_crash_loop bundle (last error "
          f"{extra.get('last_error')!r})")
    return dict(got, quarantine_s=quarantine_s,
                last_error=extra.get("last_error"))


def _ap_autoscale(ctx):
    """(e) Autoscaler.tick() by hand: a TTFT target the live traffic burns
    scales out to a third engine after burn_ticks; with the traffic
    stopped, the idle streak scales it in."""
    from paddle_tpu_torch.inference.autopilot import Autoscaler
    router, launcher, sup, obs = ctx.router, ctx.launcher, ctx.sup, ctx.obs
    asc = Autoscaler(router, sup, min_replicas=2, max_replicas=3,
                     ttft_p95_target_s=AUTOSCALE_TTFT_S, burn_ticks=2,
                     idle_ticks=3, cooldown_s=0.0, version="v2")
    mark0 = _ap_mark()
    # the TTFT window is a ring of the last observations and does not age:
    # each half starts from an empty registry (ROADMAP queue 3)
    obs.enable(reset=True)

    def ticks(stop_at, limit):
        acts = []
        while len(acts) < limit:
            router.probe_all()
            acts.append(asc.tick())
            if acts[-1] == stop_at:
                break
        return acts
    traffic = _LiveTraffic(router.port, ctx.prompts, "scale")
    try:
        _ap_wait(lambda: traffic.count() >= AUTOPILOT_CLIENTS, None,
                 "requests before the burn")
        burn_sample = asc.signals()
        out_acts = ticks("out", asc.burn_ticks + 2)
        _ap_wait(lambda: sup.slot_state("auto-1") == "serving", ctx.pump,
                 "auto-1 serving")
        after = traffic.count()
        _ap_wait(lambda: traffic.count(to="auto-1") > 0
                 and traffic.count() > after + AUTOPILOT_CLIENTS, ctx.pump,
                 "a request on auto-1")
    finally:
        log = traffic.stop()
    _ap_idle(launcher, obs, ("r0", "r1", "auto-1"))
    three = _mem()
    obs.enable(reset=True)
    in_acts = ticks("in", asc.idle_ticks + 2)
    m = router.metrics
    events = {d: m.counter("autopilot.scale.events").value(direction=d)
              for d in ("out", "in")}
    failed = [r for r in log if r["kind"] != "ok"]
    want_out = ["none"] * (asc.burn_ticks - 1) + ["out"]
    want_in = ["none"] * (asc.idle_ticks - 1) + ["in"]
    if out_acts != want_out or in_acts != want_in \
            or events != {"out": 1, "in": 1} or failed \
            or sup.slot_state("auto-1") is not None \
            or sup.active_slot_count() != 2:
        raise AssertionError(f"autopilot (e): actions {out_acts} then "
                             f"{in_acts}, want {want_out} then {want_in}; "
                             f"scale events {events}; failed {failed[:4]}; "
                             f"auto-1 {sup.slot_state('auto-1')}")
    mem_after = _ap_mem("(e)", mark0, "before the scale-out")
    out = dict(burn_sample=burn_sample, out_actions=out_acts,
               in_actions=in_acts, requests=len(log),
               on_auto=sum(1 for r in log if r.get("to") == "auto-1"),
               build=ctx.builds[-1][2:], mem_three=three,
               mem_after=mem_after)
    print(f"[autopilot] {ctx.card}: (e) TTFT p95 "
          f"{burn_sample['ttft_p95_s']:.4f} s against a target of "
          f"{AUTOSCALE_TTFT_S} s: {out_acts} (auto-1 built in "
          f"{out['build'][0]:.3f} s, primed in {out['build'][1]:.3f} s, "
          f"{out['on_auto']} of {len(log)} requests on it, none failed); "
          f"traffic stopped: {in_acts}; allocated {mark0[0]} B before, {three} "
          f"B with three engines, {mem_after} B after the scale-in")
    return out


def _ap_fleet(ctx):
    """(d) the fleet plane: r0's server answers /debug/fleet with both
    ranks fresh; `fleet.heartbeat.drop` on rank 1 makes it stale; every
    bundle of the phase renders through tools/obs_dump.py."""
    launcher, chaos, fleet = ctx.launcher, ctx.chaos, ctx.fleet
    port0 = launcher.server("r0").port
    seen = {}

    def fresh():
        code, body, _h = _http_json(port0, "/debug/fleet")
        seen.update(code=code, body=body)
        view = body.get("view") or {}
        rows = view.get("ranks", [])
        return code == 200 and body.get("enabled") is True \
            and len(rows) == 2 and all(r["present"] and not r["stale"]
                                       and "queue_depth" in r for r in rows)
    _ap_wait(fresh, None, "two fresh ranks on /debug/fleet")
    r1 = launcher.server("r1")
    victim = r1.heartbeat
    victim.stop()
    dropped, t0 = 0, time.perf_counter()
    while True:
        with chaos.scoped(rates={"fleet.heartbeat.drop": 1.0}):
            if victim.publish() is not False:
                raise AssertionError("autopilot (d): a dropped beat landed")
        dropped += 1
        rank0, rank1 = ctx.agg.scan()["ranks"]
        if rank0["stale"]:
            raise AssertionError(f"autopilot (d): rank 0 went stale {rank0}")
        if rank1["stale"]:
            break
        if time.perf_counter() - t0 > FLEET_STALE_S + 5.0:
            raise AssertionError(f"autopilot (d): rank 1 not stale {rank1}")
        time.sleep(0.01)
    stale_age = rank1["age_s"]
    stale_gauge = ctx.obs.REGISTRY.gauge("fleet.stale_ranks").value()
    if stale_age > FLEET_STALE_S + 0.25 or stale_gauge != 1.0:
        raise AssertionError(f"autopilot (d): rank 1 read stale at age "
                             f"{stale_age} s (limit {FLEET_STALE_S} s), "
                             f"fleet.stale_ranks {stale_gauge}")
    # a stopped heartbeat has closed its store connection where the store
    # has close(): rank 1 beats again through a new one
    r1.heartbeat = ctx.heartbeat(1)(r1.server).start()
    _ap_wait(lambda: not ctx.agg.scan()["ranks"][1]["stale"], None,
             "rank 1 fresh again")
    drains = _ap_bundles(fleet, ctx.flight_dir, "serving_drain")
    bundles = fleet.flight_records(ctx.flight_dir)
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "obs_dump.py")
    reasons = {}
    for b in bundles:
        with open(os.path.join(b, "manifest.json")) as f:
            reason = json.load(f)["reason"]
        run = subprocess.run([sys.executable, tool, b], capture_output=True,
                             text=True, timeout=60)
        if sorted(os.listdir(b)) != sorted(fleet.BUNDLE_FILES) \
                or run.returncode != 0 or reason not in run.stdout:
            raise AssertionError(f"autopilot (d): {b}: files "
                                 f"{sorted(os.listdir(b))}, obs_dump rc "
                                 f"{run.returncode} {run.stderr[-400:]}")
        reasons[reason] = reasons.get(reason, 0) + 1
    if len(drains) < 3 or set(reasons) != {"replica_ejected",
                                           "serving_drain",
                                           "replica_crash_loop"}:
        raise AssertionError(f"autopilot (d): bundles {reasons}")
    out = dict(stale_age_s=stale_age, dropped=dropped, bundles=reasons,
               clone=r1.heartbeat._pub_store is not r1.heartbeat.store,
               view=seen["body"]["view"]["summary"])
    print(f"[autopilot] {ctx.card}: (d) r0's /debug/fleet: 2 fresh ranks "
          f"(beats every {FLEET_BEAT_S} s, on a cloned store connection: "
          f"{out['clone']}); rank 1's beats dropped ({dropped} publishes): "
          f"stale at age {stale_age:.3f} s (stale_after_s {FLEET_STALE_S}), "
          f"rank 0 fresh throughout, fresh again after a restart; bundles "
          f"{reasons}, each with the six files and rendered by "
          f"tools/obs_dump.py (exit 0)")
    return out


def autopilot_phase(model, counters, reset, card):
    """Phase 17 on phase 5's Llama-3-8B (module doc): (a) kill and relaunch,
    (b) a rolling swap to a second 8B, (c) a crash loop, (e) the
    autoscaler, (d) the fleet plane. Launches go to the path
    "autopilot"."""
    import datetime
    import shutil
    import threading
    import torch.distributed as tdist
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.inference.autopilot import (InProcessLauncher,
                                                      ReplicaSupervisor)
    from paddle_tpu_torch.inference.router import ReplicaRouter
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.observability import fleet
    t_phase = time.perf_counter()
    cfg = model.config
    vocab = cfg.vocab_size
    base = _ap_mark()
    t0 = time.perf_counter()
    model2 = LlamaForCausalLM(cfg, device=model.device,
                              dtype=next(model.parameters()).dtype, seed=1)
    torch.cuda.synchronize()
    v2_build_s = time.perf_counter() - t0
    w2 = _mem() - base[0]
    models = {"v1": model, "v2": model2}
    probe = _prompts(1, vocab, seed=21, lo=64, hi=64)[0]
    reset()
    spent, want = [], {}
    for version, m in models.items():
        eng = _engine(m, **FEATURE_GEOM)
        _prime(eng, vocab)
        want[version] = (probe, eng.generate(
            [probe], max_new_tokens=AUTOPILOT_NEW)[0])
        _check_tokens(f"autopilot cold {version}", [want[version][1]],
                      AUTOPILOT_NEW, vocab)
        spent.append(types.SimpleNamespace(stats=eng.stats,
                                           steps_per_tick=eng.steps_per_tick))
        del eng, m
        _release()
    if want["v1"][1] == want["v2"][1]:
        raise AssertionError("autopilot: v1 and v2 gave the same tokens")
    flight_dir = tempfile.mkdtemp(prefix="flight-")
    store = tdist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=10))
    agg = fleet.FleetAggregator(store, 2, stale_after_s=FLEET_STALE_S)
    ctx = types.SimpleNamespace(card=card, obs=obs, chaos=chaos, fleet=fleet,
                                agg=agg, want=want, builds=[],
                                flight_dir=flight_dir,
                                building=threading.Event(),
                                prompts=_prompts(8, vocab, seed=0))

    def heartbeat(rank):
        return lambda srv: fleet.FleetHeartbeat(
            store, rank, 2, interval=FLEET_BEAT_S,
            extra_fn=lambda: {"queue_depth": srv.queue_depth()})

    def factory(slot, version):
        rank = FLEET_RANKS.get(slot)
        ctx.building.set()
        try:
            rep = _Replica(models[version],
                           fleet=agg if slot == "r0" else None,
                           heartbeat=None if rank is None else heartbeat(rank))
        finally:
            ctx.building.clear()
        spent.append(rep.spent)
        ctx.builds.append((slot, version, rep.build_s, rep.prime_s))
        return rep
    obs.enable(reset=True)
    fleet.configure_flight_recorder(dir=flight_dir, max_keep=1000)
    ctx.router = ReplicaRouter().start(probe=False)
    ctx.launcher = InProcessLauncher(
        factory, probe_timeout_s=AUTOPILOT_PROBE_TIMEOUT_S)
    ctx.sup = ReplicaSupervisor(ctx.router, ctx.launcher)
    ctx.pump = lambda: (ctx.router.probe_all(), ctx.sup.tick())
    ctx.heartbeat = heartbeat
    try:
        kill = _ap_kill(ctx)
        rollout = _ap_rollout(ctx)
        crash = _ap_crash_loop(ctx)
        scale = _ap_autoscale(ctx)
        fleet_out = _ap_fleet(ctx)
    finally:
        obs.disable()
        for name in ctx.sup.slot_names():
            ctx.sup.remove_slot(name)
        ctx.router.stop()
        fleet.configure_flight_recorder(dir=None)
        shutil.rmtree(flight_dir, ignore_errors=True)
        del store, agg
    launches = _feature_launches("autopilot", counters(), spent,
                                 cfg.num_hidden_layers,
                                 "paged_decode_attention")
    builds = ctx.builds
    del ctx, models, model2, factory
    # every engine and v2's weights given back: less than half an engine
    # above the phase's start (what stays: cuBLAS workspaces, PERF.md §6)
    end, blocks = _ap_mark()
    if end - base[0] > kill["engine_bytes"] / 2:
        came = {k: n for k, n in blocks.items() if n > base[1].get(k, 0)}
        raise AssertionError(f"autopilot teardown: {end} B allocated, "
                             f"{(end - base[0]) / 2**20:.1f} MiB above the "
                             f"phase's start; blocks that came {came}")
    out = dict(card=card, v2_build_s=v2_build_s, v2_weight_bytes=w2,
               engine_bytes=kill["engine_bytes"],
               kill=kill, rollout=rollout, crash_loop=crash,
               autoscale=scale, fleet=fleet_out, builds=builds,
               launches=launches, mem_end=end,
               mem_end_drift_mib=(end - base[0]) / 2**20,
               phase_s=time.perf_counter() - t_phase)
    print(f"[autopilot] {card}: phase 17 {out['phase_s']:.1f} s (v2 built "
          f"in {v2_build_s:.1f} s, {w2} B; an engine {out['engine_bytes']:.0f}"
          f" B; {len(builds)} replicas built); allocated {end} B at the end, "
          f"{base[0]} B before ({out['mem_end_drift_mib']:.1f} MiB); "
          f"launches {launches}")
    return out


# -- phase 25: the Qwen2-MoE family at Qwen1.5-MoE-A2.7B width ----------------

MOE_GEOM = dict(max_slots=8, page_size=16, num_pages=321,
                max_pages_per_slot=40, steps_per_tick=4, kv_dtype="bf16")
MOE_PROMPT_LENS = (128, 512)    # (a): 8 prompts of this many tokens
MOE_MAX_NEW = 32                # (a), (b): new tokens a request
MOE_LAYER = 12                  # (c): the layer whose MoE inputs are taken
MOE_TRAIN_LAYERS = 2            # (d): the model's depth, of 24
MOE_TRAIN_BATCH = (4, 2048)     # (d): ids a step
MOE_TRAIN_STEPS = 3             # (d): timed steps after the warm-up
# (c): a layer's whole MoE output against its plain version, entry by
# entry (`_check_rows`): four bf16 steps, since each of the three products
# and silu(a) b round once on each side, in other orders (each product
# alone is held to BF16_TOL)
MOE_BF16_TOL = 2 ** -5
# (b): generate's logits, its routing pinned to a cold engine's, within
# this x the RMS of the engine's at the same prefix (RMS of the
# difference); set from the MoE readings on an H100 (sound 0.0158-0.0173,
# the planted decode-position fault 0.128-0.138, the pad-mask fault
# 1.38-1.40), a factor of 3.6 above the one and 2 below the other
MOE_GEN_LOGITS_RMS = 2 ** -4


def _qwen15_moe_config(**overrides):
    """Qwen1.5-MoE-A2.7B's published widths (its config.json: hidden 2048,
    24 layers, 16 heads and 16 kv heads of 128, 60 experts, 4 a token,
    moe_intermediate_size 1408, shared_expert_intermediate_size 5632,
    vocab 151936, rope_theta 1e6, rms_norm_eps 1e-6, untied embeddings),
    on the dropless path (the capacity path would take top-1 at k = 4),
    with the fused RoPE kernel."""
    from paddle_tpu_torch.models.qwen2_moe import Qwen2MoeConfig
    base = dict(vocab_size=151936, hidden_size=2048, intermediate_size=5632,
                num_hidden_layers=24, num_attention_heads=16,
                num_key_value_heads=16, max_position_embeddings=8192,
                rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=False,
                num_experts=60, num_experts_per_tok=4,
                moe_intermediate_size=1408,
                shared_expert_intermediate_size=5632, moe_dropless=True,
                fused_rope=True, seq_length=2048)
    base.update(overrides)
    return Qwen2MoeConfig(**base)


def _moe_zero():
    from paddle_tpu_torch.nn import moe
    for k in moe.launches:
        moe.launches[k] = 0


@contextlib.contextmanager
def _plain_grouped_products():
    """The expert products through their plain per-expert loop, for a
    reference computation (torch._grouped_mm takes bf16 only)."""
    from paddle_tpu_torch.nn import moe
    card = moe.grouped_mm
    moe.grouped_mm = moe.grouped_mm_plain
    try:
        yield
    finally:
        moe.grouped_mm = card


def _moe_serving_part(model, counters, reset, card):
    """(a): 8 prompts through the captured tick, one joining mid-decode;
    launch gates; the eager tick's tokens."""
    from paddle_tpu_torch.nn import moe
    cfg = model.config
    layers = cfg.num_hidden_layers
    prompts = _prompts(8, cfg.vocab_size, seed=25, lo=MOE_PROMPT_LENS[0],
                       hi=MOE_PROMPT_LENS[1])
    _moe_zero()
    reset()
    t0 = time.perf_counter()
    eng, toks = _serve(model, prompts, MOE_MAX_NEW, late=7, **MOE_GEOM)
    wall = time.perf_counter() - t0
    counted, grouped = counters(), dict(moe.launches)
    _check_tokens("moe", toks, MOE_MAX_NEW, cfg.vocab_size)
    if sorted(eng._free) != list(range(1, eng.num_pages)) \
            or eng._reserved_unalloc != 0:
        raise AssertionError(f"moe: pages not returned: free "
                             f"{len(eng._free)}, reserved "
                             f"{eng._reserved_unalloc}")
    if ("tick", False) not in eng._programs or not eng.stats["ticks"]:
        raise AssertionError("moe: the decode tick was not captured")
    st = dict(eng.stats)
    steps = _decode_steps(eng)
    calls = st["prefill_calls"] + steps
    # the decode kernel L a decode step; RoPE 2 L and the grouped products
    # 3 L a model call (decode step or prefill call); the norms are plain
    want = {"paged_decode_attention": layers * steps,
            "paged_decode_attention_int8": 0, "rms_norm_residual": 0,
            "rope_apply": 2 * layers * calls, "weight_only_int8_matmul": 0}
    got = {k: counted[k] for k in want}
    want_g = {"grouped_mm": 3 * layers * calls, "grouped_mm_bwd": 0}
    if got != want or grouped != want_g:
        raise AssertionError(f"moe: launches {got} {grouped}, want {want} "
                             f"{want_g} ({steps} decode steps, "
                             f"{st['prefill_calls']} prefill calls)")
    del eng
    _release()
    eager = _eager_run(model, prompts, MOE_MAX_NEW, MOE_GEOM, toks, "moe")
    out = dict(card=card, prompt_lens=[int(p.size) for p in prompts],
               **_tick_metrics(st),
               prefill_ms=st["prefill_s"] / st["prefill_calls"] * 1e3,
               prefill_calls=st["prefill_calls"],
               prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
               decode_steps=steps, wall_s=wall,
               launches={k: v for k, v in got.items() if v},
               grouped_products=grouped,
               launches_per_step={"paged_decode_attention": layers,
                                  "rope_apply": 2 * layers,
                                  "grouped_mm": 3 * layers},
               eager=eager, tokens=toks)
    print(f"[moe] {card}: (a) Qwen1.5-MoE-A2.7B width, {layers} layers, "
          f"captured tick: prefill {out['prefill_ms']:.2f} ms a call "
          f"({st['prefill_calls']} calls, {out['prefill_tokens_per_s']:.1f} "
          f"tok/s), tick {out['tick_ms']:.2f} ms ({MOE_GEOM['steps_per_tick']}"
          f" steps of 8 slots), decode {out['decode_tokens_per_s']:.1f} "
          f"tok/s; eager tick the same tokens, tick "
          f"{eager['tick_ms']:.2f} ms, decode "
          f"{eager['decode_tokens_per_s']:.1f} tok/s; launches {got} over "
          f"{steps} decode steps and {st['prefill_calls']} prefill calls "
          f"(= the count from the code), grouped products {grouped}")
    return out, prompts


def _moe_generation_part(model, prompts, toks, card):
    """(b) at bf16, `generate` (its captured decode steps) on prompts 0
    and 1 as one left-padded batch:
    - its tokens bit for bit those of the same bodies run eagerly, with
      the same grouped products (the graphs hold nothing else);
    - its logits at each row's prefill and at one teacher-forced decode
      step against a cold engine's at the same prefix (phase 15's
      `_gen_logits_readings`), with generate's routing pinned to the
      engine's (`_moe_pins`): within MOE_GEN_LOGITS_RMS, and the planted
      decode-position and pad-mask faults above it. Unpinned, the two
      paths' bf16 noise flips the routers' top-k choices at many (layer,
      position) pairs of this random model, and each flip moves the
      logits further; those readings are reported;
    - where its tokens leave the engine's, `_moe_divergence`: the
      routers' flips on the common prefix, and the step's logits with
      the routing pinned, which must pick the engine's token (or meet
      a tie in the engine's own logits) within MOE_GEN_LOGITS_RMS.
    `_moe_f32_tokens` holds its tokens equal to the engine's at f32."""
    from paddle_tpu_torch.models import generation
    two = prompts[:2]
    ids, mask = _left_pad(two)
    t0 = time.perf_counter()
    out = generation.generate(model, ids, max_new_tokens=MOE_MAX_NEW,
                              attention_mask=mask)
    secs = time.perf_counter() - t0
    greedy = out[:, ids.shape[1]:].numpy()
    _check_tokens("moe generate", greedy.tolist(), MOE_MAX_NEW,
                  model.config.vocab_size)
    model.__dict__.pop("_gen_step_cache", None)
    with _eager_generation():
        eager = generation.generate(model, ids, max_new_tokens=MOE_MAX_NEW,
                                    attention_mask=mask)
    model.__dict__.pop("_gen_step_cache", None)
    if not torch.equal(eager, out):
        raise AssertionError("moe generate: the captured steps' tokens are "
                             "not the eager bodies'")
    refs = _memo_logits(_ref_logits(model))
    diverge = [_moe_divergence(model, two[r], greedy[r].tolist(), toks[r],
                               refs)
               for r in (0, 1) if greedy[r].tolist() != list(toks[r])]
    free = _gen_logits_readings(model, two, ids, mask, greedy, refs)
    pins = _moe_pins(model, two, ids, greedy, refs)
    with _routes(pins):
        logits = _gen_logits_readings(model, two, ids, mask, greedy, refs)
    _release()
    print(f"[moe] {card}: (b) generate on prompts 0 and 1 (left-padded to "
          f"{ids.shape[1]}, {secs:.2f} s with the captures): the eager "
          f"bodies' tokens bit for bit; with the routing pinned to the "
          f"engine's, logits against a cold engine's {logits['sound']} of "
          f"RMS (limit {MOE_GEN_LOGITS_RMS}), the planted faults at "
          f"{logits['position_fault_min']:.4g} (decode position) and "
          f"{logits['pad_fault_min']:.4g} (pad mask); unpinned "
          f"{free['sound']}, faults {free['position_fault_min']:.4g} and "
          f"{free['pad_fault_min']:.4g}; {len(diverge)} of 2 rows leave "
          f"the engine's tokens")
    res = dict(tokens=greedy.tolist(), eager_bodies_same=True, seconds=secs,
               logits_pinned=logits, logits_unpinned=free,
               divergence=diverge, limit=MOE_GEN_LOGITS_RMS)
    problems = []
    if logits["sound_max"] > MOE_GEN_LOGITS_RMS:
        problems.append(f"with the routing pinned, the logits are "
                        f"{logits['sound_max']:.4g} of RMS from a cold "
                        f"engine's")
    for name in ("position_fault_min", "pad_fault_min"):
        if logits[name] <= MOE_GEN_LOGITS_RMS:
            problems.append(f"a planted fault reads {name} "
                            f"{logits[name]:.4g}: the check is blind")
    for d in diverge:
        if d["rms_pinned"] > MOE_GEN_LOGITS_RMS or not (
                d["pinned_token"] == d["engine_token"] or d["engine_tie"]):
            problems.append(f"the divergence at step {d['step']} is not "
                            f"the routers': {d}")
    if problems:
        raise AssertionError(f"moe gen (limit {MOE_GEN_LOGITS_RMS}): "
                             + "; ".join(problems))
    return res


def _memo_logits(ref_logits):
    """`ref_logits` computing each prefix once (so a later call runs no
    model); its `fresh` always runs the engine (and keeps the result)."""
    seen = {}

    def fresh(ids):
        seen[np.asarray(ids, np.int32).tobytes()] = out = ref_logits(ids)
        return out

    def logits(ids):
        key = np.asarray(ids, np.int32).tobytes()
        return seen[key] if key in seen else fresh(ids)
    logits.fresh = fresh
    return logits


def _moe_pins(model, prompts, ids, greedy, ref_logits):
    """The routes a cold engine takes on each row's prompt + its first
    token (`ref_logits`, `_memo_logits`', so `_gen_logits_readings` runs
    no engine after this), laid out for generate's bodies on the left-padded
    batch `ids`: one (b s, k) array a layer for the prefill call (a
    padded position takes experts 0..k-1), then one (b, k) a layer for
    the decode step; `_routes` pins them call by call, cyclically."""
    layers = model.config.num_hidden_layers
    b, s = ids.shape
    routes = []
    for r in range(b):
        ref_logits(prompts[r].astype(np.int32))
        with _routes() as log:
            ref_logits.fresh(np.concatenate([prompts[r], greedy[r, :1]])
                             .astype(np.int32))
        routes.append(log[:layers])
    k = routes[0][0].shape[1]
    prefill, step = [], []
    for i in range(layers):
        p = np.tile(np.arange(k, dtype=np.int32), (b, s, 1))
        for r in range(b):
            n = prompts[r].size
            p[r, s - n:] = routes[r][i][:n]
        prefill.append(p.reshape(b * s, k))
        step.append(np.stack([routes[r][i][prompts[r].size]
                              for r in range(b)]))
    return prefill + step


@contextlib.contextmanager
def _routes(pinned=None):
    """Every dropless gate's expert ids while the block runs, one (tokens,
    k) int array a call, in call order (a capture in progress is not
    read); with `pinned` (such a list), call i takes pinned[i % n]
    instead of its own top-k, its gates its own probabilities at those
    ids, renormalised."""
    from paddle_tpu_torch.nn import moe
    real = moe.topk_gating_dropless
    log = []

    def gate(logits, k):
        idx, gates, aux = real(logits, k)
        if torch.cuda.is_current_stream_capturing():
            return idx, gates, aux
        if pinned is not None:
            want = pinned[len(log) % len(pinned)]
            if want.shape != tuple(idx.shape):
                raise AssertionError(f"pinned routes {want.shape} for a "
                                     f"gate of {tuple(idx.shape)}")
            idx = torch.from_numpy(want).to(idx.device)
            probs = torch.softmax(logits.float(), dim=-1).gather(
                -1, idx.long())
            gates = probs / probs.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        log.append(idx.cpu().numpy())
        return idx, gates, aux
    moe.topk_gating_dropless = gate
    try:
        yield log
    finally:
        moe.topk_gating_dropless = real


def _moe_divergence(model, prompt, chosen, other, ref_logits):
    """At the first step t where generate's tokens `chosen` leave the
    engine's `other` for `prompt`: the routers of generate's eager bodies
    (this prompt alone, teacher-forced with `chosen`) against a cold
    engine's prefill of the same prefix (prompt + chosen[:t]), every
    layer and position: the (layer, position) pairs whose top-k sets
    differ; the lead of chosen[t] over other[t] in each path's logits at
    t; and generate's logits at t again with its routing pinned to the
    engine's (their RMS difference to the engine's, `_rms_rel`, and the
    token they pick). `ref_logits` is `_memo_logits`'."""
    layers = model.config.num_hidden_layers
    t = _first_diff(chosen, other)
    s = prompt.size
    prefix = np.concatenate([prompt, np.asarray(chosen[:t], np.int32)])
    with _routes() as log:
        ref = np.asarray(ref_logits.fresh(prefix), np.float64)
    engine_ids = [log[i][:prefix.size] for i in range(layers)]
    ids, mask = prompt[None].astype(np.int32), np.ones((1, s), bool)
    forced = np.asarray(chosen, np.int32)[None]
    max_len = s + MOE_MAX_NEW
    with _routes() as log:
        own = _gen_exact_logits(model, ids, mask, forced, max_len,
                                [(0, t)])[(0, t)].astype(np.float64)
    own_ids = [np.concatenate([log[i]] + [log[layers * j + i]
                                          for j in range(1, t + 1)])
               for i in range(layers)]
    pinned = ([engine_ids[i][:s] for i in range(layers)]
              + [engine_ids[i][s + j - 1:s + j]
                 for j in range(1, t + 1) for i in range(layers)])
    with _routes(pinned):
        pin = _gen_exact_logits(model, ids, mask, forced, max_len,
                                [(0, t)])[(0, t)].astype(np.float64)
    flips = [int(np.sum(np.any(np.sort(a, -1) != np.sort(b, -1), -1)))
             for a, b in zip(own_ids, engine_ids)]
    last = [bool(np.any(np.sort(a[-1]) != np.sort(b[-1])))
            for a, b in zip(own_ids, engine_ids)]
    c, o = chosen[t], other[t]
    top = max(abs(ref[c]), abs(ref[o]), 2.0 ** -126)
    out = dict(step=t, positions=int(prefix.size), layers=layers,
               flips=int(sum(flips)), flips_by_layer=flips,
               first_flip_layer=next((i for i, n in enumerate(flips) if n),
                                     None),
               last_position_flips=int(sum(last)),
               lead_generate=float(own[c] - own[o]),
               lead_engine=float(ref[c] - ref[o]),
               engine_tie=bool(abs(ref[c] - ref[o])
                               <= 2.0 ** (np.floor(np.log2(top)) - 7)),
               rms_generate=_rms_rel(own, ref), rms_pinned=_rms_rel(pin, ref),
               pinned_token=int(np.argmax(pin)), engine_token=int(o),
               generate_token=int(c))
    print(f"[moe] divergence at step {t} ({prefix.size} positions x "
          f"{layers} layers): {out['flips']} router flips "
          f"({out['last_position_flips']} at the last position, first at "
          f"layer {out['first_flip_layer']}); lead of {c} over {o}: "
          f"{out['lead_generate']:.4g} (generate), {out['lead_engine']:.4g}"
          f" (engine); logits against the engine's {out['rms_generate']:.4g}"
          f" of RMS, {out['rms_pinned']:.4g} with the routing pinned, "
          f"which picks {out['pinned_token']}")
    return out


@contextlib.contextmanager
def _eager_generation():
    """generate's decode steps run eagerly instead of captured (the
    plain grouped products read their offsets on the host)."""
    from paddle_tpu_torch.models import generation
    capture = generation.capture_graph
    generation.capture_graph = lambda body, device, **kw: body
    try:
        yield
    finally:
        generation.capture_graph = capture


def _moe_f32_tokens(model, prompts, card):
    """(b) at f32, exactly: the 2-layer full-width f32 model, its expert
    products through the plain loop (torch._grouped_mm takes bf16 only),
    served by the engine's eager tick with f32 KV (prompt 1 joining
    mid-decode of prompt 0) and by `generate` (eager steps) on each
    prompt alone: the same greedy tokens."""
    from paddle_tpu_torch.models.generation import generate
    two = prompts[:2]
    with torch.no_grad(), _plain_grouped_products(), _eager_generation():
        eng, toks = _serve(model, two, MOE_MAX_NEW, late=1, eager=True,
                           **dict(MOE_GEOM, kv_dtype=None))
        del eng
        _release()
        got = [[int(x) for x in generate(model, p[None],
                                         max_new_tokens=MOE_MAX_NEW)
                [0, p.size:].tolist()] for p in two]
    _release()
    if got != toks:
        raise AssertionError(f"moe f32: generate's tokens {got} != the "
                             f"engine's {toks}")
    print(f"[moe] {card}: (b) f32, {model.config.num_hidden_layers} layers:"
          f" generate's greedy tokens on prompts 0 and 1 equal the engine's "
          f"(eager tick, prompt 1 joining mid-decode), {MOE_MAX_NEW} each")
    return dict(tokens=toks, same=True)


def _dropless_operands(x, m):
    """(ids, gates, the rows of x sorted by expert, the offsets) of the
    dropless path at MoE layer m, as nn/moe.py `moe_dropless_mlp`
    builds them."""
    from paddle_tpu_torch.nn import moe
    k = m.top_k
    idx, gates, _ = moe.topk_gating_dropless(
        x.float() @ m.router_weight.float(), k)
    order, offsets = moe.sort_by_expert(idx, m.num_experts)
    return idx, gates, x.index_select(0, order // k), offsets


def _capacity_plain(x, m, k):
    """The capacity path with its expert products as a loop of plain
    matmuls, one expert at a time."""
    from paddle_tpu_torch.nn import moe
    combine, dispatch, _ = moe.top2_gating(
        x.float() @ m.router_weight.float(),
        capacity_factor=m.capacity_factor)
    h = moe.moe_dispatch(x, dispatch)
    outs = []
    for e in range(h.shape[0]):
        a = h[e] @ m.experts_gate_weight[e]
        b = h[e] @ m.experts_up_weight[e]
        act = torch.nn.functional.silu(a.float()).to(h.dtype) * b
        outs.append(act @ m.experts_down_weight[e])
    return moe.moe_combine(torch.stack(outs), combine)


def _moe_products_part(model, prompts, card):
    """(c): one layer's MoE on the inputs the served model gives it (the
    post-attention norm's output at MOE_LAYER over 8 prompts' first 128
    tokens: 1024 prefill rows, and their last rows as a decode step's
    8), on the card: the dropless grouped products, each against the
    plain per-expert loop, the whole dropless output, and the capacity
    path at k = 2 against its plain version; the products' ms beside
    their bound."""
    from paddle_tpu_torch.nn import moe
    cfg, dev = model.config, model.device
    layer = model.model.layers[MOE_LAYER]
    m = layer.mlp.moe
    wg, wu, wd = (m.experts_gate_weight, m.experts_up_weight,
                  m.experts_down_weight)
    d, f = cfg.hidden_size, cfg.moe_intermediate_size
    seen = []
    hook = layer.post_attention_layernorm.register_forward_hook(
        lambda mod, inp, out: seen.append(out.detach()))
    ids = np.stack([p[:MOE_PROMPT_LENS[0]] for p in prompts])
    with torch.no_grad():
        model.model(torch.from_numpy(ids).to(dev))
    hook.remove()
    shapes = {"decode": seen[0][:, -1].contiguous(),
              "prefill": seen[0].reshape(-1, d).contiguous()}
    out = {}
    for name, x in shapes.items():
        idx, gates, xs, offs = _dropless_operands(x, m)
        rows = xs.shape[0]
        a = moe.grouped_mm(xs, wg, offs)
        b = moe.grouped_mm(xs, wu, offs)
        act = torch.nn.functional.silu(a.float()).to(x.dtype) * b
        o = moe.grouped_mm(act, wd, offs)
        errs = {}
        for tag, got, lhs, w in (("gate", a, xs, wg), ("up", b, xs, wu),
                                 ("down", o, act, wd)):
            errs[tag] = _check_rows(f"moe {name} {tag}", got,
                                    moe.grouped_mm_plain(lhs, w, offs),
                                    BF16_TOL)
        whole = moe.moe_dropless_mlp(x, wg, wu, wd, idx, gates)
        with _plain_grouped_products():
            whole_ref = moe.moe_dropless_mlp(x, wg, wu, wd, idx, gates)
        errs["dropless"] = _check_rows(f"moe {name} dropless", whole,
                                       whole_ref, MOE_BF16_TOL)
        cap = moe.moe_mlp(x, m.router_weight, wg, wu, wd, k=2,
                          capacity_factor=m.capacity_factor)[0]
        errs["capacity_k2"] = _check_rows(f"moe {name} capacity k=2", cap,
                                          _capacity_plain(x, m, 2),
                                          MOE_BF16_TOL)

        def products(mm, xs=xs, act=act, offs=offs):
            mm(xs, wg, offs)
            mm(xs, wu, offs)
            return mm(act, wd, offs)
        ms = _time_ms(products, [(moe.grouped_mm,)], iters=20)
        plain_ms = _time_eager_ms(products, [(moe.grouped_mm_plain,)])
        touched = int((torch.diff(offs, prepend=offs.new_zeros(1)) > 0)
                      .sum())
        nbytes = 2 * (3 * touched * d * f + rows * (2 * d + 3 * f + d))
        bound_ms, bound_by = _bound(nbytes, 6.0 * rows * d * f,
                                    BF16_TENSOR_FLOPS)
        cap_ms = _time_ms(lambda x=x: moe.moe_mlp(
            x, m.router_weight, wg, wu, wd, k=2,
            capacity_factor=m.capacity_factor), [()], iters=20)
        out[name] = dict(tokens=int(x.shape[0]), rows=rows,
                         experts_touched=touched, bytes=nbytes,
                         products_ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         capacity_k2_ms=cap_ms,
                         max_abs_err={k: v[0] for k, v in errs.items()},
                         err_over_bound={k: v[1] for k, v in errs.items()})
        print(f"[moe] {card}: (c) layer {MOE_LAYER} {name} ({x.shape[0]} "
              f"tokens, {rows} rows, {touched} of {cfg.num_experts} experts"
              f"): the three grouped products {ms:.4f} ms (plain loop "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}: "
              f"{nbytes / 1e6:.1f} MB); capacity path k=2 {cap_ms:.4f} ms; "
              f"max |err| {out[name]['max_abs_err']} (err / bound "
              f"{out[name]['err_over_bound']}; products {BF16_TOL}, whole "
              f"outputs {MOE_BF16_TOL})")
    dec = out["decode"]
    out["decode_step_ms"] = dec["products_ms"] * cfg.num_hidden_layers
    out["decode_step_bound_ms"] = dec["bound_ms"] * cfg.num_hidden_layers
    print(f"[moe] {card}: (c) a decode step's grouped products, layer "
          f"{MOE_LAYER}'s time x {cfg.num_hidden_layers} layers: "
          f"{out['decode_step_ms']:.3f} ms, bound "
          f"{out['decode_step_bound_ms']:.3f} ms")
    return out


def _moe_training_part(dev, prompts, counters, reset, card):
    """(d): the same widths at MOE_TRAIN_LAYERS layers through the Trainer
    (f32 weights from a seed, bf16 compute, AdamW, flash attention, fused
    RoPE) on MOE_TRAIN_BATCH ids, 1 + MOE_TRAIN_STEPS steps; step 1's
    loss against an f32 forward of the same model on the card
    (TRAIN_BF16_LOSS_TOL). Before the Trainer takes the model, (b)'s f32
    token check (`_moe_f32_tokens`)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM
    from paddle_tpu_torch.nn import moe
    from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig
    cfg = _qwen15_moe_config(num_hidden_layers=MOE_TRAIN_LAYERS,
                             use_flash_attention=True, fused_norm=False,
                             recompute=False)
    t0 = time.perf_counter()
    model = Qwen2MoeForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    ids = np.random.RandomState(25).randint(0, cfg.vocab_size,
                                            MOE_TRAIN_BATCH).astype(np.int64)
    ids = torch.from_numpy(ids).to(dev)
    data = {"input_ids": ids, "labels": ids}
    with torch.no_grad(), _plain_grouped_products():
        ref = float(model(**data)[0])
    f32_tokens = _moe_f32_tokens(model, prompts, card)
    opt = topt.AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                     weight_decay=0.01)
    tr = Trainer(model, opt, TrainStepConfig(compute_dtype="bfloat16"))
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _moe_zero()
    reset()
    t0 = time.perf_counter()
    losses = [tr.step(data)]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(MOE_TRAIN_STEPS):
        losses.append(tr.step(data))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, grouped = counters(), dict(moe.launches)
    losses = [float(x) for x in losses]
    steps = MOE_TRAIN_STEPS + 1
    tokens = MOE_TRAIN_BATCH[0] * MOE_TRAIN_BATCH[1]
    want = expected_train_launches(cfg, tokens)
    per_step = {k: launches[k] / steps for k in want}
    layers = cfg.num_hidden_layers
    want_g = {"grouped_mm": 3 * layers * steps,
              "grouped_mm_bwd": 6 * layers * steps}
    rel = abs(losses[0] - ref) / abs(ref)
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses {losses} (finite, falling)")
    if rel > TRAIN_BF16_LOSS_TOL:
        problems.append(f"step 1's loss {losses[0]} against the f32 "
                        f"forward's {ref}: {rel:.3g} relative")
    if per_step != {k: float(v) for k, v in want.items()} \
            or grouped != want_g:
        problems.append(f"launches per step {per_step} {grouped}, want "
                        f"{want} {want_g} over {steps} steps")
    out = dict(card=card, layers=layers, params=n_params,
               batch=list(MOE_TRAIN_BATCH), losses=losses, f32_loss=ref,
               loss_rel=rel, tokens_per_s=tokens * MOE_TRAIN_STEPS / wall,
               step_ms=wall / MOE_TRAIN_STEPS * 1e3, warmup_s=warm,
               build_s=built_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches={k: v for k, v in launches.items() if v},
               launches_per_step=per_step, grouped_products=grouped,
               f32_tokens=f32_tokens)
    print(f"[moe] {card}: (d) {layers} layers ({n_params / 1e9:.3f} B "
          f"params), {MOE_TRAIN_BATCH[0]} x {MOE_TRAIN_BATCH[1]} ids: "
          f"{out['tokens_per_s']:.1f} tokens/s, step {out['step_ms']:.1f} ms"
          f", peak {out['peak_mem_gb']:.2f} GB; losses {losses}; step 1 "
          f"against the f32 forward {ref:.6f}: {rel:.3g} relative (tol "
          f"{TRAIN_BF16_LOSS_TOL}); launches per step {per_step} (= the "
          f"count from the code), grouped products {grouped}")
    del tr, opt, model, data
    _release()
    if problems:
        raise AssertionError("moe training: " + "; ".join(problems))
    return out


def moe_phase(dev, counters, reset, card):
    """Phase 25: the Qwen2-MoE family (models/qwen2_moe.py) at
    Qwen1.5-MoE-A2.7B's width: (a) served at full depth through the
    captured tick, (b) `generate`, (c) the expert products against their
    plain versions, (d) trained at MOE_TRAIN_LAYERS layers."""
    from paddle_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM
    t_phase = time.perf_counter()
    cfg = _qwen15_moe_config()
    t0 = time.perf_counter()
    model = Qwen2MoeForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[moe] Qwen1.5-MoE-A2.7B width bf16 built on the card in "
          f"{time.perf_counter() - t0:.1f} s ({n_params / 1e9:.3f} B params,"
          f" {cfg.num_hidden_layers} layers)")
    out = {"params": n_params}
    out["serving"], prompts = _moe_serving_part(model, counters, reset, card)
    out["generation"] = _moe_generation_part(model, prompts,
                                             out["serving"]["tokens"], card)
    out["products"] = _moe_products_part(model, prompts, card)
    del model
    _release()
    out["training"] = _moe_training_part(dev, prompts, counters, reset,
                                         card)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[moe] {card}: phase 25 {out['seconds']:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace the serving path and one step of each "
                         "training configuration with torch.profiler")
    ap.add_argument("--relaunch-worker", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--dp-worker", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--tp-worker", help=argparse.SUPPRESS)
    ap.add_argument("--fsdp-worker", help=argparse.SUPPRESS)
    ap.add_argument("--overlap-worker", help=argparse.SUPPRESS)
    ap.add_argument("--cp-worker", help=argparse.SUPPRESS)
    ap.add_argument("--pp-worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.relaunch_worker:            # phase 19 (c)'s worker process
        return relaunch_worker(*args.relaunch_worker)
    if args.dp_worker:                  # phase 20's worker processes
        part, outdir = args.dp_worker
        return (dp_worker_a if part == "a" else dp_worker_b)(outdir)
    if args.tp_worker:                  # phase 21 (a)'s worker processes
        return tp_worker(args.tp_worker)
    if args.fsdp_worker:                # phase 22 (a)'s worker processes
        return fsdp_worker(args.fsdp_worker)
    if args.overlap_worker:             # phase 23 (a)'s worker processes
        return overlap_worker(args.overlap_worker)
    if args.cp_worker:                  # phase 23 (b)'s worker processes
        return cp_worker(args.cp_worker)
    if args.pp_worker:                  # phase 24's worker processes
        return pp_worker(args.pp_worker)
    from paddle_tpu_torch.kernels import _build, launch_counters
    from paddle_tpu_torch.kernels import blockwise_ce as bce
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.inference.paged import PagedKVEngine
    from paddle_tpu_torch.nn import functional as fnl

    card = _card()
    print(card)
    dev = torch.device("cuda")
    t_build = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[build] {info['sources']} -> {info['path']} in "
          f"{time.perf_counter() - t_build:.1f} s (compiled: "
          f"{info['built']})")
    for ln in regs:
        print(f"[build] {ln}")

    t_start = time.perf_counter()
    kernels = norm_phases(dev, fn)
    kernels.update(kernel_phases(dev, pa))
    call_ms = _prefill_call_ms(_prompts(8, 128256, seed=0), 7,
                               PagedKVEngine._bucket)
    kernels.update(rope_phases(dev, fn, call_ms[0]))
    kernels.update(int8_kernel_phases(dev, pa, qm, call_ms[0], call_ms[-1]))
    kernels.update(flash_phases(dev, fa))
    kernels.update(ce_phases(dev, bce, fnl))

    def reset():
        for d in launch_counters():
            for k in d:
                d[k] = 0

    def counters():
        return {k: v for d in launch_counters() for k, v in d.items()}

    serving, model = serving_phase(dev, counters, reset, card, args.profile)
    serving_prefix = prefix_serving_phase(dev, model, counters, reset, card,
                                          args.profile)
    serving_spec = spec_serving_phase(model, counters, reset, card, serving,
                                      args.profile)
    features = feature_phase(model, counters, reset, card, serving)
    http = http_phase(model, counters, reset, card, serving)
    generation = generation_phase(model, counters, reset, card, serving,
                                  args.profile)
    router = router_phase(model, counters, reset, card, http, serving_prefix)
    autopilot = autopilot_phase(model, counters, reset, card)
    del model
    _release()
    parity = parity_phase(dev)
    prefix_parity = prefix_parity_phase(dev)
    spec_parity = spec_parity_phase(dev)
    training = training_phase(dev, counters, reset, card, args.profile)
    train_parity = training_parity_phase(dev)
    bench_training = bench_training_phase(dev, counters, reset, card,
                                          args.profile)
    train_obs = training_obs_phase(dev, counters, reset, card,
                                   bench_training)
    train_sentry = sentry_phase(dev, counters, reset, card, bench_training)
    train_dp = dp_phase(card)
    train_tp = tp_phase(card, dev)
    train_fsdp = fsdp_phase(card, dev, counters, reset, train_tp)
    train_ring = ring_phase(card, dev)
    train_pp = pipeline_phase(card)
    serving_int8, model = int8_serving_phase(dev, counters, reset, card,
                                             serving, args.profile)
    serving_spec["c"] = spec_int8_part(model, counters, reset, card,
                                       args.profile)
    generation_int8 = generation_int8_part(model, counters, reset, card,
                                           serving)
    del model
    _release()
    moe_out = moe_phase(dev, counters, reset, card)
    for name, e in kernels.items():
        by_path = {"serving": serving["launches"].get(name, 0),
                   "serving_prefix": serving_prefix["launches"].get(name, 0),
                   "serving_spec": sum(part["launches"].get(name, 0)
                                       for part in serving_spec.values()),
                   "training": training["launches"].get(name, 0),
                   "training_bench": bench_training["launches"].get(name, 0),
                   "training_obs": train_obs["obs"]["launches"].get(name, 0),
                   "training_ckpt": train_obs["launches"].get(name, 0),
                   "training_sentry": train_sentry["launches"].get(name, 0),
                   "training_dp": train_dp["launches"].get(name, 0),
                   "training_tp": train_tp["launches"].get(name, 0),
                   "training_fsdp": train_fsdp["launches"].get(name, 0),
                   "training_offload": train_fsdp["offload_launches"].get(
                       name, 0),
                   "training_overlap": train_ring["launches"][
                       "overlap"].get(name, 0),
                   "training_cp_ring": train_ring["launches"]["ring"].get(
                       name, 0),
                   "training_cp_ulysses": train_ring["launches"][
                       "ulysses"].get(name, 0),
                   "training_pp": train_pp["launches"].get(name, 0),
                   "serving_int8": serving_int8["launches"].get(name, 0),
                   **{path: features[path]["launches"].get(name, 0)
                      for path in ("tenancy", "kvtier", "disagg")},
                   "http": http["launches"].get(name, 0),
                   "generation": generation["launches"].get(name, 0),
                   "generation_int8": generation_int8["launches"].get(name,
                                                                      0),
                   "router": router["launches"].get(name, 0),
                   "autopilot": autopilot["launches"].get(name, 0),
                   "serving_moe": moe_out["serving"]["launches"].get(name,
                                                                     0),
                   "training_moe": moe_out["training"]["launches"].get(
                       name, 0)}
        if sum(by_path.values()) <= 0:
            raise AssertionError(f"{name} was launched on no main path")
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        if name in train_tp["b"]["kernels"]:
            e["vocab_shard"] = train_tp["b"]["kernels"][name]
    now = time.perf_counter()
    print(f"[time] build {t_start - t_build:.1f} s, phases "
          f"{now - t_start:.1f} s, total {now - t_build:.1f} s")
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    line = {"kernels": [{**{k: e[k] for k in order},
                         **{k: v for k, v in e.items() if k not in order}}
                        for e in kernels.values()]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": line["kernels"],
                       "serving": serving, "parity": parity,
                       "serving_prefix": serving_prefix,
                       "prefix_parity": prefix_parity,
                       "training": training, "train_parity": train_parity,
                       "training_bench": bench_training,
                       "training_obs": train_obs,
                       "training_sentry": train_sentry,
                       "training_dp": train_dp,
                       "training_tp": train_tp,
                       "training_fsdp": train_fsdp,
                       "training_ring": train_ring,
                       "training_pp": train_pp,
                       "serving_int8": serving_int8,
                       "serving_spec": serving_spec,
                       "spec_parity": spec_parity,
                       "features": features, "http": http,
                       "generation": generation,
                       "generation_int8": generation_int8,
                       "router": router, "autopilot": autopilot,
                       "moe": moe_out,
                       "torch": torch.__version__}, f, indent=1)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
