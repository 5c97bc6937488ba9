"""One program captured as a CUDA graph, with the kernel launches it makes.

The kernel wrappers count their launches on the host, which a replay
does not run: `capture_graph` takes the capture's counts back out of the
counters, and each call of the returned program replays the graph and
adds them again. The capture's counts are the capturing thread's own
(`kernels.capture_tally`): another engine's ticker launching meanwhile
does not enter them. The warm-up run before the capture is real and
stays counted. Used by the paged engine's tick (inference/paged.py) and by the
static-cache generation steps (models/generation.py).
"""
from __future__ import annotations

import torch

__all__ = ["CapturedProgram", "capture_graph"]


class CapturedProgram:
    """A captured graph and the counts its capture took (`delta`:
    (counter, name, launches) triples). The graph is kept beside its
    instantiation (`keep_graph`), so its kernel nodes can be listed
    (`graph.debug_dump`). `pool_bytes`: the device memory the allocator
    reserved during the capture, the graph's pool when it is its own."""

    def __init__(self, graph, delta, pool_bytes=0):
        self.graph = graph
        self.delta = delta
        self.pool_bytes = pool_bytes

    def __call__(self):
        self.graph.replay()
        for counter, name, n in self.delta:
            counter.add(name, n)


def capture_graph(body, device, pool=None, generator=None):
    """Run `body()` once on a side stream (the warm-up a capture wants),
    then capture it into a CUDA graph on `device` (in `pool` when given)
    and instantiate it. `generator`, a CUDA torch.Generator that `body`
    draws from, is registered with the graph, so each replay draws anew.
    The capture is thread-local, so a worker thread may capture; a
    capture that fails raises."""
    from paddle_tpu_torch.kernels import capture_tally
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        body()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    if generator is not None:
        graph.register_generator_state(generator)
    # the capture empties the allocator's cache as it starts; emptied
    # first, the reserved bytes grow by the graph's pool alone
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    tally = []
    try:
        with capture_tally() as tally, torch.cuda.graph(
                graph, pool=pool, capture_error_mode="thread_local"):
            body()
    finally:
        sums = {}
        for c, k, n in tally:
            key = (id(c), k)
            sums[key] = (c, k, n + (sums[key][2] if key in sums else 0))
        delta = [t for t in sums.values() if t[2]]
        for c, k, n in delta:
            c.add(k, -n)
    graph.instantiate()
    return CapturedProgram(graph, delta,
                           torch.cuda.memory_reserved(device) - reserved)
