"""Hand-written CUDA kernels for Hopper, each beside its plain twin.

Sources live in `csrc/`; `_build.load_library()` compiles them with nvcc
for sm_90a at first use. Importing this package (or any module in it)
builds nothing, so the CPU can import everything.
"""
import contextlib
import threading

_capture = threading.local()


class LaunchCounter(dict):
    """One module's launch counts (kernel -> launches). A wrapper calls
    `add` where it launches its kernel, and nowhere else. While a thread
    captures a CUDA graph (`capture_tally`), what it adds is also tallied
    for that thread alone, so a capture's counts stay its own when another
    thread launches meanwhile."""

    _lock = threading.Lock()

    def add(self, name, n=1):
        with self._lock:
            self[name] += n
        tally = getattr(_capture, "tally", None)
        if tally is not None:
            tally.append((self, name, n))


@contextlib.contextmanager
def capture_tally():
    """This thread's launches while the block runs, as (counter, name, n)
    triples."""
    prev = getattr(_capture, "tally", None)
    _capture.tally = tally = []
    try:
        yield tally
    finally:
        _capture.tally = prev


def launch_counters():
    """Every kernel wrapper's launch counter: one dict (kernel -> launches)
    for each module of this package. A wrapper adds one where it launches
    its kernel, and nowhere else."""
    from paddle_tpu_torch.kernels import (blockwise_ce, flash_attention,
                                          fused_norm, paged_attention,
                                          quant_matmul)
    return (paged_attention.launches, fused_norm.launches,
            quant_matmul.launches, flash_attention.launches,
            blockwise_ce.launches)
