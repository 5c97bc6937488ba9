"""Hand-written CUDA kernels for Hopper, each beside its plain twin.

Sources live in `csrc/`; `_build.load_library()` compiles them with nvcc
for sm_90a at first use. Importing this package (or any module in it)
builds nothing, so the CPU can import everything.
"""


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
