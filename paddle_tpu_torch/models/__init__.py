"""Models of the port, and static-cache generation over them.

The model classes load on first use (`Qwen2MoeForCausalLM` here, or
`paddle_tpu_torch.models.llama` / `.qwen2_moe` directly): the models
import inference/paged.py, which imports this package's generation
module.
"""
from paddle_tpu_torch.models.generation import (generate,
                                                generate_speculative,
                                                generate_stream,
                                                init_kv_cache, process_logits)

__all__ = ["generate", "generate_stream", "generate_speculative",
           "init_kv_cache", "process_logits", "Qwen2MoeConfig",
           "Qwen2MoeForCausalLM"]


def __getattr__(name):
    if name in ("Qwen2MoeConfig", "Qwen2MoeForCausalLM"):
        from paddle_tpu_torch.models import qwen2_moe
        return getattr(qwen2_moe, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
