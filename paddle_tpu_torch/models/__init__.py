"""Models of the port, and static-cache generation over them."""
from paddle_tpu_torch.models.generation import (generate,
                                                generate_speculative,
                                                generate_stream,
                                                init_kv_cache, process_logits)

__all__ = ["generate", "generate_stream", "generate_speculative",
           "init_kv_cache", "process_logits"]
