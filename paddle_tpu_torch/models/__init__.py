"""Models of the port (``paddle_tpu.models`` counterparts)."""

from .convert import load_paddle_tpu_state_dict, to_numpy_state_dict
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    greedy_tokens_in_graph, llama_1b, llama_7b, llama_13b,
                    llama_125m, llama_small, llama_tiny, sample_next_tokens)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "greedy_tokens_in_graph", "load_paddle_tpu_state_dict",
           "llama_1b", "llama_7b", "llama_13b", "llama_125m", "llama_small",
           "llama_tiny", "sample_next_tokens", "to_numpy_state_dict"]
