"""Models of the port (``paddle_tpu.models`` counterparts)."""

from .bert import (BertConfig, BertForMaskedLM, BertForSequenceClassification,
                   BertModel, bert_base, bert_tiny)
from .convert import load_paddle_tpu_state_dict, to_numpy_state_dict
from .deepfm import DeepFM, deepfm_criteo
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, LlamaMoE,
                    StaticKVCache, greedy_tokens_in_graph, llama_1b,
                    llama_7b, llama_13b, llama_125m, llama_small, llama_tiny,
                    sample_next_tokens)

__all__ = ["BertConfig", "BertForMaskedLM", "BertForSequenceClassification",
           "BertModel", "DeepFM", "LlamaConfig", "LlamaForCausalLM",
           "LlamaModel", "LlamaMoE", "StaticKVCache", "bert_base", "bert_tiny",
           "deepfm_criteo", "greedy_tokens_in_graph",
           "load_paddle_tpu_state_dict", "llama_1b", "llama_7b", "llama_13b",
           "llama_125m", "llama_small", "llama_tiny", "sample_next_tokens",
           "to_numpy_state_dict"]
