from .attention import (NEG_INF, adapter_gated_attention,
                        adapter_prefix_attention, chunk_extend_attention,
                        decode_attention, video_block_bias)
from .kernels.flash_attention import (flash_adapter_attention,
                                      flash_text_attention,
                                      flash_text_attention_ref)
from .layers import (apply_rope, apply_rope_at, ffn_hidden_size,
                     precompute_rope, rms_norm, swiglu)
from .llama import (Attention, Embedding, FeedForward, FlippedVQAModel,
                    Linear, RMSNorm, TransformerBlock)

__all__ = [
    "NEG_INF", "adapter_gated_attention", "adapter_prefix_attention",
    "chunk_extend_attention", "decode_attention", "video_block_bias", "flash_adapter_attention",
    "flash_text_attention", "flash_text_attention_ref", "apply_rope",
    "apply_rope_at", "ffn_hidden_size", "precompute_rope", "rms_norm",
    "swiglu", "Attention", "Embedding", "FeedForward", "FlippedVQAModel",
    "Linear", "RMSNorm", "TransformerBlock",
]
