"""Partial freeze by parameter name (JAX: flipped_tpu/train/optim.py:29-41).

Trainables (adapter, gates, temporal_emb, the projections) are f32 and
the frozen backbone bf16. The optimizer and schedule come with the training
slice.
"""
from __future__ import annotations

TRAINABLE_MARKERS = ("gate", "adapter", "temporal_emb", "visual_proj",
                     "audio_proj", "video_audio_cross_attn")


def is_trainable(name: str) -> bool:
    return any(m in name for m in TRAINABLE_MARKERS)
