"""Padding, label construction, and label masking — pure numpy.

The port's own copy of flipped_tpu/text/masking.py, kept here so that
flipped_tpu_torch imports nothing of the JAX package; tests hold the
two copies equal.

Behavioral re-implementation of the reference's BaseDataset._get_text_token /
_get_padding_id (reference: dataloader/base_dataset.py:17-174) and the
dialogue-aware middle truncation of VLEP/TVQA (reference:
dataloader/vlep.py:73-101, dataloader/tvqa.py:75-108), producing one uniform
item contract for all seven datasets (fixing the reference's STAR/DramaQA
5-vs-6 unpack break and the VLEP/TVQA missing prefix_index, SURVEY.md §2).

Semantics to note (and preserved here):
  * Sequences are padded with -1, then negatives are zeroed into `text_id`
    while `label` keeps 0 as the ignore value for VQA/VAQ — the pad id 0
    doubles as the CE ignore_index (reference: model.py:233-234).
  * QAV labels are -1 (ignored) everywhere except the video span, which gets
    frame indices 0..F-1 (reference: base_dataset.py:80-95).
  * `video_index` is arange(prefix, prefix+F) for every objective — for
    VQA/VAQ this is the *supervision* span, not the video span; only QAV's is
    a real video position (the model splices VQA/VAQ by `video_start`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .prompts import (PromptText, encode_dqav, encode_dvaq, encode_dvqa,
                      encode_qav, encode_vaq, encode_vqa)
from .tokenizer import TokenizerLike

OBJECTIVES = ("vqa", "vaq", "qav")


@dataclass
class TextFeatures:
    """Per-example tokenized features for all three objectives."""

    text_id: Dict[str, np.ndarray]      # (n_seq, S) int32
    label: Dict[str, np.ndarray]        # (n_seq, S) int32
    label_mask: Dict[str, np.ndarray]   # (n_seq, S) float32
    video_start: Dict[str, int]
    video_index: Dict[str, np.ndarray]  # (F,) int32
    prefix_index: Dict[str, int]


def pad_ids(token_lists: List[List[int]], max_seq_len: int) -> np.ndarray:
    """Pad each sequence with -1 to max_seq_len, truncating overflow
    (reference: base_dataset.py:17-28)."""
    out = np.full((len(token_lists), max_seq_len), -1, dtype=np.int32)
    for i, tid in enumerate(token_lists):
        n = min(len(tid), max_seq_len)
        out[i, :n] = tid[:n]
        if len(tid) > max_seq_len:
            # Truncation can drop the supervision span entirely
            # (reference prints the same warning, base_dataset.py:27).
            print("max sequence length overflow")
    return out


def lm_labels(padded: np.ndarray, prefix_index: int):
    """VQA/VAQ label + mask: ignore everything before prefix_index and all
    padding (reference: base_dataset.py:63-77)."""
    label = padded.copy()
    label[:, :prefix_index] = -1
    mask = label >= 0
    label = np.where(mask, label, 0)
    return label.astype(np.int32), mask.astype(np.float32)


def qav_labels(padded: np.ndarray, prefix_index: int, max_feats: int):
    """QAV label: frame ordering targets on the video span, -1 elsewhere
    (reference: base_dataset.py:80-95)."""
    label = np.full_like(padded, -1)
    seq_len = padded.shape[1]
    range_limit = min(max(seq_len - prefix_index, 0), max_feats)
    if range_limit > 0:
        label[:, prefix_index:prefix_index + range_limit] = np.arange(range_limit)
    mask = np.zeros_like(padded, dtype=np.float32)
    if prefix_index < seq_len:
        mask[:, prefix_index] = 1.0
    return label.astype(np.int32), mask


def sanitize_text_id(padded: np.ndarray) -> np.ndarray:
    """Zero out the -1 padding and the -2 video placeholders
    (reference: base_dataset.py:97-104)."""
    return np.where(padded >= 0, padded, 0).astype(np.int32)


def build_text_features(tok: TokenizerLike, text: PromptText,
                        max_feats: int = 10, max_seq_len: int = 128,
                        split: str = "train",
                        answer_mapping: Optional[Dict[int, str]] = None,
                        answer: int = 0,
                        generation: bool = False) -> TextFeatures:
    """The uniform equivalent of BaseDataset._get_text_token
    (reference: base_dataset.py:30-174)."""
    vqa_t, vqa_prefix, vqa_vs = encode_vqa(
        tok, text, max_feats, split, answer_mapping, answer, generation)
    vaq_t, vaq_prefix, vaq_vs = encode_vaq(
        tok, text, max_feats, split, answer_mapping, answer, generation)
    qav_t, qav_prefix = encode_qav(
        tok, text, max_feats, split, answer_mapping, answer, generation)

    vqa_pad = pad_ids(vqa_t, max_seq_len)
    vaq_pad = pad_ids(vaq_t, max_seq_len)
    qav_pad = pad_ids(qav_t, max_seq_len)

    vqa_label, vqa_mask = lm_labels(vqa_pad, vqa_prefix)
    vaq_label, vaq_mask = lm_labels(vaq_pad, vaq_prefix)
    qav_label, qav_mask = qav_labels(qav_pad, qav_prefix, max_feats)

    def vindex(prefix):
        return np.arange(prefix, prefix + max_feats, dtype=np.int32)

    return TextFeatures(
        text_id={"vqa": sanitize_text_id(vqa_pad),
                 "vaq": sanitize_text_id(vaq_pad),
                 "qav": sanitize_text_id(qav_pad)},
        label={"vqa": vqa_label, "vaq": vaq_label, "qav": qav_label},
        label_mask={"vqa": vqa_mask, "vaq": vaq_mask, "qav": qav_mask},
        video_start={"vqa": vqa_vs, "vaq": vaq_vs, "qav": qav_prefix},
        video_index={"vqa": vindex(vqa_prefix), "vaq": vindex(vaq_prefix),
                     "qav": vindex(qav_prefix)},
        prefix_index={"vqa": vqa_prefix, "vaq": vaq_prefix, "qav": qav_prefix},
    )


# --- dialogue variants with middle truncation (VLEP/TVQA) --------------------

def pad_ids_dialogue(token_lists: List[List[int]], prefix_index: int,
                     prefix_i: int, prefix_main: int, kind: str,
                     max_seq_len: int, max_feats: int, sub: bool,
                     split: str, tok: TokenizerLike):
    """Middle-truncation that preserves the instruction head and the QA tail,
    dropping overflow from the dialogue middle, recomputing prefix_index
    (reference: vlep.py:73-101, tvqa.py:75-108)."""
    out = np.full((len(token_lists), max_seq_len), -1, dtype=np.int64)
    prefix = prefix_index
    for i, tid in enumerate(token_lists):
        if len(tid) <= max_seq_len:
            out[i, :len(tid)] = tid
            prefix = prefix_index
        elif sub and prefix_i != prefix_main:
            tail = len(tid) - prefix_main
            keep = max_seq_len - (prefix_i + tail)
            if prefix_i + keep >= 0:
                # reference semantics (vlep.py:84-88): the QA tail always
                # survives in full; with keep < 0 it overwrites the END of
                # the instruction/video head (write order matters)
                out[i, :prefix_i] = tid[:prefix_i]
                k = max(keep, 0)
                out[i, prefix_i:prefix_i + k] = tid[prefix_i:prefix_i + k]
                out[i, prefix_i + keep:] = tid[prefix_main:]
            else:
                # the QA tail ALONE exceeds max_seq_len — the reference's
                # arithmetic would crash on a length-mismatched assignment;
                # keep the tail's end (answer + eos)
                out[i] = tid[-max_seq_len:]
            if kind == "vqa":
                prefix = max_seq_len - 4
            elif kind == "vaq":
                hits = np.argwhere(out[i] == tok.q_token_id)
                prefix = (int(hits[0, 0]) + 2 if hits.size
                          else min(prefix_i, max_seq_len - 1))
            else:
                prefix = max_seq_len - max_feats - 1
        else:
            out[i] = tid[:max_seq_len]
            prefix = prefix_index
    return out.astype(np.int32), prefix


def build_dialogue_text_features(tok: TokenizerLike, text: PromptText,
                                 max_feats: int = 10, max_seq_len: int = 128,
                                 split: str = "train",
                                 answer_mapping: Optional[Dict[int, str]] = None,
                                 answer: int = 0,
                                 sub: bool = True) -> TextFeatures:
    """VLEP/TVQA _get_text_token equivalent (reference: vlep.py:104-154,
    tvqa.py:110-160), with prefix_index included in the contract."""
    vqa_t, vqa_prefix, vqa_vs, vqa_pi, vqa_pm = encode_dvqa(
        tok, text, max_feats, split, answer_mapping, answer)
    vaq_t, vaq_prefix, vaq_vs, vaq_pi, vaq_pm = encode_dvaq(
        tok, text, max_feats, split, answer_mapping, answer)
    qav_t, qav_prefix, qav_pi, qav_pm = encode_dqav(
        tok, text, max_feats, split, answer_mapping, answer)

    vqa_pad, vqa_prefix = pad_ids_dialogue(
        vqa_t, vqa_prefix, vqa_pi, vqa_pm, "vqa", max_seq_len, max_feats, sub, split, tok)
    vaq_pad, vaq_prefix = pad_ids_dialogue(
        vaq_t, vaq_prefix, vaq_pi, vaq_pm, "vaq", max_seq_len, max_feats, sub, split, tok)
    qav_pad, qav_prefix = pad_ids_dialogue(
        qav_t, qav_prefix, qav_pi, qav_pm, "qav", max_seq_len, max_feats, sub, split, tok)

    vqa_label, vqa_mask = lm_labels(vqa_pad, vqa_prefix)
    vaq_label, vaq_mask = lm_labels(vaq_pad, vaq_prefix)
    qav_label, qav_mask = qav_labels(qav_pad, qav_prefix, max_feats)

    def vindex(prefix):
        return np.arange(prefix, prefix + max_feats, dtype=np.int32)

    return TextFeatures(
        text_id={"vqa": sanitize_text_id(vqa_pad),
                 "vaq": sanitize_text_id(vaq_pad),
                 "qav": sanitize_text_id(qav_pad)},
        label={"vqa": vqa_label, "vaq": vaq_label, "qav": qav_label},
        label_mask={"vqa": vqa_mask, "vaq": vaq_mask, "qav": qav_mask},
        video_start={"vqa": vqa_vs, "vaq": vaq_vs, "qav": qav_prefix},
        video_index={"vqa": vindex(vqa_prefix), "vaq": vindex(vaq_prefix),
                     "qav": vindex(qav_prefix)},
        prefix_index={"vqa": vqa_prefix, "vaq": vaq_prefix, "qav": qav_prefix},
    )
