"""Pure prompt encoders for the three flipped objectives.

The port's own copy of flipped_tpu/text/prompts.py, kept here so that
flipped_tpu_torch imports nothing of the JAX package; tests hold the
two copies equal.

Behavioral re-implementation of the reference's prompt construction
(reference: llama/tokenizer.py:44-303) as pure functions over a tokenizer
backend, so they are unit-testable with golden token sequences and run inside
CPU data workers.

Each encoder returns `(token_lists, prefix_index, ...)` where:
  * token_lists — one list of token ids per candidate sequence (1 at train
    time; one per answer option at eval, reference: tokenizer.py:71-75);
    video slots are marked with the placeholder id -2.
  * prefix_index — where supervision starts: the answer span for VQA
    (position of "Answer" + 5, i.e. just past ": The answer is "), the
    question span for VAQ ("Question" + 2), the video span for QAV
    ("Video" + 2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .tokenizer import TokenizerLike

VIDEO_PLACEHOLDER = -2

VQA_INSTRUCTION = "Instruction: Predict the answer based on the video and question.\n"
VAQ_INSTRUCTION = "Instruction: Predict the question based on the video and answer.\n"
QAV_INSTRUCTION = "Instruction: Predict the video based on the question and answer.\n"
DVQA_INSTRUCTION = "Instruction: Predict the answer based on the dialogue, video and question.\n"
DVAQ_INSTRUCTION = "Instruction: Predict the question based on the dialogue, video and answer.\n"
DQAV_INSTRUCTION = "Instruction: Predict the video based on the dialogue, question and answer.\n"


@dataclass
class PromptText:
    """The per-example text fields assembled by dataset readers
    (reference: e.g. dataloader/nextqa.py:22-36)."""

    q_text: str = ""
    o_text: str = ""
    a_text: str = "Answer: The answer is "
    d_text: str = ""  # dialogue/subtitles (VLEP/TVQA)
    options: List[str] = field(default_factory=list)


def _placeholders(max_feats: int) -> List[int]:
    return [VIDEO_PLACEHOLDER] * max_feats


def encode_vqa(tok: TokenizerLike, text: PromptText, max_feats: int = 10,
               split: str = "train",
               answer_mapping: Optional[Dict[int, str]] = None,
               answer: int = 0, generation: bool = False,
               ) -> Tuple[List[List[int]], int, int]:
    """video+question→answer (reference: tokenizer.py:44-100)."""
    i_text = VQA_INSTRUCTION
    s1 = i_text + "Video:"
    t1 = [tok.bos_id] + tok.encode_raw(s1)
    video_start = len(t1)
    body = _placeholders(max_feats) + [tok.nl_id]

    if not generation:
        s2 = text.q_text + text.o_text + text.a_text
        if split == "train":
            t2 = tok.encode_raw(s2 + answer_mapping[answer]) + [tok.eos_id]
            t = [t1 + body + t2]
            prefix_index = t[0].index(tok.a_token_id) + 5
        else:
            t = []
            for _, v in sorted(answer_mapping.items()):
                t2 = tok.encode_raw(s2 + v) + [tok.eos_id]
                t.append(t1 + body + t2)
            prefix_index = t[answer].index(tok.a_token_id) + 5
    else:
        # Generation-style: free-form answer text instead of option letters
        # (reference: tokenizer.py:78-100).
        s2 = text.q_text + text.a_text
        if split == "train":
            t2 = tok.encode_raw(s2 + text.options[answer]) + [tok.eos_id]
            t = [t1 + body + t2]
            prefix_index = t[0].index(tok.a_token_id) + 5
        else:
            t = []
            for option in text.options:
                t2 = tok.encode_raw(s2 + option) + [tok.eos_id]
                t.append(t1 + body + t2)
            prefix_index = t[answer].index(tok.a_token_id) + 5
    return t, prefix_index, video_start


def encode_vaq(tok: TokenizerLike, text: PromptText, max_feats: int = 10,
               split: str = "train",
               answer_mapping: Optional[Dict[int, str]] = None,
               answer: int = 0, generation: bool = False,
               ) -> Tuple[List[List[int]], int, int]:
    """video+answer→question (reference: tokenizer.py:103-163)."""
    q_text = text.q_text.strip()
    s1 = VAQ_INSTRUCTION + "Video:"
    t1 = [tok.bos_id] + tok.encode_raw(s1)
    video_start = len(t1)
    body = _placeholders(max_feats) + [tok.nl_id]

    if not generation:
        s2 = text.o_text + text.a_text
        if split == "train":
            t2 = tok.encode_raw(s2 + answer_mapping[answer] + "\n" + q_text) + [tok.eos_id]
            t = [t1 + body + t2]
            prefix_index = t[0].index(tok.q_token_id) + 2
        else:
            t = []
            for _, v in sorted(answer_mapping.items()):
                t2 = tok.encode_raw(s2 + v + "\n" + q_text) + [tok.eos_id]
                t.append(t1 + body + t2)
            prefix_index = t[answer].index(tok.q_token_id) + 2
    else:
        s2 = "\n" + text.a_text
        if split == "train":
            t2 = tok.encode_raw(s2 + text.options[answer] + "\n" + q_text) + [tok.eos_id]
            t = [t1 + body + t2]
            prefix_index = t[0].index(tok.q_token_id) + 2
        else:
            t = []
            for option in text.options:
                t2 = tok.encode_raw(s2 + option + "\n" + q_text) + [tok.eos_id]
                t.append(t1 + body + t2)
            # NB: the reference computes this from t[0] in the generation
            # branch (tokenizer.py:162), unlike the classification branch.
            prefix_index = t[0].index(tok.q_token_id) + 2
    return t, prefix_index, video_start


def encode_qav(tok: TokenizerLike, text: PromptText, max_feats: int = 10,
               split: str = "train",
               answer_mapping: Optional[Dict[int, str]] = None,
               answer: int = 0, generation: bool = False,
               ) -> Tuple[List[List[int]], int]:
    """question+answer→video frame order (reference: tokenizer.py:165-211).
    The video placeholders are the *suffix* here and supervision is the frame
    index ordering."""
    if not generation:
        s1 = QAV_INSTRUCTION + text.q_text + text.o_text + text.a_text
        if split == "train":
            t1 = [tok.bos_id] + tok.encode_raw(s1 + answer_mapping[answer] + "\n" + "Video:")
            t = [t1 + _placeholders(max_feats) + [tok.eos_id]]
            prefix_index = t[0].index(tok.v_token_id) + 2
        else:
            t = []
            for _, v in sorted(answer_mapping.items()):
                seq = ([tok.bos_id] + tok.encode_raw(s1 + v + "\n" + "Video:")
                       + _placeholders(max_feats) + [tok.eos_id])
                t.append(seq)
            prefix_index = t[answer].index(tok.v_token_id) + 2
    else:
        s1 = QAV_INSTRUCTION + text.q_text + text.a_text
        if split == "train":
            t1 = [tok.bos_id] + tok.encode_raw(s1 + text.options[answer] + "\n" + "Video:")
            t = [t1 + _placeholders(max_feats) + [tok.eos_id]]
            prefix_index = t[0].index(tok.v_token_id) + 2
        else:
            t = []
            for option in text.options:
                seq = ([tok.bos_id] + tok.encode_raw(s1 + option + "\n" + "Video:")
                       + _placeholders(max_feats) + [tok.eos_id])
                t.append(seq)
            prefix_index = t[answer].index(tok.v_token_id) + 2
    return t, prefix_index


# --- dialogue variants (VLEP/TVQA subtitles) ---------------------------------

def encode_dvqa(tok: TokenizerLike, text: PromptText, max_feats: int = 10,
                split: str = "train",
                answer_mapping: Optional[Dict[int, str]] = None,
                answer: int = 0) -> Tuple[List[List[int]], int, int, int, int]:
    """dialogue+video+question→answer (reference: tokenizer.py:218-247).
    Also returns (prefix_i, prefix_main): the dialogue span boundaries used by
    the middle-truncation logic (vlep.py:73-101)."""
    s1 = DVQA_INSTRUCTION + "Video:"
    t1 = [tok.bos_id] + tok.encode_raw(s1)
    video_start = len(t1)
    prefix_i = video_start + max_feats + 1
    d1 = tok.encode_raw(text.d_text)
    prefix_main = prefix_i + len(d1)
    body = _placeholders(max_feats) + [tok.nl_id] + d1

    s2 = text.q_text + text.o_text + text.a_text
    if split == "train":
        t2 = tok.encode_raw(s2 + answer_mapping[answer]) + [tok.eos_id]
        t = [t1 + body + t2]
    else:
        t = []
        for _, v in sorted(answer_mapping.items()):
            t2 = tok.encode_raw(s2 + v) + [tok.eos_id]
            t.append(t1 + body + t2)
    prefix_index = len(t[0]) - 4
    return t, prefix_index, video_start, prefix_i, prefix_main


def encode_dvaq(tok: TokenizerLike, text: PromptText, max_feats: int = 10,
                split: str = "train",
                answer_mapping: Optional[Dict[int, str]] = None,
                answer: int = 0) -> Tuple[List[List[int]], int, int, int, int]:
    """dialogue+video+answer→question (reference: tokenizer.py:249-278)."""
    q_text = text.q_text.strip()
    s1 = DVAQ_INSTRUCTION + "Video:"
    t1 = [tok.bos_id] + tok.encode_raw(s1)
    video_start = len(t1)
    prefix_i = video_start + max_feats + 1
    d1 = tok.encode_raw(text.d_text)
    prefix_main = prefix_i + len(d1)
    body = _placeholders(max_feats) + [tok.nl_id] + d1

    s2 = text.o_text + text.a_text
    if split == "train":
        t2 = tok.encode_raw(s2 + answer_mapping[answer] + "\n" + q_text) + [tok.eos_id]
        t = [t1 + body + t2]
    else:
        t = []
        for _, v in sorted(answer_mapping.items()):
            t2 = tok.encode_raw(s2 + v + "\n" + q_text) + [tok.eos_id]
            t.append(t1 + body + t2)
    prefix_index = t[0].index(tok.q_token_id) + 2
    return t, prefix_index, video_start, prefix_i, prefix_main


def encode_dqav(tok: TokenizerLike, text: PromptText, max_feats: int = 10,
                split: str = "train",
                answer_mapping: Optional[Dict[int, str]] = None,
                answer: int = 0) -> Tuple[List[List[int]], int, int, int]:
    """dialogue+question+answer→video (reference: tokenizer.py:280-303).
    Returns (t, prefix_index, prefix_i, prefix_q)."""
    t1 = [tok.bos_id] + tok.encode_raw(DQAV_INSTRUCTION)
    t2 = tok.encode_raw(text.d_text)
    prefix_i, prefix_q = len(t1), len(t1) + len(t2)
    s3 = text.q_text + text.o_text + text.a_text

    if split == "train":
        t3 = tok.encode_raw(s3 + answer_mapping[answer] + "\n" + "Video:")
        t = [t1 + t2 + t3 + _placeholders(max_feats) + [tok.eos_id]]
    else:
        t = []
        for _, v in sorted(answer_mapping.items()):
            t3 = (tok.encode_raw(s3 + v + "\n" + "Video:")
                  + _placeholders(max_feats) + [tok.eos_id])
            t.append(t1 + t2 + t3)
    prefix_index = len(t[0]) - max_feats - 1
    return t, prefix_index, prefix_i, prefix_q
