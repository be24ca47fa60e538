"""Tokenizer backends.

The port's own copy of flipped_tpu/text/tokenizer.py, kept here so that
flipped_tpu_torch imports nothing of the JAX package; tests hold the
two copies equal.

The reference wraps SentencePiece directly (reference: llama/tokenizer.py:14-42)
with hardcoded LLaMA-vocab anchor ids. Tokenization is host-side work that
feeds the input pipeline; it never enters the model step. We keep the same interface but
make the backend pluggable:

  * SentencePieceTokenizer — the real LLaMA tokenizer (requires the
    `sentencepiece` package and Meta's tokenizer.model).
  * PurePythonSentencePieceTokenizer — the same tokenizer.model, decoded and
    run by our dependency-free reader (text/spm.py: protobuf wire parse +
    BPE/Unigram inference), for images without the sentencepiece extension.
  * MockTokenizer — a deterministic word-level tokenizer with the same special
    ids, used by tests and benchmarks so the full pipeline runs without Meta
    assets.

Anchor ids in the LLaMA vocab (reference: llama/tokenizer.py:28-31):
  "Video" = 15167, "Question" = 16492, "Answer" = 22550, newline = 13.
"""
from __future__ import annotations

import os
import re
from typing import List, Protocol

V_TOKEN_ID = 15167
Q_TOKEN_ID = 16492
A_TOKEN_ID = 22550
NL_ID = 13


class TokenizerLike(Protocol):
    n_words: int
    bos_id: int
    eos_id: int
    pad_id: int
    v_token_id: int
    q_token_id: int
    a_token_id: int
    nl_id: int

    def encode_raw(self, s: str) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


class _SpecialIds:
    v_token_id = V_TOKEN_ID
    q_token_id = Q_TOKEN_ID
    a_token_id = A_TOKEN_ID
    nl_id = NL_ID

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        # reference: llama/tokenizer.py:35-42
        t = self.encode_raw(s)
        if bos:
            t = [self.bos_id] + t
        if eos:
            t = t + [self.eos_id]
        return t


class SentencePieceTokenizer(_SpecialIds):
    """Real LLaMA SentencePiece tokenizer (reference: llama/tokenizer.py:14-33)."""

    def __init__(self, model_path: str):
        from sentencepiece import SentencePieceProcessor  # gated import

        assert os.path.isfile(model_path), model_path
        self.sp = SentencePieceProcessor(model_file=model_path)
        self.n_words: int = self.sp.vocab_size()
        self.bos_id: int = self.sp.bos_id()
        self.eos_id: int = self.sp.eos_id()
        self.pad_id: int = self.sp.pad_id()

    def encode_raw(self, s: str) -> List[int]:
        return self.sp.encode(s)

    def decode(self, ids: List[int]) -> str:
        return self.sp.decode(ids)


class PurePythonSentencePieceTokenizer(_SpecialIds):
    """tokenizer.model without the sentencepiece package (text/spm.py).

    Same surface as SentencePieceTokenizer; encode parity is oracle-tested
    against HuggingFace `tokenizers` in tests/test_spm.py."""

    def __init__(self, model_path: str):
        from . import spm

        assert os.path.isfile(model_path), model_path
        self._spm = spm
        self.m = spm.load_model(model_path)
        self.n_words: int = len(self.m.pieces)
        self.bos_id: int = self.m.bos_id
        self.eos_id: int = self.m.eos_id
        self.pad_id: int = self.m.pad_id

    def encode_raw(self, s: str) -> List[int]:
        return self._spm.encode(self.m, s)

    def decode(self, ids: List[int]) -> str:
        return self._spm.decode(self.m, ids)


_WORD_RE = re.compile(r"\n|[A-Za-z0-9']+|[^\sA-Za-z0-9']")


class MockTokenizer(_SpecialIds):
    """Deterministic stand-in with LLaMA-compatible special ids.

    Splits on words/punctuation (newline is its own token, id 13) and hashes
    unknown words into [100, 14999) ∪ [23000, 31900) so anchor words stay
    unique. Stable across processes (no PYTHONHASHSEED dependence).
    """

    def __init__(self, n_words: int = 32000):
        assert n_words >= 64, "MockTokenizer needs at least 64 ids"
        self.n_words = n_words
        self.bos_id = 1
        self.eos_id = 2
        self.pad_id = -1
        if n_words >= 32000:
            self._fixed = {"Video": V_TOKEN_ID, "Question": Q_TOKEN_ID,
                           "Answer": A_TOKEN_ID, "\n": NL_ID}
        else:
            # Small-vocab mode for tiny test models: anchors at low ids.
            self.v_token_id, self.q_token_id, self.a_token_id = 14, 15, 16
            self.nl_id = NL_ID
            self._fixed = {"Video": 14, "Question": 15, "Answer": 16,
                           "\n": NL_ID}
        self._id2piece = {v: k for k, v in self._fixed.items()}
        self._id2piece.update({self.bos_id: "<s>", self.eos_id: "</s>", 0: "<unk>"})

    @staticmethod
    def _stable_hash(s: str) -> int:
        h = 2166136261
        for ch in s.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return h

    def _word_id(self, w: str) -> int:
        if w in self._fixed:
            return self._fixed[w]
        h = self._stable_hash(w)
        if self.n_words >= 32000:
            # Two bands avoiding specials & reserved low ids.
            band = h % 2
            wid = (100 + (h // 2) % 14899 if band == 0
                   else 23000 + (h // 2) % 8900)
        else:
            wid = 20 + h % (self.n_words - 20)
        self._id2piece.setdefault(wid, w)
        return wid

    def encode_raw(self, s: str) -> List[int]:
        return [self._word_id(w) for w in _WORD_RE.findall(s)]

    def decode(self, ids: List[int]) -> str:
        return " ".join(self._id2piece.get(int(i), f"<{int(i)}>") for i in ids)


def load_tokenizer(model_path: str = "", n_words: int = 32000) -> TokenizerLike:
    """Given a model file: the sentencepiece package when installed, else the
    pure-Python reader — real tokenization either way. With no file, the mock
    (sized to the model vocab so ids stay in range)."""
    if model_path:
        try:
            return SentencePieceTokenizer(model_path)
        except ImportError:
            return PurePythonSentencePieceTokenizer(model_path)
    return MockTokenizer(n_words)
