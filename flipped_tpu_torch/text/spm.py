"""Self-contained SentencePiece ``tokenizer.model`` reader + encoder.

The port's own copy of flipped_tpu/text/spm.py, kept here so that
flipped_tpu_torch imports nothing of the JAX package; tests hold the
two copies equal.

The reference hard-requires the ``sentencepiece`` package to load Meta's
LLaMA tokenizer (reference: llama/tokenizer.py:14-42).  That package is a
C++ extension that is not always available (it is absent from some
images), yet the ``tokenizer.model`` file itself is just a protobuf with a
piece table — everything needed to tokenize.  This module loads that file
and implements both SentencePiece inference algorithms with no third-party
dependencies:

  * a minimal protobuf **wire-format parser** for the ModelProto schema
    (field numbers verified against sentencepiece_model.proto: pieces=1
    {piece=1, score=2, type=3}, trainer_spec=2 {model_type=3,
    byte_fallback=35, unk/bos/eos/pad_id=40..43}, normalizer_spec=3
    {add_dummy_prefix=3, remove_extra_whitespaces=4, escape_whitespaces=5});
  * **BPE** merge inference (LLaMA's model_type): score-ordered agenda of
    adjacent-pair merges, ties broken by leftmost position, mirroring
    sentencepiece's bpe_model.cc comparator;
  * **Unigram** Viterbi segmentation (the default SentencePiece model type)
    with the standard unknown-piece penalty (min_score − 10);
  * byte-fallback (``<0xNN>`` pieces) for characters outside the vocab, and
    the inverse on decode.

Tokenization is host-side pipeline work and never enters the model step.  Parity is
tested against HuggingFace ``tokenizers`` (BPE and Unigram oracles) in
tests/test_spm.py.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WS = "▁"  # ▁ — SentencePiece's escaped whitespace

# piece types (sentencepiece_model.proto: SentencePiece.Type)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# model types (TrainerSpec.ModelType)
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4


# ---------------------------------------------------------------------------
# protobuf wire-format reading (just enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.

    value is an int for varint/fixed fields and a bytes slice for
    length-delimited fields."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wtype == 1:  # fixed64
            val = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wtype == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wtype == 5:  # fixed32
            val = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} (field {fnum})")
        yield fnum, wtype, val


def _f32(bits: int) -> float:
    import struct

    return struct.unpack("<f", bits.to_bytes(4, "little"))[0]


@dataclass
class SpmModel:
    """Parsed ModelProto: the piece table plus the handful of spec fields
    that affect inference."""

    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    model_type: int = UNIGRAM
    normalizer_name: str = ""
    has_charsmap: bool = False  # NormalizerSpec.precompiled_charsmap nonempty
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    unk_surface: str = " ⁇ "

    # derived
    piece_to_id: Dict[str, int] = field(default_factory=dict)
    byte_to_id: Dict[int, int] = field(default_factory=dict)
    user_defined: set = field(default_factory=set)
    max_piece_chars: int = 1
    max_ud_chars: int = 0
    min_score: float = 0.0

    def finish(self) -> "SpmModel":
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t not in (NORMAL, USER_DEFINED, UNKNOWN, BYTE, CONTROL):
                continue
            if t == BYTE:
                # piece text is "<0xNN>"
                self.byte_to_id[int(p[3:5], 16)] = i
            self.piece_to_id.setdefault(p, i)
            if t == NORMAL:
                self.max_piece_chars = max(self.max_piece_chars, len(p))
            elif t == USER_DEFINED:
                self.user_defined.add(p)
                self.max_ud_chars = max(self.max_ud_chars, len(p))
        self.min_score = min(
            (sc for sc, t in zip(self.scores, self.types) if t == NORMAL),
            default=0.0)
        return self


def parse_model(data: bytes) -> SpmModel:
    m = SpmModel()
    for fnum, _, val in _iter_fields(data):
        if fnum == 1:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = _f32(v2) if w2 == 5 else float(v2)
                elif f2 == 3:
                    ptype = v2
            m.pieces.append(piece)
            m.scores.append(score)
            m.types.append(ptype)
        elif fnum == 2:  # TrainerSpec
            for f2, _, v2 in _iter_fields(val):
                if f2 == 3:
                    m.model_type = v2
                elif f2 == 35:
                    m.byte_fallback = bool(v2)
                elif f2 == 40:
                    m.unk_id = _signed(v2)
                elif f2 == 41:
                    m.bos_id = _signed(v2)
                elif f2 == 42:
                    m.eos_id = _signed(v2)
                elif f2 == 43:
                    m.pad_id = _signed(v2)
                elif f2 == 44:
                    m.unk_surface = v2.decode("utf-8")
        elif fnum == 3:  # NormalizerSpec
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    m.normalizer_name = v2.decode("utf-8")
                elif f2 == 2:  # precompiled_charsmap (bytes)
                    m.has_charsmap = len(v2) > 0
                elif f2 == 3:
                    m.add_dummy_prefix = bool(v2)
                elif f2 == 4:
                    m.remove_extra_whitespaces = bool(v2)
                elif f2 == 5:
                    m.escape_whitespaces = bool(v2)
    return m.finish()


def _signed(v: int) -> int:
    """Proto int32 varints encode negatives as 10-byte two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# protobuf wire-format writing (the inverse, for building synthetic
# tokenizer.model files — scripts/make_synthetic_tokenizer.py; the parser
# tests use their own independent writer so a shared bug can't self-verify)
# ---------------------------------------------------------------------------

def _w_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _w_field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _w_varint(fnum << 3 | wtype) + payload


def _w_msg(fnum: int, body: bytes) -> bytes:
    return _w_field(fnum, 2, _w_varint(len(body)) + body)


def serialize_model(pieces: List[Tuple[str, float, int]], model_type: int,
                    add_dummy_prefix: bool = True,
                    remove_extra_whitespaces: bool = False,
                    byte_fallback: bool = True, unk_id: int = 0,
                    bos_id: int = 1, eos_id: int = 2,
                    pad_id: int = -1) -> bytes:
    """ModelProto bytes for [(piece, score, type)] — loadable by this module
    and by the real sentencepiece runtime alike."""
    import struct

    out = b""
    for piece, score, ptype in pieces:
        p = piece.encode("utf-8")
        body = (_w_field(1, 2, _w_varint(len(p)) + p)
                + _w_field(2, 5, struct.pack("<f", score))
                + _w_field(3, 0, _w_varint(ptype)))
        out += _w_msg(1, body)
    trainer = (_w_field(3, 0, _w_varint(model_type))
               + _w_field(35, 0, _w_varint(int(byte_fallback)))
               + _w_field(40, 0, _w_varint(unk_id))
               + _w_field(41, 0, _w_varint(bos_id))
               + _w_field(42, 0, _w_varint(eos_id))
               + _w_field(43, 0, _w_varint(pad_id)))
    norm = (_w_field(3, 0, _w_varint(int(add_dummy_prefix)))
            + _w_field(4, 0, _w_varint(int(remove_extra_whitespaces)))
            + _w_field(5, 0, _w_varint(1)))
    return out + _w_msg(2, trainer) + _w_msg(3, norm)


def load_model(path: str) -> SpmModel:
    with open(path, "rb") as f:
        return parse_model(f.read())


# ---------------------------------------------------------------------------
# normalization. LLaMA's normalizer is "identity" (empty rule set). For the
# common "nmt_nfkc"/"nfkc" normalizers we apply unicodedata NFKC — a close
# approximation: the precompiled charsmap adds a handful of NMT-specific
# control-char rules on top of NFKC that are not reproduced here. "…_cf"
# variants additionally case-fold (str.casefold ≈ Unicode full case folding).
# Any OTHER normalizer that ships a precompiled charsmap is refused loudly —
# silently tokenizing with the wrong normalization would corrupt every
# downstream id (cf. reference tokenizer.py:19, which delegates to the
# SentencePiece C++ runtime and so never faces this).
# ---------------------------------------------------------------------------

_NFKC_NAMES = ("nmt_nfkc", "nfkc", "nmt_nfkc_cf", "nfkc_cf")


def normalize(m: SpmModel, s: str) -> str:
    if m.has_charsmap and m.normalizer_name not in _NFKC_NAMES:
        raise ValueError(
            f"tokenizer.model uses normalizer "
            f"{m.normalizer_name or '<unnamed>'!r} with a precompiled "
            f"charsmap that this dependency-free reader cannot reproduce; "
            f"known-safe normalizers are 'identity' (LLaMA) and "
            f"{_NFKC_NAMES}. Install sentencepiece or re-export the model.")
    if "nfkc" in m.normalizer_name:
        import unicodedata

        s = unicodedata.normalize("NFKC", s)
        if m.normalizer_name.endswith("_cf"):
            s = s.casefold()
    if m.remove_extra_whitespaces:
        s = " ".join(p for p in s.split(" ") if p)  # collapse runs + strip
    if m.add_dummy_prefix and s:
        s = " " + s
    if m.escape_whitespaces:
        s = s.replace(" ", WS)
    return s


# ---------------------------------------------------------------------------
# BPE inference (bpe_model.cc): merge the best-scoring adjacent pair until
# no pair concatenation exists in the vocab; ties go to the leftmost pair.
# ---------------------------------------------------------------------------

def _bpe_segment(m: SpmModel, chars: List[str]) -> List[str]:
    n = len(chars)
    piece = list(chars)          # current symbol text at each live slot
    nxt = list(range(1, n)) + [-1]
    prv = [-1] + list(range(n - 1))
    alive = [True] * n

    heap: List[Tuple[float, int, str, str]] = []

    def push(i: int) -> None:
        j = nxt[i]
        if j == -1:
            return
        merged = piece[i] + piece[j]
        idx = m.piece_to_id.get(merged)
        if idx is not None and m.types[idx] == NORMAL:
            # max-heap on score, then leftmost; snapshot the two halves so a
            # stale entry (either half since merged away) can be skipped
            heapq.heappush(heap, (-m.scores[idx], i, piece[i], piece[j]))

    for i in range(n - 1):
        push(i)
    while heap:
        _, i, left_txt, right_txt = heapq.heappop(heap)
        j = nxt[i] if alive[i] else -1
        if j == -1 or piece[i] != left_txt or piece[j] != right_txt:
            continue  # stale
        piece[i] = left_txt + right_txt
        alive[j] = False
        nxt[i] = nxt[j]
        if nxt[j] != -1:
            prv[nxt[j]] = i
        if prv[i] != -1:
            push(prv[i])
        push(i)
    return [piece[i] for i in range(n) if alive[i]]


# ---------------------------------------------------------------------------
# Unigram inference (unigram_model.cc): Viterbi over the piece lattice with
# log-prob scores; unknown characters score min_score − 10.
# ---------------------------------------------------------------------------

_UNK_PENALTY = 10.0


def _unigram_segment(m: SpmModel, s: str) -> List[str]:
    n = len(s)
    unk_score = m.min_score - _UNK_PENALTY
    best = [-1e30] * (n + 1)
    back: List[Tuple[int, str]] = [(-1, "")] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        if best[i] <= -1e30:
            continue
        hi = min(n, i + m.max_piece_chars)
        matched_single = False
        for j in range(i + 1, hi + 1):
            sub = s[i:j]
            idx = m.piece_to_id.get(sub)
            if idx is None or m.types[idx] != NORMAL:
                continue
            if j == i + 1:
                matched_single = True
            sc = best[i] + m.scores[idx]
            if sc > best[j]:
                best[j], back[j] = sc, (i, sub)
        if not matched_single:  # unknown char fallback keeps the lattice live
            sc = best[i] + unk_score
            if sc > best[i + 1]:
                best[i + 1], back[i + 1] = sc, (i, s[i])
    out: List[str] = []
    j = n
    while j > 0:
        i, sub = back[j]
        out.append(sub)
        j = i
    out.reverse()
    return out


# ---------------------------------------------------------------------------
# public encode/decode
# ---------------------------------------------------------------------------

def _split_user_defined(m: SpmModel, s: str) -> List[Tuple[str, bool]]:
    """Longest-match extraction of USER_DEFINED pieces as whole units
    (sentencepiece's PrefixMatcher runs before the model algorithm;
    user-defined pieces never participate in merges/the lattice).
    Returns [(span, is_user_defined)]."""
    if not m.user_defined:
        return [(s, False)]
    out: List[Tuple[str, bool]] = []
    buf: List[str] = []
    i, n = 0, len(s)
    while i < n:
        hit = ""
        for ln in range(min(m.max_ud_chars, n - i), 0, -1):
            if s[i:i + ln] in m.user_defined:
                hit = s[i:i + ln]
                break
        if hit:
            if buf:
                out.append(("".join(buf), False))
                buf = []
            out.append((hit, True))
            i += len(hit)
        else:
            buf.append(s[i])
            i += 1
    if buf:
        out.append(("".join(buf), False))
    return out


def _segment(m: SpmModel, s: str) -> List[str]:
    if m.model_type == BPE:
        return _bpe_segment(m, list(s))
    if m.model_type == UNIGRAM:
        return _unigram_segment(m, s)
    if m.model_type == CHAR:
        return list(s)
    if m.model_type == WORD:
        words = [w for w in s.split(WS) if w]
        if m.escape_whitespaces:
            words = [WS + w for w in words]
        return words
    raise ValueError(f"unsupported model_type {m.model_type}")


def encode(m: SpmModel, s: str) -> List[int]:
    """Text → ids (no bos/eos — the caller adds them, as the reference's
    Tokenizer.encode does at llama/tokenizer.py:35-42)."""
    s = normalize(m, s)
    if not s:
        return []
    pieces: List[str] = []
    for span, is_ud in _split_user_defined(m, s):
        pieces += [span] if is_ud else _segment(m, span)

    ids: List[int] = []
    prev_unk = False
    for p in pieces:
        idx = m.piece_to_id.get(p)
        if idx is not None and m.types[idx] in (NORMAL, USER_DEFINED):
            ids.append(idx)
            prev_unk = False
        elif m.byte_fallback:
            ids.extend(m.byte_to_id.get(b, m.unk_id) for b in p.encode("utf-8"))
            prev_unk = False
        else:
            # sentencepiece fuses consecutive unknown pieces into ONE unk
            # (model_interface.h; HF converters mirror it with fuse_unk=True)
            if not prev_unk:
                ids.append(m.unk_id)
            prev_unk = True
    return ids


def decode(m: SpmModel, ids: List[int]) -> str:
    """Ids → text: byte pieces re-assemble to utf-8, control pieces drop,
    unk renders as unk_surface, ▁ unescapes, and the dummy prefix strips."""
    out: List[str] = []
    byte_run = bytearray()

    def flush() -> None:
        if byte_run:
            out.append(byte_run.decode("utf-8", errors="replace"))
            byte_run.clear()

    for i in ids:
        i = int(i)
        if not 0 <= i < len(m.pieces):
            continue
        t = m.types[i]
        if t == BYTE:
            byte_run.append(int(m.pieces[i][3:5], 16))
            continue
        flush()
        if t == CONTROL:
            continue
        if t == UNKNOWN:
            out.append(m.unk_surface)
        else:
            out.append(m.pieces[i])
    flush()
    text = "".join(out)
    if m.escape_whitespaces:
        text = text.replace(WS, " ")
    if m.add_dummy_prefix and text.startswith(" "):
        text = text[1:]
    return text
