"""The one traffic generator: packed batches drawn from the seed.

A traffic file (`traffic/<name>.json`) gives the shapes and the ranges of
the prompt's parts; this module draws each example's token ids over the
configuration's whole vocabulary and lays them out as the Flipped-VQA
prompts are laid out (`flipped_tpu_torch/text/prompts.py`), packed as the
port's packers pack them (`data/batching.py`): the same keys, shapes and
label rules. Every seed gives the same shapes; the seed changes only the
ids, the part lengths within their ranges and the video features.

Layout of one example (S = max_seq_len, F = max_feats, ids drawn):

    vqa  bos I [video x F] nl Q O A5 ANS eos          labels from ANS
    vaq  bos I [video x F] nl O A5 ANS nl Q2 Q eos    labels from Q
    qav  bos I Q O A5 ANS nl V2 [video x F] eos       labels 0..F-1 on video

A5 is the five-token "Answer: The answer is" whose first token is the
answer marker, Q2 and V2 the two-token "Question:" and "Video:". The
eval batch holds every option's vqa sequence (the prompt shared, ANS
each option's), the generation batch its one ground-truth option.
Padding is 0, which is also the LM labels' ignore index; QAV ignores -1.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

PAD = 0


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own for each stream of one run's draws."""
    return np.random.default_rng(
        [int(seed) % 2 ** 64, sum(map(ord, stream)) * 7919 + len(stream)])


class Vocab:
    """Token ids: text ids uniform over [1, V) without the special ids."""

    def __init__(self, config: dict):
        self.size = int(config["vocab_size"])
        self.bos = int(config["bos_token_id"])
        self.eos = int(config["eos_token_id"])
        self.special = {self.bos, self.eos}

    def text(self, r: np.random.Generator, n: int) -> List[int]:
        ids = r.integers(1, self.size, size=n)
        bad = np.isin(ids, list(self.special))
        while bad.any():
            ids[bad] = r.integers(1, self.size, size=int(bad.sum()))
            bad = np.isin(ids, list(self.special))
        return ids.tolist()


def _draw_len(r: np.random.Generator, span) -> int:
    lo, hi = span
    return int(r.integers(lo, hi + 1))


class Example:
    """The drawn parts of one example."""

    def __init__(self, vocab: Vocab, r: np.random.Generator, t: dict,
                 n_options: int):
        p = t["parts"]
        self.instr = vocab.text(r, _draw_len(r, p["instruction"]))
        self.question = vocab.text(r, _draw_len(r, p["question"]))
        self.nl, = vocab.text(r, 1)
        self.answer_phrase = vocab.text(r, 5)
        self.q_phrase = vocab.text(r, 2)
        self.v_phrase = vocab.text(r, 2)
        self.options = [vocab.text(r, _draw_len(r, p["option"]))
                        for _ in range(n_options)]
        self.options_text = (sum(self.options, []) if t.get("options_in_prompt")
                             else [])
        self.answers = [vocab.text(r, _draw_len(r, p["answer"]))
                        for _ in range(n_options)]
        self.answer = int(r.integers(n_options))


def _fit(seq: List[int], s: int) -> np.ndarray:
    if len(seq) > s:
        raise ValueError(f"a drawn prompt of {len(seq)} tokens is longer "
                         f"than max_seq_len {s}: narrow the traffic's ranges")
    out = np.full(s, PAD, np.int32)
    out[:len(seq)] = seq
    return out


def _lm_labels(tokens: np.ndarray, n: int, prefix: int) -> np.ndarray:
    lab = tokens.copy()
    lab[:prefix] = PAD
    lab[n:] = PAD
    return lab


def vqa_sequence(vocab: Vocab, ex: Example, f: int, option: int, s: int):
    """(tokens, labels, video_start, prefix) of one option's VQA prompt."""
    head = [vocab.bos] + ex.instr
    vs = len(head)
    body = ([PAD] * f + [ex.nl] + ex.question + ex.options_text
            + ex.answer_phrase)
    prefix = vs + len(body)
    seq = head + body + ex.answers[option] + [vocab.eos]
    tokens = _fit(seq, s)
    return tokens, _lm_labels(tokens, len(seq), prefix), vs, prefix


def train_example(vocab: Vocab, ex: Example, f: int, s: int) -> Dict:
    a = ex.answer
    vqa_t, vqa_l, vqa_vs, _ = vqa_sequence(vocab, ex, f, a, s)
    head = [vocab.bos] + ex.instr
    body = ([PAD] * f + [ex.nl] + ex.options_text + ex.answer_phrase
            + ex.answers[a] + [ex.nl] + ex.q_phrase)
    vaq_seq = head + body + ex.question + [vocab.eos]
    vaq_t = _fit(vaq_seq, s)
    vaq_l = _lm_labels(vaq_t, len(vaq_seq), len(head) + len(body))
    qav_head = (head + ex.question + ex.options_text + ex.answer_phrase
                + ex.answers[a] + [ex.nl] + ex.v_phrase)
    qav_prefix = len(qav_head)
    qav_t = _fit(qav_head + [PAD] * f + [vocab.eos], s)
    qav_l = np.full(s, -1, np.int32)
    qav_l[qav_prefix:qav_prefix + f] = np.arange(f)
    return {"vqa": (vqa_t, vqa_l, vqa_vs), "vaq": (vaq_t, vaq_l, len(head)),
            "qav": (qav_t, qav_l, qav_prefix)}


def _video(r: np.random.Generator, b: int, f: int, dim: int) -> np.ndarray:
    return r.standard_normal((b, f, dim), dtype=np.float32)


def train_batch(vocab: Vocab, r: np.random.Generator, t: dict,
                method: dict) -> Dict[str, np.ndarray]:
    """One optimizer update's batch: leaves (accum, B, ...), as
    `data.batching.pack_train_batch` then `add_accum_axis` give them."""
    accum, b, s = t["accum_iter"], t["batch_size"], t["max_seq_len"]
    f = method["max_feats"]
    n = accum * b
    rows = [train_example(vocab, Example(vocab, r, t, t["n_options"]), f, s)
            for _ in range(n)]
    batch = {"video": _video(r, n, f, method["visual_dim"])}
    arange_f = np.arange(f, dtype=np.int32)
    for k in ("vqa", "vaq", "qav"):
        batch[f"{k}_tokens"] = np.stack([x[k][0] for x in rows])
        batch[f"{k}_labels"] = np.stack([x[k][1] for x in rows])
        start = np.array([x[k][2] for x in rows], np.int32)
        batch[f"{k}_splice"] = start[:, None] + arange_f[None]
        batch[f"{k}_video_start"] = (np.full(n, -1, np.int32) if k == "qav"
                                     else start)
    return {k: v.reshape(accum, b, *v.shape[1:]) for k, v in batch.items()}


def eval_batch(vocab: Vocab, r: np.random.Generator, t: dict,
               method: dict) -> Dict[str, np.ndarray]:
    """One eval batch: every option's VQA sequence (B, n_opt, S), as
    `data.batching.pack_eval_batch` gives it (numeric keys only)."""
    b, s, n_opt = t["batch_size"], t["max_seq_len"], t["n_options"]
    f = method["max_feats"]
    toks, labs, vss, prefixes, answers = [], [], [], [], []
    for _ in range(b):
        ex = Example(vocab, r, t, n_opt)
        seqs = [vqa_sequence(vocab, ex, f, o, s) for o in range(n_opt)]
        toks.append(np.stack([x[0] for x in seqs]))
        labs.append(np.stack([x[1] for x in seqs]))
        vss.append(seqs[0][2])
        prefixes.append(seqs[ex.answer][3])
        answers.append(ex.answer)
    vs = np.array(vss, np.int32)
    return {"video": _video(r, b, f, method["visual_dim"]),
            "vqa_tokens": np.stack(toks), "vqa_labels": np.stack(labs),
            "vqa_video_start": vs,
            "vqa_splice": vs[:, None] + np.arange(f, dtype=np.int32)[None],
            "prefix": np.array(prefixes, np.int32),
            "answer": np.array(answers, np.int32)}


def eval_span(labels: np.ndarray, prefix: np.ndarray) -> Tuple[int, bool]:
    """(need, exact) of the cached scorer, as `data.batching.eval_span`:
    the smallest L with every nonzero label in [prefix, prefix + L]."""
    pre = prefix.reshape(prefix.shape + (1,) * (labels.ndim - 1 - prefix.ndim))
    s = labels.shape[-1]
    nz = labels != 0
    pos = np.arange(s)
    max_pos = np.where(nz, pos, -1).max(axis=-1)
    min_pos = np.where(nz, pos, s).min(axis=-1)
    exact = not bool(((min_pos < pre) & (max_pos >= 0)).any())
    need = int(np.maximum(max_pos - pre, 0).max(initial=0))
    return max(need, 1), exact


def make_pool(kind: str, config: dict, t: dict, seed: int) -> List[Dict]:
    """`t["pool"]` distinct batches of the traffic's kind from the seed."""
    vocab = Vocab(config)
    r = rng(seed, f"traffic:{kind}")
    make = {"train": train_batch, "eval": eval_batch}[kind]
    return [make(vocab, r, t, config["method"]) for _ in range(t["pool"])]


def sample_rows(seed: int, ran, batch_size: int, n: int):
    """(batch, row) pairs, `n` of them drawn from the seed without
    repeats among the rows of the pool batches `ran`."""
    ran = sorted(ran)
    picks = rng(seed, "check").choice(len(ran) * batch_size,
                                      size=min(n, len(ran) * batch_size),
                                      replace=False)
    return [(ran[p // batch_size], p % batch_size) for p in sorted(picks)]
