"""Write a synthetic LLaMA-layout ``tokenizer.model`` (no Meta assets; JAX:
scripts/make_synthetic_tokenizer.py).

The vocabulary geometry the prompt anchors assume (reference:
llama/tokenizer.py:28-31): 32,000 pieces with <unk>/<s>/</s> at 0/1/2, the
256 byte-fallback pieces at 3..258 (so newline "<0x0A>" is id 13), and BPE
merge chains placing "Video" at 15167, "Question" at 16492 and "Answer" at
22550. Everything else tokenizes per character (printable ASCII as NORMAL
pieces) or through byte fallback, so any text encodes and round-trips. The
file is a SentencePiece ModelProto, written and read back by the port's own
`text.spm` (no sentencepiece package needed); it is byte for byte the JAX
script's file.

    python -m flipped_tpu_torch.scripts.make_synthetic_tokenizer --out DIR/tokenizer.model
"""
from __future__ import annotations

import argparse
import os
import string

from ..text import spm
from ..text.tokenizer import A_TOKEN_ID, NL_ID, Q_TOKEN_ID, V_TOKEN_ID

VOCAB = 32000


def build_pieces():
    pieces = [("<unk>", 0.0, spm.UNKNOWN), ("<s>", 0.0, spm.CONTROL),
              ("</s>", 0.0, spm.CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, spm.BYTE) for b in range(256)]
    chars = "▁" + string.ascii_letters + string.digits + string.punctuation
    pieces += [(c, -10.0, spm.NORMAL) for c in chars]

    # anchor merge chains: each prefix concatenation exists, with scores
    # decreasing along the chain so greedy BPE assembles the full word.
    # The anchors follow "\n" in every prompt, so (as in the real LLaMA
    # vocab) they are the unprefixed pieces: "Answer", not "▁Answer".
    def chain(word):
        return [(word[:k], -1.0 - 0.01 * k, spm.NORMAL)
                for k in range(2, len(word))]

    anchors = {"Video": V_TOKEN_ID, "Question": Q_TOKEN_ID,
               "Answer": A_TOKEN_ID}
    for w in anchors:
        pieces += chain(w)

    # pad with UNUSED fillers, then drop the anchor pieces at their ids
    out = list(pieces)
    out += [(f"<fill_{i}>", 0.0, spm.UNUSED)
            for i in range(VOCAB - len(out))]
    for w, idx in anchors.items():
        out[idx] = (w, -1.0 - 0.01 * len(w), spm.NORMAL)
    assert len(out) == VOCAB
    assert len({p for p, _, _ in out}) == VOCAB, "duplicate pieces"
    return out


def write(path: str) -> spm.SpmModel:
    """Write the model to `path`, check its anchors, → the model read
    back."""
    data = spm.serialize_model(build_pieces(), spm.BPE,
                               remove_extra_whitespaces=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    m = spm.load_model(path)
    for text, want in (("Video", V_TOKEN_ID), ("Question", Q_TOKEN_ID),
                       ("Answer", A_TOKEN_ID), ("\n", NL_ID)):
        ids = spm.encode(m, text)
        assert want in ids, (text, want, ids)
    return m


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("synthetic LLaMA-layout tokenizer.model")
    ap.add_argument("--out", default="./output_dir/tok/tokenizer.model")
    args = ap.parse_args(argv)
    m = write(args.out)
    print(f"wrote {args.out}: {len(m.pieces)} pieces, anchors "
          f"Video={V_TOKEN_ID} Question={Q_TOKEN_ID} Answer={A_TOKEN_ID}, "
          f"newline={NL_ID}")


if __name__ == "__main__":
    main()
