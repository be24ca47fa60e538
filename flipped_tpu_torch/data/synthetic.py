"""Synthetic NExT-QA, MUSIC-AVQA and VLEP fixtures, shaped like the
reference's artifacts.

The port's own writer of what `scripts/make_synthetic_data.py` writes for
NExT-QA (train/val CSVs) and MUSIC-AVQA (`avqa-{train,val}.json`), each
with its `clipvitl14.pth` video features and its ImageBind-shaped audio
features (`audio_imagebind.pth`, (10, 1024) a video, which the sum, concat
and audio-only merges read, and `audio_imagebind_clip.pth`, (1, 1024),
which the attention merge reads), and for VLEP (`vlep_{train,dev}_release.
jsonl`, `vlep_subtitles.jsonl` and the video features, for `--sub`), from
the port's own vocabulary (`data.batching._WORDS`), so runs and tests of
the port need nothing of the JAX package. `main` draws NExT-QA, then
MUSIC-AVQA, then VLEP, from one RandomState, in the script's order, and the
feature files from their own seeds, so the files equal the script's:

    python -m flipped_tpu_torch.data.synthetic --root ./data --n 32
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .batching import _WORDS

NEXTQA_QTYPES = ("CH", "CW", "TN", "TC", "TP", "DL", "DC", "DO")


def _features(path, vids, n_frames=16, dim=768, seed=0):
    rs = np.random.RandomState(seed)
    torch.save({v: torch.tensor(rs.randn(n_frames, dim).astype(np.float32))
                for v in vids}, path)


def _audio(path, vids, n=10, dim=1024, seed=1):
    rs = np.random.RandomState(seed)
    torch.save({v: torch.tensor(rs.randn(n, dim).astype(np.float32))
                for v in vids}, path)


def _media(d, vids):
    """The video features and both audio feature files of `vids` under d
    (the script's draws: `_features` seed 0, `_audio` seed 1)."""
    _features(os.path.join(d, "clipvitl14.pth"), vids)
    _audio(os.path.join(d, "audio_imagebind.pth"), vids)
    _audio(os.path.join(d, "audio_imagebind_clip.pth"), vids, n=1)


def make_nextqa(root, n, rs: np.random.RandomState):
    """`n` train rows over `n` videos and max(n // 4, 2) val rows under
    root/nextqa, drawn from `rs` (the same draws, in the same order, as the
    script's `make_nextqa`)."""
    d = os.path.join(root, "nextqa")
    os.makedirs(d, exist_ok=True)
    for split, count in (("train", n), ("val", max(n // 4, 2))):
        rows = ["video,type,answer,question,a0,a1,a2,a3,a4"]
        for i in range(count):
            opts = ",".join(rs.choice(_WORDS) for _ in range(5))
            rows.append(f"vid{i % n},{rs.choice(NEXTQA_QTYPES)},"
                        f"{rs.randint(5)},what does the {rs.choice(_WORDS)} "
                        f"do,{opts}")
        with open(os.path.join(d, f"{split}.csv"), "w") as f:
            f.write("\n".join(rows))
    _media(d, [f"vid{i}" for i in range(n)])


def make_musicavqa(root, n, rs: np.random.RandomState):
    """`n` train rows over `n` videos and max(n // 4, 2) val rows under
    root/musicavqa, drawn from `rs` as the script's `make_musicavqa` draws
    them."""
    d = os.path.join(root, "musicavqa")
    os.makedirs(d, exist_ok=True)
    types = [["Audio", "Counting"], ["Visual", "Temporal"],
             ["Audio-Visual", "Existential"]]
    for split, count in (("train", n), ("val", max(n // 4, 2))):
        data = [dict(video_id=f"mv{i % n}",
                     question_content="How many <Object> are there",
                     anser=str(rs.choice(_WORDS)),
                     templ_values=f"['{rs.choice(_WORDS)}s']",
                     type=str(types[i % 3]).replace('"', "'"))
                for i in range(count)]
        with open(os.path.join(d, f"avqa-{split}.json"), "w") as f:
            json.dump(data, f)
    _media(d, [f"mv{i}" for i in range(n)])


def make_vlep(root, n, rs: np.random.RandomState):
    """`n` train rows and max(n // 4, 2) dev rows over `n` videos, their
    subtitles and video features under root/vlep, drawn from `rs` as the
    script's `make_vlep` draws them."""
    d = os.path.join(root, "vlep")
    os.makedirs(d, exist_ok=True)
    for split, count in (("train", n), ("dev", max(n // 4, 2))):
        data = [dict(vid_name=f"vl{i % n}",
                     events=[f"{rs.choice(_WORDS)} happens",
                             f"{rs.choice(_WORDS)} stops"],
                     answer=int(rs.randint(2)), ts=[0.0, 6.0])
                for i in range(count)]
        with open(os.path.join(d, f"vlep_{split}_release.jsonl"), "w") as f:
            f.write("\n".join(json.dumps(x) for x in data))
    subs = [dict(vid_name=f"vl{i}",
                 sub=[dict(start=0, end=4,
                           text=" ".join(rs.choice(_WORDS, 8)))])
            for i in range(n)]
    with open(os.path.join(d, "vlep_subtitles.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(x) for x in subs))
    _features(os.path.join(d, "clipvitl14.pth"), [f"vl{i}" for i in range(n)])


def main(argv=None):
    ap = argparse.ArgumentParser("synthetic NExT-QA, MUSIC-AVQA and VLEP "
                                 "fixtures")
    ap.add_argument("--root", default="./data")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rs = np.random.RandomState(args.seed)
    make_nextqa(args.root, args.n, rs)
    make_musicavqa(args.root, args.n, rs)
    make_vlep(args.root, args.n, rs)
    print(f"synthetic NExT-QA, MUSIC-AVQA and VLEP written under "
          f"{args.root}")


if __name__ == "__main__":
    main()
