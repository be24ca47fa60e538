"""The seven benchmark dataset readers, all emitting one uniform Item

The port's own copy of flipped_tpu/data/datasets.py, kept here so that
flipped_tpu_torch imports nothing of the JAX package; tests hold the
two copies equal.

contract (fixing the reference's inconsistent per-dataset item dicts:
STAR/DramaQA's 5-vs-6 unpack break and VLEP/TVQA's missing prefix_index,
SURVEY.md §2).

Reference readers: dataloader/nextqa.py, star.py, dramaqa.py, vlep.py,
tvqa.py, musicavqa.py, valor32k.py.
"""
from __future__ import annotations

import csv
import json
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..text.masking import (build_dialogue_text_features, build_text_features)
from ..text.prompts import PromptText
from .batching import Item
from .feature_store import FeatureStore

LETTERS = "ABCDE"

NUM_OPTIONS = {"nextqa": 5, "star": 4, "dramaqa": 5, "vlep": 2, "tvqa": 5,
               "valor32k": 4, "musicavqa": 1}

QTYPE_MAPPINGS = {
    "nextqa": {"CH": 1, "CW": 2, "TN": 3, "TC": 4, "TP": 5, "DL": 6,
               "DC": 7, "DO": 8},
    "star": {"Interaction": 1, "Sequence": 2, "Prediction": 3,
             "Feasibility": 4},
    "valor32k": {
        "count_visual": 1, "count_audio": 2, "count_both": 3,
        "temporal_visual": 4, "temporal_audio": 5, "temporal_both": 6,
        "desc_visual": 7, "desc_audio": 8, "desc_both": 9,
        "action_visual": 10, "action_audio": 11, "action_both": 12,
        "loc_visual": 13, "loc_audio": 14, "loc_both": 15,
        "rel_pos_visual": 16, "rel_pos_audio": 17, "rel_pos_both": 18,
        "audio_both": 19, "audio_visual": 20,
    },
    "musicavqa": {
        "Audio_Temporal": 1, "Audio_Existential": 2, "Audio_Comparative": 3,
        "Audio_Location": 4, "Audio_Counting": 5,
        "Visual_Temporal": 6, "Visual_Existential": 7,
        "Visual_Comparative": 8, "Visual_Location": 9, "Visual_Counting": 10,
        "Audio-Visual_Temporal": 11, "Audio-Visual_Existential": 12,
        "Audio-Visual_Comparative": 13, "Audio-Visual_Location": 14,
        "Audio-Visual_Counting": 15,
    },
}


def _question_text(q: str) -> str:
    # capitalize + ensure trailing '?' (reference: nextqa.py:23-25)
    q = str(q).capitalize().strip()
    if not q.endswith("?"):
        q += "?"
    return f"Question: {q}\n"


def _options_text(options: List[str]) -> str:
    return "Choices: \n" + "".join(
        f"({LETTERS[i]}) {opt}\n" for i, opt in enumerate(options))


class VideoQADataset:
    """Base reader (reference: dataloader/base_dataset.py:7-15)."""

    name = "base"
    dialogue = False  # VLEP/TVQA use the dialogue encoders + truncation
    text_only = False  # skip video/audio loading (span precompute passes)

    def __init__(self, cfg, tokenizer, split: str = "train"):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.split = split
        self.max_feats = cfg.max_feats
        self.max_seq_len = cfg.max_seq_len
        self.features_dim = 768
        self.audio_dim = 1024
        self.root = Path(cfg.data_root) / self.name
        self.num_options = NUM_OPTIONS[self.name]
        self.answer_mapping = {i: f"({LETTERS[i]})"
                               for i in range(self.num_options)}
        self.generation = getattr(cfg, "is_generation_task", False)
        self.video_store: Optional[FeatureStore] = None
        self.audio_store: Optional[FeatureStore] = None
        self._load()
        if getattr(cfg, "audio", False):
            self._load_audio()

    # --- per-dataset hooks ---------------------------------------------------
    def _load(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data)

    def _load_audio(self):
        """ImageBind audio features: (10, 1024) per clip, or (1, 1024) when
        the 'attention' merge wants one clip embedding
        (reference: nextqa.py:14-19)."""
        suffix = ("audio_imagebind.pth"
                  if self.cfg.audio_merge != "attention"
                  else "audio_imagebind_clip.pth")
        self.audio_store = FeatureStore(
            str(self.root / suffix), self.audio_dim, self.max_feats,
            pad_short=self.cfg.audio_merge != "attention")

    def _video(self, vid: str, start=None, end=None, fps_scale=1):
        return self.video_store.get(vid, start, end, fps_scale)

    def _audio(self, vid: str):
        return self.audio_store.get(vid)

    def _finish_item(self, vid, qtype, answer, text: PromptText,
                     idx: int, start=None, end=None, fps_scale=1) -> Item:
        if self.dialogue:
            feats = build_dialogue_text_features(
                self.tokenizer, text, self.max_feats, self.max_seq_len,
                self.split, self.answer_mapping, answer,
                sub=getattr(self.cfg, "sub", False))
        else:
            feats = build_text_features(
                self.tokenizer, text, self.max_feats, self.max_seq_len,
                self.split, self.answer_mapping, answer,
                generation=self.generation)
        audio_only = getattr(self.cfg, "audio_only", False)
        video = video_len = None
        if not audio_only and not self.text_only:
            video, video_len = self._video(vid, start, end, fps_scale)
        audio = audio_len = None
        if getattr(self.cfg, "audio", False) and not self.text_only:
            audio, audio_len = self._audio(vid)
        return Item(features=feats, video=video, video_len=video_len or 0,
                    audio=audio, audio_len=audio_len or 0, answer=answer,
                    qtype=qtype, vid=str(vid), qid=idx, text=text)


class NextQA(VideoQADataset):
    """CSV, 5 options, C/T/D qtype groups (reference: dataloader/nextqa.py)."""

    name = "nextqa"

    def _load(self):
        with open(self.root / f"{self.split}.csv") as f:
            self.data = list(csv.DictReader(f))
        self.video_store = FeatureStore(str(self.root / "clipvitl14.pth"),
                                        self.features_dim, self.max_feats)
        print(f"Num {self.split} data: {len(self.data)}")

    def get_item(self, idx: int) -> Item:
        row = self.data[idx]
        options = [row[f"a{i}"] for i in range(self.num_options)]
        text = PromptText(q_text=_question_text(row["question"]),
                          o_text=_options_text(options),
                          options=options)
        return self._finish_item(
            row["video"], QTYPE_MAPPINGS["nextqa"][row["type"]],
            int(row["answer"]), text, idx)


class STAR(VideoQADataset):
    """JSON, 4 options, clip-window slicing (reference: dataloader/star.py)."""

    name = "star"

    def _load(self):
        with open(self.root / f"STAR_{self.split}.json") as f:
            self.data = json.load(f)
        self.video_store = FeatureStore(str(self.root / "clipvitl14.pth"),
                                        self.features_dim, self.max_feats)
        print(f"Num {self.split} data: {len(self.data)}")

    def get_item(self, idx: int) -> Item:
        row = self.data[idx]
        options = {c["choice_id"]: c["choice"] for c in row["choices"]}
        options = [options[i] for i in range(self.num_options)]
        answer = options.index(row["answer"])  # (reference: star.py:23)
        text = PromptText(q_text=_question_text(row["question"]),
                          o_text=_options_text(options), options=options)
        qtype = QTYPE_MAPPINGS["star"][row["question_id"].split("_")[0]]
        return self._finish_item(row["video_id"], qtype, answer, text, idx,
                                 start=round(row["start"]),
                                 end=round(row["end"]))


class DramaQA(VideoQADataset):
    """JSON, 5 options; scene-level ids concatenate shot features
    (reference: dataloader/dramaqa.py)."""

    name = "dramaqa"

    def _load(self):
        with open(self.root / f"AnotherMissOhQA_{self.split}_set.json") as f:
            self.data = json.load(f)
        self.video_store = FeatureStore(str(self.root / "clipvitl14.pth"),
                                        self.features_dim, self.max_feats)
        print(f"Num {self.split} data: {len(self.data)}")

    def _video(self, vid: str, start=None, end=None, fps_scale=1):
        # start/end carry the scene's shot_contained range (passed explicitly
        # through _finish_item — no mutable reader state, safe for concurrent
        # get_item calls)
        from .feature_store import uniform_downsample
        if vid[-4:] == "0000":  # scene: concat contained shots
            if start is None or end is None:
                raise ValueError(
                    f"DramaQA scene vid {vid!r} needs its shot_contained "
                    f"range passed as start/end")
            chunks = []
            for i in range(start, end + 1):
                chunks.append(self.video_store.raw(vid[:-4] + f"{i:04d}"))
            feats = np.concatenate(chunks, axis=0)
            return uniform_downsample(feats, self.max_feats, self.features_dim)
        return self.video_store.get(vid)

    def get_item(self, idx: int) -> Item:
        row = self.data[idx]
        shots = row.get("shot_contained", [0, 0])
        options = row["answers"]
        text = PromptText(q_text=_question_text(row["que"]),
                          o_text=_options_text(options), options=options)
        return self._finish_item(row["vid"], -1, int(row["correct_idx"]),
                                 text, idx, start=shots[0], end=shots[1])


class VLEP(VideoQADataset):
    """JSONL, 2 options ('what happens next'), subtitle dialogue
    (reference: dataloader/vlep.py)."""

    name = "vlep"
    dialogue = True

    def _load(self):
        split = "dev" if self.split == "val" else self.split
        with open(self.root / f"vlep_{split}_release.jsonl") as f:
            self.data = [json.loads(x) for x in f]
        with open(self.root / "vlep_subtitles.jsonl") as f:
            subs = [json.loads(x) for x in f]
        self.subtitle = {s["vid_name"]: s["sub"] for s in subs}
        self.video_store = FeatureStore(str(self.root / "clipvitl14.pth"),
                                        self.features_dim, self.max_feats)
        print(f"Num {self.split} data: {len(self.data)}")

    def _dialogue_text(self, vid: str, start: int, end: int) -> str:
        if not self.cfg.sub:
            return ""
        dialogue = ""
        for t in self.subtitle.get(vid, []):
            s, e = round(int(t["start"])), int(t["end"])
            if (s >= start and e <= end) or (s <= start and e <= end
                                             and start <= e):
                dialogue += t["text"].replace("-", "")
        return f"Dialogue: {dialogue}\n"

    def get_item(self, idx: int) -> Item:
        row = self.data[idx]
        start, end = round(row["ts"][0]), round(row["ts"][1])
        options = row["events"]
        text = PromptText(
            q_text=_question_text(
                "Which event is more likely to happen right after"),
            o_text=_options_text(options), options=options,
            d_text=self._dialogue_text(row["vid_name"], start, end))
        return self._finish_item(row["vid_name"], -1, int(row["answer"]),
                                 text, idx, start=start, end=end)


_SRT_TIME = re.compile(
    r"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*(\d+):(\d+):(\d+)[,.](\d+)")


def parse_srt(text: str):
    """Minimal .srt parser (start_s, end_s, text) — replaces the reference's
    pysrt dependency (tvqa.py:31), including its quirk of ignoring hours
    (minutes·60 + seconds only, tvqa.py:33-34)."""
    cues = []
    for block in re.split(r"\n\s*\n", text.strip()):
        lines = [ln for ln in block.splitlines() if ln.strip()]
        if len(lines) < 2:
            continue
        m = _SRT_TIME.search(lines[1] if lines[0].strip().isdigit()
                             else lines[0])
        if not m:
            continue
        g = [int(x) for x in m.groups()]
        st = g[1] * 60 + g[2]   # minutes*60 + seconds (hours dropped)
        et = g[5] * 60 + g[6]
        body_start = 2 if lines[0].strip().isdigit() else 1
        body = " ".join(ln.replace("\n", " ") for ln in lines[body_start:])
        cues.append((st, et, body))
    return cues


class TVQA(VideoQADataset):
    """JSONL, 5 options, 3fps clip slicing, .srt subtitles
    (reference: dataloader/tvqa.py)."""

    name = "tvqa"
    dialogue = True

    def _load(self):
        with open(self.root / f"tvqa_{self.split}.jsonl") as f:
            self.data = [json.loads(x) for x in f]
        self.video_store = FeatureStore(str(self.root / "clipvitl14.pth"),
                                        self.features_dim, self.max_feats)
        self.subtitle_dir = self.root / "tvqa_subtitles"
        print(f"Num {self.split} data: {len(self.data)}")

    def _dialogue_text(self, vid: str, start: int, end: int) -> str:
        if not self.cfg.sub:
            return ""
        path = self.subtitle_dir / f"{vid}.srt"
        if not path.exists():
            return ""
        dialogue = ""
        for st, et, txt in parse_srt(path.read_text(errors="ignore")):
            if (st >= start and et <= end) or (st <= start and et <= end
                                               and start <= et):
                dialogue += " " + txt
        return f"Dialogue: {dialogue}\n" if dialogue else ""

    def get_item(self, idx: int) -> Item:
        row = self.data[idx]
        try:
            start, end = (round(float(x)) for x in row["ts"].split("-"))
        except Exception:
            start, end = -1000, 1000  # (reference: tvqa.py:169-172)
        options = [row[f"a{i}"] for i in range(self.num_options)]
        text = PromptText(q_text=_question_text(row["q"]),
                          o_text=_options_text(options), options=options,
                          d_text=self._dialogue_text(row["vid_name"], start,
                                                     end))
        return self._finish_item(row["vid_name"], -1, int(row["answer_idx"]),
                                 text, idx, start=start, end=end, fps_scale=3)


class MusicAVQA(VideoQADataset):
    """JSON, generation-style single ground-truth option, template filling,
    15 audio/visual/AV qtypes (reference: dataloader/musicavqa.py)."""

    name = "musicavqa"

    def _load(self):
        with open(self.root / f"avqa-{self.split}.json") as f:
            self.data = json.load(f)
        self.video_store = FeatureStore(str(self.root / "clipvitl14.pth"),
                                        self.features_dim, self.max_feats)
        print(f"Num {self.split} data: {len(self.data)}")

    @staticmethod
    def fill_template(question: str, templ_values) -> str:
        """Replace <placeholders> left-to-right (reference:
        musicavqa.py:159-165 — minus the eval() on untrusted strings)."""
        if isinstance(templ_values, str):
            templ_values = json.loads(templ_values.replace("'", '"'))
        for i, ph in enumerate(re.findall(r"<(.*?)>", question)):
            if i < len(templ_values):
                question = question.replace(f"<{ph}>", templ_values[i], 1)
        return question

    def get_item(self, idx: int) -> Item:
        row = self.data[idx]
        question = self.fill_template(row["question_content"],
                                      row.get("templ_values", "[]"))
        answer_text = row.get("anser", "")
        t = row["type"]
        tpair = json.loads(t.replace("'", '"')) if isinstance(t, str) else t
        qtype = QTYPE_MAPPINGS["musicavqa"][f"{tpair[0]}_{tpair[1]}"]
        options = [answer_text]
        text = PromptText(q_text=_question_text(question),
                          o_text=_options_text(options), options=options)
        return self._finish_item(row["video_id"], qtype, 0, text, idx)


class Valor32K(VideoQADataset):
    """CSV mcq_1..4, 4 options, modality×type qtype grid; rows filtered to
    available features (reference: dataloader/valor32k.py)."""

    name = "valor32k"

    def _load(self):
        with open(self.root / f"processed_{self.split}_data.csv") as f:
            rows = [r for r in csv.DictReader(f)
                    if all(v not in ("", None) for v in r.values())]
        self.video_store = FeatureStore(str(self.root / "clipvitl14.pth"),
                                        self.features_dim, self.max_feats)
        # keep rows whose features exist (reference: valor32k.py:22-31)
        self.data = [r for r in rows if r["video_id"] in self.video_store]
        print(f"Num {self.split} data: {len(self.data)}")

    def get_item(self, idx: int) -> Item:
        row = self.data[idx]
        options = [row[f"mcq_{i}"] for i in range(1, self.num_options + 1)]
        qtype = QTYPE_MAPPINGS["valor32k"][f"{row['type']}_{row['mode']}"]
        text = PromptText(q_text=_question_text(row["question"]),
                          o_text=_options_text(options), options=options)
        return self._finish_item(row["video_id"], qtype,
                                 int(row["correct_mcq"]), text, idx)


DATASETS: Dict[str, type] = {
    "nextqa": NextQA, "star": STAR, "dramaqa": DramaQA, "vlep": VLEP,
    "tvqa": TVQA, "musicavqa": MusicAVQA, "valor32k": Valor32K,
}


def build_dataset(cfg, tokenizer, split: str = "train") -> VideoQADataset:
    """(reference: dataloader/__init__.py:15-17)"""
    return DATASETS[cfg.dataset](cfg, tokenizer, split)
