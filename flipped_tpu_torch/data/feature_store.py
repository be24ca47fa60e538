"""Cached visual/audio feature stores + frame sampling.

The port's own copy of flipped_tpu/data/feature_store.py, kept here so that
flipped_tpu_torch imports nothing of the JAX package; tests hold the
two copies equal.

The reference torch.loads multi-GB `clipvitl14.pth` dicts per rank at startup
(reference: dataloader/nextqa.py:18-19, SURVEY.md §3.1) and keeps them in
host RAM. Here the store is format-pluggable: .pth (torch, matching the
reference's artifacts), .npz, or a directory of per-video .npy files
(reference: valor32k.py:22-24). Tensors are converted to numpy once on load —
device copies happen at batch time.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np


def uniform_downsample(feats: np.ndarray, max_feats: int,
                       features_dim: int) -> Tuple[np.ndarray, int]:
    """Stride-sample to max_feats frames / zero-pad shorter clips
    (reference: nextqa.py:71-82 — index (j·n)//max_feats)."""
    feats = np.asarray(feats, dtype=np.float32)
    if feats.ndim == 1:
        feats = feats[None]
    n = len(feats)
    if n > max_feats:
        idx = (np.arange(max_feats) * n) // max_feats
        return feats[idx], max_feats
    if n < max_feats:
        pad = np.zeros((max_feats - n, features_dim), np.float32)
        return np.concatenate([feats, pad], axis=0), n
    return feats, max_feats


class FeatureStore:
    """vid → (n_frames, dim) float feature lookup with a zero-vector fallback
    for missing ids (reference: nextqa.py:65-67)."""

    def __init__(self, path: str, features_dim: int, max_feats: int,
                 pad_short: bool = True):
        self.path = path
        self.features_dim = features_dim
        self.max_feats = max_feats
        self.pad_short = pad_short
        self._dict: Optional[Dict[str, np.ndarray]] = None
        self._dir: Optional[Path] = None
        self._load()

    def _load(self):
        p = Path(self.path)
        if p.is_dir():
            self._dir = p
        elif p.suffix == ".pth":
            import torch  # host-side only, matching the reference artifacts
            raw = torch.load(str(p), map_location="cpu", weights_only=False)
            self._dict = {k: v.float().numpy() if hasattr(v, "numpy")
                          else np.asarray(v, np.float32)
                          for k, v in raw.items()}
        elif p.suffix == ".npz":
            self._dict = dict(np.load(str(p)))
        else:
            raise ValueError(f"unsupported feature store: {p}")

    def __contains__(self, vid: str) -> bool:
        if self._dict is not None:
            return vid in self._dict
        return ((self._dir / f"{vid}.npy").exists())

    def raw(self, vid: str) -> np.ndarray:
        if self._dict is not None:
            if vid not in self._dict:
                print(vid, "video not found!")
                return np.zeros((1, self.features_dim), np.float32)
            return np.asarray(self._dict[vid], np.float32)
        f = self._dir / f"{vid}.npy"
        if not f.exists():
            print(vid, "video not found!")
            return np.zeros((1, self.features_dim), np.float32)
        return np.load(str(f)).astype(np.float32)

    def get(self, vid: str, start: Optional[int] = None,
            end: Optional[int] = None, fps_scale: int = 1,
            sample: bool = True) -> Tuple[np.ndarray, int]:
        """Fetch + optional [start,end] clip-window slice (reference:
        star.py:33-38; tvqa 3fps scaling, tvqa.py:60) + downsample."""
        feats = self.raw(vid)
        if start is not None and vid in self:
            lo = max(start * fps_scale, 0)
            hi = (end + 1) * fps_scale
            feats = feats[lo:hi]
            if len(feats) == 0:
                feats = np.zeros((1, self.features_dim), np.float32)
        if not sample:
            return feats, len(feats)
        if not self.pad_short and len(feats) <= self.max_feats:
            # 'attention' audio merge keeps the (1, dim) clip embedding
            # un-padded (reference: nextqa.py:122)
            return feats, len(feats)
        return uniform_downsample(feats, self.max_feats, self.features_dim)
