"""Host-side data layer: the port's own copies of flipped_tpu.data's numpy
modules, plus a synthetic NExT-QA and MUSIC-AVQA fixture writer
(`synthetic.py`)."""
from .batching import (Item, add_accum_axis, eval_span, make_synthetic_items,
                       mask_tail_rows, pack_eval_batch, pack_train_batch)
from .feature_store import FeatureStore, uniform_downsample
from .datasets import (DATASETS, NUM_OPTIONS, QTYPE_MAPPINGS, DramaQA,
                       MusicAVQA, NextQA, STAR, TVQA, Valor32K,
                       VideoQADataset, VLEP, build_dataset, parse_srt)
from .pipeline import (Loader, dataset_eval_span, load_data,
                       pinned_eval_span)

__all__ = [
    "Item", "add_accum_axis", "eval_span", "make_synthetic_items",
    "mask_tail_rows", "pack_eval_batch",
    "pack_train_batch", "FeatureStore", "uniform_downsample", "DATASETS",
    "NUM_OPTIONS", "QTYPE_MAPPINGS", "DramaQA", "MusicAVQA", "NextQA",
    "STAR", "TVQA", "Valor32K", "VideoQADataset", "VLEP", "build_dataset",
    "parse_srt", "Loader", "dataset_eval_span", "load_data",
    "pinned_eval_span",
]
