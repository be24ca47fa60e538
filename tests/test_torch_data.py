"""The port's own copies of the host layers (flipped_tpu_torch.text, .data,
utils.metrics.log_qtype and the synthetic fixture writer) against the JAX
package's originals: the same inputs give equal arrays, array for array.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flipped_tpu.core.config import DataConfig as JDataConfig
from flipped_tpu.data import build_dataset as jbuild_dataset
from flipped_tpu.data import dataset_eval_span as jdataset_eval_span
from flipped_tpu.data import make_synthetic_items as jmake_items
from flipped_tpu.data import pack_eval_batch as jpack_eval
from flipped_tpu.data import pack_train_batch as jpack_train
from flipped_tpu.data.pipeline import Loader as JLoader
from flipped_tpu.text import MockTokenizer as JMockTokenizer
from flipped_tpu.text import load_tokenizer as jload_tokenizer
from flipped_tpu.utils.metrics import MetricLogger as JMetricLogger
from flipped_tpu.utils.metrics import log_qtype as jlog_qtype
from flipped_tpu_torch.core.config import DataConfig
from flipped_tpu_torch.data import (Loader, build_dataset, dataset_eval_span,
                                    load_data, make_synthetic_items,
                                    pack_eval_batch, pack_train_batch,
                                    pinned_eval_span)
from flipped_tpu_torch.data.pipeline import WorkerLoader
from flipped_tpu_torch.data.synthetic import make_musicavqa, make_nextqa
from flipped_tpu_torch.text import MockTokenizer, load_tokenizer
from flipped_tpu_torch.utils.metrics import MetricLogger, log_qtype

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_batches_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        if isinstance(r, np.ndarray):
            assert ours[k].dtype == r.dtype, k
            np.testing.assert_array_equal(ours[k], r, err_msg=k)
        else:
            assert list(ours[k]) == list(r), k


@pytest.mark.parametrize("split", ["train", "val"])
def test_pack_batches_equal_jax(split):
    kw = dict(max_feats=6, max_seq_len=96, split=split, visual_dim=16,
              seed=4)
    ours = make_synthetic_items(MockTokenizer(512), 5, **kw)
    ref = jmake_items(JMockTokenizer(512), 5, **kw)
    pack, jpack = ((pack_train_batch, jpack_train) if split == "train"
                   else (pack_eval_batch, jpack_eval))
    assert_batches_equal(pack(ours, 6), jpack(ref, 6))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """NExT-QA, then MUSIC-AVQA fixtures from the port's writer, beside the
    script's, each pair from one RandomState in the script's order."""
    ours = tmp_path_factory.mktemp("port_fixtures")
    rs = np.random.RandomState(3)
    make_nextqa(str(ours), 12, rs)
    make_musicavqa(str(ours), 12, rs)
    ref = tmp_path_factory.mktemp("script_fixtures")
    script = _load_script("make_synthetic_data")
    rs = np.random.RandomState(3)
    script.make_nextqa(str(ref), 12, rs)
    script.make_musicavqa(str(ref), 12, rs)
    return str(ours), str(ref)


FEATURE_FILES = ("clipvitl14.pth", "audio_imagebind.pth",
                 "audio_imagebind_clip.pth")


def assert_feature_files_equal(ours, ref, dataset):
    """The video and both audio feature dicts equal the script's, tensor
    for tensor: (16, 768), (10, 1024) and (1, 1024) a video."""
    for name, shape in zip(FEATURE_FILES, ((16, 768), (10, 1024),
                                           (1, 1024))):
        fa = torch.load(os.path.join(ours, dataset, name))
        fb = torch.load(os.path.join(ref, dataset, name))
        assert sorted(fa) == sorted(fb), name
        assert all(torch.equal(fa[k], fb[k]) and fa[k].shape == shape
                   for k in fa), name


def test_fixture_writer_matches_script(fixtures):
    ours, ref = fixtures
    for name in ("train.csv", "val.csv"):
        with open(os.path.join(ours, "nextqa", name)) as a, \
                open(os.path.join(ref, "nextqa", name)) as b:
            assert a.read() == b.read(), name
    assert_feature_files_equal(ours, ref, "nextqa")


def test_musicavqa_fixture_writer_matches_script(fixtures):
    """The JSON files, the video features and both audio feature files
    equal the script's, and nothing else is written."""
    ours, ref = fixtures
    for name in ("avqa-train.json", "avqa-val.json"):
        with open(os.path.join(ours, "musicavqa", name)) as a, \
                open(os.path.join(ref, "musicavqa", name)) as b:
            assert a.read() == b.read(), name
    assert_feature_files_equal(ours, ref, "musicavqa")
    assert sorted(os.listdir(os.path.join(ours, "musicavqa"))) == sorted(
        ("avqa-train.json", "avqa-val.json") + FEATURE_FILES)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("merge", ["sum", "attention"])
def test_audio_batches_equal_jax(fixtures, merge, split):
    """With --audio, the port's reader and loader pack the audio store of
    the merge (the (10, 1024) features under sum, the (1, 1024) clip
    embedding under attention) as JAX's do, array for array."""
    kw = dict(dataset="nextqa", data_root=fixtures[0], batch_size=3,
              max_seq_len=128, max_feats=10, seed=1, audio=True,
              audio_merge=merge)
    ours = build_dataset(DataConfig(**kw), MockTokenizer(32000), split)
    ref = jbuild_dataset(JDataConfig(**kw), JMockTokenizer(32000), split)
    shuffle = split == "train"
    a = Loader(ours, 3, shuffle=shuffle, seed=1, split=split, prefetch=0)
    b = JLoader(ref, 3, shuffle=shuffle, seed=1, split=split, prefetch=0)
    assert len(a) == len(b)
    n_audio = 1 if merge == "attention" else 10
    for x, y in zip(a, b):
        assert x["audio"].shape[-2:] == (n_audio, 1024)
        assert_batches_equal(x, y)


def test_musicavqa_generation_batches_equal_jax(fixtures):
    """The generation-task val batches (prefix, qid, gt_answer) of the port's
    MUSIC-AVQA reader and loader equal JAX's."""
    kw = dict(dataset="musicavqa", data_root=fixtures[0], batch_size=2,
              max_seq_len=128, max_feats=10, is_generation_task=True, seed=1)
    ours = build_dataset(DataConfig(**kw), MockTokenizer(32000), "val")
    ref = jbuild_dataset(JDataConfig(**kw), JMockTokenizer(32000), "val")
    a = Loader(ours, 2, shuffle=False, split="val", prefetch=0)
    b = JLoader(ref, 2, shuffle=False, split="val", prefetch=0)
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert_batches_equal(x, y)


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_and_loader_equal_jax(fixtures, split):
    root = fixtures[0]
    kw = dict(dataset="nextqa", data_root=root, batch_size=4,
              max_seq_len=128, max_feats=10, seed=1)
    ours = build_dataset(DataConfig(**kw), MockTokenizer(32000), split)
    ref = jbuild_dataset(JDataConfig(**kw), JMockTokenizer(32000), split)
    assert len(ours) == len(ref)
    shuffle = split == "train"
    accum = 2 if shuffle else 1
    a = Loader(ours, 2, accum_iter=accum, shuffle=shuffle, seed=1,
               split=split, prefetch=0)
    b = JLoader(ref, 2, accum_iter=accum, shuffle=shuffle, seed=1,
                split=split, prefetch=0)
    a.set_epoch(1)
    b.set_epoch(1)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert_batches_equal(x, y)
    assert dataset_eval_span(ours) == jdataset_eval_span(ref)


def test_load_data_single_process_and_refusals(fixtures):
    """One process; `--loader grain` is the worker-pool loader, an unknown
    backend raises."""
    cfg = DataConfig(dataset="nextqa", data_root=fixtures[0], batch_size=3)
    loader = load_data(cfg, MockTokenizer(32000), "train", accum_iter=2)
    assert (loader.process_index, loader.process_count) == (0, 1)
    assert loader.accum_iter == 2 and loader.shuffle
    assert pinned_eval_span(loader.dataset, 128) is None
    grain = load_data(cfg, MockTokenizer(32000), "train", backend="grain",
                      num_workers=2)
    assert isinstance(grain, WorkerLoader) and grain.num_workers == 2
    with pytest.raises(ValueError, match="loader"):
        load_data(cfg, MockTokenizer(32000), "train", backend="tf.data")


def test_spm_tokenizer_copy_encodes_like_jax(tmp_path):
    path = tmp_path / "tokenizer.model"
    subprocess.run([sys.executable, "scripts/make_synthetic_tokenizer.py",
                    "--out", str(path)], check=True, capture_output=True,
                   cwd=ROOT)
    ours, ref = load_tokenizer(str(path)), jload_tokenizer(str(path))
    assert type(ours).__name__ == type(ref).__name__
    for text in ("Question: What does the dog do?\n", "Answer: é ü 42",
                 "Video"):
        assert ours.encode(text, bos=True, eos=False) == \
            ref.encode(text, bos=True, eos=False)


def test_log_qtype_equals_jax():
    rs = np.random.RandomState(0)
    qtypes = rs.randint(0, 9, 40)
    correct = (rs.rand(40) > 0.5).astype(np.float32)
    ours, ref = MetricLogger(), JMetricLogger()
    log_qtype("nextqa", qtypes, correct, ours)
    jlog_qtype("nextqa", qtypes, correct, ref)
    assert ours.averages() == pytest.approx(
        {k: m.global_avg for k, m in ref.meters.items()})
