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


def test_fixture_writer_matches_script(fixtures):
    ours, ref = fixtures
    for name in ("train.csv", "val.csv"):
        with open(os.path.join(ours, "nextqa", name)) as a, \
                open(os.path.join(ref, "nextqa", name)) as b:
            assert a.read() == b.read(), name
    fa = torch.load(os.path.join(ours, "nextqa", "clipvitl14.pth"))
    fb = torch.load(os.path.join(ref, "nextqa", "clipvitl14.pth"))
    assert sorted(fa) == sorted(fb)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)


def test_musicavqa_fixture_writer_matches_script(fixtures):
    """The JSON files and the feature dict equal the script's; the script's
    audio feature files are not written (audio is not ported)."""
    ours, ref = fixtures
    for name in ("avqa-train.json", "avqa-val.json"):
        with open(os.path.join(ours, "musicavqa", name)) as a, \
                open(os.path.join(ref, "musicavqa", name)) as b:
            assert a.read() == b.read(), name
    fa = torch.load(os.path.join(ours, "musicavqa", "clipvitl14.pth"))
    fb = torch.load(os.path.join(ref, "musicavqa", "clipvitl14.pth"))
    assert sorted(fa) == sorted(fb)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert sorted(os.listdir(os.path.join(ours, "musicavqa"))) == [
        "avqa-train.json", "avqa-val.json", "clipvitl14.pth"]


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
    cfg = DataConfig(dataset="nextqa", data_root=fixtures[0], batch_size=3)
    loader = load_data(cfg, MockTokenizer(32000), "train", accum_iter=2)
    assert (loader.process_index, loader.process_count) == (0, 1)
    assert loader.accum_iter == 2 and loader.shuffle
    assert pinned_eval_span(loader.dataset, 128) is None
    with pytest.raises(NotImplementedError, match="grain"):
        load_data(cfg, MockTokenizer(32000), "train", backend="grain")


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
