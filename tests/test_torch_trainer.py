"""The rest of flipped_tpu_torch's trainer against the JAX package, on the
CPU: `--remat_policy qkv`, the metric logger and its progress lines,
`--trace_dir`, and `--loader grain`.

- qkv: one update's losses and gradients equal the 'full' policy's bit for
  bit (the recompute hands back the forward's own attention outputs),
  per block and with --remat_group 2; the attention forward runs once per
  block an update under qkv, twice under full (counted by patching the
  plain K1 the CPU takes); and the gradients are JAX's remat_policy="qkv"
  gradients within tests/test_torch_train.py's parity tolerance.
- `SmoothedValue`, `MetricLogger.averages()` and `log_every`'s lines equal
  JAX's on one value stream (times masked); no memory field on the CPU.
- `--trace_dir` traces steps 1 to 3 of a 4-batch epoch and nothing of a
  one-step --debug epoch.
- `--loader grain --num_workers 2` yields the thread loader's batches array
  for array over two epochs, train and val, and keeps JAX's Grain
  contract.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.data import make_synthetic_items, pack_train_batch
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.text import MockTokenizer as JMockTokenizer
from flipped_tpu.train import merge_params, partition_params
from flipped_tpu.train.objectives import \
    compute_objective_losses as jcompute_objective_losses
from flipped_tpu.utils import metrics as jmetrics
from flipped_tpu_torch.ckpt import params_from_flax
from flipped_tpu_torch.ckpt.convert import flatten_flax, \
    flax_path_to_torch_name
from flipped_tpu_torch.cli import train as ttrain
from flipped_tpu_torch.core.config import (DataConfig, ModelConfig,
                                           get_args_parser)
from flipped_tpu_torch.data import build_dataset, load_data
from flipped_tpu_torch.data.pipeline import WorkerLoader
from flipped_tpu_torch.data.synthetic import make_nextqa
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.model.kernels import flash_attention as fa
from flipped_tpu_torch.text import MockTokenizer
from flipped_tpu_torch.train import (compute_objective_losses,
                                     trainable_parameters)
from flipped_tpu_torch.train.step import TrainMetrics
from flipped_tpu_torch.utils import metrics

# tests/test_torch_train.py's model and parity tolerance
KW = dict(dim=32, n_layers=2, n_heads=4, vocab_size=512, multiple_of=16,
          max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
          visual_dim=16)
PARITY_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    cfg = JModelConfig(**KW)
    items = make_synthetic_items(JMockTokenizer(cfg.vocab_size), 4,
                                 max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len,
                                 visual_dim=cfg.visual_dim, seed=5)
    batch = pack_train_batch(items, cfg.max_feats)
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
                    trainable_dtype=jnp.float32, use_flash=False)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(1), jnp.array(batch["vqa_tokens"]),
        jnp.array(batch["video"]), None, jnp.array(batch["vqa_video_start"]),
        jnp.array(batch["vqa_splice"]))["params"])
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.3, np.float32)
    return jmodel, params, batch


def port_grads(params, batch, **remat):
    """(losses, {trainable: grad}) of one update's forward and backward."""
    model = FlippedVQAModel(ModelConfig(**KW), dtype=torch.float32,
                            frozen_dtype=torch.float32,
                            trainable_dtype=torch.float32, **remat)
    model.load_state_dict(params_from_flax(params), strict=True)
    named = trainable_parameters(model)
    losses = compute_objective_losses(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        vaq=True, qav=True)
    losses.total.backward()
    return ([x.detach() for x in losses],
            {n: p.grad for n, p in named})


@pytest.mark.parametrize("group,streaming", [(1, False), (2, False),
                                             (1, True)])
def test_qkv_remat_equals_full_and_runs_attention_once(setup, group,
                                                       streaming,
                                                       monkeypatch):
    """The losses and every gradient under qkv equal full's bit for bit at
    f32 (full's equal no remat's: tests/test_torch_train.py). The plain K1
    (what the CPU runs for K1) runs twice per block an update under full
    (4 calls at 2 blocks: the forward and the recompute) and once per
    block under qkv (2), per block and in a --remat_group 2 unit alike;
    and so does the plain K5 in the streaming regime (MAX_SEQ_BWD set
    below S, as tests/test_torch_streaming.py sets it; 2 examples, since
    the plain streaming kernels run a head at a time)."""
    _, params, batch = setup
    calls = []
    name = "flash_streaming_fwd" if streaming else "flash_text_attention"
    plain = getattr(fa, name)

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(fa, name, counted)
    if streaming:
        monkeypatch.setattr(fa, "MAX_SEQ_BWD", 32)
        batch = {k: v[:2] for k, v in batch.items()}
    out, n_calls = {}, {}
    for policy in ("full", "qkv"):
        calls.clear()
        out[policy] = port_grads(params, batch, remat=True,
                                 remat_group=group, remat_policy=policy)
        n_calls[policy] = len(calls)
    assert n_calls == {"full": 4, "qkv": 2}
    assert fa._KEPT is None
    assert all(torch.equal(a, b) for a, b in zip(out["qkv"][0],
                                                 out["full"][0]))
    assert out["qkv"][1].keys() == out["full"][1].keys()
    for n, g in out["full"][1].items():
        assert torch.equal(out["qkv"][1][n], g), n


@pytest.mark.parametrize("group", [1, 2])
def test_qkv_remat_grads_match_jax(setup, group):
    """Under remat_policy 'qkv' (and --remat_group `group`) the port's
    gradients are JAX's qkv gradients within the parity tolerance."""
    jmodel, params, batch = setup
    jmodel = jmodel.clone(remat=True, remat_policy="qkv", remat_group=group)
    trainable, frozen = partition_params(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def total(t):
        losses = jcompute_objective_losses(
            jmodel, {"params": merge_params(t, frozen)}, jb, True, True)
        return losses.vqa + losses.vaq + losses.qav

    grads = jax.jit(jax.grad(total))(trainable)
    _, got = port_grads(params, batch, remat=True, remat_group=group,
                        remat_policy="qkv")
    flat = {flax_path_to_torch_name(p): np.asarray(g).T
            if p.endswith("/kernel") else np.asarray(g)
            for p, g in flatten_flax(grads).items() if g is not None}
    assert set(flat) == set(got)
    for n, want in flat.items():
        np.testing.assert_allclose(got[n].numpy(), want, err_msg=n,
                                   **PARITY_TOL)


STREAM = [(3.0, 1), (1.0, 2), (4.0, 1), (1.5, 3), (5.0, 1), (9.0, 2),
          (2.0, 1), (6.0, 4), (5.0, 1), (3.5, 1)]


def test_smoothed_value_and_averages_match_jax():
    """One weighted value stream through both packages' meters: median,
    avg, global_avg, max, value (window 4 and the default), their strings,
    and the logger's count-weighted averages."""
    for window in (4, 20):
        ours, ref = (metrics.SmoothedValue(window_size=window),
                     jmetrics.SmoothedValue(window_size=window))
        for v, n in STREAM:
            ours.update(v, n=n)
            ref.update(v, n=n)
            for attr in ("median", "avg", "global_avg", "max", "value"):
                assert getattr(ours, attr) == getattr(ref, attr), attr
            assert str(ours) == str(ref)
    ours, ref = metrics.MetricLogger(), jmetrics.MetricLogger()
    for logger, pkg in ((ours, metrics), (ref, jmetrics)):
        logger.add_meter("lr", pkg.SmoothedValue(window_size=1,
                                                 fmt="{value:.6f}"))
        for v, n in STREAM:
            logger.update(n=n, acc=v / 10, loss=v)
            logger.update(lr=v * 1e-3)
    assert ours.averages() == ref.averages()
    assert str(ours) == str(ref)


def _masked(text):
    """Printed lines with their clock readings masked, the time-of-day
    prefix too that a print replaced by another test of the same process
    (JAX's `setup_for_distributed`) adds."""
    text = re.sub(r"(?m)^\[\d+:\d+:\d+\.\d+\] ", "", text)
    text = re.sub(r"(time|data): \d+\.\d+", r"\1: T", text)
    text = re.sub(r"eta: \S+", "eta: T", text)
    return re.sub(r"Total time: \S+ \(\d+\.\d+ s / it\)", "Total time: T",
                  text)


@pytest.mark.parametrize("sized", [False, True])
def test_log_every_prints_like_jax(capsys, sized):
    """`log_every` over 10 iterations at print_freq 3 prints at the
    iterations JAX's does, with the same fields (the train loop's
    `iter(loader)`, which has no length, and a sized iterable, which adds
    the eta, the last iteration and the total-time line); no memory field
    on the CPU in either."""
    printed = []
    for logger in (metrics.MetricLogger(), jmetrics.MetricLogger()):
        data = list(range(10))
        for i in logger.log_every(data if sized else iter(data), 3,
                                  "Epoch: [0]"):
            logger.update(loss=STREAM[i][0], grad_norm=STREAM[i][1])
        printed.append(_masked(capsys.readouterr().out))
    assert printed[0] == printed[1]
    lines = printed[0].splitlines()
    assert [re.search(r"\] \[(\d+)", x).group(1) for x in lines
            if "loss" in x] == (["0", "3", "6", "9"])
    assert ("Total time" in printed[0]) == sized
    assert "hbm" not in printed[0] and metrics.device_memory_gib() is None


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trainer_data")
    make_nextqa(str(root), 8, np.random.RandomState(0))
    return str(root)


def _args(synth_root, *extra):
    return get_args_parser().parse_args(
        ["--model", "tiny", "--dataset", "nextqa", "--data_root", synth_root,
         "--batch_size", "2", "--device", "cpu", "--epochs", "1",
         "--output_dir", "", *extra])


def test_trace_dir_traces_steps_1_to_3(synth_root, tmp_path):
    """A 4-batch epoch of the train CLI under --trace_dir writes one Chrome
    trace holding the spans of train steps 1, 2 and 3 (JAX: steps 1 to
    min(4, len - 1)); an epoch of one step (--debug's) writes none, as in
    JAX."""
    trace_dir = str(tmp_path / "trace")
    _, history = ttrain.main(_args(synth_root, "--trace_dir", trace_dir))
    assert history[0]["train_steps"] == 4
    assert os.listdir(trace_dir) == ["train_epoch0.pt.trace.json"]
    with open(ttrain.trace_file(trace_dir, 0)) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted({e["name"] for e in events
                    if e.get("name", "").startswith("train step")})
    assert steps == ["train step 1", "train step 2", "train step 3"]
    # the program's spans, each step's phases inside its `train.step`
    marked = [e for e in events if "span" in e.get("args", {})]
    phases = [e["args"]["span"] for e in marked]
    assert sorted(set(phases)) == ["train.backward", "train.forward",
                                   "train.step", "train.update"]
    assert all(phases.count(p) == 3 for p in phases)     # accum_iter 1
    for e in marked:
        p = e["args"]["parent"]
        if p >= 0:
            outer = next(o for o in marked if o["args"]["index"] == p)
            assert outer["args"]["span"] == "train.step"
            assert outer["ts"] <= e["ts"] <= e["ts"] + e["dur"] \
                <= outer["ts"] + outer["dur"]

    class OneBatch:
        def __len__(self):
            return 1

        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            yield {}

    one = torch.ones(())
    step = lambda batch: TrainMetrics(one, one, one, one, one, 0.0)
    debug_dir = str(tmp_path / "debug_trace")
    ttrain.train_one_epoch(step, OneBatch(), 0, "cpu", trace_dir=debug_dir)
    assert not os.path.exists(debug_dir)


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert list(a[k]) == list(b[k]), k


@pytest.mark.parametrize("split", ["train", "val"])
def test_grain_loader_equals_the_thread_loader(synth_root, split):
    """`--loader grain --num_workers 2` yields the thread loader's batches,
    array for array, over two epochs (train shuffled per epoch, 8 items in
    batches of 3: a padded tail)."""
    cfg = DataConfig(dataset="nextqa", data_root=synth_root, batch_size=3,
                     seed=2)
    tok = MockTokenizer(512)
    grain = load_data(cfg, tok, split, backend="grain", num_workers=2)
    thread = load_data(cfg, tok, split)
    assert isinstance(grain, WorkerLoader) and len(grain) == len(thread)
    for epoch in (0, 1):
        grain.set_epoch(epoch)
        thread.set_epoch(epoch)
        got, want = list(grain), list(thread)
        assert len(got) == len(want) == len(grain)
        for a, b in zip(got, want):
            _equal_batches(a, b)


def test_grain_loader_keeps_the_grain_contract(synth_root):
    """JAX's GrainLoader contract (tests/test_datasets.py): every example
    once an epoch, the tail padded to the fixed shapes with `valid`, and
    equal batch counts on every process of an odd split."""
    cfg = DataConfig(dataset="nextqa", data_root=synth_root, batch_size=3,
                     max_seq_len=128)
    ds = build_dataset(cfg, MockTokenizer(512), "train")
    loader = WorkerLoader(ds, 3, num_workers=2, seed=0, split="train")
    loader.set_epoch(1)
    plan = loader._plan()
    seen = np.concatenate([sel[:valid] for sel, valid in plan])
    assert sorted(seen) == list(range(len(ds)))
    batches = list(loader)
    assert [int(b["valid"]) for b in batches] == [3, 3, 2]
    assert all(b["vqa_tokens"].shape == (1, 3, 128) for b in batches)
    assert (batches[-1]["vqa_labels"][0, 2:] == 0).all()
    val = build_dataset(cfg, MockTokenizer(512), "val")     # 2 rows
    counts = []
    for rank in range(3):
        shard = WorkerLoader(val, 1, num_workers=2, shuffle=False,
                             split="val", process_index=rank,
                             process_count=3)
        counts.append(len(list(shard)))
        assert counts[-1] == len(shard)
    assert counts == [1, 1, 1]
