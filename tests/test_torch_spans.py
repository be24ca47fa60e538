"""The port's program spans (flipped_tpu_torch/utils/spans.py), on the CPU.

Held: with no recorder open `span` is one shared null context that reads
no clock; nesting, parents and stamps on `time.time_ns()`; the spans that
one tiny `gen_step`, `train_step` (accum 2) and cached and dense
`eval_step` open (the dense scorer opens none of its own), and their outputs bit for bit equal with the recorder
open and closed; `rollup`'s attribution by launch time on synthetic ops;
`analyze_trace`'s rollup by span on a synthetic Chrome trace, and
chip_smoke's check of the K1/K2 kernels in a traced step, which reads the
analyzer's ops; the train CLI's trace is held in
tests/test_torch_trainer.py.
"""
import copy
import json
import threading
import time

import pytest
import torch

from flipped_tpu_torch.core.config import ModelConfig, TrainConfig
from flipped_tpu_torch.data import (add_accum_axis, make_synthetic_items,
                                    pack_eval_batch, pack_train_batch)
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.text import MockTokenizer
from flipped_tpu_torch.train import make_generation_step, make_optimizer
from flipped_tpu_torch.train.step import make_eval_step, make_train_step
from flipped_tpu_torch.utils import spans
from flipped_tpu_torch.utils.spans import DeviceOp, Span, record, span

KW = dict(dim=32, n_layers=2, n_heads=4, vocab_size=512, multiple_of=16,
          max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
          visual_dim=16)
HOST_KEYS = ("answer", "qtype", "gt_answer", "qid", "valid", "span_need",
             "span_exact")
N_NEW = 4


def _names(rec):
    return [s.name for s in rec.spans]


def test_span_without_recorder_is_one_null_context(monkeypatch):
    def no_clock():
        raise AssertionError("read the clock with no recorder open")

    monkeypatch.setattr(spans.time, "time_ns", no_clock)
    a, b = span("gen.decode"), span("train.step")
    assert a is b
    with a:
        with b:
            pass
    monkeypatch.undo()
    with record() as rec:
        pass
    assert rec.spans == []


def _open_side():
    with span("side"):
        pass


def test_nesting_parents_and_wall_clock():
    t0 = time.time_ns()
    with record() as rec:
        with span("a"):
            with span("b"):
                pass
            side = threading.Thread(target=_open_side)
            side.start()
            side.join(timeout=10)
            assert not side.is_alive()
            with span("c"):
                with span("d"):
                    pass
        with pytest.raises(RuntimeError, match="already open"):
            with record():
                pass
    t1 = time.time_ns()
    got = rec.spans
    assert [s.name for s in got] == ["a", "b", "side", "c", "d"]
    # the other thread's span has no parent: the stack is per thread
    assert [s.parent for s in got] == [-1, 0, -1, 0, 3]
    for s in got:
        assert t0 <= s.start_ns <= s.end_ns <= t1
    a, b, _, c, d = got
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns
    assert c.start_ns <= d.start_ns <= d.end_ns <= c.end_ns <= a.end_ns
    assert spans._open_recorder is None
    assert span("a") is span("b")


def _model(seed=0):
    torch.manual_seed(seed)
    model = FlippedVQAModel(ModelConfig(**KW), dtype=torch.float32,
                            frozen_dtype=torch.float32,
                            trainable_dtype=torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.copy_(0.3 * torch.randn_like(p))
    return model


def _eval_batch(n=3, seed=9):
    items = make_synthetic_items(MockTokenizer(KW["vocab_size"]), n,
                                 max_feats=KW["max_feats"],
                                 max_seq_len=KW["max_seq_len"], split="val",
                                 visual_dim=KW["visual_dim"], seed=seed)
    batch = pack_eval_batch(items, KW["max_feats"])
    return {k: torch.tensor(v) for k, v in batch.items()
            if k not in HOST_KEYS}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_gen_step_spans_and_outputs():
    model, batch = _model(), _eval_batch()
    step = make_generation_step(model, eos_id=2, max_new_tokens=N_NEW)
    closed = step(batch)
    with record() as rec:
        opened = step(batch)
    _equal(closed, opened)
    names = _names(rec)
    assert names.count("gen.step") == 1 and names.count("gen.prefill") == 1
    assert names.count("gen.match") == 1
    assert names.count("gen.decode") == N_NEW - 1
    assert names.count("model.decode_attention") == \
        KW["n_layers"] * (N_NEW - 1)
    got = rec.spans
    for s in got:
        parent = got[s.parent].name if s.parent >= 0 else None
        assert parent == {"gen.step": None,
                          "model.decode_attention": "gen.decode"}.get(
                              s.name, "gen.step")


def test_train_step_spans_and_outputs_at_accum_2():
    items = make_synthetic_items(MockTokenizer(KW["vocab_size"]), 4,
                                 max_feats=KW["max_feats"],
                                 max_seq_len=KW["max_seq_len"],
                                 visual_dim=KW["visual_dim"], seed=5)
    batch = {k: torch.tensor(v) for k, v in add_accum_axis(
        pack_train_batch(items, KW["max_feats"]), 2).items()}
    cfg = TrainConfig(accum_iter=2, vaq=True, qav=True, epochs=8,
                      warmup_epochs=1.0, lr=1e-2, weight_decay=0.1)
    runs = []
    for recorded in (False, True):
        model = _model(1)
        step = make_train_step(model, make_optimizer(model, cfg, 4, 4),
                               vaq=True, qav=True)
        step(batch)                        # update 1 runs at lr 0 (warmup)
        if recorded:
            with record() as rec:
                m = step(batch)
        else:
            m = step(batch)
        runs.append((m, copy.deepcopy(model.state_dict())))
    (m0, s0), (m1, s1) = runs
    for a, b in zip(m0[:5], m1[:5]):
        assert torch.equal(a, b)
    assert m0.lr == m1.lr
    _equal(s0, s1)
    names = _names(rec)
    assert sorted(names) == sorted(["train.step", "train.forward",
                                    "train.backward", "train.forward",
                                    "train.backward", "train.update"])
    assert all(s.parent == 0 for s in rec.spans[1:])


@pytest.mark.parametrize("cached,phases", [
    (True, ["eval.step", "eval.prefill", "eval.extend"]),
    (False, ["eval.step"])])
def test_eval_step_spans_and_outputs(cached, phases):
    model, batch = _model(2), _eval_batch(seed=4)
    step = make_eval_step(model, cached=cached)
    closed = step(batch)
    with record() as rec:
        opened = step(batch)
    _equal(closed, opened)
    assert _names(rec) == phases
    assert [s.parent for s in rec.spans] == [-1] + [0] * (len(phases) - 1)


def test_rollup_by_launch_time():
    # step [0, 100] ⊃ decode [10, 50] ⊃ attention [20, 30]
    recorded = [Span("gen.step", 0, 100, -1), Span("gen.decode", 10, 50, 0),
                Span("model.decode_attention", 20, 30, 1),
                Span("gen.decode", 60, 90, 0)]
    ops = [DeviceOp("attn", 200, 210, 25),      # in the attention
           DeviceOp("mlp", 215, 230, 40),       # in decode 1, 5 ns after
           DeviceOp("head", 240, 250, 70),      # in decode 2
           DeviceOp("sync", 260, 262, 95),      # in the step alone
           DeviceOp("fetch", 300, 310, 120),    # after every span
           DeviceOp("orphan", 320, 330, None)]  # no launch in the profile
    got = spans.rollup(recorded, ops)
    assert got["gen.step"] == {"count": 1, "host_s": pytest.approx(100e-9),
                               "device_s": pytest.approx(37e-9),
                               "launches": 4,
                               "idle_s": pytest.approx(25e-9)}
    assert got["gen.decode"]["count"] == 2
    assert got["gen.decode"]["host_s"] == pytest.approx(70e-9)
    assert got["gen.decode"]["device_s"] == pytest.approx(35e-9)
    assert got["gen.decode"]["launches"] == 3
    # idle inside each decode's device interval: 5 ns in the first, 0
    assert got["gen.decode"]["idle_s"] == pytest.approx(5e-9)
    assert got["model.decode_attention"]["device_s"] == pytest.approx(10e-9)
    assert got["model.decode_attention"]["launches"] == 1
    assert got[spans.NONE]["launches"] == 2
    assert got[spans.NONE]["device_s"] == pytest.approx(20e-9)
    assert spans.attributed_share(got, ops) == pytest.approx(37 / 57)

    from flipped_tpu_torch.cli import profile
    fields = profile.by_span(recorded, ops, steps=2)
    assert fields["launches_per_step_by_span"]["gen.decode"] == 1.5
    assert fields["device_ms_per_step_by_span"]["gen.step"] == \
        pytest.approx(37e-6 / 2)
    assert fields["host_ms_per_step_by_span"]["gen.decode"] == \
        pytest.approx(35e-6)
    assert fields["idle_ms_per_step_by_span"]["gen.step"] == \
        pytest.approx(25e-6 / 2)


def test_analyze_trace_rolls_up_by_program_span(tmp_path, capsys):
    from flipped_tpu_torch.scripts import analyze_trace as at

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
                "ts": ts, "dur": dur, "args": args}

    ev = [x("user_annotation", "train step 1", 0, 100, span="train.step",
            index=0, parent=-1),
          x("user_annotation", "train.forward", 5, 40, span="train.forward",
            index=1, parent=0),
          x("user_annotation", "train.backward", 50, 40,
            span="train.backward", index=2, parent=0),
          x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=7),
          x("cuda_driver", "cuLaunchKernelEx", 60, 2, correlation=8),
          x("cuda_runtime", "cudaLaunchKernel", 150, 2, correlation=9),
          x("kernel", "nvjet_tst_fwd", 20, 30, device=0, correlation=7),
          x("kernel", "flash_text_bwd_dq_kernel", 70, 50, device=0,
            correlation=8),
          x("kernel", "vectorized_elementwise_kernel", 160, 20, device=0,
            correlation=9),
          x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 200, 5,
            device=0, correlation=10)]       # its launch is not in the trace
    assert at.device_ops(ev) == [
        DeviceOp("nvjet_tst_fwd", 20_000, 50_000, 10_000),
        DeviceOp("flash_text_bwd_dq_kernel", 70_000, 120_000, 60_000),
        DeviceOp("vectorized_elementwise_kernel", 160_000, 180_000, 150_000),
        DeviceOp("Memcpy DtoH (Device -> Pinned)", 200_000, 205_000, None)]
    rolled = at.span_rollup(ev)
    by = rolled["by_span"]
    assert by["train.step"]["device_s"] == pytest.approx(80e-6)
    assert by["train.forward"]["launches"] == 1
    assert by["train.backward"]["device_s"] == pytest.approx(50e-6)
    # the step's device interval [20, 120] µs: idle 50-70
    assert by["train.step"]["idle_s"] == pytest.approx(20e-6)
    assert by["train.forward"]["idle_s"] == 0.0
    assert by[spans.NONE]["launches"] == 2
    assert rolled["share"] == pytest.approx(80 / 105)
    path = tmp_path / "train_epoch0.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert at.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "== by program span (76.2% of device time" in out
    assert "idle ms" in out
    assert "train.backward" in out
    # a trace without program spans prints no such table
    assert at.span_rollup([e for e in ev if "span" not in e["args"]]) is None


def test_chip_smoke_trace_check_counts_kernels_by_launch(tmp_path, capsys):
    """chip_smoke's check of a `--trace_dir` trace reads the analyzer's
    ops: a K1/K2 kernel counts as in the traced steps where its launch
    began inside one, even if it ran after the step's host returned."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def x(cat, name, ts, dur, corr=None):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
                "ts": ts, "dur": dur,
                "args": {} if corr is None else {"correlation": corr}}

    names = [smoke.K1_KERNEL, smoke.K1_KERNEL, *smoke.K2_KERNELS]
    ev = [x("user_annotation", "train step 1", 0, 100)]
    for i, name in enumerate(names):
        ev.append(x("cuda_runtime", "cudaLaunchKernel", 10 + 20 * i, 2, i))
        ev.append(x("kernel", name, 50 + 30 * i, 25, i))  # the last, late
    path = tmp_path / "train_epoch0.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    smoke.check_trace(str(path), blocks=1, steps=1)
    assert "0 of them outside the traced steps" in capsys.readouterr().out
    ev[-2]["ts"] = 101                     # a K2 launch after the step
    path.write_text(json.dumps({"traceEvents": ev}))
    with pytest.raises(AssertionError, match="K1's and K2's"):
        smoke.check_trace(str(path), blocks=1, steps=1)


class _Event:
    def __init__(self, name, device, corr, start, dur, kind=None):
        self._v = (name, device, corr, start, dur)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


@pytest.mark.parametrize("kinds", [True, False])
def test_device_ops_link_kernels_to_their_launch(kinds):
    """A kernel's launch is the CUDA call with its correlation id, named
    by the event's activity type where torch gives one, else by name."""
    from types import SimpleNamespace

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kind = (lambda k: k) if kinds else (lambda k: None)
    events = [_Event("cudaLaunchKernel", cpu, 7, 100, 5,
                     kind("cuda_runtime")),
              _Event("cuLaunchKernelEx", cpu, 8, 120, 5, kind("cuda_driver")),
              _Event("cudaStreamSynchronize", cpu, 9, 130, 50,
                     kind("cuda_runtime")),
              _Event("nvjet_tst", cuda, 7, 300, 40, kind("kernel")),
              _Event("flash_text_fwd_kernel", cuda, 8, 340, 10,
                     kind("kernel")),
              _Event("Memcpy DtoH", cuda, 11, 400, 3, kind("gpu_memcpy"))]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert spans.device_ops(prof) == [
        DeviceOp("nvjet_tst", 300, 340, 100),
        DeviceOp("flash_text_fwd_kernel", 340, 350, 120),
        DeviceOp("Memcpy DtoH", 400, 403, None)]
