"""Tiny-size rehearsals on the CPU of each mode's whole run (set-up,
window, the reference's comparison, the result line), the same runs
with the timed path broken underneath (each must come out not correct),
and the imports a run makes."""
import json
import math
import subprocess
import sys
import time

import pytest

from pbcore import checks, registry, runner
from tiny import tiny_cell

BENCH = registry.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
MODE_FAULTS = {"train": ["unchanged", "half_batch"],
               "eval": ["answer", "half_batch"],
               "generate": ["token", "half_batch"]}
FAULTS = [(c, f) for c in CELLS
          for f in MODE_FAULTS[registry.Cell(BENCH, c).mode]]


def run_tiny(tmp_path, cell, **kw):
    c = tiny_cell(tmp_path, cell)
    ctx = runner.Context(c, 2 ** 31 + 12345, "cpu", None, **kw)
    return c, runner.run(c, ctx, 0.2, False, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_cpu(tmp_path, cell):
    c, out = run_tiny(tmp_path, cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    assert out["attempted"] > 0 and out["failed"] == 0
    readings = {k: v["value"] for k, v in out["checks"].items()}
    assert set(readings) == set(c.limits)
    # bf16 (or the stated quantization) against float32 at tiny width
    assert all(math.isfinite(v) and v < 0.05 for v in readings.values())
    assert out["correct"] == checks.judge(readings, c.limits)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_run_is_not_correct(tmp_path, cell, fault):
    c, out = run_tiny(tmp_path, cell, fault=fault)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


def test_no_jax_in_a_run(tmp_path):
    """A run loads neither JAX nor the JAX package (top-level names
    compared whole), and the reference loads nothing of the program."""
    code = f"""
import sys, time
from pathlib import Path
sys.path[:0] = {[str(registry.HERE / 'tests'), str(registry.HERE),
                 str(registry.ROOT)]!r}
import reference.model, reference.train, reference.serve
assert not any(m.split('.')[0] == 'flipped_tpu_torch' for m in sys.modules)
from tiny import tiny_cell
from pbcore import runner
c = tiny_cell(Path({str(tmp_path)!r}), 'ds7b.train.nextqa')
runner.run(c, runner.Context(c, 3, 'cpu', None), 0.1, False,
           time.perf_counter())
print(runner.forbidden_modules())
"""
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "flipped_tpu_torch_extra", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert runner.forbidden_modules() == ["jaxlib"]


def test_run_refuses_without_cards(tmp_path):
    """Without a CUDA card the command exits non-zero and prints no
    result."""
    got = subprocess.run([sys.executable, str(registry.HERE / "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert got.returncode != 0 and got.stdout.strip() == ""


def test_calibration_on_cpu(tmp_path):
    """The calibration's control and the training fault read above the
    sound program at tiny size."""
    import calibrate
    c = tiny_cell(tmp_path, "ds7b-w4a8.train.nextqa")
    mode = registry.load_mode(c.mode)
    sess, ctx = calibrate.session(c, 9, "cpu", None, 1)
    spec = json.loads((registry.HERE / "workloads" /
                       f"{c.name}.json").read_text())
    ctrl = calibrate.control_answers(c, mode, sess, ctx, spec["control"],
                                     "cpu", None, 1)
    ref = mode.reference(ctx, sess)
    sound, control = mode.compare(sess.answers(), ref), mode.compare(ctrl, ref)
    assert control["grad_rel"] > 3 * sound["grad_rel"]


@pytest.mark.gpu
def test_control_fails_on_the_card(tmp_path):
    """On the card at the cell's own size, one seed: the sound program
    within every limit, its control over one (the control is the cell
    file's `control`)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import calibrate
    out = tmp_path / "c.jsonl"
    calibrate.main(["--workload", "ds7b.eval.nextqa", "--seeds", "4242",
                    "--control", "1", "--units", "1", "--out", str(out)])
    line = json.loads(out.read_text().splitlines()[-1])
    limits = registry.Cell(BENCH, "ds7b.eval.nextqa").limits
    assert checks.judge(line["sound"], limits)
    assert not checks.judge(line["control"], limits)
