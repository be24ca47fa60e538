"""A tiny copy of a cell, written under a temporary directory in the
benchmark's own layout, for CPU rehearsals: the configuration cut to
width 128 (two heads, two layers, a vocabulary of 512), the traffic to a
few short rows; the modes, metrics and kernel classes stay the real
ones."""
from __future__ import annotations

import json
from pathlib import Path

from pbcore import registry

TINY_MODEL = {"dim": 128, "n_layers": 2, "n_heads": 2, "vocab_size": 512,
              "multiple_of": 128, "norm_eps": 1e-6, "rope_theta": 10000.0}
TINY_PARTS = {"instruction": [3, 5], "question": [3, 5], "option": [1, 2],
              "answer": [1, 2]}
TRAFFIC = {"nextqa.train": {"batch_size": 4, "accum_iter": 2,
                            "max_seq_len": 48, "pool": 3, "check_steps": 2,
                            "reference_rows": 2, "steps_per_epoch": 8},
           "nextqa.eval": {"batch_size": 4, "max_seq_len": 48, "pool": 2,
                           "check_rows": 6},
           "musicavqa.generate": {"batch_size": 4, "max_seq_len": 40,
                                  "pool": 2, "check_rows": 6,
                                  "max_new_tokens": 5}}


def tiny_cell(tmp: Path, cell: str, limits=None) -> registry.Cell:
    bench = registry.load_benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    base = tmp / "portbench"
    for d in ("configs", "traffic", "workloads"):
        (base / d).mkdir(parents=True, exist_ok=True)
    config = registry.load_config(conf)
    config.update(model=dict(TINY_MODEL), intermediate_size=384,
                  vocab_size=512, bos_token_id=510, eos_token_id=511)
    config.pop("name")
    (base / "configs" / f"{entry['config']}.json").write_text(
        json.dumps(config))
    t = json.loads((registry.HERE / "traffic" /
                    f"{entry['traffic']}.json").read_text())
    t.update(TRAFFIC[entry["traffic"]], parts=TINY_PARTS)
    (base / "traffic" / f"{entry['traffic']}.json").write_text(json.dumps(t))
    spec = json.loads((registry.HERE / "workloads" /
                       f"{cell}.json").read_text())
    if limits is not None:
        spec["limits"] = limits
    (base / "workloads" / f"{cell}.json").write_text(json.dumps(spec))
    bench = json.loads(json.dumps(bench))
    for c in bench["configs"]:
        c["file"] = str(base / "configs" / f"{c['name']}.json")
    return registry.Cell(bench, cell, base=base)
