"""Hyperparameter sweep runner (JAX: scripts/sweep.py).

The reference's SLURM array sweep (reference: submit_job.sh:13-24,
train_script.sh:14-29, params.txt) as a plain runner of the port's train
CLI: each row of a params file is one configuration; --row picks one (the
SLURM_ARRAY_TASK_ID), else every row runs in turn. The default params file
is the repo's `scripts/params.txt`, read in place.

Row format (whitespace-separated, as the reference's params.txt):
    <audio:0|1> <audio_only:0|1> <audio_merge:none|sum|concat|attention> \\
    <model> <dataset> <blr> [extra CLI flags...]

    python -m flipped_tpu_torch.scripts.sweep --row 4 --dry_run
"""
from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys

PARAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scripts", "params.txt")


def row_to_args(row: str):
    parts = row.split()
    audio, audio_only, merge, model, dataset, blr = parts[:6]
    args = ["--model", model, "--dataset", dataset, "--blr", blr]
    if audio == "1":
        args.append("--audio")
    if audio_only == "1":
        args.append("--audio_only")
    if merge != "none":
        args += ["--audio_merge", merge]
    args += parts[6:]
    return args


def commands(params: str, row=None, extra=()):
    """[(row index, argv of one cli.train run)] for the rows of `params`
    (one, with `row`)."""
    with open(params) as f:
        rows = [r.strip() for r in f
                if r.strip() and not r.lstrip().startswith("#")]
    selected = rows if row is None else [rows[row]]
    out = []
    for i, r in enumerate(selected):
        idx = row if row is not None else i
        out.append((idx, [sys.executable, "-m", "flipped_tpu_torch.cli.train"]
                    + row_to_args(r) + list(extra)
                    + ["--output_dir", f"./output_dir/sweep_{idx:03d}"]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("sweep over a params file")
    ap.add_argument("--params", default=PARAMS)
    ap.add_argument("--row", type=int, default=None,
                    help="0-based row index (like SLURM_ARRAY_TASK_ID)")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("extra", nargs="*", help="flags appended to every run")
    args = ap.parse_args(argv)
    for _, cli in commands(args.params, args.row, args.extra):
        print("run:", " ".join(shlex.quote(c) for c in cli), flush=True)
        if not args.dry_run:
            subprocess.run(cli, check=True)


if __name__ == "__main__":
    main()
