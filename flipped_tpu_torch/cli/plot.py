"""Plot learning curves from log.txt JSON lines (JAX: flipped_tpu/cli/
plot.py).

Replacement for the reference's plot_learning_curves.py (reference:
plot_learning_curves.py:24-157): parses the per-epoch JSON lines that the
port's train CLI writes (`utils.logging.write_log_line`: train_*, val_*
and epoch keys) and writes loss/accuracy/lr curves per experiment
directory. matplotlib is imported when a plot is drawn.

    python -m flipped_tpu_torch.cli.plot --log_dirs out1 out2 --out plots/
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path


def read_log(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def create_plots_for_experiment(log_dir: str, out_dir: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = read_log(os.path.join(log_dir, "log.txt"))
    if not rows:
        print(f"no log lines in {log_dir}")
        return []
    name = Path(log_dir).name
    os.makedirs(out_dir, exist_ok=True)
    epochs = [r.get("epoch", i) for i, r in enumerate(rows)]
    written = []

    groups = {
        "loss": [k for k in rows[0] if k.startswith("train_")
                 and "loss" in k],
        "accuracy": [k for k in rows[0] if k.startswith("val_")
                     and ("acc" in k or k in ("val_C", "val_T", "val_D",
                                              "val_Total"))],
        "lr": [k for k in rows[0] if k.endswith("_lr")],
    }
    for title, keys in groups.items():
        if not keys:
            continue
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for k in keys:
            ax.plot(epochs, [r.get(k) for r in rows], marker="o", label=k)
        ax.set_xlabel("epoch")
        ax.set_title(f"{name} — {title}")
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
        out = os.path.join(out_dir, f"{name}_{title}.png")
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(out)
        print("wrote", out)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log_dirs", nargs="+", required=True)
    ap.add_argument("--out", default="./plots")
    args = ap.parse_args(argv)
    for d in args.log_dirs:
        create_plots_for_experiment(d, args.out)


if __name__ == "__main__":
    main()
