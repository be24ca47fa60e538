"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload ds7b.train.nextqa --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout that holds `flipped_tpu_torch/` (the system
under test) and `BENCHMARK.json`. Builds the cell's model from its
configuration with weights drawn from the seed on the card, warms up on
the cell's own shapes, measures for --seconds (--trace 1: a traced window
of the traffic's `trace_units` at most, read for the per-layer metrics),
reads the peak memory, frees the program, compares what the timed path
produced with the float32 reference, and prints one JSON line last on
standard output; the numbers compared, each with its limit, are the last
lines of standard error. Exits non-zero, printing no result, without
enough CUDA cards or if the run loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache the program may keep lives at a fixed path in the checkout
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(HERE), str(ROOT)]

    from pbcore import registry, runner
    import torch
    import flipped_tpu_torch  # noqa: F401  the system under test

    cell = registry.Cell(registry.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    peaks = registry.peaks(kind)
    if peaks is None:
        print(f"peaks.json has no entry for {kind!r}", file=sys.stderr)
        return 2
    ctx = runner.Context(cell, args.seed, "cuda", peaks)
    out = runner.run(cell, ctx, args.seconds, bool(args.trace), T_START)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
