"""Read a cell's compared numbers over many seeds in one process: the
program's sound runs, its control, and its planted faults, each against
the one reference of that seed. Their readings are what the cell's
limits (`workloads/<cell>.json`) are set from.

    python3 portbench/calibrate.py --workload ds7b.train.nextqa \
        --seeds 101,102,103 --control 3 --units 1 --out build/calib.jsonl

The control and the faults are the cell file's `control` and `faults`:
a control {"quantize": mode} runs the program at that --quantize mode
(the generation cell reads it teacher-forced: at each served position,
the token the lower precision puts first), {"ref_act_levels": n} puts
the reference in the program's place with its activations at ±n levels.
The first `--control` seeds also run the control and every fault. The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def session(cell, seed, device, peaks, units, **kw):
    """A run's set-up and `units` units of work, the program freed → the
    session (its answers kept) and its context."""
    from pbcore import registry, runner
    ctx = runner.Context(cell, seed, device, peaks, **kw)
    sess = registry.load_mode(cell.mode).Session(ctx)
    sess.setup()
    runner.measure(sess, float("inf"), units)
    sess.release()
    return sess, ctx


def control_answers(cell, mode, sess, ctx, spec, device, peaks, units):
    if "ref_act_levels" in spec:
        from pbcore import runner
        c = runner.Context(cell, ctx.seed, device, peaks,
                           ref_act_levels=spec["ref_act_levels"])
        return mode.reference(c, sess)
    if hasattr(mode, "control_answers"):
        return mode.control_answers(ctx, sess, spec["quantize"])
    got, _ = session(cell, ctx.seed, device, peaks, units,
                     quantize=spec["quantize"])
    return got.answers()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("portbench calibration")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    from pbcore import registry
    import torch

    cell = registry.Cell(registry.load_benchmark(ROOT), args.workload)
    spec = json.loads((HERE / "workloads" / f"{cell.name}.json").read_text())
    mode = registry.load_mode(cell.mode)
    peaks = (registry.peaks(torch.cuda.get_device_name(0))
             if args.device == "cuda" else None)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        sess, ctx = session(cell, seed, args.device, peaks, args.units)
        answers = {"sound": sess.answers()}
        if n < args.control:
            answers["control"] = control_answers(
                cell, mode, sess, ctx, spec["control"], args.device, peaks,
                args.units)
            for fault in spec.get("faults", []):
                got, _ = session(cell, seed, args.device, peaks, args.units,
                                 fault=fault)
                answers[fault] = got.answers()
        t1 = time.perf_counter()
        ref = mode.reference(ctx, sess)
        t2 = time.perf_counter()
        line = {"cell": cell.name, "seed": seed,
                "program_s": t1 - t0, "reference_s": t2 - t1,
                **{k: mode.compare(a, ref) for k, a in answers.items()}}
        if hasattr(mode, "gaps"):           # each answer's gap, for the record
            line["gaps"] = {k: mode.gaps(a, ref).flatten().tolist()
                            for k, a in answers.items()}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del ref
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
