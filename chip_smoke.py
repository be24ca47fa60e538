#!/usr/bin/env python3
"""Drive flipped_tpu_torch on one CUDA card, end to end.

    python3 chip_smoke.py

Phases; any failure prints its traceback and exits 1 without a result line:
  1. device   torch and CUDA versions, the card's name and power limit;
              exits 1 when torch sees no CUDA device (there is no CPU path)
  2. build    compile flipped_tpu_torch/csrc/ with nvcc for sm_90a
  3. K1       flash_text_fwd against its plain PyTorch version in bf16 at the
              unit shape and the three main-path shapes, and lse against a
              float64 log-sum-exp
  4. timing   kernel and plain version at the two main-path shapes (cached
              prefill, dense encode): device time by CUDA-graph replay
              between CUDA events, and host time per eager call
  5. slice    the classification eval at LLaMA-7B width (dim 4096, 32
              layers, random bf16 frozen weights from a seed) over synthetic
              NExT-QA fixtures through `flipped_tpu_torch.cli.evaluate.main`;
              K1's launch count must be 32 per scored batch and every score
              finite; then one batch through the cached and the dense eval
              steps, which must agree
The last two lines of stdout are a JSON line of the kernels and the
contract line {"ok": true, "device": {...}}, with the nvidia-smi line before
them.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

K1_SOURCE = "flipped_tpu_torch/csrc/flash_text_fwd.cu"
K1_REPLACES = "flipped_tpu/model/pallas/flash_attention.py:59"
# (B, S, H, Dh, video_start per example): the unit shape (two batches, so
# -1, 0 and 5 all occur next to another value), the cached prefill of the
# eval (batch 8), the dense encode (8 examples x 5 options), the TVQA length
K1_CASES = [
    (2, 37, 4, 128, (-1, 5)),
    (2, 37, 4, 128, (0, 5)),
    (8, 128, 32, 128, (5, 1, -1, 0, 5, 3, 2, 5)),
    (40, 128, 32, 128, (5,) * 40),
    (1, 650, 32, 128, (4,)),
]
MAIN_SHAPES = {"prefill": (8, 128, 32, 128), "dense": (40, 128, 32, 128)}
MAX_FEATS = 10
# Tolerance of K1 against its plain version. The kernel rounds the
# unnormalised P to bf16 and divides by the row sum at the end; the plain
# version, like the TPU kernel, rounds the normalised P. Each rounding moves
# a term by at most 2^-9 relative, so the two outputs differ by at most
# 2^-8 * (P @ |V|) before the final rounding to bf16, which adds at most one
# bf16 ulp (<= 2^-7 |out|). The bound allows twice the first term:
#   |kernel - plain| <= 2^-7 * ((P @ |V|) + |plain|) + 2^-14
K1_REL = 2.0 ** -7
K1_ABS_FLOOR = 2.0 ** -14     # for outputs within rounding of zero
LSE_ATOL = 1e-4               # f32 row sums of up to 650 terms vs float64
SCORE_RTOL = 2e-2             # cached vs dense eval, both bf16


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def k1_inputs(torch, b, s, h, dh, vs, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, dh, device="cuda", generator=g)
               .to(torch.bfloat16) for _ in range(3))
    gate2 = torch.randn(h, device="cuda", generator=g)
    video_start = torch.tensor(vs, dtype=torch.int32, device="cuda")
    return q, k, v, gate2, video_start


def check_k1(torch, fa):
    from flipped_tpu_torch.model.attention import video_block_bias

    worst = 0.0
    for i, (b, s, h, dh, vs) in enumerate(K1_CASES):
        q, k, v, gate2, video_start = k1_inputs(torch, b, s, h, dh, vs, i)
        out, lse = fa.flash_text_attention(q, k, v, gate2, video_start,
                                           MAX_FEATS)
        torch.cuda.synchronize()
        ref, _ = fa.flash_text_attention_ref(q, k, v, gate2, video_start,
                                             MAX_FEATS)
        torch.cuda.synchronize()
        ref32 = ref.float()
        err = (out.float() - ref32).abs()
        scale, _ = fa.flash_text_attention_ref(q, k, v.abs(), gate2,
                                               video_start, MAX_FEATS)
        bound = K1_REL * (scale.float() + ref32.abs()) + K1_ABS_FLOOR
        ratio = float((err / bound).max())
        sc = torch.einsum("bshd,bthd->bhst", q.double(), k.double()) \
            / math.sqrt(dh)
        sc = sc + video_block_bias(video_start, s, MAX_FEATS, gate2.double())
        causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
        lse64 = torch.logsumexp(sc.masked_fill(~causal, -math.inf), dim=-1)
        lse_err = float((lse.double() - lse64).abs().max())
        torch.cuda.synchronize()
        max_err = float(err.max())
        worst = max(worst, max_err)
        print(f"K1 {(b, s, h, dh)} vs={vs[:4]}: max|out-plain|={max_err:.6g} "
              f"(worst {ratio:.3f} of the bound), "
              f"max|lse-f64|={lse_err:.3g}", flush=True)
        if not torch.isfinite(out).all():
            raise AssertionError("K1 produced non-finite values")
        if ratio > 1.0:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{(b, s, h, dh)}")
        if lse_err > LSE_ATOL:
            raise AssertionError(f"K1 lse off by {lse_err} at {(b, s, h, dh)}")
    return worst


def device_ms(torch, fn, n=20, reps=5):
    """Device time of one call: `n` calls captured in a CUDA graph, replayed
    `reps` times between CUDA events. Replay has no host work between the
    launches, so this is the kernels' time, not the Python wrapper's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def host_us(torch, fn, n=100):
    """Host time of one eager call (enqueue only)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def time_k1(torch, fa):
    times = {}
    for name, (b, s, h, dh) in MAIN_SHAPES.items():
        args = k1_inputs(torch, b, s, h, dh, (5,) * b, 100)
        kern = lambda: fa.flash_text_attention(*args, MAX_FEATS)
        plain = lambda: fa.flash_text_attention_ref(*args, MAX_FEATS)
        # in turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (device_ms(torch, f) for f in (plain, kern, kern,
                                                         plain))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"K1 timing {name} {(b, s, h, dh)}: device time kernel "
              f"{times[name][0]:.5f} ms, plain {times[name][1]:.5f} ms (runs "
              f"{k1:.5f}/{k2:.5f} and {p1:.5f}/{p2:.5f}); host per eager "
              f"call: kernel wrapper {host_us(torch, kern):.1f} us, plain "
              f"{host_us(torch, plain):.1f} us", flush=True)
    return times


def write_fixtures(root):
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_data", os.path.join(ROOT, "scripts",
                                            "make_synthetic_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import numpy as np
    mod.make_nextqa(root, 64, np.random.RandomState(0))  # 16 val examples


def run_slice(torch, fa):
    from flipped_tpu_torch.cli import evaluate
    from flipped_tpu_torch.core.config import get_args_parser

    data_root = os.path.join(WORK, "data")
    write_fixtures(data_root)
    argv = ["--model", "llama7B", "--dataset", "nextqa", "--data_root",
            data_root, "--max_seq_len", "128", "--batch_size", "8",
            "--device", "cuda", "--llama_model_path",
            os.path.join(WORK, "no_checkpoint")]
    args = get_args_parser().parse_args(argv)

    torch.cuda.reset_peak_memory_stats()
    fa.flash_text_attention.launches = 0
    t0 = time.perf_counter()
    stats = evaluate.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.flash_text_attention.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"slice: evaluate.main took {seconds:.3f} s (7B init included), "
          f"{stats['batches']} batches, K1 launches {launches}, peak "
          f"allocated {peak / 2**30:.3f} GiB", flush=True)
    if stats["batches"] != 2:
        raise AssertionError(f"expected 2 val batches, got {stats['batches']}")
    if launches != 32 * stats["batches"]:
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{stats['batches']} batches (want 32 each)")
    return args, launches, peak


def compare_cached_dense(torch, args):
    from flipped_tpu.data.datasets import build_dataset
    from flipped_tpu.data.pipeline import Loader
    from flipped_tpu_torch.cli.evaluate import batch_to_device
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.train.builder import build_eval_state
    from flipped_tpu_torch.train.step import make_eval_step

    run_cfg = run_config_from_args(args)
    model, _, tokenizer = build_eval_state(run_cfg, torch.device("cuda"))
    loader = Loader(build_dataset(run_cfg.data, tokenizer, "val"), 8,
                    shuffle=False, split="val", prefetch=0)
    it = iter(loader)
    batch = next(it)
    it.close()
    tb = batch_to_device(batch, "cuda")
    span = (int(batch["span_need"]), bool(batch["span_exact"]))
    steps = {"cached": make_eval_step(model, cached=True),
             "dense": make_eval_step(model, cached=False)}
    outs, secs = {}, {}
    for name, step in steps.items():
        outs[name] = step(tb, span_info=span)          # warm-up
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            outs[name] = step(tb, span_info=span)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        secs[name] = sorted(runs)[1]
    c, d = outs["cached"]["scores"].float(), outs["dense"]["scores"].float()
    if not (torch.isfinite(c).all() and torch.isfinite(d).all()):
        raise AssertionError("non-finite eval scores")
    delta = (c - d).abs()
    agree = float((outs["cached"]["prediction"]
                   == outs["dense"]["prediction"]).float().mean())
    n = tb["vqa_tokens"].shape[0]
    print(f"cached vs dense on one batch: max|dscore|={float(delta.max()):.5g} "
          f"(|score| up to {float(d.abs().max()):.4g}), argmin agreement "
          f"{agree:.3f}", flush=True)
    for name in steps:
        print(f"eval {name}: {secs[name]:.5f} s/batch (median of 3), "
              f"{n / secs[name]:.2f} ex/s at batch {n}", flush=True)
    if bool((delta > SCORE_RTOL * d.abs()).any()):
        raise AssertionError("cached and dense scores disagree beyond "
                             f"{SCORE_RTOL} relative")


def main() -> int:
    import torch

    phase("device")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("torch sees no CUDA device: chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from flipped_tpu_torch.model.kernels import build as kbuild
    from flipped_tpu_torch.model.kernels import flash_attention as fa

    phase("build")
    t0 = time.perf_counter()
    lib = kbuild.build(force=True)
    print(f"built {lib.path} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    phase("K1 vs plain")
    max_err = check_k1(torch, fa)

    phase("K1 timing")
    times = time_k1(torch, fa)

    phase("slice")
    args, launches, _ = run_slice(torch, fa)
    compare_cached_dense(torch, args)

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("the port pulled in jax")
    kernel_ms, plain_ms = times["prefill"]
    print(json.dumps({"kernels": [{
        "name": "flash_text_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
