"""Time K1, K2, K3 and K7 (both routes), K5, K6a, K6b, K4, K8 (both
branches, both routes), K9 and K10 of this checkout and another on one
card, in turns.

    python -m flipped_tpu_torch.cli.ab_kernels <other checkout>

The turns are other, this, this, other, each in its own process (both
checkouts' packages have one name): a turn builds its checkout's kernels and
times, by CUDA-graph replay, K1 at the shapes of `chip_smoke.K1_SHAPES`, K2
at the training shape (B 24, S 128), K5 at the long training shape
(`LONG_SHAPE`, B 3, S 4096) and K6a, K6b there on K5's lse and D, then
K3, K7, K4, K8 (w4a8 "k8a", weight-only "k8w"), K9 and K10 at the three
3072-row 7B shapes, K3 and K8 w4a8 at the eval's w1/w3 shapes
(`K3_EVAL`), and K3, K7 and K8 (both branches) at generation's decode
shapes (`DECODE`: 32 rows through the three block shapes, 10 adapter rows;
and 1, 64, 65 and 128 rows at 4096 -> 4096, around the decode routes'
limit),
with that checkout's `chip_smoke.py` (`k1_inputs`, `k2_inputs`,
`stream_inputs`, `quant_inputs`, `int4_inputs`, `device_ms`); the two launches of K3, K7, K8 w4a8 and K10 are also timed
apart ("k3 quantize", "k3 gemm", and so on for "k7", "k8a" and "k10":
device time by kernel name under torch.profiler, the names with
"quantize" the first: K3's int8_fwd_quantize_kernel, K7's and K8's
quantize_rows_kernel, K10's int8_dgrad_quantize_kernel; at the decode
shapes K3's, K7's and K8 w4a8's too: K3's decode route's is
int8_decode_quantize_kernel). Prints
the card's name and power limit, then one JSON line per turn: device ms
by shape and kernel, and under "clocks" the SM clock and power draw that
nvidia-smi reads right before and right after each kernel's timing, so
that a clock drop shows in the record instead of reading as a kernel
change. Unpack
the other commit with `git archive` into a directory `.gitignore` lists;
comparing two commits inside one call keeps the card, its power limit and
the toolchain the same.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = ("wq/wk/wv/wo", "w1/w3", "w2")
# generation's K3, K7 and K8 calls, and the wq shape on both sides of the
# decode routes' limit (quant_matmul.DECODE_MAX_M, 64 rows): (M, K, N)
DECODE = {"decode wq/wk/wv/wo": (32, 4096, 4096),
          "decode w1/w3": (32, 4096, 11008),
          "decode w2": (32, 11008, 4096),
          "decode adapter wk/wv": (10, 4096, 4096),
          "wq M 1": (1, 4096, 4096), "wq M 64": (64, 4096, 4096),
          "wq M 65": (65, 4096, 4096), "wq M 128": (128, 4096, 4096)}


def launch_split(torch, kern, fn, n=20) -> dict:
    """Device ms per call of the quantize kernel and of the GEMM kernel that
    one call of `fn` (K3's, K7's, K8 w4a8's or K10's wrapper) launches, from
    a torch.profiler trace of `n` calls after 3 warm ones."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = {f"{kern} quantize": 0.0, f"{kern} gemm": 0.0}
    for e in prof.profiler.function_events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            part = "quantize" if "quantize" in e.name else "gemm"
            parts[f"{kern} {part}"] += e.time_range.elapsed_us()
    if not all(parts.values()):
        raise RuntimeError(f"{kern}'s launches were not both traced: "
                           f"{parts}")
    return {k: v * 1e-3 / n for k, v in parts.items()}


def smi_clocks() -> str:
    """The card's SM clock and power draw now, as nvidia-smi reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def time_checkout(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from flipped_tpu_torch.model.kernels import build
    from flipped_tpu_torch.model.kernels import flash_attention as fa
    from flipped_tpu_torch.model.kernels import quant_matmul as qm

    if not torch.cuda.is_available():
        raise RuntimeError("ab_kernels times the card: no CUDA device")
    build.build()
    clocks = {}

    def timed(key, fn):
        before = smi_clocks()
        ms = cs.device_ms(torch, fn)
        clocks[key] = [before, smi_clocks()]
        return ms

    out = {"root": root}
    vs = cs.TRAIN_VS * 2
    for name, (b, s, h, dh) in cs.K1_SHAPES.items():
        q, k, v, g2, video_start = cs.k1_inputs(torch, b, s, h, dh, vs[:b],
                                                100)
        out[f"k1 {name}"] = timed(
            f"k1 {name}", lambda: fa.flash_text_attention(
                q, k, v, g2, video_start, cs.MAX_FEATS))
    q, k, v, g2, video_start, do = cs.k2_inputs(torch, *cs.TRAIN_SHAPE,
                                                cs.TRAIN_VS, 200)
    o, lse = fa.flash_text_attention(q, k, v, g2, video_start, cs.MAX_FEATS)
    out["k2 train"] = timed("k2 train", lambda: fa.flash_text_attention_bwd(
        q, k, v, g2, video_start, cs.MAX_FEATS, do, o, lse))
    b, s, h, _ = cs.LONG_SHAPE
    q, k, v, do, g2, video_start = cs.stream_inputs(torch, b, s, s, h,
                                                    cs.LONG_VS, 600)
    out["k5 long train"] = timed(
        "k5 long train", lambda: fa.flash_streaming_fwd(
            q, k, v, g2, video_start, cs.MAX_FEATS))
    # K6a and K6b on K5's lse and D of the same inputs, as the path runs them
    o, lse = fa.flash_streaming_fwd(q, k, v, g2, video_start, cs.MAX_FEATS)
    args = (q, k, v, g2, video_start, cs.MAX_FEATS, do, lse,
            fa.stream_delta(do, o))
    out["k6a long train"] = timed(
        "k6a long train", lambda: fa.flash_streaming_dq(*args))
    out["k6b long train"] = timed(
        "k6b long train", lambda: fa.flash_streaming_dkv(*args))
    del q, k, v, do, o, lse, args
    for name in SHAPES:
        m, k, n = cs.QUANT_MAIN[name]
        x, kq, scale, sg, g = cs.quant_inputs(torch, m, k, n, 400)
        x4, kq4, sg4, g4 = cs.int4_inputs(torch, m, k, n, 410)
        calls = {
            "k3": lambda: qm.int8_fwd(x, kq, scale),
            "k7": lambda: qm.grouped_matmul(x, kq, sg),
            "k4": lambda: qm.quant_dx(g, kq, sg),
            "k8a": lambda: qm.int4_matmul(x4, kq4, sg4, True),
            "k8w": lambda: qm.int4_matmul(x4, kq4, sg4, False),
            "k9": lambda: qm.int4_dx(g4, kq4, sg4),
            "k10": lambda: qm.int8_dgrad(g, kq, scale, cs.TRAIN_S)}
        out[name] = {kern: timed(f"{name} {kern}", fn)
                     for kern, fn in calls.items()}
        for kern in ("k3", "k7", "k8a", "k10"):
            out[name].update(launch_split(torch, kern, calls[kern]))
    for name, (m, k, n) in cs.K3_EVAL.items():
        x, kq, scale, _, _ = cs.quant_inputs(torch, m, k, n, 400)
        x4, kq4, sg4, _ = cs.int4_inputs(torch, m, k, n, 410)
        calls = {"k3": lambda: qm.int8_fwd(x, kq, scale),
                 "k8a": lambda: qm.int4_matmul(x4, kq4, sg4, True)}
        out[name] = {}
        for kern, call in calls.items():
            out[name][kern] = timed(f"{name} {kern}", call)
            out[name].update(launch_split(torch, kern, call))
    for name, (m, k, n) in DECODE.items():
        x, kq, scale, sg, _ = cs.quant_inputs(torch, m, k, n, 400)
        x4, kq4, sg4, _ = cs.int4_inputs(torch, m, k, n, 410)
        calls = {"k3": lambda: qm.int8_fwd(x, kq, scale),
                 "k7": lambda: qm.grouped_matmul(x, kq, sg),
                 "k8a": lambda: qm.int4_matmul(x4, kq4, sg4, True),
                 "k8w": lambda: qm.int4_matmul(x4, kq4, sg4, False)}
        out[name] = {kern: timed(f"{name} {kern}", call)
                     for kern, call in calls.items()}
        for kern in ("k3", "k7", "k8a"):
            out[name].update(launch_split(torch, kern, calls[kern]))
    out["clocks"] = clocks
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--time"]:
        print(json.dumps(time_checkout(os.path.abspath(argv[1]))))
        return 0
    other = os.path.abspath(argv[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in (other, HERE, HERE, other):
        # -P: the script's own directory (cli/, with a profile.py) stays
        # off sys.path, so each turn imports only its checkout's package
        proc = subprocess.run([sys.executable, "-P",
                               os.path.abspath(__file__), "--time", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"timing {root} failed:\n{proc.stderr}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
