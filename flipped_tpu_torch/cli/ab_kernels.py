"""Time K1, K2, K3, K7 and K4 of this checkout and another on one card, in
turns.

    python -m flipped_tpu_torch.cli.ab_kernels <other checkout>

The turns are other, this, this, other, each in its own process (both
checkouts' packages have one name): a turn builds its checkout's kernels and
times, by CUDA-graph replay, K1 at the shapes of `chip_smoke.K1_SHAPES` and
K2 at the training shape (B 24, S 128), then K3, K7 and K4 at the three
3072-row 7B shapes, with that checkout's `chip_smoke.py` (`k1_inputs`,
`k2_inputs`, `quant_inputs`, `device_ms`). Prints the card's name and power
limit, then one JSON line per turn: device ms by shape and kernel. Unpack
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
    out = {"root": root}
    vs = cs.TRAIN_VS * 2
    for name, (b, s, h, dh) in cs.K1_SHAPES.items():
        q, k, v, g2, video_start = cs.k1_inputs(torch, b, s, h, dh, vs[:b],
                                                100)
        out[f"k1 {name}"] = cs.device_ms(
            torch, lambda: fa.flash_text_attention(q, k, v, g2, video_start,
                                                   cs.MAX_FEATS))
    q, k, v, g2, video_start, do = cs.k2_inputs(torch, *cs.TRAIN_SHAPE,
                                                cs.TRAIN_VS, 200)
    o, lse = fa.flash_text_attention(q, k, v, g2, video_start, cs.MAX_FEATS)
    out["k2 train"] = cs.device_ms(
        torch, lambda: fa.flash_text_attention_bwd(
            q, k, v, g2, video_start, cs.MAX_FEATS, do, o, lse))
    for name in SHAPES:
        m, k, n = cs.QUANT_MAIN[name]
        x, kq, scale, sg, g = cs.quant_inputs(torch, m, k, n, 400)
        out[name] = {
            "k3": cs.device_ms(torch, lambda: qm.int8_fwd(x, kq, scale)),
            "k7": cs.device_ms(torch, lambda: qm.grouped_matmul(x, kq, sg)),
            "k4": cs.device_ms(torch, lambda: qm.quant_dx(g, kq, sg))}
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
