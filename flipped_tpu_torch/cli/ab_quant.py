"""Time K3, K7 and K4 of this checkout and another on one card, in turns.

    python -m flipped_tpu_torch.cli.ab_quant <other checkout>

The turns are other, this, this, other, each in its own process (both
checkouts' packages have one name): a turn builds its checkout's kernels and
times K3, K7 and K4 at the three 3072-row 7B shapes by CUDA-graph replay,
with that checkout's `chip_smoke.py` (`quant_inputs`, `device_ms`). Prints
the card's name and power limit, then one JSON line per turn: device ms by
shape and kernel. Unpack the other commit with `git archive` into a
directory `.gitignore` lists; comparing two commits inside one call keeps
the card, its power limit and the toolchain the same.
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
    from flipped_tpu_torch.model.kernels import quant_matmul as qm

    if not torch.cuda.is_available():
        raise RuntimeError("ab_quant times the card: no CUDA device")
    build.build()
    out = {"root": root}
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
