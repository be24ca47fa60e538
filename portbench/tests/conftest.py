"""The benchmark's tests: CPU rehearsals at tiny sizes, and `gpu` tests
that skip without a card. Run from the checkout's root:

    python -m pytest portbench/tests -q
"""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (HERE, HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

torch.set_num_threads(2)      # the tests run in several workers at once
