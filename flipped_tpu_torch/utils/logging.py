"""The JSON-lines training log (JAX: flipped_tpu/utils/logging.py:42-49).

One process writes it: the port runs on one card. `save_result`, the
extracted answers of generation eval, comes with generation (ROADMAP [7]).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict


def write_log_line(output_dir: str, stats: Dict[str, Any]) -> None:
    """Append one JSON line to {output_dir}/log.txt (reference:
    train.py:144-148); nothing without an output_dir."""
    if not output_dir:
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a",
              encoding="utf-8") as f:
        f.write(json.dumps(stats) + "\n")
