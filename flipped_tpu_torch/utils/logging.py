"""The JSON-lines training log and the result files of generation eval
(JAX: flipped_tpu/utils/logging.py:42-77).

One process writes them: the port runs on one card, so `save_result`
writes rank 0's shard and merges that one shard (the merge of many
processes' shards comes with the parallelism port, ROADMAP [9]).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List


def write_log_line(output_dir: str, stats: Dict[str, Any]) -> None:
    """Append one JSON line to {output_dir}/log.txt (reference:
    train.py:144-148); nothing without an output_dir."""
    if not output_dir:
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a",
              encoding="utf-8") as f:
        f.write(json.dumps(stats) + "\n")


def save_result(result: List[Any], result_dir: str, filename: str) -> str:
    """Write {result_dir}/{filename}_rank0.json, then the merged
    {filename}.json (one shard: the same list), with JAX's names and content (reference:
    util/misc.py:570-610). Returns the merged file's path."""
    os.makedirs(result_dir, exist_ok=True)
    final = os.path.join(result_dir, f"{filename}.json")
    for path in (os.path.join(result_dir, f"{filename}_rank0.json"), final):
        with open(path, "w") as f:
            json.dump(result, f)
    print(f"result file saved to {final}")
    return final
