"""Rank-0 printing, the JSON-lines training log and the result files of
generation eval (JAX: flipped_tpu/utils/logging.py; reference:
util/misc.py:174-188, 570-610).

Under torch.distributed `setup_for_distributed` silences every rank but
0, `write_log_line` writes from rank 0 only, and `save_result` writes one
shard a rank, then rank 0 merges the shards in rank order once every rank
has written its own.
"""
from __future__ import annotations

import builtins
import datetime
import json
import os
from typing import Any, Dict, List

from ..core.collectives import barrier
from ..core.distributed import get_rank, get_world_size


def is_main_process() -> bool:
    return get_rank() == 0


def setup_for_distributed(force: bool = False) -> None:
    """Silence print on every rank but 0 (unless `force`, or a call's
    force=True), with a timestamp prefix on what prints (reference:
    util/misc.py:174-188). Idempotent; a single process keeps print as it
    is."""
    if get_world_size() <= 1 or getattr(builtins.print, "_flipped_wrapped",
                                        False):
        return
    builtin_print = builtins.print
    main = is_main_process()

    def print_fn(*args, **kwargs):
        forced = kwargs.pop("force", False)
        if main or force or forced:
            now = datetime.datetime.now().time()
            builtin_print(f"[{now}]", *args, **kwargs)

    print_fn._flipped_wrapped = True
    builtins.print = print_fn


def write_log_line(output_dir: str, stats: Dict[str, Any]) -> None:
    """Append one JSON line to {output_dir}/log.txt (reference:
    train.py:144-148), from rank 0; nothing without an output_dir."""
    if not output_dir or not is_main_process():
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a",
              encoding="utf-8") as f:
        f.write(json.dumps(stats) + "\n")


def save_result(result: List[Any], result_dir: str, filename: str) -> str:
    """Write this rank's {result_dir}/{filename}_rank{R}.json, then, on
    rank 0 once every rank has written, the merged {filename}.json: the
    shards' lists concatenated in rank order (reference: util/misc.py:
    570-610). Returns the merged file's path."""
    os.makedirs(result_dir, exist_ok=True)
    rank = get_rank()
    with open(os.path.join(result_dir, f"{filename}_rank{rank}.json"),
              "w") as f:
        json.dump(result, f)
    final = os.path.join(result_dir, f"{filename}.json")
    barrier()
    if rank == 0:
        merged: List[Any] = []
        for r in range(get_world_size()):
            with open(os.path.join(result_dir,
                                   f"{filename}_rank{r}.json")) as f:
                merged += json.load(f)
        with open(final, "w") as f:
            json.dump(merged, f)
        print(f"result file saved to {final}")
    barrier()
    return final
