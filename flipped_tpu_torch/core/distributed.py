"""Multi-process bring-up with launcher discovery (JAX:
flipped_tpu/core/distributed.py; reference: util/misc.py:220-250).

Discovery order, first match wins, as in JAX (`detect_launcher` :29):

  1. torchrun, or any launcher that sets them: RANK and WORLD_SIZE, with
     LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT (the
     reference's first branch, util/misc.py:222-225; JAX's explicit-env
     branch);
  2. a SLURM step of more than one task: SLURM_PROCID, SLURM_NTASKS,
     SLURM_LOCALID, SLURM_STEP_TASKS_PER_NODE (util/misc.py:230-233);
  3. OpenMPI of more than one rank: OMPI_COMM_WORLD_RANK, _SIZE,
     _LOCAL_RANK and _LOCAL_SIZE;
  4. none: one process, as in JAX (util/misc.py:226-229).

SLURM and OpenMPI give no rendezvous address: MASTER_ADDR and MASTER_PORT
are read from the environment there too (default 127.0.0.1:29500).

The backend follows the device, and every rank of a host takes the same
one. `--device cpu` takes gloo. On the card, while each local rank has a
card of its own (the host's ranks, LOCAL_WORLD_SIZE, at most
torch.cuda.device_count()), a rank takes nccl on cuda:LOCAL_RANK. NCCL
refuses two ranks on one device, so where the local ranks outnumber the
cards `init_distributed_mode` raises, naming both counts, unless its
caller passes `share_device=True`: then every rank takes gloo on the card
LOCAL_RANK % count, and the choice is printed (the smoke on one card does
this; no CLI flag asks for it). A launcher that does not say how many
ranks a host holds is taken to hold them all on one host.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# the device init_distributed_mode chose for this process, once it has run
_DEVICE: Optional[torch.device] = None


def detect_launcher() -> tuple:
    """(launcher name, {rank, world_size, local_rank, master_addr,
    master_port}) or (None, {})."""
    e = os.environ
    addr = e.get("MASTER_ADDR", "127.0.0.1")
    port = int(e.get("MASTER_PORT", "29500"))

    def found(name, rank, world, local, local_world):
        return name, dict(rank=int(rank), world_size=int(world),
                          local_rank=int(local),
                          local_world_size=int(local_world or world),
                          master_addr=addr, master_port=port)

    if "RANK" in e and "WORLD_SIZE" in e:
        return found("env", e["RANK"], e["WORLD_SIZE"],
                     e.get("LOCAL_RANK", e["RANK"]),
                     e.get("LOCAL_WORLD_SIZE"))
    slurm_keys = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
                  "SLURM_PROCID", "SLURM_LOCALID")
    if all(k in e for k in slurm_keys) and int(e["SLURM_NTASKS"]) > 1:
        # "4(x2),3": the tasks of the first node
        per_node = e.get("SLURM_STEP_TASKS_PER_NODE", "").split("(")[0]
        return found("slurm", e["SLURM_PROCID"], e["SLURM_NTASKS"],
                     e["SLURM_LOCALID"], per_node.split(",")[0] or None)
    if int(e.get("OMPI_COMM_WORLD_SIZE", "1") or "1") > 1:
        return found("ompi", e["OMPI_COMM_WORLD_RANK"],
                     e["OMPI_COMM_WORLD_SIZE"],
                     e.get("OMPI_COMM_WORLD_LOCAL_RANK", "0"),
                     e.get("OMPI_COMM_WORLD_LOCAL_SIZE"))
    return None, {}


def choose_backend(device: str, local_rank: int, local_world_size: int,
                   n_cards: int, share_device: bool = False) -> tuple:
    """(backend, this rank's device) for `device` ('cpu', 'cuda' or
    'cuda:N'): gloo on the CPU; nccl on cuda:local_rank while each of the
    host's `local_world_size` ranks has a card; with more local ranks than
    cards, gloo on the card local_rank % n_cards if `share_device`, else
    ValueError. Every rank of a host decides alike."""
    if torch.device(device).type == "cpu":
        return "gloo", torch.device("cpu")
    if local_world_size <= n_cards:
        return "nccl", torch.device("cuda", local_rank)
    if not share_device:
        raise ValueError(
            f"{local_world_size} local ranks on {n_cards} card(s): NCCL "
            f"refuses two ranks on one device; launch at most {n_cards} "
            f"ranks a host")
    if n_cards == 0:
        raise ValueError(f"--device {device}: no CUDA device")
    return "gloo", torch.device("cuda", local_rank % n_cards)


def init_distributed_mode(device: str = "cuda",
                          share_device: bool = False) -> torch.device:
    """Join the process group a launcher describes, once; → this rank's
    device. Without a launcher the run is one process on `device`. Safe
    to call again: once a group is joined, later calls return its
    device."""
    global _DEVICE
    if _DEVICE is not None:
        return _DEVICE
    launcher, kw = detect_launcher()
    if launcher is None:
        return torch.device(device)
    n_cards = (torch.cuda.device_count() if torch.cuda.is_available()
               else 0)
    backend, dev = choose_backend(device, kw["local_rank"],
                                  kw["local_world_size"], n_cards,
                                  share_device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "gloo" and dev.type == "cuda":
        print(f"rank {kw['rank']}: {kw['local_world_size']} local ranks "
              f"share {n_cards} card(s): gloo on {dev}", flush=True)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{kw['master_addr']}:{kw['master_port']}",
        rank=kw["rank"], world_size=kw["world_size"])
    _DEVICE = dev
    print(f"initialized torch.distributed via {launcher}: rank "
          f"{kw['rank']}/{kw['world_size']}, {backend} on {dev}", flush=True)
    return dev


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
