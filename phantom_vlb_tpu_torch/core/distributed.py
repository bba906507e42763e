"""Multi-process initialisation: one process per card.

Counterpart of ``phantom_vlb_tpu/core/distributed.py`` (:1-62). JAX drives
every local device from one process and joins hosts with
``jax.distributed.initialize``; PyTorch's idiom is one process per card,
each told its rank by its launcher. :func:`maybe_initialize_distributed`
reads torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (with
``MASTER_ADDR`` / ``MASTER_PORT`` through ``env://``), or else the JAX
package's ``VLB_COORDINATOR`` (host:port), ``VLB_NUM_PROCESSES`` and
``VLB_PROCESS_ID``, so launch scripts written for it keep working (there,
too, one process per card: ``LOCAL_RANK``, or the process id modulo the
node's cards, picks the card).

On the card the process group is NCCL, and the process's card is made the
current device before anything resolves a bare ``"cuda"``
(``core/device.py``). Gloo is used only when the caller asks for the CPU.
A missing card or NCCL raises: nothing falls back.

A group of more than one card is refused unless ``VLB_NCCL_MULTI_CARD=1``
is set: sharded training over NCCL has run to its end on one card only,
and its one launch over 2 cards of a 4-card machine stalled with no
diagnosis (ROADMAP Queue 1 #4). Gloo on the CPU takes any world size.

Every collective has a finite time limit (``timeout_s``): a rank that waits
on a peer longer than that is ended by the process group's watchdog, which
names the collective, instead of waiting for ever; a process that joins a
group turns on ``faulthandler``, so a rank ended that way also prints
where each of its threads stood.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import sys

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "is_multihost", "process_info", "shutdown_distributed",
           "barrier", "broadcast_object", "DIST_TIMEOUT_S", "MULTI_CARD_OPT_IN"]

# A collective's time limit: above the longest a rank waits on its peers in
# training (a peer's first-use kernel build, rank 0 writing a checkpoint).
DIST_TIMEOUT_S = 600.0
# The variable that lets an NCCL group span more than one card.
MULTI_CARD_OPT_IN = "VLB_NCCL_MULTI_CARD"


def _launch_env() -> tuple[str, int, int, int | None] | None:
    """(init method, rank, world size, local rank or None) that the
    environment gives, or None when no launcher set it."""
    env = os.environ
    local = int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env else None
    if "RANK" in env and "WORLD_SIZE" in env:
        return "env://", int(env["RANK"]), int(env["WORLD_SIZE"]), local
    if env.get("VLB_COORDINATOR"):
        return (f"tcp://{env['VLB_COORDINATOR']}", int(env["VLB_PROCESS_ID"]),
                int(env["VLB_NUM_PROCESSES"]), local)
    return None


def maybe_initialize_distributed(device: str | torch.device = "cuda", init_method: str | None = None,
                                 timeout_s: float = DIST_TIMEOUT_S) -> bool:
    """Join the process group when a launcher started this process.

    ``device``: ``"cuda"`` (NCCL, this process's card made current) or
    ``"cpu"`` (gloo). ``init_method`` replaces the environment's rendezvous
    (e.g. ``file://...`` for tests); ``timeout_s`` is each collective's
    time limit. Returns whether the process is in a
    group; repeated calls are no-ops; without a launcher's variables it does
    nothing and returns False.
    """
    if dist.is_initialized():
        return True
    found = _launch_env()
    if found is None:
        return False
    method, rank, world, local = found
    if not faulthandler.is_enabled():
        faulthandler.enable(sys.__stderr__)
    device = torch.device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if device.type == "cuda":
        if world > 1 and os.environ.get(MULTI_CARD_OPT_IN) != "1":
            raise NotImplementedError(
                f"training over {world} cards (NCCL) has not yet run to its end on cards: its one launch, "
                "on 2 cards of a 4-card machine, stalled for a cause not found (ROADMAP Queue 1 #4). Train "
                f"in one process on one card, or over gloo with --device cpu; set {MULTI_CARD_OPT_IN}=1 to "
                "run it all the same (a collective stalled past its time limit ends the ranks)")
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card, and none is available; pass device='cpu' "
                               "to train on the CPU over gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this PyTorch build lacks")
        n_cards = torch.cuda.device_count()
        card = local if local is not None else rank % n_cards
        if card >= n_cards:
            raise RuntimeError(f"local rank {card} has no card: this node has {n_cards}")
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", init_method=init_method or method, rank=rank, world_size=world,
                                timeout=timeout, device_id=torch.device("cuda", card))
    elif device.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method or method, rank=rank, world_size=world,
                                timeout=timeout)
    else:
        raise ValueError(f"no process group for device {device}")
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait until every process of the group reaches this point (a no-op
    outside a group): e.g. a file rank 0 wrote is whole for every rank."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """``obj`` as process ``src`` holds it, on every process of the group
    (``obj`` itself outside one): one process's decision, taken alike."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def is_multihost() -> bool:
    """More than one process in the group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """This process's index and the group's size, in the JAX package's
    keys; a process drives one device."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return {"process_index": rank, "process_count": world, "local_devices": 1, "global_devices": world}
