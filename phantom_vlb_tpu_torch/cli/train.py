"""vlb-train-torch: the training entry point of the port.

Usage (the arguments of ``vlb-train``, plus ``--device``)::

    vlb-train-torch experiment=vlb_friends_lora subject=sub-01 [key=value ...]
    vlb-train-torch --config-path ./configs experiment=vlb_friends_baseline subject=sub-03
    vlb-train-torch ... model.preset=tiny --device cpu

It runs on the card (``--device cuda``, the default) and raises when there
is none; ``--device cpu`` runs on the CPU.

One process trains on one card. To shard over a node's cards (the configs
of record set ``mesh.fsdp: -1``), launch one process per card::

    VLB_NCCL_MULTI_CARD=1 torchrun --nproc_per_node=4 -m phantom_vlb_tpu_torch.cli.train \
        experiment=vlb_friends_lora subject=sub-01 datamodule.batch_size=4

Each process joins the group (NCCL; gloo with ``--device cpu``) before the
run is built, as ``phantom_vlb_tpu/cli/train.py:31-34`` initialises JAX's
distributed runtime, and trains on its card (``LOCAL_RANK``). Over more
than one card the launch is refused without ``VLB_NCCL_MULTI_CARD=1``: the
path has run to its end on one card only, and its one launch over 2 cards
stalled for a cause not found (``core/distributed.py``; ROADMAP Queue 1
#4). A collective stalled past its time limit ends the ranks, naming it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from phantom_vlb_tpu_torch.core.config import load_config

DEFAULT_CONFIG_PATH = Path(__file__).resolve().parents[2] / "configs"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-path", default=str(DEFAULT_CONFIG_PATH))
    parser.add_argument("--config-name", default="base")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    args = parser.parse_args(argv)

    config = load_config(args.config_path, args.config_name, args.overrides)
    if not config.get("experiment") and "datamodule" not in config:
        parser.error("select an experiment, e.g. experiment=vlb_friends_lora")

    from phantom_vlb_tpu_torch.core.distributed import maybe_initialize_distributed, process_info, shutdown_distributed
    from phantom_vlb_tpu_torch.train.builder import run_training

    maybe_initialize_distributed(args.device)
    rank = process_info()["process_index"]
    # Left only after a run that ended well: leaving a group while a peer
    # waits in a collective can block (the launcher ends the others).
    final = run_training(config, args.device)
    shutdown_distributed()
    if final and rank == 0:
        print(f"final val/brain_loss={final.get('val/brain_loss'):.6f} "
              f"val_corr_avg={final.get('val_corr_avg'):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
