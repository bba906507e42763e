"""vlb-train-torch: the training entry point of the port.

Usage (the arguments of ``vlb-train``, plus ``--device``)::

    vlb-train-torch experiment=vlb_friends_lora subject=sub-01 [key=value ...]
    vlb-train-torch --config-path ./configs experiment=vlb_friends_baseline subject=sub-03
    vlb-train-torch ... model.preset=tiny --device cpu

It runs on the card (``--device cuda``, the default) and raises when there
is none; ``--device cpu`` runs on the CPU.
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

    from phantom_vlb_tpu_torch.train.builder import run_training

    final = run_training(config, args.device)
    if final:
        print(f"final val/brain_loss={final.get('val/brain_loss'):.6f} "
              f"val_corr_avg={final.get('val_corr_avg'):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
