"""Readings that the check's limits are set from, other than the program's.

    python cardbench/calibrate.py --workload <cell> --seeds 11 12 13 [--modes control half_batch]

For each seed, with the weights, batches and dropout seeds a run of the
cell with that seed uses, the plain reference follows the checked steps
(f32, TF32 off), and in the program's place:

- ``control``: the reference with every product's operands in float8
  e4m3 (the precision below the configuration's bf16);
- ``half_batch``: the reference on the first half of each batch (rounded
  up), the mean taken over those rows: half of the batch left out.

Each prints one JSON line with the numbers the check compares and the
check's verdict on them, ``correct`` (the control and the fault have to
read false). A state
left unchanged reads 1 on ``change_gap`` by construction and needs no run.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cardbench.batches import Geometry, make_pool  # noqa: E402
from cardbench.compare import checks  # noqa: E402
from cardbench.harness import derive  # noqa: E402
from cardbench.reference.vlb import Reference, step_seeds  # noqa: E402

__all__ = ["readings", "MODES"]

MODES = ("control", "half_batch")


def _half(batch: dict) -> dict:
    keep = (len(batch["row_mask"]) + 1) // 2
    return {k: v[:keep] for k, v in batch.items()}


def readings(config: dict, workload: dict, seed: int, modes, device, log=print) -> list[dict]:
    """The reference's readings and each mode's against them, for ``seed``."""
    model = config["model"]
    n = workload["check_steps"]
    pool = make_pool(Geometry(model["geometry"]), np.random.default_rng(derive(seed, "batches")), n,
                     model["batch_size"], model["text"]["vocab_size"], model["head"]["num_target"],
                     tuple(workload["dialogue_tokens"]), workload["inst_len"])
    seeds = step_seeds(derive(seed, "random_state"), n)
    weight_seed = derive(seed, "weights", 63)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    ref = Reference(model, weight_seed, device).train(pool, seeds)
    out = [{"seed": seed, "mode": "reference", "s": time.perf_counter() - t, "loss": ref["loss"]}]
    for mode in modes:
        t = time.perf_counter()
        if mode == "control":
            got = Reference(model, weight_seed, device, quant="fp8").train(pool, seeds)
        elif mode == "half_batch":
            got = Reference(model, weight_seed, device).train([_half(b) for b in pool], seeds)
        else:
            raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
        correct, compared = checks(got, ref, workload["limits"], log)
        out.append({"seed": seed, "mode": mode, "s": time.perf_counter() - t, "loss": got["loss"],
                    "correct": correct, **{k: v["value"] for k, v in compared.items()}})
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--modes", nargs="+", default=list(MODES))
    args = parser.parse_args(argv)
    root = Path(__file__).resolve().parent
    bench = json.loads((root.parent / "BENCHMARK.json").read_text(encoding="utf-8"))
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    config = json.loads((root / "configs" / f"{cell['config']}.json").read_text(encoding="utf-8"))
    workload = json.loads((root / "workloads" / f"{cell['traffic']}.json").read_text(encoding="utf-8"))
    if not torch.cuda.is_available():
        print("calibrate runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for line in readings(config, workload, seed, args.modes, torch.device("cuda"),
                             lambda m: print(m, file=sys.stderr, flush=True)):
            print(json.dumps({"workload": args.workload, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
