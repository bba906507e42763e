"""Run one benchmark cell once and print its result as the last line.

    python cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository, on a machine with the
cards the cell asks for. ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, the device's busy time over a traced
window and a breakdown. The numbers the check compares, each with its
limit, are the last lines on standard error and the last key of the result.
Exits non-zero, with no result, without the cards, or if JAX or the JAX
package was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache in the checkout, at fixed paths: only a
# checkout's first run builds (the port's nvcc libraries live in
# build/phantom_vlb_tpu_torch/ beside the package).
CACHE = ROOT / "build" / "cardbench-cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "phantom_vlb_tpu")


def forbidden_modules() -> list[str]:
    """Imported modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN)


def cell_spec(bench: dict, workload: str) -> tuple[dict, dict, dict, list, list]:
    """The cell, its configuration and traffic files, and the metrics it reports."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = json.loads((ROOT / "cardbench" / "configs" / f"{cell['config']}.json").read_text(encoding="utf-8"))
    traffic = json.loads((ROOT / "cardbench" / "workloads" / f"{cell['traffic']}.json").read_text(encoding="utf-8"))

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return cell, config, traffic, mine(bench["per_layer"]), mine(bench["end_to_end"])


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
    cell, config, traffic, per_layer, end_to_end = cell_spec(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    from cardbench.harness import run

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run(config, traffic, per_layer, end_to_end, args.seed, args.seconds, bool(args.trace),
                 "cuda", T_START, log)
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
                        **result["device"], "power_limit": power_limit()}
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was imported: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
