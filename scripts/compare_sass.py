"""Compare the machine code (SASS) of CUDA sources built from two source trees.

Builds each named source from ``OLD`` and from ``NEW`` (two ``csrc``
directories) with the port's own ``nvcc`` flags (``ops/_build.py``), dumps
each library's SASS with ``cuobjdump -sass`` and compares the kernels'
instruction streams, symbol names aside (a kernel in an anonymous namespace
carries a name derived from its source file, which need not repeat). Prints
one line a source and exits 1 if any differs. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit): run it on the machine with the card::

    python scripts/compare_sass.py build/parent/phantom_vlb_tpu_torch/csrc \\
        phantom_vlb_tpu_torch/csrc flash_fwd.cu flash_bwd.cu ring_fwd.cu lora_epilogue.cu
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from phantom_vlb_tpu_torch.ops import _build  # noqa: E402

_HEADER = re.compile(r"^\s*Function\s*:\s*(\S+)")


def _cuobjdump() -> str:
    return str(Path(_build._nvcc()).with_name("cuobjdump"))


def kernels(source: Path, out: Path) -> dict[str, list[str]]:
    """Build ``source`` into ``out`` and return its kernels' SASS: a
    normalised name (hex runs of the mangled name dropped) -> the
    instruction lines, in order."""
    subprocess.run([_build._nvcc(), *_build._flags(source), "-o", str(out), str(source)], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    dump = subprocess.run([_cuobjdump(), "-sass", str(out)], check=True, capture_output=True, text=True).stdout
    found: dict[str, list[str]] = {}
    current = None
    for line in dump.splitlines():
        head = _HEADER.match(line)
        if head:
            name = re.sub(r"[0-9a-f]{6,}", "", head.group(1))
            current = found.setdefault(name, [])
        elif current is not None and line.strip().startswith("/*"):
            current.append(line.strip())
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, help="the first csrc directory")
    ap.add_argument("new", type=Path, help="the second csrc directory")
    ap.add_argument("sources", nargs="+", help="source file names present in both")
    args = ap.parse_args(argv)
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.sources:
            old = kernels(args.old / name, Path(tmp) / f"old-{name}.so")
            new = kernels(args.new / name, Path(tmp) / f"new-{name}.so")
            # Names aside: the multisets of the kernels' instruction streams.
            same = sorted(map(tuple, old.values())) == sorted(map(tuple, new.values()))
            count = sum(len(v) for v in new.values())
            print(f"{name}: {len(new)} kernels, {count} SASS lines: "
                  + ("identical" if same else f"DIFFERENT (old {sum(len(v) for v in old.values())} lines)"))
            differ += not same
    return 1 if differ else 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
