"""Run one benchmark cell traced, as ``run.py --trace 1`` does, and print
after its result line the device-only pass by program span
(``spans.table``): the idle time put down to each span, and each span's
length and host self time, in ms a step.

    python cardbench/span_table.py --workload <cell> --seed <n> --seconds <s>

Run from the root of a checkout, on the cards the cell asks for. The last
line is ``{"spans": {...}}``; the line before it is the run's result.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cardbench import harness, run, spans  # noqa: E402


def main(argv=None) -> int:
    tables = []
    breakdown = harness.breakdown

    def keep(tr, host_tr):             # the harness hands the device-only pass to its breakdown
        tables.append(spans.table(tr, spans.records()))
        return breakdown(tr, host_tr)

    harness.breakdown = keep
    rc = run.main([*(sys.argv[1:] if argv is None else argv), "--trace", "1"])
    for t in tables:
        print(json.dumps({"spans": t}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
