"""The numbers that decide ``correct``: the program's checked steps against
the reference's.

- ``loss_gap``: the largest over the checked steps of |loss - reference's|
  over |reference's|.
- ``grad_gap``: the first step's gradient as the optimizer got it (AdamW's
  first moment over 1 - beta1 on the program's side, the clipped gradient on
  the reference's), by the worst leaf: |program's norm - reference's norm|
  over the larger of the reference's norm of that leaf and of the median
  leaf.
- ``change_gap``: the same of each leaf's change over the checked steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).
- ``nonfinite_steps``, where the caller counts them: steps whose loss or
  gradient was not finite; its limit is 0.

A run is correct where every number is within its limit.
"""

from __future__ import annotations

import statistics

__all__ = ["checks", "leaf_gap", "QUIET_LEAF"]

QUIET_LEAF = 1e-3


def leaf_gap(program: dict[str, float], reference: dict[str, float], leaves=None) -> tuple[float, str]:
    """(worst gap, its leaf) of two {leaf: norm} over ``leaves`` (all)."""
    leaves = sorted(reference) if leaves is None else leaves
    median = statistics.median(reference[n] for n in leaves)
    worst, at = 0.0, ""
    for n in leaves:
        gap = abs(program[n] - reference[n]) / max(reference[n], median, 1e-30)
        if gap > worst or not at:
            worst, at = gap, n
    return worst, at


def checks(program: dict, reference: dict, limits: dict[str, float], log=None,
           nonfinite_steps: int | None = None) -> tuple[bool, dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) of the program's readings
    against the reference's; ``log`` gets the worst leaf of each."""
    if set(program["grad_norm"]) != set(reference["grad_norm"]):
        raise ValueError("the program and the reference train different tensors")
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], reference["loss"], strict=True))
    grad, grad_at = leaf_gap(program["grad_norm"], reference["grad_norm"])
    median = statistics.median(reference["grad_norm"].values())
    moving = sorted(n for n, g in reference["grad_norm"].items() if g >= QUIET_LEAF * median)
    change, change_at = leaf_gap(program["change_norm"], reference["change_norm"], moving)
    if log is not None:
        log(f"worst leaves: gradient {grad_at}, change {change_at} "
            f"({len(reference['grad_norm']) - len(moving)} quiet leaves left out of the change)")
    compared = {"loss_gap": {"value": loss, "limit": limits["loss_gap"]},
                "grad_gap": {"value": grad, "limit": limits["grad_gap"]},
                "change_gap": {"value": change, "limit": limits["change_gap"]}}
    if nonfinite_steps is not None:
        compared["nonfinite_steps"] = {"value": float(nonfinite_steps), "limit": 0.0}
    # A gap that is not a number (a loss gone to NaN) fails: NaN <= limit is false.
    return all(c["value"] <= c["limit"] for c in compared.values()), compared
