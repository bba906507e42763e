"""The share of the 32-bit adapter dropout's site calls that took the port's
keep-byte kernel route, in %: ``lora_dropout32.kernel`` over it and
``lora_dropout32.eager`` (``models/lora.py``), counted by the program's
``utils/profiling.py`` ``count`` while the harness's passes were traced.
Nothing where nothing was counted: a cell without adapters, or a program
without the counters."""

KERNEL = "lora_dropout32.kernel"
EAGER = "lora_dropout32.eager"


def read(run):
    from phantom_vlb_tpu_torch.utils import profiling

    counts = getattr(profiling, "COUNTS", None)
    if counts is None:
        return None
    kernel, eager = counts.get(KERNEL, 0), counts.get(EAGER, 0)
    if kernel + eager == 0:
        return None
    return 100.0 * kernel / (kernel + eager)
