"""The port's flash forward (``ops/flash_attention.py`` ->
``csrc/flash_fwd.cu``) against its roofline, in %: the least time of one
launch (``flops.flash_fwd_cost`` at the shape of the step's
``vlb::flash_fwd`` calls: the causal half's operations at the bf16 peak, or
its bytes at the memory bandwidth) over the mean time of the kernel in the
pass that traces the device alone. The shape comes from the step traced
with the host; the cell's steps share it, since every batch is padded to
the geometry's length. The kernels are not paired with that step's calls:
a pass can lose a device record, and a mean over the kernels it kept is
the same number. Nothing where the step's calls are not all of one shape."""

from cardbench.flops import bound_s, flash_fwd_cost
from cardbench.trace import port_kernel


def read(run):
    if run.trace is None or run.host_trace is None or run.peaks is None:
        return None
    shapes = {(tuple(c[0]), tuple(c[1])) for c in run.host_trace.op_shapes.get("vlb::flash_fwd", [])}
    kernels = [op.dur_ns for op in run.trace.ops if port_kernel(op.name) == "flash_fwd_kernel"]
    if len(shapes) != 1 or not kernels:
        return None
    ((b, s, qw), (_, _, kw)), = shapes
    d = run.model["text"]["head_dim"]
    bound = bound_s(*flash_fwd_cost(b, s, qw // d, kw // d, d), run.peaks)
    return 100.0 * len(kernels) * bound / (sum(kernels) / 1e9)
