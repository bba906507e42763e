"""The port's flash backward (``csrc/flash_bwd.cu``: prep, main and post
kernels summed) against its roofline, in %: the least time of every
backward (``flops.flash_bwd_cost``, one per main kernel, at the shape of
the step's ``vlb::flash_fwd`` calls in the step traced with the host) over
the three kernels' summed time, both from the pass that traces the device
alone. Nothing where the step's calls are not all of one shape."""

from cardbench.flops import bound_s, flash_bwd_cost
from cardbench.trace import port_kernel


def read(run):
    if run.trace is None or run.host_trace is None or run.peaks is None:
        return None
    shapes = {(tuple(c[0]), tuple(c[1])) for c in run.host_trace.op_shapes.get("vlb::flash_fwd", [])}
    mains = sum(1 for op in run.trace.ops if port_kernel(op.name) == "flash_bwd_kernel")
    kernel_s = run.trace.group_s("flash_bwd")
    if len(shapes) != 1 or not mains or kernel_s <= 0:
        return None
    ((b, s, qw), (_, _, kw)), = shapes
    d = run.model["text"]["head_dim"]
    return 100.0 * mains * bound_s(*flash_bwd_cost(b, s, qw // d, kw // d, d), run.peaks) / kernel_s
