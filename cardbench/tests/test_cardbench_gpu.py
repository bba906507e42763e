"""On the card: the trace reduction finds the port's flash forward and a
library GEMM, and the roofline reader gives a share within 100%."""

from __future__ import annotations

import pytest
import torch

from cardbench.harness import Run, load_plugin
from cardbench.flops import peaks_for
from cardbench.trace import WINDOW_SPAN, reduce
from conftest import cell_files


@pytest.mark.gpu
def test_trace_of_the_ports_kernels(card):
    from torch.profiler import ProfilerActivity, profile, record_function

    from phantom_vlb_tpu_torch.ops.flash_attention import attention_packed

    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(1, 2048, 32 * 128, generator=gen, device=card, dtype=torch.bfloat16)
    k, v = (torch.randn(1, 2048, 8 * 128, generator=gen, device=card, dtype=torch.bfloat16) for _ in range(2))
    w = torch.randn(4096, 4096, generator=gen, device=card, dtype=torch.bfloat16)
    attention_packed(q, k, v, 32, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(3):
                attention_packed(q, k, v, 32, 8)
                q @ w
            torch.cuda.synchronize()
    tr = reduce(prof.profiler.kineto_results.events(), steps=1)
    groups = {op.group for op in tr.ops}
    assert {"flash_fwd", "gemm"} <= groups and 0 < tr.busy_ns <= tr.window_ns[1] - tr.window_ns[0]
    config, _ = cell_files("lora-frames-b3")
    r = Run(config["model"], 1, 0.0, peaks_for(torch.cuda.get_device_name(card)))
    r.trace = r.host_trace = tr
    share = load_plugin("metrics", "flash_fwd_roofline").read(r)
    if r.peaks is None:
        pytest.skip(f"no peaks for {torch.cuda.get_device_name(card)}")
    assert 0 < share <= 100
