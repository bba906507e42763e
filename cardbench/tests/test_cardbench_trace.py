"""The trace reduction and the per-layer readers on a hand-made trace."""

from __future__ import annotations

import pytest

from cardbench.flops import bound_s, flash_bwd_cost, flash_fwd_cost
from cardbench.harness import Run, breakdown, load_plugin
from cardbench.trace import DEVICE_KINDS, STEP_SPAN, WINDOW_SPAN, activity, kernel_group, reduce
from conftest import cell_files


class Event:
    def __init__(self, kind, name, start, end, corr=0, linked=0, tid=1, shapes=()):
        self.kind, self._name, self.start, self.end = kind, name, start, end
        self.corr, self.linked, self.tid, self._shapes = corr, linked, tid, list(shapes)

    def device_type(self):
        class Kind:
            name = "CUDA" if self.kind in DEVICE_KINDS + ("gpu_user_annotation",) else "CPU"
        return Kind()

    def name(self): return self._name
    def start_ns(self): return self.start
    def end_ns(self): return self.end
    def duration_ns(self): return self.end - self.start
    def correlation_id(self): return self.corr
    def linked_correlation_id(self): return self.linked
    def start_thread_id(self): return self.tid
    def shapes(self): return self._shapes


FWD = "void flash_fwd_kernel<false>(CUtensorMap_st, CUtensorMap_st)"
Q, K = [1, 4, 16], [1, 4, 8]


def _events():
    return [
        Event("user_annotation", WINDOW_SPAN, 0, 1000, corr=1),
        Event("user_annotation", STEP_SPAN, 10, 900, corr=2),
        Event("user_annotation", "vision", 20, 100, corr=3),
        Event("cpu_op", "aten::mm", 30, 40, corr=4),
        Event("cpu_op", "vlb::flash_fwd", 150, 160, corr=5, shapes=[Q, K, K, [1, 4]]),
        Event("cpu_op", "aten::_local_scalar_dense", 500, 880, corr=6),
        Event("cuda_runtime", "cudaMemcpyAsync", 510, 870, corr=77, linked=6),
        Event("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 100, 200, corr=70, linked=4),
        Event("kernel", FWD, 250, 350, corr=71, linked=5),
        Event("kernel", "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>(Params)", 300, 400,
              corr=72, linked=4),
        Event("kernel", "flash_bwd_prep_kernel(bf16 const*)", 400, 420, corr=73, linked=4),
        Event("kernel", "flash_bwd_kernel(CUtensorMap_st)", 420, 480, corr=74, linked=4),
        Event("kernel", "flash_bwd_post_kernel(float*)", 480, 500, corr=75, linked=4),
        Event("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 860, 870, corr=77, linked=6),
        Event("kernel", "vectorized_elementwise_kernel<4>", 2000, 2100, corr=76, linked=4),   # after the window
        Event("gpu_user_annotation", STEP_SPAN, 10, 900),
    ]


@pytest.mark.parametrize("event", _events(), ids=lambda e: f"{e.kind}:{e._name[:24]}")
def test_event_kinds_from_device_and_name(event):
    want = "kernel" if event.kind == "gpu_user_annotation" else event.kind     # reduce drops it by name
    assert activity(event) == want


def test_groups():
    assert kernel_group(FWD) == "flash_fwd"
    assert kernel_group("void pytorch_flash::flash_fwd_kernel<T>(P)") == "attention_lib"
    assert kernel_group("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTT") == "gemm"
    assert kernel_group("void lora_da_kernel<16>(CUtensorMap_st)") == "lora"
    assert kernel_group("void at::native::vectorized_elementwise_kernel<4>(int)") == "eager"
    assert kernel_group("Memcpy HtoD", is_kernel=False) == "memory"


def test_reduce_window_busy_gaps_and_ranges():
    tr = reduce(_events(), steps=1)
    assert tr.window_ns == (0, 1000) and len(tr.ops) == 7                  # the late kernel left out
    assert tr.busy_ns == 100 + 250 + 10                                      # [100, 200), [250, 500), [860, 870)
    gaps = {}
    for name, ns in tr.gaps:
        gaps[name] = gaps.get(name, 0) + ns
    # [0, 100) before the step, [200, 250) between ops, [500, 860) and [870, 1000) in the sync
    assert gaps == {f"{WINDOW_SPAN}/-": 100, f"{STEP_SPAN}/-": 50,
                    f"{STEP_SPAN}/aten::_local_scalar_dense": 360 + 130}
    assert tr.in_range_s("vision") == pytest.approx((100 + 100 + 20 + 60 + 20) / 1e9)
    assert tr.group_s("flash_bwd") == pytest.approx(100 / 1e9)
    b = breakdown(tr, tr)
    assert b["device_ops"][0][1] == pytest.approx(100 / 1e9) and len(b["idle_gaps"]) <= 10


def test_readers():
    config, _ = cell_files("lora-frames-b3")
    peaks = {"bf16_flops": 989e12, "bytes_per_s": 3.35e12}
    r = Run(config["model"], 3, 1e12, peaks)
    r.step_s, r.window_s = [0.5, 0.7], 1.25
    r.trace = r.host_trace = reduce(_events(), steps=1)
    assert load_plugin("metrics", "step_ms_max").read(r) == pytest.approx(700.0)
    assert load_plugin("metrics", "step_mfu").read(r) == pytest.approx(100 * 2e12 / (1.25 * 989e12))
    assert load_plugin("metrics", "device_idle_share").read(r) == pytest.approx(64.0)
    assert load_plugin("metrics", "gemm_device_ms").read(r) == pytest.approx(100 / 1e6)
    assert load_plugin("metrics", "vision_device_ms").read(r) == pytest.approx(300 / 1e6)
    r.model = {**config["model"], "text": {**config["model"]["text"], "head_dim": 8}}    # Q: 2 heads, K: 1
    fwd = bound_s(*flash_fwd_cost(1, 4, 2, 1, 8), peaks)
    assert load_plugin("metrics", "flash_fwd_roofline").read(r) == pytest.approx(100 * fwd / 100e-9)
    bwd = bound_s(*flash_bwd_cost(1, 4, 2, 1, 8), peaks)
    assert load_plugin("metrics", "flash_bwd_roofline").read(r) == pytest.approx(100 * bwd / 100e-9)


def test_readers_give_nothing_without_a_trace():
    config, _ = cell_files("lora-frames-b3")
    r = Run(config["model"], 3, 1e12, None)
    for name in ("vision_device_ms", "gemm_device_ms", "eager_device_ms", "flash_fwd_roofline",
                 "flash_bwd_roofline", "device_idle_share", "step_mfu", "step_ms_max"):
        assert load_plugin("metrics", name).read(r) is None


def test_a_device_only_pass_takes_the_host_clocks_window():
    events = [e for e in _events() if e.kind in ("kernel", "gpu_memcpy", "cuda_runtime")
              and e.start < 1000]
    tr = reduce(events, steps=1, window_s=2e-6)
    assert tr.window_ns == (100, 871) and tr.window_s == 2e-6 and tr.busy_ns == 360
    r = Run({}, 1, 0.0, None)
    r.trace = tr
    assert load_plugin("metrics", "device_idle_share").read(r) == pytest.approx(100 * (1 - 360e-9 / 2e-6))


def _flash_run(host_events, device_events):
    config, _ = cell_files("lora-frames-b3")
    peaks = {"bf16_flops": 989e12, "bytes_per_s": 3.35e12}
    r = Run({**config["model"], "text": {**config["model"]["text"], "head_dim": 8}}, 3, 1e12, peaks)
    r.host_trace = reduce(host_events, steps=1)
    r.trace = reduce(device_events, steps=2, window_s=1e-6)
    return r, peaks


def test_flash_rooflines_read_the_device_pass_when_the_host_step_lost_a_kernel():
    host = [e for e in _events() if "flash_fwd_kernel<false>" not in e._name and "bwd" not in e._name]
    device = [Event("kernel", FWD, 0, 100), Event("kernel", FWD, 200, 500),
              Event("kernel", "flash_bwd_prep_kernel(bf16 const*)", 500, 520),
              Event("kernel", "flash_bwd_kernel(CUtensorMap_st)", 520, 600),
              Event("kernel", "flash_bwd_post_kernel(float*)", 600, 620)]
    r, peaks = _flash_run(host, device)
    fwd = bound_s(*flash_fwd_cost(1, 4, 2, 1, 8), peaks)
    assert load_plugin("metrics", "flash_fwd_roofline").read(r) == pytest.approx(100 * 2 * fwd / 400e-9)
    bwd = bound_s(*flash_bwd_cost(1, 4, 2, 1, 8), peaks)
    assert load_plugin("metrics", "flash_bwd_roofline").read(r) == pytest.approx(100 * bwd / 120e-9)


@pytest.mark.parametrize("metric", ["flash_fwd_roofline", "flash_bwd_roofline"])
def test_flash_rooflines_give_nothing_for_calls_of_two_shapes(metric):
    host = _events() + [Event("cpu_op", "vlb::flash_fwd", 170, 180, corr=9, shapes=[[1, 8, 16], K, K, [1, 8]])]
    r, _ = _flash_run(host, _events())
    assert load_plugin("metrics", metric).read(r) is None
