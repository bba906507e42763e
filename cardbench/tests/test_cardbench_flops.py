"""The operation and byte counters against hand counts at tiny shapes."""

from __future__ import annotations

import pytest

from cardbench.flops import (bound_s, causal_pairs, clip_frame_flops, decoder_clip_flops, flash_bwd_cost,
                             flash_fwd_cost, head_clip_flops, stc_clip_flops, step_flops)
from conftest import cell_files


def test_flash_costs_by_hand():
    # b 1, s 4, hq 2, hkv 1, d 8: 10 causal pairs.
    assert causal_pairs(4) == 10
    flops, nbytes = flash_fwd_cost(1, 4, 2, 1, 8)
    assert flops == 2 * 2 * 2 * 8 * 10
    assert nbytes == 2 * (4 * 16 + 4 * 8 + 4 * 8 + 4 * 16) + 4 * 2 * 4 + 4 * 4
    flops, nbytes = flash_bwd_cost(1, 4, 2, 1, 8)
    assert flops == 5 * 2 * 2 * 8 * 10
    reads = 2 * (3 * 4 * 16 + 2 * 4 * 8) + 4 * 2 * 4 + 4 * 4      # q, out, dout, k, v; lse; bias
    writes = 2 * (4 * 16 + 2 * 4 * 8)                              # dq, dk, dv
    assert nbytes == reads + writes


def test_bound_takes_the_larger():
    peaks = {"bf16_flops": 100.0, "bytes_per_s": 10.0}
    assert bound_s(1000.0, 10.0, peaks) == 10.0 and bound_s(10.0, 1000.0, peaks) == 100.0


def test_decoder_by_hand():
    # one layer, hidden 4, 1 head of 4, 1 kv head, intermediate 8, s 2, rank 1
    t = {"hidden_size": 4, "head_dim": 4, "num_attention_heads": 1, "num_key_value_heads": 1,
         "intermediate_size": 8, "num_hidden_layers": 1}
    base = 2 * 2 * (4 * 4 * 4 + 3 * 4 * 8)            # q k v o, gate up down
    attn = 2 * 2 * 1 * 4 * causal_pairs(2)
    assert decoder_clip_flops(t, 2, None, backward=False) == base + attn
    lora = 2 * 2 * 1 * (4 * (4 + 4) + 2 * (4 + 8) + (8 + 4))
    assert decoder_clip_flops(t, 2, {"r": 1}, backward=False) == base + attn + lora
    # backward: dx through every base product but layer 0's q, k, v; dB, dz, dA everywhere;
    # dx through A except layer 0's q, k, v; attention's four products.
    dx_base = 2 * 2 * (4 * 4 + 3 * 4 * 8)
    adapters = sum(2 * 2 * 1 * n_out * 2 + 2 * 2 * n_in * 1
                   for n_in, n_out in [(4, 4)] * 4 + [(4, 8), (4, 8), (8, 4)])
    dx_a = 2 * 2 * 1 * (4 + 4 + 4 + 8)
    want = base + attn + lora + dx_base + adapters + dx_a + 2 * attn
    assert decoder_clip_flops(t, 2, {"r": 1}, backward=True) == want


def test_towers_by_hand():
    v = {"image_size": 28, "patch_size": 14, "hidden_size": 2, "intermediate_size": 4, "num_hidden_layers": 2,
         "select_layer": -2}
    s = 5                                              # 4 patches and CLS
    layer = 2 * s * (4 * 2 * 2 + 2 * 2 * 4) + 4 * s * s * 2
    assert clip_frame_flops(v) == 2 * 4 * 3 * 14 * 14 * 2 + layer
    c = {"hidden_size": 4, "depth": 1, "mlp_depth": 2, "se_ratio": 0.5}
    # 2 frames of 2x2: s1 one block 2 -> 4 (rd 1); sampler to 2 frames of 2x2; s2 one block 4 -> 4 (rd 2)
    s1 = 2 * 8 * (2 * 4 + 4 * 4 + 2 * 4 + 9 * 4) + 2 * 2 * 2 * 4 * 1
    s2 = 2 * 8 * (4 * 4 + 4 * 4 + 9 * 4) + 2 * 2 * 2 * 4 * 2
    sampler = 2 * 8 * 8 * 4 * 4
    readout = 2 * 8 * (4 * 3 + 3 * 3)
    assert stc_clip_flops(c, v, 3, 2) == s1 + sampler + s2 + readout


def test_head_by_hand():
    assert head_clip_flops(4, 3, 5) == 2 * 5 * 4 * 2 + 3 * 2 * 4 * 3


@pytest.mark.parametrize("cell, per_clip", [("lora-frames-b3", (6.0e13, 7.0e13)),
                                            ("baseline-frames-b5", (3.0e13, 4.0e13))])
def test_step_flops_at_full_width(cell, per_clip):
    config, _ = cell_files(cell)
    m = config["model"]
    total = step_flops(m, m["batch_size"], 2048, 12)
    lo, hi = per_clip
    assert lo * m["batch_size"] < total < hi * m["batch_size"]
