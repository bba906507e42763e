"""Operations and bytes the algorithm needs, from shapes, and the card's peaks.

``step_flops`` counts what a training step needs and no recompute: 2·m·n·k
for each product, the causal half of attention (query row i sees keys 0..i),
the forward of the frozen towers and of the decoder, and in LoRA cells the
activation gradients through the frozen base, the attention backward (four
products) and the adapters' weight gradients. No weight gradient is counted
for a frozen weight, and no activation gradient where nothing upstream
trains (layer 0's q/k/v inputs: the embeddings enter cut from the graph).
Elementwise work, norms and the optimizer are not counted.

The flash kernels' costs count each input byte read once and each output
byte written once, and the operations of the causal half; the backward's
five products are those of the flash algorithm (the scores are made again
from q and k, as the saved inputs require).
"""

from __future__ import annotations

__all__ = ["PEAKS", "peaks_for", "bound_s", "causal_pairs", "clip_frame_flops", "stc_clip_flops",
           "decoder_clip_flops", "head_clip_flops", "step_flops", "flash_fwd_cost", "flash_bwd_cost"]

# Dense published peaks (no sparsity) by the name torch.cuda.get_device_name() gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}


def peaks_for(kind: str) -> dict | None:
    return PEAKS.get(kind)


def bound_s(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory bandwidth."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["bytes_per_s"])


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def clip_frame_flops(v: dict) -> float:
    """The CLIP tower on one frame: the patch conv, and in each layer up to
    the selected one the four projections, the MLP and the two attention
    products over all token pairs."""
    grid = v["image_size"] // v["patch_size"]
    s, e, p = grid * grid + 1, v["hidden_size"], v["patch_size"]
    layers = v["num_hidden_layers"] + v["select_layer"] + 1 if v["select_layer"] < 0 else v["select_layer"]
    layer = 2 * s * (4 * e * e + 2 * e * v["intermediate_size"]) + 4 * s * s * e
    return 2 * grid * grid * 3 * p * p * e + layers * layer


def stc_clip_flops(c: dict, v: dict, out_width: int, frames: int) -> float:
    """The STC connector on one clip of ``frames`` frames: each bottleneck's
    1x1 convs (and shortcut), depthwise 3x3 and squeeze-excite, the Conv3d
    sampler and the readout."""
    grid = v["image_size"] // v["patch_size"]

    def block(images, side, cin, cout):
        rd = max(1, int(round(cin * c["se_ratio"])))
        px = images * side * side
        convs = cin * cout + cout * cout + (cin * cout if cin != cout else 0) + 9 * cout
        return 2 * px * convs + 2 * images * 2 * cout * rd

    ch = c["hidden_size"]
    td, gd = frames // 2 + 1, grid // 2 + 1
    s1 = block(frames, grid, v["hidden_size"], ch) + (c["depth"] - 1) * block(frames, grid, ch, ch)
    s2 = c["depth"] * block(td, gd, ch, ch)
    px2 = td * gd * gd
    readout = 2 * px2 * (ch * out_width + (c["mlp_depth"] - 1) * out_width ** 2)
    return s1 + 2 * px2 * 8 * ch * ch + s2 + readout


def _projections(t: dict) -> list[tuple[str, int, int]]:
    e, hd = t["hidden_size"], t["head_dim"]
    q, kv, i = t["num_attention_heads"] * hd, t["num_key_value_heads"] * hd, t["intermediate_size"]
    return [("q", e, q), ("k", e, kv), ("v", e, kv), ("o", q, e), ("gate", e, i), ("up", e, i), ("down", i, e)]


def decoder_clip_flops(t: dict, s: int, lora: dict | None, backward: bool) -> float:
    """The decoder on one sequence of ``s`` tokens: the forward, and with
    ``backward`` (LoRA training) the gradients the adapters need."""
    r = int(lora["r"]) if lora else 0
    attn = 2 * 2 * t["num_attention_heads"] * t["head_dim"] * causal_pairs(s)
    total = 0.0
    for layer in range(t["num_hidden_layers"]):
        for name, n_in, n_out in _projections(t):
            total += 2 * s * n_in * n_out + (2 * s * r * (n_in + n_out) if r else 0)
            if backward:
                upstream = not (layer == 0 and name in ("q", "k", "v"))
                total += 2 * s * n_in * n_out if upstream else 0              # dx through the base
                total += 2 * s * r * n_out * 2 + 2 * s * n_in * r             # dB, dz, dA
                total += 2 * s * r * n_in if upstream else 0                  # dx through A
        total += attn * (3 if backward else 1)                                # bwd: four products
    return total


def head_clip_flops(e: int, p: int, s: int) -> float:
    """The head on one row, forward and backward: the HRF pooling over the
    sequence and the ridge product, their weight and input gradients."""
    return 2 * s * e + 2 * e * p + 2 * e * p + 2 * e * p + 2 * s * e


def step_flops(model: dict, batch: int, seq: int, frames: int) -> float:
    """The operations one training step of ``batch`` clips needs."""
    t, v, c = model["text"], model["vision"], model["connector"]
    lora = model.get("lora") if model["trainable"] == "lora+head" else None
    per_clip = (frames * clip_frame_flops(v) + stc_clip_flops(c, v, t["hidden_size"], frames)
                + decoder_clip_flops(t, seq, lora, backward=lora is not None)
                + head_clip_flops(t["hidden_size"], model["head"]["num_target"], seq))
    return batch * per_clip


def flash_fwd_cost(b: int, s: int, hq: int, hkv: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one causal flash forward: q, k, v and the
    (B, S) f32 key bias read, out and the (B, Hq, S) f32 lse written."""
    flops = 2 * 2 * b * hq * d * causal_pairs(s)
    nbytes = 2 * b * s * d * (2 * hq + 2 * hkv) + 4 * b * hq * s + 4 * b * s
    return flops, nbytes


def flash_bwd_cost(b: int, s: int, hq: int, hkv: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one causal flash backward: q, k, v, out, dout,
    lse and the key bias read, dq, dk, dv written; five products."""
    flops = 5 * 2 * b * hq * d * causal_pairs(s)
    nbytes = 2 * b * s * d * (3 * hq + 2 * hkv) + 4 * b * hq * s + 4 * b * s + 2 * b * s * d * (hq + 2 * hkv)
    return flops, nbytes
