"""Port parity: HF-keyed safetensors weights through ``load_pretrained_params``.

A tiny VideoLLaMA2-keyed checkpoint (decoder, CLIP tower and STC connector,
``tests/test_pretrained_loading.py``'s ``_make_checkpoint``) is written
with the ``safetensors`` package in f32 and in bf16. The JAX package's
``load_pretrained_params`` merges it into its initialised tree; the port's
reads it with its own reader into the state dict ``from_flax_params`` makes
of that same tree. Predictions from frames agree within 1e-4 of max|ref|
in f32 (and from the bf16 file, whose values both sides widen exactly),
and within the decoder's and tower's QUANT_TOL of ``tests/test_torch_clip.py``
under ``base_quant`` (both quantize the converted f32 weight per output
channel). A stray ``mm_projector`` key raises in both. The reader itself:
every dtype it takes, unaligned offsets, and what it refuses.
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import save_file as save_torch

from phantom_vlb_tpu.models.videollama2 import VideoLLaMA2VLB as JVLB
from phantom_vlb_tpu.train.builder import load_pretrained_params as jload
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import SafetensorsDir, from_flax_params
from phantom_vlb_tpu_torch.train.builder import load_pretrained_params as tload
from test_pretrained_loading import _make_checkpoint, _tiny_cfg
from test_torch_clip import QUANT_TOL

from __graft_entry__ import _example_batch


ARGS = ("language", "vision", "padvals", "vis_weights", "lang_weights")


def _init(jcfg):
    """(JAX model, seeded params of its tree's shapes and dtypes: the values
    the checkpoint does not replace, such as the head, come from here)."""
    jmodel = JVLB(jcfg)
    batch = _example_batch(jcfg.geometry, 1, jcfg.mistral.vocab_size)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *(batch[k] for k in ARGS))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype), shapes)
    return jmodel, params


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{'f32': dir, 'bf16': dir} holding the same tiny checkpoint."""
    root = tmp_path_factory.mktemp("hf")
    (root / "f32").mkdir()
    (root / "bf16").mkdir()
    sd = _make_checkpoint(root / "f32", _tiny_cfg(scan=False))
    save_torch({k: torch.from_numpy(v).bfloat16() for k, v in sd.items()},
               root / "bf16" / "model-00001-of-00001.safetensors")
    return {"f32": root / "f32", "bf16": root / "bf16"}


def _configs(mode):
    jcfg = _tiny_cfg(scan=False)
    jcfg = dataclasses.replace(jcfg, mistral=dataclasses.replace(jcfg.mistral, base_quant=mode),
                               clip=dataclasses.replace(jcfg.clip, base_quant=mode))
    return jcfg, tv.VLBConfig.tiny(base_quant=mode)


@pytest.mark.parametrize("mode,dtype", [(None, "f32"), (None, "bf16"), ("int8", "f32"),
                                        ("w8a8g8", "f32"), ("w8a8g8", "bf16")])
def test_predictions_match_jax(checkpoints, mode, dtype):
    jcfg, tcfg = _configs(mode)
    jmodel, params = _init(jcfg)
    loaded = jload(jcfg, str(checkpoints[dtype]), params)
    batch = _example_batch(jcfg.geometry, 2, jcfg.mistral.vocab_size)
    want, _ = jax.jit(jmodel.apply)({"params": jax.tree.map(jnp.asarray, loaded)},
                                    *(batch[k] for k in ARGS))

    sd = tload(tcfg, checkpoints[dtype], from_flax_params(jax.tree.map(np.asarray, params)))
    assert sd.keys() == from_flax_params(jax.tree.map(np.asarray, loaded)).keys()
    model = tv.VideoLLaMA2VLB.from_state_dict(tcfg, sd, device="cpu")
    with torch.no_grad():
        got, _ = model(*(torch.tensor(np.asarray(batch[k])) for k in ARGS))
    assert _rel(got.numpy(), want) <= QUANT_TOL[mode], _rel(got.numpy(), want)
    # What the checkpoint does not hold keeps its value: the head.
    head = "head.ridge.linear.weight"
    assert torch.equal(sd[head], from_flax_params(jax.tree.map(np.asarray, params))[head])


def test_stray_connector_key_raises_in_both(checkpoints, tmp_path):
    sd = dict(SafetensorsDir(checkpoints["f32"]))
    sd["model.mm_projector.s1.b1.conv1.bn.running_mean"] = torch.zeros(96)
    save_torch(sd, tmp_path / "model.safetensors")
    jcfg, tcfg = _configs(None)
    _, params = _init(jcfg)
    with pytest.raises(ValueError, match="mm_projector"):
        jload(jcfg, str(tmp_path), params)
    with pytest.raises(ValueError, match="mm_projector"):
        tload(tcfg, tmp_path, from_flax_params(jax.tree.map(np.asarray, params)))


def test_unported_or_broken_checkpoints_raise(checkpoints, tmp_path):
    tcfg = tv.VLBConfig.tiny()
    from phantom_vlb_tpu_torch.models.convert import init_params

    params = init_params(tcfg, device="cpu")
    (tmp_path / "orbax" / "d").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="Orbax"):
        tload(tcfg, tmp_path / "orbax", params)
    with pytest.raises(FileNotFoundError):
        tload(tcfg, tmp_path, params)
    sd = dict(SafetensorsDir(checkpoints["f32"]))
    del sd["model.layers.1.mlp.up_proj.weight"]
    (tmp_path / "missing").mkdir()
    save_torch(sd, tmp_path / "missing" / "model.safetensors")
    with pytest.raises(KeyError, match="up_proj"):
        tload(tcfg, tmp_path / "missing", params)
    wide = tv.VLBConfig.tiny(num_target=8, mistral=dataclasses.replace(tcfg.mistral, vocab_size=999))
    with pytest.raises(ValueError, match="shape"):
        tload(wide, checkpoints["f32"], init_params(wide, device="cpu"))


def test_reader_dtypes_offsets_and_refusals(tmp_path):
    tensors = {"a_bf16": torch.randn(3, 5).bfloat16(), "b_f16": torch.randn(7).half(),
               "c_f32": torch.randn(2, 2, 2), "d_i8": torch.randint(-128, 127, (3,), dtype=torch.int8),
               "e_i32": torch.randint(-9, 9, (4, 1), dtype=torch.int32), "f_empty": torch.zeros(0, 4)}
    save_torch(tensors, tmp_path / "a.safetensors")
    save_numpy({"g_np": np.arange(6, dtype=np.float32).reshape(2, 3)}, tmp_path / "b.safetensors")
    sd = SafetensorsDir(tmp_path)
    assert sorted(sd) == sorted([*tensors, "g_np"])
    for k, t in tensors.items():
        assert sd[k].dtype == t.dtype and torch.equal(sd[k], t), k
    assert torch.equal(sd["g_np"], torch.arange(6.0).reshape(2, 3))
    sd.close()

    # Unaligned: an odd-length int8 tensor ahead of an f32 one, written by hand.
    header = {"x": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "y": {"dtype": "F32", "shape": [2], "data_offsets": [3, 11]}}
    raw = json.dumps(header).encode()
    data = bytes([1, 2, 255]) + np.array([1.5, -2.0], np.float32).tobytes()
    odd = tmp_path / "odd"
    odd.mkdir()
    (odd / "m.safetensors").write_bytes(struct.pack("<Q", len(raw)) + raw + data)
    sd = SafetensorsDir(odd)
    assert sd["x"].tolist() == [1, 2, -1] and sd["y"].tolist() == [1.5, -2.0]
    sd.close()

    header["x"]["dtype"] = "F64"
    raw = json.dumps(header).encode()
    (odd / "m.safetensors").write_bytes(struct.pack("<Q", len(raw)) + raw + data)
    with pytest.raises(ValueError, match="F64"):
        SafetensorsDir(odd)
    header["x"] = {"dtype": "I8", "shape": [4], "data_offsets": [0, 3]}
    raw = json.dumps(header).encode()
    (odd / "m.safetensors").write_bytes(struct.pack("<Q", len(raw)) + raw + data)
    with pytest.raises(ValueError, match="offsets"):
        SafetensorsDir(odd)
