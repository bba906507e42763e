"""Port parity: the vision-token cache (``data/token_cache.py``) against the JAX package.

Lazy-load files from the JAX package's own stages; the tiny LoRA VLB in f32
on the CPU, the port's weights carried from the JAX model's by
``from_flax_params``. Tolerances:
- the tokens: each within one bf16 ulp of JAX's (the two towers' f32
  tokens differ in their last bits, which can move a value across a bf16
  rounding boundary); the sidecar's layout exact (``tokens`` (N, V, E)
  uint16 chunked (1, V, E), ``fingerprint``);
- each package's ``TokenCachedDataset`` reads the other's sidecar bit for
  bit;
- the forward from cached tokens: bit-equal to the forward from the same
  frames' ``encode_video`` tokens rounded to bf16, and within 5e-2 of the
  forward from the frames (the JAX test's bound for that one rounding).
"""

import os
import shutil

import h5py
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.data.lazyload_build import LazyloadBuildConfig, build_lazyload_dsets
from phantom_vlb_tpu.data import token_cache as jtc
from phantom_vlb_tpu.data.loader import LazyDataset as JLazyDataset
from phantom_vlb_tpu.data.synthetic import TEST_GEOMETRY, write_synthetic_bold_file, write_synthetic_features_file
from phantom_vlb_tpu.models.videollama2 import VideoLLaMA2VLB as JVLB
from phantom_vlb_tpu.models.videollama2 import VLBConfig as JVLBConfig
from phantom_vlb_tpu_torch.data import token_cache as ttc
from phantom_vlb_tpu_torch.data.loader import BatchLoader, LazyDataset
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params

G = TEST_GEOMETRY
BATCH = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_tokcache")
    eps = {"s01e01a": 8, "s01e01b": 7}
    write_synthetic_features_file(root / "f.h5", eps, G, seed=0)
    write_synthetic_bold_file(root / "b.h5", eps, G, seed=1)
    (root / "lazy").mkdir()
    paths = build_lazyload_dsets(LazyloadBuildConfig(
        str(root / "f.h5"), str(root / "b.h5"), str(root / "lazy"), "sub-01", "s1", 1, G))
    jmodel = JVLB(JVLBConfig.tiny(use_lora=True))
    s = JLazyDataset(paths)[0]
    params = jmodel.init(jax.random.key(0), s.language[None], jnp.asarray(s.vision[None], jnp.float32),
                         s.padvals[None], s.vis_weights[None], s.lang_weights[None])["params"]
    port = tv.VideoLLaMA2VLB.from_state_dict(tv.VLBConfig.tiny(use_lora=True), from_flax_params(params))
    jpath = jtc.build_token_cache(jmodel, params, JLazyDataset(paths), root / "jax_tok.h5", batch_size=BATCH)
    tpath = ttc.build_token_cache(port, LazyDataset(paths), root / "port_tok.h5", batch_size=BATCH)
    return dict(root=root, paths=paths, jmodel=jmodel, params=params, port=port, jpath=jpath, tpath=tpath)


def _bf16(bits: np.ndarray) -> np.ndarray:
    return bits.view(ml_dtypes.bfloat16).astype(np.float64)


def test_tokens_match_jax_and_the_layout_is_exact(setup):
    with h5py.File(setup["jpath"], "r") as fj, h5py.File(setup["tpath"], "r") as ft:
        want, got = fj["tokens"], ft["tokens"]
        assert got.shape == want.shape == (len(LazyDataset(setup["paths"])), G.num_vis_tokens, 64)
        assert got.dtype == want.dtype == np.uint16 and got.chunks == want.chunks == (1, G.num_vis_tokens, 64)
        assert isinstance(ft.attrs["fingerprint"], str) and len(ft.attrs["fingerprint"]) == 16
        assert list(ft) == list(fj) == ["tokens"]
        a, b = _bf16(got[...]), _bf16(want[...])
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)
    assert (np.abs(a - b) <= ulp).all()
    assert np.mean(a != b) < 0.01


def test_each_package_reads_the_others_sidecar(setup):
    tds, jds = LazyDataset(setup["paths"]), JLazyDataset(setup["paths"])
    for reader, base, path, other in ((ttc.TokenCachedDataset, tds, setup["jpath"], jds),
                                      (jtc.TokenCachedDataset, jds, setup["tpath"], tds)):
        view = reader(base, path)
        with h5py.File(path, "r") as f:
            bits = f["tokens"][...]
        assert len(view) == len(base)
        for i in (0, 5, len(base) - 1):
            got = view[i].vision
            got_bits = got.view(torch.int16).numpy().view(np.uint16) if isinstance(got, torch.Tensor) \
                else got.view(np.uint16)
            np.testing.assert_array_equal(got_bits, bits[i])
            for field in ("language", "timeseries", "vis_weights", "lang_weights", "padvals"):
                np.testing.assert_array_equal(np.asarray(getattr(view[i], field)), getattr(other[i], field))
    assert ttc.TokenCachedDataset(tds, setup["jpath"])[0].vision.dtype == torch.bfloat16


def test_fingerprint_keys_the_same_files_as_jax(setup):
    """The sidecar's name comes from the weight-free fingerprint, which the
    two packages compute alike, so they look for the same file."""
    tds, jds = LazyDataset(setup["paths"]), JLazyDataset(setup["paths"])
    assert ttc.dataset_fingerprint(tds, 0, 0) == jtc.dataset_fingerprint(jds, 0, 0)
    assert ttc.dataset_fingerprint(tds, 4, 8, "w") == jtc.dataset_fingerprint(jds, 4, 8, "w")


def test_stale_weights_rebuild(setup, tmp_path):
    port, ds = setup["port"], LazyDataset(setup["paths"])
    path = ttc.build_token_cache(port, ds, tmp_path / "tok.h5", batch_size=BATCH)
    before = ttc.TokenCachedDataset(ds, path)[0].vision.clone()
    mtime = path.stat().st_mtime_ns
    assert ttc.build_token_cache(port, ds, path, batch_size=BATCH) == path
    assert path.stat().st_mtime_ns == mtime                        # a match is kept as it is

    bumped = tv.VideoLLaMA2VLB.from_state_dict(port.cfg, {
        k: t + 0.01 if k.startswith("vision_tower.") else t for k, t in port.state_dict().items()})
    assert ttc.weights_digest(bumped.state_dict()) != ttc.weights_digest(port.state_dict())
    assert ttc.build_token_cache(bumped, ds, path, batch_size=BATCH) == path
    after = ttc.TokenCachedDataset(ds, path)[0].vision
    assert not torch.equal(before.view(torch.int16), after.view(torch.int16))
    assert not (tmp_path / "tok.building").exists()


def test_mtime_preserving_regeneration_rebuilds(setup, tmp_path):
    copies = []
    for p in setup["paths"]:
        dst = tmp_path / os.path.basename(p)
        shutil.copy2(p, dst)                                        # size and mtime kept
        copies.append(str(dst))
    port = setup["port"]
    path = ttc.build_token_cache(port, LazyDataset(copies), tmp_path / "tok.h5", batch_size=BATCH)
    fp = ttc.dataset_fingerprint(LazyDataset(copies), 4, 8)
    with h5py.File(path, "r") as f:
        sidecar_fp, last_before = f.attrs["fingerprint"], f["tokens"][-1]

    st = os.stat(copies[-1])
    with h5py.File(copies[-1], "r+") as f:
        last = int(f["dset_len"][0]) - 1
        d = f[f"{last}/{last}_vision"]
        d[...] = d[...] + 1.0                                        # same shape, other values
    os.utime(copies[-1], ns=(st.st_atime_ns, st.st_mtime_ns))
    assert os.stat(copies[-1]).st_mtime_ns == st.st_mtime_ns
    assert ttc.dataset_fingerprint(LazyDataset(copies), 4, 8) != fp

    ttc.build_token_cache(port, LazyDataset(copies), path, batch_size=BATCH)
    with h5py.File(path, "r") as f:
        assert f.attrs["fingerprint"] != sidecar_fp
        assert not np.array_equal(f["tokens"][-1], last_before)


def test_forward_from_tokens_equals_forward_from_pixels(setup, tmp_path):
    port = setup["port"]
    pixel_loader = BatchLoader(LazyDataset(setup["paths"]), batch_size=BATCH, shuffle=False, prefetch=0)
    token_loader = BatchLoader(LazyDataset(setup["paths"]), batch_size=BATCH, shuffle=False, prefetch=2,
                               num_threads=2)
    ttc.attach_token_cache(port, [token_loader], tmp_path, batch_size=BATCH)
    assert isinstance(token_loader.dataset, ttc.TokenCachedDataset)
    (sidecar,) = tmp_path.glob("vision_tokens_*.h5")
    bp, bt = next(iter(pixel_loader)), next(iter(token_loader))
    assert bt.vision.shape == (BATCH, G.num_vis_tokens, 64) and bt.vision.dtype == torch.bfloat16

    def fwd(vision):
        with torch.no_grad():
            pred, _ = port(torch.from_numpy(bp.language), vision, *(torch.from_numpy(a) for a in (
                bp.padvals, bp.vis_weights, bp.lang_weights)))
        return pred.numpy()

    tokens = port.encode_video(torch.from_numpy(bp.vision)).to(torch.bfloat16)
    assert torch.equal(bt.vision.view(torch.int16), tokens.view(torch.int16))
    np.testing.assert_array_equal(fwd(bt.vision), fwd(tokens))
    np.testing.assert_allclose(fwd(bt.vision), fwd(torch.from_numpy(bp.vision)), atol=5e-2, rtol=5e-2)
    # A partial last batch repeats its last clip's tokens.
    last = list(token_loader)[-1]
    assert torch.equal(last.vision[-1], last.vision[int(last.row_mask.sum()) - 1])
    assert sidecar.name == f"vision_tokens_{jtc.dataset_fingerprint(JLazyDataset(setup['paths']), 0, 0)[:8]}.h5"


def test_encode_tokens_into_an_array(setup):
    """Any indexable of samples, into any array: the sweep the sidecar's
    builder runs, and the view over an array."""
    port, ds = setup["port"], LazyDataset(setup["paths"])
    samples = [ds[i] for i in range(4)]
    out = np.zeros((4, G.num_vis_tokens, 64), np.uint16)
    ttc.encode_tokens(port, samples, out, batch_size=BATCH)
    with h5py.File(setup["tpath"], "r") as f:
        np.testing.assert_array_equal(out[:3], f["tokens"][:3])     # the same batch of 3
    view = ttc.TokenCachedDataset(samples, out)
    np.testing.assert_array_equal(view[3].vision.view(torch.int16).numpy().view(np.uint16), out[3])
    np.testing.assert_array_equal(view[3].timeseries, samples[3].timeseries)


def test_trainer_cli_with_the_token_cache(setup, tmp_path):
    """``vlb-train-torch ... datamodule.vision_token_cache=DIR`` builds one
    sidecar per split (``$VARS`` expanded) and trains from it."""
    from phantom_vlb_tpu_torch.cli.train import main

    root = setup["root"]
    (tmp_path / "lazy").mkdir()
    build_lazyload_dsets(LazyloadBuildConfig(str(root / "f.h5"), str(root / "b.h5"), str(tmp_path / "lazy"),
                                             "sub-01", "s1", 2, G))
    pattern = str(tmp_path / "lazy" / "friends_llFile_sub-01_s*_n*.h5")
    os.environ["PORT_TOKEN_CACHE_ROOT"] = str(tmp_path)
    try:
        assert main(["experiment=vlb_friends_lora", "subject=sub-01", f"datamodule.lazyload_path={pattern}",
                     "datamodule.seasons=[s1]", "datamodule.batch_size=4", "model.preset=tiny",
                     "model.lora_r=4", "model.lora_alpha=8", "model.lora_dropout=0.0",
                     "trainer.max_epochs=1", "trainer.log_every_n_steps=2", "optim.t_max=100",
                     f"output_dir={tmp_path / 'out'}", "run_name=tok", "mesh.fsdp=1",
                     "datamodule.vision_token_cache=$PORT_TOKEN_CACHE_ROOT/tok", "--device", "cpu"]) == 0
    finally:
        del os.environ["PORT_TOKEN_CACHE_ROOT"]
    assert len(list((tmp_path / "tok").glob("vision_tokens_*.h5"))) == 2    # train and val
    assert (tmp_path / "out" / "last" / "state.pt").exists()
