"""Port: ``vlb-predict-torch`` and ``vlb-brainmaps-torch`` after a
``vlb-train-torch`` run on the CPU, against the JAX package.

The lazy-load files come from the JAX package's stages; the port's trainer
runs ``tests/test_torch_cli_train.py``'s arguments (tiny LoRA VLB, 1
epoch). Then:
- ``vlb-predict-torch predict.checkpoint=<last>`` writes ``predicted``,
  ``actual`` (valid rows, P) and ``val_corr_roi`` (P,), f32; its per-ROI r
  is the validation row of ``metrics.csv`` at the step ``last`` holds (the
  same weights and batches: within 1e-6, the CSV's text holds the values
  whole);
- on the weights the JAX builder makes (carried by ``from_flax_params``)
  the port's file against JAX's ``run_predict``'s: predictions and targets
  within 1e-4 of their largest magnitude, r within 1e-4 (f32 forwards
  summed in another order, JAX's over its 8-device CPU mesh; the bound of
  ``tests/test_torch_vision_vlb.py``);
- a checkpoint with a stray or a missing tensor raises by name;
- ``vlb-brainmaps-torch`` over the port's ``metrics.csv`` writes the files
  JAX's ``vlb-brainmaps`` writes, with volumes within one f32 ulp of JAX's
  (pandas' default float parser reads an r up to 2^-53 from ``float()``).
"""

import glob
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.data.synthetic import TEST_GEOMETRY, write_synthetic_bold_file, write_synthetic_features_file
from phantom_vlb_tpu_torch.cli.predict import main as predict_main
from phantom_vlb_tpu_torch.train.checkpoint import STATE_FILE

G = TEST_GEOMETRY
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _args(pattern, out, run_name="e2e"):
    return [
        "experiment=vlb_friends_lora", "subject=sub-01",
        f"datamodule.lazyload_path={pattern}", "datamodule.seasons=[s1]",
        "datamodule.batch_size=4", "datamodule.num_workers=2",
        "model.preset=tiny", "model.lora_r=4", "model.lora_alpha=8", "model.lora_dropout=0.0",
        "trainer.max_epochs=1", "trainer.val_check_interval=0.5", "trainer.log_every_n_steps=2",
        "optim.t_max=100", f"output_dir={out}", f"run_name={run_name}", "mesh.fsdp=1",
    ]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from phantom_vlb_tpu.cli.build_lazyload import main as build_lazyload
    from phantom_vlb_tpu_torch.cli.train import main as train_main

    root = tmp_path_factory.mktemp("port_predict")
    eps = {"s01e01a": 9, "s01e01b": 8, "s01e02a": 8}
    write_synthetic_features_file(root / "features_s1.h5", eps, G, seed=0)
    write_synthetic_bold_file(root / "bold.h5", eps, G, seed=1)
    (root / "lazy").mkdir()
    assert build_lazyload([
        "--features_path", str(root / "features_s1.h5"), "--timeseries_path", str(root / "bold.h5"),
        "--lazyload_path", str(root / "lazy"), "--subject", "sub-01", "--season", "s1",
        "--n_split", "2", "--window", str(G.window), "--delay", str(G.delay)]) == 0
    pattern = str(root / "lazy" / "friends_llFile_sub-01_s*_n*.h5")
    assert train_main([*_args(pattern, root / "results"), "--device", "cpu"]) == 0
    return root, pattern


def _read(path):
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["actual", "predicted", "val_corr_roi"]
        return {k: f[k][...] for k in f}


def test_predict_cli_restores_last(trained, capsys):
    root, pattern = trained
    out = root / "preds.h5"
    assert predict_main([*_args(pattern, root / "results", "e2e_pred"),
                         f"predict.checkpoint={root / 'results' / 'last'}", f"predict.out={out}",
                         "--device", "cpu"]) == 0
    got = _read(out)
    assert got["predicted"].shape == got["actual"].shape == (6, G.num_parcels)    # the val file's rows
    assert got["val_corr_roi"].shape == (G.num_parcels,)
    assert all(a.dtype == np.float32 for a in got.values())
    assert f"wrote {out}: 6 samples, corr_avg=" in capsys.readouterr().out

    import csv

    step = torch.load(root / "results" / "last" / STATE_FILE, weights_only=True)["step"]
    (path,) = glob.glob(str(root / "results" / "e2e" / "*" / "metrics.csv"))
    with open(path, newline="") as f:
        (row,) = [r for r in csv.DictReader(f) if r["val/brain_loss"] and int(r["step"]) == step]
    want = np.array([float(row[f"val_corr_ROI_{i:06d}"]) for i in range(G.num_parcels)])
    np.testing.assert_allclose(got["val_corr_roi"], want, atol=1e-6, rtol=0)


def test_predict_matches_jax_on_the_same_weights(trained, tmp_path, monkeypatch):
    from phantom_vlb_tpu.cli.predict import run_predict as jrun
    from phantom_vlb_tpu.core.config import load_config as jload
    from phantom_vlb_tpu.train import builder as jbuilder
    from phantom_vlb_tpu_torch.cli.predict import run_predict
    from phantom_vlb_tpu_torch.core.config import load_config
    from phantom_vlb_tpu_torch.models.convert import from_flax_params
    from phantom_vlb_tpu_torch.train import builder as tbuilder

    _, pattern = trained
    # The JAX builder lays the model over the 8-device CPU mesh, as its e2e test does.
    args = [*_args(pattern, tmp_path / "jax", "jax_pred"), f"predict.out={tmp_path / 'jax.h5'}",
            "mesh.fsdp=4", "mesh.tensor=2"]
    jconfig = jload(str(CONFIGS), "base", args)
    jrun(jconfig)
    jmodel = jbuilder.VideoLLaMA2VLB(jbuilder.build_model_config(jconfig.model))
    params = jbuilder.init_model_params(jmodel, G, jmodel.config.mistral.vocab_size, int(jconfig.random_state))
    sd = from_flax_params(params)
    monkeypatch.setattr(tbuilder, "init_params", lambda cfg, device, generator: dict(sd))
    targs = [*_args(pattern, tmp_path / "port", "port_pred"), f"predict.out={tmp_path / 'port.h5'}"]
    result = run_predict(load_config(CONFIGS, "base", targs), "cpu")
    got, want = _read(tmp_path / "port.h5"), _read(tmp_path / "jax.h5")
    assert result == {"out": str(tmp_path / "port.h5"), "n_samples": 6,
                      "corr_avg": pytest.approx(float(np.nanmean(got["val_corr_roi"])))}
    for key in ("predicted", "actual"):
        assert got[key].shape == want[key].shape
        assert np.abs(got[key] - want[key]).max() <= 1e-4 * np.abs(want[key]).max(), key
    np.testing.assert_allclose(got["val_corr_roi"], want["val_corr_roi"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("change", ["stray", "missing"])
def test_a_checkpoint_with_other_tensors_raises(trained, tmp_path, change):
    root, pattern = trained
    state = torch.load(root / "results" / "last" / STATE_FILE, weights_only=True)
    if change == "stray":
        state["params"]["head.extra"] = torch.zeros(1)
    else:
        state["params"].pop(sorted(state["params"])[0])
    (tmp_path / "ckpt").mkdir()
    torch.save(state, tmp_path / "ckpt" / STATE_FILE)
    with pytest.raises(ValueError, match="holds other tensors than the trainable ones"):
        predict_main([*_args(pattern, tmp_path / "out"), f"predict.checkpoint={tmp_path / 'ckpt'}",
                      f"predict.out={tmp_path / 'p.h5'}", "--device", "cpu"])


def test_predict_defaults_to_the_card(trained, tmp_path, monkeypatch):
    _, pattern = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict_main([*_args(pattern, tmp_path / "out"), f"predict.out={tmp_path / 'p.h5'}"])


def test_brainmaps_cli_over_the_port_run_matches_jax(trained, tmp_path):
    from phantom_vlb_tpu.cli.brainmaps import main as jmain
    from phantom_vlb_tpu_torch.cli.brainmaps import main as tmain
    from phantom_vlb_tpu_torch.postprocessing.nifti import NiftiImage, load_nifti, save_nifti

    root, _ = trained
    atlas = np.zeros((6, 6, 4), np.int32)
    for i in range(G.num_parcels):
        atlas[i % 6, (i * 2) % 6, i % 4] = i + 1
    save_nifti(NiftiImage(atlas, np.eye(4)), tmp_path / "atlas.nii.gz")
    (csv_path,) = glob.glob(str(root / "results" / "e2e" / "*" / "metrics.csv"))
    common = ["--metrics_path", str(Path(csv_path).parent), "--atlas_path", str(tmp_path / "atlas.nii.gz"),
              "--export_nii", "True"]
    assert tmain([*common, "--out_path", str(tmp_path / "port")]) == 0
    assert jmain([*common, "--out_path", str(tmp_path / "jax")]) == 0
    port_maps = sorted(Path(p).name[len("port"):] for p in glob.glob(str(tmp_path / "port_val-*")))
    jax_maps = sorted(Path(p).name[len("jax"):] for p in glob.glob(str(tmp_path / "jax_val-*")))
    assert port_maps == jax_maps and len(port_maps) == 2 * 2                 # 2 val rows: html + nii
    for name in port_maps:
        if name.endswith(".nii.gz"):
            got, want = load_nifti(tmp_path / f"port{name}"), load_nifti(tmp_path / f"jax{name}")
            np.testing.assert_array_max_ulp(got.data, want.data, maxulp=1)
            np.testing.assert_array_equal(got.affine, want.affine)
