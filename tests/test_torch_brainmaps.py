"""Port: NIfTI I/O and the brain maps (``postprocessing/``), mirroring
``tests/test_brainmaps.py`` and held to the JAX package.

The port reads ``metrics.csv`` with the standard library's ``csv`` where
the JAX package uses pandas. pandas' default float parser is not correctly
rounded: it reads a value in [-1, 1] up to 2^-53 away from ``float()``
(one f64 ulp at 1), so the r² values are compared within 2^-52 absolute
(|x² - y²| = |x - y| |x + y|) and the f32 volumes within one f32 ulp;
everything else is exact.
"""

import base64
import re

import numpy as np
import pandas as pd
import pytest

from phantom_vlb_tpu.postprocessing import brainmaps as jbm
from phantom_vlb_tpu.postprocessing import nifti as jnifti
from phantom_vlb_tpu_torch.postprocessing.brainmaps import (
    BrainmapConfig,
    _interactive_html,
    labels_inverse_transform,
    make_brainmaps,
    read_val_r2,
)
from phantom_vlb_tpu_torch.postprocessing.nifti import NiftiImage, load_nifti, save_nifti


def test_nifti_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((7, 9, 5)).astype(np.float32)
    affine = np.diag([2.0, 2.0, 2.0, 1.0])
    affine[:3, 3] = [-10, -20, -5]
    save_nifti(NiftiImage(data, affine), tmp_path / "x.nii.gz")
    img = load_nifti(tmp_path / "x.nii.gz")
    np.testing.assert_allclose(img.data, data, atol=0)
    np.testing.assert_allclose(img.affine, affine, atol=1e-6)


def test_nifti_int_atlas_roundtrip(tmp_path):
    atlas = np.zeros((6, 6, 4), np.int32)
    atlas[1:3, 1:3, 1:3] = 5
    atlas[4, 4, 2] = 9
    save_nifti(NiftiImage(atlas, np.eye(4)), tmp_path / "atlas.nii")
    img = load_nifti(tmp_path / "atlas.nii")
    np.testing.assert_array_equal(img.data, atlas)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nifti_files_are_byte_equal_and_read_across(tmp_path, writer):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((5, 4, 3)).astype(np.float32)
    affine = np.diag([1.5, 2.0, 2.5, 1.0])
    save_nifti(NiftiImage(data, affine), tmp_path / "port.nii.gz")
    jnifti.save_nifti(jnifti.NiftiImage(data, affine), tmp_path / "jax.nii.gz")
    import gzip

    assert gzip.open(tmp_path / "port.nii.gz").read() == gzip.open(tmp_path / "jax.nii.gz").read()
    read = load_nifti if writer == "jax" else jnifti.load_nifti
    img = read(tmp_path / f"{'port' if writer == 'port' else 'jax'}.nii.gz")
    np.testing.assert_array_equal(img.data, data)


def test_labels_inverse_transform():
    atlas = np.zeros((4, 4, 2), np.int32)
    atlas[0, 0, 0] = 3   # first nonzero label
    atlas[1, 1, 1] = 10  # second
    out = labels_inverse_transform(atlas, np.array([0.5, 0.8]))
    assert out[0, 0, 0] == np.float32(0.5)
    assert out[1, 1, 1] == np.float32(0.8)
    assert out.sum() == np.float32(1.3)


def test_labels_mismatch_raises():
    atlas = np.ones((2, 2, 2), np.int32)
    with pytest.raises(ValueError):
        labels_inverse_transform(atlas, np.array([1.0, 2.0]))


def _metrics_dir(tmp_path, rows=None, atlas=None, affine=np.eye(4)):
    """An atlas (8 labels by default) and a metrics.csv in the trainer's layout."""
    n_roi = 8
    if atlas is None:
        atlas = np.zeros((8, 8, 6), np.int32)
        for i in range(n_roi):
            atlas[i, i, i % 6] = i + 1
    save_nifti(NiftiImage(atlas, affine), tmp_path / "atlas.nii.gz")
    if rows is None:
        rows = [{"epoch": 0, "step": 10, "train/brain_loss": 1.0}]
        for e in range(2):
            row = {"epoch": e, "step": 20 + e, "val/brain_loss": 0.5 - 0.1 * e}
            for i in range(n_roi):
                row[f"val_corr_ROI_{i:06d}"] = 0.1 * i * (e + 1)
            row["val_corr_avg"] = 0.3
            rows.append(row)
    pd.DataFrame(rows).to_csv(tmp_path / "metrics.csv", index=False)
    return BrainmapConfig(metrics_path=str(tmp_path), atlas_path=str(tmp_path / "atlas.nii.gz"),
                          out_path=str(tmp_path / "map"), export_nii=True)


def test_make_brainmaps_end_to_end(tmp_path):
    written = make_brainmaps(_metrics_dir(tmp_path))
    assert len(written) == 2  # one per val row; train rows skipped
    for f in written:
        assert "<html" in open(f).read()[:200].lower()
    # nii export: voxel for ROI 3 in epoch 1 = (0.1*3*2)^2.
    img = load_nifti(tmp_path / "map_val-1.nii.gz")
    np.testing.assert_allclose(img.data[3, 3, 3], (0.6) ** 2, rtol=1e-5)


def test_interactive_viewer_payload():
    """The view_img-style HTML embeds a decodable, value-faithful volume."""
    atlas = np.zeros((5, 6, 4), np.int32)
    atlas[1, 2, 3] = 7
    atlas[2, 3, 1] = 9
    volume = np.zeros((5, 6, 4), np.float32)
    volume[1, 2, 3] = 0.64   # r^2 value
    volume[2, 3, 1] = -0.5
    html = _interactive_html(volume, atlas, np.diag([2.0, 2.0, 3.0, 1.0]), 1.0, "test map")
    for n in ("ax", "co", "sa"):
        assert f"cv_{n}" in html and f"sl_{n}" in html
    assert "cbar" in html and "test map" in html
    assert html == jbm._interactive_html(volume, atlas, np.diag([2.0, 2.0, 3.0, 1.0]), 1.0, "test map")

    vol_b64 = re.search(r'VOL_B64 = "([^"]*)"', html).group(1)
    q = np.frombuffer(base64.b64decode(vol_b64), np.uint8).reshape(volume.shape, order="F")
    assert q[0, 0, 0] == 128
    assert abs((int(q[1, 2, 3]) - 128) / 127.0 - 0.64) < 1 / 127
    assert abs((int(q[2, 3, 1]) - 128) / 127.0 + 0.5) < 1 / 127
    under_b64 = re.search(r'UNDER_B64 = "([^"]*)"', html).group(1)
    u = np.frombuffer(base64.b64decode(under_b64), np.uint8).reshape(volume.shape, order="F")
    assert u[0, 0, 0] == 0 and u[1, 2, 3] > 0


def test_read_val_r2_selects_as_pandas_does(tmp_path):
    """Rows with a missing val/brain_loss (empty, "nan", "NA") are skipped,
    the ROI columns are taken in sorted order, missing cells read as NaN."""
    rng = np.random.default_rng(4)
    path = tmp_path / "metrics.csv"
    header = ["epoch", "step", "val/brain_loss", "val_corr_ROI_000002", "val_corr_ROI_000000",
              "val_corr_ROI_000001", "train/brain_loss"]
    lines = [",".join(header)]
    for i, loss in enumerate(["0.5", "", "nan", "0.25", "NA", "0.125"]):
        cells = [repr(float(x)) for x in rng.uniform(-1, 1, 3)]
        if i == 3:
            cells[1] = ""
        lines.append(",".join([str(i), str(i * 10), loss, *cells, "" if loss else "1.0"]))
    path.write_text("\n".join(lines) + "\n")
    got = read_val_r2(path)
    df = pd.read_csv(path)
    val = df[df["val/brain_loss"].notna()]
    want = val[sorted(c for c in val.columns if "ROI" in c)].to_numpy() ** 2
    assert got.shape == want.shape == (3, 3)
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.isnan(got).sum() == 1
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), rtol=0, atol=2.0 ** -52)


def test_volumes_match_jax(tmp_path):
    """Both packages' make_brainmaps on one metrics.csv and atlas: the same
    files, volumes within one f32 ulp."""
    rng = np.random.default_rng(5)
    n_roi = 40
    rows = []
    for e in range(3):
        rows.append({"epoch": e, "step": 10 * e + 5, "train/brain_loss": float(rng.uniform())})
        row = {"epoch": e, "step": 10 * e + 10, "val/brain_loss": float(rng.uniform())}
        row.update({f"val_corr_ROI_{i:06d}": float(rng.uniform(-1, 1)) for i in range(n_roi)})
        rows.append(row)
    atlas = rng.integers(0, n_roi + 1, (10, 9, 8)).astype(np.int32)
    atlas.flat[:n_roi] = np.arange(1, n_roi + 1)               # every label present
    cfg = _metrics_dir(tmp_path, rows, atlas, np.diag([2.0, 2.0, 2.0, 1.0]))
    got = make_brainmaps(cfg)
    want = jbm.make_brainmaps(jbm.BrainmapConfig(cfg.metrics_path, cfg.atlas_path,
                                                  str(tmp_path / "jax"), export_nii=True))
    assert len(got) == len(want) == 3
    for i in range(3):
        a = load_nifti(tmp_path / f"map_val-{i}.nii.gz").data
        b = load_nifti(tmp_path / f"jax_val-{i}.nii.gz").data
        np.testing.assert_array_max_ulp(a, b, maxulp=1)
        labels = np.unique(atlas)[1:]
        r2 = np.array([rows[2 * i + 1][f"val_corr_ROI_{k:06d}"] for k in range(n_roi)]) ** 2
        for k, label in enumerate(labels):
            assert (a[atlas == label] == np.float32(r2[k])).all()
