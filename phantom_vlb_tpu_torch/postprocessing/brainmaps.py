"""Accuracy brain maps: per-ROI validation r² projected into atlas volumes.

The port's own copy of ``phantom_vlb_tpu/postprocessing/brainmaps.py``
(the contract of ``make_acc_brainmaps.py:33-67``): read
``{metrics_path}/metrics.csv``, keep the rows whose ``val/brain_loss`` is
present, take the ``*ROI*`` columns in sorted order, square the
correlations, and project them into the atlas volume (value *i* to every
voxel whose label is the atlas's *i*-th nonzero label, nilearn's
``NiftiLabelsMasker.inverse_transform``), writing an HTML viewer per
validation row and optionally a ``.nii.gz``. The CSV is read with the
standard library's ``csv``, where the JAX package uses pandas; the cells
pandas reads as missing read as NaN.

The viewer is interactive (three orthogonal planes with slice sliders and
click-to-navigate crosshairs, a seismic colormap with vmax ``VMAX``, a
colorbar and an underlay drawn from the atlas), self-contained: the volume
is embedded uint8-quantized (256 levels over [-vmax, vmax]) and rendered in
the page. The JAX package's static ``viewer='mosaic'`` (PIL) is not copied.
"""

from __future__ import annotations

import base64
import csv
import dataclasses
from pathlib import Path

import numpy as np

from phantom_vlb_tpu_torch.postprocessing.nifti import NiftiImage, load_nifti, save_nifti

__all__ = ["BrainmapConfig", "labels_inverse_transform", "read_val_r2", "make_brainmaps"]

VMAX = 1.0   # r² colormap range [-VMAX, VMAX]


@dataclasses.dataclass
class BrainmapConfig:
    metrics_path: str       # directory containing metrics.csv
    atlas_path: str         # atlas .nii(.gz): integer labels, 0 = background
    out_path: str           # output prefix
    export_nii: bool = False


def labels_inverse_transform(atlas: np.ndarray, values: np.ndarray) -> np.ndarray:
    """nilearn NiftiLabelsMasker.inverse_transform semantics.

    ``values[i]`` fills voxels whose label equals the i-th *sorted nonzero*
    label of the atlas; background (0) stays 0.
    """
    labels = np.unique(atlas)
    labels = labels[labels != 0]
    if len(values) != len(labels):
        raise ValueError(
            f"{len(values)} values for {len(labels)} atlas labels"
        )
    out = np.zeros(atlas.shape, np.float32)
    # Vectorized: map label -> rank via searchsorted.
    mask = atlas != 0
    ranks = np.searchsorted(labels, atlas[mask])
    out[mask] = np.asarray(values, np.float32)[ranks]
    return out


_VIEWER_JS = r"""
const DIMS = __DIMS__, ASPECT = __ASPECT__, VMAX = __VMAX__;
const vol = Uint8Array.from(atob(VOL_B64), c => c.charCodeAt(0));
const under = Uint8Array.from(atob(UNDER_B64), c => c.charCodeAt(0));
const [NX, NY, NZ] = DIMS;
let cross = [NX >> 1, NY >> 1, NZ >> 1];
function vox(x, y, z) { return x + NX * (y + NY * z); }
function seismic(t) {            // t in [-1, 1] -> [r, g, b]
  const pos = Math.max(0, Math.min(t, 1)), neg = Math.max(0, Math.min(-t, 1));
  const a = Math.abs(Math.max(-1, Math.min(t, 1)));
  return [255 * (1 - neg), 255 * (1 - a), 255 * (1 - pos)];
}
// planes: [axisFixed, axisH, axisW]
const PLANES = { ax: [2, 1, 0], co: [1, 2, 0], sa: [0, 2, 1] };
function drawPlane(name) {
  const [af, ah, aw] = PLANES[name];
  const W = DIMS[aw], H = DIMS[ah], fixed = cross[af];
  const cv = document.getElementById("cv_" + name);
  const ctx = cv.getContext("2d");
  const img = ctx.createImageData(W, H);
  const idx = [0, 0, 0];
  idx[af] = fixed;
  for (let j = 0; j < H; j++) {
    idx[ah] = H - 1 - j;                     // superior up / anterior up
    for (let i = 0; i < W; i++) {
      idx[aw] = i;
      const v = vol[vox(idx[0], idx[1], idx[2])];
      const u = under[vox(idx[0], idx[1], idx[2])];
      let r = u, g = u, b = u;
      if (v !== 128) {                        // 128 encodes exactly 0
        const t = (v - 128) / 127.0;
        [r, g, b] = seismic(t);
      }
      const o = 4 * (j * W + i);
      img.data[o] = r; img.data[o + 1] = g; img.data[o + 2] = b;
      img.data[o + 3] = 255;
    }
  }
  ctx.putImageData(img, 0, 0);
  // crosshair
  ctx.strokeStyle = "rgba(120,220,120,0.8)";
  ctx.beginPath();
  const cx = cross[aw] + 0.5, cy = H - 1 - cross[ah] + 0.5;
  ctx.moveTo(cx, 0); ctx.lineTo(cx, H);
  ctx.moveTo(0, cy); ctx.lineTo(W, cy);
  ctx.stroke();
  document.getElementById("sl_" + name).value = fixed;
  const [x, y, z] = cross;
  document.getElementById("val").textContent =
    "voxel (" + x + "," + y + "," + z + ")  value " +
    ((vol[vox(x, y, z)] - 128) / 127 * VMAX).toFixed(3);
}
function drawAll() { for (const n in PLANES) drawPlane(n); }
function setup(name) {
  const [af, ah, aw] = PLANES[name];
  const cv = document.getElementById("cv_" + name);
  cv.width = DIMS[aw]; cv.height = DIMS[ah];
  cv.style.width = (DIMS[aw] * ASPECT[aw] * 2.2) + "px";
  cv.style.height = (DIMS[ah] * ASPECT[ah] * 2.2) + "px";
  const sl = document.getElementById("sl_" + name);
  sl.max = DIMS[af] - 1; sl.value = cross[af];
  sl.oninput = () => { cross[af] = +sl.value; drawAll(); };
  cv.onclick = (e) => {
    const r = cv.getBoundingClientRect();
    cross[aw] = Math.min(DIMS[aw] - 1, Math.max(0,
      Math.round((e.clientX - r.left) / r.width * DIMS[aw] - 0.5)));
    cross[ah] = Math.min(DIMS[ah] - 1, Math.max(0, DIMS[ah] - 1 -
      Math.round((e.clientY - r.top) / r.height * DIMS[ah] - 0.5)));
    drawAll();
  };
}
for (const n in PLANES) setup(n);
drawAll();
"""


def _interactive_html(
    volume: np.ndarray, atlas: np.ndarray, affine: np.ndarray,
    vmax: float, title: str,
) -> str:
    """nilearn-view_img-style three-plane viewer, fully self-contained."""
    q = np.rint(np.clip(volume / vmax, -1.0, 1.0) * 127).astype(np.int16) + 128
    # Reserve 128 for exactly-zero so background stays underlay-only.
    q[(volume == 0)] = 128
    vol_b64 = base64.b64encode(q.astype(np.uint8).tobytes(order="F")).decode()
    # Anatomical-ish underlay: parcel-textured gray inside the brain.
    under = np.where(atlas != 0, 55 + (atlas % 89) * 0.9, 0).astype(np.uint8)
    under_b64 = base64.b64encode(under.tobytes(order="F")).decode()
    aspect = [float(a) for a in np.abs(np.diag(affine)[:3])]
    aspect = [a / max(aspect) for a in aspect]

    js = (
        _VIEWER_JS
        .replace("__DIMS__", str(list(volume.shape)))
        .replace("__ASPECT__", str(aspect))
        .replace("__VMAX__", repr(float(vmax)))
    )
    grad = (
        "linear-gradient(to right, rgb(0,0,255), rgb(255,255,255), rgb(255,0,0))"
    )
    panes = "".join(
        f"<div class='pane'><div>{label}</div>"
        f"<canvas id='cv_{n}'></canvas><br>"
        f"<input type='range' id='sl_{n}' min='0' value='0'></div>"
        for n, label in (("sa", "sagittal"), ("co", "coronal"), ("ax", "axial"))
    )
    return f"""<!doctype html><html><head><meta charset='utf-8'>
<title>{title}</title><style>
body {{ background:#111; color:#eee; font-family:sans-serif }}
.pane {{ display:inline-block; margin:8px; text-align:center }}
canvas {{ image-rendering:pixelated; background:#000; cursor:crosshair }}
input[type=range] {{ width: 90% }}
.cbar {{ width:260px; height:14px; background:{grad}; display:inline-block }}
</style></head><body>
<h3>{title}</h3>
<div>{panes}</div>
<div id='val' style='margin:6px'></div>
<div>-{vmax} <span class='cbar'></span> +{vmax} &nbsp; (seismic, vmax={vmax})</div>
<script>
const VOL_B64 = "{vol_b64}";
const UNDER_B64 = "{under_b64}";
{js}
</script></body></html>"""


# The cells pandas' ``read_csv`` reads as missing by default.
NA_CELLS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                      "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                      "nan", "null"})


def _cell(text: str | None) -> float:
    return np.nan if text is None or text in NA_CELLS else float(text)


def read_val_r2(metrics_csv: str | Path) -> np.ndarray:
    """(validation rows, ROIs) f64: the squared ``*ROI*`` columns (sorted by
    name) of the rows of ``metrics_csv`` whose ``val/brain_loss`` is set."""
    with open(metrics_csv, newline="") as f:
        reader = csv.DictReader(f)
        roi = sorted(c for c in reader.fieldnames or () if "ROI" in c)
        rows = [[_cell(r[c]) for c in roi] for r in reader
                if not np.isnan(_cell(r.get("val/brain_loss")))]
    return np.asarray(rows, np.float64).reshape(len(rows), len(roi)) ** 2


def make_brainmaps(config: BrainmapConfig) -> list[str]:
    """Returns the list of HTML files written (one per validation row)."""
    atlas_img = load_nifti(config.atlas_path)
    atlas = np.asarray(atlas_img.data)
    if atlas.ndim == 4:
        atlas = atlas[..., 0]
    atlas = np.rint(atlas).astype(np.int32)

    written = []
    for i, r2 in enumerate(read_val_r2(Path(config.metrics_path) / "metrics.csv")):
        volume = labels_inverse_transform(atlas, r2)
        if config.export_nii:
            save_nifti(
                NiftiImage(volume, atlas_img.affine),
                f"{config.out_path}_val-{i}.nii.gz",
            )
        html = _interactive_html(volume, atlas, atlas_img.affine, VMAX, f"val epoch {i} — r²")
        out = f"{config.out_path}_val-{i}.html"
        Path(out).write_text(html)
        written.append(out)
    return written
