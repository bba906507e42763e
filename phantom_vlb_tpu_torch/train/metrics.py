"""Streaming per-ROI Pearson r (running moments, batch-merged on the device)
and the CSV metrics log.

Counterpart of ``phantom_vlb_tpu/train/metrics.py``: ``pearson_init/update/
compute`` (:45-99) are a Welford-style batch merge in f32, aware of padded
rows, so no activation-sized host transfer is needed. :func:`pearson_merge`
is the pairwise (Chan) merge of two states, which a batch update applies to
the batch's own moments and :func:`pearson_all_merge` applies to the
ranks' states in rank order (a rank with no rows contributes nothing). :class:`CSVMetricsLogger`
(:106-156) writes Lightning's CSVLogger layout, which the brain maps read
(``postprocessing/brainmaps.py``): ``<save_dir>/<name>/version_<k>/metrics.csv``,
one row per logging event, the union of keys as header, empty cells for
absent metrics, and ``val/brain_loss`` + ``val_corr_ROI_%06d`` +
``val_corr_avg`` in each validation's row.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from phantom_vlb_tpu_torch.core.config import dump_yaml

__all__ = ["PearsonState", "pearson_init", "pearson_update", "pearson_merge", "pearson_all_merge",
           "pearson_compute", "CSVMetricsLogger", "NullMetricsLogger", "roi_metric_names"]


@dataclasses.dataclass
class PearsonState:
    """Running first/second moments per ROI (all (P,) except the scalar n)."""

    n: torch.Tensor
    mean_x: torch.Tensor
    mean_y: torch.Tensor
    m2x: torch.Tensor
    m2y: torch.Tensor
    cxy: torch.Tensor


def pearson_init(num_target: int, device="cpu") -> PearsonState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return PearsonState(n=z(), mean_x=z(num_target), mean_y=z(num_target),
                        m2x=z(num_target), m2y=z(num_target), cxy=z(num_target))


def pearson_update(
    state: PearsonState,
    preds: torch.Tensor,                  # (B, P)
    targets: torch.Tensor,                # (B, P)
    row_mask: torch.Tensor | None = None,  # (B,)
) -> PearsonState:
    """Merge one batch into the running moments; an empty batch changes nothing."""
    x = torch.nan_to_num(preds.to(state.mean_x.dtype))
    y = torch.nan_to_num(targets.to(state.mean_y.dtype))
    if row_mask is None:
        row_mask = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    m = row_mask.to(x.dtype)[:, None]

    nb = m.sum()
    safe_nb = nb.clamp_min(1.0)
    mean_xb = (x * m).sum(0) / safe_nb
    mean_yb = (y * m).sum(0) / safe_nb
    dxb = (x - mean_xb) * m
    dyb = (y - mean_yb) * m
    batch = PearsonState(n=nb, mean_x=mean_xb, mean_y=mean_yb, m2x=(dxb * dxb).sum(0),
                         m2y=(dyb * dyb).sum(0), cxy=(dxb * dyb).sum(0))
    return pearson_merge(state, batch)


def pearson_merge(a: PearsonState, b: PearsonState) -> PearsonState:
    """The moments of ``a``'s rows and ``b``'s together (Chan's pairwise
    update); ``a`` itself when ``b`` holds no rows."""
    n_new = a.n + b.n
    safe_n_new = n_new.clamp_min(1.0)
    delta_x = b.mean_x - a.mean_x
    delta_y = b.mean_y - a.mean_y
    corr = a.n * b.n / safe_n_new
    merged = PearsonState(
        n=n_new,
        mean_x=a.mean_x + delta_x * b.n / safe_n_new,
        mean_y=a.mean_y + delta_y * b.n / safe_n_new,
        m2x=a.m2x + b.m2x + delta_x * delta_x * corr,
        m2y=a.m2y + b.m2y + delta_y * delta_y * corr,
        cxy=a.cxy + b.cxy + delta_x * delta_y * corr,
    )
    keep = b.n > 0
    return PearsonState(**{
        f.name: torch.where(keep, getattr(merged, f.name), getattr(a, f.name))
        for f in dataclasses.fields(PearsonState)
    })


def pearson_all_merge(state: PearsonState, mesh) -> PearsonState:
    """Every rank's state merged in rank order (``mesh.all_gather``, a
    collective); the state itself on an unsharded mesh."""
    if mesh is None or not mesh.sharded:
        return state
    names = [f.name for f in dataclasses.fields(PearsonState)]
    flat = torch.cat([getattr(state, k).reshape(-1) for k in names])
    p = state.mean_x.shape[0]
    merged = None
    for part in mesh.all_gather(flat):
        s = PearsonState(n=part[0], **{k: part[1 + i * p: 1 + (i + 1) * p] for i, k in enumerate(names[1:])})
        merged = s if merged is None else pearson_merge(merged, s)
    return merged


def pearson_compute(state: PearsonState, eps: float = 1e-12) -> torch.Tensor:
    """Per-ROI correlation r (P,)."""
    return state.cxy / torch.sqrt((state.m2x * state.m2y).clamp_min(eps))


def roi_metric_names(num_target: int) -> list[str]:
    """``val_corr_ROI_%06d`` names."""
    return [f"val_corr_ROI_{i:06d}" for i in range(num_target)]


class CSVMetricsLogger:
    """Lightning-CSVLogger-compatible metrics.csv writer.

    Appends rows; the file is rewritten only when a new column appears
    (typically once, at the first validation), so logging stays O(row) with
    the 1002 per-ROI columns.
    """

    def __init__(self, save_dir: str | Path, name: str, version: int | None = None):
        base = Path(save_dir) / name
        if version is None:
            version = 0
            while (base / f"version_{version}").exists():
                version += 1
        self.log_dir = base / f"version_{version}"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "metrics.csv"
        self._rows: list[dict[str, Any]] = []
        self._columns: list[str] = []
        self._rows_flushed = 0

    def log_metrics(self, metrics: Mapping[str, Any], step: int, epoch: int) -> None:
        row = {"epoch": epoch, "step": step}
        for k, v in metrics.items():
            if isinstance(v, (torch.Tensor, np.ndarray)):
                v = v.item()
            row[k] = v
        new_cols = [k for k in row if k not in self._columns]
        self._columns.extend(new_cols)
        self._rows.append(row)
        self._flush(rewrite=bool(new_cols) and self._rows_flushed > 0)

    def _flush(self, rewrite: bool) -> None:
        if rewrite or not self.path.exists():
            with open(self.path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._columns)
                writer.writeheader()
                writer.writerows(self._rows)
        else:
            with open(self.path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._columns)
                if self._rows_flushed == 0:
                    writer.writeheader()
                writer.writerows(self._rows[self._rows_flushed:])
        self._rows_flushed = len(self._rows)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        """Append ``params`` to ``hparams.yaml`` in ``yaml.safe_dump``'s layout."""
        with open(self.log_dir / "hparams.yaml", "a") as f:
            f.write(dump_yaml(dict(params)))


class NullMetricsLogger:
    """The log of a rank that does not write (every rank but 0)."""

    def log_metrics(self, metrics: Mapping[str, Any], step: int, epoch: int) -> None:
        pass

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        pass
