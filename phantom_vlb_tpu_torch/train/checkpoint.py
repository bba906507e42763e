"""Checkpoints: best-on-validation and last, the trainer's state, adapter export.

Counterpart of ``phantom_vlb_tpu/train/checkpoint.py``: the directory
``best_brainloss_{epoch}-{step}`` (replaced only when ``val/brain_loss``
improves) and ``last`` under the checkpoint root, the host-side trainer
state in ``trainer_state.json`` beside them, and the adapters-only export.

A checkpoint directory holds one ``state.pt``, written with ``torch.save``
and read with ``torch.load(weights_only=True)``: ``{"step", "params"
(trainable tensors by state-dict name), "optimizer"
(:meth:`AdamWCosine.state_dict`)}``. A run never writes the frozen
backbone. ``export_adapters`` writes ``adapters.pt``, the selected tensors
by name. Under a mesh of processes the state holds whole tensors (gathered
by the trainer), so a checkpoint resumes at any world size; only the
writer (rank 0) writes, and every rank keeps the best/last bookkeeping.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Callable, Mapping

import torch

__all__ = ["CheckpointManager", "export_adapters", "load_adapters", "STATE_FILE", "ADAPTERS_FILE"]

STATE_FILE = "state.pt"
ADAPTERS_FILE = "adapters.pt"


def _write(obj: Any, path: Path) -> int:
    """``torch.save`` to ``path`` through a temporary file renamed into
    place; returns the bytes written."""
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    tmp.replace(path)
    return path.stat().st_size


class CheckpointManager:
    """The best/last policy over ``directory``; ``bytes_written`` counts
    what the saves wrote. ``writer`` False: the same decisions, no files."""

    def __init__(self, directory: str | Path, writer: bool = True):
        self.directory = Path(directory).resolve()
        self.writer = writer
        if writer:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.best_metric = float("inf")
        self.best_path: Path | None = None
        self.bytes_written = 0

    def save(self, name: str, state: Mapping[str, Any]) -> Path:
        path = self.directory / name
        if not self.writer:
            return path
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        self.bytes_written += _write(dict(state), path / STATE_FILE)
        return path

    def save_on_validation(self, state: Mapping[str, Any], metric: float, epoch: int,
                           step: int) -> bool:
        """Save ``best_brainloss_<epoch>-<step>`` when the metric improves."""
        improved = metric < self.best_metric
        if improved:
            if self.writer and self.best_path is not None and self.best_path.exists():
                shutil.rmtree(self.best_path)
            self.best_metric = metric
            self.best_path = self.save(f"best_brainloss_{epoch}-{step}", state)
        return improved

    def save_last(self, state: Mapping[str, Any]) -> Path:
        return self.save("last", state)

    def save_metadata(self, meta: dict) -> None:
        """Persist the host-side trainer state (early-stop window, best
        metric) beside the checkpoints, so a resumed run neither resets its
        patience window nor saves a worse 'best'."""
        if self.writer:
            (self.directory / "trainer_state.json").write_text(json.dumps(meta))

    def load_metadata(self) -> dict:
        path = self.directory / "trainer_state.json"
        if not path.exists():
            return {}
        try:
            return json.loads(path.read_text())
        except ValueError:
            return {}

    def restore(self, name: str, device: str | torch.device = "cpu") -> dict:
        """The state saved under ``name``, its tensors on ``device``."""
        return self.restore_path(self.directory / name, device)

    @staticmethod
    def restore_path(path: str | Path, device: str | torch.device = "cpu") -> dict:
        return torch.load(Path(path) / STATE_FILE, map_location=device, weights_only=True)


def export_adapters(params: Mapping[str, torch.Tensor], path: str | Path,
                    keep: Callable[[str], bool]) -> dict[str, torch.Tensor]:
    """Save only the tensors whose names ``keep`` selects (e.g. LoRA + head)
    to ``<path>/adapters.pt``; returns them."""
    subset = {name: t.detach() for name, t in params.items() if keep(name)}
    if not subset:
        raise ValueError("adapter filter selected no parameters")
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    _write(subset, path / ADAPTERS_FILE)
    return subset


def load_adapters(params: Mapping[str, torch.Tensor], path: str | Path,
                  keep: Callable[[str], bool]) -> dict[str, torch.Tensor]:
    """``params`` with the tensors ``keep`` selects taken from an adapter
    export (each moved to its tensor's device and dtype); the export must
    hold exactly those names."""
    restored = torch.load(Path(path) / ADAPTERS_FILE, map_location="cpu", weights_only=True)
    wanted = {name for name in params if keep(name)}
    if set(restored) != wanted:
        raise ValueError(f"adapter export holds {sorted(set(restored) ^ wanted)[:8]} "
                         "unlike the selected parameters")
    return {name: restored[name].to(t.device, t.dtype) if name in restored else t
            for name, t in params.items()}
