"""Metric logger sinks.

Counterpart of ``phantom_vlb_tpu/utils/logging.py``: a console sink and an
optional Comet sink (``comet_ml`` is imported only when one is made, and the
builder makes one only under ``comet.enabled``). The CSV logger, which the
brain maps read, is in ``train/metrics.py``. Every sink takes
``log_metrics(metrics, step, epoch)`` and ``log_hyperparams(dict)``.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping

__all__ = ["ConsoleLogger", "CometLoggerSink", "get_logger"]

_logger = logging.getLogger("phantom_vlb_tpu_torch")


def get_logger() -> logging.Logger:
    if not _logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(asctime)s %(name)s] %(message)s", "%H:%M:%S"))
        _logger.addHandler(handler)
        _logger.setLevel(logging.INFO)
    return _logger


class ConsoleLogger:
    def __init__(self, every_n: int = 1):
        self.every_n = every_n
        self._n = 0

    def log_metrics(self, metrics: Mapping[str, Any], step: int, epoch: int) -> None:
        self._n += 1
        if self._n % self.every_n:
            return
        small = {k: v for k, v in metrics.items() if "ROI" not in k}
        parts = " ".join(f"{k}={float(v):.5f}" for k, v in small.items())
        get_logger().info("epoch %d step %d %s", epoch, step, parts)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        get_logger().info("hparams: %s", dict(params))


class CometLoggerSink:
    """Comet experiment sink; inactive (and says so) when ``comet_ml`` is
    absent or the experiment cannot be made."""

    def __init__(self, api_key: str | None = None, workspace: str | None = None,
                 project: str = "phantom_mm", name: str | None = None):
        self._exp = None
        try:
            import comet_ml  # type: ignore

            self._exp = comet_ml.Experiment(api_key=api_key, workspace=workspace,
                                            project_name=project, display_summary_level=0)
            if name:
                self._exp.set_name(name)
        except Exception:
            get_logger().info("comet_ml unavailable; Comet logging disabled")

    def log_metrics(self, metrics: Mapping[str, Any], step: int, epoch: int) -> None:
        if self._exp is not None:
            self._exp.log_metrics(dict(metrics), step=step, epoch=epoch)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        if self._exp is not None:
            self._exp.log_parameters(dict(params))
