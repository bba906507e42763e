"""Checkpoints the JAX package wrote, in this package's own layouts.

The JAX trainer writes Orbax directories (``phantom_vlb_tpu/train/checkpoint.py``):

- a ``TrainState`` (``last``, ``best_brainloss_{epoch}-{step}``;
  ``phantom_vlb_tpu/train/step.py:66-92``): ``step``, ``params`` (the
  trainable subtree, its frozen leaves ``None``) and ``opt_state``, optax's
  ``chain(clip_by_global_norm, adamw)`` state
  (``phantom_vlb_tpu/train/optim.py:63-75``);
- ``trainer_state.json`` beside them (the early-stop window, the best
  metric and the best checkpoint's path);
- the adapters-only export (``export_adapters``, :117-139: the head and
  the LoRA factors);
- and it reads a full param tree as ``model.checkpoint_path``
  (``phantom_vlb_tpu/train/builder.py:159-167``).

Neither Orbax nor JAX is imported here. ``scripts/orbax_to_torch.py``
restores each tree raw, without a target, as numpy arrays (nested dicts;
optax's tuples as lists, its empty states as ``None``), and :func:`convert`
writes into a new directory:

- a TrainState -> a checkpoint directory holding ``state.pt`` in
  ``train/checkpoint.py``'s layout: ``step``; ``params`` by
  :func:`~phantom_vlb_tpu_torch.models.convert.from_flax_params`'s rules;
  ``optimizer`` in :meth:`AdamWCosine.state_dict`'s layout, optax's ``mu``
  and ``nu`` as AdamW's ``exp_avg`` and ``exp_avg_sq``, each mapped as its
  parameter is (a kernel's moments transposed with it, a stacked leaf cut
  into its layers), Adam's ``count`` as each tensor's ``step`` (its bias
  correction) and the schedule's ``count`` as the schedule's step. The
  optimizer's state is found by its structure (the one node with ``count``,
  ``mu`` and ``nu``, and at most one other ``count``), so a
  ``multi_transform`` around the chain reads too; any other leaf raises by
  name. The hyperparameters are not in a JAX state: a resumed run takes
  them from its config, as the JAX trainer does;
- an adapters export -> ``adapters.pt``;
- a full param tree -> safetensors shards, one a Flax leaf, keyed by this
  package's state-dict names and tagged
  :data:`~phantom_vlb_tpu_torch.models.convert.PORT_LAYOUT`, which
  ``load_pretrained_params`` reads whole (the head and the adapters too);
- a checkpoint root -> a root of the same names: each Orbax directory
  converted by its kind, ``trainer_state.json`` carried with its
  ``best_path`` moved into the new root, any other file copied.

A tree's leaves may be arrays, or callables that read one leaf when called,
so that a full param tree (14 GB in bf16) is converted one leaf at a time.
Leaves may be f32 or bf16 (``ml_dtypes``), and the decoder's tree stacked
(``layers_scan``) or per layer.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import time
from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch

from phantom_vlb_tpu_torch.models.convert import (
    PORT_LAYOUT,
    flax_leaf_arrays,
    flax_paths,
    from_flax_params,
    write_safetensors,
)
from phantom_vlb_tpu_torch.train.checkpoint import ADAPTERS_FILE, STATE_FILE, is_orbax_dir

__all__ = ["Conversion", "convert", "train_state_to_port", "optimizer_from_optax", "adapters_to_port",
           "tree_kind", "write_param_shards", "TRAINER_STATE"]

TRAINER_STATE = "trainer_state.json"


@dataclasses.dataclass
class Conversion:
    """What :func:`convert` wrote: files (relative to the new directory),
    bytes, leaves read and seconds."""
    files: list[str] = dataclasses.field(default_factory=list)
    bytes: int = 0
    leaves: int = 0
    seconds: float = 0.0

    def add(self, path: Path, root: Path) -> None:
        self.files.append(str(path.relative_to(root)))
        self.bytes += path.stat().st_size


def _value(leaf) -> np.ndarray:
    return np.asarray(leaf() if callable(leaf) else leaf)


def _count_leaves(node) -> int:
    """The arrays of a tree restored raw (dicts, lists, ``None``)."""
    if node is None:
        return 0
    if isinstance(node, Mapping):
        return sum(_count_leaves(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_count_leaves(v) for v in node)
    return 1


def _is_adapter_path(path: tuple) -> bool:
    """``export_adapters``' filter on a Flax path: the head and the LoRA factors."""
    joined = "/".join(str(k) for k in path)
    return joined.startswith("head") or "lora_a" in joined or "lora_b" in joined


def tree_kind(tree) -> str:
    """``'train_state'``, ``'adapters'`` (every leaf the head's or a LoRA
    factor) or ``'params'`` (a param tree), from the tree's structure alone."""
    if isinstance(tree, Mapping) and {"step", "params", "opt_state"} <= set(tree):
        return "train_state"
    paths = flax_paths(tree)
    if not paths:
        raise ValueError("the tree holds no array")
    return "adapters" if all(_is_adapter_path(p) for p in paths) else "params"


def _optax_parts(opt_state) -> tuple[Mapping, object]:
    """(Adam's node ``{count, mu, nu}``, the schedule's ``count`` or None)
    of an optax state restored raw; raises on anything else that holds an
    array."""
    adam, counts = [], []

    def walk(node, where: tuple) -> None:
        if node is None:
            return
        if isinstance(node, Mapping):
            keys = set(node)
            if keys == {"count", "mu", "nu"}:
                adam.append(node)
            elif keys == {"count"}:
                counts.append(node["count"])
            else:
                for k, v in node.items():
                    walk(v, where + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, where + (str(i),))
        else:
            raise ValueError(f"unconsumed optimizer state leaf opt_state/{'/'.join(where)}")

    walk(opt_state, ())
    if len(adam) != 1 or len(counts) > 1:
        raise ValueError(f"the optimizer state holds {len(adam)} Adam states and {len(counts)} schedule "
                         "counts; the JAX trainer's holds one of each")
    return adam[0], counts[0] if counts else None


def optimizer_from_optax(opt_state, names: list[str]) -> dict:
    """:meth:`AdamWCosine.state_dict`'s layout from optax's state over the
    parameters ``names`` (their state-dict names, in AdamW's index order)."""
    adam, schedule_count = _optax_parts(opt_state)
    adam_count = int(_value(adam["count"]))
    mu, nu = from_flax_params(adam["mu"]), from_flax_params(adam["nu"])
    for label, moments in (("mu", mu), ("nu", nu)):
        if set(moments) != set(names):
            raise ValueError(f"optax's {label} is for other tensors than the parameters: "
                             f"{sorted(set(moments) ^ set(names))[:8]}")
    state = {i: {"step": torch.tensor(float(adam_count), dtype=torch.float32),
                 "exp_avg": mu[name], "exp_avg_sq": nu[name]}
             for i, name in enumerate(names)}
    step = adam_count if schedule_count is None else int(_value(schedule_count))
    return {"step": step, "names": list(names),
            "adamw": {"state": state, "param_groups": [{"params": list(range(len(names)))}]}}


def train_state_to_port(tree: Mapping) -> dict:
    """A JAX ``TrainState`` restored raw -> ``state.pt``'s contents."""
    stray = sorted(set(tree) - {"step", "params", "opt_state"})
    if stray:
        raise ValueError(f"unconsumed TrainState field(s) {stray}")
    params = from_flax_params(tree["params"])
    return {"step": int(_value(tree["step"])), "params": params,
            "optimizer": optimizer_from_optax(tree["opt_state"], list(params))}


def adapters_to_port(tree: Mapping) -> dict[str, torch.Tensor]:
    """An adapters-only export restored raw -> ``adapters.pt``'s contents."""
    if tree_kind(tree) != "adapters":
        raise ValueError("not an adapters export: it holds tensors other than the head and the LoRA factors")
    return from_flax_params(tree)


def write_param_shards(tree: Mapping, out: Path, report: Conversion, root: Path) -> None:
    """A param tree -> one safetensors shard a Flax leaf under ``out``,
    keyed by state-dict names, tagged ``PORT_LAYOUT``; one leaf read at a time."""
    n = len(flax_paths(tree))
    seen: set[str] = set()
    for i, (path, pairs) in enumerate(flax_leaf_arrays(tree)):
        keys = [key for key, _ in pairs]
        twice = seen.intersection(keys)
        if twice:
            raise ValueError(f"{sorted(twice)[0]} given twice")
        seen.update(keys)
        shard = out / f"params-{i + 1:05d}-of-{n:05d}.safetensors"
        write_safetensors(shard, dict(pairs), PORT_LAYOUT)
        report.add(shard, root)
        report.leaves += 1
        del pairs                      # before the next leaf is read


def _convert_one(src: Path, out: Path, restore: Callable[[Path], Mapping], report: Conversion,
                 root: Path) -> str:
    tree = restore(src)
    kind = tree_kind(tree)
    out.mkdir(parents=True)
    if kind == "params":
        write_param_shards(tree, out, report, root)
        return kind
    obj = train_state_to_port(tree) if kind == "train_state" else adapters_to_port(tree)
    target = out / (STATE_FILE if kind == "train_state" else ADAPTERS_FILE)
    torch.save(obj, target)
    report.add(target, root)
    report.leaves += _count_leaves(tree)
    return kind


def _carry_trainer_state(src: Path, dst: Path, report: Conversion) -> None:
    meta = json.loads((src / TRAINER_STATE).read_text())
    best = meta.get("best_path")
    if best and Path(best).parent.resolve() == src.resolve():
        meta["best_path"] = str(dst.resolve() / Path(best).name)
    (dst / TRAINER_STATE).write_text(json.dumps(meta))
    report.add(dst / TRAINER_STATE, dst)


def convert(src: str | Path, dst: str | Path, restore: Callable[[Path], Mapping]) -> tuple[Conversion, dict]:
    """Convert ``src`` (one Orbax directory, or a checkpoint root that holds
    them) into the new directory ``dst``; ``restore`` reads an Orbax
    directory's tree raw. Returns what was written and each Orbax
    directory's kind by name (``.`` for ``src`` itself)."""
    src, dst = Path(src), Path(dst)
    if dst.exists() and any(dst.iterdir()):
        raise FileExistsError(f"{dst} exists and is not empty; the converter writes a new directory")
    if dst.resolve() == src.resolve() or src.resolve() in dst.resolve().parents:
        raise ValueError(f"{dst} lies inside {src}; the converter never writes into the JAX checkpoint")
    t0 = time.perf_counter()
    report, kinds = Conversion(), {}
    if is_orbax_dir(src):
        if dst.exists():
            dst.rmdir()
        kinds["."] = _convert_one(src, dst, restore, report, dst)
    else:
        if not src.is_dir():
            raise FileNotFoundError(f"no checkpoint directory at {src}")
        dst.mkdir(parents=True, exist_ok=True)
        for entry in sorted(src.iterdir()):
            if entry.is_dir() and is_orbax_dir(entry):
                kinds[entry.name] = _convert_one(entry, dst / entry.name, restore, report, dst)
            elif entry.name == TRAINER_STATE:
                _carry_trainer_state(src, dst, report)
            elif entry.is_dir():
                shutil.copytree(entry, dst / entry.name)
                for f in sorted(p for p in (dst / entry.name).rglob("*") if p.is_file()):
                    report.add(f, dst)
            else:
                shutil.copy2(entry, dst / entry.name)
                report.add(dst / entry.name, dst)
        if not kinds:
            raise FileNotFoundError(f"no Orbax checkpoint directory in {src}")
    report.seconds = time.perf_counter() - t0
    return report, kinds
