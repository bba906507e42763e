#!/usr/bin/env python3
"""Convert the JAX package's Orbax checkpoints into the PyTorch port's layouts.

    python scripts/orbax_to_torch.py SRC DST
    make convert-orbax-torch SRC=results/run DST=results/run_torch

SRC is a JAX trainer's checkpoint root (``last``, ``best_brainloss_*``,
``trainer_state.json``, ``adapters``, the CSV logs) or one Orbax directory:
a ``TrainState``, an adapters-only export, or a full param tree (the
``model.checkpoint_path`` form). DST is a new directory; SRC is only read.
``vlb-train-torch`` resumes from the converted root (``output_dir=DST
trainer.resume=true``), ``vlb-predict-torch`` takes ``predict.checkpoint=DST/last``,
and a converted param tree is a ``model.checkpoint_path`` of the port's
(safetensors shards keyed by its state-dict names).

This runs where ``orbax`` is installed; the card's machine has none, so
convert there and copy DST over. It imports nothing of the JAX package:
each tree is restored without a target, as numpy arrays on the host
(a state that a multi-process run wrote, sharded, restores whole in one
process), and handed to ``phantom_vlb_tpu_torch/train/from_jax.py``. A
tree of dicts alone (a param tree, an adapters export) is restored one
leaf at a time as the converter reaches it, so one leaf is in memory at
once (a 7B tree in bf16 is 14 GB); a ``TrainState``, whose optax state
holds lists, is restored whole (its trainable subtree is the adapters and
the head). Prints the files written, their bytes, the leaves read and the
seconds.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from phantom_vlb_tpu_torch.train.from_jax import convert  # noqa: E402


def _plain(node):
    """Orbax's metadata tree as plain dicts and lists (leaves kept)."""
    if hasattr(node, "items"):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def _nest(keys: tuple, value):
    for k in reversed(keys):
        value = {k: value}
    return value


def _get(tree, keys: tuple):
    for k in keys:
        tree = tree[k]
    return tree


def make_restore():
    """``restore(path)`` -> the Orbax tree under ``path`` with numpy leaves
    (a tree with lists), or with one callable a leaf that restores that
    leaf alone when called (a tree of dicts)."""
    import orbax.checkpoint as ocp

    checkpointer = ocp.PyTreeCheckpointer()
    as_numpy = ocp.RestoreArgs(restore_type=np.ndarray)

    def restore(path: Path):
        path = Path(path).resolve()
        meta = _plain(checkpointer.metadata(path).item_metadata.tree)

        def leaves(node, keys=()):
            if node is None:
                return
            if isinstance(node, dict):
                for k, v in node.items():
                    yield from leaves(v, keys + (k,))
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    yield from leaves(v, keys + (i,))
            else:
                yield keys, node

        found = list(leaves(meta))
        if any(isinstance(k, int) for keys, _ in found for k in keys):
            args = _map(meta, lambda m: as_numpy)
            return checkpointer.restore(path, args=ocp.args.PyTreeRestore(restore_args=args))

        def lazy(keys, m):
            def load():
                item = _nest(keys, m)
                args = _nest(keys, as_numpy)
                out = checkpointer.restore(path, args=ocp.args.PyTreeRestore(
                    item=item, restore_args=args, partial_restore=True))
                return _get(out, keys)
            return load

        tree = _map(meta, lambda m: m)
        for keys, m in found:
            parent = _get(tree, keys[:-1])
            parent[keys[-1]] = lazy(keys, m)
        return tree

    return restore


def _map(node, fn):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(v, fn) for v in node]
    return fn(node)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("src", help="an Orbax directory, or a JAX trainer's checkpoint root")
    parser.add_argument("dst", help="a new directory for the port's layouts")
    args = parser.parse_args(argv)
    report, kinds = convert(args.src, args.dst, make_restore())
    for name, kind in kinds.items():
        print(f"{name}: {kind}")
    for f in report.files:
        print(f"  wrote {f} ({(Path(args.dst) / f).stat().st_size} bytes)")
    print(f"wrote {len(report.files)} files, {report.bytes} bytes, from {report.leaves} leaves, "
          f"in {report.seconds:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
