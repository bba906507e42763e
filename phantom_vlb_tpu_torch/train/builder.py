"""Assembly: config tree -> loaders, model, trainer (the reference's train.py).

Counterpart of ``phantom_vlb_tpu/train/builder.py``: seed, the native
loaders over the lazy-load files (:40-80), the model config of the selected
regime (:85-133), random weights with HF-keyed pretrained weights merged in
(:147; a JAX param tree as this package's shards, which
``train/from_jax.py`` writes from the Orbax form, :159-167), the
vision-token cache (:327-343), the trainer with its CSV,
console and optional Comet loggers and the hyperparameters logged twice
(:301-399), the feature-cache path of the frozen baseline
(``run_cached_training``, :402-482) and ``run_training`` (:485).

The ``mesh`` node spans the processes of a ``torchrun`` launch
(``core/distributed.py``, one card each; ``-1`` absorbs the world size):
under it the model is built on each rank's card from the same seed, its
decoder's projections cut to each rank's block along ``mesh.tensor`` and
the blocks sharded by FSDP2 over the batch axes (``parallel/sharding.py``,
``parallel/tensor.py``; any ``base_quant`` too), and each rank's loaders
yield its batch coordinate's rows of each global batch, which the batch
axes must divide. The two caches run under the mesh as the reference's run
under its own (:327-343, :402-482): each rank encodes its rows of the
clips (``datamodule.vision_token_cache``) or runs the backbone over its rows
(``model.cache_features``), the rows are gathered in order, rank 0 writes a
file, and the head over the feature cache trains on the sharded step. A
single process trains on one card, whatever the machine holds. Branches of
the reference that are not ported raise by name: an Orbax directory as
``model.checkpoint_path`` (naming the converter, ``scripts/orbax_to_torch.py``),
``mesh.sequence`` > 1 across processes
(``core/mesh.py``), and under a mesh of more than one process the ring
``attention_impl``s (``parallel/sharding.py``). :func:`build_trainer` and :func:`build_cached_trainer`
also take ready ``loaders`` (any sized iterables of global batches; under a
mesh each rank keeps its rows), in which case they build none; the
vision-token cache needs the native loaders (it swaps their datasets).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from phantom_vlb_tpu_torch.core.config import Config, to_dict
from phantom_vlb_tpu_torch.core.device import resolve_device
from phantom_vlb_tpu_torch.core.distributed import MULTI_CARD_OPT_IN, broadcast_object
from phantom_vlb_tpu_torch.core.mesh import MeshConfig, MeshEnv, build_mesh
from phantom_vlb_tpu_torch.data.grain_loader import GrainBatchLoader
from phantom_vlb_tpu_torch.data.loader import (
    BatchLoader,
    LazyDataset,
    RankRows,
    expand_lazyload_glob,
    split_train_val,
)
from phantom_vlb_tpu_torch.data.token_cache import attach_token_cache
from phantom_vlb_tpu_torch.models.convert import (
    HF_STC_PREFIX,
    PORT_LAYOUT,
    SafetensorsDir,
    hf_key,
    init_params,
)
from phantom_vlb_tpu_torch.models.lora import LoRAConfig
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB, VLBConfig
from phantom_vlb_tpu_torch.ops.quant import quantize_int8
from phantom_vlb_tpu_torch.train.checkpoint import refuse_orbax
from phantom_vlb_tpu_torch.train.loop import TrainLoopConfig, VLBTrainer
from phantom_vlb_tpu_torch.train.optim import OptimConfig
from phantom_vlb_tpu_torch.train.precompute import (
    CachedFeatureLoader,
    HeadOnly,
    build_feature_cache,
    cache_present,
    head_forward,
)
from phantom_vlb_tpu_torch.utils.logging import CometLoggerSink, ConsoleLogger

__all__ = ["build_loaders", "split_loaders", "build_model_config", "load_pretrained_params", "build_model",
           "build_trainer", "build_cached_trainer", "run_cached_training", "run_training"]


def build_loaders(dm: Config, mesh: MeshEnv | None = None) -> tuple[BatchLoader, BatchLoader, dict]:
    """The train and val loaders over the lazy-load files (under a mesh,
    this rank's rows of each global batch), and the files' names: the
    native loaders, or with ``datamodule.loader=grain`` the
    :class:`GrainBatchLoader`s (``data/grain_loader.py``)."""
    files = expand_lazyload_glob(dm.lazyload_path, list(dm.seasons))
    if not files:
        raise FileNotFoundError(
            f"no lazy-load files match {dm.lazyload_path!r} for seasons {dm.seasons}")
    train_files, val_files = split_train_val(files, int(dm.random_state))
    dset_names = {"val_set": [f.rsplit("/", 1)[-1] for f in val_files],
                  "train_set": [f.rsplit("/", 1)[-1] for f in train_files]}
    return (*split_loaders(dm, train_files, val_files, mesh), dset_names)


def split_loaders(dm: Config, train_sources: list, val_sources: list,
                  mesh: MeshEnv | None = None) -> tuple[BatchLoader, BatchLoader]:
    """The train and val loaders of the datamodule config (``loader``:
    ``native`` or ``grain``) over lazy-load files or open stores (e.g. the
    in-memory ones the builder writes)."""
    if str(dm.get("loader", "native")) == "grain":
        common = dict(batch_size=int(dm.batch_size), seed=int(dm.random_state),
                      worker_count=int(dm.get("num_workers", 0)), mesh=mesh)
        return (GrainBatchLoader(train_sources, shuffle=True, **common),
                GrainBatchLoader(val_sources, shuffle=bool(dm.get("shuffle_val_data", False)), **common))
    common = dict(batch_size=int(dm.batch_size), seed=int(dm.random_state),
                  prefetch=int(dm.get("prefetch", 4)), num_threads=int(dm.get("num_workers", 4)),
                  mesh=mesh)
    train_loader = BatchLoader(LazyDataset(train_sources), shuffle=True, **common)
    val_loader = BatchLoader(LazyDataset(val_sources), shuffle=bool(dm.get("shuffle_val_data", False)),
                             **common)
    return train_loader, val_loader


def build_model_config(m: Config) -> VLBConfig:
    """The model's config from the ``model`` node: preset ``tiny`` or
    ``full``, LoRA from ``lora_*``, ``base_quant`` for the decoder and the
    tower alike."""
    use_lora = bool(m.get("use_lora", False))
    lora = None
    if use_lora:
        lora = LoRAConfig(
            rank=int(m.lora_r),
            alpha=float(m.lora_alpha),
            dropout=float(m.lora_dropout),
            shared_dropout=bool(m.get("lora_shared_dropout", False)),
            dropout_bits=int(m.get("lora_dropout_bits", 32)),
            fused_dropout=bool(m.get("lora_fused_dropout", False)),
        )
    common = dict(
        l2_lambda=float(m.l2_lambda),
        dropout_rate=float(m.dropout_rate),
        freeze_backbone=bool(m.get("freeze_backbone", True)),
    )
    base_quant = m.get("base_quant", None) or None
    preset = m.get("preset", "full")
    if preset == "tiny":
        cfg = VLBConfig.tiny(use_lora=use_lora, base_quant=base_quant)
        if use_lora:
            cfg = dataclasses.replace(cfg, mistral=dataclasses.replace(cfg.mistral, lora=lora))
        return dataclasses.replace(cfg, **common)
    if preset == "full":
        cfg = VLBConfig.full(use_lora=use_lora, base_quant=base_quant)
        cfg = dataclasses.replace(cfg, mistral=dataclasses.replace(cfg.mistral, lora=lora),
                                  num_target=int(m.num_target), **common)
        cfg.validate()
        return cfg
    raise ValueError(f"unknown model preset {preset!r}")


def _stc_expected_keys(stc_cfg) -> set[str]:
    """The exact HF key set (under ``model.mm_projector.``) of the STC
    connector the port builds."""
    keys = set()
    # A block has a 1x1-conv shortcut only where its in/out widths differ
    # (timm's Bottleneck rule): stage s1's first block only.
    downsample_blocks = {"s1.b1"} if stc_cfg.encoder_hidden_size != stc_cfg.hidden_size else set()
    for stage in ("s1", "s2"):
        for j in range(stc_cfg.depth):
            p = f"{stage}.b{j + 1}"
            for conv in ("conv1", "conv2", "conv3"):
                keys |= {f"{p}.{conv}.conv.weight", f"{p}.{conv}.bn.weight", f"{p}.{conv}.bn.bias"}
            keys |= {f"{p}.se.fc1.weight", f"{p}.se.fc1.bias", f"{p}.se.fc2.weight", f"{p}.se.fc2.bias"}
            if p in downsample_blocks:
                keys |= {f"{p}.downsample.conv.weight", f"{p}.downsample.bn.weight",
                         f"{p}.downsample.bn.bias"}
    keys |= {"sampler.0.weight", "sampler.0.bias", "readout.0.weight", "readout.0.bias"}
    for i in range(1, stc_cfg.mlp_depth):
        keys |= {f"readout.{2 * i}.weight", f"readout.{2 * i}.bias"}
    return keys


def _assert_keys_consumed(sd: Mapping, prefix: str, expected: set[str]) -> None:
    """A checkpoint's keys under ``prefix`` must be exactly ``expected``
    (none at all is fine: a shard set without that subtree); anything else
    means the reconstructed architecture does not hold for it."""
    present = {k[len(prefix):] for k in sd if k.startswith(prefix)}
    if not present:
        return
    unconsumed, missing = present - expected, expected - present
    if unconsumed or missing:
        raise ValueError(
            f"checkpoint/{prefix}* does not match the reconstructed architecture: unconsumed keys "
            f"{sorted(unconsumed)[:8]}..., missing keys {sorted(missing)[:8]}... — the STC "
            "connector's reconstruction does not hold for this checkpoint.")


def load_pretrained_params(model_cfg: VLBConfig, checkpoint_path: str | Path,
                           params: Mapping[str, torch.Tensor], sd: Mapping | None = None
                           ) -> dict[str, torch.Tensor]:
    """``params`` (a state dict) with the tensors of the safetensors shards
    under ``checkpoint_path`` in place of their own.

    Shards with VideoLLaMA2's HF keys: each tensor is read from the shards
    straight to its parameter's device and cast to its dtype; under
    ``base_quant`` the HF weight of a base projection is quantized there
    (:func:`quantize_int8`). The decoder's tensors must all be present; the
    tower's and the connector's are taken when the shards hold that
    subtree, the connector's only when its keys match the connector
    exactly. The head and the adapters keep their values. Shapes must match.

    Shards tagged :data:`PORT_LAYOUT` (a JAX param tree, the Orbax
    ``model.checkpoint_path`` form, converted by ``train/from_jax.py``) hold
    state-dict names and replace every tensor, the head and the adapters
    too, as the reference's Orbax branch does; a tensor missing or stray
    raises by name. An Orbax directory raises, naming the converter.

    ``sd``: an optional key -> tensor mapping read in place of the shards
    (e.g. one that records which keys were read).
    """
    p = Path(checkpoint_path)
    refuse_orbax(p, "model.checkpoint_path")
    if sd is None and not list(p.glob("*.safetensors")):
        raise FileNotFoundError(f"no checkpoint found at {checkpoint_path}")
    own = sd is None
    if own:
        sd = SafetensorsDir(p, next(iter(params.values())).device)
    try:
        if getattr(sd, "metadata", None) == PORT_LAYOUT:
            return _load_port_layout(sd, p, params)
        _assert_keys_consumed(sd, HF_STC_PREFIX, _stc_expected_keys(model_cfg.stc))
        subtrees = {"vision_tower.": any(k.startswith("model.vision_tower") for k in sd),
                    "mm_projector.": any(k.startswith(HF_STC_PREFIX) for k in sd)}
        out = dict(params)
        for key, base in params.items():
            src = hf_key(key)
            if src is None or key.endswith(".weight_scale") or not subtrees.get(
                    key.split(".", 1)[0] + ".", True):
                continue
            if src not in sd:
                raise KeyError(f"{src} (for {key}) is not in the checkpoint at {p}")
            w = sd[src].to(base.device)
            if key.endswith(".weight_q"):
                scale_key = key[: -len("weight_q")] + "weight_scale"
                w, scale = quantize_int8(w, axis=1)
                _check_shape(scale_key, params[scale_key], scale)
                out[scale_key] = scale.to(params[scale_key].dtype)
            _check_shape(key, base, w)
            out[key] = w.to(base.dtype)
            del w
    finally:
        if own:
            sd.close()
    return out


def _load_port_layout(sd: Mapping, p: Path, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every tensor of ``params`` from shards keyed by state-dict names."""
    stray = sorted(set(sd) - set(params))
    if stray:
        raise ValueError(f"the checkpoint at {p} holds tensors the model does not: {stray[:8]}")
    out = {}
    for key, base in params.items():
        if key not in sd:
            raise KeyError(f"{key} is not in the checkpoint at {p}")
        w = sd[key]
        _check_shape(key, base, w)
        out[key] = w.to(base.device, base.dtype)
        del w
    return out


def _check_shape(key: str, base: torch.Tensor, w: torch.Tensor) -> None:
    if tuple(base.shape) != tuple(w.shape):
        raise ValueError(f"pretrained weight shape {tuple(w.shape)} does not match the "
                         f"initialized parameter shape {tuple(base.shape)} of {key}")


def build_run_mesh(config: Config, device: torch.device) -> MeshEnv:
    """The ``mesh`` node over this launch's processes; says so when a
    single process leaves cards idle, and raises unless its batch axes
    divide ``datamodule.batch_size``."""
    mesh = build_mesh(MeshConfig.from_config(config.get("mesh")), device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if not mesh.sharded and n_cards > 1:
        print(f"[build] one process trains on {device}; the node's other {n_cards - 1} cards stay idle. "
              f"Launch one process per card to shard over them: {MULTI_CARD_OPT_IN}=1 torchrun "
              f"--nproc_per_node={n_cards} -m phantom_vlb_tpu_torch.cli.train ... (not yet run to its end "
              "on more than one card: ROADMAP Queue 1 #4)")
    mesh.local_rows(int(config.datamodule.batch_size))          # raises unless the batch axes divide it
    return mesh


def build_model(m: Config, seed: int, device: torch.device) -> VideoLLaMA2VLB:
    """The model of the ``model`` node on ``device``: random weights from a
    generator on ``device`` seeded with ``seed``, with the HF weights of
    ``model.checkpoint_path`` in place of their own."""
    model_cfg = build_model_config(m)
    params = init_params(model_cfg, device, torch.Generator(device=device).manual_seed(seed))
    ckpt_path = m.get("checkpoint_path")
    if ckpt_path:
        params = load_pretrained_params(model_cfg, ckpt_path, params)
    return VideoLLaMA2VLB.from_state_dict(model_cfg, params)


def _loop_configs(config: Config, num_target: int, seed: int) -> tuple[OptimConfig, TrainLoopConfig]:
    optim = config.optim
    optim_cfg = OptimConfig(
        lr=float(optim.lr),
        betas=tuple(float(b) for b in optim.betas),
        eps=float(optim.eps),
        weight_decay=float(optim.weight_decay),
        lr_scheduler_name=str(optim.lr_scheduler_name),
        t_max=int(optim.t_max),
        grad_clip=float(optim.get("grad_clip", 1.0)),
    )
    tr = config.trainer
    loop_cfg = TrainLoopConfig(
        max_epochs=int(tr.max_epochs),
        val_check_interval=float(tr.val_check_interval),
        log_every_n_steps=int(tr.log_every_n_steps),
        seed=seed,
        output_dir=str(config.output_dir),
        run_name=str(config.get("run_name", "vlb")),
        num_target=num_target,
        early_stop_patience=int(tr.get("early_stop_patience", 0)),
        early_stop_min_delta=float(tr.get("early_stop_min_delta", 0.0)),
    )
    return optim_cfg, loop_cfg


def _loaders(dm: Config, loaders, mesh: MeshEnv | None = None) -> tuple[object, object, dict]:
    if loaders is None:
        return build_loaders(dm, mesh)
    if mesh is not None and mesh.sharded:
        loaders = [RankRows(loader, mesh) for loader in loaders]
    return (*loaders, {"val_set": [], "train_set": []})


def build_trainer(config: Config, device: str | torch.device = "cuda", loaders=None,
                  mesh: MeshEnv | None = None, token_cache=None):
    """Full assembly on ``device`` -> (trainer, train_loader, val_loader).

    ``loaders``: an optional (train, val) pair of sized iterables of global
    batches (e.g. lists of dicts of tensors); without it the native loaders
    are built over the lazy-load files. With ``datamodule.vision_token_cache``
    the frozen vision path runs once per clip into a sidecar under that
    directory (``$VARS`` expanded), or into ``token_cache`` (an in-memory
    store, ``MemoryStore``) when given, and the loaders read its tokens.
    Under a mesh of processes (:func:`build_run_mesh`), each rank's loaders
    yield its rows and the trainer shards the model; the model is whole on
    every rank until then, so each rank encodes its rows of the clips into
    the sidecar, which rank 0 writes (``data/token_cache.py``). ``mesh``
    replaces that mesh (e.g. ``MeshEnv`` of one device: unsharded, in a
    process of a group).
    """
    device = resolve_device(device)
    seed = int(config.random_state)
    np.random.seed(seed)
    dm = config.datamodule
    mesh = build_run_mesh(config, device) if mesh is None else mesh

    train_loader, val_loader, dset_names = _loaders(dm, loaders, mesh)
    model = build_model(config.model, seed, device)

    # Vision-token cache (data/token_cache.py): the frozen CLIP + STC forward
    # once per clip; epochs then read (V, E) bf16 tokens.
    cache_dir = dm.get("vision_token_cache")
    if cache_dir:
        if str(dm.get("loader", "native")) == "grain":
            raise ValueError("vision_token_cache requires the native loader "
                             "(datamodule.loader=grain builds its own dataset views)")
        attach_token_cache(model, [train_loader, val_loader],
                           os.path.expandvars(str(cache_dir)) if token_cache is None else token_cache,
                           batch_size=int(dm.get("batch_size", 6)),
                           log=(lambda m: print(f"[build] {m}")) if mesh.is_writer else None,
                           mesh=mesh)

    optim_cfg, loop_cfg = _loop_configs(config, model.cfg.num_target, seed)
    # The CSV log (the brain maps' input) always; Comet when configured;
    # the console for interactive runs. The trainer drops the loggers on
    # ranks that do not write; Comet's sink is not even made there.
    extra_loggers: list = [ConsoleLogger()]
    comet_cfg = config.get("comet", None)
    if comet_cfg and comet_cfg.get("enabled", False) and mesh.is_writer:
        extra_loggers.append(CometLoggerSink(
            api_key=comet_cfg.get("api_key"), workspace=comet_cfg.get("workspace"),
            project=comet_cfg.get("project", "phantom_mm"), name=config.get("run_name")))
    trainer = VLBTrainer(model, optim_cfg, loop_cfg, device=device, extra_loggers=extra_loggers, mesh=mesh)
    # Hyperparameters logged twice, as the reference does: the whole config,
    # then the train and val file lists.
    trainer.csv_logger.log_hyperparams(to_dict(config))
    trainer.csv_logger.log_hyperparams(dset_names)
    return trainer, train_loader, val_loader


def build_cached_trainer(config: Config, device: str | torch.device = "cuda", loaders=None,
                         caches: Mapping[str, object] | None = None, mesh: MeshEnv | None = None):
    """The frozen baseline's feature-cache path on ``device`` -> (trainer,
    cached train loader, cached val loader): the backbone runs once per
    sample of each split into its cache, then the trainer trains the head
    alone over the caches (its checkpoints hold ``head.*``).

    ``caches``: an optional store per split ("train", "val"; see
    ``train/precompute.py``), filled here unless it holds a cache already;
    a split without one caches into ``output_dir/feature_cache_{split}.h5``,
    which is reused when present. ``loaders`` as for :func:`build_trainer`.

    Under a mesh of processes (:func:`build_run_mesh`, or ``mesh``) each
    rank runs the backbone (whole on every rank) over its rows of each
    batch and the rows are gathered, so each cache is the one-process cache
    (rank 0 writes a file, and decides whether one is there already); the
    head then trains on the sharded step (FSDP2 shards it as it shards the
    whole model's head), each rank on its rows of each global batch.
    """
    m = config.model
    if not bool(m.get("freeze_backbone", True)) or bool(m.get("use_lora", False)):
        raise ValueError("cache_features requires the frozen-baseline regime")
    device = resolve_device(device)
    seed = int(config.random_state)
    np.random.seed(seed)
    mesh = build_run_mesh(config, device) if mesh is None else mesh
    dm = config.datamodule
    train_loader, val_loader, dset_names = _loaders(dm, loaders, mesh)
    model = build_model(m, seed, device)

    out_dir = Path(str(config.output_dir))
    out_dir.mkdir(parents=True, exist_ok=True)
    stores = dict(caches or {})
    for split, loader in (("train", train_loader), ("val", val_loader)):
        store = stores.setdefault(split, out_dir / f"feature_cache_{split}.h5")
        present = cache_present(store)
        if isinstance(store, Path):
            present = broadcast_object(present)          # rank 0's file decides
        if not present:
            if isinstance(store, Path) and mesh.is_writer:
                print(f"building {split} feature cache -> {store}")
            build_feature_cache(model, loader, store, mesh)

    batch_size = int(dm.batch_size)
    cached_train = CachedFeatureLoader(stores["train"], batch_size, shuffle=True, seed=seed, mesh=mesh)
    cached_val = CachedFeatureLoader(stores["val"], batch_size,
                                     shuffle=bool(dm.get("shuffle_val_data", False)), mesh=mesh)
    head = HeadOnly(model.head)
    optim_cfg, loop_cfg = _loop_configs(config, model.cfg.num_target, seed)
    del model
    trainer = VLBTrainer(head, optim_cfg, loop_cfg, forward=head_forward, device=device, mesh=mesh)
    trainer.csv_logger.log_hyperparams(dset_names)
    return trainer, cached_train, cached_val


def run_cached_training(config: Config, device: str | torch.device = "cuda", loaders=None,
                        caches: Mapping[str, object] | None = None, mesh: MeshEnv | None = None) -> dict:
    """:func:`build_cached_trainer`, then fit the head over the caches."""
    trainer, cached_train, cached_val = build_cached_trainer(config, device, loaders, caches, mesh)
    return trainer.fit(cached_train, cached_val)


def run_training(config: Config, device: str | torch.device = "cuda") -> dict:
    """The feature-cache path under ``model.cache_features``; otherwise
    build, resume when ``trainer.resume`` is set and a ``last`` exists, fit."""
    if bool(config.get("model", {}).get("cache_features", False)):
        return run_cached_training(config, device)
    trainer, train_loader, val_loader = build_trainer(config, device)
    if bool(config.get("trainer", {}).get("resume", False)) and trainer.maybe_resume():
        print(f"resumed from step {trainer.global_step}")
    return trainer.fit(train_loader, val_loader)
