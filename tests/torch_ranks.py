"""Run a function of this module on N gloo ranks of the CPU, one process each.

``run_ranks(case, world, tmp, **kwargs)`` starts ``world`` processes of
this file with torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, joined
through ``file://`` under ``tmp`` (no ports, so parallel test workers never
collide), each running ``CASES[case](mesh, tmp, **kwargs)``; every process
has its own time limit, and a rank that fails or outlives it fails the
caller. Returns each rank's result (``torch.save``d by the rank, on the
CPU). ``device="cuda"`` runs NCCL ranks, one card each; the default is gloo
on the CPU.

The cases build a VLB from a config and a state dict the caller saved (no
JAX here), and report whole tensors, so the caller holds them against the
one-process step and the JAX package's. ``many`` runs several cases in one
launch, in order (the ranks start once).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240


def run_ranks(case: str, world: int, tmp: Path, timeout: float = RANK_TIMEOUT_S, **kwargs) -> list:
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(kwargs, tmp / f"{case}.args.pt")
    env_base = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env_base["PYTHONPATH"] = os.pathsep.join([str(ROOT), env_base.get("PYTHONPATH", "")])
    env_base.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    for rank in range(world):
        env = dict(env_base, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        log = open(tmp / f"{case}.rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, case, str(tmp)], env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    failed = []
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                if proc.wait(timeout=timeout):
                    failed.append(f"rank {rank} exited {proc.returncode}")
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} ran past {timeout} s")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        logs = "\n".join((tmp / f"{case}.rank{r}.log").read_text()[-3000:] for r in range(world))
        raise AssertionError(f"{case}: {'; '.join(failed)}\n{logs}")
    return [torch.load(tmp / f"{case}.rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# The rank's side.

def tiny_config(use_lora: bool, dropout: float = 0.0, bits: int = 32, fused: bool = False,
                remat: bool = False, l2_lambda: float = 0.001, base_quant: str | None = None,
                remat_policy: str = "nothing", shared: bool = False, fused_epilogue: str = ""):
    """The tiny VLB's config, with LoRA (rank 4) and head dropout at
    ``dropout``: 32-bit generator masks, u8 ones, or the fused kernel's hash
    (its plain version on the CPU); optionally an int8 base, a checkpoint
    policy, one adapter mask per layer input and the fused epilogue."""
    from phantom_vlb_tpu_torch.models import videollama2 as tv
    from phantom_vlb_tpu_torch.models.lora import LoRAConfig

    cfg = tv.VLBConfig.tiny(use_lora=use_lora, dropout_rate=dropout, l2_lambda=l2_lambda)
    lora = LoRAConfig(rank=4, alpha=8.0, dropout=dropout, dropout_bits=bits, fused_dropout=fused,
                      shared_dropout=shared, fused_epilogue=fused_epilogue) if use_lora else None
    return dataclasses.replace(cfg, mistral=dataclasses.replace(
        cfg.mistral, lora=lora, remat=remat, base_quant=base_quant, remat_policy=remat_policy))


def make_model(cfg, sd: dict, device="cpu"):
    """``cfg``'s VLB holding copies of ``sd``'s tensors on ``device``."""
    from phantom_vlb_tpu_torch.models import videollama2 as tv

    return tv.VideoLLaMA2VLB.from_state_dict(cfg, {k: v.clone() for k, v in sd.items()}, device=device)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _whole_grads(trainable: dict) -> dict:
    from phantom_vlb_tpu_torch.parallel.sharding import whole

    return {k: whole(p.grad, p).cpu() for k, p in trainable.items()}


def case_steps(mesh, tmp: Path, scenarios: list) -> dict:
    """Each scenario: a fresh model and optimizer, then one ``train_step``
    per batch (this rank's rows of each); the losses, grad norms, whole
    gradients after the first step, and the whole tensors and AdamW state
    after the last."""
    from phantom_vlb_tpu_torch.models import videollama2 as tv
    from phantom_vlb_tpu_torch.parallel.sharding import shard_model, whole
    from phantom_vlb_tpu_torch.train.optim import AdamWCosine, OptimConfig
    from phantom_vlb_tpu_torch.train.step import train_step

    out = {}
    device = mesh.device_mesh.device_type
    for sc in scenarios:
        model = make_model(sc["cfg"], sc["sd"], device)
        tv.trainable_parameters(model)
        shard_model(model, mesh)
        model.train()
        trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
        optimizer = AdamWCosine(trainable.values(), OptimConfig(), mesh)
        res = {"loss": [], "grad_norm": [], "finite": [], "l2": []}
        for i, batch in enumerate(sc["batches"]):
            rows = mesh.local_rows(len(batch["row_mask"]))
            local = {k: torch.as_tensor(v)[rows].to(device) for k, v in batch.items()}
            before = {k: whole(p.detach(), p).clone() for k, p in trainable.items()}
            r = train_step(model, optimizer, local, seed=sc["seeds"][i], mesh=mesh)
            res["loss"].append(r["brain_loss"].item())
            res["l2"].append(r["l2_reg"].item())
            res["grad_norm"].append(r["grad_norm"].item())
            res["finite"].append(r["finite"])
            if i == 0:
                res["grads"] = _whole_grads(trainable)
            if not r["finite"]:
                res["unchanged"] = all(torch.equal(whole(p.detach(), p), before[k])
                                       for k, p in trainable.items())
        res["params"] = {k: whole(p.detach(), p).cpu() for k, p in trainable.items()}
        res["optimizer"] = _cpu(optimizer.state_dict())
        res["placements"] = {n: str(p.placements) for n, p in model.named_parameters()}
        out[sc["name"]] = res
    return out


def case_fit(mesh, tmp: Path, sd: dict, cfg, train: list, val: list, out_dir: str,
             max_epochs: int, resume: bool) -> dict:
    """``VLBTrainer.fit`` over this rank's rows of ``train`` / ``val`` (lists
    of global batches) into ``out_dir``, after ``maybe_resume`` when
    ``resume``; the trainer's state at the end (whole tensors)."""
    from phantom_vlb_tpu_torch.data.loader import RankRows

    return fit_run(sd, cfg, train, val, out_dir, max_epochs, resume, mesh, lambda loader: RankRows(loader, mesh))


def fit_run(sd, cfg, train, val, out_dir: str, max_epochs: int, resume: bool, mesh, wrap) -> dict:
    """The fit of :func:`case_fit` on ``wrap(train)`` / ``wrap(val)``; with
    ``mesh`` None, in one process."""
    from phantom_vlb_tpu_torch.train.loop import TrainLoopConfig, VLBTrainer
    from phantom_vlb_tpu_torch.train.optim import OptimConfig

    model = make_model(cfg, sd)
    loop = TrainLoopConfig(max_epochs=max_epochs, val_check_interval=0.5, log_every_n_steps=1,
                           seed=7, output_dir=out_dir, run_name="run", num_target=model.cfg.num_target,
                           early_stop_patience=0)
    trainer = VLBTrainer(model, OptimConfig(), loop, device="cpu", mesh=mesh)
    resumed_state = None
    if resume:
        assert trainer.maybe_resume()
        resumed_state = _copy(trainer.state())     # the tensors train on in place
    trainer.fit(wrap(train), wrap(val))
    return {"state": trainer.state(), "resumed": resumed_state, "step": trainer.global_step,
            "csv": str(getattr(trainer.csv_logger, "path", ""))}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def case_products(mesh, tmp: Path, cfg, sd: dict, seed: int) -> dict:
    """Each decoder projection of ``cfg``'s model cut to this rank's block
    along ``tensor`` (``split_decoder``, no FSDP), fed the whole input (its
    columns, row-parallel) made from ``seed``: the base product's output
    (column-parallel: this rank's columns gathered whole) and x's gradient
    under a seeded output gradient (row-parallel: its columns gathered), by
    projection name."""
    from phantom_vlb_tpu_torch.models.lora import LoRALinear
    from phantom_vlb_tpu_torch.parallel.sharding import _projections, split_decoder
    from phantom_vlb_tpu_torch.parallel.tensor import COLUMN, copy_to_tensor, gather_along

    model = make_model(cfg, sd)
    split_decoder(model, mesh)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i, (name, proj) in enumerate(_projections(model)):
        split = proj.tensor_split
        k = proj.weight_q.shape[1] * (split.size if split.role != COLUMN else 1)
        x = torch.randn(2, 5, k, generator=gen)
        n = proj.weight_q.shape[0] * (split.size if split.role == COLUMN else 1)
        dy = torch.randn(2, 5, n, generator=gen)
        if split.role == COLUMN:
            xin = x.clone().requires_grad_()
            base_in = xin if cfg.mistral.base_quant == "w8a8g8" else copy_to_tensor(xin, split)
            dy_in = dy.chunk(split.size, -1)[split.rank]
        else:
            xin = x.chunk(split.size, -1)[split.rank].clone().requires_grad_()
            base_in, dy_in = xin, dy
        y = proj._base_product(base_in) if isinstance(proj, LoRALinear) else proj(base_in)
        y.backward(dy_in)
        dx = xin.grad
        if split.role == COLUMN:
            y = gather_along(y.detach(), -1, split)
        else:
            dx = gather_along(dx, -1, split)
        out[f"{i}.{name}"] = {"y": y.detach(), "dx": dx, "x": x, "dy": dy}
    return out


def case_token_cache(mesh, tmp: Path, sd: dict, cfg, paths: list, cache_dir: str | None,
                     batch_size: int) -> dict:
    """The vision-token cache of the lazy-load ``paths`` under the mesh:
    ``attach_token_cache`` into ``cache_dir`` (a file rank 0 writes) or,
    with ``cache_dir`` None, into an in-memory store filled on every rank.
    Reports the sidecar's name, fingerprint and tokens as this rank sees
    them (the file read back after the barrier), the mtimes of the
    sidecars there before and after, the real rows of this rank's last
    batch, and the model's weights digest whole and sharded by FSDP2."""
    import h5py

    from phantom_vlb_tpu_torch.data import token_cache as ttc
    from phantom_vlb_tpu_torch.data.loader import BatchLoader, LazyDataset
    from phantom_vlb_tpu_torch.data.schemas import MemoryStore
    from phantom_vlb_tpu_torch.parallel.sharding import shard_model

    model = make_model(cfg, sd)
    loader = BatchLoader(LazyDataset(paths), batch_size, shuffle=False, prefetch=0, mesh=mesh)
    mtimes = (lambda: {} if cache_dir is None else
              {p.name: p.stat().st_mtime_ns for p in Path(cache_dir).glob("*.h5")})
    before = mtimes()
    target = MemoryStore() if cache_dir is None else cache_dir
    ttc.attach_token_cache(model, [loader], target, batch_size=batch_size, mesh=mesh)
    tokens = loader.dataset.tokens
    if cache_dir is None:
        (name,) = target.keys()
        fingerprint = target[name]["fingerprint"]
    else:
        name = Path(tokens).stem
        with h5py.File(tokens, "r") as f:
            tokens, fingerprint = f["tokens"][...], f.attrs["fingerprint"]
    last = list(loader)[-1]
    whole = ttc.weights_digest(model.state_dict())
    shard_model(model, mesh)
    return {"name": name, "fingerprint": fingerprint, "tokens": tokens, "before": before, "after": mtimes(),
            "last_rows": int(last.row_mask.sum()), "last_vision": last.vision.view(torch.int16).clone(),
            "digest": whole, "sharded_digest": ttc.weights_digest(model.state_dict()),
            "dtensors": sum(hasattr(t, "full_tensor") for t in model.state_dict().values())}


def case_feature_cache(mesh, tmp: Path, sd: dict, cfg, paths: list, batch_size: int) -> dict:
    """The feature cache of the lazy-load ``paths`` under the mesh, into an
    in-memory store (filled whole on every rank), and the batches of
    ``CachedFeatureLoader`` over it as this rank sees them."""
    from phantom_vlb_tpu_torch.data.loader import BatchLoader, LazyDataset
    from phantom_vlb_tpu_torch.data.schemas import MemoryStore
    from phantom_vlb_tpu_torch.train.precompute import CachedFeatureLoader, build_feature_cache

    model = make_model(cfg, sd)
    loader = BatchLoader(LazyDataset(paths), batch_size, shuffle=False, prefetch=0, mesh=mesh)
    store = MemoryStore()
    n = build_feature_cache(model, loader, store, mesh)
    cached = list(CachedFeatureLoader(store, batch_size, shuffle=True, seed=5, mesh=mesh))
    return {"n": n, "store": {k: ({f: np.asarray(v) for f, v in g.items()} if isinstance(g, dict) else np.asarray(g))
                              for k, g in store.items()},
            "batches": cached, "last_rows": int(list(loader)[-1].row_mask.sum())}


def case_cli(mesh, tmp: Path, argv: list, sd: dict | None = None) -> dict:
    """``vlb-train-torch`` with ``argv`` on the launch's ranks (the group
    this process joined); with ``sd``, the builder's random weights are
    ``sd``'s tensors. The CLI leaves the group when it is done."""
    from phantom_vlb_tpu_torch.cli.train import main
    from phantom_vlb_tpu_torch.train import builder

    if sd is not None:
        builder.init_params = lambda cfg, device, generator: {k: t.clone() for k, t in sd.items()}
    assert main(argv) == 0
    return {}


def case_many(mesh, tmp: Path, jobs: list) -> list:
    """Each (case, kwargs) of ``jobs`` in turn, in one launch."""
    return [CASES[name](mesh, tmp, **kwargs) for name, kwargs in jobs]


CASES = {"steps": case_steps, "fit": case_fit, "products": case_products, "token_cache": case_token_cache,
         "feature_cache": case_feature_cache, "cli": case_cli, "many": case_many}


def main() -> int:
    case, tmp = sys.argv[1], Path(sys.argv[2])
    torch.manual_seed(0)
    from phantom_vlb_tpu_torch.core.distributed import maybe_initialize_distributed, shutdown_distributed
    from phantom_vlb_tpu_torch.core.mesh import MeshConfig, build_mesh

    kwargs = torch.load(tmp / f"{case}.args.pt", weights_only=False)
    device = kwargs.pop("device", "cpu")
    # A stuck collective ends the rank with the collective named, well
    # before the caller's time limit kills it.
    assert maybe_initialize_distributed(device, init_method=f"file://{tmp}/{case}.rendezvous",
                                        timeout_s=RANK_TIMEOUT_S / 2)
    mesh = build_mesh(MeshConfig(**kwargs.pop("mesh", {})), device)
    result = CASES[case](mesh, tmp, **kwargs)
    torch.save(result, tmp / f"{case}.rank{mesh.rank}.pt")
    shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
