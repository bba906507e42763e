"""One run of one cell: set-up, the measured window, the trace, the check.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
``configs/<config>.json`` (the experiment YAML it composes, its overrides
and its sizes), ``workloads/<cell>.json`` (the traffic: batches, pool,
dialogue lengths, the steps checked and traced, the limits of the check,
optional set-up steps ``setup/<name>.py``) and ``metrics/<metric>.py`` (a
``read(run)`` for each per-layer metric). :func:`run` takes them as dicts,
so that the tests can hand it a tiny configuration on the CPU.

Set-up, timed as ``setup_s`` from the process's start: the configuration is
composed (``core/config.py``), the trainer of record built
(``train/builder.py`` ``build_trainer``), every tensor of its model made
from the seed block by block (``weights.py``) and copied in by name, a pool
of host batches made (``batches.py``), and the cell's set-up steps run.
Then the model goes to train mode, as ``VLBTrainer.fit`` puts it, and the
first ``check_steps`` batches of the pool go through
``VLBTrainer.train_one``: the steps that the check compares, which also
build and warm every kernel of the cell's shapes. The window then calls
``train_one`` on the next batch of the pool, cycling, until ``seconds`` have
passed, and waits for the card. With ``trace`` a further ``trace_steps``
steps run under ``torch.profiler``. The program is then freed and the
reference (``reference/vlb.py``) follows the checked steps from the same
weights, batches and seeds.
"""

from __future__ import annotations

import gc
import importlib.util
import resource
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from cardbench.batches import Geometry, make_pool
from cardbench.compare import checks
from cardbench.flops import peaks_for, step_flops
from cardbench.trace import BATCH_SPAN, STEP_SPAN, WINDOW_SPAN, reduce
from cardbench.weights import blocks, make_block, state_spec

__all__ = ["Run", "run", "derive", "load_plugin"]

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def derive(seed: int, purpose: str, bits: int = 31) -> int:
    """A seed for one purpose, from the run's seed (any size)."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), seed >> 64, *purpose.encode()])
    return int(ss.generate_state(1, np.uint64)[0]) >> (64 - bits)


def load_plugin(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark, as a module."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench.{kind}.{name.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Run:
    """What the per-layer metrics read."""

    def __init__(self, model: dict, batch: int, step_flops: float, peaks: dict | None):
        self.model, self.batch, self.step_flops, self.peaks = model, batch, step_flops, peaks
        self.step_s: list[float] = []
        self.window_s = 0.0
        self.trace = None          # the device-only pass
        self.host_trace = None     # the step traced with the host

    @property
    def steps(self) -> int:
        return len(self.step_s)


def _compose(config: dict, random_state: int, output_dir: str):
    from phantom_vlb_tpu_torch.core.config import load_config

    return load_config(ROOT / "configs", "base", [f"experiment={config['experiment']}", *config["overrides"],
                                                  f"random_state={random_state}", f"output_dir={output_dir}"])


def _check_sizes(trainer, composed, model: dict) -> None:
    """The model built is the one the configuration file states."""
    cfg = trainer.model.cfg
    m, t, v, c, h = cfg.mistral, model["text"], model["vision"], model["connector"], model["head"]
    lora = model.get("lora") if model["trainable"] == "lora+head" else None
    g = Geometry(model["geometry"])
    stated = {
        "text": (t["vocab_size"], t["hidden_size"], t["intermediate_size"], t["num_hidden_layers"],
                 t["num_attention_heads"], t["num_key_value_heads"], t["head_dim"], t["rms_norm_eps"],
                 t["rope_theta"]),
        "vision": (v["image_size"], v["patch_size"], v["hidden_size"], v["intermediate_size"],
                   v["num_hidden_layers"], v["num_attention_heads"], v["layer_norm_eps"], v["select_layer"]),
        "connector": (c["hidden_size"], c["depth"], c["mlp_depth"], c["se_ratio"]),
        "head": (h["num_target"], h["l2_lambda"], h["dropout_rate"]),
        "lora": None if lora is None else (lora["r"], lora["alpha"], lora["dropout"], lora["dropout_bits"],
                                           lora["fused_dropout"], lora.get("shared_dropout", False)),
        "dtype": model["dtype"],
        "batch_size": model["batch_size"],
        "geometry": (g.feature_len, g.num_frames, g.image_size),
    }
    built = {
        "text": (m.vocab_size, m.hidden_size, m.intermediate_size, m.num_hidden_layers, m.num_attention_heads,
                 m.num_key_value_heads, m.head_dim, m.rms_norm_eps, m.rope_theta),
        "vision": (cfg.clip.image_size, cfg.clip.patch_size, cfg.clip.hidden_size, cfg.clip.intermediate_size,
                   cfg.clip.num_hidden_layers, cfg.clip.num_attention_heads, cfg.clip.layer_norm_eps,
                   cfg.clip.select_layer),
        "connector": (cfg.stc.hidden_size, cfg.stc.depth, cfg.stc.mlp_depth, cfg.stc.se_ratio),
        "head": (cfg.num_target, cfg.l2_lambda, cfg.dropout_rate),
        "lora": None if m.lora is None else (m.lora.rank, m.lora.alpha, m.lora.dropout, m.lora.dropout_bits,
                                             m.lora.fused_dropout, m.lora.shared_dropout),
        "dtype": str(m.dtype).removeprefix("torch."),
        "batch_size": int(composed.datamodule.batch_size),
        "geometry": (cfg.geometry.feature_len, cfg.geometry.num_frames, cfg.geometry.image_size),
    }
    wrong = {k: (built[k], stated[k]) for k in stated if built[k] != stated[k]}
    if wrong:
        raise ValueError(f"the model built differs from its configuration file (built, stated): {wrong}")


def load_weights(model_nn: torch.nn.Module, model: dict, seed: int, device) -> None:
    """Every tensor of ``model_nn`` from the seed, block by block, copied in
    by name; the names, shapes and dtypes must be the benchmark's."""
    spec = state_spec(model)
    have = {k: (tuple(t.shape), t.dtype) for k, t in model_nn.state_dict().items()}
    want = {n: (tuple(s), d) for n, s, d in spec}
    if have != want:
        diff = sorted(k for k in set(have) | set(want) if have.get(k) != want.get(k))
        raise ValueError(f"the model's tensors differ from the benchmark's: {diff[:8]}")
    for name, entries in blocks(spec).items():
        result = model_nn.load_state_dict(make_block(seed, name, entries, device), strict=False)
        if result.unexpected_keys:
            raise ValueError(f"unexpected tensors {result.unexpected_keys[:8]}")


def _trainable_norms(trainer, tensors: dict[str, torch.Tensor] | None = None) -> dict[str, float]:
    """Each trainable leaf's norm: of its first gradient as AdamW holds it
    after one step (the first moment, (1 - beta1) g, over 1 - beta1), or of
    its change from ``tensors``."""
    part = 1.0 - trainer.optimizer.config.betas[0]
    norms = []
    for name, p in trainer.trainable.items():
        if tensors is None:                          # no state: the optimizer never moved this leaf
            moment = trainer.optimizer.adamw.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            norms.append((moment.float() / part).norm())
        else:
            norms.append((p.detach().float() - tensors[name]).norm())
    return dict(zip(trainer.trainable, torch.stack(norms).tolist()))


def _traced_steps(trainer, pool: list, start: int, n: int, sync, cuda: bool):
    """Two traced passes after the window: ``n`` steps with the device alone
    traced (its busy time, kernel groups and the host clock's window: the
    tracer costs the host little), then one step with the host traced too
    (ranges, the ops' shapes, which op launched each kernel; the tracer's
    host cost makes its idle time longer than an untraced step's)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    outs = []
    sync()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        for i in range(start, start + n):
            outs.append(trainer.train_one(pool[i % len(pool)]))
        sync()
        window_s = time.perf_counter() - t
    device = reduce(prof.profiler.kineto_results.events(), n, window_s)
    with profile(activities=[ProfilerActivity.CPU] + activities[:cuda], record_shapes=True) as prof:
        with record_function(WINDOW_SPAN):
            with record_function(BATCH_SPAN):
                batch = pool[(start + n) % len(pool)]
            with record_function(STEP_SPAN):
                outs.append(trainer.train_one(batch))
            sync()
    return device, reduce(prof.profiler.kineto_results.events(), 1), outs


def run(config: dict, workload: dict, metrics: list[dict], end_to_end: list[dict], seed: int,
        seconds: float, trace: bool, device: str, t_start: float, log=print) -> dict:
    """One run -> the result's dict (without the device's name)."""
    from phantom_vlb_tpu_torch.train.builder import build_trainer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model = config["model"]
    random_state = derive(seed, "random_state")
    out_dir = tempfile.mkdtemp(prefix="cardbench-")

    def mark(stage: str) -> None:           # set-up's stages by the wall clock and the process's CPU time
        log(f"set-up: {stage} at {time.perf_counter() - t_start:.2f} s (process CPU {time.process_time():.2f} s)")

    try:
        composed = _compose(config, random_state, out_dir)
        mark("imports and composition done")
        trainer, _, _ = build_trainer(composed, dev, loaders=([], []))
        sync()
        mark("build_trainer done")
        _check_sizes(trainer, composed, model)
        weight_seed = derive(seed, "weights", 63)
        load_weights(trainer.model, model, weight_seed, dev)
        sync()
        mark("weights made and copied")
        geom = Geometry(model["geometry"])
        pool = make_pool(geom, np.random.default_rng(derive(seed, "batches")), workload["pool_batches"],
                         model["batch_size"], model["text"]["vocab_size"], model["head"]["num_target"],
                         tuple(workload["dialogue_tokens"]), workload["inst_len"])
        mark("host pool made")
        for name in workload.get("setup", []):
            load_plugin("setup", name).run(trainer, pool, workload, dev)
        trainer.model.train()
        n_check = workload["check_steps"]
        start = {n: p.detach().float().clone() for n, p in trainer.trainable.items()}
        program = {"loss": []}
        for i in range(n_check):
            out = trainer.train_one(pool[i])
            program["loss"].append(float(out["brain_loss"]))
            if i == 0:
                program["grad_norm"] = _trainable_norms(trainer)
                mark("first checked step done")
        program["change_norm"] = _trainable_norms(trainer, start)
        del start
        sync()
        setup_s = time.perf_counter() - t_start
        mark("checked steps done")

        # The measured window.
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        step_s, finite, i = [], [], n_check
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            out = trainer.train_one(pool[i % len(pool)])
            step_s.append(time.perf_counter() - t)
            finite.append(out["finite"])
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0

        kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
        r = Run(model, model["batch_size"], step_flops(model, model["batch_size"], geom.feature_len,
                                                       geom.num_frames), peaks_for(kind))
        r.step_s, r.window_s = step_s, window_s
        if trace:
            r.trace, r.host_trace, outs = _traced_steps(trainer, pool, i, workload["trace_steps"], sync,
                                                          cuda)
            finite += [o["finite"] for o in outs]
        del trainer, out
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # The check: the reference follows the checked steps.
        from cardbench.reference.vlb import Reference, step_seeds

        t_ref = time.perf_counter()
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            ref = Reference(model, weight_seed, dev).train(pool[:n_check], step_seeds(random_state, n_check))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        log(f"reference: {time.perf_counter() - t_ref:.1f} s for {n_check} steps")
        correct, compared = checks(program, ref, workload["limits"], log,
                                   nonfinite_steps=sum(not f for f in finite))

        values = {}
        if trace:
            for m in metrics:
                value = load_plugin("metrics", m["name"]).read(r)
                if value is not None:
                    values[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            e2e = {"train_clips_per_s": r.steps * r.batch / window_s, "peak_device_gb": peak_bytes / 1e9,
                   "setup_s": setup_s}
            values = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in end_to_end}
        result = {"correct": correct, "attempted": len(finite), "failed": sum(not f for f in finite),
                  "metrics": values,
                  "device": {"memory_peak_bytes": int(peak_bytes)}}
        if trace:
            result["device"].update(busy_s=r.trace.busy_s, window_s=r.trace.window_s)
            result["breakdown"] = breakdown(r.trace, r.host_trace)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024      # Linux gives KiB
        log(f"host: peak resident set {rss / 1e9:.3f} GB")
        result["host"] = {"rss_peak_bytes": rss}
        result["checks"] = compared
        return result
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def breakdown(tr, host_tr) -> dict:
    """The ten device operations that took most time in the device-only
    pass, and the ten host activities under which the device sat idle
    longest (summed) in the step traced with the host, in s."""
    ops: dict[str, float] = {}
    for op in tr.ops:
        ops[op.name[:160]] = ops.get(op.name[:160], 0.0) + op.dur_ns / 1e9
    gaps: dict[str, float] = {}
    for name, ns in host_tr.gaps:
        gaps[name] = gaps.get(name, 0.0) + ns / 1e9
    top = sorted(ops.items(), key=lambda x: -x[1])[:10]
    idle = sorted(gaps.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle]}

