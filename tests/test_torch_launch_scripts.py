"""The ``scripts/*_torch.sh`` launch scripts against the JAX package's.

Each pair runs with stub ``python`` and ``torchrun`` executables first on
``PATH``; a stub records its name, argv and environment and does nothing
else, except a stub trainer run under ``STUB_METRICS``, which writes the
metrics directory the port's trainer would write for its config
(``load_config`` and ``CSVMetricsLogger`` of the port:
``<output_dir>/<run_name>/version_0``).
The port's script must make the calls of the JAX one with
``phantom_vlb_tpu.`` become ``phantom_vlb_tpu_torch.``, the trainers
launched by ``torchrun --standalone --nproc_per_node=$NPROC`` (1 by
default) in place of ``python``, in the same environment: the scripts'
own defaults, nothing more (``VLB_NCCL_MULTI_CARD`` is the caller's to
set, and passes through when it does).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
SUBJECT = "sub-01"
# Each script's arguments (a trainer's, a subject and an override).
CASES = {
    "extract_features": ["s1"],
    "build_lazyload": [SUBJECT, "s2"],
    "train_baseline": [SUBJECT, "trainer.max_epochs=1"],
    "train_lora": [SUBJECT, "trainer.max_epochs=1"],
    "train_all_subjects": ["trainer.max_epochs=1"],       # over SUBJECTS, 2 of them here
    "make_brainmaps": [SUBJECT, "results/metrics"],
}
TRAIN = "phantom_vlb_tpu_torch.cli.train"

STUB = """#!{python}
import json, os, sys
argv = sys.argv[1:]
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps({{"prog": os.path.basename(sys.argv[0]), "argv": argv, "env": dict(os.environ)}}) + "\\n")
module = argv[argv.index("-m") + 1] if "-m" in argv else ""
if module.endswith(".cli.train") and os.environ.get("STUB_METRICS"):
    sys.path.insert(0, {root!r})
    from phantom_vlb_tpu_torch.core.config import load_config
    from phantom_vlb_tpu_torch.train.metrics import CSVMetricsLogger
    overrides = [a for a in argv[argv.index("-m") + 2:] if "=" in a]
    config = load_config({configs!r}, "base", overrides)
    CSVMetricsLogger(str(config.output_dir), str(config.run_name)).log_metrics({{"val_corr_avg": 0.5}}, 1, 0)
"""


@pytest.fixture
def stubs(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("python", "torchrun"):
        path = bin_dir / name
        path.write_text(STUB.format(python=sys.executable, root=str(ROOT), configs=str(ROOT / "configs")))
        path.chmod(0o755)
    return bin_dir


def run_script(name: str, args: list, stubs: Path, work: Path, **env) -> list[dict]:
    """``scripts/<name>.sh args`` from ``work`` with the stubs first on
    PATH and a bare environment plus ``env``; the stubs' calls in order."""
    work.mkdir(parents=True, exist_ok=True)
    log = work / "calls.jsonl"
    base = {"PATH": f"{stubs}:/usr/bin:/bin", "HOME": str(work), "STUB_LOG": str(log),
            "SUBJECTS": "sub-01 sub-02", **env}
    proc = subprocess.run(["bash", str(SCRIPTS / f"{name}.sh"), *args], cwd=work, env=base,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return [json.loads(line) for line in log.read_text().splitlines()]


def as_port(call: dict, nproc: str = "1") -> tuple[str, list]:
    """A JAX script's call as the port's script should make it."""
    argv = [a.replace("phantom_vlb_tpu.", "phantom_vlb_tpu_torch.") for a in call["argv"]]
    if argv[:2] == ["-m", TRAIN]:
        return "torchrun", ["--standalone", f"--nproc_per_node={nproc}", *argv]
    return call["prog"], argv


def _env(call: dict) -> dict:
    return {k: v for k, v in call["env"].items() if k not in ("_", "SHLVL", "PWD", "OLDPWD")}


@pytest.mark.parametrize("name", list(CASES))
def test_port_script_makes_the_jax_scripts_calls(name, stubs, tmp_path):
    want = run_script(name, CASES[name], stubs, tmp_path / "jax")
    got = run_script(f"{name}_torch", CASES[name], stubs, tmp_path / "port")
    assert want and len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["prog"], g["argv"]) == as_port(w)
        env_g, env_w = _env(g), _env(w)
        env_w["HOME"], env_w["STUB_LOG"] = env_g["HOME"], env_g["STUB_LOG"]
        assert env_g == env_w and "VLB_NCCL_MULTI_CARD" not in env_g


@pytest.mark.parametrize("name", ["train_baseline", "train_lora", "train_all_subjects"])
def test_trainers_take_nproc_and_pass_the_callers_opt_in_through(name, stubs, tmp_path):
    calls = run_script(f"{name}_torch", CASES[name], stubs, tmp_path, NPROC="4", VLB_NCCL_MULTI_CARD="1")
    trains = [c for c in calls if TRAIN in c["argv"]]
    assert trains and all(c["prog"] == "torchrun" for c in trains)
    assert all(c["argv"][:4] == ["--standalone", "--nproc_per_node=4", "-m", TRAIN] for c in trains)
    assert all(c["env"]["VLB_NCCL_MULTI_CARD"] == "1" for c in calls)


def test_all_subjects_maps_the_metrics_of_each_run(stubs, tmp_path):
    """Each subject's stub run writes its metrics where the port's trainer
    would; brainmaps is then run on that directory."""
    calls = run_script("train_all_subjects_torch", ["trainer.max_epochs=1"], stubs, tmp_path,
                       SUBJECTS="sub-01 sub-03", EXPERIMENT="vlb_friends_baseline", STUB_METRICS="1")
    assert [c["prog"] for c in calls] == ["torchrun", "python"] * 2
    for subject, (train, maps) in zip(("sub-01", "sub-03"), (calls[0:2], calls[2:4])):
        assert train["argv"][-3:] == ["experiment=vlb_friends_baseline", f"subject={subject}", "trainer.max_epochs=1"]
        metrics = maps["argv"][maps["argv"].index("--metrics_path") + 1]
        assert maps["argv"][:2] == ["-m", "phantom_vlb_tpu_torch.cli.brainmaps"]
        assert (tmp_path / metrics / "metrics.csv").is_file()
        assert Path(os.path.normpath(tmp_path / metrics)).relative_to(tmp_path) == Path(
            "results/videollama2/brain_finetune/friends/tpu_ckpt/baseline", subject,
            f"vllama2_vlb_friends_baseline_{subject}", "version_0")
        assert maps["argv"][-2:] == ["--out_path", f"./results/brainmaps/{subject}"]
