"""Port parity: config composition against the JAX package's ``load_config``.

The port reads YAML with a reader of its own (the card's machine has no
``yaml``). Every file under ``configs/`` reads as ``yaml.safe_load`` reads
it, and each experiment composed with a table of overrides (YAML 1.1
typing: ``1e-4`` stays a string, ``1.0e-4`` is a float, ``yes`` is True,
``~`` is None; flow lists, quotes, ``${env:X,3}``, ``$SCRATCH_PATH``) gives
a tree equal to the JAX package's after interpolation. Exact equality: the
same Python values. YAML the reader does not take raises. The hparams
emitter writes what ``yaml.safe_dump`` writes.
"""

from pathlib import Path

import pytest
import yaml

from phantom_vlb_tpu.core import config as jconfig
from phantom_vlb_tpu_torch.core import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
YAML_FILES = sorted(CONFIGS.rglob("*.yaml"))
EXPERIMENTS = sorted(p.stem for p in (CONFIGS / "experiment").glob("*.yaml"))

OVERRIDES = {
    "none": [],
    "typed": ["optim.lr=1e-4", "optim.eps=1.0e-4", "trainer.resume=yes", "model.checkpoint_path=~",
              "datamodule.seasons=[s1]", "run_name='e2e # quoted'", "mesh.fsdp=-1",
              "optim.betas=[0.8, 0.99]", "model.base_quant=w8a8g8", "+extra.flag=off"],
    "env": ["output_dir=${env:PORT_CONFIG_TEST_X,3}", "datamodule.lazyload_path=$SCRATCH_PATH/f_s*.h5",
            "comet.workspace=${env:PORT_CONFIG_TEST_Y,ws}"],
    "cli": ["datamodule.batch_size=4", "datamodule.num_workers=2", "model.preset=tiny",
            "model.lora_r=4", "model.lora_alpha=8", "model.lora_dropout=0.0", "trainer.max_epochs=1",
            "trainer.val_check_interval=0.5", "trainer.log_every_n_steps=2", "optim.t_max=100",
            "output_dir=/tmp/out", "run_name=e2e", "mesh.fsdp=1"],
}


@pytest.mark.parametrize("path", YAML_FILES, ids=lambda p: str(p.relative_to(CONFIGS)))
def test_every_config_file_reads_as_pyyaml_reads_it(path):
    text = path.read_text()
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("overrides", list(OVERRIDES), ids=list(OVERRIDES))
@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_composed_config_matches_jax(experiment, overrides, monkeypatch):
    monkeypatch.setenv("SCRATCH_PATH", "/scratch/data")
    monkeypatch.delenv("PORT_CONFIG_TEST_X", raising=False)
    monkeypatch.setenv("PORT_CONFIG_TEST_Y", "from-env")
    args = [f"experiment={experiment}", "subject=sub-01", *OVERRIDES[overrides]]
    want = jconfig.load_config(CONFIGS, "base", args)
    got = tconfig.load_config(CONFIGS, "base", args)
    assert got == want
    assert isinstance(got, tconfig.Config) and got.datamodule.subject == "sub-01"
    if overrides == "typed":
        assert got.optim.lr == "1e-4" and got.optim.eps == 1e-4 and got.trainer.resume is True
        assert got.model.checkpoint_path is None and got.datamodule.seasons == ["s1"]
        assert got.run_name == "e2e # quoted" and got.extra.flag is False
    if overrides == "env":
        assert got.output_dir == 3 and got.comet.workspace == "from-env"
        assert got.datamodule.lazyload_path == "/scratch/data/f_s*.h5"
    # Unresolved trees agree too, and the hparams writer writes what
    # yaml.safe_dump writes.
    raw = tconfig.load_config(CONFIGS, "base", args, resolve_interpolations=False)
    assert raw == jconfig.load_config(CONFIGS, "base", args, resolve_interpolations=False)
    assert tconfig.dump_yaml(tconfig.to_dict(got)) == yaml.safe_dump(jconfig.to_dict(want))


SCALARS = ["1e-4", "1.0e-4", "1.0e4", "-1", "0x1F", "017", "09", "0b101", "1:30", "1_000", ".5",
           "-.inf", "yes", "No", "ON", "off", "~", "null", "", "True", "'q # x'", '"a\\tb"',
           "${env:X,3}", "$SCRATCH_PATH", "a b", "a,b", "http://x", "[s1, [s2, 's3']]", "[]",
           "- a", "foo#bar", "x: 1", "a:\n- 1\n- 2", "- a: 1\n  b: [2]\n- c", "k: v  # note"]


@pytest.mark.parametrize("text", SCALARS)
def test_values_typed_as_pyyaml_types_them(text):
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


UNSUPPORTED = ["&a x", "*a", "!!str x", "k: |\n  x", "k: >\n  x", "{a: 1}", "a: 1\n---\nb: 2",
               "a: b\n  c", "2001-12-14", "k: 'x\n  y'", "k: [a,\n  b]", "[a: b]", "a:\n\tb: 1"]


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_unsupported_yaml_raises(text):
    with pytest.raises(tconfig.YAMLSubsetError):
        tconfig.parse_yaml(text)


def test_interpolation_errors_and_instantiate(tmp_path, monkeypatch):
    (tmp_path / "base.yaml").write_text("a: ${env:PORT_CONFIG_UNSET}\n")
    monkeypatch.delenv("PORT_CONFIG_UNSET", raising=False)
    with pytest.raises(KeyError, match="PORT_CONFIG_UNSET"):
        tconfig.load_config(tmp_path)
    (tmp_path / "base.yaml").write_text("a: ${b}\nb: ${a}\n")
    with pytest.raises(RecursionError):
        tconfig.load_config(tmp_path)
    with pytest.raises(ValueError, match="key=value"):
        tconfig.load_config(CONFIGS, overrides=["experiment"])
    node = tconfig.parse_yaml("_target_: fractions.Fraction\nnumerator: 3\ndenominator: 4\n")
    assert tconfig.instantiate(node) == jconfig.instantiate(node)
