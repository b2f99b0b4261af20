"""The port's presets against the JAX package's composed YAML of the same
name, key for key after the package-name mapping; its config groups against
the JAX group files and against a JAX tree whose defaults select them;
overrides parse as the JAX CLI parses them."""

import shutil

import pytest

from pipelinerl_tpu.config import _parse_scalar, compose as j_compose
from pipelinerl_tpu_torch import presets
from pipelinerl_tpu_torch.config import Config, compose, parse_value


def renamed(node):
    if isinstance(node, dict):
        return {k: renamed(v) for k, v in node.items()}
    if isinstance(node, list):
        return [renamed(v) for v in node]
    if isinstance(node, str):
        return node.replace("pipelinerl_tpu.", "pipelinerl_tpu_torch.")
    return node


@pytest.mark.parametrize("name", presets.names())
@pytest.mark.parametrize("resolve", [False, True])
def test_preset_equals_jax_compose(name, resolve):
    overrides = ["output_dir=/tmp/x"] if resolve else []
    ours = compose(name, overrides, resolve=resolve).to_dict()
    theirs = renamed(j_compose("conf", name, overrides, resolve=resolve).to_dict())
    assert ours == theirs


@pytest.mark.parametrize("name", presets.group_names("finetune"))
def test_finetune_group_equals_jax_group_file(name):
    ours = presets.group_preset("finetune", name).to_dict()
    assert ours == renamed(j_compose("conf/finetune", name, resolve=False).to_dict())


@pytest.mark.parametrize("name", presets.group_names("finetune"))
def test_group_override_equals_jax_defaults_entry(name, tmp_path):
    """``finetune=<name>`` composes as a JAX tree whose ``base.yaml`` takes
    ``finetune: <name>`` in its defaults: the group's entry first, then
    every preset body over it."""
    conf = tmp_path / "conf"
    shutil.copytree("conf", conf)
    base = (conf / "base.yaml").read_text()
    assert "  - finetune: base\n" in base
    (conf / "base.yaml").write_text(base.replace("  - finetune: base\n", f"  - finetune: {name}\n"))
    overrides = ["output_dir=/tmp/x", "finetune.max_train_steps=20"]
    ours = compose("bandit_tpu", [f"finetune={name}", *overrides]).to_dict()
    assert ours == renamed(j_compose(str(conf), "bandit_tpu", overrides).to_dict())
    with pytest.raises(KeyError):
        compose("bandit_tpu", ["finetune=nope"])


@pytest.mark.parametrize("name", presets.group_names("rewards"))
def test_rewards_group_equals_jax_group_file_and_defaults_entry(name, tmp_path):
    """The ``rewards`` group's entries against the JAX group files, and a
    ``rewards=<name>`` override against a JAX tree whose ``base.yaml`` takes
    ``rewards: <name>`` in its defaults."""
    assert presets.group_preset("rewards", name).to_dict() == j_compose("conf/rewards", name, resolve=False).to_dict()
    conf = tmp_path / "conf"
    shutil.copytree("conf", conf)
    base = (conf / "base.yaml").read_text()
    assert "  - rewards: base\n" in base
    (conf / "base.yaml").write_text(base.replace("  - rewards: base\n", f"  - rewards: {name}\n"))
    overrides = ["output_dir=/tmp/x", "model_path=/tmp/m"]
    ours = compose("math", [f"rewards={name}", *overrides]).to_dict()
    assert ours == renamed(j_compose(str(conf), "math", overrides).to_dict())


@pytest.mark.parametrize(
    "text",
    ["1", "-3", "1e-5", "4e-3", ".5", "0.25", "true", "False", "null", "~", "yes", "off", "[test]",
     "[a, b]", "[1, 2]", "[]", '"quoted"', "plain", "pipelinerl_tpu_torch.domains.bandit.load_problems",
     "gqa", "bfloat16", "", "[{hostname: 127.0.0.1, port: 7777}, {hostname: h1, port: 7778}]", "{a: 1, b: [x, y]}",
     "[[1, 2], [a, {k: v}]]", "{}"],
)
def test_override_values_parse_as_the_jax_cli(text):
    assert parse_value(text) == _parse_scalar(text)


def test_overrides_interpolation_and_access():
    cfg = compose("bandit_tpu", ["output_dir=/tmp/r", "finetune.samples_per_step=32", "+new.key=7",
                                 "engine.attn_impl=gqa"])
    assert cfg.finetune.weight_update_interval == 32  # ${finetune.samples_per_step}
    assert cfg.finetune.rl.temperature == 1.0  # ${llm.parameters.temperature}
    assert cfg.select("new.key") == 7 and cfg.engine.attn_impl == "gqa"
    assert cfg.get("absent", 3) == 3 and cfg.select("a.b.c") is None
    c = Config({"a": {"b": 1}})
    c.merge({"a": {"c": 2}})
    c.set_dotted("d.e", [1])
    assert c.to_dict() == {"a": {"b": 1, "c": 2}, "d": {"e": [1]}}
    with pytest.raises(KeyError):
        compose("nope")
