"""The port's configuration store against the JAX package's: every scenario
of tests/test_config.py run through both stores on separate homes must give
equal merged dicts (home paths aside), the default ``config.yaml`` must be
byte-equal, and without PyYAML the port must name the file it cannot read."""

import subprocess
import sys
from pathlib import Path

import pytest
import yaml

import deepemia_tpu.config.config as jax_cfg
import deepemia_tpu_torch.config.config as port_cfg
from deepemia_tpu.config.schema import validate_config as jax_validate
from deepemia_tpu.utils.exceptions import ConfigurationError as JaxConfigurationError
from deepemia_tpu_torch.config.schema import CONFIG_SCHEMA, validate_config
from deepemia_tpu_torch.utils.exceptions import ConfigurationError

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def homes(tmp_path, monkeypatch):
    """(JAX home, port home), with both packages' cached stores reset."""
    jax_cfg._default_store = None
    port_cfg._default_store = None
    monkeypatch.delenv("DEEPEMIA_TPU_HOME", raising=False)
    yield tmp_path / "jax_home", tmp_path / "port_home"
    jax_cfg._default_store = None
    port_cfg._default_store = None


def _norm(value, home):
    """``value`` with the home directory replaced by a marker."""
    if isinstance(value, dict):
        return {k: _norm(v, home) for k, v in value.items()}
    if isinstance(value, list):
        return [_norm(v, home) for v in value]
    if isinstance(value, str):
        return value.replace(str(home), "<HOME>")
    return value


def _stores(homes):
    jax_home, port_home = homes
    return jax_cfg.ConfigStore(jax_home), port_cfg.ConfigStore(port_home)


def _both_equal(a, b, homes):
    assert _norm(a, homes[0]) == _norm(b, homes[1])


def _write_dataset_yaml(store, name, text):
    d = store.dataset_config_dir
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.yaml").write_text(text)
    store.invalidate()


def _spec(field):
    """A schema node as plain data (the two packages' Field classes differ)."""
    if isinstance(field, dict):
        return {k: _spec(v) for k, v in field.items()}
    return (
        field.types, field.required, field.default,
        _spec(field.children) if field.children is not None else None,
        _spec(field.wildcard_child) if field.wildcard_child is not None else None,
    )


def test_schema_and_defaults_are_the_jax_packages():
    from deepemia_tpu.config.schema import CONFIG_SCHEMA as JAX_SCHEMA

    assert _spec(CONFIG_SCHEMA) == _spec(JAX_SCHEMA)
    home = Path("/nonexistent/home")
    assert port_cfg.default_config(home) == jax_cfg.default_config(home)
    assert port_cfg.DATASET_TEMPLATE == jax_cfg.DATASET_TEMPLATE
    assert validate_config(port_cfg.default_config(home), create_dirs=False) == jax_validate(
        jax_cfg.default_config(home), create_dirs=False
    )


def test_default_config_file_is_byte_equal(tmp_path):
    home = tmp_path / "home"
    jax_store = jax_cfg.ConfigStore(home)
    ref_cfg = jax_store.load()
    ref_bytes = jax_store.config_path.read_bytes()
    jax_store.config_path.unlink()
    store = port_cfg.ConfigStore(home)
    cfg = store.load()
    assert store.config_path.read_bytes() == ref_bytes
    assert cfg == ref_cfg
    assert cfg["inference_settings"]["tile_settings"]["tile_size"] == 512
    assert cfg["rcnn_hyperparameters"]["default"]["R50"]["base_lr"] == 0.00025


DATASET_YAML = yaml.safe_dump(
    {
        "inference_overrides": {
            "class_specific_settings": {"class_0": {"confidence_threshold": 0.9}},
            "tile_settings": {"upscale_factor": 3.5},
        },
        "scale_bar_roi": {"x_start_factor": 0.5},
        "scalebar_thresholds": {"intensity": 55},
        "spatial_constraints": {"enabled": True, "containment_rules": []},
        "rcnn_hyperparameters": {"best_R50": {"base_lr": 0.001}},
    }
)


def test_dataset_override_channels(homes):
    stores = _stores(homes)
    for s in stores:
        s.load()
        _write_dataset_yaml(s, "mydata", DATASET_YAML)
    ref, got = (s.get("mydata") for s in stores)
    _both_equal(ref, got, homes)
    inf = got["inference_settings"]
    assert inf["class_specific_settings"]["class_0"] == {
        **got["inference_settings"]["class_specific_settings"]["class_0"],
        "confidence_threshold": 0.9,
        "iou_threshold": 0.7,
    }
    assert inf["tile_settings"]["upscale_factor"] == 3.5 and inf["tile_settings"]["tile_size"] == 512
    assert got["scale_bar_rois"]["mydata"]["x_start_factor"] == 0.5
    assert got["scalebar_thresholds"] == {**got["scalebar_thresholds"], "intensity": 55, "merge_gap": 15}
    assert inf["spatial_constraints"]["mydata"]["enabled"] is True
    assert got["rcnn_hyperparameters"]["best"]["R50"]["base_lr"] == 0.001
    # the base stays untouched
    _both_equal(stores[0].get(), stores[1].get(), homes)
    assert stores[1].get()["inference_settings"]["class_specific_settings"]["class_0"]["confidence_threshold"] == 0.5


def test_unknown_dataset_returns_base(homes):
    for s in _stores(homes):
        assert s.get("nope") == s.get()
    ref, got = (s.get("nope") for s in _stores(homes))
    _both_equal(ref, got, homes)


def test_create_dataset_config_from_template(homes):
    stores = _stores(homes)
    paths = [s.create_dataset_config("newds") for s in stores]
    assert paths[0].read_text() == paths[1].read_text()
    assert yaml.safe_load(paths[1].read_text())["metadata"]["name"] == "newds"
    assert [s.list_dataset_configs() for s in stores] == [["newds"], ["newds"]]
    copies = [s.create_dataset_config("other", template="newds") for s in stores]
    assert copies[0].read_text() == copies[1].read_text()
    assert 'name: "other"' in copies[1].read_text()
    with pytest.raises(ConfigurationError, match="Template not found"):
        stores[1].create_dataset_config("third", template="missing")


@pytest.mark.parametrize(
    "path, value",
    [(("scalebar_thresholds", "intensity"), "high"), (("performance", "use_bf16"), 1), (("inference_settings", "mask_threshold"), True)],
)
def test_validation_rejects_bad_types(path, value):
    cfg = port_cfg.default_config()
    cfg[path[0]][path[1]] = value
    with pytest.raises(JaxConfigurationError):
        jax_validate(cfg, create_dirs=False)
    with pytest.raises(ConfigurationError, match=".".join(path)):
        validate_config(cfg, create_dirs=False)


def test_validation_fills_defaults():
    raw = {"paths": {"split_dir": "/tmp/x", "category_json": "/tmp/y.json"}}
    out = validate_config(raw, create_dirs=False)
    assert out == jax_validate(raw, create_dirs=False)
    assert out["scalebar_thresholds"]["intensity"] == 100
    assert out["inference_settings"]["tile_settings"]["tile_size"] == 512
    # keys that default_config() lacks, which the pipeline reads
    assert out["inference_settings"]["postprocessing"] == {
        "enabled": True, "min_size_small": 0, "min_size_large": 0, "size_heuristic_sample": 5,
    }
    assert out["inference_settings"]["mask_threshold"] == 0.5
    assert out["performance"]["measurement_backend"] == "host"
    assert out["train"]["steps_per_dispatch"] == 8
    with pytest.raises(ConfigurationError, match="paths.split_dir"):
        validate_config({"paths": {"category_json": "/tmp/y.json"}}, create_dirs=False)


def _via_get_config(monkeypatch, homes, text, name):
    """(JAX, port) ``get_config(name)`` with ``text`` as the dataset YAML,
    each package on its own home through DEEPEMIA_TPU_HOME."""
    out = []
    for mod, home in ((jax_cfg, homes[0]), (port_cfg, homes[1])):
        monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(home))
        _write_dataset_yaml(mod.get_store(), name, text)
        out.append(mod.get_config(name))
    return out


def test_dataset_config_direct_inference_settings_merge(homes, monkeypatch):
    ref, got = _via_get_config(
        monkeypatch, homes,
        "inference_settings:\n  tile_settings:\n    tile_size: 128\n    tile_batch_size: 4\n"
        "performance:\n  inference_chips: 2\n",
        "dsx",
    )
    _both_equal(ref, got, homes)
    ts = got["inference_settings"]["tile_settings"]
    assert (ts["tile_size"], ts["tile_batch_size"], ts["overlap_ratio"]) == (128, 4, 0.1)
    assert got["performance"]["inference_chips"] == 2


def test_dataset_train_section_merges(homes, monkeypatch):
    ref, got = _via_get_config(
        monkeypatch, homes,
        "train:\n  pretrained_weights:\n    R50: /zoo/r50.pkl\n  resize_mode: range\n  grad_clip_norm: 1.0\n",
        "dstrain",
    )
    _both_equal(ref, got, homes)
    assert got["train"]["pretrained_weights"] == {"R50": "/zoo/r50.pkl", "R101": ""}
    assert (got["train"]["resize_mode"], got["train"]["train_size"], got["train"]["grad_clip_norm"]) == ("range", 512, 1.0)


def test_store_follows_the_home(homes, monkeypatch):
    """``get_store`` caches per home and is remade when the home changes."""
    monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(homes[1]))
    first = port_cfg.get_store()
    assert port_cfg.get_store() is first and first.home == homes[1]
    monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(homes[0]))
    assert port_cfg.get_store().home == homes[0]


def test_without_pyyaml_loading_names_the_file(homes, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    store = port_cfg.ConfigStore(homes[1])
    with pytest.raises(ConfigurationError, match=r"config\.yaml.*'yaml'"):
        store.load()
    monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(homes[1]))
    with pytest.raises(ConfigurationError, match=r"config\.yaml.*PyYAML"):
        port_cfg.get_config("smoke")


def test_modules_import_without_pyyaml():
    code = (
        "import sys; sys.modules['yaml'] = None; "
        "import deepemia_tpu_torch, deepemia_tpu_torch.config.config, deepemia_tpu_torch.inference.pipeline, "
        "deepemia_tpu_torch.inference.scalebar, deepemia_tpu_torch.inference.ensemble; "
        "from deepemia_tpu_torch.config.config import default_config; "
        "from deepemia_tpu_torch.config.schema import validate_config; "
        "validate_config(default_config('/nonexistent'), create_dirs=False)"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
