"""The port's interactive wizard (``deepemia_tpu_torch/cli/wizard.py``)
against the JAX package's (``deepemia_tpu/cli/wizard.py``): for each task,
the same scripted answers give the same command line, once the JAX
wizard's ``[python, main.py]`` maps to the port's ``[python, -m,
deepemia_tpu_torch.cli.main]`` (``subprocess.run`` stubbed in both); the
dataset-config create, view, edit and delete give the same files and the
same output in two homes; and ``python -m deepemia_tpu_torch.cli.wizard``
started from another directory runs the port's CLI, on ``cuda`` by
default."""

import builtins
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deepemia_tpu.config.config as jax_cfg
import deepemia_tpu_torch.config.config as port_cfg
from deepemia_tpu.cli import wizard as jax_wizard
from deepemia_tpu_torch.cli import wizard as port_wizard

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_PREFIX = [sys.executable, "-m", "deepemia_tpu_torch.cli.main"]


def _drive(fn, answers):
    """Run ``fn()`` with ``input`` answering from ``answers`` and
    ``subprocess.run`` recorded -> (the commands run, their environments)."""
    it = iter(answers)
    runs = []

    def fake_run(cmd, **kw):
        runs.append((list(cmd), kw.get("env")))
        return subprocess.CompletedProcess(cmd, 0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(builtins, "input", lambda prompt="": next(it))
        mp.setattr(subprocess, "run", fake_run)
        fn()
    assert next(it, None) is None, "answers left over"
    return runs


# (menu entry, answers after it): each task's prompts with defaults taken
# ("") and given; "5" is "Run inference", "7" is "Exit"
TASKS = [
    ("1", []),
    ("2", ["ds1", "", ""]),
    ("2", ["ds1", "debug", "coco"]),
    ("3", ["ds1", "", "", "", "", ""]),
    ("3", ["ds_2", "warning", "50", "y", "y", "4", "weights/zoo.pkl"]),
    ("3", ["ds-3", "", "combo", "n", "y", "", ""]),
    ("4", ["ds1", "", "", ""]),
    ("4", ["ds1", "error", "50", "n"]),
    ("5", ["ds1", "", "", "", "", ""]),
    ("5", ["ds1", "info", "0.4", "y", "y", "trunk"]),
    ("5", ["ds1", "", "0.9", "n", "y", "FULL"]),
    ("5", ["ds1", "", "", "", "", "bogus"]),
]


@pytest.mark.parametrize("entry, answers", TASKS)
def test_task_argv_matches_jax(monkeypatch, tmp_path, entry, answers):
    monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(tmp_path / "home"))
    script = [entry, *answers, "7"]
    jax_runs = _drive(jax_wizard.main, script)
    port_runs = _drive(port_wizard.main, script)
    assert len(jax_runs) == len(port_runs) == 1
    (jax_cmd, _), (port_cmd, env) = jax_runs[0], port_runs[0]
    assert jax_cmd[0] == sys.executable and Path(jax_cmd[1]).name == "main.py"
    assert port_cmd == PORT_PREFIX + jax_cmd[2:]
    assert "--device" not in port_cmd  # the CLI's default: cuda
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)


def test_task_command_keeps_the_callers_path(monkeypatch):
    from deepemia_tpu_torch.cli import task_command

    monkeypatch.setenv("PYTHONPATH", "elsewhere/site")
    cmd, env = task_command(["--task", "setup"])
    assert cmd == PORT_PREFIX + ["--task", "setup"]
    assert env["PYTHONPATH"] == os.pathsep.join([str(ROOT), "elsewhere/site"])
    monkeypatch.delenv("PYTHONPATH")
    assert task_command([])[1]["PYTHONPATH"] == str(ROOT)


# Manage dataset configs ("6"): list, create from the template, create from
# an existing config, view, a missing view, edit ($EDITOR stubbed), a
# refused and an accepted delete, a bad template, list, back, exit
CRUD = [
    "6", "1",
    "3", "wizds", "",
    "3", "copyds", "wizds",
    "2", "copyds",
    "2", "nosuch",
    "4", "wizds",
    "5", "wizds", "n",
    "5", "copyds", "y",
    "3", "bad", "missing_template",
    "1", "6", "7",
]


def _crud(monkeypatch, capsys, wizard, cfg_mod, home):
    monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(home))
    monkeypatch.setenv("EDITOR", "true")
    cfg_mod._default_store = None
    runs = _drive(wizard.main, CRUD)
    cfg_mod._default_store = None
    out = capsys.readouterr().out.replace(str(home), "<HOME>").replace("deepEMIA-TPU", "deepEMIA")
    files = {p.relative_to(home / "config" / "datasets").as_posix(): p.read_text()
             for p in sorted((home / "config" / "datasets").rglob("*")) if p.is_file()}
    return out, files, runs


def test_dataset_config_crud_matches_jax(monkeypatch, capsys, tmp_path):
    jax_out, jax_files, jax_runs = _crud(monkeypatch, capsys, jax_wizard, jax_cfg, tmp_path / "jax")
    port_out, port_files, port_runs = _crud(monkeypatch, capsys, port_wizard, port_cfg, tmp_path / "port")
    assert port_files == jax_files and set(port_files) == {"wizds.yaml"}
    assert port_out == jax_out
    for want in ("Created: <HOME>/config/datasets/wizds.yaml", "Not found: <HOME>/config/datasets/nosuch.yaml",
                 "Not deleted.", "Deleted.", "Error: Template not found", "  - wizds"):
        assert want in port_out, want
    assert [c[0] for c, _ in port_runs] == [c[0] for c, _ in jax_runs] == ["true"]


def test_wizard_runs_the_port_cli_from_any_directory(tmp_path):
    """The wizard's child finds the package whatever the working directory,
    and runs on ``cuda`` (no ``--device`` asked): on a host without a card
    the CLI's preflight refuses, and the wizard reports its exit code."""
    home = tmp_path / "home"
    env = {**os.environ, "DEEPEMIA_TPU_HOME": str(home), "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "deepemia_tpu_torch.cli.wizard"],
        input="5\nds1\n\n\n\n\n\n7\n", text=True, capture_output=True, cwd=tmp_path, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Running: " + " ".join(PORT_PREFIX) + " --task inference --dataset_name ds1" in proc.stdout
    assert "Task finished with exit code 1" in proc.stdout and "Bye." in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_interrupted_wizard_exits_130(tmp_path):
    env = {**os.environ, "DEEPEMIA_TPU_HOME": str(tmp_path / "home"), "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-m", "deepemia_tpu_torch.cli.wizard"], input="", text=True,
                          capture_output=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 130 and "Interrupted." in proc.stdout
