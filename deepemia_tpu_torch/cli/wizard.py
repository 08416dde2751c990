"""Interactive wizard: the JAX package's menu-driven wrapper around the
command line (``deepemia_tpu/cli/wizard.py``) for the port.

    python -m deepemia_tpu_torch.cli.wizard

The same menus, prompts and defaults: setup, prepare, train, evaluate and
inference (its int8 prompt sets ``--quantized trunk|full``), and the
dataset-config create/view/edit/delete on the port's config store. Each
task runs ``python -m deepemia_tpu_torch.cli.main`` in a fresh interpreter
(``cli.task_command``), which holds the CUDA context for the task alone and
releases it when the task ends; the task runs on ``cuda``, the CLI's
default.
"""

from __future__ import annotations

import os
import subprocess
from typing import List

from deepemia_tpu_torch.cli import task_command
from deepemia_tpu_torch.config.config import get_store


def _input(prompt: str, default: str = "") -> str:
    raw = input(f"{prompt}{f' [{default}]' if default else ''}: ").strip()
    return raw or default


def get_user_choice(title: str, options: List[str]) -> int:
    """Numbered-menu selection."""
    print(f"\n{title}")
    for i, opt in enumerate(options, 1):
        print(f"  {i}. {opt}")
    while True:
        raw = input("Choice: ").strip()
        if raw.isdigit() and 1 <= int(raw) <= len(options):
            return int(raw) - 1
        print(f"Enter a number 1-{len(options)}")


def execute_command(argv: List[str]) -> int:
    """Run the port's CLI with ``argv`` in a subprocess -> its exit code."""
    cmd, env = task_command(argv)
    print(f"\nRunning: {' '.join(cmd)}\n")
    return subprocess.run(cmd, env=env).returncode


def _common_flags(task: str) -> List[str]:
    dataset = _input("Dataset name")
    argv = ["--task", task, "--dataset_name", dataset]
    verbosity = _input("Verbosity (debug/info/warning/error)", "info")
    argv += ["--verbosity", verbosity]
    return argv


def prepare_task() -> int:
    argv = _common_flags("prepare")
    fmt = _input("Dataset format (json/coco)", "json")
    argv += ["--dataset_format", fmt]
    return execute_command(argv)


def train_task() -> int:
    argv = _common_flags("train")
    rcnn = _input("Backbone (50/101/combo)", "101")
    argv += ["--rcnn", rcnn]
    if _input("Enable augmentation? (y/n)", "n").lower() == "y":
        argv.append("--augment")
    if _input("Run hyperparameter optimization? (y/n)", "n").lower() == "y":
        argv.append("--optimize")
        argv += ["--n-trials", _input("Number of trials", "10")]
    pretrained = _input("Pretrained weights to fine-tune from (path, empty = config/none)", "")
    if pretrained:
        argv += ["--pretrained-weights", pretrained]
    return execute_command(argv)


def evaluate_task() -> int:
    argv = _common_flags("evaluate")
    argv += ["--rcnn", _input("Backbone (50/101)", "101")]
    if _input("Save prediction overlays? (y/n)", "y").lower() == "y":
        argv.append("--visualize")
    return execute_command(argv)


def inference_task() -> int:
    argv = _common_flags("inference")
    thr = _input("Confidence threshold", "0.65")
    argv += ["--threshold", thr]
    if _input("Draw instance IDs on overlays? (y/n)", "n").lower() == "y":
        argv.append("--id")
    if _input("Debug scale bar detection? (y/n)", "n").lower() == "y":
        argv.append("--draw-scalebar")
    quant = _input("Int8 backbone serving (none/trunk/full)", "none").strip().lower()
    if quant in ("trunk", "full"):
        argv += ["--quantized", quant]
    return execute_command(argv)


def setup_task() -> int:
    return execute_command(["--task", "setup"])


def manage_dataset_configs() -> None:
    """Dataset-config CRUD on the port's config store."""
    store = get_store()
    while True:
        choice = get_user_choice(
            "Dataset configurations:",
            [
                "List configs",
                "View a config",
                "Create from template",
                "Edit a config (opens $EDITOR)",
                "Delete a config",
                "Back",
            ],
        )
        if choice == 0:
            configs = store.list_dataset_configs()
            print("\n".join(f"  - {c}" for c in configs) or "  (none)")
        elif choice == 1:
            name = _input("Config name")
            path = store.dataset_config_dir / f"{name}.yaml"
            print(path.read_text() if path.exists() else f"Not found: {path}")
        elif choice == 2:
            name = _input("New dataset name")
            template = _input("Template ('template' or existing name)", "template")
            try:
                print(f"Created: {store.create_dataset_config(name, template)}")
            except Exception as e:  # noqa: BLE001 - reported, the menu goes on
                print(f"Error: {e}")
        elif choice == 3:
            name = _input("Config name")
            path = store.dataset_config_dir / f"{name}.yaml"
            if not path.exists():
                print(f"Not found: {path}")
                continue
            editor = os.environ.get("EDITOR", "nano")
            subprocess.run([editor, str(path)])
            store.invalidate()
        elif choice == 4:
            name = _input("Config name to delete")
            path = store.dataset_config_dir / f"{name}.yaml"
            if path.exists() and _input(f"Really delete {path}? (y/n)", "n").lower() == "y":
                path.unlink()
                store.invalidate()
                print("Deleted.")
            else:
                print("Not deleted.")
        else:
            return


def main() -> None:
    """Top-level menu loop."""
    print("=" * 58)
    print(" deepEMIA interactive wizard")
    print("=" * 58)
    actions = {
        0: setup_task,
        1: prepare_task,
        2: train_task,
        3: evaluate_task,
        4: inference_task,
    }
    while True:
        choice = get_user_choice(
            "Main menu:",
            [
                "Setup (first-time configuration)",
                "Prepare dataset (split + register)",
                "Train models",
                "Evaluate models",
                "Run inference",
                "Manage dataset configs",
                "Exit",
            ],
        )
        if choice in actions:
            rc = actions[choice]()
            print(f"\nTask finished with exit code {rc}")
        elif choice == 5:
            manage_dataset_configs()
        else:
            print("Bye.")
            return


def cli_entry() -> None:
    try:
        main()
    except (KeyboardInterrupt, EOFError):
        print("\nInterrupted.")
        raise SystemExit(130)


if __name__ == "__main__":
    cli_entry()
