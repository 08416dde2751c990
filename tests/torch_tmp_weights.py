"""The port's tests write model weights and training checkpoints (~150-350
MB a file) into their temporary directories. pytest keeps the temporary
directories of the last three runs, and ``--task train`` refuses to start
on a filesystem with less than 5 GB free
(``deepemia_tpu_torch/train/workflow.py:check_disk_space``), so a test run
that follows two others could fail the training tests for the weights the
earlier runs left. A test module that writes weights imports
:func:`drop_weights`, which removes them from the test's ``tmp_path`` when
the test ends (passed or failed); the other files stay for inspection."""

from pathlib import Path

import pytest

WEIGHT_SUFFIXES = (".pt", ".pth", ".pkl")


def remove_weights(root) -> None:
    """Deletes every weight or checkpoint file under ``root``."""
    for path in Path(root).rglob("*"):
        if path.suffix in WEIGHT_SUFFIXES and path.is_file():
            path.unlink()


@pytest.fixture(autouse=True)
def drop_weights(tmp_path):
    yield
    remove_weights(tmp_path)
