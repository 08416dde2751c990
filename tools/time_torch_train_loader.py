"""Steady step time and loader wait of the PyTorch port's ``--task train``
on one GPU, for comparing two trees of the port on one card.

It runs the first training of ``chip_smoke.py``'s phase 13 with the
phase's own helpers, taken from the tree given: ten synthetic 1024x768
micrographs, ``--task prepare``, then ``--task train --rcnn 50 --augment
--max-iter STEPS`` (R50-FPN, the default config: 2 x 512² a step, bf16,
two loader workers), every ``train_step`` synchronised and timed and every
wait in ``next(loader)`` timed. It prints one line: the label, phase 13's
step statistics and the card's name and power limit.

    python3 tools/time_torch_train_loader.py --tree <checkout> --label <name> [--steps 40]

Run it in turns (parent, change, change, parent) in one call on the
card to compare two trees; each run needs a GPU and builds the port's
kernels of that tree.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="checkout of the repository whose port is timed")
    ap.add_argument("--label", required=True)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import yaml

    import chip_smoke as cs
    from deepemia_tpu_torch.config.config import default_config
    from deepemia_tpu_torch.kernels import _build

    assert os.path.dirname(os.path.abspath(cs.__file__)) == tree, cs.__file__
    _build.build(["roi_align_fwd", "roi_align_bwd"])
    shutil.rmtree(cs.DATASET_DIR, ignore_errors=True)
    home = os.path.join(cs.DATASET_DIR, "home")
    root = cs.synthetic_dataset(os.path.join(home, "DATASET", "sem"), cs.DATASET_IMAGES, cs.DATASET_HW)
    cfg = default_config(home)
    os.makedirs(os.path.join(home, "config"))
    with open(os.path.join(home, "config", "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    with open(cfg["paths"]["category_json"], "w") as f:
        json.dump({"sem": [root, root, ["particle", "pore"]]}, f)
    flags = ["--dataset_name", "sem", "--no-download", "--no-upload", "--device", "cuda", "--verbosity", "warning"]
    try:
        assert cs.run_cli(home, "--task", "prepare", *flags) == 0
        with cs.TrainRun("cuda") as run:
            t0 = time.perf_counter()
            rc = cs.run_cli(home, "--task", "train", "--rcnn", "50", "--augment", "--max-iter", str(args.steps),
                            *flags)
            wall = time.perf_counter() - t0
        assert rc == 0 and len(run.steps) == args.steps, (rc, len(run.steps))
        workers = cfg.get("train", {}).get("loader_workers", 2)
        print(f"{args.label}: {args.steps} steps, {workers} loader workers: {cs.step_stats(run, args.steps)}; "
              f"the task took {wall:.1f} s ({cs.card_line()})", flush=True)
    finally:
        shutil.rmtree(cs.DATASET_DIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
