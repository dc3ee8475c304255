"""Job launcher: local runs, sweep expansion, optional SLURM submission.

Counterpart of ``phendiff_tpu/cli/launcher.py``, launching the port's
comparison app (``python -m phendiff_tpu_torch.cli.img2img_cli``):

* freezes the config into the experiment folder, then launches the
  comparison app on the frozen copy, one subprocess per run; with more
  than one visible card (``CUDA_VISIBLE_DEVICES`` narrows them, as
  ``devices=`` narrows the JAX mesh) the command is prefixed with
  ``python -m torch.distributed.run --standalone --nproc_per_node=<cards>``:
  one process a card, the counterpart of the JAX package's one process
  driving its whole mesh;
* offline environment (``WANDB_MODE=offline``, ``HF_DATASETS_OFFLINE=1``);
* sweep mode: a YAML grid ``{param: [values...]}`` expands into sequential
  runs, one ``--override`` set each;
* SLURM: writes an sbatch script (job name, time and qos by the debug flag,
  mail on failure) and submits it when ``sbatch`` exists.

Usage:
    python -m phendiff_tpu_torch.cli.launcher --config conf.yaml \\
        --experiment_dir exp/ [--sweep sweep.yaml] [--slurm] [--dry_run]
"""

from __future__ import annotations

import argparse
import itertools
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional

import torch


def expand_sweep(sweep: Dict[str, List[str]]) -> List[List[str]]:
    """{param: [v1, v2], ...} -> list of override lists (cartesian)."""
    keys = sorted(sweep)
    combos = itertools.product(*(sweep[k] for k in keys))
    return [[f"{k}={v}" for k, v in zip(keys, combo)] for combo in combos]


def build_command(config_path: str, overrides: List[str], debug: bool) -> List[str]:
    cmd = [sys.executable]
    cards = torch.cuda.device_count()
    if cards > 1:  # data parallelism: one process a visible card
        cmd += ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={cards}"]
    cmd += ["-m", "phendiff_tpu_torch.cli.img2img_cli", "--config", config_path]
    if overrides:
        cmd += ["--override", *overrides]
    if debug:
        cmd.append("--debug")
    return cmd


def sbatch_script(cmd: List[str], job_name: str, debug: bool,
                  mail: Optional[str]) -> str:
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={job_name}",
        f"#SBATCH --time={'0:30:00' if debug else '20:00:00'}",
        f"#SBATCH --qos={'qos_dev' if debug else 'qos_normal'}",
        "#SBATCH --ntasks=1",
    ]
    if mail:
        lines += [f"#SBATCH --mail-user={mail}", "#SBATCH --mail-type=FAIL"]
    lines += ["", " ".join(cmd), ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("phendiff-launcher")
    p.add_argument("--config", required=True)
    p.add_argument("--experiment_dir", required=True)
    p.add_argument("--sweep", default=None,
                   help="YAML file: {param: [values...]} grid")
    p.add_argument("--slurm", action="store_true")
    p.add_argument("--mail_user", default=None)
    p.add_argument("--offline", action="store_true", default=True)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)

    os.makedirs(args.experiment_dir, exist_ok=True)
    frozen = os.path.join(args.experiment_dir, "frozen_launch_config.yaml")
    shutil.copy(args.config, frozen)

    runs: List[List[str]] = [[]]
    if args.sweep:
        import yaml

        with open(args.sweep) as f:
            runs = expand_sweep(yaml.safe_load(f))

    env = dict(os.environ)
    if args.offline:
        env.setdefault("WANDB_MODE", "offline")
        env.setdefault("HF_DATASETS_OFFLINE", "1")

    for i, overrides in enumerate(runs):
        out_dir = os.path.join(args.experiment_dir, f"run_{i:03d}")
        cmd = build_command(frozen, overrides + [f"output_dir={out_dir}"], args.debug)
        if args.slurm:
            script = sbatch_script(cmd, f"phendiff_{i}", args.debug, args.mail_user)
            spath = os.path.join(args.experiment_dir, f"job_{i:03d}.sbatch")
            with open(spath, "w") as f:
                f.write(script)
            if shutil.which("sbatch") and not args.dry_run:
                subprocess.run(["sbatch", spath], check=True, env=env)
            else:
                print(f"[launcher] wrote {spath} (sbatch unavailable or dry run)")
            continue
        print(f"[launcher] run {i}: {' '.join(cmd)}")
        if args.dry_run:
            continue
        proc = subprocess.run(cmd, env=env)
        if proc.returncode != 0:
            raise RuntimeError(f"run {i} failed with code {proc.returncode}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
