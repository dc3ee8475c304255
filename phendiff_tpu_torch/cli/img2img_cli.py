"""``python -m phendiff_tpu_torch.cli.img2img_cli`` -- the class-transfer
comparison app.

Counterpart of ``phendiff_tpu/cli/img2img_cli.py``: a YAML config selects
pipelines, dataset splits, transfer methods, per-method parameters and
metrics; the config file is copied into the output folder before the run
(``frozen_config.yaml``, with the resolved config beside it), so a queued
job sees the config it was given.  Runs on the card unless ``--device``
names another.

Usage:
    python -m phendiff_tpu_torch.cli.img2img_cli --config conf.yaml \\
        [--override key=value ...] [key=value ...] [--debug] [--device cpu]

``--override key=value ...`` is the JAX app's form, which the JAX
package's launcher (``build_command``) emits; bare ``key=value`` arguments
are taken too, after the flag's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
import sys

from phendiff_tpu_torch.experiments.comparison import ComparisonConfig, ComparisonExperiment
from phendiff_tpu_torch.obs.trackers import make_tracker


def apply_overrides(config: ComparisonConfig, overrides) -> ComparisonConfig:
    """Hydra-style ``key=value`` overrides of scalar (and comma-separated
    tuple) fields."""
    fields = {f.name for f in dataclasses.fields(ComparisonConfig)}
    kw = {}
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        if key not in fields:
            raise ValueError(f"unknown override key: {key}")
        current = getattr(config, key)
        if isinstance(current, bool):
            kw[key] = value.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            kw[key] = int(value)
        elif isinstance(current, float):
            kw[key] = float(value)
        elif isinstance(current, tuple):
            kw[key] = tuple(value.split(","))
        else:
            kw[key] = value
    return dataclasses.replace(config, **kw)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    p = argparse.ArgumentParser("phendiff-img2img-comparison")
    p.add_argument("--config", required=True, help="YAML comparison config")
    p.add_argument("overrides", nargs="*", help="key=value overrides of config fields")
    p.add_argument("--override", nargs="*", default=[], help="key=value overrides (the JAX "
                   "app's form)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    config = apply_overrides(ComparisonConfig.from_yaml(args.config),
                             args.override + args.overrides)
    if args.debug:
        config = dataclasses.replace(
            config, debug=True, num_inference_steps=10,
            metrics=dataclasses.replace(config.metrics, kid_subset_size=1),
        )

    os.makedirs(config.output_dir, exist_ok=True)
    shutil.copy(args.config, os.path.join(config.output_dir, "frozen_config.yaml"))
    with open(os.path.join(config.output_dir, "resolved_config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2, default=str)

    tracker = make_tracker("jsonl", config.output_dir)
    try:
        results = ComparisonExperiment(config, tracker=tracker, device=args.device).run()
    finally:
        tracker.finish()
    for k in sorted(results):
        print(f"{k}: {results[k]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
