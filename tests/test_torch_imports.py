"""The port stands alone: importing every module of ``phendiff_tpu_torch``
(and ``chip_smoke.py``) loads neither ``jax`` nor ``phendiff_tpu`` nor
``triton``, no source imports the root ``tools/`` scripts, no kernel is
built, and entry points default to the card.  The
build directory may hold the native loader library (host C++, built by the
CPU tests that read images), never a CUDA kernel library without a card."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN_CHECK = textwrap.dedent("""
    import importlib, pkgutil, sys
    import phendiff_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(phendiff_tpu_torch.__path__,
                                                   "phendiff_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "phendiff_tpu", "triton"))
    print(len(names), bad)
    missing = [m for m in NEW_MODULES if m not in names]
    print("missing", missing)
    sys.exit(1 if bad or missing or len(names) < 15 else 0)
""")
# The training, comparison, SD, serving, data-parallel, round-trip and tensor-parallel
# slices' modules, each checked by name above.
NEW_MODULES = [
    "phendiff_tpu_torch.train.train_loop", "phendiff_tpu_torch.train.ema",
    "phendiff_tpu_torch.train.checkpoints", "phendiff_tpu_torch.train.trainer",
    "phendiff_tpu_torch.data.native", "phendiff_tpu_torch.data.imagefolder",
    "phendiff_tpu_torch.obs.trackers", "phendiff_tpu_torch.obs.profiling",
    "phendiff_tpu_torch.tools.bench_gn_moments", "phendiff_tpu_torch.tools.ddib_batch_gap",
    "phendiff_tpu_torch.metrics.fidelity", "phendiff_tpu_torch.metrics.inception",
    "phendiff_tpu_torch.experiments.comparison", "phendiff_tpu_torch.cli.img2img_cli",
    "phendiff_tpu_torch.train.eval_loop", "phendiff_tpu_torch.obs.images",
    "phendiff_tpu_torch.models.sd_unet", "phendiff_tpu_torch.models.autoencoder_kl",
    "phendiff_tpu_torch.models.hf_import", "phendiff_tpu_torch.pipelines.sd_img2img",
    "phendiff_tpu_torch.serving.engine", "phendiff_tpu_torch.data.hf_datasets",
    "phendiff_tpu_torch.parallel", "phendiff_tpu_torch.parallel.mesh",
    "phendiff_tpu_torch.parallel.tp", "phendiff_tpu_torch.tools.reco_err",
    "phendiff_tpu_torch.tools.make_toy_dataset", "phendiff_tpu_torch.tools.trained_round_trip",
]


def _run(code, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120, **kw)


def test_import_every_module_without_jax():
    proc = _run(_FORBIDDEN_CHECK.replace("NEW_MODULES", repr(NEW_MODULES)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    from phendiff_tpu_torch.ops._build import BUILD, KERNELS

    kernel_libs = [f for name in KERNELS for f in BUILD.glob(f"lib{name}-*.so")]
    assert not kernel_libs or torch.cuda.is_available()


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    os.path.join(d, f)
    for d, _, files in os.walk(os.path.join(ROOT, "phendiff_tpu_torch"))
    for f in files if f.endswith(".py")
))
def test_sources_never_import_jax(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "flax", "phendiff_tpu", "tools"), (
                path, m)


def test_entry_points_default_to_cuda():
    from phendiff_tpu_torch.core.device import resolve_device
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig, make_schedule

    if torch.cuda.is_available():
        assert make_schedule(SchedulerConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_schedule(SchedulerConfig())
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert make_schedule(SchedulerConfig(), device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
