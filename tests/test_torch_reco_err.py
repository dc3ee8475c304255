"""The trained-model round trip's tools: ``phendiff_tpu_torch/tools/reco_err.py``
against ``tools/reco_err.py``, and the two ``make_toy_dataset`` copies.

A tiny JAX pipeline (8 px, 2 classes) is saved by the JAX package and
loaded by the port.  The same numpy start noise goes to the port's
``round_trip`` and to the JAX pipeline's ``generate``, ``invert`` and
``generate(start_image=)`` at 5 steps; the per-image relative errors and
the latent statistics agree to rtol 1e-4 (float32 in another order).  The
tools are then run whole, on the CPU, on the same folder: they print the
same JSON keys and exit with the same code on either side of the
threshold.
"""

import dataclasses
import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from phendiff_tpu.models import UNet2DConfig as JaxUNetConfig  # noqa: E402
from phendiff_tpu.pipelines import ConditionalDDIMPipeline as JaxPipeline  # noqa: E402
from phendiff_tpu.pipelines.transfer import check_gaussianity as jax_gaussianity  # noqa: E402
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline  # noqa: E402
from phendiff_tpu_torch.tools import make_toy_dataset, reco_err  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    sample_size=8, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
SCHED = dict(clip_sample=False, timestep_spacing="trailing")  # the tool's default pipeline's
STEPS, BATCH = 5, 4
RTOL = 1e-4


def _root_tool(name):
    """A root ``tools/`` script as a module (the folder is not a package)."""
    spec = importlib.util.spec_from_file_location(f"root_tools_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    pipe = JaxPipeline.init_random(JaxUNetConfig(**TINY), JaxSchedulerConfig(**SCHED), seed=3)
    pipe = dataclasses.replace(pipe, lane_pack=False)
    path = str(tmp_path_factory.mktemp("reco") / "pipe")
    pipe.save_pretrained(path)
    return pipe, path


@pytest.fixture(scope="module")
def trips(saved):
    """The JAX and the port's round trips from one numpy start noise."""
    jpipe, path = saved
    noise = np.random.default_rng(0).standard_normal((BATCH, 8, 8, 3)).astype(np.float32)
    labels = np.arange(BATCH) % 2
    jl = jnp.asarray(labels, jnp.int32)
    key = jax.random.key(0)
    x = jpipe.generate(jl, key, start_image=jnp.asarray(noise), num_inference_steps=STEPS)
    z = jpipe.invert(x, jl, num_inference_steps=STEPS)
    recon = jpipe.generate(jl, key, start_image=z, num_inference_steps=STEPS)
    err = np.asarray(jnp.mean((recon - x) ** 2, axis=(1, 2, 3))
                     / jnp.maximum(jnp.mean(x**2, axis=(1, 2, 3)), 1e-8))
    want = {"err": err, "gauss": {k: float(v) for k, v in jax_gaussianity(z).items()}}

    pipe = ConditionalDDIMPipeline.from_pretrained(path, device="cpu")
    got = reco_err.round_trip(pipe, torch.from_numpy(labels), torch.from_numpy(noise), STEPS)
    return want, got


def test_round_trip_errors_match_the_jax_pipeline_per_image(trips):
    want, (x, z, recon) = trips
    got = reco_err.rel_errors(x, recon).numpy()
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got, want["err"], rtol=RTOL)


def test_summary_matches_the_jax_tools_arithmetic(trips):
    want, (x, z, recon) = trips
    s = reco_err.summarize(x, z, recon, threshold=0.05)
    np.testing.assert_allclose(s["mean"], want["err"].mean(), rtol=RTOL)
    np.testing.assert_allclose(s["max"], want["err"].max(), rtol=RTOL)
    assert s["latent_stats"].keys() == want["gauss"].keys()
    for k, v in want["gauss"].items():
        np.testing.assert_allclose(s["latent_stats"][k], v, rtol=RTOL, atol=1e-6, err_msg=k)
    assert s["batch"] == BATCH and s["pass"] == bool(want["err"].mean() < 0.05)


def _run_port(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = reco_err.main(argv)
    return rc, json.loads(buf.getvalue().splitlines()[-1])


def _run_jax(argv, monkeypatch):
    tool = _root_tool("reco_err")
    monkeypatch.setattr(sys, "argv", ["reco_err.py", *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tool.main()
    return rc, json.loads(buf.getvalue().splitlines()[-1])


@pytest.mark.parametrize("threshold,rc", [("10", 0), ("0", 1)])
def test_the_tool_prints_the_jax_tools_keys_and_exit_code(saved, monkeypatch, threshold, rc):
    argv = ["--pipeline", saved[1], "--steps", "2", "--batch", "2", "--res", "8",
            "--threshold", threshold, "--cpu"]
    got_rc, got = _run_port(argv)
    want_rc, want = _run_jax(argv, monkeypatch)
    assert got_rc == want_rc == rc
    assert list(got) == list(want)
    assert list(got["latent_stats"]) == list(want["latent_stats"])
    assert (got["steps"], got["batch"], got["pass"]) == (want["steps"], want["batch"], want["pass"])


def test_the_tool_refuses_to_run_without_a_card_unless_asked_for_the_cpu(saved):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reco_err.main(["--pipeline", saved[1], "--steps", "1", "--batch", "2"])


def test_make_toy_dataset_writes_the_root_tools_pngs_byte_for_byte(tmp_path, monkeypatch):
    make_toy_dataset.write(str(tmp_path / "port"), n=3, res=16, seed=5)
    tool = _root_tool("make_toy_dataset")
    monkeypatch.setattr(sys, "argv", ["make_toy_dataset.py", str(tmp_path / "jax"), "--n", "3",
                                      "--res", "16", "--seed", "5"])
    with redirect_stdout(io.StringIO()):
        tool.main()
    for cls in ("blobs", "stripes"):
        names = sorted(os.listdir(tmp_path / "jax" / cls))
        assert names == sorted(os.listdir(tmp_path / "port" / cls)) and len(names) == 3
        for n in names:
            assert (tmp_path / "port" / cls / n).read_bytes() == (tmp_path / "jax" / cls / n).read_bytes()
