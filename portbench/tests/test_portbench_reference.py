"""The frozen reference against the port's plain path at tiny sizes on the
CPU (the port's kernels take their plain versions there): the models, the
schedule, and whole runs of each runner in float32, where the numbers that
decide ``correct`` read rounding alone."""

import numpy as np
import pytest
import torch

from portbench.families import ddim, sd
from portbench.harness import seeds
from portbench.harness.weights import make_weights
from portbench.reference import diffusion as D
from portbench.reference.models import Arith
from portbench.runners import ddib as ddib_runner
from portbench.tests import tiny

CPU = torch.device("cpu")


def _models(fam, cfg, seed=7):
    weights = make_weights(fam.specs(cfg), seed, CPU)
    models = fam.reference(cfg)
    for part, module in models.items():
        module.load_state_dict({n[len(part) + 1:]: w for n, w in weights.items()
                                if n.startswith(part + ".")})
    return weights, models


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def test_the_pixel_unet_matches_the_ports():
    cfg = tiny.config("ddim")
    weights, models = _models(ddim, cfg)
    prog = ddim.program_transfer(cfg, weights, torch.float32, CPU)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 16, 16, 3, generator=gen)
    t = torch.tensor([0, 500, 999])
    labels = torch.tensor([0, 1, 1])
    got = prog.denoiser(x, t, prog.embed(labels))
    want = ddim.ref_denoise(Arith(), models, x, t, ddim.ref_embed(models, labels))
    assert _rel(got, want) < 1e-5


def test_the_sd_unet_and_vae_match_the_ports():
    cfg = tiny.config("sd")
    weights, models = _models(sd, cfg)
    prog = sd.program_transfer(cfg, weights, torch.float32, CPU)
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1
    labels = torch.tensor([0, 1])
    lat = prog.encode(images)
    assert _rel(lat, sd.ref_encode(Arith(), models, images)) < 1e-5
    t = torch.tensor([10, 700])
    got = prog.denoiser(lat, t, prog.embed(labels))
    want = sd.ref_denoise(Arith(), models, lat, t, sd.ref_embed(models, labels))
    assert _rel(got, want) < 1e-5
    assert _rel(prog.decode(lat), sd.ref_decode(Arith(), models, lat)) < 1e-5


@pytest.mark.parametrize("family", ["ddim", "sd"])
def test_the_schedule_and_the_ddib_steps_match_the_ports(family):
    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.pipelines.transfer import ddib_rows

    cfg = tiny.config(family)["scheduler"]
    port = S.make_schedule(S.SchedulerConfig.from_json(cfg), device="cpu")
    ref = D.Schedule(cfg, CPU)
    assert torch.equal(port.alphas_cumprod, ref.alphas)
    assert float(port.final_alpha_cumprod) == float(ref.final)
    assert np.array_equal(ddib_rows(port.config, 50),
                          np.array([(a, b, int(g)) for a, b, g in ref.ddib_rows(50)]))


@pytest.mark.parametrize("family,runner", [("ddim", "ddib"), ("sd", "ddib"), ("ddim", "train"),
                                           ("sd", "train")])
def test_a_float32_run_reads_rounding_alone(family, runner):
    if runner == "ddib":
        kw = dict(batch=4, compute_dtype="float32", checked_rows_per_batch=2,
                  num_inference_steps=3)
    else:
        kw = dict(batch=4, mixed_precision="no", reference_rows_per_block=3, pool_batches=4)
    cell = tiny.cell(family, runner, {}, **kw)
    out = cell.runner().run(cell, cell.family(), 2**33 + 5, 0.2, False, CPU, lambda: 0.0)
    assert out["failed"] == 0 and out["attempted"] >= 4
    checked = out["checked"]
    assert set(checked) == ({"step_gap"} if runner == "ddib" and family == "ddim" else
                            {"encode_gap", "step_gap", "decode_gap"} if runner == "ddib" else
                            {"loss_gap", "grad_gap", "change_gap", "ema_gap"})
    for name, value in checked.items():
        # AdamW turns rounding of small gradients into whole updates: the
        # change of the parameters reads more than the rest
        assert value < (5e-3 if name in ("change_gap", "ema_gap") else 1e-4), (name, value)


def test_the_same_seed_gives_the_same_inputs_and_weights():
    cfg, mix = tiny.config("ddim"), tiny.cell("ddim", "ddib", {}).traffic
    a = ddib_runner.inputs(ddim, cfg, mix, 2**40 + 3, 1, CPU)
    b = ddib_runner.inputs(ddim, cfg, mix, 2**40 + 3, 1, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[1].sum()) == mix["batch"] // 2 and torch.equal(a[2], 1 - a[1])
    w1 = make_weights(ddim.specs(cfg), seeds.derive(5, "weights"), CPU)
    w2 = make_weights(ddim.specs(cfg), seeds.derive(5, "weights"), CPU)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert seeds.derive(5, "weights") != seeds.derive(6, "weights")
