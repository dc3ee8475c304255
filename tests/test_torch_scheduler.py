"""The port's DDIM schedule (phendiff_tpu_torch.core.scheduler) against the
JAX package's (phendiff_tpu.core.scheduler) and the float64 goldens.

Inputs come from numpy and go to both sides.  Tolerances: tables and
timestep schedules are exact (both sides build float64 tables in numpy and
round once to float32); step functions agree to float32 rounding of the
same formulas (atol 1e-6 on O(1) values); the goldens use the JAX tests'
own tolerance (rtol 5e-4, atol 5e-5).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phendiff_tpu.core import scheduler as JS
from phendiff_tpu_torch.core import scheduler as TS

torch.set_num_threads(1)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs", "noise_scheduler")
CONFIG_FILES = sorted(os.listdir(CONFIG_DIR))
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "scheduler_goldens.json")
with open(FIXTURE) as f:
    GOLDENS = json.load(f)
STEP_ATOL = 1e-6


def _both(fname):
    path = os.path.join(CONFIG_DIR, fname)
    jcfg, tcfg = JS.SchedulerConfig.from_json(path), TS.SchedulerConfig.from_json(path)
    return jcfg, tcfg, JS.make_schedule(jcfg), TS.make_schedule(tcfg, device="cpu")


@pytest.mark.parametrize("fname", CONFIG_FILES)
def test_config_json_round_trip_and_tables(fname):
    jcfg, tcfg, jsched, tsched = _both(fname)
    assert tcfg.to_json_dict() == jcfg.to_json_dict()
    assert TS.SchedulerConfig.from_json(tcfg.to_json_dict()) == tcfg
    np.testing.assert_array_equal(TS._make_betas(tcfg), JS._make_betas(jcfg))
    np.testing.assert_array_equal(
        tsched.alphas_cumprod.numpy(), np.asarray(jsched.alphas_cumprod)
    )
    assert float(tsched.final_alpha_cumprod) == float(jsched.final_alpha_cumprod)
    assert tsched.alphas_cumprod.dtype == torch.float32


@pytest.mark.parametrize("fname", CONFIG_FILES)
def test_timestep_pairs_match(fname):
    jcfg, tcfg, _, _ = _both(fname)
    for n in (3, 10, 50):
        np.testing.assert_array_equal(
            TS.inference_timesteps(tcfg, n), JS.inference_timesteps(jcfg, n)
        )
        for a, b in zip(TS.timestep_pairs(tcfg, n, 0.3), JS.timestep_pairs(jcfg, n, 0.3)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(TS.inversion_timestep_pairs(tcfg, n),
                        JS.inversion_timestep_pairs(jcfg, n)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fname", CONFIG_FILES)
@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
def test_steps_match_jax(fname, prediction_type):
    jcfg, tcfg, _, _ = _both(fname)
    jcfg = jcfg.replace(prediction_type=prediction_type)
    tcfg = tcfg.replace(prediction_type=prediction_type)
    jsched, tsched = JS.make_schedule(jcfg), TS.make_schedule(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    out = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    T = tcfg.num_train_timesteps
    per_sample = np.array([-1, T // 3, T - 2])
    for t, tp in [(T // 2, T // 4), (5, -1), (per_sample, per_sample - 1)]:
        jt, tt = (jnp.asarray(t), torch.as_tensor(t)) if isinstance(t, np.ndarray) else (t, t)
        jtp, ttp = (jnp.asarray(tp), torch.as_tensor(tp)) if isinstance(tp, np.ndarray) else (tp, tp)
        for eta in (0.0, 0.7):
            want = JS.ddim_step(jsched, jnp.asarray(out), jt, jtp, jnp.asarray(x),
                                eta=eta, noise=jnp.asarray(noise))
            got = TS.ddim_step(tsched, torch.from_numpy(out), tt, ttp, torch.from_numpy(x),
                               eta=eta, noise=torch.from_numpy(noise))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=STEP_ATOL)
        want = JS.ddim_inverse_step(jsched, jnp.asarray(out), jt, jtp, jnp.asarray(x))
        got = TS.ddim_inverse_step(tsched, torch.from_numpy(out), tt, ttp, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=STEP_ATOL)
        want = JS.add_noise(jsched, jnp.asarray(x), jnp.asarray(noise), jt)
        got = TS.add_noise(tsched, torch.from_numpy(x), torch.from_numpy(noise), tt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=STEP_ATOL)


def test_thresholding_matches_jax():
    cfg = dict(thresholding=True, dynamic_thresholding_ratio=0.9, sample_max_value=1.5)
    jsched = JS.make_schedule(JS.SchedulerConfig(**cfg))
    tsched = TS.make_schedule(TS.SchedulerConfig(**cfg), device="cpu")
    x0 = (np.random.default_rng(1).standard_normal((2, 8, 8, 3)) * 2).astype(np.float32)
    want = JS._maybe_clip_x0(jsched, jnp.asarray(x0))
    got = TS._maybe_clip_x0(tsched, torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(GOLDENS["configs"]))
def test_steps_match_float64_goldens(name):
    entry = GOLDENS["configs"][name]
    sched = TS.make_schedule(TS.SchedulerConfig.from_json(entry["config"]), device="cpu")
    sample, model_output, noise = (
        torch.tensor(GOLDENS["inputs"][k], dtype=torch.float32)
        for k in ("sample", "model_output", "noise")
    )
    for t_str, want in entry["alphas_cumprod_probe"].items():
        np.testing.assert_allclose(float(sched.alphas_cumprod[int(t_str)]), want,
                                   rtol=2e-6, atol=1e-9)
    for case in entry["steps"]:
        got = TS.ddim_step(
            sched, model_output, case["t"], case["t_prev"], sample, eta=case["eta"],
            noise=noise if case["eta"] > 0 else None,
            use_clipped_model_output=case["use_clipped_model_output"],
        )
        np.testing.assert_allclose(got.double().numpy(), np.asarray(case["prev_sample"]),
                                   rtol=5e-4, atol=5e-5)
    for case in entry["inverse_steps"]:
        got = TS.ddim_inverse_step(sched, model_output, case["t"], case["t_next"], sample)
        np.testing.assert_allclose(got.double().numpy(), np.asarray(case["next_sample"]),
                                   rtol=5e-4, atol=5e-5)


def test_rng_streams_and_precision_policy():
    from phendiff_tpu.core.precision import Policy as JaxPolicy
    from phendiff_tpu.core.rng import EVAL_SEED as JAX_EVAL_SEED
    from phendiff_tpu_torch.core import precision, rng

    assert rng.EVAL_SEED == JAX_EVAL_SEED
    a, b = rng.KeyStream(rng.EVAL_SEED), rng.KeyStream(rng.EVAL_SEED)
    draws_a = [torch.randn(3, generator=a.next()) for _ in range(2)]
    draws_b = [torch.randn(3, generator=b.next()) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(draws_a, draws_b))
    assert not torch.equal(draws_a[0], draws_a[1])
    assert torch.equal(torch.randn(3, generator=a.fold_in(7)), torch.randn(3, generator=b.fold_in(7)))
    assert not torch.equal(torch.randn(3, generator=rng.KeyStream(0).next()),
                           torch.randn(3, generator=rng.KeyStream(1).next()))
    for flag in ("no", "bf16", "fp16"):
        jp, tp = JaxPolicy.from_mixed_precision(flag), precision.Policy.from_mixed_precision(flag)
        assert (jp.param_dtype, jp.compute_dtype, jp.output_dtype) == (
            tp.param_dtype, tp.compute_dtype, tp.output_dtype)
    cast = precision.cast_floating({"w": torch.ones(2), "n": torch.arange(2)}, "bfloat16")
    assert cast["w"].dtype == torch.bfloat16 and cast["n"].dtype == torch.int64
