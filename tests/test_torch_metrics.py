"""The port's metrics against the JAX package, on the CPU.

* FID, ISC and KID: the port's ``metrics/fidelity.py`` and the JAX
  package's on the same seeded float64 features agree to 1e-8 relative
  (the same numpy/scipy math; KID draws the same ``default_rng`` subsets).
* InceptionV3: a variable tree of the JAX model's structure with seeded
  values, carried across by ``from_flax_variables``, gives the JAX model's
  features and logits; the port's own seeded init, fed to the JAX
  package's ``convert_torch_weights`` (torch-fidelity's key space),
  does too.  Float32 convolutions in another order: 1e-4 of the largest
  magnitude.  The extractor's input path (bilinear resize with antialias,
  then ``x * 2 - 1``) is held against ``jax.image.resize``: measured
  within 2e-6 when enlarging 128 -> 299 and when shrinking, borders
  included; asserted to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phendiff_tpu.metrics import fidelity as jax_fid
from phendiff_tpu.metrics.inception import InceptionV3 as JaxInceptionV3
from phendiff_tpu.metrics.inception import convert_torch_weights
from phendiff_tpu_torch.metrics import fidelity
from phendiff_tpu_torch.metrics.inception import (
    InceptionExtractor,
    from_flax_variables,
    load_state_dict,
    prepare,
)

torch.set_num_threads(1)
RES = 75  # the smallest input InceptionV3 takes


def _features(seed, n, d=64, shift=0.0):
    return np.random.default_rng(seed).standard_normal((n, d)) + shift


@pytest.mark.parametrize("n", [40, 100])
def test_fid_isc_kid_match_jax(n):
    real, fake = _features(0, n), _features(1, n, shift=0.3)
    assert fidelity.fid_from_features(real, fake) == pytest.approx(
        jax_fid.fid_from_features(real, fake), rel=1e-8)
    logits = _features(2, n, d=10) * 3
    got, want = fidelity.isc_from_logits(logits), jax_fid.isc_from_logits(logits)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-8)
    got = fidelity.kid_from_features(real, fake, subset_size=16, num_subsets=10, seed=3)
    want = jax_fid.kid_from_features(real, fake, subset_size=16, num_subsets=10, seed=3)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-8)
    assert fidelity._polynomial_mmd(real, fake) == pytest.approx(
        jax_fid._polynomial_mmd(real, fake), rel=1e-8)
    assert fidelity.fid_from_features(real, real) == pytest.approx(0.0, abs=1e-6)


def test_calculate_metrics_and_kid_autodisable_match_jax():
    real, fake = _features(4, 30), _features(5, 30, shift=0.5)
    logits = _features(6, 30, d=12)
    for subset in (10, 31):  # 31 > 30 samples: KID is skipped on both sides
        cfg = dict(fid=True, isc=True, kid=True, kid_subset_size=subset, kid_subsets=5)
        got = fidelity.calculate_metrics(fake, real, logits, fidelity.MetricsConfig(**cfg))
        want = jax_fid.calculate_metrics(fake, real, logits, jax_fid.MetricsConfig(**cfg))
        assert sorted(got) == sorted(want)
        assert ("kernel_inception_distance_mean" in got) == (subset == 10)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-8)
    with pytest.raises(ValueError, match="real_features"):
        fidelity.calculate_metrics(fake, None, logits, fidelity.MetricsConfig())


def test_feature_cache(tmp_path):
    cache = fidelity.FeatureCache(str(tmp_path / "cache"))
    calls = []

    def compute():
        calls.append(1)
        return {"features": np.arange(6.0).reshape(2, 3)}

    a = cache.get_or_compute("DMSO_abc", compute)
    b = cache.get_or_compute("DMSO_abc", compute)
    assert len(calls) == 1 and np.array_equal(a["features"], b["features"])
    assert cache.get("other") is None


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(JaxInceptionV3().apply)


def _images01(seed, n=2, size=16):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


def _jax_features(apply, variables, images01):
    x = jax.image.resize(jnp.asarray(images01), (len(images01), RES, RES, 3), "bilinear")
    f, lg = apply(variables, x * 2.0 - 1.0)
    return np.asarray(f), np.asarray(lg)


def _assert_close_to_scale(got, want):
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()))


def test_flax_variables_carry_across(jax_apply, monkeypatch):
    monkeypatch.setenv("PHENDIFF_INCEPTION_RESIZE", str(RES))
    shapes = jax.eval_shape(JaxInceptionV3().init, jax.random.key(0),
                            jnp.zeros((1, RES, RES, 3)))
    rng = np.random.default_rng(7)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        if name in ("mean", "bias"):
            return rng.uniform(-0.2, 0.2, s.shape)
        return rng.uniform(0.5, 1.5, s.shape)  # BatchNorm scale and var

    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(fill(p, s), jnp.float32), shapes)
    ext = InceptionExtractor(device="cpu")
    ext.model.load_state_dict(from_flax_variables(variables))
    images = _images01(8)
    f, lg = ext(torch.from_numpy(images))
    want_f, want_l = _jax_features(jax_apply, variables, images)
    assert f.shape == (2, 2048) and lg.shape == (2, 1008)
    _assert_close_to_scale(f.numpy(), want_f)
    _assert_close_to_scale(lg.numpy(), want_l)
    # and back: the port's state dict through the JAX converter is the same tree
    back = convert_torch_weights({k: v.numpy() for k, v in ext.model.state_dict().items()})
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(variables)):
        assert pa == pb and np.array_equal(np.asarray(a), np.asarray(b))


def test_state_dict_is_torch_fidelity_key_space(jax_apply, monkeypatch, tmp_path):
    monkeypatch.setenv("PHENDIFF_INCEPTION_RESIZE", str(RES))
    ext = InceptionExtractor(seed=3, device="cpu")
    assert not ext.pretrained and ext.resolution() == RES
    sd = {k: v.numpy() for k, v in ext.model.state_dict().items()}
    assert "Mixed_5b.branch1x1.conv.weight" in sd and "fc.weight" in sd
    variables = convert_torch_weights(sd)
    images = _images01(9)
    feats, logits = ext.features_for([images[:1], images[1:]])
    want_f, want_l = _jax_features(jax_apply, variables, images)
    _assert_close_to_scale(feats, want_f)
    _assert_close_to_scale(logits, want_l)
    # a checkpoint with the training-time aux head loads; real weights pin 299
    path = str(tmp_path / "inception.pt")
    torch.save({**ext.model.state_dict(), "AuxLogits.fc.weight": torch.zeros(3)}, path)
    assert "AuxLogits.fc.weight" not in load_state_dict(path)
    loaded = InceptionExtractor(weights_path=path, device="cpu")
    assert loaded.pretrained and loaded.resolution() == 299


@pytest.mark.parametrize("size,res", [(16, 75), (128, 299), (128, 75), (300, 299)])
def test_resize_matches_jax(size, res):
    x = _images01(size, size=size)
    want = jax.image.resize(jnp.asarray(x), (2, res, res, 3), "bilinear") * 2.0 - 1.0
    got = prepare(torch.from_numpy(x), res)
    assert got.shape == (2, 3, res, res)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
