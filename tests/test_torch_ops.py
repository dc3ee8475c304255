"""The port's attention and GroupNorm (plain versions and dispatch) against
the JAX package's XLA paths and its Pallas kernels run in interpret mode.
(The CUDA kernels are held against these plain versions on the card in
``test_torch_kernels_cuda.py``.)

Inputs come from numpy and go to both sides.  Tolerances: float32 paths
agree to float32 rounding of the same sums (atol 1e-5 on O(1) values);
bfloat16 outputs agree to one bf16 ulp (rtol 2**-7).
"""

import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from phendiff_tpu.ops.attention import attention_xla  # noqa: E402
from phendiff_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from phendiff_tpu.ops.gn_kernels import fused_group_norm as jax_fused_gn  # noqa: E402
from phendiff_tpu.ops.group_norm import group_norm as jax_group_norm  # noqa: E402
from phendiff_tpu_torch.ops.attention import attention_plain, multi_head_attention  # noqa: E402
from phendiff_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from phendiff_tpu_torch.ops.gn_kernels import fused_group_norm, group_norm_plain  # noqa: E402
from phendiff_tpu_torch.ops.group_norm import group_norm  # noqa: E402

torch.set_num_threads(1)

F32_ATOL = 1e-5
BF16_RTOL = 2.0**-7


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


# -- attention ---------------------------------------------------------------


@pytest.mark.parametrize("d", [4, 8])
def test_attention_plain_matches_xla_and_pallas_interpret(d):
    q, k, v = _qkv(2, 64, 3, d, seed=d)
    want_xla = np.asarray(attention_xla(*map(jnp.asarray, (q, k, v))))
    want_pallas = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (attention_plain(tq, tk, tv), flash_attention(tq, tk, tv),
                multi_head_attention(tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), want_xla, atol=F32_ATOL)
        np.testing.assert_allclose(got.numpy(), want_pallas, atol=F32_ATOL)


def test_attention_plain_bf16_and_cross_attention_match_xla():
    q, k, v = _qkv(2, 64, 2, 8, seed=3)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = np.asarray(attention_xla(*jb, scale=0.3).astype(jnp.float32))
    got = attention_plain(*tb, scale=0.3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=1e-3)
    # cross-attention (s_q != s_kv) takes the plain path
    kx, vx = _qkv(2, 77, 2, 8, seed=4)[:2]
    want = np.asarray(attention_xla(jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx)))
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(kx), torch.from_numpy(vx))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


# -- GroupNorm ---------------------------------------------------------------


@pytest.mark.parametrize("c,groups", [(8, 4), (24, 4), (48, 4)])  # C/G = 2, 6, 12
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_xla_and_pallas_interpret(c, groups, act):
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((2, 4, 4, c)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(c).astype(np.float32) for _ in range(2))
    kw = dict(num_groups=groups, eps=1e-5, act=act)
    want = np.asarray(jax_group_norm(jnp.asarray(x), scale=jnp.asarray(scale),
                                     bias=jnp.asarray(bias), **kw))
    want_pallas = np.asarray(jax_fused_gn(jnp.asarray(x.reshape(2, 16, c)), jnp.asarray(scale),
                                          jnp.asarray(bias), **kw)).reshape(x.shape)
    got = group_norm(torch.from_numpy(x), scale=torch.from_numpy(scale),
                     bias=torch.from_numpy(bias), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=F32_ATOL)


def test_group_norm_bf16_out_and_no_affine_match_xla():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 24)).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    want = np.asarray(jax_group_norm(
        jnp.asarray(x, jnp.bfloat16), num_groups=4, eps=1e-6, scale=jnp.asarray(scale),
        act="silu", out_dtype=jnp.bfloat16).astype(jnp.float32))
    got = group_norm(torch.from_numpy(x).to(torch.bfloat16), num_groups=4, eps=1e-6,
                     scale=torch.from_numpy(scale), act="silu", out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=1e-3)
    # a constant group: var clamps at 0, output is the bias (no NaN)
    flat = torch.ones(1, 16, 8)
    out = group_norm_plain(flat, None, torch.full((8,), 0.5), num_groups=2, eps=1e-5)
    assert torch.equal(out, torch.full_like(out, 0.5))


def test_wrappers_reject_other_devices():
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        fused_group_norm(x, None, None, num_groups=2, eps=1e-5)
    q = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
