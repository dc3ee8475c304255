"""The port's attention and GroupNorm (plain versions and dispatch) against
the JAX package's XLA paths and its Pallas kernels run in interpret mode.
(The CUDA kernels are held against these plain versions on the card in
``test_torch_kernels_cuda.py``.)

Inputs come from numpy and go to both sides.  Tolerances: float32 paths
agree to float32 rounding of the same sums (atol 1e-5 on O(1) values);
bfloat16 outputs agree to one bf16 ulp (rtol 2**-7).  Gradients: the
attention backward against ``jax.vjp`` of the Pallas kernel (interpret
mode), the GroupNorm backward against ``jax.vjp`` of the XLA GroupNorm, at
the same tolerances (bf16 gradients to one bf16 ulp of the largest one).
The closed-form GroupNorm backward (``group_norm_bwd_plain``, the backward
kernel's plain version) agrees with ``jax.vjp`` and with autograd through
``group_norm_plain`` to 1e-4 of the largest gradient in f32: f32 rounding
of the group mean, which x - mean amplifies by |mean| / std (50 in the
near-constant group; both packages and the float64 answer differ there by
1e-5 to 3e-5); and to one bf16 ulp of the largest gradient where dx is bf16.
"""

import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from phendiff_tpu.ops.attention import attention_xla  # noqa: E402
from phendiff_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from phendiff_tpu.ops.gn_kernels import fused_group_norm as jax_fused_gn  # noqa: E402
from phendiff_tpu.ops.group_norm import group_norm as jax_group_norm  # noqa: E402
from phendiff_tpu_torch.ops import flash_attention as fa_mod  # noqa: E402
from phendiff_tpu_torch.ops import gn_kernels  # noqa: E402
from phendiff_tpu_torch.ops.attention import attention_plain, multi_head_attention  # noqa: E402
from phendiff_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd_plain,
)
from phendiff_tpu_torch.ops.gn_kernels import (  # noqa: E402
    channel_moments,
    fused_group_norm,
    gn_plan,
    group_norm_bwd_plain,
    group_norm_plain,
    group_stats_plain,
    route_addend,
)
from phendiff_tpu_torch.ops.group_norm import group_norm  # noqa: E402

torch.set_num_threads(1)

F32_ATOL = 1e-5
BF16_RTOL = 2.0**-7


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


# -- attention ---------------------------------------------------------------


def _tol(dtype, want):
    """f32: f32 rounding; bf16: one bf16 ulp of the largest value."""
    if dtype == "float32":
        return dict(atol=F32_ATOL)
    return dict(rtol=BF16_RTOL, atol=BF16_RTOL * np.abs(want).max())


# D = 8 is the main path's head width, 64 the SD path's, 4 pads up to 8.
@pytest.mark.parametrize("d,dtype", [(4, "float32"), (8, "float32"), (64, "float32"),
                                     (8, "bfloat16"), (64, "bfloat16")],
                         ids=["4", "8", "64", "8-bfloat16", "64-bfloat16"])
def test_attention_plain_matches_xla_and_pallas_interpret(d, dtype):
    q, k, v = _qkv(2, 128, 3, d, seed=d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq = [jnp.asarray(a, jd) for a in (q, k, v)]
    want_xla = np.asarray(attention_xla(*jq).astype(jnp.float32))
    want_pallas = np.asarray(jax_flash(*jq).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    for got in (attention_plain(tq, tk, tv), flash_attention(tq, tk, tv),
                multi_head_attention(tq, tk, tv)):
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), want_xla, **_tol(dtype, want_xla))
        np.testing.assert_allclose(got.float().numpy(), want_pallas, **_tol(dtype, want_pallas))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_with_addend_normalises_the_rounded_sum(act, dtype):
    """An addend [B, C] gives the bits of the call on the materialised sum
    (PyTorch's add, rounded to x's dtype) through every wrapper, and the JAX
    package's group_norm of the same sum."""
    rng = np.random.default_rng(11)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = torch.from_numpy((rng.standard_normal((2, 4, 4, 24)) * 3 + 1).astype(np.float32)).to(td)
    t = torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32)).to(td)
    scale, bias = (torch.from_numpy(rng.standard_normal(24).astype(np.float32)) for _ in range(2))
    kw = dict(num_groups=4, eps=1e-5, act=act, out_dtype=td)
    total = x + t[:, None, None, :]
    assert total.dtype == td
    want = group_norm(total, scale=scale, bias=bias, **kw)
    assert torch.equal(group_norm(x, scale=scale, bias=bias, addend=t, **kw), want)
    flat = x.reshape(2, 16, 24)
    for fn in (group_norm_plain, fused_group_norm):
        got = fn(flat, scale, bias, addend=t, **kw)
        assert torch.equal(got, fn(flat + t[:, None, :], scale, bias, **kw))
        assert torch.equal(got.reshape(want.shape), want)
    want_jax = jax_group_norm(
        jnp.asarray(x.float().numpy(), jd) + jnp.asarray(t.float().numpy(), jd)[:, None, None, :],
        num_groups=4, eps=1e-5, scale=jnp.asarray(scale.numpy()), bias=jnp.asarray(bias.numpy()),
        act=act, out_dtype=jd)
    tol = dict(atol=F32_ATOL) if dtype == "float32" else dict(rtol=BF16_RTOL, atol=1e-3)
    np.testing.assert_allclose(want.float().numpy(),
                               np.asarray(want_jax.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("case,takes", [
    ("no_grad", True), ("params_record_under_no_grad", True), ("x_records", False),
    ("addend_records", False), ("params_record", False), ("addend_in_f32", False),
    ("streaming_route", False),
])
def test_route_addend_hands_the_kernel_the_addend_only_outside_autograd(case, takes):
    """The CUDA route's choice, made on CPU tensors: the kernel takes the
    addend unless autograd records, the shape takes the streaming variant
    or the addend's dtype is not x's; then the sum is formed and counted."""
    rng = np.random.default_rng(3)
    c, groups = (512, 1) if case == "streaming_route" else (24, 4)
    x = torch.from_numpy(rng.standard_normal((2, 16, c)).astype(np.float32)).to(torch.bfloat16)
    addend = torch.from_numpy(rng.standard_normal((2, c)).astype(np.float32))
    addend = addend if case == "addend_in_f32" else addend.to(torch.bfloat16)
    scale, bias = torch.ones(c), torch.zeros(c)
    x.requires_grad_(case == "x_records")
    addend.requires_grad_(case == "addend_records")
    scale.requires_grad_(case.startswith("params_record"))
    if case == "streaming_route":
        assert gn_kernels.gn_route(16, c, groups, 2) == "stream"
    before = gn_kernels.fused_group_norm.addend_materialised
    with torch.set_grad_enabled(case != "params_record_under_no_grad"):
        got_x, got_addend = route_addend(x, scale, bias, addend, groups)
    assert (got_x is x and got_addend is addend) == takes
    assert gn_kernels.fused_group_norm.addend_materialised - before == (not takes)
    if not takes:
        assert got_addend is None
        assert torch.equal(got_x.detach(), (x + addend[:, None, :]).detach())
        assert got_x.requires_grad == (case in ("x_records", "addend_records"))


def test_wrappers_reject_other_devices():
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        fused_group_norm(x, None, None, num_groups=2, eps=1e-5)
    q = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


# -- gradients ---------------------------------------------------------------


@pytest.mark.parametrize("dtype,d", [("float32", 8), ("bfloat16", 8),
                                     ("float32", 64), ("bfloat16", 64)],
                         ids=["float32", "bfloat16", "float32-d64", "bfloat16-d64"])
def test_attention_backward_matches_pallas_vjp(dtype, d):
    q, k, v, g = _qkv(2, 128, 2, d, seed=11) + _qkv(2, 128, 2, d, seed=12)[:1]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(jax_flash, *(jnp.asarray(a, jd) for a in (q, k, v)))
    want = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g, jd))]
    tq, tk, tv, tg = (torch.from_numpy(a).to(td) for a in (q, k, v, g))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    flash_attention(*leaves).backward(tg)  # the CPU path: autograd through the plain forward
    for got in (flash_attention_bwd_plain(tq, tk, tv, tg), [t.grad for t in leaves]):
        for a, w in zip(got, want):
            assert a.dtype == td
            np.testing.assert_allclose(a.float().numpy(), w, **_tol(dtype, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_versions_match_xla_at_ragged_s(dtype):
    """S = 100, a multiple of no kernel tile: forward and backward of the
    plain versions against ``attention_xla`` and its VJP."""
    q, k, v = _qkv(2, 100, 2, 8, seed=70)
    g = _qkv(2, 100, 2, 8, seed=71)[0]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(attention_xla, *(jnp.asarray(a, jd) for a in (q, k, v)))
    tq, tk, tv, tg = (torch.from_numpy(a).to(td) for a in (q, k, v, g))
    got = [attention_plain(tq, tk, tv), *flash_attention_bwd_plain(tq, tk, tv, tg)]
    for a, w in zip(got, [out, *vjp(jnp.asarray(g, jd))]):
        w = np.asarray(w.astype(jnp.float32))
        assert a.dtype == td
        np.testing.assert_allclose(a.float().numpy(), w, **_tol(dtype, w))


@pytest.mark.parametrize("kernel,category", [
    ("void (anonymous namespace)::flash_fwd_mma_kernel<8>(...)", "flash_attn_fwd"),
    ("void (anonymous namespace)::flash_fwd_kernel<64>(...)", "flash_attn_fwd"),
    ("void (anonymous namespace)::flash_bwd_dq_mma_kernel<8>(...)", "flash_attn_bwd"),
    ("void (anonymous namespace)::flash_bwd_dkdv_mma_kernel<64>(...)", "flash_attn_bwd"),
    ("void (anonymous namespace)::flash_bwd_dkdv_kernel<8>(...)", "flash_attn_bwd"),
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel(CUtensorMap_st, ...)", "flash_attn_fwd"),
    ("void (anonymous namespace)::flash_bwd_dq_wgmma_kernel(CUtensorMap_st, ...)",
     "flash_attn_bwd"),
    ("void (anonymous namespace)::flash_bwd_dkdv_wgmma_kernel(CUtensorMap_st, ...)",
     "flash_attn_bwd"),
    ("void (anonymous namespace)::gn_fwd_cluster<__nv_bfloat16, true>(...)", "group_norm_silu"),
    ("void (anonymous namespace)::gn_fwd_cluster<float, false>(...)", "group_norm_silu"),
    ("void (anonymous namespace)::gn_bwd_cluster<__nv_bfloat16, true>(...)",
     "group_norm_silu_bwd"),
    ("void (anonymous namespace)::gn_bwd_cluster<float, false>(...)", "group_norm_silu_bwd"),
    ("void (anonymous namespace)::gn_stats<__nv_bfloat16>(...)", "channel_moments"),
    ("void (anonymous namespace)::moments_combine(...)", "channel_moments"),
    ("void (anonymous namespace)::stream_apply<__nv_bfloat16, true>(...)",
     "group_norm_silu_stream"),
    ("void (anonymous namespace)::stream_stats_combine(...)", "group_norm_silu_stream"),
    ("void (anonymous namespace)::stream_bwd_sums<float, false>(...)",
     "group_norm_silu_stream_bwd"),
    ("void (anonymous namespace)::stream_bwd_dx<__nv_bfloat16, true>(...)",
     "group_norm_silu_stream_bwd"),
    # the ResnetBlock's residual with its conv biases: no fragment names it
    ("void (anonymous namespace)::residual_bias_kernel<__nv_bfloat16, true>(...)", "other"),
])
def test_benchmark_trace_table_attributes_the_port_kernels(kernel, category):
    """The category table behind the benchmark's device-time breakdown."""
    from portbench.harness.trace import categorize

    assert categorize(kernel) == category


def test_launch_counts_read_and_reset_every_counter_of_the_ops_wrappers():
    """Every int attribute of an ``ops`` function (its launch or call
    counter) is read by ``launch_counts`` under a key of its own and zeroed
    by ``reset_launch_counts``, so a new kernel's counter cannot be missed."""
    import importlib
    import inspect
    import pkgutil

    import phendiff_tpu_torch.ops as ops
    from phendiff_tpu_torch.ops.routes import launch_counts, reset_launch_counts

    found = []
    for info in pkgutil.iter_modules(ops.__path__, "phendiff_tpu_torch.ops."):
        mod = importlib.import_module(info.name)
        for fn in vars(mod).values():
            if inspect.isfunction(fn) and fn.__module__ == mod.__name__:
                found += [(fn, a) for a, v in vars(fn).items()
                          if isinstance(v, int) and not isinstance(v, bool)]
    assert len(found) >= 19
    saved = [getattr(fn, a) for fn, a in found]
    try:
        for i, (fn, a) in enumerate(found):
            setattr(fn, a, i + 1)
        assert sorted(launch_counts().values()) == list(range(1, len(found) + 1))
        reset_launch_counts()
        assert all(getattr(fn, a) == 0 for fn, a in found)
    finally:
        for (fn, a), v in zip(found, saved):
            setattr(fn, a, v)


def test_kernel_library_names_hash_the_shared_headers(tmp_path, monkeypatch):
    from phendiff_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    before = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != before  # an edited header is rebuilt
    log = ("ptxas info    : Function properties for _Z3fooILi64EEv\n"
           "    8 bytes stack frame, 4 bytes spill stores, 6 bytes spill loads\n"
           "ptxas info    : Used 255 registers, used 1 barriers, 33792 bytes smem\n")
    assert _build.ptxas_functions(log) == {
        "_Z3fooILi64EEv": {"spill_bytes": 10, "stack_bytes": 8, "registers": 255}}


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_backward_matches_jax(act):
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2, 4, 4, 24)) * 2 + 0.5).astype(np.float32)
    scale, bias = (rng.standard_normal(24).astype(np.float32) for _ in range(2))
    g = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(num_groups=4, eps=1e-5, act=act)
    _, vjp = jax.vjp(lambda a, s, b: jax_group_norm(a, scale=s, bias=b, **kw),
                     *map(jnp.asarray, (x, scale, bias)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    group_norm(leaves[0], scale=leaves[1], bias=leaves[2], **kw).backward(torch.from_numpy(g))
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4)


def test_autograd_functions_route_gradients(monkeypatch):
    """The card's autograd Functions, with their launches swapped for the
    plain versions, give the plain path's gradients (their backward
    plumbing: argument order, dtypes, the saved statistics)."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy((rng.standard_normal((2, 16, 8)) + 1).astype(np.float32))
    scale, bias = (torch.from_numpy(rng.standard_normal(8).astype(np.float32)) for _ in "ab")
    g = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(num_groups=2, eps=1e-5, act="silu")

    def launch(xx, s, b, n, e, a, od):
        return (group_norm_plain(xx, s, b, num_groups=n, eps=e, act=a, out_dtype=od),
                *group_stats_plain(xx, n, e))

    monkeypatch.setattr(gn_kernels, "_launch", launch)
    monkeypatch.setattr(gn_kernels, "fused_group_norm_bwd", group_norm_bwd_plain)
    grads = []
    for fn in (lambda *t: gn_kernels._FusedGroupNorm.apply(*t, 2, 1e-5, "silu", torch.bfloat16),
               lambda *t: group_norm_plain(*t, out_dtype=torch.bfloat16, **kw)):
        leaves = [t.clone().to(torch.bfloat16 if i == 0 else torch.float32).requires_grad_()
                  for i, t in enumerate((x, scale, bias))]
        out = fn(*leaves)
        assert out.dtype == torch.bfloat16
        grads.append(torch.autograd.grad(out, leaves, g))
    for a, b in zip(*grads):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b)

    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 32, 2, 8, seed=32))
    go = torch.from_numpy(rng.standard_normal((2, 32, 2, 8)).astype(np.float32))
    monkeypatch.setattr(fa_mod, "_launch", lambda qq, kk, vv, sc, with_lse=False: (
        attention_plain(qq, kk, vv, scale=sc), torch.zeros(qq.shape[0], qq.shape[2], qq.shape[1])))
    monkeypatch.setattr(fa_mod, "flash_attention_bwd", lambda qq, kk, vv, o, lse, gg, sc: (
        flash_attention_bwd_plain(qq, kk, vv, gg, sc)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_mod._FlashAttention.apply(*leaves, 0.3)
    got = torch.autograd.grad(out, leaves, go)
    for a, b in zip(got, flash_attention_bwd_plain(q, k, v, go, 0.3)):
        torch.testing.assert_close(a, b)


def _gn_inputs(c, groups, seed, near_constant=False):
    """x [2, 4, 4, C] (NHWC), scale, bias, output gradient; optionally the
    first group of sample 0 near-constant (var ~1e-6, well under eps)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 4, 4, c)) * 2 + 0.5).astype(np.float32)
    if near_constant:
        cg = c // groups
        x[0, ..., :cg] = 0.05 + 1e-3 * rng.standard_normal((4, 4, cg))
    scale, bias = (rng.standard_normal(c).astype(np.float32) for _ in range(2))
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, scale, bias, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("c,groups,near_constant", [(8, 4, False), (24, 4, True), (48, 4, False)],
                         ids=["width2", "width6-near-constant", "width12"])
def test_group_norm_bwd_plain_matches_jax_vjp_and_autograd(c, groups, near_constant, act,
                                                           dtype):
    x, scale, bias, g = _gn_inputs(c, groups, 50 + c, near_constant)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(num_groups=groups, eps=1e-5, act=act)
    _, vjp = jax.vjp(lambda a, s, b: jax_group_norm(a, scale=s, bias=b, **kw),
                     jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias))
    want_jax = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g))]

    xt = torch.from_numpy(x).to(td).reshape(2, 16, c)
    st, bt, gt = torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(g)
    leaves = [t.clone().requires_grad_() for t in (xt, st, bt)]
    group_norm_plain(*leaves, out_dtype=torch.float32, **kw).backward(gt.reshape(2, 16, c))
    mean, rstd = group_stats_plain(xt, groups, 1e-5)
    got = group_norm_bwd_plain(xt, gt.reshape(2, 16, c), st, bt, mean, rstd, num_groups=groups,
                               act=act)
    assert [t.dtype for t in got] == [td, torch.float32, torch.float32]
    for a, w_jax, leaf in zip(got, want_jax, leaves):
        w_jax = w_jax.reshape(a.shape)
        top = np.abs(w_jax).max()
        tol = (dict(rtol=1e-4, atol=1e-4 * top) if a.dtype == torch.float32
               else dict(rtol=BF16_RTOL, atol=BF16_RTOL * top))
        np.testing.assert_allclose(a.float().numpy(), w_jax, **tol)
        np.testing.assert_allclose(a.float().numpy(), leaf.grad.float().numpy(), **tol)


def _check_gn_plan(p, s, c, groups, itemsize, backward, batch=1):
    """A launch plan's invariants, as csrc/group_norm_silu.cu checks them:
    whole groups in a tile, S and the batch covered, shared memory within
    the limit and as the kernel lays it out, tickets within the buffer."""
    from phendiff_tpu_torch.ops.gn_kernels import (
        _TICKETS, MAX_CLUSTER, SMEM_LIMIT, _bwd_smem_bytes, _smem_bytes)

    assert p.cb % 8 == 0 and p.cb % (c // groups) == 0 and c % p.cb == 0  # whole groups
    assert 1 <= p.k <= MAX_CLUSTER and (p.k - 1) * p.rows < s <= p.k * p.rows  # covers S
    assert p.threads % 32 == 0 and p.threads <= (256 if backward else 512)
    assert p.smem <= SMEM_LIMIT
    if not backward:
        assert p.nb == 1 and _smem_bytes(p.rows, p.cb, itemsize, p.threads) == p.smem
        return
    assert _bwd_smem_bytes(p.nb, p.rows, p.cb, itemsize, p.threads) == p.smem
    nw = p.threads // 32
    assert 1 <= p.nb <= batch and (p.k == 1 or p.nb == 1)  # covers the batch
    assert p.nb >= nw or nw % p.nb == 0  # the warps split evenly over the samples
    assert -(-p.nb * p.rows // 256) <= 64  # TMA boxes of 256 rows, 64 mbarriers
    assert c // p.cb <= _TICKETS  # one ticket a channel slice


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_gn_plan_fits_every_main_path_call(itemsize, backward):
    from phendiff_tpu_torch.tools.kernel_calls import group_norm_calls

    calls = group_norm_calls()
    assert sum(calls.values()) == 41 and len({(s, c) for s, c, _, _ in calls}) == 12
    for s, c, groups, _ in calls:
        for batch in (1, 4, 32):
            p = gn_plan(s, c, groups, itemsize, backward, batch)
            _check_gn_plan(p, s, c, groups, itemsize, backward, batch)
            assert p.cb * itemsize >= 32  # a row is at least one sector
            # the route, and the tile's width and split, do not depend on the batch
            assert p[:3] == gn_plan(s, c, groups, itemsize, backward)[:3]
    with pytest.raises(ValueError):  # rows beyond 16 blocks' shared memory
        gn_plan(1 << 20, 192, 32, itemsize, backward)
    with pytest.raises(ValueError):  # a tile wider than 256 channels
        gn_plan(64, 1024, 2, itemsize, backward)


@pytest.mark.parametrize("batch", [8, 32, 64])
@pytest.mark.parametrize("latent", [16, 64])
def test_gn_backward_plan_fits_every_sd_unet_call(latent, batch):
    """SD-2.1's UNet backward calls (the guided step and the fine-tune step
    differentiate them) at the paths' batches: a plan whose blocks hold
    whole samples where a sample's tile fits one block, the batch covered
    once, and no more blocks than one wave where one wave can hold them."""
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.tools.kernel_calls import sd_unet_calls
    from phendiff_tpu_torch.ops.gn_kernels import _BWD_BLOCK_BYTES, _BWD_WAVE, gn_route

    calls = sd_unet_calls(SDUNetConfig(), latent, torch.bfloat16)["group_norm"]
    assert sum(calls.values()) == 61
    for s, c, groups, _, isz in calls:
        if gn_route(s, c, groups, isz, backward=True) != "cluster":
            continue
        p = gn_plan(s, c, groups, isz, True, batch)
        _check_gn_plan(p, s, c, groups, isz, True, batch)
        groups_of_samples = -(-batch // p.nb)
        assert (groups_of_samples - 1) * p.nb < batch  # no empty block
        blocks = p.k * (c // p.cb) * groups_of_samples
        more = p.nb + 1 if p.nb >= 8 else 2 * p.nb  # the next count the warps split over
        room = more <= batch and more * (2 * s * p.cb * isz + 24 * p.cb) <= _BWD_BLOCK_BYTES
        if p.k == 1 and room:  # a block could take more samples: the call fits one wave
            assert blocks <= _BWD_WAVE, (s, c, batch, p)


def test_gn_stream_backward_plan_takes_two_launches_in_whole_clusters():
    from phendiff_tpu_torch.ops.gn_kernels import _stream_bwd_plan

    for b, s, c, isz in [(1, 4096, 960, 4), (1, 4096, 1920, 4), (8, 262144, 128, 2),
                         (8, 262144, 256, 4), (1, 16384, 960, 2), (2, 100, 48, 4),
                         (3, 37, 2560, 2)]:
        nsplit, kc, rows, nsplit_dx = _stream_bwd_plan(b, s, c, isz)
        assert 1 <= kc <= 8 and nsplit % kc == 0 and 1 <= nsplit <= s  # whole clusters
        assert 1 <= c // 8 * rows <= 512 and 4 * 2 * (rows + 1) * c <= 232448
        assert 1 <= nsplit_dx <= s and nsplit_dx * b <= 2048 + b


def _preset_records(dtype):
    """Every GroupNorm and attention call, by shape, of one forward of each
    ``configs/denoiser`` preset at its own size, of full-width SD-2.1 at
    latent 16 and 64, and of the SD VAE's encode + decode at 128 and 512 px."""
    import glob

    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
    from phendiff_tpu_torch.models.config import UNet2DConfig
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.tools.kernel_calls import sd_unet_calls, unet_calls, vae_calls

    root = os.path.join(os.path.dirname(__file__), "..", "configs", "denoiser")
    records = {}
    for path in sorted(glob.glob(os.path.join(root, "*.json"))):
        cfg = UNet2DConfig.from_json(path)
        records[os.path.basename(path)[:-5]] = unet_calls(cfg, cfg.sample_size, dtype)
    for latent in (16, 64):
        records[f"sd21_latent{latent}"] = sd_unet_calls(SDUNetConfig(), latent, dtype)
    for res in (128, 512):
        records[f"vae_{res}px"] = vae_calls(AutoencoderKLConfig(), res, dtype)
    return records


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_every_preset_call_has_a_kernel_plan_the_stream_variant_or_the_counted_route(dtype):
    from phendiff_tpu_torch.ops import attention
    from phendiff_tpu_torch.ops.gn_kernels import gn_route

    itemsize = torch.finfo(getattr(torch, dtype)).bits // 8
    records = _preset_records(getattr(torch, dtype))
    assert len(records) == 8 and all(r["group_norm"] for r in records.values())
    streamed, xla = set(), {}
    for name, rec in records.items():
        for (s, c, groups, act, isz), _ in rec["group_norm"].items():
            assert isz == itemsize, name
            for backward in (False, True):
                if gn_route(s, c, groups, isz, backward) == "cluster":
                    for batch in (1, 8, 64):
                        p = gn_plan(s, c, groups, isz, backward, batch)
                        _check_gn_plan(p, s, c, groups, isz, backward, batch)
                else:  # the streaming variant's constraints (csrc check_stream)
                    assert c % 8 == 0 and c % groups == 0 and c // 8 <= 512, (name, s, c)
                    streamed.add((name, s, c, backward))
        for (s_q, s_kv, h, d, isz), n in rec["attention"].items():
            if attention.takes_kernel(s_q, s_kv, d):
                assert s_q == s_kv and d <= 64
            else:  # cross-attention or D > 64: the counted attention_plain route
                assert s_q != s_kv or d > 64
                xla[name] = xla.get(name, 0) + n
    # the shapes that had no plan before the streaming variant
    assert ("vae_512px", 262144, 128, False) in streamed
    assert ("vae_512px", 262144, 256, True) in streamed
    assert ("sd21_size", 16384, 960, False) in streamed
    if dtype == "float32":
        assert ("ddpm_unconditional_256", 65536, 128, True) in streamed
    assert not any(n.startswith(("super_small", "small")) for n, *_ in streamed)
    # one head of D = 512, and the SD UNet's 16 cross-attentions a forward
    assert xla["ddpm_unconditional_256"] == 6
    assert xla["sd21_latent16"] == xla["sd21_latent64"] == 16
    assert "super_small" not in xla and records["vae_512px"]["single_head_attention"] == 2


def test_attention_design_takes_wgmma_only_for_bf16_d64_from_the_threshold():
    """The kernel design of every self-attention shape the port runs:
    SD-2.1's at 128 and 512 px (latents 16 and 64, levels of side latent /
    2**i, heads of 64), the DDIM main path's (S = 1024, D = 8), padded head
    dims; in bf16 and f32."""
    from phendiff_tpu_torch.ops.flash_attention import WGMMA_MIN_S, attention_design

    bf16, f32 = torch.bfloat16, torch.float32
    sd = sorted({(lat >> i) ** 2 for lat in (16, 64) for i in range(4)})
    assert sd == [4, 16, 64, 256, 1024, 4096]
    for s in sd:
        assert attention_design(s, 64, bf16) == ("wgmma" if s >= WGMMA_MIN_S else "mma_sync")
        assert attention_design(s, 64, f32) == "fma"
    # both designs serve SD-2.1's shapes: the threshold lies inside them
    assert {attention_design(s, 64, bf16) for s in sd} == {"wgmma", "mma_sync"}
    for s in (1024, 4096, 17):  # D = 8 (the DDIM main path) and D = 4 padded to 8
        for d in (8, 4):
            assert attention_design(s, d, bf16) == "mma_sync"
            assert attention_design(s, d, f32) == "fma"
    assert attention_design(4096, 40, bf16) == "wgmma"  # padded up to 64
    with pytest.raises(TypeError):
        attention_design(4096, 64, torch.float16)


def test_attention_design_takes_wgmma_for_bf16_d72_at_every_s():
    """DiT-XL/2's heads of 72 have one bf16 design, the warpgroup kernel,
    below WGMMA_MIN_S too (D = 72 has no mma.sync kernel); f32 takes fma."""
    from phendiff_tpu_torch.ops.flash_attention import WGMMA_MIN_S, attention_design

    for s in (1, 17, 256, 300, 1024, 4096, WGMMA_MIN_S - 1):
        for d in (72, 65):  # 65 is padded up to 72
            assert attention_design(s, d, torch.bfloat16) == "wgmma"
            assert attention_design(s, d, torch.float32) == "fma"
    with pytest.raises(ValueError):
        attention_design(1024, 73, torch.bfloat16)


def test_attention_routes_count_the_calls_that_skip_the_kernel():
    from phendiff_tpu_torch.models.config import UNet2DConfig
    from phendiff_tpu_torch.models.unet2d import CondUNet2D
    from phendiff_tpu_torch.ops.routes import plain_kernels

    cfg = UNet2DConfig.from_json(os.path.join(os.path.dirname(__file__), "..", "configs",
                                              "denoiser", "ddpm_unconditional_256.json"))
    before = multi_head_attention.xla_route_calls
    with plain_kernels(), torch.device("meta"):
        CondUNet2D(cfg)(torch.zeros(1, 256, 256, 3), torch.zeros(1, dtype=torch.long))
    assert multi_head_attention.xla_route_calls - before == 6  # D = 512 > 64
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 77, 2, 8)).astype(np.float32))
    before = multi_head_attention.xla_route_calls
    np.testing.assert_allclose(
        multi_head_attention(q, kv, kv).numpy(),
        np.asarray(attention_xla(jnp.asarray(q.numpy()), jnp.asarray(kv.numpy()),
                                 jnp.asarray(kv.numpy()))), atol=1e-6)
    multi_head_attention(q, q, q)  # self-attention at D <= 64: the kernel's route
    assert multi_head_attention.xla_route_calls - before == 1


@pytest.mark.parametrize("preset,resnets", [("ddim_super_small_128", 17), ("sd21_latent16", 22)])
def test_every_resnet_block_hands_its_time_embedding_to_the_second_group_norm(preset, resnets):
    """The recorder's addend calls: one a ResnetBlock (its second GroupNorm,
    with SiLU), each on the cluster route, so on the card, outside autograd,
    each takes the addend into the kernel and no broadcast add is launched."""
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.tools.kernel_calls import sd_unet_calls, unet_calls

    rec = (unet_calls(super_small(), 128) if preset.startswith("ddim")
           else sd_unet_calls(SDUNetConfig(), 16))
    assert sum(rec["group_norm_addend"].values()) == resnets
    for (s, c, groups, act, isz), n in rec["group_norm_addend"].items():
        assert act == "silu" and n <= rec["group_norm"][(s, c, groups, act, isz)]
        assert gn_kernels.gn_route(s, c, groups, isz) == "cluster"


def test_plain_kernels_route_the_unet_through_plain_versions_and_restore():
    from phendiff_tpu_torch.ops import attention, group_norm
    from phendiff_tpu_torch.ops import residual_bias as RB
    from phendiff_tpu_torch.ops.routes import plain_kernels

    saved = group_norm.fused_group_norm, attention.flash_attention, RB.residual_bias
    x = torch.randn(1, 4, 8, device="meta")  # the kernels' wrappers refuse meta tensors
    with pytest.raises(ValueError):
        group_norm.fused_group_norm(x, None, None, num_groups=2, eps=1e-5)
    with pytest.raises(ValueError):
        RB.residual_bias(x, x, x[0, 0])
    with pytest.raises(KeyError), plain_kernels():
        assert group_norm.fused_group_norm(x, None, None, num_groups=2, eps=1e-5).shape == x.shape
        q = torch.randn(1, 4, 2, 8, device="meta")
        assert attention.flash_attention(q, q, q).shape == q.shape
        assert RB.residual_bias(x, x, x[0, 0], x[0, 0]).shape == x.shape
        raise KeyError  # restored on the way out of an error too
    assert (group_norm.fused_group_norm, attention.flash_attention, RB.residual_bias) == saved


def test_channel_moments_plain_matches_float64():
    rng = np.random.default_rng(41)
    x = (rng.standard_normal((3, 512, 16)) + 0.5).astype(np.float32)
    s, q = channel_moments(torch.from_numpy(x).to(torch.bfloat16))
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    assert s.dtype == q.dtype == torch.float32 and s.shape == (3, 16)
    np.testing.assert_allclose(s.numpy(), xb.sum(1), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(q.numpy(), (xb ** 2).sum(1), rtol=1e-5)
