"""The DiT boundary wrapper (``ops/adaln_norm.py``) on the CPU: its plain
route is the composition DiT ran before the kernel (``addcmul`` for the
gated residual, ``layer_norm``, ``addcmul`` for the modulate), bit for bit
in float32; ``refusal`` names what keeps a call off the kernel, and a call
off the CPU that the kernel cannot take raises with that name (meta
tensors stand in for the card's); the counters count each call's route and
each op of the composition.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from phendiff_tpu_torch.ops import adaln_norm as A

torch.set_num_threads(1)
EPS = 1e-6


def _inputs(b=2, s=5, c=16, dtype=torch.float32, seed=0, device="cpu"):
    """x, y [B, S, C] and the [B, 6, C] modulation's unbind views (row
    stride 6C), scales near 1."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, c, generator=g).to(device, dtype)
    y = torch.randn(b, s, c, generator=g).to(device, dtype)
    mod = (0.5 * torch.randn(b, 6, c, generator=g)).to(device, dtype)
    mod[:, 1::3] += 1
    return x, y, mod.unbind(1)


def _composition(x, gate, y, shift, scale1p):
    """DiT's three ops in their order: x + gate y, LayerNorm, x (1 + scale) + shift."""
    if y is not None:
        x = torch.addcmul(x, gate[:, None], y)
    z = torch.addcmul(shift[:, None], F.layer_norm(x, x.shape[-1:], eps=EPS), scale1p[:, None])
    return x, z


@pytest.mark.parametrize("variant", ["full", "no_y", "no_write"])
def test_plain_route_is_the_composition_bit_for_bit(variant):
    x, y, (_, _, gate, shift, scale1p, _) = _inputs()
    if variant == "no_y":
        gate = y = None
    keep = variant != "no_write"
    launches, plain, ops = A.adaln_norm.launches, A.adaln_norm.plain_calls, A.adaln_norm_plain.ops
    got_x, got_z = A.adaln_norm(x, gate, y, shift, scale1p, eps=EPS, keep_x=keep)
    assert A.adaln_norm_plain.ops == ops + (2 if y is None else 3)
    want_x, want_z = _composition(x, gate, y, shift, scale1p)
    assert torch.equal(got_z, want_z)
    if variant == "no_write":
        assert got_x is None
    elif variant == "no_y":
        assert got_x is x
    else:
        assert torch.equal(got_x, want_x)
    assert (A.adaln_norm.launches, A.adaln_norm.plain_calls) == (launches, plain + 1)


def test_every_cpu_call_counts_as_plain():
    x, y, (_, _, gate, shift, scale1p, _) = _inputs(dtype=torch.bfloat16)
    plain = A.adaln_norm.plain_calls
    for _ in range(3):
        A.adaln_norm(x, gate, y, shift, scale1p, eps=EPS)
    A.adaln_norm(x, None, None, shift, scale1p, eps=EPS)
    assert A.adaln_norm.plain_calls == plain + 4


def test_a_recording_autograd_on_the_cpu_takes_the_composition_and_differentiates():
    x, y, (_, _, gate, shift, scale1p, _) = _inputs()
    y = y.requires_grad_()
    assert A.refusal(x, gate, y, shift, scale1p) == "autograd records"
    plain = A.adaln_norm.plain_calls
    _, z = A.adaln_norm(x, gate, y, shift, scale1p, eps=EPS)
    assert A.adaln_norm.plain_calls == plain + 1
    dy, = torch.autograd.grad(z.square().sum(), (y,))
    y2 = y.detach().requires_grad_()
    want, = torch.autograd.grad(_composition(x, gate, y2, shift, scale1p)[1].square().sum(), (y2,))
    assert torch.equal(dy, want)
    with torch.no_grad():  # not recording: only the device keeps it off the kernel
        assert A.refusal(x, gate, y, shift, scale1p) == "device"


def _case(name, device="cpu"):
    """(x, gate, y, shift, scale1p) that ``refusal`` refuses for ``name``."""
    x, y, (_, _, gate, shift, scale1p, _) = _inputs(device=device)
    if name == "dtype: float16":
        return x.half(), gate.half(), y.half(), shift.half(), scale1p.half()
    if name == "dtype: mixed":
        return x.bfloat16(), gate, y.bfloat16(), shift, scale1p
    if name == "shape: C % 8":
        x, y, (_, _, gate, shift, scale1p, _) = _inputs(c=12, device=device)
    elif name == "shape: C > 1280":
        x, y, (_, _, gate, shift, scale1p, _) = _inputs(s=1, c=1288, device=device)
    elif name == "shape: broadcast rows":
        shift = shift[:1]
    elif name == "layout: x transposed":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif name == "layout: rows strided":
        scale1p = torch.stack([scale1p, scale1p], -1)[..., 0]
    elif name == "layout: row stride not 16 bytes":
        # [B, C] rows 18 floats apart: 72 bytes, not a whole 16-byte vector
        scale1p = torch.zeros(2, 18, device=device)[:, :16]
    return x, gate, y, shift, scale1p


CASES = ["dtype: float16", "dtype: mixed", "shape: C % 8", "shape: C > 1280",
         "shape: broadcast rows", "layout: x transposed", "layout: rows strided",
         "layout: row stride not 16 bytes"]


@pytest.mark.parametrize("name", CASES)
def test_refusal_names_what_keeps_a_call_off_the_kernel(name):
    """On the CPU such a call takes the composition all the same."""
    args = _case(name)
    assert A.refusal(*args) == name.split(":")[0]
    plain = A.adaln_norm.plain_calls
    A.adaln_norm(*args, eps=EPS)
    assert A.adaln_norm.plain_calls == plain + 1


@pytest.mark.parametrize("name", CASES + ["device: meta", "autograd records: y"])
def test_a_call_off_the_cpu_the_kernel_cannot_take_raises_naming_why(name):
    """Off the CPU no call takes the composition: the kernel or an error
    that names ``refusal``'s finding (meta tensors: the device, where
    nothing else is against the call)."""
    args = list(_case(name, device="meta"))
    why = name.split(":")[0]
    if why == "autograd records":
        args[2].requires_grad_()
    counts = A.adaln_norm.launches, A.adaln_norm.plain_calls, A.adaln_norm_plain.ops
    with pytest.raises(TypeError if why == "dtype" else ValueError, match=f"\\({why}\\)"):
        A.adaln_norm(*args, eps=EPS)
    assert (A.adaln_norm.launches, A.adaln_norm.plain_calls, A.adaln_norm_plain.ops) == counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_modulation_unbind_views_pass_everything_but_the_device(dtype):
    """The [B, 6, C] and [B, 2, C] projections' unbind views (row strides 6C
    and 2C, no copy) and a [B, 1024, 1152] map pass every check the kernel
    makes of its inputs; on the CPU only the device fails."""
    x, y, (_, _, gate, _, _, _) = _inputs(b=2, s=1024, c=1152, dtype=dtype)
    fin = torch.randn(2, 2, 1152).to(dtype)
    shift, scale1p = fin.unbind(1)
    assert gate.stride(0) == 6 * 1152 and shift.stride(0) == 2 * 1152
    assert A.refusal(x, gate, y, shift, scale1p) == "device"
    assert A.refusal(x, None, None, shift, scale1p) == "device"
