"""The ResnetBlock's deferred conv biases on the CPU.

``ops/residual_bias.py``'s plain version is x + h + bias (+ bias2) in f32,
rounded once; ``refusal`` names what keeps a call off the kernel (meta
tensors stand in for a device that is neither the card nor the CPU).  A
ResnetBlock that no autograd records and no shard marks runs its convs
bias-free and hands the biases on (conv1's to the second GroupNorm's
addend, conv2's and the shortcut's to the residual): in float32 it equals
the block that adds each bias in its conv, which it runs where autograd
records, to f32 rounding of sums taken in another order (1e-5 relative).
The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""

import pytest
import torch

from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.models.unet2d import CondUNet2D, ResnetBlock
from phendiff_tpu_torch.ops import residual_bias as RB
from phendiff_tpu_torch.ops.routes import launch_counts, plain_kernels, record_calls

torch.set_num_threads(1)
REL = 1e-5


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def _maps(c=16, dtype=torch.float32, two=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    x, h = (torch.randn(2, 3, 5, c, generator=g).to(dtype) for _ in range(2))
    b, b2 = (torch.randn(c, generator=g).to(dtype) for _ in range(2))
    return x, h, b, (b2 if two else None)


def _random_biases(module, seed=1):
    """Flax's initialisers zero every bias; draw them, so a lost bias shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g))
    return module


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_sum_rounded_once(dtype, two):
    x, h, b, b2 = _maps(dtype=dtype, two=two)
    plain = RB.residual_bias.plain_calls
    got = RB.residual_bias(x, h, b, b2)
    assert RB.residual_bias.plain_calls == plain + 1
    want = x.float() + h.float() + b.float() + (0 if b2 is None else b2.float())
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:  # one rounding of the f32 sum
        assert torch.equal(got, want.to(dtype))


def _refused(name):
    x, h, b, b2 = _maps()
    if name == "shape: C % 8":
        x, h, b, b2 = _maps(c=12)
    elif name == "shape: bias length":
        b2 = b2[:8]
    elif name == "shape: maps differ":
        h = h[:1]
    elif name == "dtype: float16":
        x, h, b, b2 = (t.half() for t in (x, h, b, b2))
    elif name == "dtype: mixed":
        b = b.bfloat16()
    elif name == "layout: h transposed":
        h = h.transpose(1, 2).contiguous().transpose(1, 2)
    elif name == "autograd records":
        h.requires_grad_()
    elif name == "device: meta":
        x, h, b, b2 = (t.to("meta") for t in (x, h, b, b2))
    return x, h, b, b2


REFUSED = ["shape: C % 8", "shape: bias length", "shape: maps differ", "dtype: float16",
           "dtype: mixed", "layout: h transposed", "autograd records", "device: meta"]


@pytest.mark.parametrize("name", REFUSED)
def test_refusal_names_what_keeps_a_call_off_the_kernel(name):
    assert RB.refusal(*_refused(name)) == name.split(":")[0]
    assert RB.refusal(*_maps()) is None


BLOCKS = {"default": ("default", 16), "default_shortcut": ("default", 8),
          "scale_shift": ("scale_shift", 16), "scale_shift_shortcut": ("scale_shift", 8)}


@pytest.mark.parametrize("variant", sorted(BLOCKS))
def test_deferred_block_equals_the_block_that_adds_its_biases(variant):
    """Under no_grad the block defers (one residual call); with autograd
    recording it adds each bias in its conv (no residual call).
    scale_shift keeps conv1's bias and defers the residual's alone."""
    shift, cin = BLOCKS[variant]
    block = _random_biases(ResnetBlock(cin, 16, 24, norm_num_groups=4, time_scale_shift=shift))
    g = torch.Generator().manual_seed(2)
    x, temb = torch.randn(2, 6, 6, cin, generator=g), torch.randn(2, 24, generator=g)
    before = launch_counts()
    with torch.no_grad():
        got = block(x, temb)
    after = launch_counts()
    assert after["residual_bias_plain_calls"] - before["residual_bias_plain_calls"] == 1
    want = block(x, temb)
    assert want.grad_fn is not None
    assert launch_counts() == after
    assert _rel(got, want) < REL


def _tiny_unet(channels):
    cfg = UNet2DConfig(sample_size=16, block_out_channels=channels, layers_per_block=1,
                       down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                       up_block_types=("AttnUpBlock2D", "UpBlock2D"), norm_num_groups=8,
                       attention_head_dim=8, num_class_embeds=2)
    return _random_biases(CondUNet2D(cfg).init_weights(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("channels,deferred", [((16, 32), 8), ((12, 24), 5)])
def test_unet_forward_under_no_grad_equals_the_recorded_forward(channels, deferred):
    """Under no_grad each of the 8 ResnetBlocks whose output width is a
    multiple of 8 defers (at (12, 24) the 5 of 24; the residual's refusal
    names the other 3's width), none where autograd records; the outputs
    agree."""
    model = _tiny_unet(channels)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 16, 3, generator=g)
    t, labels = torch.tensor([10, 900]), torch.tensor([0, 1])
    n0 = RB.residual_bias.plain_calls
    with torch.no_grad():
        got = model(x, t, class_labels=labels)
    assert RB.residual_bias.plain_calls - n0 == deferred
    n0 = RB.residual_bias.plain_calls
    want = model(x, t, class_labels=labels)
    assert want.grad_fn is not None and RB.residual_bias.plain_calls == n0
    assert _rel(got, want) < REL


def test_unet_on_the_meta_device_keeps_the_biases_in_the_convs():
    """The call recorders run models on the meta device: no block defers
    there (the residual's refusal names the device)."""
    model = _tiny_unet((16, 32)).to("meta")
    meta = dict(device="meta")
    keys = ("residual_bias", "residual_bias_plain_calls")
    n0 = [launch_counts()[k] for k in keys]
    with torch.no_grad():
        calls = record_calls(lambda: model(torch.empty(2, 16, 16, 3, **meta),
                                           torch.tensor([1, 2], **meta),
                                           class_labels=torch.tensor([0, 1], **meta)))
    assert sum(calls["group_norm_addend"].values()) == 8
    assert [launch_counts()[k] for k in keys] == n0


def test_plain_kernels_route_the_deferred_residual_through_the_plain_version():
    """Under ``plain_kernels`` a deferring block calls the plain version
    itself (the wrapper, and so its counters, stay out) and gives the bits
    the wrapper gives; the wrapper is back on exit."""
    model = _tiny_unet((16, 32))
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, 16, 3, generator=g)
    t, labels = torch.tensor([10, 900]), torch.tensor([0, 1])
    wrapper = RB.residual_bias
    with torch.no_grad():
        got = model(x, t, class_labels=labels)
        n0 = RB.residual_bias.plain_calls
        with plain_kernels():
            plain = model(x, t, class_labels=labels)
    assert RB.residual_bias is wrapper and RB.residual_bias.plain_calls == n0
    assert torch.equal(got, plain)
