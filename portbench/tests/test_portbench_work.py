"""The work counts: FLOPs and bytes against hand arithmetic at a tiny size,
and the full-width figures on the meta device."""

import math

import pytest
import torch

from portbench.families import ddim, sd
from portbench.harness import peaks, spec, work
from portbench.harness.trace import Stretch, categorize, reduce_events
from portbench.reference import models as R

DDIM = spec.load_json(spec.PACKAGE / "configs" / "ddim_super_small_128.json")
SD = spec.load_json(spec.PACKAGE / "configs" / "sd21_128.json")


def test_a_conv_and_an_attention_count_as_by_hand():
    def conv(rec):
        with torch.device("meta"):
            x = torch.zeros(2, 8, 8, 4)
            rec.conv(x, torch.zeros(6, 4, 3, 3), None, 1, 1)

    flops, calls = work.count(conv)
    assert flops == 2 * (2 * 8 * 8) * 6 * (4 * 9)
    assert calls.attention == {} and calls.group_norm == {}

    def attn(rec):
        with torch.device("meta"):
            q = torch.zeros(3, 16, 2, 8)
            rec.attention(q, q, q)
            rec.group_norm(torch.zeros(3, 4, 4, 8), 2, 1e-5, torch.ones(8), torch.zeros(8), True)

    flops, calls = work.count(attn)
    assert flops == 3 * 2 * 4 * 16 * 16 * 8
    assert calls.attention == {(16, 2, 8): 3} and calls.group_norm == {(16, 8): 3}
    forward = 3 * max(4 * 16 * 16 * 8 * 2 / peaks.BF16_FLOPS, 4 * 16 * 2 * 8 * 2 / peaks.HBM_BYTES)
    assert work.attention_least_s(calls, 2, False) == pytest.approx(forward)
    backward = 3 * max(10 * 16 * 16 * 8 * 2 / peaks.BF16_FLOPS,
                       (8 * 16 * 2 * 8 * 2 + 4 * 16 * 2) / peaks.HBM_BYTES)
    assert work.attention_least_s(calls, 2, True) == pytest.approx(forward + backward)
    assert work.group_norm_least_s(calls, 2) == pytest.approx(3 * 2 * 16 * 8 * 2 / peaks.HBM_BYTES)
    assert work.group_norm_least_s(calls, 2, calls) == pytest.approx(
        3 * 5 * 16 * 8 * 2 / peaks.HBM_BYTES)


def test_the_full_width_counts_on_the_meta_device():
    per_image = ddim.work_transfer(DDIM)["denoiser"]
    assert per_image[0] == pytest.approx(74.672766976e9, rel=1e-9)
    assert per_image[1].attention == {(1024, 32, 8): 6}
    assert sum(per_image[1].group_norm.values()) == 41
    assert sum(math.prod(s) for _, s, _, _ in ddim.specs(DDIM)) == 15_725_443
    w = sd.work_transfer(SD)
    assert w["denoiser"][0] == pytest.approx(46.83098112e9, rel=1e-9)
    assert w["encode"][0] == pytest.approx(67.777888256e9, rel=1e-9)
    assert w["decode"][0] == pytest.approx(155.144167424e9, rel=1e-9)
    assert w["denoiser"][1].attention == {(256, 5, 64): 5, (64, 10, 64): 5, (16, 20, 64): 5,
                                          (4, 20, 64): 1}
    assert w["encode"][1].attention == {} and w["decode"][1].attention == {}
    sizes = {}
    for name, shape, _, _ in sd.specs(SD):
        sizes[name.split(".")[0]] = sizes.get(name.split(".")[0], 0) + math.prod(shape)
    assert sizes == {"unet": 865_910_724, "vae": 83_653_863, "class_embedding": 2048}
    train = sd.work_train(SD)
    assert train["step_flops"] > 3 * w["denoiser"][0]
    assert sum(train["forward"].group_norm.values()) == 61 + 22


def _event(name, start_us, dur_us, cuda):
    class E:
        def device_type(self):
            return torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

        def start_ns(self):
            return int(start_us * 1000)

        def duration_ns(self):
            return int(dur_us * 1000)

    e = E()
    e.name = lambda: name
    return e


def test_a_trace_reduces_to_busy_time_categories_and_idle_by_span():
    events = [
        _event("stretch", 0, 100, False),
        _event("stretch", 0, 100, True),  # a span's range on the device's timeline
        _event("ddib.call", 10, 30, False),
        _event("gn_fwd_cluster<bf16>", 20, 10, True),
        _event("flash_fwd_mma_kernel", 25, 10, True),
        _event("sm90_xmma_gemm", 60, 20, True),
        _event("Memcpy HtoD", 90, 5, True),
    ]
    s = reduce_events(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.launches == 3
    assert s.seconds(("group_norm_silu",)) == pytest.approx(10e-6)
    # a gap counts for the span the host was in when the device went idle
    assert s.idle_by_span["ddib.call"] == pytest.approx(25e-6)
    assert s.idle_by_span["harness"] == pytest.approx(35e-6)
    assert isinstance(s, Stretch)
    assert categorize("void pytorch_flash::flash_fwd_kernel<>") == "flash_attn_fwd"
    assert categorize("fmha_cutlassF_bf16_aligned_64x64_rf_sm80") == "library_attention"
    assert categorize("void at::native::RowwiseMomentsCUDAKernel<float>") == "library_group_norm"
    assert categorize("multi_tensor_apply_kernel") == "optimizer"


def test_the_recorder_sees_the_reference_models_calls():
    rec = R.Recorder()
    with torch.device("meta"):
        unet = R.CondUNet2D(DDIM["unet"])
        unet(rec, torch.zeros(2, 128, 128, 3), torch.zeros(2, dtype=torch.long),
             torch.zeros(2, 256))
    assert rec.attention_calls == {(1024, 32, 8): 12}
