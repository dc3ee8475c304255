"""Pipeline placement: the segmented SD UNet's stages spread over devices.

Counterpart of ``phendiff_tpu/parallel/pp.py``, in one process.  Each
stage of ``models/sd_segmented.py`` (stem, down levels, mid, up levels,
out) lives on one device with its weights, and activations move between
stages with ``.to(device, non_blocking=True)`` only where the device
changes, so a UNet (or a UNet and its optimizer state) that one card
cannot hold runs across several.

* ``stage_devices`` assigns contiguously: stage i of S goes to device
  floor(i * D / S), so neighbouring stages share a device and S stages on
  D devices pay D - 1 boundary copies a microbatch; the skip tensors move
  once, when the up stage that consumes them runs.
* ``num_microbatches`` dispatches microbatch-major: the host loops the
  chunks through the chain in order, and each card runs its stages' work as
  the copies land (CUDA launches return at once), so chunk k + 1 can run
  on stage s - 1's card while chunk k runs on stage s's.
* Training composes the same placement with the per-stage VJP chain: pass
  ``device_of=stage_devices(stage_keys(cfg), devices)`` to
  ``train/segmented_train.py::SegmentedSDTrainStep``.

``devices=None`` means every card this process sees; with none it raises
(no CPU fallback: tests pass ``["cpu"] * k``).  Under data parallelism each
process owns one card, so the comparison engine refuses placement there.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch

from phendiff_tpu_torch.core.device import DeviceLike
from phendiff_tpu_torch.models.sd_segmented import SegmentedSDUNet, stage_keys, stage_names
from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig

__all__ = ["PipelinedSDUNet", "stage_devices", "stage_keys"]


def stage_devices(keys: Sequence[str], devices: Sequence) -> Dict[str, object]:
    """Contiguous assignment: stage i of S onto device floor(i * D / S)."""
    S, D = len(keys), len(devices)
    return {k: devices[(i * D) // S] for i, k in enumerate(keys)}


def visible_devices() -> List[torch.device]:
    """Every card this process sees; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("pipeline placement needs CUDA devices (none visible); "
                           "pass devices= explicitly")
    return [torch.device("cuda", i) for i in range(n)]


class PipelinedSDUNet:
    """The segmented SD UNet with each stage on its device.

    ``unet_or_cfg`` is an ``SDUNet`` (its weights are placed) or an
    ``SDUNetConfig`` (built on the meta device in ``dtype``; ``place_params``
    then takes a state dict)::

        pp = PipelinedSDUNet(unet, devices=["cuda:0", "cuda:1"])
        pp.place_params()                      # each stage onto its card
        eps = pp(latents, t, ctx, num_microbatches=4)
    """

    def __init__(self, unet_or_cfg: Union[SDUNet, SDUNetConfig],
                 devices: Optional[Sequence[DeviceLike]] = None,
                 dtype: torch.dtype = torch.float32):
        if isinstance(unet_or_cfg, SDUNetConfig):
            with torch.device("meta"):
                unet_or_cfg = SDUNet(unet_or_cfg, dtype=dtype)
        self.seg = SegmentedSDUNet(unet_or_cfg)
        self.cfg = self.seg.cfg
        self.devices = [torch.device(d) for d in
                        (devices if devices is not None else visible_devices())]
        self.keys = stage_keys(self.cfg)
        self.device_of: Dict[str, torch.device] = stage_devices(self.keys, self.devices)
        self._stage_of = {name: key for key in self.keys for name in stage_names(self.cfg, key)}

    @property
    def unet(self) -> SDUNet:
        return self.seg.unet

    # -- parameters ---------------------------------------------------------
    def place_params(self, params: Optional[Mapping[str, torch.Tensor]] = None) -> SDUNet:
        """Move each stage's submodules, and the root ``norm_out_*``
        parameters, to its device; with ``params`` (a state dict of the
        UNet) load them first, each tensor straight onto its stage's device.
        Placing placed weights moves nothing."""
        if params is not None:
            self.unet.load_state_dict(
                {n: t.to(self.device_of[self._stage_of[n.split(".")[0]]])
                 for n, t in params.items()}, assign=True)
            self.seg = SegmentedSDUNet(self.unet)  # the stages hold the new tensors
        for key in self.keys:
            self.seg.stages[key].to(self.device_of[key])
        return self.unet

    # -- forward ------------------------------------------------------------
    def _move(self, key: str, *tensors: torch.Tensor):
        dev = self.device_of[key]
        return tuple(t if t.device == dev else t.to(dev, non_blocking=True) for t in tensors)

    def _run_chunk(self, sample, timesteps, ctx) -> torch.Tensor:
        return self.seg._forward(sample, timesteps, ctx, None, move=self._move)

    def __call__(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                 *, num_microbatches: int = 1) -> torch.Tensor:
        """The model output on ``sample``'s device, in its dtype."""
        home = sample.device
        b = sample.shape[0]
        if num_microbatches <= 1:
            out = self._run_chunk(sample, timesteps, encoder_hidden_states)
        else:
            if b % num_microbatches:
                raise ValueError(f"batch {b} not divisible by num_microbatches="
                                 f"{num_microbatches}")
            m = b // num_microbatches
            t = torch.as_tensor(timesteps, device=home).expand(b)
            # microbatch-major: every chunk's stage calls are queued before
            # any output is read
            outs = [self._run_chunk(sample[k * m:(k + 1) * m], t[k * m:(k + 1) * m],
                                    encoder_hidden_states[k * m:(k + 1) * m])
                    for k in range(num_microbatches)]
            out = torch.cat([o.to(home, non_blocking=True) for o in outs])
        return out.to(home).to(sample.dtype)

    def forward_with_input_vjp(self, sample: torch.Tensor, timesteps,
                               encoder_hidden_states: torch.Tensor):
        """``(pred, vjp_fn: ct -> d sample)`` with every stage's forward and
        input VJP on that stage's device; cotangents walk back over the
        same copies in reverse.  Both outputs land on ``sample``'s device
        (the guided head adds them to each other and to the latents).  The
        numbers are ``SegmentedSDUNet.forward_with_input_vjp``'s: placement
        moves tensors, never math."""
        home = sample.device
        pred, vjp_fn = self.seg.forward_with_input_vjp(sample, timesteps, encoder_hidden_states,
                                                       move=self._move)
        return pred.to(home), lambda ct: vjp_fn(ct).to(home)

