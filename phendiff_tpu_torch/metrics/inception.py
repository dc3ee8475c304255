"""InceptionV3 (FID variant) feature extractor.

Counterpart of ``phendiff_tpu/metrics/inception.py``: pool3 features
[B, 2048] and the 1008-way logits of the network torch-fidelity pins for
FID/ISC/KID, with its FID details: average pools that exclude the padding,
a max pool in ``Mixed_7c``'s pool branch, BatchNorm eps 1e-3 (inference
statistics), a 1008-way ``fc``.  Module names are torch-fidelity's
(``Mixed_5b.branch1x1.conv.weight``, ...), so its state dict loads with no
renaming (the training-time ``AuxLogits`` head is dropped), and
``from_flax_variables`` carries the JAX model's ``{params, batch_stats}``
across.

Without a weights file the network is a seeded random init (Flax's
initialisers) and ``pretrained`` is False: its FID is a random-projection
distance, not comparable to torch-fidelity's or across machines.  Set
``PHENDIFF_INCEPTION_WEIGHTS=/path/to/pt-or-safetensors`` for parity.

Input contract: NHWC float in [0, 1]; resized to 299x299 bilinear
(antialiased when shrinking), then scaled to [-1, 1].  Convolutions run in
float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from phendiff_tpu_torch.core.device import DeviceLike, resolve_device

FEATURE_DIM = 2048
NUM_LOGITS = 1008
WEIGHTS_ENV = "PHENDIFF_INCEPTION_WEIGHTS"
# Test knob: shrink the input resolution (16x cheaper on a CPU; honoured
# with random-init weights only, never with real ones).
RESIZE_ENV = "PHENDIFF_INCEPTION_RESIZE"


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class BasicConv2d(nn.Module):
    """conv -> BatchNorm (eps 1e-3, running statistics) -> relu."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=bn.eps)
        return F.relu(x)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool(x)),
        ], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, stride=2),
        ], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool_mode``: "avg" in Mixed_7b; "max" in Mixed_7c (the FID variant)."""

    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = _avg_pool(x) if self.pool_mode == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3(nn.Module):
    """NCHW in [-1, 1] -> (pool3 features [B, 2048], logits [B, 1008])."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(FEATURE_DIM, NUM_LOGITS)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        features = x.mean(dim=(2, 3))
        return features, self.fc(features)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "InceptionV3":
        """Flax's default initialisers, drawn from ``generator`` on the CPU:
        truncated lecun-normal conv and dense kernels, a zero dense bias,
        BatchNorm scale 1, bias 0, mean 0, var 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                s = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, s, -2 * s, 2 * s, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``InceptionV3``'s ``{params, batch_stats}`` -> this module's
    state dict: conv kernels HWIO -> OIHW, the Dense kernel transposed
    (the inverse of the JAX package's ``convert_torch_weights``)."""
    names = {("params", "kernel"): "weight", ("params", "scale"): "weight",
             ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
             ("batch_stats", "var"): "running_var"}
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables[collection]):
            *mods, leaf_name = path
            if leaf_name == "kernel":
                leaf = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T
            sd[".".join([*mods, names[(collection, leaf_name)]])] = torch.from_numpy(
                np.array(leaf, dtype=np.float32))
    return sd


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch-fidelity (or torchvision) Inception state dict from a
    ``.pt``/``.pth`` or ``.safetensors`` file, without the ``AuxLogits``
    head."""
    if path.endswith(".safetensors"):
        from phendiff_tpu_torch.pipelines.io import load_safetensors

        sd = {k: torch.from_numpy(v) for k, v in load_safetensors(path).items()}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.state_dict() if hasattr(sd, "state_dict") else sd
    return {k: v for k, v in sd.items() if not k.startswith("AuxLogits.")}


@contextlib.contextmanager
def _exact_f32():
    """TF32 off for the block (cuDNN convolutions and matrix products)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def prepare(images01: torch.Tensor, res: int) -> torch.Tensor:
    """NHWC in [0, 1] -> the network's NCHW input in [-1, 1] at res x res
    (bilinear, antialiased when shrinking, as ``jax.image.resize``)."""
    x = images01.float().permute(0, 3, 1, 2)
    if tuple(x.shape[-2:]) != (res, res):
        x = F.interpolate(x, size=(res, res), mode="bilinear", align_corners=False,
                          antialias=True)
    return x * 2.0 - 1.0


class InceptionExtractor:
    """Batched feature and logit extraction with the resize to 299, on the
    card unless ``device`` says otherwise."""

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = InceptionV3()
        weights_path = weights_path or os.environ.get(WEIGHTS_ENV)
        if weights_path:
            self.model.load_state_dict(load_state_dict(weights_path))
            self.pretrained = True
        else:
            self.model.init_weights(torch.Generator().manual_seed(seed))
            self.pretrained = False
        self.model.to(self.device).eval()

    def resolution(self) -> int:
        return 299 if self.pretrained else int(os.environ.get(RESIZE_ENV, "299"))

    @torch.no_grad()
    def __call__(self, images01) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W, 3] in [0, 1] (tensor or numpy) -> (features, logits)
        on the extractor's device."""
        x = prepare(torch.as_tensor(images01).to(self.device), self.resolution())
        with _exact_f32():
            return self.model(x)

    def features_for(self, batches: Iterable) -> Tuple[np.ndarray, np.ndarray]:
        """An iterable of [B, H, W, 3]-in-[0, 1] batches -> numpy
        (features [N, 2048], logits [N, 1008])."""
        feats, logits = [], []
        for batch in batches:
            f, lg = self(batch)
            feats.append(f.cpu().numpy())
            logits.append(lg.cpu().numpy())
        return np.concatenate(feats), np.concatenate(logits)
