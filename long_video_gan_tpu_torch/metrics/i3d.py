"""I3D (Inflated 3D Inception, Kinetics-400), the FVD feature detector, as a
PyTorch module, with the converter that loads a published detector file
into it.

Counterpart of `long_video_gan_tpu/metrics/i3d.py`. The reference computes
FVD with a torchscript I3D it downloads (metrics/frechet_video_distance.py:
29-36), the standard InceptionI3d ("piergiaj/pytorch-i3d" layout): Unit3D =
Conv3d (no bias) + BatchNorm3d (eps 1e-3) + ReLU with TF-SAME padding, 9
Inception blocks, 1024-d average-pooled features before the logits conv.
The JAX package runs that network natively on the file's weights; so does
this module, with the JAX package's arithmetic (batch norm folded into a
scale and shift, SAME padding split as TF splits it, SAME max pools padded
with -inf), and `I3DDetector` reproduces the JAX package's preprocessing
(rescale to [-1, 1], `jax.image.resize` to 224x224, see `common.py`).

The module's state_dict keys are the published layout's own
(`Mixed_3b.b0.conv3d.weight`, `Conv3d_1a_7x7.bn.running_mean`, ...), so a
file with those names loads after a uniform prefix is stripped, and one
with other names by registration order and shape.

No pretrained weights ship with the repository: tests hold the module and
its converter to the JAX package on an independently built torch I3D with
random weights (tests/test_torch_detectors.py).
"""

from __future__ import annotations

from typing import Any, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import as_tensors, by_order, load_detector_file, load_weights, resize

# (out_channels per branch) for each Inception block:
# [b0, b1a, b1b, b2a, b2b, b3b]
_INCEPTION_BLOCKS = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}
_STEM = ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3")


def _same_pads(sizes: Sequence[int], kernel: Sequence[int], stride: Sequence[int]) -> list[int]:
    """TF-SAME padding of the trailing axes, in `F.pad` order (last axis
    first, before/after); the smaller half goes before, as in
    `lax.padtype_to_pads`."""
    pads = []
    for size, k, s in reversed(list(zip(sizes, kernel, stride))):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _max_pool_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    pads = _same_pads(x.shape[2:], kernel, stride)
    return F.max_pool3d(F.pad(x, pads, value=float("-inf")), kernel, stride)


class Unit3D(nn.Module):
    """Conv3d (no bias) + BatchNorm (eval-mode, eps 1e-3) + ReLU, TF-SAME;
    the logits unit has a bias and neither norm nor activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: tuple[int, int, int] = (1, 1, 1),
                 stride: tuple[int, int, int] = (1, 1, 1), use_bn: bool = True,
                 activation: bool = True, use_bias: bool = False, device=None):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(in_channels, out_channels, kernel, stride=stride,
                                bias=use_bias, device=device)
        self.bn = nn.BatchNorm3d(out_channels, eps=1e-3, device=device) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, _same_pads(x.shape[2:], self.kernel, self.stride))
        y = F.conv3d(x, self.conv3d.weight, self.conv3d.bias, stride=self.stride)
        if self.bn is not None:
            inv = torch.rsqrt(self.bn.running_var + 1e-3) * self.bn.weight
            shift = self.bn.bias - self.bn.running_mean * inv
            y = y * inv.reshape(1, -1, 1, 1, 1) + shift.reshape(1, -1, 1, 1, 1)
        return F.relu(y) if self.activation else y


class InceptionModule(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int], device=None):
        super().__init__()
        c = channels
        self.b0 = Unit3D(in_channels, c[0], device=device)
        self.b1a = Unit3D(in_channels, c[1], device=device)
        self.b1b = Unit3D(c[1], c[2], kernel=(3, 3, 3), device=device)
        self.b2a = Unit3D(in_channels, c[3], device=device)
        self.b2b = Unit3D(c[3], c[4], kernel=(3, 3, 3), device=device)
        self.b3b = Unit3D(in_channels, c[5], device=device)
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(_max_pool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


class InceptionI3d(nn.Module):
    """Kinetics-400 I3D. Input [N, 3, T, H, W] in [-1, 1]; returns 1024-d
    features (pre-logits average pool) and 400-way logits."""

    def __init__(self, num_classes: int = 400, device=None):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, kernel=(7, 7, 7), stride=(2, 2, 2), device=device)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, device=device)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, kernel=(3, 3, 3), device=device)
        channels = 192
        for name, c in _INCEPTION_BLOCKS.items():
            block = InceptionModule(channels, c, device=device)
            setattr(self, name, block)
            channels = block.out_channels
        self.logits = Unit3D(channels, num_classes, use_bn=False, activation=False,
                             use_bias=True, device=device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2b_1x1(x)
        x = self.Conv3d_2c_3x3(x)
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = _max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = _max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))

        # Average pool over (min(T,2), 7, 7) with stride 1, then mean over the
        # remaining positions: the torchscript's avg_pool3d + mean(dim=2..4)
        # feature head.
        window = (min(2, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
        pooled = F.avg_pool3d(x, window, stride=1)
        features = pooled.mean(dim=(2, 3, 4))                            # [N, 1024]
        logits = self.logits(pooled.mean(dim=(3, 4), keepdim=True))      # [N, 400, t, 1, 1]
        return features, logits.mean(dim=(2, 3, 4))                      # [N, 400]


# ---------------------------------------------------------------------------
# Weight conversion from a detector file's state_dict.

_UNIT_KEYS = ("conv3d.weight", "conv3d.bias", "bn.weight", "bn.bias", "bn.running_mean",
              "bn.running_var")


def i3d_state_dict(state_dict: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map a piergiaj-layout I3D state_dict (torch tensors or numpy arrays)
    onto `InceptionI3d`'s keys: <Block>[.<branch>].{conv3d,bn}.<param>, e.g.
    'Mixed_3b.b0.conv3d.weight', 'Conv3d_1a_7x7.bn.running_mean'. Tolerates a
    uniform prefix (e.g. 'i3d.' or 'model.') on every key; a file with none
    of the block names converts by registration order and shape
    (`common.by_order`). Counterpart of the JAX package's
    `i3d_variables_from_state_dict`."""
    items = as_tensors(state_dict)
    if not items:
        raise ValueError("empty state_dict")
    roots = tuple(_INCEPTION_BLOCKS) + _STEM + ("logits",)
    prefix = next((k[:k.find(root)] for k in items for root in roots if root in k), None)
    if prefix is None:
        return by_order(InceptionI3d(device="meta"), items, "I3D")
    out = {}
    for k, v in items.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if ".".join(k.split(".")[-2:]) not in _UNIT_KEYS:
            if "num_batches_tracked" in k:
                continue
            raise ValueError(f"unrecognized I3D key {prefix + k!r}")
        out[k] = v
    return out


class I3DDetector:
    """Detector contract: uint8 video [N, C, T, H, W] -> [N, 400]
    time-averaged pre-softmax logits, computed on `device`, with the
    reference torchscript's call options (rescale / resize /
    return_features).

    Feature space: the stylegan-v i3d_torchscript (the file the reference
    downloads) returns the 400-d "raw features before the softmax layer"
    when return_features=True, the space the original FVD and all published
    numbers use, not the 1024-d pre-logits pool."""

    def __init__(self, module: InceptionI3d, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.module = module.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_torchscript(cls, path: str, device: Union[str, torch.device]) -> "I3DDetector":
        state = i3d_state_dict(load_detector_file(path).state_dict())
        return cls(load_weights(InceptionI3d(), state), device)

    @staticmethod
    def preprocess(video: torch.Tensor, rescale: bool = True, resize_to: bool = True
                   ) -> torch.Tensor:
        """The network's input from a [N, C, T, H, W] video on the 0-255
        scale: rescaled to [-1, 1], each frame resized to 224x224."""
        x = video.float()
        if rescale:
            x = x / 127.5 - 1.0
        if resize_to:
            x = resize(x, (224, 224))
        return x

    @torch.inference_mode()
    def __call__(self, batch: np.ndarray, rescale: bool = True, resize: bool = True,
                 return_features: bool = True, **_) -> np.ndarray:
        assert return_features, "only the 400-d feature contract is supported"
        video = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        return self.module(self.preprocess(video, rescale, resize))[1].cpu().numpy()
