"""InceptionV3 (FID/KID/IS feature extractor) as a PyTorch module, with the
converter that loads a published detector file into it.

Counterpart of `long_video_gan_tpu/metrics/inception_v3.py`. The reference
computes FID/KID/IS with NVIDIA's pickled TorchScript port of TF-slim
InceptionV3 (metrics/frechet_inception_distance.py:25). This module is the
same published topology (the torchvision / pytorch-fid "FID Inception"
layout: BasicConv2d = Conv (no bias) + BN (eps 1e-3) + ReLU, Mixed_5b ..
Mixed_7c, 2048-d pooled features, 1008 classes), with the TF-style branch
average pools (count_include_pad=False) and the JAX package's arithmetic
(batch norm folded into a scale and shift). Its state_dict keys are the
torchvision names (`Mixed_5b.branch1x1.conv.weight`, `fc.weight`, ...), the
names such a file carries.

No pretrained weights ship with the repository: tests hold the module and
its converter to the JAX package on an independently built torch
InceptionV3 with random weights (tests/test_torch_detectors.py).
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import as_tensors, load_detector_file, load_weights, resize


class BasicConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel=(1, 1), stride=(1, 1),
                 padding=(0, 0), device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, bias=False, device=device)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3, device=device)
        self.out_channels = out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.conv.weight, stride=self.stride, padding=self.padding)
        inv = torch.rsqrt(self.bn.running_var + 1e-3) * self.bn.weight
        shift = self.bn.bias - self.bn.running_mean * inv
        return F.relu(y * inv.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avg_pool_tf(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, pad 1, count_include_pad=False (TF style)."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c: int, pool_features: int, device=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(c, 64, device=device)
        self.branch5x5_1 = BasicConv2d(c, 48, device=device)
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2), device=device)
        self.branch3x3dbl_1 = BasicConv2d(c, 64, device=device)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1), device=device)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1), device=device)
        self.branch_pool = BasicConv2d(c, pool_features, device=device)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool_tf(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.branch3x3 = BasicConv2d(c, 384, (3, 3), stride=(2, 2), device=device)
        self.branch3x3dbl_1 = BasicConv2d(c, 64, device=device)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1), device=device)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=(2, 2), device=device)
        self.out_channels = 384 + 96 + c

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c: int, c7: int, device=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(c, 192, device=device)
        self.branch7x7_1 = BasicConv2d(c, c7, device=device)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), device=device)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0), device=device)
        self.branch7x7dbl_1 = BasicConv2d(c, c7, device=device)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), device=device)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), device=device)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), device=device)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3), device=device)
        self.branch_pool = BasicConv2d(c, 192, device=device)
        self.out_channels = 4 * 192

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_tf(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c, 192, device=device)
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=(2, 2), device=device)
        self.branch7x7x3_1 = BasicConv2d(c, 192, device=device)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3), device=device)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0), device=device)
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=(2, 2), device=device)
        self.out_channels = 320 + 192 + c

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(c, 320, device=device)
        self.branch3x3_1 = BasicConv2d(c, 384, device=device)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), device=device)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), device=device)
        self.branch3x3dbl_1 = BasicConv2d(c, 448, device=device)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1), device=device)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), device=device)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), device=device)
        self.branch_pool = BasicConv2d(c, 192, device=device)
        self.out_channels = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool_tf(x))], dim=1)


class InceptionV3(nn.Module):
    """FID InceptionV3. Input [N, 3, H, W] in [-1, 1] (callers resize to
    299x299); returns (features [N, 2048], logits [N, num_classes])."""

    def __init__(self, num_classes: int = 1008, device=None):   # TF-slim export width
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=(2, 2), device=device)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3), device=device)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1), device=device)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, device=device)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3), device=device)
        c = 192
        for name, make in (("Mixed_5b", lambda c: InceptionA(c, 32, device)),
                           ("Mixed_5c", lambda c: InceptionA(c, 64, device)),
                           ("Mixed_5d", lambda c: InceptionA(c, 64, device)),
                           ("Mixed_6a", lambda c: InceptionB(c, device)),
                           ("Mixed_6b", lambda c: InceptionC(c, 128, device)),
                           ("Mixed_6c", lambda c: InceptionC(c, 160, device)),
                           ("Mixed_6d", lambda c: InceptionC(c, 160, device)),
                           ("Mixed_6e", lambda c: InceptionC(c, 192, device)),
                           ("Mixed_7a", lambda c: InceptionD(c, device)),
                           ("Mixed_7b", lambda c: InceptionE(c, device)),
                           ("Mixed_7c", lambda c: InceptionE(c, device))):
            block = make(c)
            setattr(self, name, block)
            c = block.out_channels
        self.fc = nn.Linear(c, num_classes, device=device)
        self.blocks = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                       "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        features = x.mean(dim=(2, 3))                                   # [N, 2048]
        return features, features @ self.fc.weight.T + self.fc.bias


# ---------------------------------------------------------------------------
# Weight conversion (torchvision-style names).

_CONV_KEYS = ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")


def inception_state_dict(state_dict: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map a torchvision-layout InceptionV3 state_dict onto `InceptionV3`'s
    keys, leaving out the auxiliary classifier and batch norm's step
    counters; raises on any other key. Counterpart of the JAX package's
    `inception_variables_from_state_dict`."""
    out = {}
    for k, v in as_tensors(state_dict).items():
        if "num_batches_tracked" in k or "AuxLogits" in k:
            continue
        if k not in ("fc.weight", "fc.bias") and ".".join(k.split(".")[-2:]) not in _CONV_KEYS:
            raise ValueError(f"unrecognized InceptionV3 key {k!r}")
        out[k] = v
    return out


class InceptionDetector:
    """Detector contract: uint8 images [N, C, H, W] -> 2048-d features (or
    class probabilities with return_probs=True), computed on `device`, with
    the reference detector's call options (frechet_inception_distance.py
    detector_kwargs=dict(return_features=True), inception_score.py
    dict(no_output_bias=True))."""

    def __init__(self, module: InceptionV3, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.module = module.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_torchscript(cls, path: str, device: Union[str, torch.device]
                         ) -> "InceptionDetector":
        state = inception_state_dict(load_detector_file(path).state_dict())
        return cls(load_weights(InceptionV3(), state), device)

    @staticmethod
    def preprocess(images: torch.Tensor) -> torch.Tensor:
        """The network's input from [N, C, H, W] images on the 0-255 scale:
        resized to 299x299 (unless they are), then rescaled to [-1, 1]."""
        x = resize(images.float(), (299, 299))
        return x / 127.5 - 1.0

    @torch.inference_mode()
    def __call__(self, batch: np.ndarray, return_features: bool = True,
                 return_probs: bool = False, no_output_bias: bool = False,
                 **_) -> np.ndarray:
        images = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        feats, logits = self.module(self.preprocess(images))
        if not return_probs:
            return feats.cpu().numpy()
        if no_output_bias:
            # logits = feats @ fc_w.T + fc_b: drop the bias term exactly
            # (reference is50k detector_kwargs, inception_score.py:26).
            logits = logits - self.module.fc.bias
        return torch.softmax(logits, dim=-1).cpu().numpy()
