"""C3D (UCF-101), the video Inception Score detector, as a PyTorch module,
with the converter that loads a published detector file into it.

Counterpart of `long_video_gan_tpu/metrics/c3d.py`. The reference's
isv2048_ucf metric uses a torchscript C3D finetuned on UCF-101
(metrics/video_inception_score.py:26-31, the tgan2 chainer checkpoint's
torchscript export): 8 conv3d(k3, pad 1)+ReLU layers with max-pools, 3
fully-connected layers, 101-way softmax. The detector contract returns class
probabilities (the IS split-KL consumes them).

Input protocol: [N, 3, 16, H, W] uint8; frames are resized to 128x171 as
`jax.image.resize` does (see `common.py`) and center-cropped to 112x112,
with the channels reversed to BGR and the C3D means subtracted, as the JAX
package does. The state_dict keys are the canonical layer names
(`conv1a.weight`, `fc6.bias`, ...).

No pretrained weights ship with the repository: tests hold the module and
its converter to the JAX package on an independently built torch C3D with
random weights (tests/test_torch_detectors.py).
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import as_tensors, by_order, load_detector_file, load_weights, resize

# Canonical layer plan: (name, out_channels) for convs, pools between.
_CONVS = [("conv1a", 64), ("conv2a", 128), ("conv3a", 256), ("conv3b", 256),
          ("conv4a", 512), ("conv4b", 512), ("conv5a", 512), ("conv5b", 512)]
# BGR channel means of the original C3D (sports-1m) preprocessing.
_MEAN = (90.25, 97.66, 101.41)


class C3D(nn.Module):
    """UCF-101 C3D. Input [N, 3, 16, 112, 112] (mean-subtracted, NCTHW);
    returns (fc7 features [N, 4096], logits [N, num_classes])."""

    def __init__(self, num_classes: int = 101, device=None):
        super().__init__()
        c = 3
        for name, out in _CONVS:
            setattr(self, name, nn.Conv3d(c, out, 3, padding=1, device=device))
            c = out
        self.fc6 = nn.Linear(8192, 4096, device=device)
        self.fc7 = nn.Linear(4096, 4096, device=device)
        self.fc8 = nn.Linear(4096, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        def conv(name, x):
            return F.relu(getattr(self, name)(x))

        x = F.max_pool3d(conv("conv1a", x), (1, 2, 2))
        x = F.max_pool3d(conv("conv2a", x), 2)
        x = F.max_pool3d(conv("conv3b", conv("conv3a", x)), 2)
        x = F.max_pool3d(conv("conv4b", conv("conv4a", x)), 2)
        x = conv("conv5b", conv("conv5a", x))
        # The last pool pads H and W by 1 in front (torch MaxPool3d padding
        # (0, 1, 1), whose floor mode drops the trailing window): 7x7 -> 4x4.
        x = F.max_pool3d(F.pad(x, (1, 0, 1, 0), value=float("-inf")), 2)
        x = x.reshape(x.shape[0], -1)                                  # [N, 8192]
        feats = F.relu(self.fc7(F.relu(self.fc6(x))))
        return feats, self.fc8(feats)


def c3d_state_dict(state_dict: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map a canonical C3D state_dict onto `C3D`'s keys: '<layer>.weight/.bias'
    (tgan2/torch naming, any uniform prefix), or else by registration order
    and shape (`common.by_order`). Counterpart of the JAX package's
    `c3d_variables_from_state_dict`."""
    items = as_tensors(state_dict)
    wanted = [n for n, _ in _CONVS] + ["fc6", "fc7", "fc8"]
    by_layer: dict[str, dict[str, torch.Tensor]] = {}
    for k, v in items.items():
        parts = k.split(".")
        if len(parts) >= 2 and parts[-1] in ("weight", "bias"):
            by_layer.setdefault(parts[-2], {})[parts[-1]] = v
    if all(n in by_layer for n in wanted):
        return {f"{n}.{leaf}": by_layer[n][leaf] for n in wanted for leaf in ("weight", "bias")}
    return by_order(C3D(device="meta"), items, "C3D")


class C3DDetector:
    """Detector contract: uint8 video [N, 3, 16, H, W] -> [N, 101] class
    probabilities, computed on `device` (isv2048_ucf protocol)."""

    def __init__(self, module: C3D, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.module = module.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_torchscript(cls, path: str, device: Union[str, torch.device]) -> "C3DDetector":
        state = c3d_state_dict(load_detector_file(path).state_dict())
        return cls(load_weights(C3D(), state), device)

    @staticmethod
    def preprocess(video: torch.Tensor) -> torch.Tensor:
        """The network's input from a [N, 3, T, H, W] video on the 0-255
        scale: frames resized to 128x171, center-cropped to 112x112, RGB ->
        BGR, means subtracted."""
        x = resize(video.float(), (128, 171))
        y0, x0 = (128 - 112) // 2, (171 - 112) // 2
        x = x[:, :, :, y0:y0 + 112, x0:x0 + 112].flip(1)
        mean = torch.tensor(_MEAN[::-1], dtype=x.dtype, device=x.device)
        return x - mean.reshape(1, 3, 1, 1, 1)

    @torch.inference_mode()
    def __call__(self, batch: np.ndarray, **_) -> np.ndarray:
        video = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        _, logits = self.module(self.preprocess(video))
        return torch.softmax(logits, dim=-1).cpu().numpy()
