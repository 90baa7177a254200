"""Plain reference of the sres `VideoGenerator` (36x64 -> 144x256).

A frozen copy of the plain path of
`long_video_gan_tpu_torch/models/generator_sres.py`: the mapping network,
the alias-free synthesis stack (15 layers, modulated convolution and the
composed `filtered_lrelu`), the Kaiser-resampled conditioning pyramid and the
segment windowing of `sample_video_segments`, in the types the model states
(bfloat16 on the `num_fp16_res` layers, float32 elsewhere). Module and
parameter names are the program's, so one state dict loads into both.
"""

from __future__ import annotations

import math
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from .models_common import FullyConnectedLayer
from .ops import (design_lowpass_filter, downsample2d, downsample2d_padding, filter_buffer,
                  filtered_lrelu, kaiser_resample_filter, q, upfirdn2d_macs, upsample2d,
                  upsample2d_padding)


def modulated_conv2d(x, w, s, demodulate: bool = True, padding: int = 0, input_gain=None):
    """conv(x * s, w), demodulated; styles in f32, the conv in x's type."""
    batch = x.shape[0]
    w, s = w.float(), s.float()
    if demodulate:
        w = w * w.square().mean(dim=(1, 2, 3), keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
        dcoefs = (torch.einsum("oikl,ni->no", w.square(), s.square()) + 1e-8).rsqrt()
    gain = s
    if input_gain is not None:
        gain = gain * input_gain.float().expand(batch, w.shape[1])
    x = x * gain[:, :, None, None].to(x.dtype)
    y = F.conv2d(q(x), q(w.to(x.dtype)), padding=padding)
    if demodulate:
        y = y * dcoefs[:, :, None, None].to(y.dtype)
    return y


class MappingNetwork(nn.Module):
    def __init__(self, z_dim: int, w_dim: int, num_ws: int, num_layers: int = 2,
                 lr_multiplier: float = 0.01, w_avg_beta: float = 0.998, device=None):
        super().__init__()
        self.z_dim, self.w_dim, self.num_ws = z_dim, w_dim, num_ws
        self.num_layers, self.w_avg_beta = num_layers, w_avg_beta
        features = [z_dim] + [w_dim] * num_layers
        for idx, (fi, fo) in enumerate(zip(features[:-1], features[1:])):
            self.add_module(f"fc{idx}", FullyConnectedLayer(fi, fo, activation="lrelu",
                                                            lrate_mul=lr_multiplier,
                                                            device=device))
        self.register_buffer("w_avg", torch.zeros(w_dim, device=device))

    def forward(self, z, truncation_psi: float = 1.0, update_emas: bool = False):
        x = z.float()
        x = x * (x.square().mean(dim=1, keepdim=True) + 1e-8).rsqrt()
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        if update_emas:
            mean = x.detach().mean(dim=0)
            self.w_avg.copy_(mean + (self.w_avg - mean) * self.w_avg_beta)
        x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1.0:
            x = self.w_avg + (x - self.w_avg) * truncation_psi
        return x


class SynthesisLayer(nn.Module):
    def __init__(self, w_dim, is_torgb, is_critically_sampled, use_fp16, in_channels,
                 out_channels, in_size, out_size, in_sampling_rate, out_sampling_rate,
                 in_cutoff, out_cutoff, in_half_width, out_half_width, conv_kernel=3,
                 filter_size=6, lrelu_upsampling=2, conv_clamp=256.0,
                 magnitude_ema_beta=0.999, device=None):
        super().__init__()
        self.is_torgb, self.use_fp16 = is_torgb, use_fp16
        self.in_channels, self.out_channels = in_channels, out_channels
        self.in_size, self.out_size = tuple(map(int, in_size)), tuple(map(int, out_size))
        self.conv_clamp, self.magnitude_ema_beta = conv_clamp, magnitude_ema_beta
        k = 1 if is_torgb else conv_kernel
        self.kernel = k
        tmp_rate = max(in_sampling_rate, out_sampling_rate) * (1 if is_torgb else lrelu_upsampling)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.register_buffer("magnitude_ema", torch.ones((), device=device))
        self.up_factor = int(np.rint(tmp_rate / in_sampling_rate))
        up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        self.register_buffer("up_filter", filter_buffer(design_lowpass_filter(
            up_taps, in_cutoff, in_half_width * 2, tmp_rate), device), persistent=False)
        self.down_factor = int(np.rint(tmp_rate / out_sampling_rate))
        down_taps = filter_size * self.down_factor if self.down_factor > 1 and not is_torgb else 1
        self.register_buffer("down_filter", filter_buffer(design_lowpass_filter(
            down_taps, out_cutoff, out_half_width * 2, tmp_rate,
            radial=False), device), persistent=False)
        in_sz, out_sz = np.asarray(self.in_size), np.asarray(self.out_size)
        pad_total = (out_sz - 1) * self.down_factor + 1
        pad_total -= (in_sz + k - 1) * self.up_factor
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]), int(pad_hi[1])]

    def init_stds(self) -> dict[str, float]:
        return {"weight": 1.0}

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_fp16 else torch.float32

    def forward(self, x, w, update_emas: bool = False):
        if update_emas:
            mag = x.detach().float().square().mean()
            self.magnitude_ema.copy_(mag + (self.magnitude_ema - mag) * self.magnitude_ema_beta)
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / math.sqrt(self.in_channels * self.kernel ** 2))
        x = modulated_conv2d(x.to(self.dtype), self.weight, styles, padding=self.kernel - 1,
                             demodulate=not self.is_torgb,
                             input_gain=self.magnitude_ema.rsqrt())
        return filtered_lrelu(x, self.up_filter, self.down_filter, self.bias.to(x.dtype),
                              up=self.up_factor, down=self.down_factor, padding=self.padding,
                              gain=1.0 if self.is_torgb else math.sqrt(2.0),
                              slope=1.0 if self.is_torgb else 0.2, clamp=self.conv_clamp)


def synthesis_layer_plan(img_width, img_height, img_channels, channel_base=32768,
                         channel_max=512, num_layers=14, num_critical=2, first_cutoff=2.0,
                         first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3, margin_size=10):
    """StyleGAN3's per-layer cutoffs, stopbands, rates, sizes and channels,
    with the non-square size scaling and the last two layers at image size."""
    img_resolution = max(img_width, img_height)
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes_x = np.ceil(rates * min(1, img_width / img_height)) + margin_size * 2
    sizes_y = np.ceil(rates * min(1, img_height / img_width)) + margin_size * 2
    sizes_x[-2:], sizes_y[-2:] = img_width, img_height
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = img_channels
    return dict(cutoffs=cutoffs, sampling_rates=rates, half_widths=half_widths,
                sizes_x=sizes_x, sizes_y=sizes_y, channels=channels)


class SynthesisNetwork(nn.Module):
    def __init__(self, w_dim, img_width, img_height, img_channels, cond_channels,
                 channel_base=32768, channel_max=512, num_layers=14, num_critical=2,
                 margin_size=10, output_scale=0.25, num_fp16_res=4, conv_clamp=256.0,
                 device=None):
        super().__init__()
        self.w_dim, self.num_layers, self.output_scale = w_dim, num_layers, output_scale
        self.img_width, self.img_height, self.img_channels = img_width, img_height, img_channels
        p = self._plan = synthesis_layer_plan(img_width, img_height, img_channels, channel_base,
                                              channel_max, num_layers, num_critical,
                                              margin_size=margin_size)
        rates, channels = p["sampling_rates"], p["channels"]
        img_resolution = max(img_width, img_height)
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            in_channels = cond_channels + (int(channels[prev]) if idx > 0 else 0)
            layer = SynthesisLayer(
                w_dim=w_dim, is_torgb=idx == num_layers,
                is_critically_sampled=idx >= num_layers - num_critical,
                use_fp16=bool(rates[idx] * (2 ** num_fp16_res) > img_resolution),
                in_channels=in_channels, out_channels=int(channels[idx]),
                in_size=(int(p["sizes_x"][prev]), int(p["sizes_y"][prev])),
                out_size=(int(p["sizes_x"][idx]), int(p["sizes_y"][idx])),
                in_sampling_rate=int(rates[prev]), out_sampling_rate=int(rates[idx]),
                in_cutoff=float(p["cutoffs"][prev]), out_cutoff=float(p["cutoffs"][idx]),
                in_half_width=float(p["half_widths"][prev]),
                out_half_width=float(p["half_widths"][idx]), conv_clamp=conv_clamp,
                device=device)
            name = f"L{idx}_{int(p['sizes_x'][idx])}_{int(p['sizes_y'][idx])}_{int(channels[idx])}"
            self.add_module(name, layer)
            self.layer_names.append(name)

    @property
    def num_ws(self) -> int:
        return self.num_layers + 1

    @property
    def layers(self) -> list[SynthesisLayer]:
        return [getattr(self, name) for name in self.layer_names]

    def forward(self, ws, conds, update_emas: bool = False):
        # Under a gradient each layer is recomputed in the backward, so that
        # the composed filtered_lrelu's supersampled maps live one layer at a
        # time (a training micro-batch's would not fit on the card). The
        # magnitude EMAs move only in passes without a gradient.
        remat = torch.is_grad_enabled() and not update_emas
        x = None
        for i, layer in enumerate(self.layers):
            x = conds[i] if x is None else torch.cat([x, conds[i].to(x.dtype)], dim=1)
            if remat:
                x = torch.utils.checkpoint.checkpoint(layer, x, ws[:, i].float(),
                                                      use_reentrant=False)
            else:
                x = layer(x, ws[:, i].float(), update_emas)
        return (x * self.output_scale).float()


class KaiserResample(nn.Module):
    """Replicate-pad, then Kaiser up- or downsample by `scale`."""

    def __init__(self, up: bool, scale: int, device=None):
        super().__init__()
        self.is_up, self.scale = up, scale
        self.register_buffer("filter", filter_buffer(kaiser_resample_filter(scale), device),
                             persistent=False)

    def forward(self, x):
        if self.is_up:
            x = F.pad(x, [1, 1, 1, 1], mode="replicate")
            return upsample2d(x, self.filter, up=self.scale, padding=-self.scale)
        p = self.scale
        x = F.pad(x, [p, p, p, p], mode="replicate")
        return downsample2d(x, self.filter, down=self.scale, padding=-p)

    def macs(self, h: int, w: int) -> int:
        taps = self.filter.shape[0]
        if self.is_up:
            pad = upsample2d_padding(self.filter, self.scale, -self.scale)
            return upfirdn2d_macs(h + 2, w + 2, taps, up=self.scale, padding=pad)[2]
        p = self.scale
        pad = downsample2d_padding(self.filter, self.scale, -p)
        return upfirdn2d_macs(h + 2 * p, w + 2 * p, taps, down=self.scale, padding=pad)[2]


class Generator(nn.Module):
    def __init__(self, z_dim, w_dim, img_width, img_height, img_channels, cond_width,
                 cond_height, cond_context, margin_size=10, num_fp16_res=4,
                 channel_base=32768, channel_max=512, num_layers=14, device=None):
        super().__init__()
        self.img_channels, self.margin_size = img_channels, margin_size
        self.cond_width, self.cond_height, self.cond_context = cond_width, cond_height, cond_context
        self.synthesis = SynthesisNetwork(
            w_dim, img_width, img_height, img_channels, img_channels * (2 * cond_context + 1),
            channel_base=channel_base, channel_max=channel_max, num_layers=num_layers,
            margin_size=margin_size, num_fp16_res=num_fp16_res, device=device)
        self.mapping = MappingNetwork(z_dim, w_dim, self.synthesis.num_ws, device=device)
        rates = self.synthesis._plan["sampling_rates"]
        cond_edge = max(cond_width, cond_height)
        self.resamplers = nn.ModuleDict()
        self._resample_keys = []
        for idx in range(self.synthesis.num_ws):
            scale = rates[max(idx - 1, 0)] / cond_edge
            if scale < 1:
                key, mod = f"down{math.ceil(1 / scale)}", (False, math.ceil(1 / scale))
            elif scale > 1:
                key, mod = f"up{math.ceil(scale)}", (True, math.ceil(scale))
            else:
                key, mod = "id1", None
            if key not in self.resamplers:
                self.resamplers[key] = (nn.Identity() if mod is None
                                        else KaiserResample(*mod, device=device))
            self._resample_keys.append(key)

    def prep_cond(self, cond):
        """Pad the lr frames to a square plus the margin, resample once per
        layer scale, crop or pad to each layer's input, and unfold the
        +/-context window into channels (c-major)."""
        n, c, t, h, w = cond.shape
        edge = max(self.cond_width, self.cond_height)
        m = self.margin_size
        frames = cond.transpose(1, 2).reshape(n * t, c, h, w)
        frames = F.pad(frames, [(edge - w) // 2 + m, (edge - w + 1) // 2 + m,
                                (edge - h) // 2 + m, (edge - h + 1) // 2 + m], mode="replicate")
        levels = {key: r(frames) for key, r in self.resamplers.items()}
        s = 1 + 2 * self.cond_context
        t_out = t - s + 1
        idx = (torch.arange(t_out)[:, None] + torch.arange(s)[None, :]).to(cond.device)
        p = self.synthesis._plan
        conds = []
        for i, key in enumerate(self._resample_keys):
            prev = max(i - 1, 0)
            in_w, in_h = int(p["sizes_x"][prev]), int(p["sizes_y"][prev])
            y = levels[key]
            x0, y0 = max(0, (y.shape[3] - in_w) // 2), max(0, (y.shape[2] - in_h) // 2)
            y = y[:, :, y0:y0 + in_h, x0:x0 + in_w]
            pads = [(in_w - y.shape[3]) // 2, (in_w - y.shape[3] + 1) // 2,
                    (in_h - y.shape[2]) // 2, (in_h - y.shape[2] + 1) // 2]
            if any(pads):
                y = F.pad(y, pads, mode="replicate")
            windows = y.reshape(n, t, c, in_h, in_w)[:, idx].transpose(2, 3)
            conds.append(windows.reshape(n * t_out, c * s, in_h, in_w))
        return conds

    def forward(self, z, cond, truncation_psi: float = 1.0, update_emas: bool = False):
        t_out = cond.shape[2] - 2 * self.cond_context
        conds = self.prep_cond(cond)
        ws = self.mapping(z, truncation_psi=truncation_psi, update_emas=update_emas)
        img = self.synthesis(ws.repeat_interleave(t_out, dim=0), conds, update_emas=update_emas)
        s = self.synthesis
        return img.reshape(z.shape[0], t_out, s.img_channels, s.img_height,
                           s.img_width).transpose(1, 2)


class VideoGenerator(nn.Module):
    """lr video [N, 3, T + 2 context, lh, lw] and z -> hr video [N, 3, T, hh, hw]."""

    def __init__(self, hr_height=256, hr_width=256, lr_height=32, lr_width=32,
                 temporal_context=4, latent_z_dim=512, latent_w_dim=512, margin_size=10,
                 num_fp16_res=4, channel_base=32768, channel_max=512, num_layers=14,
                 device=None, **ignored):
        super().__init__()
        self.temporal_context, self.latent_z_dim = temporal_context, latent_z_dim
        self.lr_height, self.lr_width = lr_height, lr_width
        self.SG3 = Generator(latent_z_dim, latent_w_dim, hr_width, hr_height, 3, lr_width,
                             lr_height, temporal_context, margin_size, num_fp16_res,
                             channel_base, channel_max, num_layers, device=device)

    def forward(self, lr_video, z, magnitude_ema_beta: float = 1.0, truncation_psi: float = 1.0):
        return self.SG3(z, lr_video, truncation_psi=truncation_psi,
                        update_emas=magnitude_ema_beta < 1)


def segment_window(lr_video: torch.Tensor, index: int, segment_length: int,
                   temporal_context: int) -> torch.Tensor:
    """The lr frames that hr segment `index` of a streamed video reads:
    `segment_length + 2 * temporal_context` frames from index * segment_length."""
    start = index * segment_length
    return lr_video[:, :, start:start + segment_length + 2 * temporal_context]

