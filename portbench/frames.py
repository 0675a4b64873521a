"""The benchmark's content, made on the device from the seed.

A canvas is the synthetic frame of the JAX package's original benchmark:
smooth gradients, 128 + 60 sin(x / 97) cos(y / 53), plus N(0, 12) sensor
noise, clipped and truncated to uint8, on all three channels. Each canvas
shifts the gradient's phase and draws its noise from the seed, so that no
two frames are alike and nothing can be served from a cache. A frame is a
crop of its own canvas at an offset drawn from the seed (the whole canvas
where they are the same size). Every seed gives the same sizes; only the
pixels differ.
"""

from __future__ import annotations

import numpy as np
import torch


def canvas(h: int, w: int, phase: tuple, noise_seed: int, sd: float,
           device: torch.device) -> torch.Tensor:
    """uint8 [h, w, 3]: the gradient shifted by phase (dy, dx) plus
    N(0, sd) noise from noise_seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed)
    yy = torch.arange(h, device=device, dtype=torch.float32) + phase[0]
    xx = torch.arange(w, device=device, dtype=torch.float32) + phase[1]
    base = 128 + 60 * torch.sin(xx / 97.0)[None, :] * torch.cos(
        yy / 53.0)[:, None]
    noise = torch.randn((h, w, 3), generator=gen, device=device) * sd
    return (base[..., None] + noise).clamp(0, 255).to(torch.uint8)


def make_inputs(cfg: dict, seed: int, device: torch.device) -> list:
    """cfg["distinct"] inputs: uint8 [H, W, 3] frames, or [batch, H, W, 3]
    batches where cfg["batch"] > 1."""
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    ch, cw = cfg["canvas"]
    h, w = cfg["height"], cfg["width"]
    out = []
    for _ in range(cfg["distinct"]):
        imgs = []
        for _ in range(cfg["batch"]):
            phase = tuple(int(v) for v in rng.integers(0, 1 << 16, 2))
            noise_seed = int(rng.integers(0, 1 << 62))
            oy = int(rng.integers(0, ch - h + 1))
            ox = int(rng.integers(0, cw - w + 1))
            c = canvas(ch, cw, phase, noise_seed, cfg["noise_sd"], device)
            imgs.append(c[oy:oy + h, ox:ox + w])
        x = imgs[0] if cfg["batch"] == 1 else torch.stack(imgs)
        out.append(x.contiguous())
    return out
