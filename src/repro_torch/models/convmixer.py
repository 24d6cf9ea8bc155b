"""ConvMixer (Trockman & Kolter 2022) — the paper's second evaluation model —
plus a small MLP classifier. Counterpart of ``repro.models.convmixer``.

Params stay in the JAX package's shapes (HWIO kernels, (in, out)
matrices, NHWC images) so the flat vector has ``ravel_pytree``'s layout;
``convmixer_apply`` permutes to PyTorch's OIHW/NCHW inside the forward.
"SAME" padding at an odd kernel is ``kernel // 2`` on each side, and
``jax.nn.gelu`` is the tanh approximation. As in the JAX model, BatchNorm
is a per-channel scale and bias."""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models import params as pdefs


@dataclass(frozen=True)
class ConvMixerConfig:
    dim: int = 256
    depth: int = 8
    kernel: int = 9
    patch: int = 2
    num_classes: int = 10
    image: int = 32
    channels: int = 3


def convmixer_defs(c: ConvMixerConfig):
    d = {
        "patch_w": pdefs.ParamDef((c.patch, c.patch, c.channels, c.dim),
                                  scale=(c.patch * c.patch * c.channels) ** -0.5),
        "patch_b": pdefs.bias(c.dim),
        "head": pdefs.linear(c.dim, c.num_classes),
        "head_b": pdefs.bias(c.num_classes),
    }
    for i in range(c.depth):
        d[f"block{i}"] = {
            "dw": pdefs.ParamDef((c.kernel, c.kernel, 1, c.dim),
                                 scale=(c.kernel * c.kernel) ** -0.5),
            "dw_s": pdefs.norm_scale(c.dim), "dw_b": pdefs.bias(c.dim),
            "pw": pdefs.linear(c.dim, c.dim),
            "pw_s": pdefs.norm_scale(c.dim), "pw_b": pdefs.bias(c.dim),
        }
    return d


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _chan(v):
    """(C,) per-channel vector → (1, C, 1, 1) for NCHW broadcasting."""
    return v.view(1, -1, 1, 1)


def convmixer_apply(p, images, c: ConvMixerConfig):
    """``images``: (B, H, W, C) — NHWC like the JAX model. Returns logits."""
    if c.kernel % 2 == 0:
        raise ValueError("ConvMixer 'SAME' padding needs an odd kernel")
    x = images.permute(0, 3, 1, 2)                          # NHWC -> NCHW
    x = F.conv2d(x, p["patch_w"].permute(3, 2, 0, 1), stride=c.patch)
    x = _gelu(x + _chan(p["patch_b"]))
    for i in range(c.depth):
        b = p[f"block{i}"]
        h = F.conv2d(x, b["dw"].permute(3, 2, 0, 1), padding=c.kernel // 2,
                     groups=c.dim)
        x = x + (_gelu(h) * _chan(b["dw_s"]) + _chan(b["dw_b"]))
        # x @ pw over the channel axis == a 1x1 convolution
        y = F.conv2d(x, b["pw"].t()[:, :, None, None])
        x = _gelu(y) * _chan(b["pw_s"]) + _chan(b["pw_b"])
    x = x.mean(dim=(2, 3))
    return x @ p["head"] + p["head_b"]


def _xent(logits, y):
    y = y.long()
    ce = -torch.log_softmax(logits, dim=-1).gather(-1, y[:, None]).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return ce, {"acc": acc}


def convmixer_loss(p, batch, c: ConvMixerConfig):
    return _xent(convmixer_apply(p, batch["x"], c), batch["y"])


# -- tiny MLP for fast optimizer-level benchmarks ---------------------------


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 64
    hidden: int = 128
    depth: int = 2
    num_classes: int = 10


def mlp_defs(c: MLPConfig):
    d = {}
    prev = c.in_dim
    for i in range(c.depth):
        d[f"w{i}"] = pdefs.linear(prev, c.hidden)
        d[f"b{i}"] = pdefs.bias(c.hidden)
        prev = c.hidden
    d["w_out"] = pdefs.linear(prev, c.num_classes)
    d["b_out"] = pdefs.bias(c.num_classes)
    return d


def mlp_apply(p, x, c: MLPConfig):
    for i in range(c.depth):
        x = torch.relu(x @ p[f"w{i}"] + p[f"b{i}"])
    return x @ p["w_out"] + p["b_out"]


def mlp_loss(p, batch, c: MLPConfig):
    return _xent(mlp_apply(p, batch["x"], c), batch["y"])
