"""Plain-PyTorch ConvMixer (Trockman & Kolter, arXiv:2201.09792) as the
FedCAMS paper trains it on CIFAR-10: the benchmark's reference model.

Written from the published description, not from the program: a patch
embedding (a ``patch`` x ``patch`` convolution at stride ``patch``, GELU,
BatchNorm), then ``depth`` blocks of a residual depthwise ``kernel`` x
``kernel`` convolution (GELU, BatchNorm) and a pointwise convolution (GELU,
BatchNorm), global average pooling and a linear head, trained on the mean
cross-entropy. Departures, as the paper's JAX code has them: BatchNorm is a
learned per-channel scale and bias (no batch statistics); GELU is the tanh
approximation; the patch embedding's bias is added before its GELU and it
has no BatchNorm.

The parameters live in one flat float32 vector in the layout every
federated round of the paper works on: dict keys sorted at every level,
depth first, each leaf row-major in its (JAX) shape — HWIO kernels,
(in, out) matrices. Blockwise top-k cuts its blocks from that vector.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.precision import operand


def layout(model: dict) -> list:
    """``[(path, shape, init, scale)]`` in the flat vector's order; ``init``
    is ``normal`` (N(0, 1) times ``scale``), ``zeros`` or ``ones``."""
    dim, depth, kern = model["dim"], model["depth"], model["kernel"]
    patch, ch, classes = model["patch"], model["channels"], model["num_classes"]
    tree = {
        "patch_w": ((patch, patch, ch, dim), "normal",
                    (patch * patch * ch) ** -0.5),
        "patch_b": ((dim,), "zeros", 0.0),
        "head": ((dim, classes), "normal", dim ** -0.5),
        "head_b": ((classes,), "zeros", 0.0),
    }
    for i in range(depth):
        tree[f"block{i}"] = {
            "dw": ((kern, kern, 1, dim), "normal", (kern * kern) ** -0.5),
            "dw_s": ((dim,), "ones", 1.0), "dw_b": ((dim,), "zeros", 0.0),
            "pw": ((dim, dim), "normal", dim ** -0.5),
            "pw_s": ((dim,), "ones", 1.0), "pw_b": ((dim,), "zeros", 0.0),
        }
    out = []

    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], prefix + (key,))
            else:
                out.append((prefix + (key,),) + node[key])

    walk(tree, ())
    return out


def size(model: dict) -> int:
    """The flat vector's length d."""
    return sum(math.prod(shape) for _, shape, _, _ in layout(model))


def views(flat: torch.Tensor, model: dict) -> dict:
    """``{path: view}`` of each leaf in ``flat``."""
    out, at = {}, 0
    for path, shape, _, _ in layout(model):
        n = math.prod(shape)
        out[path] = flat[at:at + n].view(shape)
        at += n
    return out


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _chan(v):
    return v.view(1, -1, 1, 1)


def logits(flat: torch.Tensor, images: torch.Tensor, model: dict,
           tf32: bool = False) -> torch.Tensor:
    """``images`` (B, H, W, C) float32 → (B, classes) logits."""
    p = {"/".join(k): v for k, v in views(flat, model).items()}
    op = lambda t: operand(t, tf32)
    dim, kern, patch = model["dim"], model["kernel"], model["patch"]
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(op(x), op(p["patch_w"].permute(3, 2, 0, 1)), stride=patch)
    x = _gelu(x + _chan(p["patch_b"]))
    for i in range(model["depth"]):
        b = lambda name: p[f"block{i}/{name}"]
        h = F.conv2d(op(x), op(b("dw").permute(3, 2, 0, 1)),
                     padding=kern // 2, groups=dim)
        x = x + (_gelu(h) * _chan(b("dw_s")) + _chan(b("dw_b")))
        y = F.conv2d(op(x), op(b("pw").t()[:, :, None, None]))
        x = _gelu(y) * _chan(b("pw_s")) + _chan(b("pw_b"))
    x = x.mean(dim=(2, 3))
    return op(x) @ op(p["head"]) + p["head_b"]


def loss_and_grad(flat: torch.Tensor, batch: dict, model: dict,
                  tf32: bool = False):
    """The mean cross-entropy of ``batch`` (``x`` images, ``y`` labels) at
    ``flat`` and its gradient, a flat vector."""
    flat = flat.detach().requires_grad_(True)
    loss = F.cross_entropy(logits(flat, batch["x"], model, tf32),
                           batch["y"].long())
    (grad,) = torch.autograd.grad(loss, flat)
    return loss.detach(), grad
