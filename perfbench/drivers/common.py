"""What the drivers share: the weights they make from the seed, the
nested dict of leaves the program takes, and a clock of set-up's parts."""
from __future__ import annotations

import math
import time

import torch

from perfbench.reference.fedcams import leaf_sizes


class Clock:
    """Seconds of each part of a set-up, on the host's clock."""

    def __init__(self):
        self.parts, self.t = {}, time.perf_counter()

    def lap(self, name: str) -> None:
        t = time.perf_counter()
        self.parts[name] = t - self.t
        self.t = t


def make_weights(layout: list, seed: int, device) -> torch.Tensor:
    """The flat float32 parameter vector from ``seed``, drawn on ``device``
    in one call: N(0, 1) times each leaf's scale, ones where a leaf starts
    at one, zeros where at zero."""
    sizes = torch.tensor(leaf_sizes(layout), device=device)
    scale = torch.tensor([s if init == "normal" else 0.0
                          for _, _, init, s in layout], device=device)
    shift = torch.tensor([1.0 if init == "ones" else 0.0
                          for _, _, init, _ in layout], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(int(sizes.sum()), generator=gen, device=device)
    return (flat.mul_(scale.repeat_interleave(sizes))
            .add_(shift.repeat_interleave(sizes)))


def nested(layout: list, flat: torch.Tensor) -> dict:
    """``flat`` as the nested dict of leaves, in their shapes (views), that
    the program takes."""
    out, at = {}, 0
    for path, shape, _, _ in layout:
        n = math.prod(shape)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[at:at + n].view(shape)
        at += n
    return out
