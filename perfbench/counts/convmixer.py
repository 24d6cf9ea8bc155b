"""Model FLOPs of ConvMixer (Trockman & Kolter, arXiv:2201.09792), counted
from its shapes: two operations a multiply-add of each convolution and of
the head; the elementwise work (GELU, BatchNorm's scale and bias, the
residual add, the pooling, the loss) is not counted.

Training an example is its forward pass, the gradient of every weight
(as many FLOPs as the forward of that layer) and the gradient of every
layer's input but the image's (the patch embedding has no input gradient).
Nothing is recomputed.
"""
from __future__ import annotations


def layer_flops(model: dict) -> dict:
    """Forward FLOPs of one example by layer."""
    dim, patch, ch = model["dim"], model["patch"], model["channels"]
    positions = (model["image"] // patch) ** 2
    depth = model["depth"]
    return {"patch": 2 * positions * dim * patch * patch * ch,
            "depthwise": depth * 2 * positions * dim * model["kernel"] ** 2,
            "pointwise": depth * 2 * positions * dim * dim,
            "head": 2 * dim * model["num_classes"]}


def forward_flops_per_example(model: dict) -> int:
    return sum(layer_flops(model).values())


def train_flops_per_example(model: dict) -> int:
    """Forward, weight gradients and input gradients of one example."""
    fwd = layer_flops(model)
    return 3 * sum(fwd.values()) - fwd["patch"]
