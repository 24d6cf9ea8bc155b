"""Model FLOPs of the xLSTM language model (Beck et al., arXiv:2405.04517)
as the port's stack runs it (an mLSTM and an sLSTM block a period, an
untied unembedding), counted from its shapes: two operations a
multiply-add of each matrix product, the mLSTM's quadratic form over the
causal pairs (j <= i) alone; the gates' and norms' elementwise work, the
embedding's gather and the loss are not counted.

Training a token is its forward pass, the gradient of every weight and the
gradient of every product's input: three times the forward. Nothing is
recomputed (the program's remat is not counted).
"""
from __future__ import annotations


def _pad(x: int) -> int:
    return -(-x // 128) * 128


def forward_flops_per_sequence(model: dict, seq: int) -> dict:
    """Forward FLOPs of one sequence of ``seq`` tokens, by part."""
    d, nh, V = model["d_model"], model["num_heads"], model["vocab_size"]
    di = _pad(int(d * model["mlstm_proj_factor"]))
    dff = _pad(int(d * model["slstm_proj_factor"]))
    kinds = model["block_pattern"]
    layers = [kinds[i % len(kinds)] for i in range(model["num_layers"])]
    per_token = {"mlstm_proj": 0, "slstm": 0, "unembed": 2 * d * V}
    quadratic = 0
    for kind in layers:
        if kind == "mlstm":
            # q, k, v, o; the input and forget gates; the down projection
            per_token["mlstm_proj"] += 2 * d * di * 4 + 2 * d * nh * 2 \
                + 2 * di * d
            # q·k and the weighted sum of v over j <= i: seq(seq+1)/2 pairs
            quadratic += 2 * 2 * di * seq * (seq + 1) // 2
        else:
            dh = d // nh
            # input preactivations, the block-diagonal recurrence, the FFN
            per_token["slstm"] += (2 * d * 4 * d + 2 * 4 * d * dh
                                   + 3 * 2 * d * dff)
    out = {k: v * seq for k, v in per_token.items()}
    out["mlstm_quadratic"] = quadratic
    return out


def train_flops_per_sequence(model: dict, seq: int) -> int:
    return 3 * sum(forward_flops_per_sequence(model, seq).values())
