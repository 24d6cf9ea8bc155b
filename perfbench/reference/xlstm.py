"""Plain-PyTorch xLSTM language model (Beck et al., arXiv:2405.04517) as the
port's train step (``launch/steps.py``) trains it: the benchmark's reference
model, in float32.

The stack alternates a pre-norm residual mLSTM block and a pre-norm
residual sLSTM block (one period, ``(mLSTM, sLSTM)``, a layer each), then
a final RMSNorm and an untied unembedding, trained on the mean next-token
cross-entropy. Written from the paper's equations, with the departures
the paper's JAX reproduction makes (the program's model):

* mLSTM: q, k (``proj_factor`` · d wide, split over the heads), v and the
  output gate o per head from the block's normed input; scalar input and
  forget gates a head, no bias; the stabilized parallel form
  D_ij = F_i - F_j + log i_j (j <= i, F the cumulative log-sigmoid forget
  gate), m_i = max_j D_ij, h_i = Σ_j (q_i·k_j/√dh) e^{D_ij - m_i} v_j over
  max(|Σ_j (q_i·k_j/√dh) e^{D_ij - m_i}|, e^{-m_i}); out = (h ⊙ σ(o)) W_down.
  No causal convolution, no learnable skip, no group norm.
* sLSTM: input preactivations x W_in + b for the gates (i, f, z, o), a
  block-diagonal recurrence over the heads, exponential input gate and
  log-sigmoid forget gate stabilized by m_t; h_t = σ(o) c_t / max(n_t,
  1e-6); then RMSNorm and a gated SiLU FFN (up, gate: d → d_ff, down). No
  causal convolution.
* RMSNorm: x / √(mean x² + 1e-6) · scale.

The parameters live in one flat vector in the mesh's layout (dict keys
sorted, depth first; the period's leaves carry a leading group dim of 1).
The loss over a batch is taken in blocks of rows, each block's gradient
summed with its share, so that the float32 reference fits beside nothing.
In the control, each matmul's operands and its result are rounded to
float8 (``precision``), as the program holds both in bfloat16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.precision import operand


def _widths(model: dict) -> dict:
    d, nh = model["d_model"], model["num_heads"]
    pad = lambda x: -(-x // 128) * 128
    di = pad(int(d * model["mlstm_proj_factor"]))
    return {"d": d, "nh": nh, "V": model["vocab_size"], "di": di,
            "dh_m": di // nh, "dh_s": d // nh,
            "dff": pad(int(d * model["slstm_proj_factor"]))}


def layout(model: dict) -> list:
    """``[(path, shape, init, scale)]`` in the flat vector's order."""
    w = _widths(model)
    d, nh, V, di, dhm, dhs, dff = (w[k] for k in (
        "d", "nh", "V", "di", "dh_m", "dh_s", "dff"))
    if model["num_layers"] != 2 or model["block_pattern"] != ["mlstm",
                                                              "slstm"]:
        raise ValueError("the reference holds one (mLSTM, sLSTM) period")
    g = lambda shape: (1,) + shape        # the period's group dim
    lin = lambda i, o: (g((i, o)), "normal", i ** -0.5)
    tree = {
        "embed": {"table": ((V, d), "normal", model["embed_scale"])},
        "final_norm": ((d,), "ones", 1.0),
        "unembed": {"table": ((V, d), "normal", model["unembed_scale"])},
        "stack": {"groups": {
            "l0": {"norm1": (g((d,)), "ones", 1.0), "mix": {
                "w_q": lin(d, di), "w_k": lin(d, di),
                "w_v": (g((d, nh, dhm)), "normal", d ** -0.5),
                "w_i": lin(d, nh), "w_f": lin(d, nh),
                "w_o": (g((d, nh, dhm)), "normal", d ** -0.5),
                "w_down": (g((nh, dhm, d)), "normal", di ** -0.5)}},
            "l1": {"norm1": (g((d,)), "ones", 1.0), "mix": {
                "w_in": lin(d, 4 * d),
                "r": (g((4, nh, dhs, dhs)), "normal", dhs ** -0.5),
                "b": (g((4 * d,)), "zeros", 0.0),
                "norm": (g((d,)), "ones", 1.0),
                "ffn": {"up": lin(d, dff), "gate": lin(d, dff),
                        "down": lin(dff, d)}}}}},
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


def views(flat: torch.Tensor, model: dict) -> dict:
    """``{"a/b/c": view}`` of each leaf, the group dim dropped."""
    out, at = {}, 0
    for path, shape, _, _ in layout(model):
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        out["/".join(p for p in path if p not in ("stack", "groups"))] = (
            v[0] if path[0] == "stack" else v)
        at += n
    return out


def _rms(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * scale


def _log_sigmoid(x):
    return -F.softplus(-x)


def _f8(x, f8):
    return operand(x, f8, "float8")


def _mm(a, b, f8):
    return _f8(_f8(a, f8) @ _f8(b, f8), f8)


def mlstm(p, x, nh: int, f8: bool):
    """One mLSTM block's mix on its normed input x (B, S, d)."""
    B, S, d = x.shape
    q = _mm(x, p["w_q"], f8).view(B, S, nh, -1)
    k = _mm(x, p["w_k"], f8).view(B, S, nh, -1)
    v = _mm(x, p["w_v"].reshape(d, -1), f8).view(B, S, nh, -1)
    o = torch.sigmoid(_mm(x, p["w_o"].reshape(d, -1), f8).view(B, S, nh, -1))
    log_i = _mm(x, p["w_i"], f8)                                # (B,S,nh)
    Fc = torch.cumsum(_log_sigmoid(_mm(x, p["w_f"], f8)), dim=1)
    D = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    D = D.masked_fill(~causal[None, :, :, None], -math.inf)
    m = D.amax(dim=2)                                            # (B,S,nh)
    s = _f8(torch.einsum("bihd,bjhd->bijh", _f8(q, f8), _f8(k, f8)),
            f8) / math.sqrt(q.shape[-1])
    sw = s * torch.exp(D - m[:, :, None, :])
    denom = torch.maximum(sw.sum(dim=2).abs(), torch.exp(-m))
    h = _f8(torch.einsum("bijh,bjhv->bihv", _f8(sw, f8), _f8(v, f8)),
            f8) / denom[..., None]
    return _mm((h * o).reshape(B, S, -1), p["w_down"].reshape(-1, d), f8)


def slstm(p, x, nh: int, f8: bool):
    """One sLSTM block's mix on its normed input x (B, S, d): the
    recurrence, then RMSNorm and the gated FFN."""
    B, S, d = x.shape
    dh = d // nh
    pre = (_mm(x, p["w_in"], f8) + p["b"]).view(B, S, 4, d)
    r = p["r"]                                             # (4, nh, dh, dh)
    h = c = n = x.new_zeros(B, d)
    m = x.new_full((B, d), -1e30)
    hs = []
    for t in range(S):
        rec = _f8(torch.einsum("bhk,ghkl->bghl", _f8(h.view(B, nh, dh), f8),
                               _f8(r, f8)), f8).reshape(B, 4, d)
        z = pre[:, t] + rec
        i_t, f_t, z_t, o_t = z.unbind(1)
        lf = _log_sigmoid(f_t)
        m_new = torch.maximum(lf + m, i_t)
        ig, fg = torch.exp(i_t - m_new), torch.exp(lf + m - m_new)
        c = fg * c + ig * torch.tanh(z_t)
        n = fg * n + ig
        h = torch.sigmoid(o_t) * c / n.clamp_min(1e-6)
        m = m_new
        hs.append(h)
    y = _rms(torch.stack(hs, dim=1), p["norm"])
    up = _mm(y, p["ffn/up"], f8)
    gate = _mm(y, p["ffn/gate"], f8)
    return _mm(F.silu(gate) * up, p["ffn/down"], f8)


def _mix_params(pv: dict, layer: str) -> dict:
    pre = f"{layer}/mix/"
    return {k[len(pre):]: v for k, v in pv.items() if k.startswith(pre)}


def loss_sum(flat, tokens, labels, model: dict, f8: bool = False):
    """The summed next-token cross-entropy of (B, S) ``tokens`` against
    ``labels`` at ``flat``."""
    pv = views(flat, model)
    nh = model["num_heads"]
    x = pv["embed/table"][tokens.long()]
    x = x + mlstm(_mix_params(pv, "l0"), _rms(x, pv["l0/norm1"]), nh, f8)
    x = x + slstm(_mix_params(pv, "l1"), _rms(x, pv["l1/norm1"]), nh, f8)
    h = _rms(x, pv["final_norm"])
    logits = _mm(h, pv["unembed/table"].t(), f8)
    return F.cross_entropy(logits.flatten(0, 1), labels.long().flatten(),
                           reduction="sum")


def loss_and_grad(flat: torch.Tensor, batch: dict, model: dict,
                  f8: bool = False, rows: int = 4):
    """The mean cross-entropy of ``batch`` (``tokens``, ``labels``: (B, S))
    and its flat gradient, ``rows`` sequences at a time."""
    flat = flat.detach().requires_grad_(True)
    tokens, labels = batch["tokens"], batch["labels"]
    count = labels.numel()
    total, grad = 0.0, torch.zeros_like(flat)
    for lo in range(0, tokens.shape[0], rows):
        part = loss_sum(flat, tokens[lo:lo + rows], labels[lo:lo + rows],
                        model, f8) / count
        (g,) = torch.autograd.grad(part, flat)
        grad += g
        total += float(part.detach())
    return torch.tensor(total), grad
