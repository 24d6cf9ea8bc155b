"""Top-level model: embeddings -> stack -> final norm -> (tied) unembed.

Counterpart of ``repro.models.model``: one ``Model`` class driven by a
``ModelConfig``. Modality frontends of the [audio]/[vlm] archs are stubs,
as in the reference: their batches carry precomputed frame/patch
``"embeddings"`` (B, S, d_model) instead of token ids.

The port builds every arch of the zoo: the attention-only family
(gemma2-2b/27b, qwen1.5-32b, deepseek-coder-33b, internvl2-1b,
hubert-xlarge), the MoE family (qwen2-moe-a2.7b; deepseek-v3-671b with MLA
and the MTP head), the hybrid recurrentgemma-2b (RG-LRU + local attention)
and xlstm-350m (mLSTM + sLSTM), at any tp. ``loss`` adds the MoE layers'
aux loss to the cross entropy and reports it as ``metrics["aux"]``; with
``cfg.mtp`` and a token batch it adds ``loss_weight`` times the MTP head's
cross entropy, ``metrics["mtp_ce"]`` (:meth:`Model._mtp_loss`).

``Model(cfg, tp)`` pads heads and the vocabulary to a multiple of tp, as
the reference's does; ``defs()`` are GLOBAL shapes (the reference's), and
each rank of a model axis holds its shards of them (``ParamDef`` specs
naming ``"model"``: ``init(..., ctx=ctx)`` draws the global tree and keeps
the rank's shards, ``models.params.shard_params``/``gather_params`` cut and
rejoin a tree). Params are nested dicts of tensors in the JAX package's
shapes and key order, so the mesh's flat vector, its EF rows and
checkpoints line up with the reference (``convert.model_params_from_jax``
carries a JAX init across).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as pdefs
from repro_torch.models import stack as stack_mod
from repro_torch.models.layers import (embed_defs, embed_lookup, rms_norm,
                                       sharded_xent, softcap, span,
                                       unembed_logits)
from repro_torch.sharding.rules import attn_dims, pad_to


class Model:
    def __init__(self, cfg: ModelConfig, tp: int = 1):
        self.cfg = cfg
        self.tp = tp
        self.vocab_padded = pad_to(cfg.vocab_size, tp)
        self.dims = attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                              tp)

    # ------------------------------------------------------------------
    # Parameter definitions
    # ------------------------------------------------------------------
    def defs(self):
        cfg = self.cfg
        d = {
            "embed": embed_defs(self.vocab_padded, cfg.d_model),
            "stack": stack_mod.stack_defs(cfg, self.tp),
            "final_norm": pdefs.norm_scale(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            d["unembed"] = embed_defs(self.vocab_padded, cfg.d_model)
        if cfg.mtp is not None:
            desc = stack_mod.LayerDesc("attn", 0)
            d["mtp"] = {
                "proj": pdefs.linear(2 * cfg.d_model, cfg.d_model),
                "block": stack_mod.layer_defs(cfg, desc, self.dims, self.tp),
                "norm": pdefs.norm_scale(cfg.d_model),
            }
        return d

    def init(self, generator: torch.Generator, device=None, ctx=None):
        """Params from ``generator`` (drawn on its device: a CPU
        ``torch.Generator`` gives the same init everywhere), on ``device``
        (None: CUDA, which raises without a card). With ``ctx`` (a context
        over a mesh with a model axis) this rank's shards of the global
        draw."""
        return pdefs.init_params(self.defs(), generator,
                                 resolve_device(device), ctx=ctx)

    # ------------------------------------------------------------------
    # Input specs
    # ------------------------------------------------------------------
    def train_batch_defs(self, batch: int, seq: int):
        cfg = self.cfg
        if cfg.frontend is not None:
            return {
                "embeddings": pdefs.ParamDef((batch, seq, cfg.d_model),
                                             spec=("data", None, None),
                                             dtype=cfg.dtype),
                "labels": pdefs.ParamDef((batch, seq), spec=("data", None),
                                         dtype="int32"),
            }
        return {
            "tokens": pdefs.ParamDef((batch, seq), spec=("data", None),
                                     dtype="int32"),
            "labels": pdefs.ParamDef((batch, seq), spec=("data", None),
                                     dtype="int32"),
        }

    # ------------------------------------------------------------------
    # Forward / loss
    # ------------------------------------------------------------------
    def _embed_in(self, params, batch, ctx):
        if "embeddings" in batch:
            return batch["embeddings"].to(getattr(torch, self.cfg.dtype))
        return embed_lookup(params["embed"], batch["tokens"], ctx,
                            self.cfg.dtype)

    def _unembed(self, params, h, ctx):
        with span("unembed"):
            table = params.get("unembed", params["embed"])
            logits = unembed_logits(table, ctx.tp_copy(h), self.cfg.dtype)
            return softcap(logits.float(), self.cfg.logit_softcap)

    def loss(self, params, batch, ctx, *, remat_policy: str = "full",
             chunk: int = 2048):
        """Next-token (or masked-target) CE. Returns (loss, metrics)."""
        cfg = self.cfg
        x = self._embed_in(params, batch, ctx)
        h, aux = stack_mod.stack_train(params["stack"], x, cfg, ctx,
                                       remat_policy=remat_policy, chunk=chunk)
        h = rms_norm(params["final_norm"], h, cfg.norm_eps)
        logits = self._unembed(params, h, ctx)
        with span("xent"):
            ce = sharded_xent(logits, batch["labels"], ctx,
                              true_vocab=cfg.vocab_size)
        loss = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp is not None and "tokens" in batch:
            mtp_ce = self._mtp_loss(params, h, batch, ctx)
            loss = loss + cfg.mtp.loss_weight * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return loss, metrics

    def _mtp_loss(self, params, h, batch, ctx):
        """DeepSeek-V3 multi-token prediction: predict t+2 from [h_t;
        emb_{t+1}], h after ``final_norm``. The shifts wrap around
        (``torch.roll``, the reference's ``jnp.roll``); the block is an
        MLA + MoE layer at the default chunk, its aux loss dropped."""
        cfg = self.cfg
        mp = params["mtp"]
        with span("mtp"):
            emb_next = embed_lookup(params["embed"],
                                    torch.roll(batch["tokens"], -1, dims=1),
                                    ctx, cfg.dtype)
            z = torch.cat([h, emb_next], dim=-1) @ mp["proj"].to(h.dtype)
            desc = stack_mod.LayerDesc("attn", 0)
            z, _ = stack_mod.layer_train(mp["block"], z, cfg, desc, self.dims,
                                         ctx)
            z = rms_norm(mp["norm"], z, cfg.norm_eps)
        logits = self._unembed(params, z, ctx)
        labels2 = torch.roll(batch["labels"], -1, dims=1)
        with span("xent"):
            return sharded_xent(logits, labels2, ctx,
                                true_vocab=cfg.vocab_size)

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def cache_defs(self, batch: int, max_len: int, *,
                   seq_sharded: bool = False):
        return stack_mod.stack_cache_defs(self.cfg, self.tp, batch, max_len,
                                          seq_sharded=seq_sharded)

    def init_cache(self, batch: int, max_len: int, *,
                   seq_sharded: bool = False, device=None, ctx=None):
        """A zero cache on ``device`` (None: CUDA); with ``ctx``, this
        rank's block of it (its model shards and, ``seq_sharded``, its
        block of the slots)."""
        return stack_mod.init_cache_value(
            self.cache_defs(batch, max_len, seq_sharded=seq_sharded),
            resolve_device(device),
            {} if ctx is None else ctx.axis_sizes())

    def _require_decoder(self):
        if self.cfg.is_encoder:
            raise ValueError(f"{self.cfg.name} is encoder-only: no decode "
                             f"path")

    def prefill(self, params, tokens, ctx, *, max_len: int,
                chunk: int = 2048):
        """tokens (B,S) -> (last-position logits (B, V/tp), caches)."""
        self._require_decoder()
        x = embed_lookup(params["embed"], tokens, ctx, self.cfg.dtype)
        h, caches = stack_mod.stack_prefill(params["stack"], x, self.cfg, ctx,
                                            max_len=max_len, chunk=chunk)
        h = rms_norm(params["final_norm"], h[:, -1:], self.cfg.norm_eps)
        return self._unembed(params, h, ctx)[:, 0], caches

    def decode_step(self, params, token, caches, pos, ctx, *, max_len: int):
        """token (B,1), pos an int -> (logits (B, V/tp), new caches)."""
        self._require_decoder()
        x = embed_lookup(params["embed"], token, ctx, self.cfg.dtype)
        h, caches = stack_mod.stack_decode(params["stack"], x, caches, pos,
                                           self.cfg, ctx, max_len)
        h = rms_norm(params["final_norm"], h, self.cfg.norm_eps)
        return self._unembed(params, h, ctx)[:, 0], caches

    def encode(self, params, batch, ctx, *, chunk: int = 2048):
        """Full-sequence forward without a cache (the encoder archs'
        prefill): logits at every position."""
        x = self._embed_in(params, batch, ctx)
        h, _ = stack_mod.stack_train(params["stack"], x, self.cfg, ctx,
                                     remat_policy="none", chunk=chunk)
        h = rms_norm(params["final_norm"], h, self.cfg.norm_eps)
        return self._unembed(params, h, ctx)


def greedy_sample(logits_local, ctx):
    """Argmax over a vocab-sharded logits row (the first maximum on ties).
    logits_local: (B, V/tp) -> (B,) int32."""
    vloc = logits_local.shape[-1]
    lo = ctx.model_index() * vloc
    lmax = logits_local.amax(dim=-1)
    larg = logits_local.argmax(dim=-1).to(torch.int32) + lo
    gmax = ctx.pmax_model(lmax)
    cand = torch.where(lmax >= gmax, larg,
                       torch.full_like(larg, 2 ** 30))
    return -ctx.pmax_model(-cand)
