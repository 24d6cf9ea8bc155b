"""Serving in the port (``Model.prefill``/``decode_step``,
``launch/serve.py``) against the JAX package, on the CPU at smoke size.

The JAX init is carried across by ``convert.model_params_from_jax``;
prompts come from a numpy seed. fp32 throughout: the two sides differ only
in summation order, and each tolerance is stated where it is set.

* ``prefill``'s last-position logits and its caches (the windowed layers'
  rolled ring, the global layers' padded one), unchunked and q-chunked
  with a band, then k ``decode_step``s past the window against JAX's, on
  every decoder arch the port builds (qwen2-moe's MoE FFN, deepseek-v3's
  MLA latent cache and recurrentgemma's RG-LRU state included), on
  ``test_decode_consistency.py``'s two dense cases, its ``mla_moe``,
  ``hybrid_rglru`` and ``xlstm`` cases, on xlstm-350m's smoke config
  (mLSTM + sLSTM state), and on an attention + MoE case (its ``mla_moe``
  case without MLA, capacity factor 8.0);
* decoding from an empty cache equals the port's full-sequence forward;
* the serve CLI on ``--device cpu`` prints the JAX CLI's tokens, both
  restoring the same checkpoint (the JAX package's files), on gemma2-2b,
  deepseek-v3 (its checkpoint holds the MTP block serving never runs),
  recurrentgemma and xlstm, and at ``--tp 2`` (two gloo ranks against the
  JAX CLI at tp = 1) on gemma2-2b and xlstm;
  ``examples/serve_batched_torch.py`` runs on
  ``--device cpu``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as jax_save_pytree
from repro.configs import base as jbase
from repro.configs.registry import get_arch as jax_arch
from repro.models.model import Model as JaxModel
from repro.sharding.rules import ParallelContext as JaxCtx
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model, greedy_sample
from repro_torch.models.params import leaves_with_paths
from repro_torch.sharding.rules import ParallelContext
from test_decode_consistency import CASES as DECODE_CASES

torch.set_num_threads(1)

CTX, JCTX = ParallelContext(), JaxCtx()
ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
DECODERS = ("gemma2-2b", "gemma2-27b", "qwen1.5-32b", "deepseek-coder-33b",
            "internvl2-1b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
            "recurrentgemma-2b", "xlstm-350m")
CASES = {a: (jax_arch(a).smoke, get_arch(a).smoke) for a in DECODERS}
CASES.update({f"decode:{n}": (c, ModelConfig(**{
    f.name: getattr(c, f.name) for f in dataclasses.fields(c)}))
    for n, c in DECODE_CASES.items()
    if n in ("dense_gqa", "local_global_softcap", "mla_moe", "hybrid_rglru",
             "xlstm")})
#: ``test_decode_consistency.py``'s ``mla_moe`` case without MLA: at
#: capacity factor 8.0 (≥ E/k) an expert has a slot for every token, so
#: decode (T = B) drops no token the forward keeps
_ATTN_MOE = dict(name="am", family="moe", num_layers=2, d_model=64,
                 num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=64,
                 dtype="float32")
_MOE = dict(num_experts=4, top_k=2, num_shared_experts=1, d_ff_expert=64,
            capacity_factor=8.0)
CASES["decode:attn_moe"] = (
    jbase.ModelConfig(**_ATTN_MOE, moe=jbase.MoEConfig(**_MOE)),
    ModelConfig(**_ATTN_MOE, moe=MoEConfig(**_MOE)))


def close(got, want, rel, what=""):
    """|got − want| ≤ rel · max|want|."""
    got = got.detach().double().numpy()
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _models(name):
    jc, tc = CASES[name]
    jm, tm = JaxModel(jc), Model(tc)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, tm, jp, model_params_from_jax(jp, "cpu")


@pytest.mark.parametrize("chunk", [2048, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_then_decode_past_the_window_matches_jax(name, chunk):
    """A 40-token prompt (past every smoke window: 16, and 6 for
    ``local_global_softcap``) prefilled into caches of 52, then 12 decode
    steps, so the windowed layers' rings wrap. At ``chunk=8`` (40 > 16)
    the prefill runs q-chunked with a band of keys on the windowed layers.
    Logits within 1e-5 of the largest |logit|, every cache leaf within
    1e-5 of its largest |value|, at every step (fp32; the caches are the
    roped k/v, the MLA latents or the RG-LRU state, whose matmuls sum in
    another order than XLA's; JAX's jitted decode step contracts the
    recurrence into an FMA). MLA decodes absorbed on both sides: the
    caches and logits are held against JAX's, not against the forward."""
    jm, tm, jp, tp = _models(name)
    B, S, G = 2, 40, 12
    max_len = S + G
    toks = np.random.default_rng(7).integers(
        0, tm.cfg.vocab_size, size=(B, S + G)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]), JCTX, max_len=max_len,
                        chunk=chunk)
    jstep = jax.jit(lambda p, tk, c, pos: jm.decode_step(
        p, tk, c, pos, JCTX, max_len=max_len))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]), CTX,
                            max_len=max_len, chunk=chunk)

    def same_caches(tcache, jcache, step):
        jd = dict(leaves_with_paths(jax.device_get(jcache)))
        paths = [p for p, _ in leaves_with_paths(tcache)]
        assert paths == sorted(jd)
        for path, leaf in leaves_with_paths(tcache):
            close(leaf, jd[path], 1e-5, f"{name} cache {path} step {step}")

    close(tl, jl, 1e-5, f"{name} prefill logits")
    same_caches(tc, jc, "prefill")
    for i in range(G):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jstep(jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, S + i, CTX,
                                    max_len=max_len)
        close(tl, jl, 1e-5, f"{name} decode step {i}")
    same_caches(tc, jc, G)
    assert np.array_equal(greedy_sample(tl, CTX).numpy(),
                          np.asarray(jl.argmax(-1)))


@pytest.mark.parametrize("name", ["gemma2-2b", "decode:local_global_softcap",
                                  "qwen1.5-32b", "decode:attn_moe",
                                  "qwen2-moe-a2.7b", "decode:mla_moe",
                                  "decode:hybrid_rglru", "recurrentgemma-2b",
                                  "decode:xlstm", "xlstm-350m"])
def test_decode_from_an_empty_cache_matches_the_forward(name):
    """Decoding a sequence token by token from ``init_cache`` (the rings
    wrap after 16 / 6 tokens) gives the full-sequence forward's logits at
    every position, within 1e-5 of the largest |logit| (the reference's
    own consistency check, on the port): MLA's absorbed decode against the
    decompressed forward, RG-LRU's step against the scan."""
    _, tm, _, tp = _models(name)
    B, S, max_len = 2, 24, 24
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, size=(B, S)).astype(np.int32))
    with torch.no_grad():
        ref = tm.encode(tp, {"tokens": toks}, CTX)
        caches = tm.init_cache(B, max_len, device="cpu")
        outs = []
        for i in range(S):
            lg, caches = tm.decode_step(tp, toks[:, i:i + 1], caches, i, CTX,
                                        max_len=max_len)
            outs.append(lg)
    close(torch.stack(outs, 1), ref.numpy(), 1e-5)


def test_greedy_sample_takes_the_first_maximum():
    lg = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert greedy_sample(lg, CTX).tolist() == [1, 0]
    assert greedy_sample(lg, CTX).dtype == torch.int32


def _seq_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if ln.strip().startswith("seq[")]


def _serve_clis(arch, tmp_path, capsys, tp=1):
    """Both CLIs restore one checkpoint (the JAX init of ``arch``'s smoke
    config, its embedding table scaled by 0.05 so that the layers, not the
    table, pick the tokens) and greedy-decode the same prompts, the port's
    at ``tp`` (on tp gloo ranks), the JAX CLI's at tp = 1: the printed
    tokens are equal."""
    cfg = jax_arch(arch).smoke
    params = jax.device_get(JaxModel(cfg).init(jax.random.PRNGKey(4)))
    params["embed"]["table"] = params["embed"]["table"] * np.float32(0.05)
    path = str(tmp_path / "ckpt")
    jax_save_pytree(path, params, {"arch": cfg.name})
    argv = ["--arch", arch, "--smoke", "--batch", "3",
            "--prompt-len", "20", "--gen", "10", "--checkpoint", path]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = _seq_lines(out.stdout)
    tserve.main(argv + ["--tp", str(tp), "--device", "cpu"])
    got = _seq_lines(capsys.readouterr().out)
    assert len(want) == 3 and got == want
    assert len({ln.split("->")[1] for ln in got}) > 1


def test_serve_cli_prints_the_jax_clis_tokens(tmp_path, capsys):
    _serve_clis("gemma2-2b", tmp_path, capsys)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "recurrentgemma-2b",
                                  "xlstm-350m"])
def test_serve_cli_prints_the_jax_clis_tokens_on_mla_and_rglru(
        arch, tmp_path, capsys):
    """As :func:`test_serve_cli_prints_the_jax_clis_tokens`: deepseek-v3's
    MLA + MoE (the checkpoint holds the MTP block too, which serving
    restores and never runs), recurrentgemma's RG-LRU + local attention
    and xlstm's mLSTM + sLSTM."""
    _serve_clis(arch, tmp_path, capsys)


@pytest.mark.parametrize("arch", ["gemma2-2b", "xlstm-350m"])
def test_serve_cli_at_tp2_prints_the_jax_clis_tokens(arch, tmp_path, capfd):
    """``--tp 2``: the port's two gloo ranks (rank 0 prints) against the
    JAX CLI on one checkpoint. The JAX CLI's own ``--tp 2`` fails under
    jax 0.9: its cache out_specs name ``"data"`` on a ``("model",)`` mesh
    (ROADMAP Queue 3 item 23), so it serves at tp = 1 here."""
    _serve_clis(arch, tmp_path, capfd, tp=2)


def test_serve_refuses_what_the_port_does_not_run():
    """An encoder-only arch has no decode path (``--tp 2`` and xlstm-350m
    run: the two tests above)."""
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                     "cpu"])


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b",
                                  "deepseek-v3-671b", "recurrentgemma-2b"])
def test_serve_batched_example_runs_on_the_cpu(arch):
    """The twin of ``examples/serve_batched.py`` serves a smoke config on
    ``--device cpu``: its prefill, decode and request lines, tokens in the
    vocabulary, and neither jax nor repro loaded."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['serve_batched_torch.py', '--arch', '{arch}', "
            "'--batch', '3', '--prompt-len', '12', '--gen', '6', "
            "'--device', 'cpu']\n"
            "runpy.run_path("
            f"{os.path.join(ROOT, 'examples', 'serve_batched_torch.py')!r}, "
            "run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]", out.stdout
    assert lines[0].startswith("prefill 3x12: "), out.stdout
    assert lines[1].startswith("decode: "), out.stdout
    reqs = [ln for ln in lines if ln.strip().startswith("request[")]
    vocab = get_arch(arch).smoke.vocab_size
    assert len(reqs) == 3
    for ln in reqs:
        toks = [int(v) for v in ln.split("-> [")[1].split("]")[0].split(",")]
        assert len(toks) == 6 and all(0 <= v < vocab for v in toks), ln
