"""Serving in the port (``Model.prefill``/``decode_step``,
``launch/serve.py``) against the JAX package, on the CPU at smoke size.

The JAX init is carried across by ``convert.model_params_from_jax``;
prompts come from a numpy seed. fp32 throughout: the two sides differ only
in summation order, and each tolerance is stated where it is set.

* ``prefill``'s last-position logits and its caches (the windowed layers'
  rolled ring, the global layers' padded one), unchunked and q-chunked
  with a band, then k ``decode_step``s past the window against JAX's, on
  every decoder arch of the slice and on ``test_decode_consistency.py``'s
  two dense cases;
* decoding from an empty cache equals the port's full-sequence forward;
* the serve CLI on ``--device cpu`` prints the JAX CLI's tokens, both
  restoring the same checkpoint (the JAX package's files).
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
from repro.configs.registry import get_arch as jax_arch
from repro.models.model import Model as JaxModel
from repro.sharding.rules import ParallelContext as JaxCtx
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model, greedy_sample
from repro_torch.models.params import leaves_with_paths
from repro_torch.sharding.rules import ParallelContext
from test_decode_consistency import CASES as DECODE_CASES

torch.set_num_threads(1)

CTX, JCTX = ParallelContext(), JaxCtx()
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DECODERS = ("gemma2-2b", "gemma2-27b", "qwen1.5-32b", "deepseek-coder-33b",
            "internvl2-1b")
CASES = {a: (jax_arch(a).smoke, get_arch(a).smoke) for a in DECODERS}
CASES.update({f"decode:{n}": (c, ModelConfig(**{
    f.name: getattr(c, f.name) for f in dataclasses.fields(c)}))
    for n, c in DECODE_CASES.items()
    if n in ("dense_gqa", "local_global_softcap")})


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
    roped k/v, whose matmuls sum in another order than XLA's)."""
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
                                  "qwen1.5-32b"])
def test_decode_from_an_empty_cache_matches_the_forward(name):
    """Decoding a sequence token by token from ``init_cache`` (the rings
    wrap after 16 / 6 tokens) gives the full-sequence forward's logits at
    every position, within 1e-5 of the largest |logit| (the reference's
    own consistency check, on the port)."""
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


def test_serve_cli_prints_the_jax_clis_tokens(tmp_path, capsys):
    """Both CLIs restore one checkpoint (the JAX init of the gemma2-2b smoke
    config, its embedding table scaled by 0.05 so that the layers, not the
    tied table, pick the tokens) and greedy-decode the same prompts: the
    printed tokens are equal."""
    cfg = jax_arch("gemma2-2b").smoke
    params = jax.device_get(JaxModel(cfg).init(jax.random.PRNGKey(4)))
    params["embed"]["table"] = params["embed"]["table"] * np.float32(0.05)
    path = str(tmp_path / "ckpt")
    jax_save_pytree(path, params, {"arch": cfg.name})
    argv = ["--arch", "gemma2-2b", "--smoke", "--batch", "3",
            "--prompt-len", "20", "--gen", "10", "--checkpoint", path]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = _seq_lines(out.stdout)
    tserve.main(argv + ["--device", "cpu"])
    got = _seq_lines(capsys.readouterr().out)
    assert len(want) == 3 and got == want
    assert len({ln.split("->")[1] for ln in got}) > 1


def test_serve_refuses_what_the_port_does_not_run():
    with pytest.raises(NotImplementedError, match="tp = 1"):
        tserve.main(["--smoke", "--tp", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                     "cpu"])
    with pytest.raises(NotImplementedError, match="MoE"):
        tserve.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                     "cpu"])
