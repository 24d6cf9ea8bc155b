"""xlstm's local round is ill-conditioned at two local steps in the JAX
reference as in the port (ROADMAP Queue 3 item 29, held).

``tests/xlstm_conditioning.py`` runs the local phase of a dense FedAvg
round (one client, K plain SGD steps at route w's η_l = 0.001) from one
init drawn with numpy, on the reference (``jax.jit``), on the port, and on
the reference from the same init with every element of every leaf one
ulp up. Here at the smoke config's widths, 24 layers, fp32, batch 2 × 64:

* at K = 1 the port and the moved reference are within 1e-3 of the
  reference on every leaf (route w's bound);
* at K = 2 the moved reference departs from the reference ten times (or
  more) as far as at K = 1 — a one-ulp change of its input moves the
  reference's own round so — and the port departs no further than it.

Read here: K = 1 port 2.37e-4, moved 1.84e-4; K = 2 port 8.72e-3, moved
9.55e-2, on the zero-initialised sLSTM bias (one position of the mLSTM's
normalizer ``max(|η|, exp(-m))`` at a near tie takes the other side, in
the port and in the moved reference alike).
"""
import pytest
import torch

from xlstm_conditioning import reading

torch.set_num_threads(1)


def test_the_reference_round_is_as_ill_conditioned_at_two_local_steps():
    r = reading(24, 64, widths="smoke")
    worst = {k: {w: max(r[k][f"{w}_vs_jax"].values())
                 for w in ("port", "moved")} for k in (1, 2)}
    assert worst[1]["port"] <= 1e-3 and worst[1]["moved"] <= 1e-3, worst
    assert worst[2]["moved"] >= 10 * worst[1]["moved"], worst
    assert worst[2]["port"] <= worst[2]["moved"], worst
    for k in (1, 2):
        assert r[k]["losses"]["port"] == pytest.approx(
            r[k]["losses"]["jax"], rel=1e-5)
