"""The benchmark's own copies and counts against the program they stand
beside: the frozen traffic generator draws what the port's data module
draws, the reference's parameter layout is the port's ravel order, the
ConvMixer FLOP count, and the TF32 rounding of the control."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from smoke_cells import harness  # noqa: F401 (puts src/ on the path)
from perfbench.counts import convmixer as counts
from perfbench.reference import convmixer as ref_cm
from perfbench.reference.precision import round_tf32
from perfbench.traffic import generator, synthetic

CONVMIXER_256_8 = dict(dim=256, depth=8, kernel=9, patch=2, num_classes=10,
                       image=32, channels=3)


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_frozen_traffic_draws_as_the_port(seed):
    from repro_torch.data.synthetic import FederatedClassification as Port
    kw = dict(num_clients=12, image_shape=(8, 8, 3), alpha=0.3, noise=0.6,
              seed=seed)
    mine, port = synthetic.FederatedClassification(**kw), Port(**kw)
    np.testing.assert_array_equal(mine.prototypes, port.prototypes)
    np.testing.assert_array_equal(mine.label_dist, port.label_dist)
    a, b = mine.round_batches([3, 7], 2, 3, 4), port.round_batches(
        [3, 7], 2, 3, 4)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_rounds_same_sizes_every_seed():
    traffic = harness.load_cell("convmixer-256-8.sync").traffic
    traffic = dict(traffic, pool_rounds=2, batch=2,
                   fed=dict(traffic["fed"], num_clients=20, participating=4))
    shapes = set()
    for seed in (1, 2, 2**32 + 3):
        for ids, b in generator.federated_rounds(traffic, seed, 2):
            assert len(set(ids.tolist())) == 4
            shapes.add((ids.shape, b["x"].shape, b["y"].shape))
    assert shapes == {((4,), (4, 3, 2, 32, 32, 3), (4, 3, 2))}
    a = generator.federated_rounds(traffic, 5, 2)
    b = generator.federated_rounds(traffic, 5, 2)
    np.testing.assert_array_equal(a[1][1]["x"], b[1][1]["x"])


def test_reference_layout_is_the_ports_ravel_order():
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import leaves_with_paths
    port = [(path, tuple(d.shape)) for path, d in
            leaves_with_paths(cm.convmixer_defs(
                cm.ConvMixerConfig(**CONVMIXER_256_8)))]
    mine = [(path, shape) for path, shape, _, _ in
            ref_cm.layout(CONVMIXER_256_8)]
    assert mine == port
    assert ref_cm.size(CONVMIXER_256_8) == 704266


def test_convmixer_flops():
    fwd = counts.forward_flops_per_example(CONVMIXER_256_8)
    assert fwd == 354_948_096                 # ~355 MFLOP an image
    layers = counts.layer_flops(CONVMIXER_256_8)
    assert layers["depthwise"] == 8 * 10_616_832
    assert layers["pointwise"] == 8 * 33_554_432
    assert (counts.train_flops_per_example(CONVMIXER_256_8)
            == 3 * fwd - layers["patch"])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10),
                      3.14159265], dtype=torch.float32)
    y = round_tf32(x)
    # ties to even at the 10th mantissa bit; TF32 values stay put
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 4 * 2**-11, -(1.0 + 2**-10)]
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(float(y[4]) - 3.14159265) <= 2**-10 * 2


XLSTM_350M_2L = dict(d_model=1024, num_heads=4, vocab_size=50304,
                     mlstm_proj_factor=2.0, slstm_proj_factor=4 / 3,
                     num_layers=2, block_pattern=["mlstm", "slstm"])


def test_xlstm_flops():
    from perfbench.counts import xlstm
    f = xlstm.forward_flops_per_sequence(XLSTM_350M_2L, 4096)
    per_token = {k: v / 4096 for k, v in f.items()}
    # matmuls: 2 x 20.0 M weights outside the embeddings, 2 x 51.5 M in
    # the unembedding; the mLSTM's causal q.k and weighted sum of v
    assert per_token["unembed"] == 2 * 1024 * 50304
    assert per_token["mlstm_proj"] + per_token["slstm"] == 2 * (
        4 * 1024 * 2048 + 2 * 1024 * 4 + 2048 * 1024
        + 1024 * 4096 + 4 * 4 * 256 * 256 + 3 * 1024 * 1408)
    assert f["mlstm_quadratic"] == 2 * 2 * 2048 * 4096 * 4097 // 2
    assert xlstm.train_flops_per_sequence(XLSTM_350M_2L, 4096) == \
        3 * sum(f.values())


def test_kernel_bytes():
    from perfbench.counts.kernels import bytes_per_round
    # route z's 51,511,296-value leaf: 824 MB through topk_ef, 1.85 GB
    # through fedams_update (PERF.md's kernel table, scripts/topk_floor.py)
    b = bytes_per_round([51_511_296])
    assert b == {"topk_ef_kernel": 51_511_296 * 16 + 8,
                 "fedams_update_kernel": 51_511_296 * 36}
    assert round(b["topk_ef_kernel"] / 1e6) == 824
    assert round(b["fedams_update_kernel"] / 1e9, 2) == 1.85
