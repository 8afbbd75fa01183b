"""The frozen yardstick arithmetic against hand counts and against the
program's copy it was taken from."""

import json
import pathlib

import pytest

from benchmark.core import layers
from benchmark.frozen import flops

BENCH = pathlib.Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((BENCH / "configs" / (name + ".json")).read_text())


def test_dense_chain_by_hand():
    assert flops.dense_chain_flops(10, [3, 4, 5]) == 2 * 10 * (12 + 20)


def test_forward_flops_by_hand():
    cfg = config("car_auto_T3")["config"]
    p, k, e0, e1 = 1000, 100, 5000, 3000
    pool = 2 * p * 1 * 32 + 2 * p * 3 * 32 + 2 * k * 3 * 32 \
        + 2 * e0 * (32 * 64 + 64 * 128 + 128 * 300) \
        + 2 * k * (300 * 300 + 300 * 300)
    gnn = 2 * k * (300 * 64 + 64 * 3) + 2 * k * 300 * 300 \
        + 2 * 2 * k * 3 * 300 + 2 * e1 * 300 * 300 \
        + 2 * k * (300 * 300 + 300 * 300)
    head = 2 * k * (300 * 64 + 64 * 4) \
        + 4 * 2 * k * (300 * 64 + 64 * 64 + 64 * 7)
    want = pool + 3 * gnn + head
    assert flops.pointgnn_forward_flops(cfg, 1, p, k, e0, e1) == want


@pytest.mark.parametrize("name", ["car_auto_T3", "ped_cyl_auto_T3"])
def test_forward_flops_equal_the_programs(name):
    from pointgnn_tpu_torch.utils import flops as program_flops

    cfg = config(name)["config"]
    args = (cfg, 1, 23456, 7890, 412345, 1134567)
    assert flops.pointgnn_forward_flops(*args) == \
        program_flops.pointgnn_forward_flops(*args)


def test_k1_bound_by_hand():
    pairs, n_src, n_ctr, h = 1000, 64, 32, 8
    t, kind, f, b = flops.k1_bound(pairs, n_src, n_ctr, h, [8, 16, 4], 9,
                                   flops.PEAK_BF16_FLOPS)
    want_f = pairs * (2 * 8 + 2 * 8 * 16 + 2 * 16 + 2 * 16 * 4 + 2 * 4)
    want_b = 4 * (8 * 16 + 16 + 16 * 4 + 4) + 4 * 64 * 8 + 16 * 64 \
        + 4 * 32 * 8 + 16 * 32 + 4 * 10 + 4 * 32 + 4 * 32 * 4
    assert (f, b) == (want_f, want_b)
    assert t == max(want_f / 989e12, want_b / 3.35e12)
    assert kind == ("operations" if want_f / 989e12 >= want_b / 3.35e12
                    else "bytes")


def test_k1_bound_matches_chip_smoke_at_serving_shapes():
    """``chip_smoke.bound`` over tensors of the serving K1 shapes gives
    the same seconds as the frozen bound over those shapes."""
    import sys

    import torch

    sys.path.insert(0, str(BENCH.parent))
    import chip_smoke

    cfg = config("car_auto_T3")
    for h, dims, n_src, cells in ((32, [32, 64, 128, 300], 32768, 130 ** 2),
                                  (300, [300, 300], 16384, 33 ** 2)):
        k = 16384
        args = dict(
            table_a=torch.zeros(n_src, h), src_xyz=torch.zeros(n_src, 4),
            table_b=torch.zeros(k, h), ctr_xyz=torch.zeros(k, 4),
            offsets=torch.zeros(cells + 1, dtype=torch.int32),
            center_cell=torch.zeros(k, dtype=torch.int32),
            weights=[(torch.zeros(a, b), torch.zeros(b))
                     for a, b in zip(dims[:-1], dims[1:])])
        ms = chip_smoke.bound(args, 123456, flops.PEAK_BF16_FLOPS)[0]
        s = flops.k1_bound(123456, n_src, k, h, dims, cells,
                           flops.PEAK_BF16_FLOPS)[0]
        assert ms / 1e3 == pytest.approx(s, rel=1e-12)
    counts = {"pairs_l0": 123456, "pairs_l1": 123456}
    assert layers.k1_frame_bound(cfg, counts) == pytest.approx(
        flops.k1_bound(123456, 32768, 16384, 32, [32, 64, 128, 300],
                       130 ** 2, flops.PEAK_BF16_FLOPS)[0]
        + 3 * flops.k1_bound(123456, 16384, 16384, 300, [300, 300],
                             33 ** 2, flops.PEAK_BF16_FLOPS)[0])
