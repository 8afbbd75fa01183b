"""The plain reference against the program's plain path at a tiny size
on the CPU, and the reference NMS against the program's numpy loop."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.core import adapter, judge, lidar
from benchmark.reference import nms as ref_nms
from benchmark.reference import pointgnn as ref
from benchmark.reference.weights import calibrate_classes, make_weights

BENCH = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def load(kind, name):
    return json.loads((BENCH / kind / (name + ".json")).read_text())


def tiny_pool(seed, frames=2):
    m = load("traffic", "stream")
    m.update(pool_frames=frames, points_per_beam=[24, 30])
    return lidar.make_pool(m, seed)


@pytest.mark.parametrize("name", ["car_auto_T3", "ped_cyl_auto_T3"])
def test_reference_equals_the_programs_float32_path(name):
    cfg = load("configs", name)
    cfg["serving"].update(num_points=2048, num_keypoints=2048,
                          compute_dtype="float32")
    config = cfg["config"]
    weights = make_weights(config, 1, 1, 5, CPU, 0.05, 0.01)
    calibrate_classes(weights, config, [0.0] * config["num_classes"], 1.5)
    pipe = adapter.serving_pipeline(cfg, adapter.program_params(weights), CPU)
    for xyz, attr in tiny_pool(7):
        hyps = tuple(t.numpy() for t in pipe.device_fn(
            pipe.params, torch.from_numpy(
                __import__("pointgnn_tpu_torch.graph.device_builder",
                           fromlist=["pack_points"]).pack_points(
                    xyz, attr[:, :1], 2048))))
        dets = pipe.run_frame(adapter.points(xyz, attr))[:3]
        graph = ref.FrameGraph(xyz, config, CPU)
        probs, enc = ref.forward(graph, attr[:, 0], weights, config)
        got, _ = judge.judge_frames([(hyps, dets, graph,
                                      {"f32": (probs, enc)})], config,
                                    cfg["serving"]["max_hypotheses"])
        assert got["score_err"] < 1e-4, got
        assert got["box_err"] < 1e-4, got
        assert got["nms_err"] < 1e-9, got


def test_reference_graph_counts_equal_the_programs():
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.nn import slab

    cfg = load("configs", "car_auto_T3")
    (xyz, attr), = tiny_pool(3, frames=1)
    spec = db.spec_from_config(cfg["config"], 2048, 2048)._replace(
        slab_level0=True, slab_level1=True)
    x, f, mask = (torch.from_numpy(a) for a in db.pad_points(xyz, attr[:, :1],
                                                              2048))
    g = db.build_padded_graph(x, f, mask, spec)
    counts = ref.FrameGraph(xyz, cfg["config"], CPU).counts
    assert counts["keypoints"] == int(g.vertex_mask[1].sum())
    assert counts["points"] == int(g.vertex_mask[0].sum())
    for level, src, key in ((spec.level0, 0, "pairs_l0"),
                            (spec.level1, 1, "pairs_l1")):
        wiring = db.slab_kernel_wiring(level)
        offsets = g.slab0_offsets if src == 0 else g.slab_offsets
        cells = g.slab0_center_cell if src == 0 else g.slab_center_cell

        def xyz4(v, m, s):
            x4 = torch.cat([v, torch.zeros_like(v[:, :1])], 1)
            return torch.where(m[:, None] > 0, x4, torch.full((), s))

        n = slab.inradius_pair_count(
            xyz4(g.vertex_xyz[src], g.vertex_mask[src], 1e6),
            xyz4(g.vertex_xyz[1], g.vertex_mask[1], -1e6), offsets, cells,
            wiring["grid_g"], wiring["radius"], wiring["halo"])
        assert counts[key] == n


def random_boxes(rng, n):
    xyz = rng.uniform([-5, 0, 5], [5, 1, 15], (n, 3))
    lhw = rng.uniform([3, 1.3, 1.4], [4.5, 1.7, 1.8], (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.hstack([xyz, lhw, yaw])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_nms_equals_the_programs_numpy_loop(seed):
    from pointgnn_tpu_torch.postprocess import iou, nms

    rng = np.random.default_rng(seed)
    n = 300
    boxes = random_boxes(rng, n)
    scores = rng.uniform(0.3, 1.0, n)
    classes = rng.integers(1, 3, n)
    # the program's numpy loop runs for any overlap function other than
    # its default, so hand it the same function under another name
    overlap = lambda one, many: iou.overlapped_boxes_3d(one, many)
    for thr in (0.01, 0.2):
        want = nms.nms_boxes_3d_uncertainty(classes, boxes, scores,
                                            overlapped_thres=thr,
                                            overlapped_fn=overlap)
        got = ref_nms.merge_nms(classes, boxes, scores, thr)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-9)
        assert len(got[0]) < n


def test_reference_overlap_equals_the_programs():
    from pointgnn_tpu_torch.postprocess import iou

    rng = np.random.default_rng(9)
    c = ref_nms.corners(random_boxes(rng, 200))
    for i in range(5):
        np.testing.assert_allclose(ref_nms.overlaps(c[i], c),
                                   iou.overlapped_boxes_3d(c[i], c),
                                   rtol=0, atol=1e-12)
