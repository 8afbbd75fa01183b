"""K1's pair list at a capacity, on the CPU (the plain versions): the
capacity rule of the serving spec, ``slab_edge_max`` given a capacity
(its count logged, the plain version never cut), and the serving loop's
bookkeeping of a frame whose
count passed its capacity (recomputed on exact pair lists, counted in
``overflow_counters["k1_pairs"]``), with the count taken from the plain
walk or faked.  The card's side is in ``tests/test_torch_cuda.py``."""

import math

import numpy as np
import pytest
import torch

from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.graph import device_builder as db
from pointgnn_tpu_torch.infer import InferencePipeline
from pointgnn_tpu_torch.nn import slab
from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

NUM_POINTS, NUM_KEYPOINTS = 2048, 256


def _small_config():
    """Narrow widths and a 0.8 m keypoint voxel, so a small frame fits
    2048 points and 256 keypoints."""
    cfg = configs.model_config("Car", T=2)
    for level in cfg["runtime_graph_gen_kwargs"]["level_configs"]:
        level["graph_scale"] = 1.0
    for lc in cfg["model_kwargs"]["layer_configs"][:-1]:
        kw = lc["kwargs"]
        if "point_MLP_depth_list" in kw:
            kw["point_MLP_depth_list"] = [16, 24, 32]
            kw["output_MLP_depth_list"] = [32, 32]
        else:
            kw["auto_offset_MLP_depth_list"] = [16, 3]
            kw["edge_MLP_depth_list"] = [32, 32]
            kw["update_MLP_depth_list"] = [32, 32]
    return cfg


def _pipe(cfg, capacities=None, monkeypatch=None):
    if capacities is not None:
        monkeypatch.setattr(db, "k1_pair_capacities",
                            lambda spec: capacities)
    spec = db.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS)
    pipe = InferencePipeline(cfg, on_device_graph=True, device_spec=spec,
                             compute_dtype="float32", device="cpu", seed=3)
    # spread the class logits so some hypotheses pass the mask
    head = pipe.params["output"]["cls"][-1]
    head["w"] = head["w"] * 8.0
    return pipe


def _frames(n=3):
    return [synthetic_lidar_frame(seed=s, n_beams=16,
                                  points_per_beam=64)[0] for s in range(n)]


@pytest.mark.parametrize("name,T", [("Car", 3), ("Pedestrian_and_Cyclist", 3)])
def test_capacity_rule(name, T):
    """Four times the sources times the keypoints in a disc of the
    level's radius on one surface, capped at every (source, center) pair;
    at the benchmark's spec at least twice the most pairs its frames were
    measured to hold (car L0 0.63M, L1 2.23M; ped_cyl L0 0.32M, L1
    3.02M)."""
    cfg = configs.model_config(name, T=T)
    spec = db.spec_from_config(cfg, num_points=32768, num_keypoints=16384)
    cap0, cap1 = db.k1_pair_capacities(spec)
    v = spec.voxel_size
    want = [math.ceil(4 * n * math.pi * (lv.radius / v) ** 2)
            for n, lv in ((32768, spec.level0), (16384, spec.level1))]
    assert (cap0, cap1) == tuple(want)
    peak = {"Car": (628574, 2229705),
            "Pedestrian_and_Cyclist": (317622, 3018432)}[name]
    assert cap0 >= 2 * peak[0] and cap1 >= 2 * peak[1]
    # a tiny spec: never more than every pair
    tiny = spec._replace(num_points=16, num_keypoints=8)
    assert db.k1_pair_capacities(tiny) == (16 * 8, 8 * 8)


def _level_inputs(pipe, frame, level):
    packed = torch.from_numpy(db.pack_points(
        frame.xyz, frame.attr[:, :1], NUM_POINTS))
    graph = db.build_padded_graph(*db.unpack_points(packed),
                                  pipe.device_spec)
    lv = (pipe.device_spec.level0, pipe.device_spec.level1)[level]
    src = graph.vertex_xyz[level]
    src_mask = graph.vertex_mask[level] > 0
    ctr, ctr_mask = graph.vertex_xyz[1], graph.vertex_mask[1] > 0
    pad = torch.zeros((src.shape[0], 1))
    src4 = torch.where(src_mask[:, None], torch.cat([src, pad], 1),
                       torch.full((), 1e6))
    ctr4 = torch.where(ctr_mask[:, None],
                       torch.cat([ctr, torch.zeros((ctr.shape[0], 1))], 1),
                       torch.full((), -1e6))
    offsets, cells = ((graph.slab0_offsets, graph.slab0_center_cell)
                      if level == 0 else
                      (graph.slab_offsets, graph.slab_center_cell))
    return src4.contiguous(), ctr4.contiguous(), offsets, cells, lv


@pytest.mark.parametrize("level", [0, 1])
def test_slab_edge_max_logs_its_count_at_a_capacity(level):
    """A call with a capacity logs ``(count, capacity)`` into the
    innermost ``pair_counts`` block, the count its exact pair total; a
    call without one logs nothing; the output never changes.  A capacity
    with no block to log into raises, and so does a capacity for the
    plain pair list (which is never cut)."""
    pipe = _pipe(_small_config())
    src4, ctr4, offsets, cells, lv = _level_inputs(pipe, _frames(1)[0],
                                                   level)
    gen = torch.Generator().manual_seed(0)
    kw = dict(table_a=torch.randn(src4.shape[0], 8, generator=gen),
              src_xyz=src4, table_b=torch.randn(ctr4.shape[0], 8,
                                                generator=gen),
              ctr_xyz=ctr4, offsets=offsets, center_cell=cells,
              weights=[(torch.randn(8, 6, generator=gen),
                        torch.randn(6, generator=gen))],
              compute_dtype="float32", **db.slab_kernel_wiring(lv))
    want = slab.slab_edge_max(**kw)
    n = slab.inradius_pair_count(src4, ctr4, offsets, cells, kw["grid_g"],
                                 kw["radius"], kw["halo"])
    assert n > 100
    with pytest.raises(ValueError, match="pair_counts"):
        slab.slab_edge_max(**kw, pair_capacity=5)
    with slab.pair_counts() as log:
        assert torch.equal(slab.slab_edge_max(**kw, pair_capacity=5), want)
        assert torch.equal(slab.slab_edge_max(**kw), want)
        with slab.pair_counts() as inner:
            slab.slab_edge_max(**kw, pair_capacity=7)
    assert [(c.tolist(), cap) for c, cap in log] == [([n], 5)]
    assert [(c.tolist(), cap) for c, cap in inner] == [([n], 7)]
    with pytest.raises(ValueError, match="pair_capacity"):
        with slab.pair_counts():
            slab.slab_edge_max(**kw, pair_capacity=2.5)
    win = slab.column_row_windows(offsets, cells, kw["grid_g"], 32,
                                  kw["halo"])
    with pytest.raises(ValueError, match="capacity"):
        slab.pair_list(src4, ctr4, *win, 32, lv.radius, n + 1)


def test_exact_outputs_run_without_capacities():
    """A frame past a capacity is recomputed by a copy of the model whose
    K1 wiring lacks ``pair_capacity`` (every other key kept), so its
    calls log nothing and cannot be cut; the pipeline's own model keeps
    its capacities, and runs only inside ``pair_counts``."""
    pipe = _pipe(_small_config())
    p = _frames(1)[0]
    packed = torch.from_numpy(db.pack_points(p.xyz, p.attr[:, :1],
                                             NUM_POINTS))
    wirings = []
    apply = type(pipe.model).apply

    def recording(model, *a, **kw):
        wirings.append((model.slab_level0, model.slab_level1))
        return apply(model, *a, **kw)

    type(pipe.model).apply = recording
    try:
        with slab.pair_counts() as log:
            exact = pipe._exact_outputs(pipe.params, packed)
    finally:
        type(pipe.model).apply = apply
    assert log == [] and pipe.overflow_counters["k1_pairs"] == 1
    ((l0, l1),) = wirings
    for got, own in ((l0, pipe.model.slab_level0),
                     (l1, pipe.model.slab_level1)):
        assert "pair_capacity" in own and "pair_capacity" not in got
        assert got == {k: v for k, v in own.items() if k != "pair_capacity"}
    for a, b in zip(exact, pipe.device_fn(pipe.params, packed)):
        assert torch.equal(a, b)
    graph = db.build_padded_graph(*db.unpack_points(packed),
                                  pipe.device_spec)
    with pytest.raises(ValueError, match="pair_counts"):
        pipe.model.apply(pipe.params, graph)


def _same(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_counts_per_frame_and_no_overflow():
    """Each frame's K1 counts land in ``k1_counters`` (level 0, then
    level 1 per graph-net layer), under the spec's capacities."""
    cfg = _small_config()
    pipe = _pipe(cfg)
    frames = _frames()
    with pytest.warns(RuntimeWarning, match="keypoint overflow"):
        for p in frames:
            pipe.run_frame(p)
    c = pipe.k1_counters
    caps = db.k1_pair_capacities(pipe.device_spec)
    assert c["frames"] == 3
    assert [c["call%d_capacity" % i] for i in range(3)] == \
        [caps[0], caps[1], caps[1]]
    for i in range(3):
        assert 0 < c["call%d_peak" % i] <= c["call%d_capacity" % i]
        assert c["call%d_peak" % i] <= c["call%d_pairs" % i] \
            <= 3 * c["call%d_peak" % i]
    # both level-1 layers walk the same graph
    assert c["call1_pairs"] == c["call2_pairs"]
    assert pipe.overflow_counters["k1_pairs"] == 0


@pytest.mark.parametrize("loop", ["run_frame", "stream"])
def test_capacity_below_count_recomputes_exactly(loop, monkeypatch):
    """A capacity below a frame's level-1 pairs: every frame is computed
    again on exact pair lists, counted once per frame, with the
    detections of a pipeline whose capacities hold every frame."""
    cfg = _small_config()
    frames = _frames()
    want_pipe = _pipe(cfg)
    with pytest.warns(RuntimeWarning):
        want = [want_pipe.run_frame(p) for p in frames]
    low = (10 ** 9, min(want_pipe.k1_counters["call1_peak"] // 2,
                        min(want_pipe.k1_counters["call1_pairs"] // 6, 500)))
    pipe = _pipe(cfg, low, monkeypatch)
    calls = []
    exact = pipe._exact_outputs
    monkeypatch.setattr(pipe, "_exact_outputs",
                        lambda *a: calls.append(1) or exact(*a))
    with pytest.warns(RuntimeWarning):
        if loop == "stream":
            got = list(pipe.stream(iter(frames), depth=2))
        else:
            got = [pipe.run_frame(p) for p in frames]
    assert len(calls) == 3 and pipe.overflow_counters["k1_pairs"] == 3
    assert pipe.k1_counters["call1_capacity"] == low[1]
    for w, g in zip(want, got):
        _same(w, g)


def test_faked_count_over_capacity_redoes_one_frame(monkeypatch):
    """The card's count faked past its capacity on the second frame only:
    that frame alone is recomputed, and every frame's detections are the
    unfaked pipeline's."""
    cfg = _small_config()
    frames = _frames()
    ref = _pipe(cfg)
    with pytest.warns(RuntimeWarning):
        want = list(ref.stream(iter(frames)))
    pipe = _pipe(cfg)
    program = pipe._program
    seen = []

    def faked(params, packed):
        outs, k1 = program(params, packed)
        seen.append(1)
        if len(seen) == 2:
            counts, caps = k1
            k1 = (counts.clone().fill_(caps[1] + 1), caps)
        return outs, k1

    monkeypatch.setattr(pipe, "_program", faked)
    with pytest.warns(RuntimeWarning):
        got = list(pipe.stream(iter(frames)))
    assert pipe.overflow_counters["k1_pairs"] == 1
    for w, g in zip(want, got):
        _same(w, g)


def test_device_fn_leaves_its_counts_for_this_thread():
    """``device_fn`` returns the four outputs and leaves the call's K1
    counts for ``_take_k1``, once."""
    pipe = _pipe(_small_config())
    p = _frames(1)[0]
    packed = torch.from_numpy(db.pack_points(p.xyz, p.attr[:, :1],
                                             NUM_POINTS))
    outs = pipe.device_fn(pipe.params, packed)
    assert len(outs) == 4
    counts, caps = pipe._take_k1()
    assert counts.dtype == torch.int32 and counts.shape == (3,)
    assert len(caps) == 3 and (counts.numpy() > 0).all()
    assert pipe._take_k1() is None


def test_serving_spec_wires_capacities_into_the_model():
    cfg = _small_config()
    pipe = _pipe(cfg)
    caps = db.k1_pair_capacities(pipe.device_spec)
    assert pipe.model.slab_level0["pair_capacity"] == caps[0]
    assert pipe.model.slab_level1["pair_capacity"] == caps[1]
    assert np.all(np.array(caps) > 0)


def test_capture_tally_keeps_other_threads_launches():
    """Launches this thread makes inside ``capture_tally`` go to the tally
    (a captured graph adds them at each replay); another thread's
    launches meanwhile, as a second serving replica's, count at once."""
    import threading

    from pointgnn_tpu_torch.nn import cuda_build

    def kernel():
        pass

    kernel.launches = 0
    with cuda_build.capture_tally() as tally:
        cuda_build.count_launch(kernel)
        other = threading.Thread(target=cuda_build.count_launch,
                                 args=(kernel,))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
        cuda_build.count_launch(kernel)
    assert tally == {kernel: 2} and kernel.launches == 1
    cuda_build.count_launch(kernel)
    assert kernel.launches == 2
