"""Tests of the port that need the card: the CUDA kernels (slab_edge_max,
its backward, edge_tail_max and fused_edge_max) against their plain
PyTorch versions, the launch counts of the slab, edge-list and "l1"
serving paths and of a train step, ``stream`` against ``run_frame``, and
the host-graph program on the card against the CPU.  They import no JAX,
so on a
machine without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

and here, without a card, they skip.
"""

import numpy as np
import pytest
import torch

from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.data.labels import LABEL_MAP_CAR
from pointgnn_tpu_torch.graph import device_builder as db
from pointgnn_tpu_torch.graph import device_labels as dl
from pointgnn_tpu_torch import infer
from pointgnn_tpu_torch.infer import InferencePipeline
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.nn import edge_tail, slab
from pointgnn_tpu_torch.parallel import step as step_lib
from pointgnn_tpu_torch.train import device_pipeline as dpipe
from pointgnn_tpu_torch.train import optimizers
from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

pytestmark = pytest.mark.cuda

NUM_POINTS, NUM_KEYPOINTS = 4096, 2048

# f32: the kernel's sums run in another order than cuBLAS's, a few f32
# ulps.  bf16: such a difference can flip one bf16 rounding of a hidden
# activation (2^-8 relative) that later layers carry on.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _graph(device):
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS
    )._replace(slab_level0=True, slab_level1=True)
    pts, _ = synthetic_lidar_frame(seed=0, n_beams=32, points_per_beam=160)
    packed = torch.from_numpy(
        db.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    ).to(device)
    return spec, db.build_padded_graph(*db.unpack_points(packed), spec)


def _call(graph, spec, level, widths, device):
    gen = torch.Generator(device=device).manual_seed(level)
    if level == 0:
        src, smask = graph.vertex_xyz[0], graph.vertex_mask[0]
        offsets, cells, lvl = graph.slab0_offsets, graph.slab0_center_cell, \
            spec.level0
    else:
        src, smask = graph.vertex_xyz[1], graph.vertex_mask[1]
        offsets, cells, lvl = graph.slab_offsets, graph.slab_center_cell, \
            spec.level1
    ctr, cmask = graph.vertex_xyz[1], graph.vertex_mask[1]

    def xyz4(xyz, mask, sentinel):
        x4 = torch.cat([xyz, torch.zeros_like(xyz[:, :1])], 1)
        return torch.where(mask[:, None] > 0, x4,
                           torch.full((), sentinel, device=device))

    tail = [
        (torch.randn(i, o, generator=gen, device=device) / i ** 0.5,
         0.1 * torch.randn(o, generator=gen, device=device))
        for i, o in zip(widths[:-1], widths[1:])
    ]
    return dict(
        table_a=torch.randn(src.shape[0], widths[0], generator=gen,
                            device=device),
        src_xyz=xyz4(src, smask, 1e6).contiguous(),
        table_b=torch.randn(ctr.shape[0], widths[0], generator=gen,
                            device=device),
        ctr_xyz=xyz4(ctr, cmask, -1e6).contiguous(),
        offsets=offsets, center_cell=cells, weights=tail,
        **db.slab_kernel_wiring(lvl),
    )


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level,widths", [
    (0, [32, 64, 128, 300]), (1, [300, 300]), (1, [36, 20]),
])
def test_kernel_matches_plain_version(cuda, level, widths, compute_dtype):
    spec, graph = _graph(cuda)
    kw = dict(_call(graph, spec, level, widths, cuda),
              compute_dtype=compute_dtype)
    before = slab.slab_edge_max.launches
    out = slab.slab_edge_max(**kw)
    torch.cuda.synchronize()
    assert slab.slab_edge_max.launches == before + 1
    ref = slab.slab_edge_max_reference(**kw)
    assert out.shape == ref.shape
    rel = ((out - ref).abs() / (1 + ref.abs())).max().item()
    assert rel <= TOL[compute_dtype], rel
    assert (out.abs().sum(1) > 0).sum() > 0


def test_kernel_rejects_cpu_mixed_inputs(cuda):
    spec, graph = _graph(cuda)
    kw = _call(graph, spec, 1, [32, 32], cuda)
    kw["table_b"] = kw["table_b"].cpu()
    with pytest.raises(ValueError, match="on cuda"):
        slab.slab_edge_max(**kw)


def test_serving_launches_once_per_slab_layer(cuda):
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS)
    pipe = InferencePipeline(cfg, on_device_graph=True, device_spec=spec,
                             device=cuda)
    pts, _ = synthetic_lidar_frame(seed=1, n_beams=32, points_per_beam=160)
    before = slab.slab_edge_max.launches
    cls, boxes, scores, _ = pipe.run_frame(pts)
    assert slab.slab_edge_max.launches == before + 3  # 1 x L0 + T x L1
    assert np.isfinite(boxes).all() and boxes.shape[1:] == (7,)


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_on_the_card_equals_run_frame(cuda, depth):
    """stream's worker-packed frames and asynchronous read-back give
    run_frame's detections bit for bit (4 frames, the worker 1 or 3
    frames ahead)."""
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS)
    pipe = InferencePipeline(cfg, on_device_graph=True, device_spec=spec,
                             device=cuda)
    frames = [synthetic_lidar_frame(seed=s, n_beams=32,
                                    points_per_beam=160)[0]
              for s in range(4)]
    want = [pipe.run_frame(p) for p in frames]
    before = slab.slab_edge_max.launches
    got = list(pipe.stream(iter(frames), depth=depth))
    assert slab.slab_edge_max.launches == before + 3 * len(frames)
    assert len(got) == len(frames)
    assert sum(len(w[0]) for w in want) > 0
    for w, g in zip(want, got):
        for a, b in zip(w[:3], g[:3]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# K1 at a capacity (no host sync) and the device program as a CUDA graph
# ---------------------------------------------------------------------------

# frames of different sizes: (seed, points per beam)
SIZES = [(s, ppb) for s, ppb in zip(range(8), (60, 200, 90, 160, 40, 120,
                                                180, 75))]


def _frame(seed, ppb):
    return synthetic_lidar_frame(seed=seed, n_beams=32,
                                 points_per_beam=ppb)[0]


def _sized_graph(device, seed, ppb):
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS
    )._replace(slab_level0=True, slab_level1=True)
    pts = _frame(seed, ppb)
    packed = torch.from_numpy(
        db.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    ).to(device)
    return spec, db.build_padded_graph(*db.unpack_points(packed), spec)


@pytest.mark.parametrize("level", [0, 1])
def test_capacity_pair_list_equals_exact_one(cuda, level):
    """At a capacity the pair list keeps its count on the card:
    ``row_ptr`` equals the syncing list's bitwise, and so do its pairs up
    to the count, or up to a capacity below it."""
    for seed, ppb in SIZES[:4]:
        spec, graph = _sized_graph(cuda, seed, ppb)
        kw = _call(graph, spec, level, [16, 16], cuda)
        win = slab.column_row_windows(kw["offsets"], kw["center_cell"],
                                      kw["grid_g"], 32, kw["halo"])
        args = (kw["src_xyz"], kw["ctr_xyz"], *win, 32, kw["radius"])
        row_ptr, pk, pj = slab.pair_list(*args)
        n = pk.numel()
        assert n > 0 and int(row_ptr[-1]) == n
        for cap in (n + 1000, n, n // 2):
            r, k, j = slab.pair_list(*args, capacity=cap)
            m = min(n, cap)
            assert k.numel() == j.numel() == cap
            assert torch.equal(r, row_ptr)
            assert torch.equal(k[:m], pk[:m]) and torch.equal(j[:m], pj[:m])


@pytest.mark.parametrize("level,widths", [(0, [32, 64, 128, 300]),
                                          (1, [300, 300])])
def test_capacity_kernel_output_bitwise(cuda, level, widths):
    """K1 inside ``pair_counts`` (its list at a capacity, its count read
    on the card) equals the syncing K1 bitwise on 8 frames of different
    sizes, and logs the exact count."""
    for seed, ppb in SIZES:
        spec, graph = _sized_graph(cuda, seed, ppb)
        kw = dict(_call(graph, spec, level, widths, cuda),
                  compute_dtype="bfloat16")
        want = slab.slab_edge_max(**kw)
        cap = db.k1_pair_capacities(spec)[level]
        with slab.pair_counts() as log:
            got = slab.slab_edge_max(**kw, pair_capacity=cap)
        n = slab.inradius_pair_count(
            kw["src_xyz"], kw["ctr_xyz"], kw["offsets"], kw["center_cell"],
            kw["grid_g"], kw["radius"], kw["halo"])
        assert [(c.item(), c_cap) for c, c_cap in log] == [(n, cap)]
        assert n <= cap
        assert torch.equal(got, want), (seed, ppb)


def _car_pipe(cuda, slab_mode=True, params=None):
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS)
    return InferencePipeline(cfg, on_device_graph=True, device_spec=spec,
                             device=cuda, slab=slab_mode, params=params)


def _packed(pipe, p, device):
    return torch.from_numpy(db.pack_points(
        p.xyz, p.attr[:, :1], pipe.device_spec.num_points)).to(device)


@pytest.mark.parametrize("slab_mode", [True, "l1", False])
def test_device_fn_has_no_host_sync(cuda, slab_mode):
    """The device program (slab, ``"l1"`` and edge lists) and its graph
    replay run under ``set_sync_debug_mode("error")``."""
    pipe = _car_pipe(cuda, slab_mode)
    packed = _packed(pipe, _frame(1, 160), cuda)
    for _ in range(2):  # the eager first call, then the capture
        pipe.device_fn(pipe.params, packed)
    torch.cuda.synchronize()
    assert any(isinstance(r, infer._GraphedProgram)
               for r in pipe._graphs.values())
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            pipe._program(pipe.params, packed)
        pipe.device_fn(pipe.params, packed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_graph_replay_equals_eager_program(cuda):
    """The replayed graph gives the eager program's outputs and K1 counts
    bitwise over 8 frames of different sizes, and its replays count 3 K1
    launches each."""
    pipe = _car_pipe(cuda)
    checked = 0
    for seed, ppb in SIZES + SIZES[:2]:
        packed = _packed(pipe, _frame(seed, ppb), cuda)
        before = slab.slab_edge_max.launches
        got = pipe.device_fn(pipe.params, packed)
        k1 = pipe._take_k1()
        assert slab.slab_edge_max.launches == before + 3
        with torch.inference_mode():
            want, want_k1 = pipe._program(pipe.params, packed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (seed, ppb)
        assert torch.equal(k1[0], want_k1[0]) and k1[1] == want_k1[1]
        checked += isinstance(pipe._graphs[(str(packed.device),
                                            id(pipe.params))],
                              infer._GraphedProgram)
    assert checked == len(SIZES) + 1  # every call after the first


def test_capacity_below_count_recomputes_on_the_card(cuda, monkeypatch):
    """A level-1 capacity below every frame's pairs: each frame's count
    comes back past it, the frame is computed again on exact pair lists
    and counted once, and the detections are bitwise those of a pipeline
    whose capacities hold every frame, through run_frame and stream."""
    frames = [_frame(s, ppb) for s, ppb in SIZES[:4]]
    base = _car_pipe(cuda)
    want = [base.run_frame(p) for p in frames]
    assert sum(len(w[0]) for w in want) > 0
    assert base.overflow_counters["k1_pairs"] == 0
    low = min(base.k1_counters["call1_peak"] // 4, 2000)
    monkeypatch.setattr(db, "k1_pair_capacities",
                        lambda spec: (10 ** 8, low))
    for loop in ("run_frame", "stream"):
        pipe = _car_pipe(cuda, params=base.params)
        if loop == "stream":
            got = list(pipe.stream(iter(frames), depth=2))
        else:
            got = [pipe.run_frame(p) for p in frames]
        assert pipe.overflow_counters["k1_pairs"] == len(frames), loop
        for w, g in zip(want, got):
            for a, b in zip(w[:3], g[:3]):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_stream_equals_run_frame_over_frame_sizes(cuda):
    """``stream`` (graph replays running a frame ahead of the host) yields
    ``run_frame``'s detections frame by frame on frames of different
    sizes, with no K1 overflow."""
    frames = [_frame(s, ppb) for s, ppb in SIZES]
    ref = _car_pipe(cuda)
    want = [ref.run_frame(p) for p in frames]
    pipe = _car_pipe(cuda, params=ref.params)
    got = list(pipe.stream(iter(frames), depth=2))
    assert len(got) == len(frames)
    for w, g in zip(want, got):
        for a, b in zip(w[:3], g[:3]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert pipe.overflow_counters["k1_pairs"] == 0
    assert pipe.k1_counters["frames"] == len(frames)


# The backward kernel sums the same f32 products as the plain version in
# another order (and the plain version's dW is a cuBLAS product), a few
# ulps of sums over up to a few hundred pairs; the winners agree because
# the kernel's recompute equals the forward kernel bit for bit and the
# plain version recomputes its own forward.
BWD_TOL = 1e-4


@pytest.mark.parametrize("level,widths", [
    (0, [32, 64, 128, 300]), (1, [300, 300]), (1, [36, 20]),
])
def test_backward_kernel_matches_plain_version(cuda, level, widths):
    torch.backends.cuda.matmul.allow_tf32 = False
    spec, graph = _graph(cuda)
    kw = dict(_call(graph, spec, level, widths, cuda),
              compute_dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(5)
    out = slab.slab_edge_max(**kw)
    g = torch.randn(out.shape, generator=gen, device=cuda)
    before = slab.slab_edge_max_backward.launches
    got = slab.slab_edge_max_backward(**kw, out=out, g=g)
    again = slab.slab_edge_max_backward(**kw, out=out, g=g)
    torch.cuda.synchronize()
    assert slab.slab_edge_max_backward.launches == before + 2
    ref_out = slab.slab_edge_max_reference(**kw)
    ref = slab.slab_edge_max_backward_reference(**kw, out=ref_out, g=g)
    flat = lambda r: [r[0], r[1]] + [t for wb in r[2] for t in wb]  # noqa
    for x, y, z in zip(flat(got), flat(again), flat(ref)):
        assert x.shape == z.shape
        assert torch.equal(x, y)  # no atomics: bitwise reproducible
        err = (x - z).abs().max().item()
        assert err <= BWD_TOL * (1 + z.abs().max().item()), err
    assert got[0].abs().sum() > 0 and got[1].abs().sum() > 0


def test_train_step_launches_both_kernels(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("car_auto_T1_train")
    spec = db.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS, runtime=False)
    dspec, extra = dpipe.resolve_device_setup(cfg, spec)
    model = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                     **extra, **cfg["model_kwargs"])
    params = model.init(seed=0, input_dim=1, device=cuda)
    for t in optimizers.param_leaves(params):
        t.requires_grad_(True)
    opt, _ = optimizers.build_from_train_config(
        configs.get_train_config("car_auto_T1_train"))
    state = step_lib.init_train_state(params, opt)
    step = step_lib.make_train_step(
        model, opt, loss_config(cfg), with_metrics=True,
        graph_builder=dpipe.make_graph_builder(
            dspec, model.output_graph_level, cfg),
        graph_rng_seed=0, frames_per_device=2,
    )
    frames = []
    for seed in (0, 1):
        pts, labels = synthetic_lidar_frame(seed=seed, n_beams=32,
                                            points_per_beam=160)
        frames.append(dpipe.DeviceFrame(
            db.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS),
            dl.pack_frame_labels(labels, LABEL_MAP_CAR, 4),
        ))
    batch = dpipe.frames_to_device(dpipe.stack_frames(frames), cuda)
    k1, k2 = slab.slab_edge_max.launches, slab.slab_edge_max_backward.launches
    state, aux = step(state, batch)
    torch.cuda.synchronize()
    # 2 frames x (1 level-0 + T level-1 layers), forward and backward
    assert slab.slab_edge_max.launches == k1 + 4
    assert slab.slab_edge_max_backward.launches == k2 + 4
    assert np.isfinite(float(aux["total_loss"]))


def test_backward_kernel_gives_tied_winners_full_cotangent(cuda):
    """Two candidate rows with the same coordinates and table row tie
    exactly wherever one wins a channel: the kernel, like its plain
    version, gives both the full cotangent."""
    spec, graph = _graph(cuda)
    kw = dict(_call(graph, spec, 1, [300, 300], cuda),
              compute_dtype="float32")
    offsets = kw["offsets"].long()
    counts = offsets[1:] - offsets[:-1]
    # the first row of the fullest cell and its neighbour in that cell
    j = int(offsets[:-1][torch.argmax(counts)])
    src, table_a = kw["src_xyz"].clone(), kw["table_a"].clone()
    src[j + 1] = src[j]
    table_a[j] += 3.0
    table_a[j + 1] = table_a[j]
    kw.update(src_xyz=src, table_a=table_a)
    out = slab.slab_edge_max(**kw)
    g = torch.ones_like(out)
    d_a, d_b, d_w = slab.slab_edge_max_backward(**kw, out=out, g=g)
    ref_out = slab.slab_edge_max_reference(**kw)
    ref = slab.slab_edge_max_backward_reference(**kw, out=ref_out, g=g)
    torch.cuda.synchronize()
    assert d_a[j].abs().sum() > 0
    assert torch.equal(d_a[j], d_a[j + 1])
    for x, z in zip([d_a, d_b, d_w[0][0], d_w[0][1]],
                    [ref[0], ref[1], ref[2][0][0], ref[2][0][1]]):
        err = (x - z).abs().max().item()
        assert err <= BWD_TOL * (1 + z.abs().max().item()), err


# ---------------------------------------------------------------------------
# the skewed frame of tests/test_torch_slab_chunks.py (one center with
# several hundred neighbours): the pair list, K1 and K2 on the card
# ---------------------------------------------------------------------------

def _skewed(device, level, widths, tie=False):
    from test_torch_slab_chunks import skewed_case

    kw = skewed_case(30 + level, widths, level, tie=tie)
    return {key: (v.to(device) if torch.is_tensor(v) else
                  [(w.to(device), b.to(device)) for w, b in v]
                  if key == "weights" else v) for key, v in kw.items()}


SKEWED = [(0, [16, 16, 24, 32]), (1, [32, 32]), (0, [32, 64, 128, 300]),
          (1, [300, 300])]


@pytest.mark.parametrize("level,widths", SKEWED)
def test_skewed_pair_list_matches_plain_enumeration(cuda, level, widths):
    kw = _skewed(cuda, level, widths)
    win_lo, win_hi = slab.column_row_windows(
        kw["offsets"], kw["center_cell"], kw["grid_g"], kw["block_centers"], 1)
    args = (kw["src_xyz"], kw["ctr_xyz"], win_lo, win_hi,
            kw["block_centers"], kw["radius"])
    got = slab.pair_list(*args)
    again = slab.pair_list(*args)
    ref = slab.pair_list_reference(*[a.cpu() if torch.is_tensor(a) else a
                                     for a in args])
    for x, y, z in zip(got, again, ref):
        assert torch.equal(x, y)  # the same order on every run
        assert torch.equal(x.cpu(), z)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level,widths", SKEWED)
def test_skewed_kernel_matches_plain_version(cuda, level, widths,
                                             compute_dtype):
    kw = dict(_skewed(cuda, level, widths), compute_dtype=compute_dtype)
    out = slab.slab_edge_max(**kw)
    again = slab.slab_edge_max(**kw)
    torch.cuda.synchronize()
    ref = slab.slab_edge_max_reference(**kw)
    assert torch.equal(out, again)
    rel = ((out - ref).abs() / (1 + ref.abs())).max().item()
    assert rel <= TOL[compute_dtype], rel
    assert torch.equal(out == 0, ref == 0) or compute_dtype == "bfloat16"


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level,widths", SKEWED)
def test_skewed_kernel_block_centers_bitwise(cuda, level, widths,
                                             compute_dtype):
    """``block_centers`` only sets the pair kernel's windows: the pair
    list and the outputs are bitwise the same at 16, 32 and 64."""
    kw = dict(_skewed(cuda, level, widths), compute_dtype=compute_dtype)
    outs, pairs = {}, {}
    for bk in (16, 32, 64):
        outs[bk] = slab.slab_edge_max(**dict(kw, block_centers=bk))
        win_lo, win_hi = slab.column_row_windows(
            kw["offsets"], kw["center_cell"], kw["grid_g"], bk, 1)
        pairs[bk] = slab.pair_list(kw["src_xyz"], kw["ctr_xyz"], win_lo,
                                   win_hi, bk, kw["radius"])
    for bk in (16, 64):
        assert torch.equal(outs[bk], outs[32]), bk
        for x, y in zip(pairs[bk], pairs[32]):
            assert torch.equal(x, y), bk


def test_slab_tuning_detections_bitwise(cuda):
    """``InferencePipeline(slab_tuning=...)``: 3 launches a frame and the
    default's detections bit for bit, flat and per level."""
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS)
    base = InferencePipeline(cfg, on_device_graph=True, device_spec=spec,
                             device=cuda)
    frames = [synthetic_lidar_frame(seed=s, n_beams=32,
                                    points_per_beam=160)[0]
              for s in range(2)]
    want = [base.run_frame(p) for p in frames]
    assert sum(len(w[0]) for w in want) > 0
    for tuning in ({"block_centers": 16}, {"block_centers": 64},
                   {"level0": {"block_centers": 8},
                    "level1": {"block_centers": 128}}):
        pipe = InferencePipeline(cfg, params=base.params,
                                 on_device_graph=True, device_spec=spec,
                                 device=cuda, slab_tuning=tuning)
        before = slab.slab_edge_max.launches
        got = [pipe.run_frame(p) for p in frames]
        assert slab.slab_edge_max.launches == before + 3 * len(frames)
        for w, g in zip(want, got):
            for a, b in zip(w[:3], g[:3]):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("level,widths", SKEWED)
def test_skewed_backward_kernel_matches_plain_version(cuda, level, widths,
                                                      tie):
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(_skewed(cuda, level, widths, tie=tie), compute_dtype="float32")
    out = slab.slab_edge_max(**kw)
    g = torch.randn(out.shape, generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda)
    got = slab.slab_edge_max_backward(**kw, out=out, g=g)
    again = slab.slab_edge_max_backward(**kw, out=out, g=g)
    torch.cuda.synchronize()
    ref_out = slab.slab_edge_max_reference(**kw)
    ref = slab.slab_edge_max_backward_reference(**kw, out=ref_out, g=g)
    flat = lambda r: [r[0], r[1]] + [t for wb in r[2] for t in wb]  # noqa
    for x, y, z in zip(flat(got), flat(again), flat(ref)):
        assert torch.equal(x, y)  # no float atomics: bitwise reproducible
        err = (x - z).abs().max().item()
        assert err <= BWD_TOL * (1 + z.abs().max().item()), err
    # with g = 1 the last bias gradient counts each channel's winners
    ones = slab.slab_edge_max_backward(**kw, out=out, g=torch.ones_like(out))
    db_last = ones[2][-1][1]
    assert bool((db_last >= (out > 0).sum(0).to(torch.float32)).all())


# ---------------------------------------------------------------------------
# the edge-list tail: K3 (edge_tail_max) and K4 (fused_edge_max)
# ---------------------------------------------------------------------------


def _edge_graph(device):
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS,
        per_center_caps=(16, 64),
    )
    pts, _ = synthetic_lidar_frame(seed=0, n_beams=32, points_per_beam=160)
    packed = torch.from_numpy(
        db.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    ).to(device)
    return db.build_padded_graph(*db.unpack_points(packed), spec)


def _tail_call(graph, level, widths, dtype, device):
    """K3 and K4 arguments on the graph's level-``level`` edge list, with
    random tables and chain in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(10 + level)
    n = graph.vertex_xyz[level].shape[0]
    k = graph.vertex_xyz[1].shape[0]
    src = graph.edges_src[level].reshape(k, -1)
    a = torch.randn(n, widths[0], generator=gen, device=device).to(dtype)
    b = torch.randn(k, widths[0], generator=gen, device=device).to(dtype)
    tail = [
        ((torch.randn(i, o, generator=gen, device=device) / i ** 0.5)
         .to(dtype), (0.1 * torch.randn(o, generator=gen, device=device))
         .to(dtype))
        for i, o in zip(widths[:-1], widths[1:])
    ]
    valid = (src < n).to(torch.float32).contiguous()
    gathered = a.index_select(
        0, torch.clamp(src.reshape(-1).long(), max=n - 1)).contiguous()
    return (dict(gathered=gathered, table_b=b, slot_valid=valid,
                 weights=tail),
            dict(table_a=a, table_b=b, edges_src=src.contiguous(),
                 slot_valid=valid, weights=tail))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level,widths", [
    (0, [32, 64, 128, 300]), (1, [300, 300]), (1, [36, 20]), (1, [40]),
])
def test_edge_tail_kernels_match_plain_version(cuda, level, widths,
                                               compute_dtype):
    graph = _edge_graph(cuda)
    k3, k4 = _tail_call(graph, level, widths,
                        getattr(torch, compute_dtype), cuda)
    assert (k3["slot_valid"] == 0).any() and (k3["slot_valid"] > 0).any()
    before = (edge_tail.edge_tail_max.launches,
              edge_tail.fused_edge_max.launches)
    out3 = edge_tail.edge_tail_max(**k3)
    out4 = edge_tail.fused_edge_max(**k4)
    torch.cuda.synchronize()
    assert (edge_tail.edge_tail_max.launches,
            edge_tail.fused_edge_max.launches) == (before[0] + 1,
                                                   before[1] + 1)
    ref = edge_tail.edge_tail_max_reference(**k3)
    assert torch.equal(ref, edge_tail.fused_edge_max_reference(**k4))
    for out in (out3, out4):
        assert out.shape == ref.shape
        rel = ((out - ref).abs() / (1 + ref.abs())).max().item()
        assert rel <= TOL[compute_dtype], rel
    # one chain per slot in a fixed order: the gather's place changes
    # nothing
    assert torch.equal(out3, out4)
    assert (out3.abs().sum(1) > 0).sum() > 0
    # centers with no valid slot get 0
    empty = k3["slot_valid"].sum(1) == 0
    assert (out3[empty] == 0).all()


def test_edge_tail_rejects_cpu_mixed_inputs(cuda):
    graph = _edge_graph(cuda)
    k3, k4 = _tail_call(graph, 1, [32, 32], torch.bfloat16, cuda)
    k3["slot_valid"] = k3["slot_valid"].cpu()
    with pytest.raises(ValueError, match="on cuda"):
        edge_tail.edge_tail_max(**k3)
    k4["edges_src"] = k4["edges_src"].long()
    with pytest.raises(ValueError, match="int32"):
        edge_tail.fused_edge_max(**k4)


@pytest.mark.parametrize("mode,k4_per_frame,k1_per_frame", [
    (False, 3, 0), ("l1", 1, 2),
])
def test_edge_serving_launch_counts(cuda, mode, k4_per_frame,
                                    k1_per_frame):
    """The edge-list layers run K4 (the gather inside the kernel), not
    the gather and K3."""
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS,
                               per_center_caps=(16, 64))
    pipe = InferencePipeline(cfg, on_device_graph=True, device_spec=spec,
                             device=cuda, slab=mode)
    pts, _ = synthetic_lidar_frame(seed=1, n_beams=32, points_per_beam=160)
    k1, k3, k4 = (slab.slab_edge_max.launches,
                  edge_tail.edge_tail_max.launches,
                  edge_tail.fused_edge_max.launches)
    cls, boxes, scores, _ = pipe.run_frame(pts)
    # T = 2: one level-0 layer and two level-1 layers
    assert edge_tail.fused_edge_max.launches == k4 + k4_per_frame
    assert slab.slab_edge_max.launches == k1 + k1_per_frame
    assert edge_tail.edge_tail_max.launches == k3
    assert np.isfinite(boxes).all() and boxes.shape[1:] == (7,)


# the edge-list tail's work plan on the card: valid-slot patterns of
# tests/test_torch_edge_tail_chunks.py (front-packed, holes, none valid;
# a center with every slot valid, one with none)


def _tail_case_on(cuda, pattern, chain, compute_dtype, seed=3):
    from test_torch_edge_tail_chunks import CHAINS, tail_case

    h, widths = CHAINS[chain]
    k3, k4 = tail_case(seed, pattern, h, widths, compute_dtype=compute_dtype)

    def move(kw):
        return {key: ([tuple(t.to(cuda) for t in wb) for wb in val]
                      if key == "weights" else val.to(cuda).contiguous())
                for key, val in kw.items()}

    return move(k3), move(k4)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain", ["car_l0", "car_l1", "odd"])
@pytest.mark.parametrize("pattern", ["front_packed", "holes",
                                     "all_invalid"])
def test_edge_tail_kernels_on_slot_patterns(cuda, pattern, chain,
                                            compute_dtype):
    k3, k4 = _tail_case_on(cuda, pattern, chain, compute_dtype)
    out3 = edge_tail.edge_tail_max(**k3)
    out4 = edge_tail.fused_edge_max(**k4)
    again = edge_tail.edge_tail_max(**k3)
    torch.cuda.synchronize()
    ref = edge_tail.edge_tail_max_reference(**k3)
    assert torch.equal(ref, edge_tail.fused_edge_max_reference(**k4))
    for out in (out3, out4):
        assert out.shape == ref.shape
        rel = ((out - ref).abs() / (1 + ref.abs())).max().item()
        assert rel <= TOL[compute_dtype], rel
    # one chain per pair in a fixed order: K4 is K3, and runs repeat
    assert torch.equal(out3, out4)
    assert torch.equal(out3, again)
    empty = k3["slot_valid"].sum(1) == 0
    assert (out3[empty] == 0).all()
    if pattern == "all_invalid":
        assert (out3 == 0).all()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["odd_width", "unaligned_rows"])
def test_edge_tail_kernels_with_scalar_row_loads(cuda, case, compute_dtype):
    """Rows the kernels cannot read 4 values a load: a width that is not a
    multiple of 4, or tables whose rows start off an 8-byte boundary (a
    contiguous view one value into its storage)."""
    chain = "odd" if case == "odd_width" else "car_l0"
    k3, k4 = _tail_case_on(cuda, "holes", chain, compute_dtype)
    if case == "unaligned_rows":
        def shifted(t):
            flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
            return flat[1:].view(t.shape)

        k3["gathered"] = shifted(k3["gathered"])
        k3["table_b"] = k4["table_b"] = shifted(k3["table_b"])
        k4["table_a"] = shifted(k4["table_a"])
        assert k3["table_b"].data_ptr() % 8 != 0
    out3 = edge_tail.edge_tail_max(**k3)
    out4 = edge_tail.fused_edge_max(**k4)
    torch.cuda.synchronize()
    ref = edge_tail.edge_tail_max_reference(**k3)
    rel = ((out3 - ref).abs() / (1 + ref.abs())).max().item()
    assert rel <= TOL[compute_dtype], rel
    assert torch.equal(out3, out4)


@pytest.mark.parametrize("pattern", ["front_packed", "holes",
                                     "all_invalid"])
def test_edge_tail_signed_empty_chain(cuda, pattern):
    """No chain and no first ReLU: the outputs are rnd(row - B), signed;
    every step is elementwise, so the kernels equal the plain version
    bitwise, negative maxima included, and empty centers get 0."""
    k3, k4 = _tail_case_on(cuda, pattern, "empty", "bfloat16", seed=4)
    out3 = edge_tail.edge_tail_max(**k3, apply_act_first=False)
    out4 = edge_tail.fused_edge_max(**k4, apply_act_first=False)
    torch.cuda.synchronize()
    ref = edge_tail.edge_tail_max_reference(**k3, apply_act_first=False)
    assert torch.equal(out3, ref) and torch.equal(out4, ref)
    empty = k3["slot_valid"].sum(1) == 0
    assert (out3[empty] == 0).all()
    if pattern != "all_invalid":
        assert (out3[~empty] < 0).any()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("pattern", ["front_packed", "holes",
                                     "all_invalid"])
def test_edge_tail_pair_list_kernel_matches_plain(cuda, pattern, fused):
    k3, k4 = _tail_case_on(cuda, pattern, "car_l1", "bfloat16")
    args = (k3["slot_valid"], k4["edges_src"] if fused else None,
            k4["table_a"].shape[0])
    got = edge_tail.tail_pair_list(*args)
    again = edge_tail.tail_pair_list(*args)
    want = edge_tail.tail_pair_list_reference(*args)
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_edge_tail_on_the_device_builders_edge_list(cuda):
    """K3 and K4 on a real capped edge list (front-packed valid slots),
    with the car level-0 chain in bf16: the kernel-built pair list is the
    plain one, and K4 equals K3."""
    graph = _edge_graph(cuda)
    k3, k4 = _tail_call(graph, 0, [32, 64, 128, 300], torch.bfloat16, cuda)
    n = k4["table_a"].shape[0]
    for edges in (None, k4["edges_src"]):
        got = edge_tail.tail_pair_list(k3["slot_valid"], edges, n)
        want = edge_tail.tail_pair_list_reference(k3["slot_valid"], edges, n)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    out3 = edge_tail.edge_tail_max(**k3)
    out4 = edge_tail.fused_edge_max(**k4)
    torch.cuda.synchronize()
    ref = edge_tail.edge_tail_max_reference(**k3)
    assert torch.equal(out3, out4)
    rel = ((out3 - ref).abs() / (1 + ref.abs())).max().item()
    assert rel <= TOL["bfloat16"], rel


def test_host_graph_frame_on_the_card_equals_cpu(cuda):
    """The host-graph path (``on_device_graph=False``): one graph built
    once on the host and fed to the card and the CPU, f32 (car T=2 at full
    width): probabilities and decoded boxes within 1e-3 relative; then
    ``run_frame`` on the card launches no kernel."""
    from pointgnn_tpu_torch.graph import pad
    from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy

    cfg = configs.model_config("Car", T=2)
    cap = pad.GraphCapacity((NUM_POINTS, 4096, 4096), (65536, 262144))
    card = InferencePipeline(cfg, capacity=cap, device=cuda)
    cpu = InferencePipeline(
        cfg, params=params_from_jax(params_to_numpy(card.params), "cpu"),
        capacity=cap, device="cpu")
    assert not card.on_device_graph and card.compute_dtype is None
    pts, _ = synthetic_lidar_frame(seed=1, n_beams=32, points_per_beam=160)
    pts = pts.mask(np.arange(NUM_POINTS))
    graph = cpu.host_graph(pts, np.random.default_rng(0))
    outs = [[t.cpu().numpy() for t in p.host_graph_fn(
        p.params, pad.to_device(graph, p.device))] for p in (card, cpu)]
    for got, want in zip(*outs):
        assert np.isfinite(got).all()
        err = np.abs(got - want) / (1.0 + np.abs(want))
        assert err.max() <= 1e-3, err.max()
    counts = [fn.launches for fn in (slab.slab_edge_max,
                                     slab.slab_edge_max_backward,
                                     edge_tail.edge_tail_max,
                                     edge_tail.fused_edge_max)]
    cls, boxes, scores, _ = card.run_frame(pts, np.random.default_rng(0))
    assert np.isfinite(boxes).all() and boxes.shape[1:] == (7,)
    assert counts == [fn.launches for fn in (slab.slab_edge_max,
                                             slab.slab_edge_max_backward,
                                             edge_tail.edge_tail_max,
                                             edge_tail.fused_edge_max)]


def _launch_counts():
    return [fn.launches for fn in (slab.slab_edge_max,
                                   slab.slab_edge_max_backward,
                                   edge_tail.edge_tail_max,
                                   edge_tail.fused_edge_max)]


def _grads_on(model, params, loss_of):
    """Loss and every parameter gradient (leaves that take one) of
    ``loss_of(params)``, on the CPU."""
    from pointgnn_tpu_torch.nn import mlp

    for key, t in mlp.named_leaves(params):
        t.requires_grad_(key not in mlp.EMA_KEYS)
    total = loss_of(params)
    total.backward()
    return float(total.detach()), [
        torch.zeros(t.shape) if t.grad is None else t.grad.cpu()
        for key, t in mlp.named_leaves(params) if key not in mlp.EMA_KEYS]


def _assert_grads_close(card, cpu, loss_tol=1e-5, grad_tol=1e-3):
    assert np.isfinite(card[0])
    np.testing.assert_allclose(card[0], cpu[0], rtol=loss_tol)
    for g, w in zip(card[1], cpu[1]):
        assert torch.isfinite(g).all()
        scale = 1.0 + w.abs().max().item()
        assert (g - w).abs().max().item() <= grad_tol * scale


def test_edge_list_train_step_on_the_card_equals_cpu(cuda):
    """One two-frame union step on device-built edge lists
    (``device_graph_slab: false``, car T=1 at full width, the segment
    path in 16 chunks) on the card and on the CPU with the same graph
    randomization: the loss at rtol 1e-5, every gradient within 1e-3 of
    ``(1 + max|g|)``; no kernel launches."""
    from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("car_auto_T1_train")
    spec = db.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS, runtime=False)
    dspec, extra = dpipe.resolve_device_setup(cfg, spec, slab=False)
    model = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                     **extra, **cfg["model_kwargs"])
    assert model.edge_chunks == 16 and model.slab_level1 is None
    frames = []
    for seed in (0, 1):
        pts, labels = synthetic_lidar_frame(seed=seed, n_beams=32,
                                            points_per_beam=160)
        frames.append(dpipe.DeviceFrame(
            db.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS),
            dl.pack_frame_labels(labels, LABEL_MAP_CAR, 4)))
    stacked = dpipe.stack_frames(frames)
    init = params_to_numpy(model.init(seed=0, input_dim=1, device="cpu"))
    runs = []
    before = _launch_counts()
    for dev in (cuda, torch.device("cpu")):
        sums = step_lib.make_union_sums_fn(
            model, loss_config(cfg),
            dpipe.make_graph_builder(dspec, model.output_graph_level, cfg),
            2)
        gen = torch.Generator().manual_seed(5)
        rnds = [tuple(x.to(dev) for x in db.draw_randomization(
            NUM_POINTS, gen)) for _ in range(2)]
        batch = dpipe.frames_to_device(stacked, dev)

        def loss_of(params):
            acc, reg = sums(params, batch, rnds)
            return (acc["cls_w"] / torch.clamp(acc["n_ep"], min=1.0)
                    + acc["loc_w"] / torch.clamp(acc["n_val"], min=1.0)
                    + reg)

        runs.append(_grads_on(model, params_from_jax(init, dev), loss_of))
    torch.cuda.synchronize()
    assert _launch_counts() == before
    _assert_grads_close(*runs)


def _to_double(tree):
    if isinstance(tree, dict):
        return {k: _to_double(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_double(v) for v in tree]
    if tree is None or not tree.is_floating_point():
        return tree
    return tree.to(torch.float64)


def test_bn_train_step_on_the_card_equals_cpu(cuda):
    """One step of a car T=1 config with every MLP normalized by
    ``fused_BN_center`` on a host-built graph (unchunked), on the card
    and on the CPU, each against the CPU's float64 evaluation of the
    same step: the loss at rtol 1e-5, every gradient within 5e-3 of ``(1
    + max|g|)`` (batch norm amplifies f32 rounding: the CPU's own f32
    gradients lie ~2e-3 from float64 here), and the moving averages
    after the update, card against CPU, within 1e-3 relative."""
    from pointgnn_tpu_torch.graph import builder, pad
    from pointgnn_tpu_torch.nn import mlp
    from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("car_auto_T1_train")
    for lc in cfg["model_kwargs"]["layer_configs"]:
        for key in lc["kwargs"]:
            if key.endswith("normalization_type"):
                lc["kwargs"][key] = "fused_BN_center"
    model = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                     **cfg["model_kwargs"])
    assert model._has_bn and model.edge_chunks == 1
    pts, _ = synthetic_lidar_frame(seed=2, n_beams=32, points_per_beam=160)
    pts = pts.mask(np.arange(NUM_POINTS))
    vcl, kil, el = builder.gen_multi_level_local_graph_v3(
        pts.xyz, **cfg["graph_gen_kwargs"], rng=np.random.default_rng(0))
    k = len(vcl[-1])
    rng = np.random.default_rng(1)
    frame = pad.FrameData(
        pts.attr[:, :1].astype(np.float32), vcl, kil, el,
        rng.integers(0, 4, (k, 1)).astype(np.int32),
        rng.normal(size=(k, 1, 7)).astype(np.float32),
        (rng.random((k, 1)) < 0.3).astype(np.float32))
    graph = pad.batch_and_pad(
        [frame], pad.GraphCapacity((NUM_POINTS, 4096, 4096),
                                   (65536, 262144)))
    init = params_to_numpy(model.init(seed=0, input_dim=1, device="cpu"))
    loss_fn = step_lib.make_loss_fn(model, loss_config(cfg))
    runs, emas = [], []
    for dev, double in ((cuda, False), (torch.device("cpu"), False),
                        (torch.device("cpu"), True)):
        params = params_from_jax(init, dev)
        g = pad.to_device(graph, dev)
        if double:
            params = _to_double(params)
            g = g._replace(**{k: _to_double(getattr(g, k)) for k in (
                "features", "vertex_xyz", "vertex_mask", "encoded_boxes",
                "valid_boxes")})
        stats = {}

        def loss_of(p):
            total, aux = loss_fn(p, g)
            stats.update(aux["bn_stats"])
            return total

        runs.append(_grads_on(model, params, loss_of))
        mlp.update_bn_ema(params, stats, 0.5)
        emas.append([t.cpu() for key, t in mlp.named_leaves(params)
                     if key in mlp.EMA_KEYS])
    ref = runs[2]
    for loss, grads in runs[:2]:
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, ref[0], rtol=1e-5)
        for g, w in zip(grads, ref[1]):
            assert torch.isfinite(g).all()
            scale = 1.0 + w.abs().max().item()
            assert (g.double() - w).abs().max().item() <= 5e-3 * scale
    assert len(emas[0]) > 0
    for a, b in zip(emas[0], emas[1]):
        assert (a - b).abs().max().item() <= 1e-3 * (1 + b.abs().max().item())


def test_data_parallel_trainer_on_the_card(cuda, tmp_path):
    """Phase 16(a) at a small size: two ranks (``parallel.mesh.launch``,
    gloo on this card twice, NCCL over two cards) train car_auto_T1 at
    narrow widths through ``Trainer`` at batch 4 on a synthetic tree,
    two frames a rank: 2 K1 and 2 K2 launches per frame on each rank,
    the same parameters on both ranks bit for bit, and the first step
    against one process training the union of the four frames (no
    augmentation, no graph randomization): the loss at rtol 1e-5, each
    leaf's update within 1e-4 of (lr + its largest update)."""
    import copy
    import os

    from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy
    from pointgnn_tpu_torch.parallel import dryrun, mesh
    from pointgnn_tpu_torch.train import pipeline as tpipe
    from pointgnn_tpu_torch.train.trainer import Trainer
    from pointgnn_tpu_torch.utils import synthetic_kitti

    cfg = configs.get_config("car_auto_T1_train")
    for lc in cfg["model_kwargs"]["layer_configs"][:-1]:
        kw = lc["kwargs"]
        if "point_MLP_depth_list" in kw:
            kw["point_MLP_depth_list"] = [16, 24, 32]
            kw["output_MLP_depth_list"] = [32, 32]
        else:
            kw["auto_offset_MLP_depth_list"] = [16, 3]
            kw["edge_MLP_depth_list"] = [32, 32]
            kw["update_MLP_depth_list"] = [32, 32]
    tree = str(tmp_path / "kitti")
    synthetic_kitti.main(tree, 4, n_ground=2000)
    tc = configs.get_train_config("car_auto_T1_train")
    tc.update(batch_size=4, NUM_GPU=2, num_load_dataset_workers=0,
              data_aug_configs=[], device_graph_rnd3d=False,
              train_dir=str(tmp_path / "dp"),
              device_graph_spec=db.spec_from_config(
                  cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS,
                  runtime=False))
    fspec = tpipe.FetchSpec(tpipe.DatasetSpec.from_kitti_root(
        tree, os.path.join(tree, "3DOP_splits/train.txt"), 4), cfg, tc)
    devices = (["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2
               else ["cuda:0", "cuda:0"])
    job = dict(config=cfg, train_config=tc, fetch_spec=fspec, num_frames=4,
               batches=[[0, 1, 2, 3]] * 2, snapshots=(1,))
    ranks = [r[0] for r in mesh.launch(dryrun.train_jobs, 2, [job],
                                       devices=devices, timeout=300,
                                       join_timeout=300)]
    assert dryrun.same_params(ranks)
    for res in ranks:
        assert res["launches"] == [[4, 4], [4, 4]]  # (1 + T) x 2 frames
        assert all(np.isfinite(res["total_loss"]))
    one_tc = dict(tc, NUM_GPU=1, train_dir=str(tmp_path / "one"))
    one = Trainer(cfg, one_tc, fspec._replace(train_config=one_tc),
                  num_frames=4, device=cuda)
    try:
        p0 = copy.deepcopy(params_to_numpy(one.state.params))
        aux = one.train_batch([0, 1, 2, 3])
        p1 = params_to_numpy(one.state.params)
    finally:
        one.close()
    np.testing.assert_allclose(ranks[0]["total_loss"][0],
                               float(aux["total_loss"]), rtol=1e-5)
    lr = tc["initial_lr"]
    for t0, a, b in zip(*(optimizers.param_leaves(params_from_jax(p, "cpu"))
                          for p in (p0, ranks[0]["snapshots"][1], p1))):
        ua, ub = a - t0, b - t0
        assert (ua - ub).abs().max() <= 1e-4 * (lr + ub.abs().max())
