"""The port's host-built graph against the JAX package's, bitwise.

The radius search (native and the plain numpy search, capped and
uncapped, against ``pointgnn_tpu.graph._native`` and the JAX numpy
search), the multi-level downsampling (random and "center"), the whole
``gen_multi_level_local_graph_v3`` with one ``default_rng(seed)`` on each
side for the shipped car and ped_cyl graph settings, and the padding:
``pad_frame``, ``batch_and_pad`` (union offsets, overflow warnings,
balanced truncation), ``suggest_capacity`` and ``grow_to_fit``.  A failed
build of the native library raises: no numpy search replaces it."""

import numpy as np
import pytest
import torch

import jax

from pointgnn_tpu import configs as jax_configs
from pointgnn_tpu.graph import _native as jax_native
from pointgnn_tpu.graph import builder as jbuilder
from pointgnn_tpu.graph import pad as jpad
from pointgnn_tpu.graph import radius as jradius
from pointgnn_tpu.graph import voxel as jvoxel
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.graph import builder, pad, radius, voxel
from pointgnn_tpu_torch.postprocess import native


def _cloud(seed, n=6000, extent=20.0):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-extent, extent, n),
                    rng.uniform(-1.5, 1.5, n),
                    rng.uniform(0, 2 * extent, n)], 1).astype(np.float32)
    # a dense cluster, so a 256-neighbor cap fires
    dense = min(800, n // 4)
    xyz[:dense] = (rng.normal(size=(dense, 3)) * 0.6 + [3, 0, 10]).astype(
        np.float32)
    return xyz


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("cap", [-1, 256])
@pytest.mark.parametrize("use_native", [True, False])
def test_radius_neighbors_match_jax(use_native, cap):
    pts = _cloud(0)
    centers = pts[::5]
    got = radius.radius_neighbors(pts, centers, 1.5, cap,
                                  rng=np.random.default_rng(3),
                                  use_native=use_native)
    want = jradius.radius_neighbors(pts, centers, 1.5, cap,
                                    rng=np.random.default_rng(3),
                                    use_native=use_native)
    _same(got, want)
    assert (np.diff(got[:, 1]) >= 0).all()  # grouped by center
    counts = np.bincount(got[:, 1], minlength=len(centers))
    if cap > 0:
        assert counts.max() == cap  # the cap fired
    else:
        assert counts.max() > 256
    if use_native:
        seed = int(np.random.default_rng(3).integers(0, 2**63 - 1))
        _same(got, jax_native.radius_neighbors_native(pts, centers, 1.5,
                                                      cap, seed))


def test_native_and_plain_find_the_same_pairs():
    """Uncapped, both searches give the same pairs but for ones on the
    radius boundary (float64 against float32 distances)."""
    pts = _cloud(1)
    centers = pts[::7]
    a = radius.radius_neighbors(pts, centers, 2.0)
    b = radius.radius_neighbors(pts, centers, 2.0, use_native=False)
    diff = set(map(tuple, a.tolist())) ^ set(map(tuple, b.tolist()))
    for p, c in diff:
        d = np.linalg.norm(pts[p].astype(np.float64) - centers[c])
        assert abs(d - 2.0) < 1e-5
    assert len(a) > 10000


def test_seed_is_drawn_for_uncapped_levels():
    """The native search draws its seed whenever it gets a generator,
    capped or not, as JAX does: later draws line up."""
    pts = _cloud(2, n=500)
    for mod in (radius, jradius):
        g = np.random.default_rng(9)
        mod.radius_neighbors(pts, pts[:50], 1.0, -1, rng=g)
        assert g.bit_generator.state == _after_one_draw(9)


def _after_one_draw(seed):
    g = np.random.default_rng(seed)
    g.integers(0, 2**63 - 1)
    return g.bit_generator.state


def test_empty_inputs():
    assert radius.radius_neighbors(np.zeros((0, 3)), np.zeros((5, 3)),
                                   1.0).shape == (0, 2)
    assert radius.radius_neighbors(np.zeros((5, 3)), np.zeros((0, 3)),
                                   1.0).shape == (0, 2)


@pytest.mark.parametrize("rnd3d", [False, True])
@pytest.mark.parametrize("fn", ["multi_level_downsample_random",
                                "multi_level_downsample_select"])
def test_multi_level_downsample_matches_jax(fn, rnd3d):
    pts = _cloud(4)
    levels = [0.5, 0.5, 1.0]  # an equal consecutive scale copies
    got = getattr(voxel, fn)(pts, 0.8, levels, add_rnd3d=rnd3d,
                             rng=np.random.default_rng(5))
    want = getattr(jvoxel, fn)(pts, 0.8, levels, add_rnd3d=rnd3d,
                               rng=np.random.default_rng(5))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        _same(a, b)
    np.testing.assert_array_equal(got[1][1][:, 0],
                                  np.arange(len(got[0][1])))


@pytest.mark.parametrize("kwargs", ["graph_gen_kwargs",
                                    "runtime_graph_gen_kwargs"])
@pytest.mark.parametrize("name", ["car_auto_T3_train",
                                  "ped_cyl_auto_T3_trainval",
                                  "center"])
def test_multi_level_graph_matches_jax(name, kwargs):
    """The shipped graph settings (and car's with the "center"
    downsampling), one generator per side: every vertex, keypoint and
    edge array bitwise."""
    cfg = configs.get_config("car_auto_T3_train" if name == "center"
                             else name)
    assert cfg == jax_configs.get_config(
        "car_auto_T3_train" if name == "center" else name)
    gen = dict(cfg[kwargs])
    if name == "center":
        gen["downsample_method"] = "center"
    pts = _cloud(6)
    got = builder.gen_multi_level_local_graph_v3(
        pts, **gen, rng=np.random.default_rng(7))
    want = jbuilder.gen_multi_level_local_graph_v3(
        pts, **gen, rng=np.random.default_rng(7))
    leaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == 7
    for a, b in zip(leaves, jax.tree_util.tree_leaves(want)):
        _same(a, b)
    assert builder.get_graph_generate_fn("multi_level_local_graph_v3") is \
        builder.gen_multi_level_local_graph_v3


def _frames(n, with_labels=True):
    cfg = configs.get_config("car_auto_T3_train")
    out = []
    for seed in range(n):
        pts = _cloud(10 + seed, n=3000)
        vcl, kil, el = jbuilder.gen_multi_level_local_graph_v3(
            pts, **cfg["graph_gen_kwargs"],
            rng=np.random.default_rng(seed))
        k = len(vcl[-1])
        rng = np.random.default_rng(seed)
        labels = (rng.integers(0, 4, (k, 1)).astype(np.int32),
                  rng.normal(size=(k, 1, 7)).astype(np.float32),
                  rng.integers(0, 2, (k, 1, 1)).astype(np.float32)) \
            if with_labels else (None, None, None)
        out.append((pts[:, :1].copy(), [v.astype(np.float32) for v in vcl],
                    [x.astype(np.int32) for x in kil],
                    [e.astype(np.int32) for e in el], *labels))
    return out


def _pad_both(frames, cap, **kw):
    got = pad.batch_and_pad([pad.FrameData(*f) for f in frames],
                            pad.GraphCapacity(cap.vertices, cap.edges), **kw)
    want = jpad.batch_and_pad([jpad.FrameData(*f) for f in frames], cap,
                              **kw)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(got)),
                    jax.tree_util.tree_leaves(tuple(want))):
        _same(a, b)
    return got


def test_pad_frame_and_union_match_jax():
    frames = _frames(3)
    fit = jpad.suggest_capacity([jpad.FrameData(*f) for f in frames])
    assert tuple(pad.suggest_capacity([pad.FrameData(*f) for f in frames])
                 ) == (fit.vertices, fit.edges)
    # a capacity that holds the union of the three frames
    cap = jpad.GraphCapacity(tuple(3 * v for v in fit.vertices),
                             tuple(3 * e for e in fit.edges))
    one = pad.pad_frame(pad.FrameData(*frames[0]),
                        pad.GraphCapacity(cap.vertices, cap.edges))
    for a, b in zip(jax.tree_util.tree_leaves(tuple(one)),
                    jax.tree_util.tree_leaves(tuple(jpad.pad_frame(
                        jpad.FrameData(*frames[0]), cap)))):
        _same(a, b)
    got = _pad_both(frames, cap)
    # union offsets: frame 1's first edge points past frame 0's vertices
    n0 = [len(v) for v in frames[0][1]]
    e0 = len(frames[0][3][0])
    assert got.edges_src[0][e0] == frames[1][3][0][0, 0] + n0[0]
    assert got.edges_dst[0][e0] == frames[1][3][0][0, 1] + n0[1]
    # padded edges carry the sentinel destination
    total = sum(len(f[3][1]) for f in frames)
    assert (got.edges_dst[1][total:] == cap.vertices[2]).all()
    assert got.vertex_mask[0].dtype == np.float32
    dev = pad.to_device(got, "cpu")
    assert dev.edges_src[0].dtype == torch.int32
    assert dev.vertex_mask[2].dtype == torch.float32
    assert dev.cls_labels.dtype == torch.int32
    # without labels: zeros
    _pad_both(_frames(1, with_labels=False), cap)


def test_overflow_warns_and_truncates_like_jax():
    """Vertex overflow truncates the level and clamps its dependents;
    edge overflow drops the highest ranks of every center first."""
    frames = _frames(2)
    fit = jpad.suggest_capacity([jpad.FrameData(*f) for f in frames])
    need_v = [sum(len(f[1][li]) for f in frames) for li in range(3)]
    need_e = [sum(len(f[3][li]) for f in frames) for li in range(2)]
    cap = jpad.GraphCapacity((need_v[0] - 100, need_v[1] - 50,
                              need_v[2] - 50),
                             (need_e[0] // 2, need_e[1] // 3))
    with pytest.warns(RuntimeWarning) as caught:
        got = _pad_both(frames, cap)
    messages = [str(w.message) for w in caught]
    assert sum("vertex overflow" in m for m in messages) >= 3
    assert sum("edge overflow" in m for m in messages) >= 2
    # the bucket is full; which edges stayed is JAX's choice, bitwise
    dst = got.edges_dst[1][got.edges_dst[1] < cap.vertices[2]]
    assert len(dst) == cap.edges[1]
    assert fit.edges[1] > cap.edges[1]


def test_grow_to_fit_matches_jax():
    frames = _frames(2)
    tiny = jpad.GraphCapacity((512, 128, 128), (1024, 2048))
    want, grew = jpad.grow_to_fit(tiny, [jpad.FrameData(*f) for f in frames])
    got, tgrew = pad.grow_to_fit(pad.GraphCapacity(tiny.vertices, tiny.edges),
                                 [pad.FrameData(*f) for f in frames])
    assert grew and tgrew
    assert (got.vertices, got.edges) == (want.vertices, want.edges)
    assert got.num_levels == 2
    assert got.scaled(2) == pad.GraphCapacity(
        tuple(2 * v for v in got.vertices), tuple(2 * e for e in got.edges))
    same, grew = pad.grow_to_fit(got, [pad.FrameData(*f) for f in frames])
    assert not grew and same == got


def test_failed_radius_grid_build_raises(tmp_path, monkeypatch):
    """A compiler that cannot build the host library: the radius search
    raises with its output; the numpy search is not used in its place."""
    bad = tmp_path / "bad-c++"
    bad.write_text("#!/bin/sh\necho broken compiler >&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    pts = _cloud(3, n=200)
    with pytest.raises(RuntimeError, match="broken compiler"):
        radius.radius_neighbors(pts, pts[:10], 1.0)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    with pytest.raises(RuntimeError, match="cannot run"):
        builder.gen_multi_level_local_graph_v3(
            pts, **configs.get_config("car_auto_T3_train")[
                "graph_gen_kwargs"], rng=np.random.default_rng(0))
    assert "radius_grid.cpp" in {s.name for s in native.SOURCES}
