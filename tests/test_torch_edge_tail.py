"""The port's edge-list tail (K3 ``edge_tail_max``, K4 ``fused_edge_max``)
and the layers' edge-list branches against the JAX package.

The same numpy inputs go through the JAX kernels (Pallas, in interpret
mode on the CPU, as ``tests/test_pallas_kernels.py`` runs them) and the
port's wrappers on CPU tensors (the plain PyTorch versions).  Cases
cover invalid slots, a center with no valid slot, an empty chain and
``apply_act_first=False``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.nn import layers as jlayers
from pointgnn_tpu.nn import pallas_kernels as pk
from pointgnn_tpu_torch.nn import edge_tail
from pointgnn_tpu_torch.nn import layers as tlayers
from pointgnn_tpu_torch.params import params_from_jax

K, S, H = 64, 12, 24


def _close(out, ref, compute_dtype):
    """f32: the same f32 sums in another order, a few ulps of values of
    order 1-5.  bf16: a sum on the other side of a bf16 rounding boundary
    moves an activation by one bf16 ulp (2^-8), carried by later layers."""
    if compute_dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(out - ref) / (1.0 + np.abs(ref))
        assert err.max() <= 2e-2, err.max()


def _case(seed, widths, compute_dtype):
    """(A, B, edges [K, S] with the sentinel K on invalid slots, valid,
    chain) in numpy; A, B and the chain already in the compute dtype."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(K, H)).astype(np.float32)
    b = rng.normal(size=(K, H)).astype(np.float32)
    valid = rng.uniform(size=(K, S)) > 0.3
    valid[3] = False  # a center with no valid slot
    valid[5] = True   # and one with every slot valid
    edges = np.where(valid, rng.integers(0, K, (K, S)), K).astype(np.int32)
    chain = []
    for din, dout in zip([H] + widths[:-1], widths):
        chain.append(((rng.normal(size=(din, dout)) / np.sqrt(din))
                      .astype(np.float32),
                      (rng.normal(size=(dout,)) * 0.1).astype(np.float32)))
    jd = jnp.dtype(compute_dtype)
    cast = lambda x: np.asarray(jnp.asarray(x, jd))  # noqa: E731
    return (cast(a), cast(b), edges, valid.astype(np.float32),
            [(cast(w), cast(bb)) for w, bb in chain])


def _t(x):
    x = np.array(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x)


CASES = {
    "two_layers": dict(widths=[32, 20], act=True),
    "one_layer_no_act": dict(widths=[24], act=False),
    "empty_chain": dict(widths=[], act=True),
}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_jax(case, compute_dtype):
    spec = CASES[case]
    a, b, edges, valid, chain = _case(len(case), spec["widths"],
                                      compute_dtype)
    flat = tuple(jnp.asarray(t) for wb in chain for t in wb)
    gathered = np.asarray(jnp.asarray(a)[np.minimum(edges, K - 1)
                                         .reshape(-1)])
    j3 = np.asarray(pk.edge_tail_max(
        jnp.asarray(gathered), jnp.asarray(b), jnp.asarray(valid), flat,
        apply_act_first=spec["act"], interpret=True,
    ))
    j4 = np.asarray(pk.fused_edge_max(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(edges),
        jnp.asarray(valid), flat, apply_act_first=spec["act"],
        interpret=True,
    ))
    weights = [(_t(w), _t(bb)) for w, bb in chain]
    t3 = edge_tail.edge_tail_max(_t(gathered), _t(b), _t(valid), weights,
                                 apply_act_first=spec["act"])
    t4 = edge_tail.fused_edge_max(_t(a), _t(b), _t(edges), _t(valid),
                                  weights, apply_act_first=spec["act"])
    h_out = spec["widths"][-1] if spec["widths"] else H
    assert t3.shape == t4.shape == (K, h_out)
    assert t3.dtype == t4.dtype == torch.float32
    _close(t3.numpy(), j3, compute_dtype)
    _close(t4.numpy(), j4, compute_dtype)
    # K4's plain version gathers what K3's was given: the same output
    assert torch.equal(t3, t4)
    # the center with no valid slot gets 0 on every side
    assert (t3[3] == 0).all() and (j3[3] == 0).all()
    if not spec["act"]:
        # negative differences reach the first product unclipped
        with_act = edge_tail.edge_tail_max(_t(gathered), _t(b), _t(valid),
                                           weights, apply_act_first=True)
        assert not torch.equal(t3, with_act)


def test_rounding_follows_the_tpu_kernel():
    """bf16: the last layer's output is rounded to bf16 (slab_edge_max
    leaves it in f32), so every output is a bf16 value."""
    a, b, edges, valid, chain = _case(7, [32, 20], "bfloat16")
    gathered = _t(a)[torch.from_numpy(np.minimum(edges, K - 1))
                     .reshape(-1).long()]
    out = edge_tail.edge_tail_max(gathered, _t(b), _t(valid),
                                  [(_t(w), _t(bb)) for w, bb in chain])
    assert torch.equal(out, out.to(torch.bfloat16).to(torch.float32))


def test_wrappers_reject_bad_inputs():
    a, b, edges, valid, chain = _case(1, [16], "float32")
    w = [(_t(x), _t(y)) for x, y in chain]
    g = _t(a)[torch.from_numpy(np.minimum(edges, K - 1)).reshape(-1).long()]
    with pytest.raises(ValueError, match="K \\* S"):
        edge_tail.edge_tail_max(g[:-1], _t(b), _t(valid), w)
    with pytest.raises(ValueError, match="dtype"):
        edge_tail.edge_tail_max(g, _t(b).to(torch.bfloat16), _t(valid), w)
    with pytest.raises(ValueError, match="int32"):
        edge_tail.fused_edge_max(_t(a), _t(b), _t(edges).long(), _t(valid),
                                 w)
    with pytest.raises(ValueError, match="chain widths"):
        edge_tail.fused_edge_max(_t(a), _t(b), _t(edges), _t(valid),
                                 [(w[0][0][:5], w[0][1])])


# ---------------------------------------------------------------------------
# the layers' edge-list (pallas_tail) branches
# ---------------------------------------------------------------------------

NP, NK = 384, 96


def _geometry(seed):
    rng = np.random.default_rng(seed)
    pxyz = np.stack([rng.uniform(0, 12, NP), rng.uniform(-1, 1, NP),
                     rng.uniform(0, 12, NP)], 1).astype(np.float32)
    pmask = np.ones(NP, bool)
    pmask[NP - 30:] = False
    kidx = np.sort(rng.choice(NP - 30, NK, replace=False))
    kxyz = pxyz[kidx]
    kmask = np.ones(NK, bool)
    kmask[NK - 6:] = False
    l0 = jdb.LevelSpec(1.5, 16, 8, grid_xz=16)
    l1 = jdb.LevelSpec(3.0, 32, 16, grid_xz=8)
    e0 = jdb.radius_edges(pxyz, pmask, kxyz, kmask, l0)
    e1 = jdb.radius_edges(kxyz, kmask, kxyz, kmask, l1)
    return (pxyz, pmask, kxyz, kmask,
            [tuple(np.asarray(x) for x in e) for e in (e0, e1)], rng)


POOL_KW = dict(
    point_MLP_depth_list=[16, 24, 32], output_MLP_depth_list=[32, 32],
    point_MLP_normalization_type="NONE", output_MLP_normalization_type="NONE",
)
GNN_KW = dict(
    edge_MLP_depth_list=[32, 32], update_MLP_depth_list=[32, 32],
    auto_offset=True, auto_offset_MLP_depth_list=[16, 3],
    edge_MLP_normalization_type="NONE", update_MLP_normalization_type="NONE",
    auto_offset_MLP_normalization_type="NONE",
)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pooling_tail_matches_jax(compute_dtype):
    pxyz, pmask, kxyz, kmask, edges, rng = _geometry(0)
    feats = rng.normal(size=(NP, 1)).astype(np.float32)
    feats[~pmask] = 0
    layer = jlayers.PointSetPooling()
    params = jax.device_get(layer.init(jax.random.PRNGKey(0), 1, **POOL_KW))
    kw = dict(POOL_KW, compute_dtype=compute_dtype)
    ref = np.asarray(layer.apply(
        params, jnp.asarray(feats), jnp.asarray(pxyz), jnp.asarray(kxyz),
        jnp.asarray(edges[0][0]), jnp.asarray(edges[0][1]),
        center_mask=jnp.asarray(kmask, jnp.float32),
        edge_sentinel="src", pallas_tail=True, **kw,
    ))
    out = tlayers.PointSetPooling().apply(
        params_from_jax(params, "cpu"), _t(feats), _t(pxyz), _t(kxyz),
        center_mask=_t(kmask.astype(np.float32)),
        edges_src=_t(edges[0][0]), edges_dst=_t(edges[0][1]),
        edge_sentinel="src", pallas_tail=True, **kw,
    )
    assert out.shape == ref.shape
    assert (out.numpy()[~kmask] == 0).all()
    _close(out.numpy(), ref, compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gnn_tail_matches_jax(compute_dtype):
    pxyz, pmask, kxyz, kmask, edges, rng = _geometry(1)
    feats = rng.normal(size=(NK, 32)).astype(np.float32)
    layer = jlayers.GraphNetAutoCenter()
    params = jax.device_get(layer.init(jax.random.PRNGKey(1), 32, **GNN_KW))
    kw = dict(GNN_KW, compute_dtype=compute_dtype)
    vmask = kmask.astype(np.float32)
    ref = np.asarray(layer.apply(
        params, jnp.asarray(feats), jnp.asarray(kxyz),
        jnp.asarray(edges[1][0]), jnp.asarray(edges[1][1]),
        vertex_mask=jnp.asarray(vmask), edge_sentinel="src",
        pallas_tail=True, **kw,
    ))
    out = tlayers.GraphNetAutoCenter().apply(
        params_from_jax(params, "cpu"), _t(feats), _t(kxyz),
        vertex_mask=_t(vmask), edges_src=_t(edges[1][0]),
        edges_dst=_t(edges[1][1]), edge_sentinel="src", pallas_tail=True,
        **kw,
    )
    assert out.shape == ref.shape
    _close(out.numpy(), ref, compute_dtype)


def test_generic_segment_path_is_not_ported():
    """(Named when the generic segment path raised.)  The segment path is
    ported: without the tail, the GNN layer reduces the device-built
    ("src") edge list through the sentinel mask, as the JAX layer does,
    and gives the tail's output."""
    pxyz, pmask, kxyz, kmask, edges, rng = _geometry(2)
    feats = rng.normal(size=(NK, 32)).astype(np.float32)
    jparams = jax.device_get(jlayers.GraphNetAutoCenter().init(
        jax.random.PRNGKey(2), 32, **GNN_KW))
    params = params_from_jax(jparams, "cpu")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jlayers.GraphNetAutoCenter().apply(
            jparams, jnp.asarray(feats), jnp.asarray(kxyz),
            jnp.asarray(edges[1][0]), jnp.asarray(edges[1][1]),
            vertex_mask=jnp.asarray(kmask.astype(np.float32)),
            edge_sentinel="src", pallas_tail=False, **GNN_KW))
    outs = [tlayers.GraphNetAutoCenter().apply(
        params, _t(feats), _t(kxyz), vertex_mask=_t(kmask.astype(
            np.float32)), edges_src=_t(edges[1][0]),
        edges_dst=_t(edges[1][1]), edge_sentinel="src", pallas_tail=tail,
        **GNN_KW).numpy() for tail in (False, True)]
    for got in outs:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """Each kernel library is keyed by its source and every local header
    it includes: editing a header rebuilds exactly its includers."""
    import shutil

    from pointgnn_tpu_torch.nn import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    assert cuda_build.local_headers("edge_tail_max.cu") == [
        "edge_tail.cuh", "slab_chain.cuh"]
    assert cuda_build.local_headers("slab_edge_max.cu") == ["slab_chain.cuh"]
    before = {n: cuda_build.source_hash(n) for n in cuda_build.SOURCES}
    with open(csrc / "edge_tail.cuh", "a") as f:
        f.write("// edit\n")
    after = {n: cuda_build.source_hash(n) for n in cuda_build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == {
        "edge_tail_max", "fused_edge_max"}
    with open(csrc / "slab_chain.cuh", "a") as f:
        f.write("// edit\n")
    again = {n: cuda_build.source_hash(n) for n in cuda_build.SOURCES}
    assert all(again[n] != after[n] for n in cuda_build.SOURCES)
