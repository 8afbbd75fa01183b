"""The port's PointGNN forward against the JAX model, on the same graph
and the same parameters (handed over through ``params_from_jax``)."""

import numpy as np
import pytest
import torch

import jax

from pointgnn_tpu import configs as jax_configs
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.model import encodings as jax_encodings
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.model import encodings
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy

NUM_POINTS, NUM_KEYPOINTS = 1024, 256


def small_config(T=2):
    """car_auto config with MLP widths narrowed to 16-32 (CPU-sized)."""
    cfg = jax_configs.model_config("Car", T=T)
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


def _models(cfg, compute_dtype):
    spec = jdb.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS
    )._replace(slab_level0=True, slab_level1=True)
    wiring = {
        lvl: jdb.slab_kernel_wiring(getattr(spec, "level%d" % lvl))
        for lvl in (0, 1)
    }
    jmodel = JaxPointGNN(
        num_classes=4, box_encoding_len=7, mode="test",
        compute_dtype=compute_dtype, edge_sentinel="src",
        slab_level1=wiring[1], slab_level0=wiring[0],
        **cfg["model_kwargs"],
    )
    port_wiring = {
        lvl: {k: v for k, v in w.items() if k != "zscan"}
        for lvl, w in wiring.items()
    }
    tmodel = PointGNN(
        num_classes=4, box_encoding_len=7, mode="test",
        compute_dtype=compute_dtype,
        slab_level1=port_wiring[1], slab_level0=port_wiring[0],
        **cfg["model_kwargs"],
    )
    tspec = tdb.DeviceGraphSpec(*spec)
    return spec, tspec, jmodel, tmodel


def test_params_from_jax_round_trip():
    cfg = small_config()
    _, _, jmodel, tmodel = _models(cfg, None)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0), 1))
    tparams = params_from_jax(jparams, device="cpu")
    assert tparams["layer2"]["edge_mlp"][0]["w"].dtype == torch.float32
    assert tparams["layer2"]["edge_mlp"][0]["norm"] is None
    back = params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_b) > 0
    for a, b in zip(flat_j, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the port's own init has the same tree shape
    own = params_to_numpy(tmodel.init(seed=0, input_dim=1, device="cpu"))
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(
        back
    )
    for a, b in zip(jax.tree_util.tree_leaves(own), flat_b):
        assert a.shape == b.shape


# f32: the two frameworks sum the same f32 products in other orders, so
# table values differ by a few ulps; across T=2 residual layers and the
# heads that stays below 1e-4 of values of order 1.  bf16: such an ulp
# difference can flip a bf16 rounding of a table or hidden activation
# (2^-8 relative) and the kernel's max may then pick another neighbor;
# 1e-2 absolute bounds one such flip on values of order 1.
TOL = {None: dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_pointgnn_apply_matches_jax(compute_dtype):
    cfg = small_config()
    spec, tspec, jmodel, tmodel = _models(cfg, compute_dtype)
    pts, _ = synthetic_lidar_frame(seed=0, n_beams=16, points_per_beam=64)
    packed = jdb.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(1), 1))

    @jax.jit
    def jfwd(params, packed):
        graph = jdb.build_padded_graph(*jdb.unpack_points(packed), spec)
        logits, enc = jmodel.apply(params, graph)
        return jmodel.postprocess(logits), enc

    jprobs, jenc = jax.device_get(jfwd(jparams, packed))
    graph = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)), tspec
    )
    logits, enc = tmodel.apply(params_from_jax(jparams, "cpu"), graph)
    probs = tmodel.postprocess(logits)
    assert probs.shape == jprobs.shape and enc.shape == jenc.shape
    assert torch.isfinite(enc).all()
    np.testing.assert_allclose(probs.numpy(), jprobs, **TOL[compute_dtype])
    np.testing.assert_allclose(enc.numpy(), jenc, **TOL[compute_dtype])


def test_classaware_decode_matches_jax():
    """(Named when the class-aware decoder was the only one ported.)  The
    class-aware device decoder against JAX's; the voxelnet decoder,
    which raised here then, against JAX's too (the six codecs are held
    against JAX in ``test_torch_codecs.py``)."""
    rng = np.random.default_rng(0)
    n = 64
    cls = rng.integers(0, 4, n).astype(np.int32)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    enc = rng.normal(size=(n, 7)).astype(np.float32)
    label_map = {"Background": 0, "Car": 1, "DontCare": 3}
    jdec = np.asarray(jax_encodings.get_decode_jax(
        "classaware_all_class_box_encoding", label_map
    )(cls, xyz, enc))
    tdec = encodings.get_decode(
        "classaware_all_class_box_encoding", label_map
    )(torch.from_numpy(cls), torch.from_numpy(xyz), torch.from_numpy(enc))
    # exp() of two libm implementations: a few f32 ulps
    np.testing.assert_allclose(tdec.numpy(), jdec, rtol=1e-6, atol=1e-6)
    jvox = np.asarray(jax_encodings.get_decode_jax(
        "voxelnet_box_encoding", label_map)(cls, xyz, enc))
    tvox = encodings.get_decode("voxelnet_box_encoding", label_map)(
        torch.from_numpy(cls), torch.from_numpy(xyz), torch.from_numpy(enc))
    np.testing.assert_allclose(tvox.numpy(), jvox, rtol=1e-6, atol=1e-6)


def test_non_slab_layer_raises():
    """(Named when the layers raised here.)  Without slab wiring or the
    edge-list tail the layers take the generic segment path: on a
    device-built edge-list graph ("src" sentinel) it gives the edge-list tail's outputs; a slab graph has no
    edge list to reduce, so the model raises."""
    cfg = small_config(T=1)
    tmodel = PointGNN(num_classes=4, box_encoding_len=7,
                      edge_sentinel="src", edge_chunks=4,
                      **cfg["model_kwargs"])
    tail = PointGNN(num_classes=4, box_encoding_len=7, edge_sentinel="src",
                    pallas_tail=True, **cfg["model_kwargs"])
    params = tmodel.init(seed=0, input_dim=1, device="cpu")
    pts, _ = synthetic_lidar_frame(seed=0, n_beams=16, points_per_beam=64)
    spec = tdb.spec_from_config(cfg, num_points=NUM_POINTS,
                                num_keypoints=NUM_KEYPOINTS)
    packed = torch.from_numpy(
        tdb.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    )
    graph = tdb.build_padded_graph(
        *tdb.unpack_points(packed),
        spec._replace(slab_level0=False, slab_level1=False),
    )
    for got, want in zip(tmodel.apply(params, graph),
                         tail.apply(params, graph)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    graph = tdb.build_padded_graph(
        *tdb.unpack_points(packed),
        spec._replace(slab_level0=True, slab_level1=True),
    )
    with pytest.raises(ValueError, match="segment"):
        tmodel.apply(params, graph)
