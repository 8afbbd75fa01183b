"""Data-parallel serving: the port's ``stream(mesh=...)`` on the CPU.

Eight synthetic frames served in batches of 4 over two devices (``["cpu",
"cpu"]``, and a ``parallel.mesh.Mesh``), each device with its own copy
of the params and a thread: the frames come out in input order, bitwise
those of ``stream()`` without a mesh, with the same buckets; and they
agree with the JAX pipeline's ``stream(mesh=make_mesh(2))`` (its
``test_stream_sharded_over_mesh``: the same detections, scores at rtol
1e-4 / atol 1e-5, boxes at rtol 1e-4 / atol 1e-4), on capped edge
lists in f32 from the same parameters.
"""

import numpy as np
import pytest
import torch

import jax

from pointgnn_tpu import infer as jax_infer
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.parallel import mesh as pmesh
from pointgnn_tpu_torch import infer
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.parallel import mesh
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame
from test_torch_serving import _small_config

pytestmark = pytest.mark.filterwarnings("ignore:keypoint overflow")

SPEC = dict(num_points=2048, num_keypoints=512, per_center_caps=(16, 64),
            cell_caps=(32, 64))


@pytest.fixture(scope="module")
def served():
    cfg = _small_config()
    jpipe = jax_infer.InferencePipeline(
        cfg, on_device_graph=True, device_spec=jdb.spec_from_config(
            cfg, **SPEC), use_box_score=False, seed=7, slab=False,
        pallas_tail=False, compute_dtype=None)
    params = jax.device_get(jpipe.params)
    # spread the class logits: no near-ties at the score threshold or in
    # the NMS order
    params["output"]["cls"][-1]["w"] = params["output"]["cls"][-1]["w"] * 8
    jpipe.params = params
    frames = [synthetic_lidar_frame(seed=s, n_beams=16, points_per_beam=64)[0]
              for s in range(8)]
    want = list(jpipe.stream(frames, batch=4, mesh=pmesh.make_mesh(2)))

    def port():
        return infer.InferencePipeline(
            cfg, params=params_from_jax(params, device="cpu"),
            on_device_graph=True,
            device_spec=tdb.spec_from_config(cfg, **SPEC),
            use_box_score=False, slab=False, compute_dtype="float32",
            device="cpu")

    return frames, want, port


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x[:3], y[:3]):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
        assert x[3].keys() == y[3].keys()
        for key in x[3]:
            assert x[3][key].tobytes() == y[3][key].tobytes()


@pytest.mark.parametrize("kind", ["list", "mesh"])
def test_stream_sharded_over_two_devices(served, kind):
    frames, want, port = served
    devices = ["cpu", "cpu"]
    if kind == "mesh":
        devices = mesh.Mesh(0, (torch.device("cpu"),) * 2)
    single, sharded = port(), port()
    one = list(single.stream(iter(frames), batch=4))
    got = list(sharded.stream(iter(frames), batch=4, mesh=devices))
    _same(one, got)
    assert sharded.frames_done == single.frames_done == len(frames)
    assert set(sharded.time_dict) == {"gen graph", "gnn inference", "nms"}
    assert sum(len(g[0]) for g in got) > 0
    for (c1, b1, s1, _), (c2, b2, s2, _) in zip(want, got):
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_allclose(s2, s1, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b2, b1, rtol=1e-4, atol=1e-4)


def test_stream_mesh_checks_its_batch(served):
    """``batch`` must divide over the devices; the tail batch may be
    short (here 6 frames in batches of 4)."""
    frames, _, port = served
    pipe = port()
    with pytest.raises(ValueError, match="must divide"):
        next(pipe.stream(iter(frames), batch=4, mesh=["cpu"] * 3))
    _same(list(port().stream(iter(frames[:6]), batch=4)),
          list(pipe.stream(iter(frames[:6]), batch=4, mesh=["cpu"] * 2)))
