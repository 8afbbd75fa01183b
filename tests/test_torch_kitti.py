"""The port's KITTI reads against the JAX package's: PNG decoding
(against PIL), the synthetic KITTI writer (against the tool), the
``KittiDataset`` reads and voxel averaging (bitwise), config files and
the port's checkpoints."""

import importlib.util
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from pointgnn_tpu.data import kitti as jax_kitti
from pointgnn_tpu.graph import voxel as jax_voxel
from pointgnn_tpu.train import checkpoint as jax_ckpt
from pointgnn_tpu.core.points import Points as JaxPoints
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.core.points import Points
from pointgnn_tpu_torch.data import kitti, png
from pointgnn_tpu_torch.graph import voxel
from pointgnn_tpu_torch.model.pointgnn import get_model
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.utils import config_io, synthetic_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pil_bgr(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[:, :, ::-1]


def _pil_png(array, mode) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def _image(rng, h=23, w=37, c=3):
    """Noise on a gradient, so encoders pick more than one filter."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy) % 256] * c, -1)
    noise = rng.integers(-4, 5, (h, w, c))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _filter_rows(pixels: np.ndarray, kinds, bpp: int) -> bytes:
    """PNG row filtering (the encoder side), one filter type per row."""
    h = pixels.shape[0]
    raw = pixels.reshape(h, -1).astype(np.int64)
    out = []
    for r in range(h):
        cur = raw[r]
        prior = raw[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        kind = kinds[r % len(kinds)]
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8)
                   .tobytes())
    return b"".join(out)


def _hand_png(width, height, depth, color, payload, interlace=0,
              split=1) -> bytes:
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0,
                         interlace)
    data = zlib.compress(payload)
    step = -(-len(data) // split)
    idats = b"".join(png._chunk(b"IDAT", data[i:i + step])
                     for i in range(0, len(data), step))
    return (png.SIGNATURE + png._chunk(b"IHDR", header) + idats
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_decode_equals_pil_on_pil_files(mode):
    rng = np.random.default_rng(0)
    for shape in ((23, 37), (64, 5), (1, 1)):
        img = _image(rng, *shape, c=len(mode))
        data = _pil_png(img, mode)
        out = png.decode_png(data)
        assert out.dtype == np.uint8 and out.shape == shape + (3,)
        np.testing.assert_array_equal(out, _pil_bgr(data))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("color, bpp", [(2, 3), (6, 4)])
def test_png_decode_each_filter_type(kinds, color, bpp):
    rng = np.random.default_rng(sum(kinds) + bpp)
    img = _image(rng, 9, 13, bpp)
    payload = _filter_rows(img, kinds, bpp)
    data = _hand_png(13, 9, 8, color, payload, split=3)
    np.testing.assert_array_equal(png.decode_png(data), _pil_bgr(data))
    np.testing.assert_array_equal(png.decode_png(data), img[:, :, 2::-1])


def test_png_rejects_what_it_does_not_read(tmp_path):
    rng = np.random.default_rng(1)
    cases = {
        "color type 3": _pil_png(rng.integers(0, 4, (5, 6)).astype(
            np.uint8), "P"),
        "color type 0": _pil_png(_image(rng, 5, 6, 1)[:, :, 0], "L"),
        "bit depth 16": _hand_png(2, 2, 16, 2, b"\0" * (2 * 13)),
        "interlaced": _hand_png(2, 2, 8, 2, b"\0" * (2 * 7), interlace=1),
    }
    for match, data in cases.items():
        with pytest.raises(ValueError, match=match):
            png.decode_png(data)
    good = _pil_png(_image(rng), "RGB")
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(good[1:])
    bad_crc = bytearray(good)
    bad_crc[30] ^= 0xFF  # inside the IHDR chunk
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad_crc))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_writer_filter_types(kind):
    img = _image(np.random.default_rng(3 + kind), 19, 29)
    data = png.encode_png(img, filter_type=kind)
    rows = np.frombuffer(zlib.decompress(data[41:-16]), np.uint8)
    assert (rows.reshape(19, -1)[:, 0] == kind).all()
    np.testing.assert_array_equal(_pil_bgr(data), img)
    np.testing.assert_array_equal(png.decode_png(data), img)
    # the writer's rows equal the tests' own filtering
    assert rows.tobytes() == _filter_rows(img[:, :, ::-1], (kind,), 3)


def test_png_unknown_filter_type_raises():
    payload = bytearray(_filter_rows(_image(np.random.default_rng(4), 3,
                                            4), (0,), 3))
    payload[2 * 13] = 5  # the last row's filter byte
    with pytest.raises(ValueError, match="row 2 has unknown filter type 5"):
        png.decode_png(_hand_png(4, 3, 8, 2, bytes(payload)))
    with pytest.raises(ValueError, match="filter type 5"):
        png.encode_png(np.zeros((2, 2, 3), np.uint8), filter_type=5)


def test_png_writer_round_trip(tmp_path):
    img = _image(np.random.default_rng(2), 31, 17)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(_pil_bgr(f.read()), img)
    with pytest.raises(ValueError):
        png.write_png(path, img.astype(np.float32))


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_kitti",
        os.path.join(REPO, "tools", "make_synthetic_kitti.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dirs(root):
    return (os.path.join(root, "image/training/image_2"),
            os.path.join(root, "velodyne/training/velodyne"),
            os.path.join(root, "calib/training/calib"),
            os.path.join(root, "labels/training/label_2"),
            os.path.join(root, "3DOP_splits/val.txt"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The tool's tree and the port's, 2 frames at the tool's size,
    both written from seed 0."""
    root = tmp_path_factory.mktemp("kitti")
    tool, port = str(root / "tool"), str(root / "port")
    _load_tool().main(tool, 2, classes=("Car", "Pedestrian", "Cyclist"))
    synthetic_kitti.main(port, 2, classes=("Car", "Pedestrian", "Cyclist"))
    return tool, port


def test_synthetic_writer_equals_the_tool(trees):
    tool, port = trees
    for sub in ("velodyne/training/velodyne", "calib/training/calib",
                "labels/training/label_2", "3DOP_splits"):
        names = sorted(os.listdir(os.path.join(tool, sub)))
        assert names == sorted(os.listdir(os.path.join(port, sub)))
        for name in names:
            with open(os.path.join(tool, sub, name), "rb") as a, \
                    open(os.path.join(port, sub, name), "rb") as b:
                assert a.read() == b.read(), (sub, name)
    for name in ("000000.png", "000001.png"):
        a = jax_kitti._imread_bgr(
            os.path.join(tool, "image/training/image_2", name))
        b = png.read_png(os.path.join(port, "image/training/image_2", name))
        np.testing.assert_array_equal(a, b)


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("voxel_size", [None, 0.3])
def test_dataset_reads_equal_jax(trees, voxel_size):
    tool, port = trees
    jds = jax_kitti.KittiDataset(*_dirs(tool), num_classes=4)
    tds = kitti.KittiDataset(*_dirs(tool), num_classes=4)
    assert tds.num_files == jds.num_files == 2
    for i in range(2):
        assert tds.get_filename(i) == jds.get_filename(i)
        jc, tc = jds.get_calib(i), tds.get_calib(i)
        assert jc.keys() == tc.keys()
        for key in jc:
            _bitwise(tc[key], jc[key])
        jv, tv = jds.get_velo_points(i), tds.get_velo_points(i)
        _bitwise(tv.xyz, jv.xyz)
        _bitwise(tv.attr, jv.attr)
        assert tds.get_label(i) == jds.get_label(i)
        jp = jds.get_cam_points_in_image_with_rgb(i, voxel_size)
        tp = tds.get_cam_points_in_image_with_rgb(i, voxel_size)
        assert len(tp.xyz) > 1000
        _bitwise(tp.xyz, jp.xyz)
        _bitwise(tp.attr, jp.attr)
        jq = jds.get_cam_points_in_image(i, voxel_size)
        _bitwise(tds.get_cam_points_in_image(i, voxel_size).xyz, jq.xyz)
    hard = kitti.KittiDataset(*_dirs(tool), num_classes=4, difficulty=2)
    jhard = jax_kitti.KittiDataset(*_dirs(tool), num_classes=4,
                                   difficulty=2)
    assert hard.get_label(0) == jhard.get_label(0)
    # the port's own images (its writer) read the same
    pds = kitti.KittiDataset(*_dirs(port), num_classes=4)
    _bitwise(pds.get_cam_points_in_image_with_rgb(1).attr,
             jds.get_cam_points_in_image_with_rgb(1).attr)


def test_missing_files_raise(trees, tmp_path):
    tool, _ = trees
    dirs = list(_dirs(tool))
    dirs[2] = str(tmp_path)  # no calibration files there
    with pytest.raises(FileNotFoundError, match="does not exist"):
        kitti.KittiDataset(*dirs)


def test_parse_label_line_equals_jax():
    line = "Car 0.00 0 1.85 387.63 181.54 423.81 203.12 1.67 1.87 3.69 " \
           "-16.53 2.39 58.49 1.57 0.93"
    assert kitti.parse_label_line(line) == jax_kitti.parse_label_line(line)
    assert kitti.parse_label_line(line[:-5]) == jax_kitti.parse_label_line(
        line[:-5])
    assert kitti.parse_label_line("  \n") is None


def test_voxel_downsample_average_equals_jax():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-20, 20, (2048, 3)).astype(np.float32)
    attr = rng.uniform(0, 1, (2048, 4)).astype(np.float32)
    for size, seed in ((0.5, None), (2.0, None), (1.0, 5)):
        kw = {}
        if seed is not None:
            tr, jr = np.random.default_rng(seed), np.random.default_rng(seed)
            kw = dict(t=dict(rng=tr), j=dict(rng=jr))
        t = voxel.voxel_downsample_average(Points(xyz, attr), size,
                                           **kw.get("t", {}))
        j = jax_voxel.voxel_downsample_average(JaxPoints(xyz, attr), size,
                                               **kw.get("j", {}))
        assert len(t.xyz) < len(xyz)
        _bitwise(t.xyz, j.xyz)
        _bitwise(t.attr, j.attr)
    t = voxel.voxel_downsample_average(Points(xyz), 0.5)
    assert t.attr is None


def test_config_io_round_trip(tmp_path):
    cfg = configs.get_config("car_auto_T3_train")
    tcfg = configs.get_train_config("car_auto_T3_train")
    config_io.save_config(str(tmp_path / "a" / "config"), cfg)
    config_io.save_train_config(str(tmp_path / "a" / "train_config"), tcfg)
    assert config_io.load_config(str(tmp_path / "a" / "config")) == cfg
    assert config_io.load_train_config(
        str(tmp_path / "a" / "train_config")) == tcfg
    # built-in names, with and without the file suffix
    assert config_io.load_config("car_auto_T3_train") == cfg
    assert config_io.load_config("x/car_auto_T3_train_config") == cfg
    assert config_io.load_train_config(
        "car_auto_T3_train_train_config") == tcfg
    with pytest.raises(FileNotFoundError):
        config_io.load_config(str(tmp_path / "nope"))


def _small_params(seed=0):
    cfg = configs.model_config("Car", T=1)
    model = get_model(cfg["model_name"])(
        num_classes=4, box_encoding_len=7, mode="test",
        **cfg["model_kwargs"])
    return model.init(seed, 1, "cpu")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, "%s/%s" % (path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, "%s/%d" % (path, i))
    else:
        yield path, tree


def test_checkpoint_round_trip(tmp_path):
    params = _small_params()
    leaves = [t for _, t in _leaves(params) if t is not None]
    for t in leaves:
        t.grad = torch.ones_like(t)
    sgd = torch.optim.SGD(leaves, lr=0.1, momentum=0.9)
    sgd.step()
    adam = torch.optim.Adam(leaves, lr=1e-3)
    adam.step()
    state = {"params": params, "opt_state": {"torch": sgd, "count": 1},
             "adam": adam, "bf16": torch.arange(5.0).to(torch.bfloat16),
             "step": np.asarray(7), "none": None}
    d = str(tmp_path / "ck")
    cfg = configs.model_config("Car", T=1)
    path = ckpt.save_checkpoint(d, 7, state, config=cfg,
                                train_config={"batch_size": 4})
    assert os.listdir(path) == [ckpt.STATE_FILE]
    ckpt.save_checkpoint(d, 3, {"params": _small_params(1)})
    assert ckpt.list_checkpoint_steps(d) == [3, 7]
    assert ckpt.latest_checkpoint(d).endswith("model-7")
    assert config_io.load_config(os.path.join(d, "config")) == cfg
    restored, step = ckpt.restore_checkpoint(d, device="cpu")
    assert step == 7
    want = dict(_leaves({**state, "opt_state": {
        "torch": sgd.state_dict(), "count": 1}, "adam": adam.state_dict()}))
    got = dict(_leaves(restored))
    assert want.keys() == got.keys()
    for key, val in want.items():
        if isinstance(val, (torch.Tensor, np.ndarray)):
            val = torch.as_tensor(val)
            assert got[key].dtype == val.dtype, key
            assert torch.equal(got[key], val), key
        else:
            assert got[key] == val and type(got[key]) is type(val), key
    # the restored optimizer state loads into a fresh optimizer
    fresh = torch.optim.SGD(leaves, lr=0.5, momentum=0.9)
    fresh.load_state_dict(restored["opt_state"]["torch"])
    assert fresh.param_groups[0]["lr"] == 0.1
    older, step = ckpt.restore_checkpoint(d, step=3, device="cpu")
    assert step == 3
    for (kg, g), (kw, w) in zip(_leaves(older["params"]),
                                _leaves(_small_params(1))):
        assert kg == kw and (g is w is None or torch.equal(g, w))
    assert ckpt.restore_checkpoint(str(tmp_path / "nope"),
                                   device="cpu") == (None, 0)
    with pytest.raises(ValueError, match="'/'"):
        ckpt.save_checkpoint(d, 8, {"a/b": torch.zeros(1)})


def test_orbax_directory_names_the_converter(tmp_path):
    d = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(d, 2, {"params": {"w": np.ones(3, np.float32)}})
    with pytest.raises(ValueError, match="convert_jax_checkpoint.py"):
        ckpt.restore_checkpoint(d, device="cpu")
