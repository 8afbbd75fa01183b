"""The port imports with JAX, orbax, OpenCV, PIL, matplotlib,
scikit-learn and Open3D blocked and pulls in nothing of
``pointgnn_tpu``; ``chip_smoke.py``, the port's scripts (``run_torch.py``,
``train_torch.py``, ``eval_torch.py``, ``smoke_train_eval_torch.py``) and
its tools (``tools_torch/*.py``) import none of them."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pointgnn_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "orbax", "cv2", "PIL", "matplotlib", "sklearn",
           "open3d")
TOOLS = tuple(sorted(
    "tools_torch." + f[:-3]
    for f in os.listdir(os.path.join(REPO, "tools_torch"))
    if f.endswith(".py") and f != "__init__.py"))
SCRIPTS = ("run_torch", "train_torch", "eval_torch",
           "smoke_train_eval_torch") + TOOLS


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            pointgnn_tpu_torch.__path__, "pointgnn_tpu_torch."
        )
    )


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "pointgnn_tpu_torch.nn.slab" in mods
    assert "pointgnn_tpu_torch.infer" in mods
    for name in ("postprocess.native", "data.png", "data.kitti",
                 "graph.voxel", "utils.config_io", "train.checkpoint",
                 "utils.synthetic_kitti", "data.augment", "data.crop_aug",
                 "train.pipeline", "train.trainer", "train.summary",
                 "utils.thread_warnings", "train.evaluator",
                 "postprocess.kitti_eval", "nn.segment", "graph.radius",
                 "graph.builder", "graph.pad", "parallel.mesh",
                 "parallel.dryrun", "utils.vis", "utils.interactive",
                 "utils.flops", "train.convert"):
        assert "pointgnn_tpu_torch." + name in mods, name
    code = textwrap.dedent(
        """
        import importlib, sys
        for blocked in %r:
            sys.modules[blocked] = None
        for name in %r:
            importlib.import_module(name)
        for script in %r:
            importlib.import_module(script)
        bad = sorted(m for m in sys.modules
                     if m == "pointgnn_tpu" or m.startswith("pointgnn_tpu."))
        assert not bad, bad
        for blocked in %r:
            assert sys.modules.get(blocked) is None, blocked
        print("ok", len(%r))
        """ % (BLOCKED, mods, SCRIPTS, BLOCKED, mods)
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imported_names(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_chip_smoke_imports_no_jax():
    assert len(TOOLS) == 7, TOOLS
    for script in ("chip_smoke",) + SCRIPTS:
        names = _imported_names(
            os.path.join(REPO, script.replace(".", os.sep) + ".py"))
        assert any(n.startswith("pointgnn_tpu_torch") for n in names)
        for n in names:
            root = n.split(".")[0]
            assert root not in BLOCKED + ("pointgnn_tpu",), (script, n)
