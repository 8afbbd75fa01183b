"""The KITTI AP evaluator (counterpart of
:mod:`pointgnn_tpu.postprocess.kitti_eval`).

The executable is the port's copy of the JAX package's evaluator,
``csrc/host/evaluate_object.cpp`` (official-protocol AP for 2D boxes,
bird's-eye view and 3D boxes at easy / moderate / hard, 11- and 40-point
interpolation).  At first use the host C++ compiler (``$CXX``, else
``c++``) builds it with the JAX package's flags (``-O3 -march=native
-std=c++17``) into ``build/torch_kernels/``, named by a hash of the
source, the flags and the target (:func:`native.build_target`), so an
edited source is rebuilt.  A failed build raises with the compiler's
output: there is no prebuilt binary to fall back to.

    evaluate_object_offline <gt_dir> <result_dir>

reads the label files of ``gt_dir`` and the detections under
``<result_dir>/data/``, writes ``<result_dir>/stats_<class>_ap.txt`` and
prints one line per class, metric and difficulty, which
:func:`evaluate` parses.
"""

import re
import subprocess
from typing import Dict

from pointgnn_tpu_torch.postprocess import native

SOURCE = native.HOST_DIR / "evaluate_object.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17"]

_LINE_RE = re.compile(
    r"^(\w+)_(detection|bev|3d)_(easy|moderate|hard) "
    r"AP: ([\d.]+) AP_R40: ([\d.]+)"
)


def binary_path(cxx=None, build_dir=native.BUILD_DIR) -> str:
    """The evaluator executable, built from ``SOURCE`` unless it exists
    for this source, flags and target.  Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    return str(native.build_target(
        cxx, (SOURCE,), CXX_FLAGS, "evaluate_object_offline", "",
        build_dir))


def evaluate(gt_dir: str, result_dir: str) -> Dict[str, Dict[str, float]]:
    """Run the evaluator; returns
    ``{"<Class>_<metric>_<difficulty>": {"ap": x, "ap_r40": y}}``."""
    out = subprocess.run(
        [binary_path(), gt_dir, result_dir],
        check=True,
        capture_output=True,
        text=True,
    ).stdout
    results = {}
    for line in out.splitlines():
        m = _LINE_RE.match(line)
        if m:
            key = "%s_%s_%s" % (m.group(1), m.group(2), m.group(3))
            results[key] = {
                "ap": float(m.group(4)),
                "ap_r40": float(m.group(5)),
            }
    return results
