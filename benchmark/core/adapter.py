"""Hands the benchmark's inputs to the program: its parameter tree and
its serving pipeline, built as ``run_torch.py --fast`` builds them."""

import numpy as np


def program_params(weights):
    """The program's parameter tree (``params[scope][mlp][i] = {"w", "b",
    "norm"}``, ``params["output"]["loc"][c][i]``) holding copies of the
    benchmark's weights, so the program cannot change the reference's."""
    tree = {}
    for (scope, name, i), (w, b) in sorted(
            weights.items(), key=lambda kv: (kv[0][0], str(kv[0][1]),
                                             kv[0][2])):
        layer = {"w": w.clone(), "b": b.clone(), "norm": None}
        if isinstance(name, tuple):
            loc = tree.setdefault(scope, {}).setdefault("loc", [])
            while len(loc) <= name[1]:
                loc.append([])
            mlp = loc[name[1]]
        else:
            mlp = tree.setdefault(scope, {}).setdefault(name, [])
        assert len(mlp) == i, (scope, name, i)
        mlp.append(layer)
    return tree


def serving_pipeline(cfg, params, device):
    """``InferencePipeline`` on device-built slab graphs at the
    configuration's serving spec."""
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import InferencePipeline

    serving = cfg["serving"]
    spec = db.spec_from_config(
        cfg["config"], num_points=serving["num_points"],
        num_keypoints=serving["num_keypoints"],
        cell_caps=tuple(serving["cell_caps"]),
        per_center_caps=tuple(serving["per_center_caps"]))
    return InferencePipeline(
        cfg["config"], params=params, device_spec=spec,
        compute_dtype=serving["compute_dtype"], device=device,
        use_box_merge=serving["use_box_merge"],
        use_box_score=serving["use_box_score"],
        max_hypotheses=serving["max_hypotheses"], slab=serving["slab"],
        on_device_graph=serving["on_device_graph"])


def points(xyz, attr):
    from pointgnn_tpu_torch.core.points import Points

    return Points(xyz=np.asarray(xyz, np.float32),
                  attr=np.asarray(attr, np.float32))
