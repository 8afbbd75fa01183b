#!/usr/bin/env python3
"""Same-process sweep of ``slab_edge_max``'s ``block_centers`` on a
serving workload.

The CUDA K1 (``pointgnn_tpu_torch/csrc/slab_edge_max.cu``) takes one
tuning knob, ``block_centers``: the center blocks whose per-column row
windows the pair kernel walks.  The pair list it builds is exact, so
every value gives the same outputs; only the windows' waste and the walk
change.  This tool streams a synthetic workload through
``InferencePipeline(slab_tuning=...).stream(raw=True)`` once per variant
in one process, checks that each variant's raw outputs are bitwise the
default's, re-measures the default at the end to show drift, and prints
the ``slab_tuning`` to pass to ``InferencePipeline`` when a variant beats
the default by more than 3%.

Variants are ``block_centers`` values, each optionally for one level
(``l0:16`` tunes level 0 only, ``l1:64`` level 1 only).  The JAX tool's
``BKxTILE`` form is refused: the tile has no CUDA counterpart.

Usage:
    python tools_torch/tune_slab_kernels.py [--label_method Car] [--T 3] \\
        [--num_points 24576] [--num_keypoints 12288] \\
        [--variants 16,64,l1:16] [--frames 24] [--device cuda]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def parse_variants(text):
    """``"16,l0:8,l1:64"`` -> ``[{"block_centers": 16}, {"level0":
    {"block_centers": 8}}, {"level1": {"block_centers": 64}}]``."""
    out = []
    for raw in text.split(","):
        tok = raw.strip().lower()
        if not tok:
            continue
        level = None
        if ":" in tok:
            level, _, tok = tok.partition(":")
            if level not in ("l0", "l1"):
                raise ValueError(
                    "bad variant %r: level prefix must be l0: or l1:"
                    % raw.strip()
                )
        if "x" in tok:
            raise ValueError(
                "bad variant %r: BKxTILE sets the TPU kernel's tile, which "
                "the CUDA slab_edge_max does not have; give block_centers "
                "alone, e.g. 16" % raw.strip()
            )
        if not tok.isdigit() or int(tok) < 1:
            raise ValueError(
                "bad variant %r: expected [l0:|l1:]BLOCK_CENTERS with "
                "BLOCK_CENTERS >= 1, e.g. 16" % raw.strip()
            )
        tuning = {"block_centers": int(tok)}
        if level:
            tuning = {{"l0": "level0", "l1": "level1"}[level]: tuning}
        out.append(tuning)
    return out


def name_of(tuning):
    """A row's label: ``default(32)``, ``16``, ``level0:16``, ..."""
    from pointgnn_tpu_torch.nn.slab import DEFAULT_BLOCK_CENTERS

    if tuning is None:
        return "default(%d)" % DEFAULT_BLOCK_CENTERS
    if isinstance(tuning, str):
        return tuning
    if "block_centers" in tuning:
        return "%d" % tuning["block_centers"]
    return ",".join("%s:%d" % (lv, t["block_centers"])
                    for lv, t in sorted(tuning.items()))


def stream_rate_ms(pipe, frames, n):
    """``(ms per frame, raw outputs)`` of ``n`` frames through
    ``pipe.stream(raw=True)``, after a 4-frame warm-up."""
    seq = [frames[i % len(frames)] for i in range(n)]
    for _ in pipe.stream(seq[:4], raw=True):
        pass
    t0 = time.perf_counter()
    outs = list(pipe.stream(seq, raw=True))
    return (time.perf_counter() - t0) / n * 1e3, outs


def sweep(config, spec, variants, frames, n, device=None):
    """Rows ``(tuning, ms per frame)``: the default (None), each variant,
    then the default again (``"baseline-recheck"``).  Raises
    ``AssertionError`` when a variant's raw outputs are not bitwise the
    default's."""
    import numpy as np

    from pointgnn_tpu_torch.infer import InferencePipeline

    params = None

    def measure(tuning):
        nonlocal params
        pipe = InferencePipeline(
            config, params=params, on_device_graph=True,
            use_box_score=False, device_spec=spec, slab_tuning=tuning,
            device=device,
        )
        params = pipe.params
        if not pipe.slab:
            raise RuntimeError(
                "slab_edge_max is off for this config (slab resolved "
                "False): every variant would time the same program")
        return stream_rate_ms(pipe, frames, n)

    ms, base_outs = measure(None)
    rows = [(None, ms)]
    for tuning in variants + ["baseline-recheck"]:
        ms, outs = measure(None if tuning == "baseline-recheck" else tuning)
        for i, (a, b) in enumerate(zip(base_outs, outs)):
            if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(
                    "variant %s: frame %d's outputs differ from the "
                    "default's" % (name_of(tuning), i))
        rows.append((tuning, ms))
    return rows


def suggestion(rows):
    """The best row's tuning when it beats the default by more than 3%
    (the recheck row excluded), else None."""
    base = rows[0][1]
    best = min(rows[:-1], key=lambda r: r[1])
    if best[0] is not None and best[1] < 0.97 * base:
        return best[0]
    return None


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="slab_edge_max block_centers sweep"
    )
    parser.add_argument("--label_method", default="Car")
    parser.add_argument("--T", type=int, default=3)
    parser.add_argument("--num_points", type=int, default=24576)
    parser.add_argument("--num_keypoints", type=int, default=12288)
    parser.add_argument(
        "--variants", default="16,64,8",
        help="comma-separated [l0:|l1:]BLOCK_CENTERS list to try against "
             "the default",
    )
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--device", default="cuda",
                        help="torch device (cpu runs the plain versions)")
    args = parser.parse_args(argv)
    try:  # fail on typos before building anything
        variants = parse_variants(args.variants)
    except ValueError as exc:
        parser.error(str(exc))

    from tools_torch.profile_inference import matmul_probe_tflops

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    config = configs.model_config(args.label_method, T=args.T)
    spec = db.spec_from_config(
        config, num_points=args.num_points,
        num_keypoints=args.num_keypoints, per_center_caps=(32, 192),
    )
    frames = [synthetic_lidar_frame(seed=i, points_per_beam=380)[0]
              for i in range(8)]
    print("matmul rate stamp: %.1f TFLOP/s"
          % matmul_probe_tflops(args.device))
    rows = sweep(config, spec, variants, frames, args.frames, args.device)
    base = rows[0][1]
    for tuning, ms in rows:
        print("  %-18s %7.2f ms/frame  (%+5.1f%%)"
              % (name_of(tuning), ms, 100.0 * (ms - base) / base))
    print("raw outputs of every variant bitwise equal to the default's")
    print("matmul rate stamp after: %.1f TFLOP/s"
          % matmul_probe_tflops(args.device))
    best = suggestion(rows)
    if best is not None:
        print("suggested slab_tuning: %s" % json.dumps(best))
    else:
        print("default tuning stands (no variant beat it by >3%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
