"""``main.py`` refuses to run without a card or without the program."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    res = subprocess.run(
        [sys.executable, str(BENCH / "main.py"), "--workload",
         "car_auto_T3.stream", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_fails_with_only_the_benchmark_files(tmp_path):
    """In a checkout of ``BENCHMARK.json`` and ``benchmark/`` alone, the
    run stops where it needs the program, and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, argparse, time, torch; sys.path.insert(0, %r); "
            "from benchmark.core import harness; "
            "harness.run_cell(argparse.Namespace(workload="
            "'car_auto_T3.stream', seed=1, seconds=1.0, trace=0), "
            "time.time(), torch.device('cpu'))" % str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": os.environ.get("PATH", ""),
                              "HOME": str(tmp_path)})
    assert res.returncode != 0
    assert "pointgnn_tpu_torch" in res.stderr
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (BENCH / "configs" / (w["config"] + ".json")).is_file()
        assert (BENCH / "traffic" / (w["traffic"] + ".json")).is_file()
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / (m["name"] + ".py")).is_file()
