"""A new mix and a new per-layer metric are found by name, with no file
of the harness edited."""

import json
import pathlib
import shutil

from helpers import tiny_run

BENCH = pathlib.Path(__file__).resolve().parents[1]


def test_added_files_are_found(tmp_path):
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((bench_dir / "traffic" / "stream.json").read_text())
    mix["depth"] = 1
    (bench_dir / "traffic" / "stream_shallow.json").write_text(
        json.dumps(mix))
    (bench_dir / "metrics" / "frames.stream_shallow.py").write_text(
        "def read(ctx):\n    return len(ctx['frames'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "car_auto_T3.stream_shallow", "config": "car_auto_T3",
        "traffic": "stream_shallow", "chips": 1, "why": "test"})
    bench["end_to_end"][1]["workloads"].append("car_auto_T3.stream_shallow")
    bench["per_layer"].append({
        "name": "frames.stream_shallow", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "serve_fps",
        "workloads": ["car_auto_T3.stream_shallow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    where = dict(bench_dir=str(bench_dir), root=str(tmp_path))
    result, _ = tiny_run("car_auto_T3.stream_shallow", trace=1, **where)
    assert result["metrics"]["frames.stream_shallow"]["value"] >= 1
    assert "mfu.stream" not in result["metrics"]
    result, _ = tiny_run("car_auto_T3.stream_shallow", trace=0, **where)
    assert set(result["metrics"]) == {"setup_s", "serve_fps"}
