"""One run of one cell: ``main.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.

The harness reads ``BENCHMARK.json`` at the checkout's root and finds
every part of the cell by name: ``configs/<config>.json`` (the
configuration as it is run), ``traffic/<traffic>.json`` (the mix; its
``runner`` names ``loops/<runner>.py``, the general loop that serves
it), ``limits/<config>.<judge>.json`` (the limits of the comparison
that decides ``correct``) and ``metrics/<metric>.py`` (one reader per
per-layer metric).  A later cell adds such files and entries; it edits
none.

The run makes its inputs from the seed, warms up (set-up), measures for
``--seconds``, reads the peak memory, judges a sample of the window's
outputs against the plain reference and prints, as its last lines, the
numbers compared with their limits on standard error and one JSON
object on standard output.  With ``--trace 1`` the window runs under
``torch.profiler`` and the JSON carries the cell's per-layer metrics
instead of its end-to-end ones.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "pointgnn_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def cell_metrics(bench, workload, kind):
    """The cell's ``end_to_end`` or ``per_layer`` entries."""
    out = []
    reported = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


class Context:
    """What a loop module gets: the cell's files, the seed, the device, and
    the set-up clock, the profiler and the reference's pair counts."""

    def __init__(self, args, cfg, mix, device, t_start):
        self.cfg, self.mix = cfg, mix
        self.seed = args.seed
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.device = device
        self.t_start = t_start
        self.setup_s = None

    def mark_setup_done(self, excluded_s=0.0):
        """Set-up ends: its seconds since process start, less
        ``excluded_s`` of the benchmark's own work (the reference)."""
        self.setup_s = time.time() - self.t_start - excluded_s

    def span(self, name):
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def start_profiler(self):
        if not self.trace:
            return None
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def stop_profiler(self, prof, window_span):
        if prof is None:
            return None
        from benchmark.core import trace as trace_lib

        prof.__exit__(None, None, None)
        events = list(prof.profiler.kineto_results.events())
        device, host, window = [], [], None
        for ev in events:
            start = ev.start_ns() / 1e9
            end = start + ev.duration_ns() / 1e9
            if str(ev.device_type()).endswith("CUDA"):
                # the window's own span is mirrored on the device's
                # timeline as an annotation, not an operation
                if ev.name() != window_span:
                    device.append((ev.name(), start, end))
            else:
                if ev.name() == window_span:
                    window = (start, end)
                host.append((ev.name(), start, end))
        if window is None:
            raise RuntimeError("the trace holds no %r span" % window_span)
        return trace_lib.DeviceTrace(device, host, window)

    def memory_peak(self):
        import torch

        if self.device.type != "cuda":
            return 0
        return int(max(torch.cuda.max_memory_allocated(d)
                       for d in range(torch.cuda.device_count())))

    def pool_counts(self, pool_np, cfg, indices):
        """The reference graph's counts of the pool frames ``indices``."""
        from benchmark.reference.pointgnn import FrameGraph

        out = {}
        for i in sorted(indices):
            out[i] = FrameGraph(pool_np[i][0], cfg["config"],
                                self.device).counts
        return out


def card_stamp(device):
    """Lines describing the host's and the card's state (stderr, never
    the result)."""
    import subprocess

    import torch

    lines = []
    try:
        with open("/proc/loadavg") as f:
            load = " ".join(f.read().split()[:3])
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        lines.append("host: %d cpus, torch %d intra-op threads, load %s, "
                     "cpu MHz %.0f-%.0f" % (os.cpu_count(),
                                            torch.get_num_threads(), load,
                                            min(mhz), max(mhz)))
    except (OSError, ValueError) as exc:
        lines.append("host: unreadable (%s)" % exc)
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        lines.append("card: " + res.stdout.strip().replace("\n", " | "))
    except (OSError, subprocess.SubprocessError) as exc:
        lines.append("card: nvidia-smi unavailable (%s)" % exc)
    if device.type == "cuda":
        n = 8192
        a = torch.randn(n, n, device=device, dtype=torch.bfloat16)
        b = torch.randn(n, n, device=device, dtype=torch.bfloat16)
        a @ b
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            a @ b
        end.record()
        end.synchronize()
        tflops = 10 * 2 * n ** 3 / (start.elapsed_time(end) / 1e3) / 1e12
        lines.append("card: bf16 matmul probe %.1f TFLOP/s (8192^3)" % tflops)
        del a, b
        torch.cuda.empty_cache()
    return lines


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, t_start, device, bench_dir=BENCH_DIR, root=ROOT,
             overrides=None):
    """Run one cell on ``device``; returns ``(result dict, check lines)``.
    ``overrides`` (tests) updates the configuration's ``serving`` and the
    mix."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit("unknown workload %r" % args.workload)
    cell = cells[args.workload]
    cfg = load_json(bench_dir, "configs", cell["config"] + ".json")
    mix = load_json(bench_dir, "traffic", cell["traffic"] + ".json")
    if overrides:
        cfg["serving"].update(overrides.get("serving", {}))
        mix.update(overrides.get("mix", {}))
    runner = load_module(os.path.join(bench_dir, "loops",
                                      mix["runner"] + ".py"),
                         "benchmark_loop_" + mix["runner"])
    ctx = Context(args, cfg, mix, device, t_start)
    out = runner.run(ctx)
    limits = load_json(bench_dir, "limits",
                       "%s.%s.json" % (cell["config"], out["judge"]))
    from benchmark.core import judge

    numbers = out["numbers"]
    correct = judge.verdict(numbers, limits)

    metrics = {}
    if not ctx.trace:
        e2e = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        pl = out["per_layer"]
        for m in cell_metrics(bench, args.workload, "per_layer"):
            reader = load_module(
                os.path.join(bench_dir, "metrics", m["name"] + ".py"),
                "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(pl)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}

    import torch

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type, "kind": kind,
                         "count": cell.get("chips", 1),
                         "memory_peak_bytes": int(out["memory_peak"])}}
    if ctx.trace:
        tr = out["per_layer"]["trace"]
        from benchmark.core.trace import top

        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": top(tr.time_by_name()),
            "idle_gaps": top(tr.idle_gaps(ignore=(out["span"],))),
        }
    checks = {name: {"value": float(numbers[name]),
                     "limit": float(limits[name])} for name in judge.NUMBERS}
    result["checks"] = checks
    lines = ["reference %s: %s" % (name, " ".join(
        "%s %.6g" % kv for kv in sorted(nums.items())))
        for name, nums in sorted(out.get("detail", {}).items())]
    lines += ["check %s %.6g limit %.6g" % (name, c["value"], c["limit"])
              for name, c in checks.items()]
    return result, lines


def main(argv, t_start):
    args = parse(argv)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark runs only on a GPU",
              file=sys.stderr)
        return 2
    bench = load_json(ROOT, "BENCHMARK.json")
    chips = {w["name"]: w.get("chips", 1) for w in bench["workloads"]}
    need = chips.get(args.workload, 1)
    if torch.cuda.device_count() < need:
        print("benchmark: %s needs %d GPUs, %d visible"
              % (args.workload, need, torch.cuda.device_count()),
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, lines = run_cell(args, t_start, device)
    for line in card_stamp(device):
        print(line, file=sys.stderr)
    found = forbidden_modules()
    if found:
        print("benchmark: forbidden modules loaded: %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
