#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's files are found by name
(`harness/registry`): its workload file names its configuration and its
driver. The run makes its inputs and weights from the seed, warms up the
cell's shapes (set-up), measures for --seconds, then judges what the
timed path produced against the plain reference. With --trace 0 the
result carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read from the device trace of the window. The
numbers compared, each with its limit, are the last lines on standard
error and the last key of the result, the last line on standard output.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# JAX must stay out of the process that is measured
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gesture2vec_tpu")
TRACE_WINDOW_S = 10.0


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so only a checkout's first run builds; libraries that could load JAX
    are told not to."""
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Context:
    """What a driver gets: the cell's files, the run's arguments, and the
    device's hooks (a test drives the same run on the CPU)."""

    def __init__(self, cell, workload, config, seed, seconds, trace,
                 device="cuda", t0=T0, control=False):
        self.cell, self.workload, self.config = cell, workload, config
        self.seed, self.trace = seed, trace
        # the window: a traced run traces at most TRACE_WINDOW_S of it, so
        # the trace's reading stays inside the run's time limit
        self.seconds = min(seconds, TRACE_WINDOW_S) if trace else seconds
        self.device, self.t0 = device, t0
        # also judge the control (the reference one precision below, in
        # the program's place): calibration only, never a benchmark run
        self.control = control

    @property
    def on_card(self) -> bool:
        return str(self.device).startswith("cuda")

    def sync(self) -> None:
        import torch

        if self.on_card:
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated()) if self.on_card else 0

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def settle(self) -> None:
        """The end of set-up: set-up's garbage is collected before the
        window opens. The program then runs as its entry points run it
        (PyTorch's default threads, the collector as it is)."""
        import gc

        gc.collect()

    def tracer(self):
        from portbench.harness.trace import Tracer

        return Tracer()

    def device_clock(self, lap_every: int):
        """The card's busy time over an untraced window, read every
        lap_every units of work (None without a card, and in a traced
        run, whose tracer records the card)."""
        from portbench.harness.trace import DeviceClock

        return DeviceClock(lap_every) if self.on_card and not self.trace \
            else None


def execute(ctx: Context, bench: dict) -> dict:
    """Drive the cell and judge it: the result line's keys, and the
    numbers compared as [name, value, limit]."""
    from portbench.harness import registry

    out = registry.driver(ctx.workload["driver"]).run(ctx)
    limits = ctx.workload["limits"]
    checks = [[name, float(out["readings"][name]), float(limit)]
              for name, limit in limits.items()]
    # a refused or failed request is counted in `failed` and in the
    # latency it misses; an answer is judged by what it says
    correct = all(v <= lim for _, v, lim in checks)
    if ctx.trace:
        record = {**out["record"], "cell": ctx.cell, "config": ctx.config}
        metrics = registry.read_metrics(
            registry.per_layer_of(bench, ctx.cell), record)
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in registry.end_to_end_of(bench, ctx.cell)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"]}}
    host = out["record"].get("host")
    if host is not None:
        result["host"] = host
    trace = out["record"].get("trace")
    if trace is not None:
        result["device"]["busy_s"] = trace.busy_s()
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    from portbench.harness import registry

    bench = registry.benchmark()
    entry = registry.cell_entry(bench, args.workload)
    workload = registry.workload(args.workload)
    config = registry.config(entry["config"])

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < entry["chips"]:
        print(f"portbench: the cell needs {entry['chips']} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    # the configurations state float32: no TF32 in the program either
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(args.workload, workload, config, args.seed, args.seconds,
                  bool(args.trace))
    result = execute(ctx, bench)
    from portbench.work.peaks import power_limit_w

    # the card's power limit beside every number of the run: a card set
    # below 700 W runs slower under load
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": entry["chips"], **result["device"],
                        "power_limit_w": power_limit_w()}
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    if "host" in result:
        print(f"host {json.dumps(result['host'])}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
