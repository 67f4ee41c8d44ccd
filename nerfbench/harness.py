"""One run of one cell, driven by data: ``BENCHMARK.json`` names the cell,
its configuration (``configs/<config>.json``, whose ``family`` picks the
model's module ``families/<family>.py``), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` picks ``train_cell`` or
``serve_cell``), the cell's own numbers (``cells/<workload>.json``: the
offered rate, the limits of ``correct``) and the per-layer metrics, each
read by its own ``metrics/<name>/read.py`` from the window's trace.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import torch

from nerfbench import check, flops, serve_cell, train_cell
from nerfbench import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cvnerf_tpu")


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def reports(metric: dict, cell: dict, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or the metric
    lists no cells and the cell reports what it moves (or, end to end,
    every cell)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def read_metric(name: str, trace, ctx: dict):
    """The value of per-layer metric ``name`` by its reader, or None."""
    path = HERE / "metrics" / name / "read.py"
    spec = importlib.util.spec_from_file_location(
        "nerfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace, {**ctx, "dir": path.parent})


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device: torch.device, t0: float,
             overrides: dict | None = None) -> dict:
    """Run the cell once and return its result line's object, with the
    compared numbers beside their limits under ``checks`` (last).
    ``overrides`` (the CPU tests' small sizes) replace keys of the
    configuration."""
    cfg = {**load("configs", cell["config"]), **(overrides or {})}
    traffic = load("traffic", cell["traffic"])
    own = load("cells", cell["name"])
    if traffic["kind"] == "train":
        out = train_cell.run(cfg, traffic, seed, seconds, traced, device, t0)
    else:
        out = serve_cell.run(cfg, traffic, own, seed, seconds, traced,
                             device, t0)
    ok, checks = check.judge(out["numbers"], own["limits"])
    e2e = [m for m in bench["end_to_end"] if reports(m, cell, set())]
    e2e_names = {m["name"] for m in e2e}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if traced:
        tr = out["trace"]
        ctx = {"cfg": cfg, "peak": flops.PEAKS[
            "bf16" if cfg["dtype"] == "bfloat16" else "fp32"],
               **out["context"]}
        metrics = {}
        if not tr.device:
            note("the trace holds no device activity: no per-layer metric")
        for m in bench["per_layer"]:
            if not reports(m, cell, e2e_names) or not tr.device:
                continue
            value = read_metric(m["name"], tr, ctx)
            if value is None:
                note(f"{m['name']}: nothing to read in this trace; left out")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]} for m in e2e}
    result = {"correct": ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = tracing.breakdown(out["trace"])
    note(f"card: {flops.power_limit() if device.type == 'cuda' else 'cpu'}")
    for k, v in out["notes"].items():
        note(f"{k}: {v}")
    result["not_compared"] = {k: v for k, v in out["numbers"].items()
                              if k not in checks}
    result["checks"] = checks
    return result


def note(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the program must not
    load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def report(result: dict) -> None:
    """The compared numbers as the last lines on standard error, the result
    as the last line on standard output."""
    for name, c in result["checks"].items():
        note(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
