"""The highest rate a serving cell's server sustains, found once by a sweep
on the card it starts on (one set-up, then each rate in turn):

    python3 nerfbench/sweep.py --workload <name> --seed <n> \
        --rates 6,7,8,9,10 --seconds 20

A rate is sustained when every request is answered and the median latency
of the last third of the requests is within 1.5x that of the first third
(no growing backlog). Each rate prints one JSON line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)

    import torch

    from nerfbench import harness, scene, serve_cell
    if not torch.cuda.is_available():
        harness.note("the sweep runs on a CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    cfg = harness.load("configs", cell["config"])
    traffic = harness.load("traffic", cell["traffic"])
    s = serve_cell.setup(cfg, traffic, args.seed, dev)
    print(json.dumps({"setup_s": time.perf_counter() - T0}), flush=True)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            due = serve_cell.schedule(traffic["arrival_seed"], rate,
                                      args.seconds)
            poses = scene.request_poses(cfg, s["gen"], len(due),
                                        dev).cpu().numpy()
            recs = serve_cell.offer(s["port"], poses, due, traffic,
                                    time.perf_counter())
            lat = [(r["done"] - r["due"]) * 1e3 if r.get("status") == 200
                   else math.inf for r in recs]
            third = max(1, len(lat) // 3)
            first = statistics.median(lat[:third])
            last = statistics.median(lat[-third:])
            ok = all(math.isfinite(x) for x in lat) and last <= 1.5 * first
            print(json.dumps({
                "rate_per_s": rate, "requests": len(lat),
                "answered": sum(math.isfinite(x) for x in lat),
                "p50_ms": serve_cell.percentile(lat, 0.5),
                "p95_ms": serve_cell.percentile(lat, 0.95),
                "first_third_p50_ms": first, "last_third_p50_ms": last,
                "late_ms_max": max((r["sent"] - r["due"]) * 1e3
                                   for r in recs),
                "sustained": bool(ok)}), flush=True)
    finally:
        serve_cell.stop_server(*s["server"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
