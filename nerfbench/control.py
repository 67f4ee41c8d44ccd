"""Readings that set the limits of ``correct``, at a cell's own size on
the card it starts on, several seeds in one process:

    python3 nerfbench/control.py --workload <name> --side <side> \
        --seeds 1,2,3 [--seconds 4]

``program``: the cell's run (a short window at the cell's load), its
compared numbers: the lower readings. ``control``: the reference computed
as float8 e4m3 products, forward and backward, in the program's place
(bf16 is what the configurations state), against the float32 reference.
``half`` (training): the reference with each step's loss averaged over half
of the batch. Each seed prints one JSON line of numbers and ``correct`` as
the cell's limits judge them: a control or a fault has to read false.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def read(bench: dict, cell: dict, side: str, seed: int, seconds: float,
         device, overrides: dict | None = None) -> dict:
    """The compared numbers of one seed on ``side`` (``overrides``: see
    ``harness.run_cell``)."""
    import numpy as np
    import torch

    from nerfbench import check, families, harness, scene, serve_cell
    from nerfbench.reference.common import fp8, fp32, no_tf32
    if side == "program":
        res = harness.run_cell(bench, cell, seed, seconds, False, device,
                               time.perf_counter(), overrides)
        return {**{k: c["value"] for k, c in res["checks"].items()},
                **res["not_compared"]}
    cfg = {**harness.load("configs", cell["config"]), **(overrides or {})}
    traffic = harness.load("traffic", cell["traffic"])
    family = families.get(cfg)
    q = fp8 if side == "control" else fp32
    sc, params0, gen, _ = scene.inputs(cfg, seed, device)
    if traffic["kind"] == "train":

        def run(product, rows):
            return family.reference_run(
                cfg, sc, params0, seed % 2 ** 31, traffic["start_step"],
                traffic["checked_single_steps"], traffic["steps_per_call"],
                product, rows)
        rows = cfg["N_rand"] // 2 if side == "half" else None
        return check.train_numbers(run(q, rows), run(fp32, None))
    if side != "control":
        raise SystemExit("--side half reads a training cell")
    own = harness.load("cells", cell["name"])
    scene.request_poses(cfg, gen, 1 + traffic["batch_max"], device)
    n = len(serve_cell.schedule(traffic["arrival_seed"], own["rate_per_s"],
                                seconds))
    poses = scene.request_poses(cfg, gen, n, device)
    pick = np.random.default_rng(seed).choice(
        n, size=min(traffic["checked_frames"], n), replace=False)
    mae = []
    with no_tf32():
        for k in pick:
            want, got = (check.to_byte(family.reference_frame(
                params0, cfg, poses[k], qq)) for qq in (fp32, q))
            mae.append(check.frame_mae(got, want))
    return {"frame_mae": max(mae)}


def judged(cell: dict, numbers: dict) -> bool:
    """``correct`` of ``numbers`` by the cell's own limits."""
    from nerfbench import check, harness
    return check.judge(numbers, harness.load("cells", cell["name"])
                       ["limits"])[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", choices=("program", "control", "half"),
                   required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)

    import torch

    from nerfbench import harness
    if not torch.cuda.is_available():
        harness.note("the readings are taken on a CUDA device")
        return 2
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers = read(bench, cell, args.side, seed, args.seconds,
                       torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": seed, "correct": judged(cell, numbers),
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
