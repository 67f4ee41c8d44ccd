"""Run one cell of the benchmark once on the card it starts on:

    python3 nerfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It prints each compared number beside its limit as the last lines on
standard error and one JSON object as the last line on standard output:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled window. It exits non-zero and prints no
result without CUDA (or with fewer cards than the cell asks for), and if
``jax``, ``jaxlib``, ``flax`` or ``cvnerf_tpu`` is loaded once the window
has closed. ``setup_s`` counts from the first line of this file.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from nerfbench import harness
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        harness.note(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                     f"this machine has {cards}")
        return 2
    result = harness.run_cell(bench, cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        harness.note(f"loaded after the window: {', '.join(found)}")
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
