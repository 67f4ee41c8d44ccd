"""Time the port's bf16 forward kernel (``cvnerf_torch.ops.fused_mlp.
fused_nerf_apply``) of one or more checkouts of this repo on one NVIDIA card,
in turns, at the four shapes of the main paths: a serving coarse chunk
(8192 rays x 64 = 524,288 points), a serving fine chunk (x 192 =
1,572,864), a train step's coarse pass (1024 x 64 = 65,536) and fine pass
(1024 x 192 = 196,608). The lego-shaped net (trunk 256, head 128, L = 10/4)
with seeded random weights. With ``--int8``, the int8 forward kernel
(``cvnerf_torch.ops.fused_mlp_int8.fused_nerf_apply_int8``) instead, on the
net quantized on the card from calibration points a seeded torch generator
draws (not the checkout's own draws, which may differ), at the shapes
of the int8 serving path (the two serving chunks) and a ragged n = 65,573.
With ``--bwd``, the bf16 backward (``cvnerf_torch.ops.fused_mlp_bwd.
fused_nerf_bwd``) at a train step's coarse and fine passes, with seeded
upstream gradients: the whole backward by CUDA events and, from
``torch.profiler`` over 3 more launches, its pass 1 (the kernel whose name
holds ``fused_nerf_bwd``) and the rest (the weight gradients,
``reduce_slabs``, the workspace's memset). With ``--fp32``, the fp32
forward (the ``--no-bf16`` path) at the four shapes above and a ragged
n = 65,573; with ``--fp32 --bwd``, the fp32 backward at the train passes
and n = 65,573. An fp32 kernel's sums may change order between versions,
so fp32 turns print, beside each hash, the output's distance from the
plain version on the same inputs (forward: max abs error; backward: the
largest per-leaf error relative to the leaf's largest gradient).

    python3 scripts/time_forward_kernel.py [--int8 | --bwd | --fp32 [--bwd]] ROOT [ROOT ...]

Each ROOT is a checkout (for example a parent commit unpacked with
``git archive``); each runs in its own process, in the order given, so
``parent change change parent`` compares two versions on one card. Prints
the card's name and power limit, then one JSON line per ROOT with the
median milliseconds of 7 launches (CUDA events, after 2 warm-up launches)
at each shape, and a hash of each shape's output (checkouts whose kernels
are bitwise equal to one plain version print equal hashes). Exits non-zero
when there is no card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {"serve_coarse": 8192 * 64, "serve_fine": 8192 * 192,
          "train_coarse": 1024 * 64, "train_fine": 1024 * 192}
INT8_SHAPES = {"serve_coarse": 8192 * 64, "serve_fine": 8192 * 192,
               "ragged": 2 ** 16 + 37}
BWD_SHAPES = {"train_coarse": 1024 * 64, "train_fine": 1024 * 192}
FP32_SHAPES = {**SHAPES, "ragged": 2 ** 16 + 37}
FP32_BWD_SHAPES = {**BWD_SHAPES, "ragged": 2 ** 16 + 37}
KINDS = {("--int8",): "int8", ("--bwd",): "bwd", ("--fp32",): "fp32",
         ("--fp32", "--bwd"): "fp32_bwd"}


def split_ms(apply, reps: int = 3) -> dict:
    """Device ms per call of the backward's pass 1 and of its other
    kernels, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            apply()
        torch.cuda.synchronize()
    out = {"pass1": 0.0, "rest": 0.0}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            key = "pass1" if "fused_nerf_bwd" in e.key else "rest"
            out[key] += e.self_device_time_total / reps / 1e3
    return out


def time_one(root: str, kind: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch
    from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params
    from cvnerf_torch.ops import fused_mlp as fm
    from cvnerf_torch.ops.rng import PRNGKey
    if not Path(fm.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise SystemExit(f"imported {fm.__file__}, not the checkout {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NerfMLPConfig()
    params = init_nerf_params(PRNGKey(0), cfg, "cuda")
    plain = None
    if kind in ("bwd", "fp32_bwd"):
        from cvnerf_torch.ops import fused_mlp_bwd as fb
        dt = torch.float32 if kind == "fp32_bwd" else torch.bfloat16
        w = fm.FusedNerfWeights(params, cfg, dt)
        shapes = FP32_BWD_SHAPES if kind == "fp32_bwd" else BWD_SHAPES

        def apply(pts, dirs, g):
            return fb.fused_nerf_bwd(w, pts, dirs, g)

        if kind == "fp32_bwd":
            def plain(pts, dirs, g, res):
                got = fb.unpack_grads(res, cfg, dt)
                want = fb.fused_nerf_bwd_plain(params, pts, dirs, g, cfg, dt)
                return max(((got[k][p] - want[k][p]).abs().max()
                            / want[k][p].abs().max().clamp_min(1e-30)).item()
                           for k in want for p in ("w", "b"))
    elif kind == "int8":
        from cvnerf_torch.ops import fused_mlp_int8 as fq
        from cvnerf_torch.ops import quantize as tq
        # Calibration points from a seeded torch generator, not the
        # checkout's own draws, so that every checkout quantizes the same
        # weights and equal hashes mean equal kernels.
        cal = torch.Generator().manual_seed(6)
        cpts = (torch.rand(1 << 17, 3, generator=cal) * 12 - 6).cuda()
        cdirs = torch.nn.functional.normalize(
            torch.randn(1 << 17, 3, generator=cal), dim=-1).cuda()
        qw = fq.QuantizedNerfWeights(tq.quantize_nerf(params, cfg, cpts,
                                                      cdirs), cfg)
        shapes = INT8_SHAPES

        def apply(pts, dirs, g):
            return fq.fused_nerf_apply_int8(qw, pts, dirs)
    else:
        dt = torch.float32 if kind == "fp32" else torch.bfloat16
        w = fm.FusedNerfWeights(params, cfg, dt)
        shapes = FP32_SHAPES if kind == "fp32" else SHAPES

        def apply(pts, dirs, g):
            return fm.fused_nerf_apply(w, pts, dirs)

        if kind == "fp32":
            def plain(pts, dirs, g, res):
                return (res - fm.fused_nerf_plain(params, pts, dirs, cfg, dt)
                        ).abs().max().item()
    gen = torch.Generator().manual_seed(1)
    grads = torch.Generator().manual_seed(2)
    out, digest, split, err = {}, {}, {}, {}
    for name, n in shapes.items():
        pts = (torch.randn(n, 3, generator=gen) * 2).cuda()
        dirs = torch.nn.functional.normalize(
            torch.randn(n, 3, generator=gen), dim=-1).cuda()
        g = ((torch.randn(n, 4, generator=grads) * 1e-3).cuda()
             if kind in ("bwd", "fp32_bwd") else None)
        res = apply(pts, dirs, g)
        digest[name] = hashlib.sha256(res.cpu().numpy().tobytes()
                                      ).hexdigest()[:16]
        if plain is not None:
            err[name] = plain(pts, dirs, g, res)
        apply(pts, dirs, g)
        torch.cuda.synchronize()
        times = []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            apply(pts, dirs, g)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = float(np.median(times))
        if kind in ("bwd", "fp32_bwd"):
            split[name] = split_ms(lambda: apply(pts, dirs, g))
    res = {"root": root, "kernel": kind, "ms": out, "output_sha256": digest}
    if split:
        res["split_ms"] = split
    if err:
        res["err_vs_plain"] = err
    return res


def main() -> int:
    args = sys.argv[1:]
    kind = "bf16"
    for flags, name in sorted(KINDS.items(), key=lambda kv: -len(kv[0])):
        if tuple(args[:len(flags)]) == flags:
            kind, args = name, args[len(flags):]
            break
    if len(args) > 1 and args[0] == "--one":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card")
        print(json.dumps(time_one(args[1], kind)), flush=True)
        return 0
    if not args:
        raise SystemExit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    for root in args:
        flags = next((list(f) for f, k in KINDS.items() if k == kind), [])
        res = subprocess.run([sys.executable, __file__] + flags
                             + ["--one", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"{root}: {res.stderr[-3000:]}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
