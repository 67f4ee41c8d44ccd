"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; no phase is caught and passed over):
  1. build every kernel from the checkout's sources (``nvcc``, one process
     per source, all started together), print ptxas' registers and spills
     of the bf16, fp32 and int8 forward kernels and of both backwards' pass
     1 and weight-gradient kernels (a spill fails), and hold the forward
     kernel against its plain PyTorch version on the card at full width, in
     fp32 and bf16: at ragged sizes around the dtype's tiles (fp32 64
     points, bf16 128) and one-block-per-SM grid (1, tile - 1, tile + 1, a
     full wave of tiles + 1, 65,573), the serving chunks and a train step's
     shapes, each case launched twice and bitwise equal, its launch plan
     the host's; time both with CUDA events (median of >= 5 runs after
     warm-up), and beside the fine chunk the same products unfused through
     ``torch.matmul`` in the same dtype (``gemm_chain_ms``, a yardstick of
     cuBLAS on these shapes; fp32 without TF32);
  1b. hold the backward kernel against its plain version at full width, in
     fp32 and bf16 (a ragged n, the train step's coarse and fine shapes and
     a ragged n past one chunk), per leaf relative to the leaf's largest
     gradient, check that two launches on the same inputs agree bitwise and
     that its launch plan is the host's, and time both, the kernel also
     split into pass 1 and the rest by ``torch.profiler``;
     at the ragged n also print what the tolerances rest on (two plain
     versions, two halves against the whole, a planted fault) and check the
     ragged tail's points alone;
  1c. hold the int8 kernel against its plain version at full width: the
     phase-1 net quantized on the card from ``calibration_samples``, at the
     ragged n of phase 1 and the serving chunks (coarse 8192 x 64, fine
     8192 x 192); bitwise with power-of-two head scales and zero head
     biases, within TOL_INT8 with the real scales, bitwise over two
     launches, its launch plan the host's; time both, and beside the fine
     chunk the same int8 products unfused through ``torch._int_mm``
     (``int8_gemm_chain_ms``, a yardstick of cuBLASLt on these shapes);
  2. serve: write a run directory for the lego serving shape (400x400,
     focal 555, near 2, far 6, white background, 64 + 128 samples, bf16,
     the full-width MLP) with seeded random weights and a few camera poses
     for int8 calibration, start the port's HTTP server from its own
     argument parser with ``--device cuda``, and send ``GET /health`` and
     three ``POST /render`` (png, json with depth, factor 2);
  2b. serve int8: start the server from the same run directory with
     ``--int8`` (calibrated on the run's poses by the step ``main`` runs),
     send ``GET /health`` and ``POST /render`` as png and as json with
     depth; then hold the served frame bitwise against the same pose
     rendered on the card with ``kernels="off"`` from the same quantized
     nets, compare it with phase 2's bf16 frame (each pixel whose last
     sample flips witnessed by its terminal density's sign), and time
     phase 3's pose sequence under int8;
  3. render a two-pose sequence through ``NerfRenderer.render_video``;
  3b. serve fp32 (the ``--no-bf16`` path): the server's renderer from a run
     directory whose snapshot says ``"bf16": false`` renders one 400x400
     frame (40 fp32 forward launches, no plain call; wall time printed);
  4. render one small frame with the kernel and with ``kernels="off"`` on
     the card and compare them;
  5. train (main path): ``create_train_state`` and ``Trainer.run`` for
     TRAIN_STEPS steps of the lego-shaped workload (400x400 bench scene,
     1024 rays, 64 + 128 samples, perturb, bf16, full width, Adam lr 5e-4,
     lr_decay 500), split a few more steps' device time by kernel with
     ``torch.profiler`` (the backward's pass 1 must be
     ``fused_nerf_bwd_wgmma`` alone), then render one 400x400 frame of the
     trained params;
  5b. train fp32 (the ``--no-bf16`` path): TRAIN_STEPS_FP32 steps of the
     same workload in fp32 through ``Trainer`` (2 + 2 launches a step, no
     plain call), the step time and a profiler split whose pass 1 must be
     ``fused_nerf_bwd_ffma`` alone;
  6. one train step with the kernels and with ``kernels="off"`` from the
     same state and key, in fp32 and in bf16, compared;
  7. the training entry point (main path): write an 800x800 Blender
     fixture with the port's generator (lego's camera angle, so
     ``configs/lego.txt``'s half_res gives 400x400), then through
     ``cvnerf_torch.cli.main``: 60 bf16 steps with validation at 30 and 60,
     checkpoints at 30 and 60 and the test eval; a second run stopped at
     its step-30 checkpoint and resumed to 60, whose final checkpoint must
     equal the first's bitwise; ``--render_only --render_test`` (the test
     PSNR logged by the run, exactly); ``--render_only --int8``;
     ``NerfRenderer.from_run_dir`` serving the run (params bitwise the
     checkpoint's); 3 steps under ``--no-bf16``; the checkpoint writer's
     enqueue and drain times;
  8. the training levers (main path), each alone at phase 5's lego shape
     in bf16: ``ema_decay`` 0.999, ``noise_decay`` 100 (with density noise
     1.0), ``freq_anneal`` 100, ``distortion_loss`` 0.01 (start 1, ramp
     2), ``occlusion_loss`` 0.01, ``ray_batching``, ``pixel_sampling=
     "parity"``: 3 steps through the kernels, each held against the same
     step with ``kernels="off"`` at phase 6's bf16 tolerances, exactly 2 +
     2 launches a step; 4 rounds of 8 steps with each lever and 8 plain
     steps (density noise 1.0 in ``noise_decay``'s plain step), the order
     alternating each round, with the medians, the spread of the rounds
     and the ops a profiled step of the lever grew most; the pixel draws'
     cost; then through the CLI,
     ``--ema_decay 0.999 --freq_anneal 40`` on phase 7's fixture, a run
     stopped at step 30 and resumed equal bitwise (the EMA slot included)
     to an uninterrupted one, and ``from_run_dir`` at the mid-anneal step
     30 serving the average through the window;
  9. a quality band (main path): ``sphere_hi_3000`` through
     ``cvnerf_torch.quality_run`` at full width, passing at or above the
     band's floor (29.24 dB; the JAX package measured 30.24);
  10. occupancy grids, the mesh and LPIPS (main paths): a. the bake of
     phase 5's trained bf16 fine net at res 192, dilate 1, bound 1.5
     (108 forward launches, no plain call; against kernels="off" at phase
     1's bf16 tolerance; occupied share > 0; median ms); b. the server with
     ``--occupancy merge`` and ``full`` (trilinear and nearest) and ``full
     --occ_term 1e-3 --serve_coarse 32 --serve_fine 64``, each answering
     /render at 400x400 (the startup bake 108 launches, then 20 fine and
     no coarse launches a frame, no plain call), each frame against
     kernels="off" through the same grid at phase 4's bf16 tolerances on
     every pixel but those whose terminal density changes sign, frame ms
     beside the plain bf16 server's; c. ``--int8 --occupancy merge`` (the
     bake in float, 20 int8 launches a frame, bitwise against
     kernels="off"); d. three occupancy steps against kernels="off" (1 + 1
     launches each, the coarse net unchanged) and the occupancy step timed
     against the plain step in interleaved rounds, then ``--occ_train
     --occ_train_warmup 20 --occ_train_every 20`` through the CLI on phase
     7's fixture (2 + 2 launches a step before the switch, 1 + 1 after,
     the verdicts, the coarse net bitwise the switch's checkpoint's, a run
     stopped at 40 and resumed in occupancy mode, a full-mode run with
     ``--occ_floor 16``, ``from_run_dir`` through a grid); e. ``python -m
     cvnerf_torch.render.mesh --run`` phase 7's run at res 256 (256
     forward launches; the grid against kernels="off"; the mesh's size
     and the host marching seconds); f. LPIPS of two occupancy frames with
     seeded random weights, card against CPU within 1e-5 relative;
  11. ray-sharded data parallelism (main paths): a. a two-shard mesh of
     the one card (``make_mesh(devices=["cuda:0", "cuda:0"])``): 3 lego
     bf16 steps (512 rays a shard), each against the unsharded step from
     the same state at phase 6's bf16 tolerances, exactly 2 + 2 launches a
     shard a step; ``NerfRenderer(use_mesh=<the mesh>)`` serving phase 7's
     run at 400x400 against the unsharded renderer (bf16 within phase 4's
     tolerances, the unequal values counted; int8 bitwise; 2 launches a
     chunk a shard); the sharded and unsharded step and frame timed; b. a
     one-rank NCCL world through the CLI (``--coordinator localhost:<free
     port> --num_processes 1 --process_id 0``, phase 7's run cut to 30
     steps: every step 2 + 2, every frame 80, its step-30 checkpoint
     bitwise phase 7's), then in a world of the script's own a second
     ``initialize_distributed`` refused while it is live and 3 ``Trainer``
     steps with ``fused_allreduce`` bitwise the per-leaf all-reduce, and
     whether the NCCL all-reduce was captured in the CLI's blocks;
  12. blocks of steps as CUDA-graph replays (``make_train_scan``, the
     CLI's ``--steps_per_call 10``, which phases 7-11's CLI runs use), with
     every draw on the card: a. the draw kernels (``threefry_bits``,
     ``feistel_draw``, ``csrc/threefry.cu``) against their plain versions,
     bitwise over two launches, at the key derivations', the lego step's
     ray streams' and the Feistel draws' shapes (m = 2^k, 2^k +- 1, the
     200, 400 and 800 pixel grids, the 8 x 800 x 800 ray-batching pool),
     ptxas spills 0, timed against their plain versions; b. ``Trainer(
     steps_per_call=10)`` against single steps from one state at phase 5's
     shape across the precrop switch and two callbacks (plain; occupancy
     with a rebake copied in at a callback; EMA + anneal; noise,
     regularizers and ray batching; parity; a two-shard mesh of the one
     card): params, moments, count, step and EMA slot bitwise, no plain
     call, each captured step launching what an eager step launches (2 +
     2, 1 + 1 through a grid, 2 + 2 a shard); c. eager
     steps and blocks of 10 one-step graph replays in interleaved rounds,
     median ms a step, the profiler's idle share, the capture seconds and graph pool
     bytes; d. phase 7's run at
     ``--steps_per_call 1``: its checkpoints at 30 and 60 bitwise phase
     7's at 10; e. Adam's update of every leaf in one launch (``fused_adam``,
     ``csrc/adam.cu``) against its plain version on the card at the lego
     nets' 48 leaves: p, m and v bitwise at update counts 0, 1, 2, 499 and
     500 with random, zero and large gradients, and one launch captured in
     a CUDA graph replayed over three scalar rows; ptxas registers and
     spills (a spill fails); the kernel, the plain version (672 launches)
     and a ``torch._foreach_*`` Adam (the yardstick) timed through CUDA
     graphs of launches;
  14. the Instant-NGP field (``models/ngp_field.py``): a. its kernels at
     the published widths (16 levels, 2^19 entries a level) and a train
     step's two encodings (65,536 and 196,608 samples): ``hash_encode_fwd``
     bitwise its plain version in float32 and bfloat16,
     ``hash_encode_bwd`` per level within 1e-4 of the level's largest
     plain gradient, ``fused_adam``'s skip-zero and L2 rules over the
     field's 21 leaves bitwise ``adam_plain`` (eagerly and replayed), each
     timed through CUDA graphs beside its plain version and a bound from
     that run's inputs (bytes at 3.35 TB/s), ptxas spills 0; and the MLPs'
     fused pair (``csrc/ngp_mlp.cu``) at the two passes' samples against
     its bf16 plain version (the forward within twice, the backward's
     features' and weight gradients within once the plain version's own
     distance from the float32 chain; the backward bitwise over two
     launches), timed through CUDA graphs beside the plain version and a
     bound from operations and bytes, ptxas spills 0; b. the field
     through ``Trainer`` at the ``ngp-fern-train`` cell's shape, 3 single
     steps and blocks of 10 graphed steps, every step 2 + 2 hash launches,
     2 + 2 MLP launches and one Adam, no plain call, median ms a step;
  13. a frame as one CUDA-graph dispatch (``render/frames.py``: every
     frame path, phases 2-11's included, replays a captured frame
     program): a. on phase 7's run (and an fp32 run directory), each frame
     variant (bf16, fp32, int8, occupancy merge and full with both probes,
     full with ``--occ_term``, int8 through a grid, ``--stochastic``, a
     two-shard mesh of the one card) through its renderer's program: a
     pose's first frame, the same pose replayed, another pose and key
     replayed and that frame through the program's body run eagerly, the
     replays bitwise their eager frames (rgb, rgb_coarse, acc, depth),
     every frame exactly the variant's launches and no plain call, one
     capture; b. eager frames against replays in interleaved rounds (CUDA
     events and wall clock), each split by the profiler into the forward
     kernels, other device work and idle time, capture seconds and pool
     bytes, at 400x400 chunk 8192 (bf16, int8, full nearest, merge
     trilinear), bf16 at factor 2 and 4, 200x200 at chunk 4096, and the
     probes of one chunk inside a graph; c. ``render_video`` of 3 poses bitwise 3 ``render_pose``
     calls; d. phase 7's validations and test frames one capture and 5
     replays, each logged validation PSNR equal to the same views scored
     through eager frames from the step's checkpoint.
The launch counts of phases 2, 2b, 3, 3b, 5, 5b, 7, 8, 9, 10 and 11 (the
main paths) are reset just before each phase (each CLI call of phase 7) and read just
after: the kernels must have launched exactly as often as the chunking
implies (40 forward launches per 400x400 frame at chunk 8192, 80 at the
CLI's chunk 4096, or as many int8 launches and no forward launch under
``--int8``, half as many through an occupancy grid; 2 forward and 2
backward launches per train step, 1 + 1 per occupancy step, counted step
by step in phases 7 and 10d; ceil(res^3 / 65,536) per bake; on a
two-shard mesh 2 + 2 a shard a step, 2 a chunk a shard a frame), and the
plain versions not at all. A train step captured in a CUDA graph is counted
as it runs: its launches are taken off the counters at the capture and
added again at each replay, and so is a frame replayed from a frame
program's graph (``Graphs``: the first frame of a program runs eagerly,
then the body is captured); the draw kernels count every
launch after phase 12a's comparisons (9 threefry and 1 Feistel a lego
step), Adam's every launch after phase 12e's (1 a step, its plain
version never), and the hash and MLP kernels' every launch of phase 14b
(2 + 2 of each an NGP step; the counters set to 0 just before it).

Prints the card's name and power limit, one JSON line of per-kernel
numbers (phase 12's under ``threefry_bits``'s ``"scan"`` key, phase 13's
under ``fused_nerf_apply``'s ``"frames"``), the list of kernels
exercised, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
CUDA is unavailable or the port's package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_FP32_FLOPS = 67e12       # fp32 FFMA peak outside the tensor cores
H100_INT8_OPS = 1979e12       # dense int8 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3
SEED = 0
CHUNK = 8192
SERVE_HW = 400
TOL_FP32 = 2e-4               # the JAX package's fused-kernel fp32 tolerance
# bf16: kernel and plain version round the same operands; they differ only
# in summation order, which can flip the bf16 rounding of an activation.
TOL_BF16 = 2e-2
# Backward, per leaf, relative to the leaf's largest gradient. A ReLU whose
# pre-activation lies within rounding of zero flips its mask between two
# summation orders and moves one whole term of a sum over n points; with a
# zero-mean upstream g the leaf's largest gradient grows only like sqrt(n),
# so one flip weighs ~1/sqrt(n); in bf16 a sum that lands on the other side
# of a rounding step also moves an activation by one bf16 step (2^-8). On an
# H100, at phase 1b's ragged n = 65,573: two plain versions (cuBLAS, CPU)
# disagree by 3.3e-3 (fp32) and 2.3e-3 (bf16); the kernel, whose
# tensor-core sums round differently again, reads 2.5e-3 (fp32) and at
# most 1.4e-2 (bf16, any of phase 1b's sizes); a kernel that drops the
# 37-point ragged tail reads 3.7e-2 (fp32) and 3.0e-2 (bf16). Each
# tolerance lies between the kernel's reading and the planted fault's;
# phase 1b prints them all. The check of the tail's points alone (see
# calibrate) is where a dropped tail reads 1; it differs from the same
# points in full tiles only in the fp32 grouping of the sums (~1e-7).
TOL_BWD_FP32 = 1e-2
TOL_BWD_BF16 = 2e-2
TOL_TAIL = 1e-5
# int8 with the real head scales: the JAX package's bound between its int8
# kernel and its plain version (tests/test_quantize.py:122). The kernel
# rounds every fp32 step as the plain version does, so it reads 0.
TOL_INT8 = 1e-6
INT8_FLIP_SHARE = 0.02        # see phase_int8_serve
TRAIN_HW = 400
TRAIN_STEPS = 50
TRAIN_STEPS_FP32 = 5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def inputs(n: int, gen: torch.Generator, scale: float = 2.0):
    pts = (torch.randn(n, 3, generator=gen) * scale).cuda()
    dirs = torch.randn(n, 3, generator=gen)
    dirs = (dirs / dirs.norm(dim=-1, keepdim=True)).cuda()
    return pts.contiguous(), dirs.contiguous()


def check_ptxas(library: Path, kernel: str) -> None:
    """Print ptxas' registers and spills of every instantiation of
    ``kernel``; fail if there is none or one spills."""
    report = ptxas_report(library, kernel)
    if not report:
        fail(f"no {kernel} kernel in the ptxas report")
    for k in report:
        print(f"ptxas: {k['kernel']}: {k.get('registers')} registers, spill "
              f"stores {k.get('spill_stores')} B, spill loads "
              f"{k.get('spill_loads')} B, wgmma warnings "
              f"{sorted(set(k['warnings']))}", flush=True)
        if k.get("spill_stores") != 0 or k.get("spill_loads") != 0:
            fail(f"{kernel} spills ({k['kernel']})")


def ptxas_report(library: Path, kernel: str) -> list[dict]:
    """Registers and spills of every instantiation of ``kernel`` in the
    ptxas report of a verbose build, and the wgmma warnings ptxas gave it."""
    from cvnerf_torch.utils.kernels import ptxas_log
    log = ptxas_log(library)
    if not log.exists():
        fail(f"no ptxas report beside {library.name}: delete "
             f"{library.parent} and rerun")
    found, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for|$)", line)
        if m:
            name = m.group(1)
            continue
        if name is None or kernel not in name:
            continue
        k = found.setdefault(name, {"kernel": name, "warnings": []})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            k["spill_stores"], k["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            k["registers"] = int(m.group(1))
    for line in log.read_text().splitlines():
        m = re.search(r"\((C75\d\d)\).*function '(\S+)'", line)
        if m and m.group(2) in found:
            found[m.group(2)]["warnings"].append(m.group(1))
    return list(found.values())


def gemm_chain_ms(cfg, n: int, dt=torch.bfloat16) -> tuple[float, float]:
    """The forward's products alone, unfused, through ``torch.matmul`` in
    ``dt`` (fp32: full fp32 products, ``allow_tf32`` False) at the kernel's
    padded widths: l1 and l6b (n x KX x W), eight W x W layers, l10a
    (n x W x H) and l10b (n x KD x H). Returns the median ms and the FLOP
    it does."""
    if dt == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        fail("the fp32 yardstick must not run on TF32")
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = -(-cfg.xyz_dim // 16) * 16, -(-cfg.dir_dim // 16) * 16
    bf = dict(device="cuda", dtype=dt)
    x, xe, de = (torch.randn(n, k, **bf) for k in (w, kx, kd))
    wx, ww, wh, wd = (torch.randn(a, b, **bf) * 0.05
                      for a, b in ((kx, w), (w, w), (w, h), (kd, h)))
    o, oh = torch.empty(n, w, **bf), torch.empty(n, h, **bf)

    def chain():
        torch.matmul(xe, wx, out=o)
        for _ in range(8):
            torch.matmul(x, ww, out=o)
        torch.matmul(xe, wx, out=o)
        torch.matmul(x, wh, out=oh)
        torch.matmul(de, wd, out=oh)
    flops = 2 * n * (2 * kx * w + 8 * w * w + w * h + kd * h)
    return time_ms(chain), flops


def int8_gemm_chain_ms(cfg, n: int) -> tuple[float, float]:
    """The int8 kernel's products alone, unfused, through ``torch._int_mm``
    (s8 x s8 -> s32) at the kernel's padded widths, as ``gemm_chain_ms``
    for bf16. Timed only; the port never calls it. Returns the median ms
    and the operations it does."""
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = -(-cfg.xyz_dim // 16) * 16, -(-cfg.dir_dim // 16) * 16
    i8 = dict(device="cuda", dtype=torch.int8)
    x, xe, de = (torch.randint(-127, 128, (n, k), **i8) for k in (w, kx, kd))
    # [in, out] views of [out, in] matrices: the column-major B cuBLASLt's
    # int8 product takes.
    wx, ww, wh, wd = (torch.randint(-127, 128, (b, a), **i8).t()
                      for a, b in ((kx, w), (w, w), (w, h), (kd, h)))

    def chain():
        torch._int_mm(xe, wx)
        for _ in range(8):
            torch._int_mm(x, ww)
        torch._int_mm(xe, wx)
        torch._int_mm(x, wh)
        torch._int_mm(de, wd)
    ops = 2 * n * (2 * kx * w + 8 * w * w + w * h + kd * h)
    return time_ms(chain), ops


def phase_kernels(fm, cfg, params):
    """Build every kernel, then check and time the forward kernel; returns
    its per-shape rows (without ``launches``)."""
    from cvnerf_torch.utils.kernels import SOURCES, build_library
    t0 = time.time()
    with ThreadPoolExecutor() as pool:   # one nvcc per kernel source
        libs = dict(zip(SOURCES, pool.map(
            lambda name: build_library(name, verbose=True), SOURCES)))
    print(f"built {[str(p.name) for p in libs.values()]} in "
          f"{time.time() - t0:.1f} s", flush=True)
    check_ptxas(libs["fused_mlp"], "fused_nerf_wgmma")
    check_ptxas(libs["fused_mlp"], "fused_nerf_ffma")
    check_ptxas(libs["fused_mlp_int8"], "fused_nerf_int8_wgmma")
    check_ptxas(libs["fused_mlp_bwd"], "fused_nerf_bwd_wgmma")
    check_ptxas(libs["fused_mlp_bwd"], "wgrad_wgmma")
    check_ptxas(libs["fused_mlp_bwd"], "fused_nerf_bwd_ffma")
    check_ptxas(libs["fused_mlp_bwd"], "wgrad_ffma")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = []
    # Each dtype at ragged sizes around its tiles (fp32 64 points, bf16 128)
    # and its one-block-per-SM grid, then the serving shapes (a coarse chunk
    # of 8192 rays x 64, a fine chunk x 192) and a train step's (1024 rays x
    # 64 coarse, x 192 fine).
    main_shapes = (CHUNK * 64, CHUNK * 192, 1024 * 64, 1024 * 192)
    cases = [(n, dt) for dt, tile in ((torch.float32, fm.FP32_TILE),
                                      (torch.bfloat16, fm.BF16_TILE))
             for n in (1, tile - 1, tile + 1, sms * tile + 1, 2 ** 16 + 37)
             + main_shapes]
    for n, dt in cases:
        w = fm.FusedNerfWeights(params, cfg, dt)
        pts, dirs = inputs(n, gen)
        got = fm.fused_nerf_apply(w, pts, dirs)
        again = fm.fused_nerf_apply(w, pts, dirs)
        torch.cuda.synchronize()
        want = fm.fused_nerf_plain(params, pts, dirs, cfg, dt)
        err = (got - want).abs().max().item()
        tol = TOL_FP32 if dt == torch.float32 else TOL_BF16
        ok = bool(torch.isfinite(got).all()) and got.shape == (n, 4)
        same = torch.equal(got, again)
        if dt == torch.bfloat16:
            plan, host = fm.kernel_bf16_plan(cfg, n), fm.bf16_launch_plan(
                cfg, n, sms)
        else:
            plan, host = fm.kernel_fp32_plan(cfg, n), fm.fp32_launch_plan(
                cfg, n, sms)
        if plan != host:
            fail(f"the kernel's launch plan {plan} is not the host's {host} "
                 f"(n={n}, {dt})")
        print(f"fused_nerf_apply n={n} {str(dt)[6:]}: max_abs_err={err:.3e} "
              f"(tol {tol:g}) finite_and_shaped={ok} two launches bitwise "
              f"equal: {same} {plan}", flush=True)
        if not ok or not err <= tol:
            fail(f"kernel disagrees with its plain version (n={n}, {dt})")
        if not same:
            fail(f"two {dt} launches differ (n={n})")
        del again
        kernel_ms = time_ms(lambda: fm.fused_nerf_apply(w, pts, dirs))
        plain_ms = time_ms(lambda: fm.fused_nerf_plain(params, pts, dirs,
                                                       cfg, dt), reps=5)
        flops = fm.forward_flops(cfg) * n
        peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_FP32_FLOPS
        nbytes = (pts.numel() * 4 + dirs.numel() * 4 + got.numel() * 4
                  + w.wmat.numel() * w.wmat.element_size()
                  + w.wvec.numel() * 4)
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        print(f"  kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={max(ops_ms, bytes_ms):.4f} "
              f"({flops / kernel_ms / 1e9:.2f} TFLOP/s)", flush=True)
        rows.append({"n": n, "dtype": str(dt)[6:], "max_abs_err": err,
                     "ms": kernel_ms, "plain_ms": plain_ms,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes"})
        del pts, dirs, got, want
        if n == CHUNK * 192:
            chain_ms, chain_flops = gemm_chain_ms(cfg, n, dt)
            rows[-1]["gemm_chain_ms"] = chain_ms
            print(f"  gemm_chain_ms={chain_ms:.4f} (the same {str(dt)[6:]} "
                  f"products unfused through torch.matmul, "
                  f"{chain_flops / chain_ms / 1e9:.2f} TFLOP/s; a yardstick, "
                  "not library_ms)", flush=True)
        torch.cuda.empty_cache()
    return rows


def pow2_heads(tq, qp):
    """``qp`` with power-of-two head scales and zero head biases: the heads'
    fp32 dequant is then exact, so equal outputs mean equal int8
    activations and head accumulators."""
    layers = dict(qp.layers)
    for h in ("alpha", "l11"):
        layers[h] = {"qw": layers[h]["qw"],
                     "s": torch.full_like(layers[h]["s"], 2.0 ** -10),
                     "b": torch.zeros_like(layers[h]["b"])}
    return tq.QuantizedNerfParams(layers=layers, inv_act=qp.inv_act)


def phase_int8(fm, fq, tq, rng, cfg, params):
    """Quantize the full-width net on the card, check the int8 kernel
    against its plain version (bitwise with power-of-two heads, TOL_INT8
    with the real scales, bitwise over two launches, the launch plan the
    host's) and time both."""
    cpts, cdirs = tq.calibration_samples(rng.PRNGKey(SEED + 6), 1 << 17,
                                         (-6.0,) * 3, (6.0,) * 3, "cuda")
    qp = tq.quantize_nerf(params, cfg, cpts, cdirs)
    real, exact = fq.QuantizedNerfWeights(qp, cfg), pow2_heads(tq, qp)
    exact_w = fq.QuantizedNerfWeights(exact, cfg)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = []
    # Ragged sizes around the 128-point tiles and the one-block-per-SM
    # grid, then the serving chunks.
    for n in (1, 127, 129, sms * 128 + 1, 2 ** 16 + 37, CHUNK * 64,
              CHUNK * 192):
        pts, dirs = inputs(n, gen)
        first = fq.fused_nerf_apply_int8(real, pts, dirs)
        second = fq.fused_nerf_apply_int8(real, pts, dirs)
        got_exact = fq.fused_nerf_apply_int8(exact_w, pts, dirs)
        torch.cuda.synchronize()
        want = fq.fused_nerf_int8_plain(qp, pts, dirs, cfg)
        err = (first - want).abs().max().item()
        bitwise = torch.equal(got_exact,
                              fq.fused_nerf_int8_plain(exact, pts, dirs, cfg))
        same = torch.equal(first, second)
        ok = bool(torch.isfinite(first).all()) and first.shape == (n, 4)
        plan = fq.kernel_int8_plan(cfg, n)
        print(f"fused_nerf_apply_int8 n={n}: power-of-two heads bitwise "
              f"equal to plain: {bitwise}; real scales max_abs_err={err:.3e} "
              f"(tol {TOL_INT8:g}); two launches bitwise equal: {same}; "
              f"finite_and_shaped={ok} {plan}", flush=True)
        if not (bitwise and same and ok and err <= TOL_INT8):
            fail(f"int8 kernel disagrees with its plain version (n={n})")
        if plan != fq.int8_launch_plan(cfg, n, sms):
            fail(f"the int8 kernel's launch plan {plan} is not the host's "
                 f"{fq.int8_launch_plan(cfg, n, sms)} (n={n})")
        del want, got_exact, second
        kernel_ms = time_ms(lambda: fq.fused_nerf_apply_int8(real, pts, dirs))
        plain_ms = time_ms(lambda: fq.fused_nerf_int8_plain(qp, pts, dirs,
                                                            cfg),
                           reps=3, warmup=1)
        ops = fm.forward_flops(cfg) * n
        nbytes = (pts.numel() * 4 + dirs.numel() * 4 + first.numel() * 4
                  + real.qmat.numel() + real.qvec.numel() * 4)
        ops_ms, bytes_ms = ops / H100_INT8_OPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        print(f"  kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound:.4f} (share {bound / kernel_ms:.2%}, "
              f"{ops / kernel_ms / 1e9:.2f} TOPS)", flush=True)
        rows.append({"n": n, "max_abs_err": err, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes"})
        del pts, dirs, first
        if n == CHUNK * 192:
            chain_ms, chain_ops = int8_gemm_chain_ms(cfg, n)
            rows[-1]["int8_gemm_chain_ms"] = chain_ms
            print(f"  int8_gemm_chain_ms={chain_ms:.4f} (the same int8 "
                  f"products unfused through torch._int_mm, "
                  f"{chain_ops / chain_ms / 1e9:.2f} TOPS; a yardstick, not "
                  "library_ms)", flush=True)
        torch.cuda.empty_cache()
    return rows


def leaf_errors(got: dict, want: dict) -> dict:
    """Per leaf: max |got - want| over the leaf's largest |want|."""
    return {f"{k}.{p}": ((got[k][p] - want[k][p]).abs().max()
                         / want[k][p].abs().max().clamp_min(1e-30)).item()
            for k in want for p in ("w", "b")}


def bwd_split_ms(run, reps: int = 3) -> dict:
    """Device ms per backward launch of its pass 1 (the kernel named
    ``fused_nerf_bwd_wgmma`` in bf16, ``fused_nerf_bwd_ffma`` in fp32) and
    of the rest (weight gradients, sums, the workspace's memset, the
    weights' transposed copy), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {"pass1_ms": 0.0, "rest_ms": 0.0}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            key = "pass1_ms" if "fused_nerf_bwd" in e.key else "rest_ms"
            out[key] += e.self_device_time_total / reps / 1e3
    return out


def phase_backward(fm, fb, cfg, params):
    """Check the backward kernel against its plain version, its launch
    against a second launch (bitwise), its launch plan (bf16) against the
    host's, and time both; returns the rows."""
    gen = torch.Generator().manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    # In both dtypes: a ragged size, a train step's coarse (1024 rays x 64)
    # and fine (x 192) shapes, and a ragged size past the kernel's chunk of
    # 2^18 points (two chunks).
    cases = [(n, dt) for dt in (torch.float32, torch.bfloat16)
             for n in (2 ** 16 + 37, 1024 * 64, 1024 * 192,
                       2 ** 18 + 2 ** 15 + 37)]
    for n, dt in cases:
        w = fm.FusedNerfWeights(params, cfg, dt)
        pts, dirs = inputs(n, gen)
        g = (torch.randn(n, 4, generator=gen) * 1e-3).cuda()
        first = fb.fused_nerf_bwd(w, pts, dirs, g)
        second = fb.fused_nerf_bwd(w, pts, dirs, g)
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        want = fb.fused_nerf_bwd_plain(params, pts, dirs, g, cfg, dt)
        errs = leaf_errors(fb.unpack_grads(first, cfg, dt), want)
        worst = max(errs, key=errs.get)
        tol = TOL_BWD_FP32 if dt == torch.float32 else TOL_BWD_BF16
        if n == 2 ** 16 + 37:
            calibrate(fb, cfg, params, w, pts, dirs, g, first, want)
        finite = bool(torch.isfinite(first).all())
        plan = fb.kernel_bwd_plan(cfg, n, dt)
        host = (fb.bwd_launch_plan if dt == torch.bfloat16
                else fb.bwd32_launch_plan)(cfg, n, sms)
        if plan != host:
            fail(f"the backward's launch plan {plan} is not the host's "
                 f"{host} (n={n}, {dt})")
        print(f"fused_nerf_bwd n={n} {str(dt)[6:]}: max leaf error "
              f"{errs[worst]:.3e} ({worst}; tol {tol:g}), bitwise equal over "
              f"two launches: {same}, finite: {finite} {plan}", flush=True)
        if not (finite and same and errs[worst] <= tol):
            fail(f"backward kernel check failed (n={n}, {dt})")
        kernel_ms = time_ms(lambda: fb.fused_nerf_bwd(w, pts, dirs, g),
                            reps=5)
        split = bwd_split_ms(lambda: fb.fused_nerf_bwd(w, pts, dirs, g))
        plain_ms = time_ms(lambda: fb.fused_nerf_bwd_plain(
            params, pts, dirs, g, cfg, dt), reps=5)
        flops = fb.backward_flops(cfg) * n
        peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_FP32_FLOPS
        nbytes = ((pts.numel() + dirs.numel() + g.numel()) * 4
                  + w.wmat.numel() * w.wmat.element_size()
                  + w.wvec.numel() * 4 + first.numel() * 4)
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        print(f"  kernel_ms={kernel_ms:.4f} (profiler: pass 1 "
              f"{split['pass1_ms']:.4f}, the rest {split['rest_ms']:.4f}) "
              f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} (share "
              f"{bound / kernel_ms:.2%})", flush=True)
        rows.append({"n": n, "dtype": str(dt)[6:], "max_abs_err": errs[worst],
                     "ms": kernel_ms, **split, "plain_ms": plain_ms,
                     "bound_ms": bound,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes"})
        del pts, dirs, g, first, second
    return rows


def calibrate(fb, cfg, params, w, pts, dirs, g, whole, want) -> None:
    """What the backward tolerance rests on, at a ragged n: how far two
    plain versions (cuBLAS on the card, the CPU) disagree on the same
    inputs, how far the kernel's gradients of two halves of the points are
    from its whole, and what a kernel that dropped the ragged tail would
    read, which must lie above the tolerance. Then checks the ragged
    tail's points alone."""
    dt, n = w.compute_dtype, pts.shape[0]
    cpu = {k: {p: t.cpu() for p, t in v.items()} for k, v in params.items()}
    on_cpu = fb.fused_nerf_bwd_plain(cpu, pts.cpu(), dirs.cpu(), g.cpu(), cfg,
                                     dt)
    gap = max(leaf_errors({k: {p: t.cpu() for p, t in v.items()}
                           for k, v in want.items()}, on_cpu).values())
    h = n // 2
    halves = (fb.fused_nerf_bwd(w, pts[:h], dirs[:h], g[:h])
              + fb.fused_nerf_bwd(w, pts[h:], dirs[h:], g[h:]))
    split = max(leaf_errors(fb.unpack_grads(halves, cfg, dt),
                            fb.unpack_grads(whole, cfg, dt)).values())
    body = n // 64 * 64
    dropped = max(leaf_errors(fb.unpack_grads(fb.fused_nerf_bwd(
        w, pts[:body], dirs[:body], g[:body]), cfg, dt), want).values())
    # The ragged tail's points alone (g zero elsewhere) against the same
    # points placed in full tiles (64 rows, the last ones with g = 0): per
    # point the kernel does the same arithmetic wherever the point sits, so
    # only the fp32 grouping of the sums differs; a dropped tail reads 1.
    # (Against the plain version, a sum over 37 points would swing by a
    # whole point's share where one bf16 ReLU flips between summation
    # orders.) Per leaf: the norm of the difference over the norm.
    g_tail = g.clone()
    g_tail[:body] = 0
    got = fb.unpack_grads(fb.fused_nerf_bwd(w, pts, dirs, g_tail), cfg, dt)
    full = torch.arange(n - 64, n, device=pts.device)
    g_full = g[full].clone()
    g_full[:body + 64 - n] = 0
    want_tail = fb.unpack_grads(fb.fused_nerf_bwd(
        w, pts[full].contiguous(), dirs[full].contiguous(), g_full), cfg, dt)
    tail = max(((got[k][p] - want_tail[k][p]).norm()
                / want_tail[k][p].norm().clamp_min(1e-30)).item()
               for k in want_tail for p in ("w", "b"))
    print(f"  {str(dt)[6:]} calibration: plain on the card vs plain on the "
          f"CPU {gap:.3e}; kernel over two halves vs the whole {split:.3e}; "
          f"planted fault (the {n - body}-point tail dropped) {dropped:.3e}; "
          f"the tail alone vs the same points in full tiles {tail:.3e} "
          f"(tol {TOL_TAIL:g})", flush=True)
    if not tail <= TOL_TAIL:
        fail(f"backward check of the ragged tail failed (n={n}, {dt})")
    tol = TOL_BWD_FP32 if dt == torch.float32 else TOL_BWD_BF16
    if not dropped > tol:
        fail(f"the planted fault reads {dropped:.3e}, within the tolerance "
             f"{tol:g}: the check could not see a dropped tail ({dt})")


# The counters read_counts reports (the MLP kernels and their plain
# versions); Graphs also keeps the draws' (threefry, feistel) and Adam's.
MLP_COUNTS = ("fwd", "bwd", "int8", "fwd_plain", "bwd_plain", "int8_plain")


def all_counters(fm, fb, fq) -> dict:
    from cvnerf_torch.ops import adam as fa
    from cvnerf_torch.ops import hash_encode as he
    from cvnerf_torch.ops import ngp_mlp as nm
    from cvnerf_torch.ops import threefry as tf
    return {"fwd": (fm.fused_nerf_apply, "launches"),
            "bwd": (fb.fused_nerf_bwd, "launches"),
            "int8": (fq.fused_nerf_apply_int8, "launches"),
            "fwd_plain": (fm.fused_nerf_plain, "calls"),
            "bwd_plain": (fb.fused_nerf_bwd_plain, "calls"),
            "int8_plain": (fq.fused_nerf_int8_plain, "calls"),
            "threefry": (tf.threefry_bits, "launches"),
            "feistel": (tf.feistel_draw, "launches"),
            "threefry_plain": (tf.threefry_bits_plain, "calls"),
            "feistel_plain": (tf.feistel_draw_plain, "calls"),
            "adam": (fa.fused_adam, "launches"),
            "adam_plain": (fa.adam_plain, "calls"),
            "hash_fwd": (StatsKey(he.stats), "fwd_launches"),
            "hash_bwd": (StatsKey(he.stats), "bwd_launches"),
            "hash_plain": (StatsKey(he.stats), "plain_calls"),
            "mlp_fwd": (StatsKey(nm.stats), "fwd_launches"),
            "mlp_bwd": (StatsKey(nm.stats), "bwd_launches"),
            "mlp_plain": (StatsKey(nm.stats), "plain_calls")}


def reset_counts(fm, fb, fq) -> None:
    fm.fused_nerf_apply.launches = 0
    fm.fused_nerf_plain.calls = 0
    fb.fused_nerf_bwd.launches = 0
    fb.fused_nerf_bwd_plain.calls = 0
    fq.fused_nerf_apply_int8.launches = 0
    fq.fused_nerf_int8_plain.calls = 0


def read_counts(fm, fb, fq) -> dict:
    return {"fwd": fm.fused_nerf_apply.launches,
            "bwd": fb.fused_nerf_bwd.launches,
            "int8": fq.fused_nerf_apply_int8.launches,
            "fwd_plain": fm.fused_nerf_plain.calls,
            "bwd_plain": fb.fused_nerf_bwd_plain.calls,
            "int8_plain": fq.fused_nerf_int8_plain.calls}


def lego_train_config(dt, kernels: str = "on"):
    from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
    from cvnerf_torch.render.renderer import RenderConfig
    from cvnerf_torch.train.loop import TrainConfig
    rcfg = RenderConfig(n_coarse=64, n_fine=128, perturb=True, noise_std=0.0,
                        white_bkg=True, mlp=NerfMLPConfig(),
                        compute_dtype=dt, kernels=kernels)
    return TrainConfig(height=TRAIN_HW, width=TRAIN_HW, focal=555.0,
                       near=2.0, far=6.0, n_rays=1024, lr=5e-4, lr_decay=500,
                       render=rcfg)


def phase_train(fm, fb, fq, card: str):
    """Train the lego-shaped workload through ``Trainer`` (main path) and
    render a frame of the trained params; returns the launch counts."""
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.render.frames import render_image
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.train.loop import Trainer
    from cvnerf_torch.train.state import create_train_state
    images, poses = bench_scene(TRAIN_HW, TRAIN_HW)
    tcfg = lego_train_config(torch.bfloat16)
    state = create_train_state(PRNGKey(SEED),
                               lr=tcfg.lr, lr_decay=tcfg.lr_decay,
                               mlp=tcfg.render.mlp, device="cuda")
    tr = Trainer(tcfg, state, images, poses, [0, 1], seed=SEED)
    seen, events, walls = [], [], []

    def on_step(i, trainer, m):
        seen.append(m)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        walls.append(time.perf_counter())

    tr.add_callback(1, on_step)
    torch.cuda.synchronize()
    reset_counts(fm, fb, fq)
    before = GRAPHS.read()
    tr.run(1, 1 + TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = read_counts(fm, fb, fq)
    draws = {k: v - before[k] for k, v in GRAPHS.read().items()
             if k not in MLP_COUNTS}
    # A step's draws on the card: its key (fold_in), the image, pixel and
    # render keys (split), the image (randint: a split and two bits), both
    # ray streams (a fold_in and the bits each), the pixels (Feistel); and
    # Adam, one launch.
    print(f"train: the draws' and Adam's launches {draws} (expected "
          f"threefry {9 * TRAIN_STEPS}, feistel {TRAIN_STEPS}, adam "
          f"{TRAIN_STEPS}, plain 0)", flush=True)
    # Every other counter (the NGP field's hash and MLP kernels) reads 0.
    if draws != {**dict.fromkeys(draws, 0), "threefry": 9 * TRAIN_STEPS,
                 "feistel": TRAIN_STEPS, "adam": TRAIN_STEPS}:
        fail("train: the step's draws or Adam did not run exactly through "
             "their kernels")
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    wall_ms = [(b - a) * 1e3 for a, b in zip(walls, walls[1:])]
    med = float(np.median(step_ms))
    losses = [m["loss"] for m in seen]
    finite = all(np.isfinite(v) for m in seen for v in m.values())
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"train: {TRAIN_STEPS} lego-shaped bf16 steps through Trainer: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of first 10 "
          f"{first:.4f}, last 10 {last:.4f}), psnr {seen[-1]['psnr']:.2f}, "
          f"grad_norm {seen[-1]['grad_norm']:.4f}, metrics finite: {finite}",
          flush=True)
    print(f"train: median step {med:.3f} ms by CUDA events (wall "
          f"{float(np.median(wall_ms)):.3f} ms), {tcfg.n_rays / med * 1e3:.1f}"
          f" rays/s; launches {counts} (expected fwd {2 * TRAIN_STEPS}, bwd "
          f"{2 * TRAIN_STEPS}, plain 0); card: {card}", flush=True)
    if not finite or len(seen) != TRAIN_STEPS:
        fail("train: missing or non-finite metrics")
    if not last < first:
        fail("train: the loss did not fall")
    if counts != {"fwd": 2 * TRAIN_STEPS, "bwd": 2 * TRAIN_STEPS, "int8": 0,
                  "fwd_plain": 0, "bwd_plain": 0, "int8_plain": 0}:
        fail("train: the step did not run exactly through the kernels")
    split = profile_steps(tr, 1 + TRAIN_STEPS, 5, med)
    # Hand the trained state to the serving path of the first slice.
    nets = {k: fm.FusedNerfWeights(v, tcfg.render.mlp, torch.bfloat16)
            for k, v in tr.state.params.items()}
    rcfg = dataclasses.replace(tcfg.render, deterministic_resample=True
                               ).eval_mode()
    reset_counts(fm, fb, fq)
    out = render_image(nets, TRAIN_HW, TRAIN_HW, 555.0,
                       torch.as_tensor(poses[0], device="cuda"), 2.0, 6.0,
                       rcfg, chunk=CHUNK)
    rgb = out["rgb"].cpu().numpy()
    frame_counts = read_counts(fm, fb, fq)
    frame_psnr = float(-10 * np.log10(np.mean((rgb - images[0]) ** 2)))
    print(f"train: rendered the trained params at {rgb.shape}, psnr vs the "
          f"training view {frame_psnr:.2f} dB; launches {frame_counts}",
          flush=True)
    if rgb.shape != (TRAIN_HW, TRAIN_HW, 3) or not np.isfinite(rgb).all():
        fail("train: the trained frame is misshapen or non-finite")
    if frame_counts["fwd"] != 2 * -(-TRAIN_HW * TRAIN_HW // CHUNK):
        fail("train: the trained frame did not run through the kernel")
    return counts, med, split, tr.state.params


def profile_steps(tr, start: int, n: int, step_ms: float,
                  pass1: str = "fused_nerf_bwd_wgmma") -> dict:
    """Device time per train step by kernel group, from ``torch.profiler``
    (device activity only) over ``n`` more steps after the counted run, and
    the device's idle share of the unprofiled median step ``step_ms``. The
    backward's pass 1 must be the kernel ``pass1`` alone."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.run(start, start + n)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    # The backward's passes: the recompute and input gradients
    # (fused_nerf_bwd_wgmma in bf16, fused_nerf_bwd_ffma in fp32; a step
    # must launch its own dtype's alone), the weight gradients (wgrad_wgmma,
    # wgrad_ffma) and the fixed-order sum of the partials (reduce_slabs).
    us = {"fwd_kernels": 0.0, "bwd_pass1": 0.0, "bwd_wgrad": 0.0,
          "other_device": 0.0}
    pass1_names = set()
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        t = e.self_device_time_total
        if "fused_nerf_bwd" in e.key:
            us["bwd_pass1"] += t
            pass1_names.add(re.search(r"fused_nerf_bwd_\w+", e.key).group(0))
        elif "wgrad_" in e.key or "reduce_slabs" in e.key:
            us["bwd_wgrad"] += t
        elif "fused_nerf_wgmma" in e.key or "fused_nerf_ffma" in e.key:
            us["fwd_kernels"] += t
        else:
            us["other_device"] += t
    busy_ms = sum(us.values()) / n / 1e3
    if busy_ms > 0 and pass1_names != {pass1}:
        fail(f"the train step's pass 1 ran {sorted(pass1_names)}, not "
             f"{pass1} alone")
    split = {k: v / n / 1e3 for k, v in us.items()}
    split["bwd_kernels"] = split["bwd_pass1"] + split["bwd_wgrad"]
    split["profiled_wall"] = wall_us / n / 1e3
    split["idle_share"] = 1.0 - busy_ms / step_ms if busy_ms > 0 else None
    if busy_ms > 0:
        print("train step split (torch.profiler, ms per step over "
              f"{n} steps): forward kernels {split['fwd_kernels']:.3f}, "
              f"backward kernels {split['bwd_kernels']:.3f} (pass 1 "
              f"{split['bwd_pass1']:.3f}, weight gradients and sums "
              f"{split['bwd_wgrad']:.3f}), other device "
              f"work {split['other_device']:.3f} (profiled wall "
              f"{split['profiled_wall']:.3f}); pass-1 kernels "
              f"{sorted(pass1_names)}; device idle "
              f"{split['idle_share']:.1%} of the {step_ms:.3f} ms step",
              flush=True)
    else:
        print("train step split: the profiler saw no device time (not "
              "measured)", flush=True)
    return split


def phase_train_fp32(fm, fb, fq, card: str):
    """The --no-bf16 training path: TRAIN_STEPS_FP32 lego-shaped fp32
    steps through ``Trainer``, exactly 2 forward and 2 backward launches a
    step and no plain call, the step time by CUDA events and a profiler
    split whose pass 1 is ``fused_nerf_bwd_ffma`` alone. Returns the launch
    counts, the median step and the split."""
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.train.loop import Trainer
    from cvnerf_torch.train.state import create_train_state
    images, poses = bench_scene(TRAIN_HW, TRAIN_HW)
    tcfg = lego_train_config(torch.float32)
    state = create_train_state(PRNGKey(SEED),
                               lr=tcfg.lr, lr_decay=tcfg.lr_decay,
                               mlp=tcfg.render.mlp, device="cuda")
    tr = Trainer(tcfg, state, images, poses, [0, 1], seed=SEED)
    seen, events = [], []

    def on_step(i, trainer, m):
        seen.append(m)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    tr.add_callback(1, on_step)
    torch.cuda.synchronize()
    reset_counts(fm, fb, fq)
    t0 = time.perf_counter()
    tr.run(1, 1 + TRAIN_STEPS_FP32)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS_FP32
    counts = read_counts(fm, fb, fq)
    med = float(np.median([a.elapsed_time(b)
                           for a, b in zip(events, events[1:])]))
    finite = all(np.isfinite(v) for m in seen for v in m.values())
    want = {"fwd": 2 * TRAIN_STEPS_FP32, "bwd": 2 * TRAIN_STEPS_FP32,
            "int8": 0, "fwd_plain": 0, "bwd_plain": 0, "int8_plain": 0}
    print(f"train --no-bf16: {TRAIN_STEPS_FP32} lego-shaped fp32 steps "
          f"through Trainer: loss {seen[0]['loss']:.4f} -> "
          f"{seen[-1]['loss']:.4f}, metrics finite: {finite}; median step "
          f"{med:.3f} ms by CUDA events (wall {wall:.3f} ms a step); "
          f"launches {counts} (expected {want}); card: {card}", flush=True)
    if not finite or len(seen) != TRAIN_STEPS_FP32:
        fail("fp32 train: missing or non-finite metrics")
    if counts != want:
        fail("fp32 train: the step did not run exactly through the kernels")
    split = profile_steps(tr, 1 + TRAIN_STEPS_FP32, 3, med,
                          pass1="fused_nerf_bwd_ffma")
    return counts, med, split


def phase_frame_fp32(fm, fb, fq, run: str):
    """The --no-bf16 serving path: the server's renderer from a run
    directory whose snapshot says ``"bf16": false`` renders one 400x400
    frame; exactly 40 forward launches and no plain call. Returns the
    launch counts and the frame's wall ms."""
    from cvnerf_torch.server import build_parser, renderer_from_args
    args = build_parser().parse_args(["--run", run, "--device", "cuda"])
    renderer = renderer_from_args(args)
    if renderer.cfg.compute_dtype != torch.float32:
        fail("the fp32 run directory did not load as fp32")
    renderer.render_video(np.stack([pose(1.1)]))   # warm
    torch.cuda.synchronize()
    reset_counts(fm, fb, fq)
    t0 = time.perf_counter()
    frames = renderer.render_video(np.stack([pose(0.3)]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(fm, fb, fq)
    per_frame = 2 * -(-SERVE_HW * SERVE_HW // CHUNK)          # 40
    want = {"fwd": per_frame, "bwd": 0, "int8": 0, "fwd_plain": 0,
            "bwd_plain": 0, "int8_plain": 0}
    ok = (frames.shape == (1, SERVE_HW, SERVE_HW, 3)
          and bool(np.isfinite(frames).all()))
    print(f"serve --no-bf16: one {SERVE_HW}x{SERVE_HW} fp32 frame in "
          f"{ms:.1f} ms wall, finite and shaped: {ok}; launches {counts} "
          f"(expected {want})", flush=True)
    if not ok:
        fail("the fp32 frame is misshapen or non-finite")
    if counts != want:
        fail("fp32 serving did not run exactly through the kernel")
    return counts, ms


def phase_step_vs_off(cfg):
    """One train step with the kernels and with kernels="off" from one
    state and key, fp32 and bf16."""
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.ops.rng import PRNGKey, fold_in
    from cvnerf_torch.train.loop import make_train_step
    from cvnerf_torch.train.state import create_train_state
    from cvnerf_torch.utils.tree import tree_leaves
    images, poses = bench_scene(TRAIN_HW, TRAIN_HW)
    images = torch.as_tensor(images, device="cuda")
    poses = torch.as_tensor(poses, device="cuda")
    idx = torch.tensor([0, 1])
    key = fold_in(PRNGKey(SEED), 1)
    # loss rtol; mu (= 0.1 x the gradient after one step) relative to each
    # leaf's largest; updated params: Adam's first step moves a weight by
    # ~lr·sign(g)·|g|/(|g| + eps), so a weight whose gradient is small enough
    # to change sign between the two paths may differ by up to 2·lr, and must
    # agree to 1e-6 where |g| is above the given fraction of its leaf's
    # largest and far above Adam's eps (1e-8), where the step no longer
    # depends on |g|.
    for dt, tol_loss, tol_g, gfrac in ((torch.float32, 1e-5, 1e-2, 1e-2),
                                       (torch.bfloat16, 2e-2, 1.5e-1, 0.3)):
        outs = []
        for kernels in ("on", "off"):
            tcfg = lego_train_config(dt, kernels)
            state = create_train_state(PRNGKey(SEED + 5),
                                       lr=tcfg.lr, lr_decay=tcfg.lr_decay,
                                       device="cuda")
            new, m = make_train_step(tcfg)(state, key, images, poses, idx,
                                           False)
            outs.append((new, {k: float(v) for k, v in m.items()}))
        (on, m_on), (off, m_off) = outs
        loss_err = abs(m_on["loss"] - m_off["loss"]) / abs(m_off["loss"])
        mu_on = tree_leaves(on.opt_state.mu)
        mu_off = tree_leaves(off.opt_state.mu)
        g_err = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(mu_on, mu_off))
        p_any, p_big = 0.0, 0.0
        for a, b, g in zip(tree_leaves(on.params), tree_leaves(off.params),
                           mu_off):
            d = (a - b).abs()
            p_any = max(p_any, d.max().item())
            big = (g.abs() > gfrac * g.abs().max()) & (g.abs() > 1e-6)
            if big.any():
                p_big = max(p_big, d[big].max().item())
        lr = lego_train_config(dt).lr
        print(f"train step {str(dt)[6:]} kernels vs kernels='off': loss "
              f"{m_on['loss']:.6f} vs {m_off['loss']:.6f} (rel {loss_err:.2e}, "
              f"tol {tol_loss:g}); grads rel {g_err:.2e} (tol {tol_g:g}); "
              f"params max {p_any:.2e} (tol {2 * lr:g}), where |g| > "
              f"{gfrac:g} max and 1e-5: {p_big:.2e} (tol 1e-6)", flush=True)
        if not (loss_err <= tol_loss and g_err <= tol_g
                and p_any <= 2 * lr + 1e-6 and p_big <= 1e-6):
            fail(f"train step {dt}: kernels and kernels='off' disagree")


class PerCall:
    """Launch counts of every call of ``module.name`` while active (the
    delta of ``read_counts`` across the call); for ``make_train_step``,
    of every call of the step function it returns."""

    def __init__(self, counts, module, name: str, factory: bool = False):
        self.counts, self.module, self.name = counts, module, name
        self.factory = factory
        self.deltas: list[dict] = []

    def _wrap(self, fn):
        def call(*a, **kw):
            before = self.counts()
            out = fn(*a, **kw)
            after = self.counts()
            self.deltas.append({k: after[k] - before[k] for k in after})
            return out
        return call

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        if self.factory:
            def make(*a, **kw):
                return self._wrap(self.orig(*a, **kw))
            setattr(self.module, self.name, make)
        else:
            setattr(self.module, self.name, self._wrap(self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class Graphs:
    """Launch accounting for programs replayed from CUDA graphs (blocks of
    train steps, ``make_train_scan``, and frame programs,
    ``render/frames.py``; both ``utils/graphs.py::GraphProgram``),
    installed for the whole run. Work recorded into a graph runs nothing at
    its capture and runs again at every replay, while each wrapper counts
    its Python calls: this takes a capture's counts back off the counters
    and adds them again at every replay, so every counter reads what ran
    on the card (the eager warm-up before a capture included). While
    ``into(list)`` is active, each step of a block is appended to that
    list (a step-by-step ``PerCall`` record) as the launches of one step,
    and each block's record to ``blocks``; ``totals`` counts frame
    programs' captures, replays and eager frames over the run."""

    def __init__(self, counters: dict):
        self.counters = counters          # name -> (object, attribute)
        self.deltas: list | None = None
        self.blocks: list[dict] = []
        self.totals = {"captures": 0, "replays": 0, "eager_frames": 0}

    def read(self) -> dict:
        return {k: getattr(o, a) for k, (o, a) in self.counters.items()}

    def _add(self, delta: dict, times: int) -> None:
        for k, (o, a) in self.counters.items():
            setattr(o, a, getattr(o, a) + times * delta[k])

    def into(self, deltas: list):
        outer = self

        class Into:
            def __enter__(self):
                outer.deltas = deltas

            def __exit__(self, *exc):
                outer.deltas = None
        return Into()

    def _mlp(self, d: dict) -> dict:
        return {k: d[k] for k in MLP_COUNTS}

    def install(self) -> None:
        from cvnerf_torch.render import frames
        from cvnerf_torch.train import loop
        from cvnerf_torch.utils.graphs import GraphProgram
        rec = self
        capture, replay = GraphProgram._capture, GraphProgram._replay
        body, call = loop._Block._body, loop._Block.__call__
        run = frames.FrameProgram.run

        def counted_capture(prog, device, mesh, collective, fn,
                            warm_up=None):
            seen = {}

            def counted():
                before = rec.read()
                out = fn()
                seen.update({k: v - before[k]
                             for k, v in rec.read().items()})
                return out
            got = capture(prog, device, mesh, collective, counted,
                          warm_up or fn)
            if got is not None:
                rec._add(seen, -1)
                prog.__dict__.setdefault("captured", {})[id(got[0])] = seen
                prog.captured_launches = seen
            return got

        def counted_replay(prog, graph, times: int = 1):
            replay(prog, graph, times)
            d = prog.captured[id(graph)]
            rec._add(d, times)
            if isinstance(prog, loop._Block) and rec.deltas is not None:
                rec.deltas.extend(rec._mlp(d) for _ in range(times))

        def counted_body(blk, *a, write: bool = True, **kw):
            before = rec.read()
            out = body(blk, *a, write=write, **kw)
            capturing = (torch.cuda.is_available()
                         and torch.cuda.is_current_stream_capturing())
            if write and not capturing and rec.deltas is not None:
                rec.deltas.append(rec._mlp(       # an eager block's step
                    {k: v - before[k] for k, v in rec.read().items()}))
            return out

        def counted_call(blk, *a, **kw):
            stats, before = dict(blk.stats), rec.read()
            out = call(blk, *a, **kw)
            rec.blocks.append({
                "steps": blk.block,
                "replayed": blk.stats["replayed_steps"]
                - stats["replayed_steps"],
                "captures": blk.stats["captures"] - stats["captures"],
                "per_step": dict(getattr(blk, "captured_launches", {})),
                "delta": {k: v - before[k] for k, v in rec.read().items()},
                "eager_reason": blk.eager_reason})
            return out

        def counted_run(prog):
            stats = dict(prog.stats)
            out = run(prog)
            for k in rec.totals:
                rec.totals[k] += prog.stats[k] - stats[k]
            return out
        GraphProgram._capture = counted_capture
        GraphProgram._replay = counted_replay
        loop._Block._body, loop._Block.__call__ = counted_body, counted_call
        frames.FrameProgram.run = counted_run


GRAPHS: Graphs | None = None


def drive_cli(fm, fb, fq, argv: list[str]) -> tuple:
    """``cvnerf_torch.cli.main(argv)`` with the counts set to 0 just
    before and read just after; returns (result, counts, per-step launch
    counts, per-frame launch counts). A block's steps count one by one
    (``Graphs``), in order with the single steps; a replayed frame counts
    what it launched. ``drive_cli.programs`` holds the call's
    frame-program captures, replays and eager frames."""
    from cvnerf_torch import cli
    from cvnerf_torch.render import frames
    from cvnerf_torch.train import loop

    def counts():
        return read_counts(fm, fb, fq)
    with PerCall(counts, loop, "make_train_step", factory=True) as steps, \
            PerCall(counts, frames.FramePrograms, "__call__") as frame_calls, \
            GRAPHS.into(steps.deltas):
        torch.cuda.synchronize()
        reset_counts(fm, fb, fq)
        before = dict(GRAPHS.totals)
        result = cli.main(argv)
        torch.cuda.synchronize()
        total = read_counts(fm, fb, fq)
    drive_cli.programs = {k: v - before[k] for k, v in GRAPHS.totals.items()}
    return result, total, steps.deltas, frame_calls.deltas


def check_calls(what: str, deltas: list[dict], n: int, want: dict) -> None:
    want = {"fwd": 0, "bwd": 0, "int8": 0, "fwd_plain": 0, "bwd_plain": 0,
            "int8_plain": 0, **want}
    bad = [d for d in deltas if d != want]
    if len(deltas) != n or bad:
        fail(f"{what}: {len(deltas)} calls (expected {n}), launch counts "
             f"off {want}: {bad[:3]}")


def cli_base(tmp: str) -> list[str]:
    """Phase 7's CLI flags: ``configs/lego.txt`` on its fixture, logs
    under ``tmp``."""
    logs = os.path.join(tmp, "cli_logs")
    lego = str(Path(__file__).resolve().parent / "configs" / "lego.txt")
    return ["--config", lego, "--data_dir", os.path.join(tmp, "lego_fixture"),
            "--base_dir", logs, "--save_dir", logs, "--testskip", "1",
            "--ckpt_freq", "30", "--val_freq", "30", "--vid_freq", "0",
            "--print_freq", "10", "--deterministic_resample"]


def phase_cli(fm, fb, fq, card: str, tmp: str) -> dict:
    """The training entry point (main path): ``cvnerf_torch.cli.main`` on a
    lego-shaped fixture written by the port's generator. An uninterrupted
    bf16 run with validation and test; a second run stopped at its step-30
    checkpoint and resumed, whose final checkpoint must equal the first's
    bitwise; ``--render_only --render_test`` (the logged test PSNR again);
    ``--render_only --int8``; ``from_run_dir`` serving the run; 3 fp32
    steps. Returns the launch counts and the numbers it printed."""
    from cvnerf_torch.data.synthetic import make_blender_dataset
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.serve import NerfRenderer
    from cvnerf_torch.train.checkpoint import (Checkpointer,
                                               restore_checkpoint,
                                               restore_params)
    from cvnerf_torch.train.state import create_train_state
    from cvnerf_torch.utils.tree import tree_leaves
    data = os.path.join(tmp, "lego_fixture")
    t0 = time.perf_counter()
    make_blender_dataset(data, n_train=8, n_val=2, n_test=2, h=800, w=800,
                         camera_angle_x=0.6911112, texture="normals")
    fixture_s = time.perf_counter() - t0
    print(f"cli: wrote an 800x800 blender fixture (8 train, 2 val, 2 test "
          f"views) in {fixture_s:.2f} s", flush=True)
    logs = os.path.join(tmp, "cli_logs")
    base = cli_base(tmp)
    chunk, hw = 4096, SERVE_HW          # lego.txt's chunk default; half_res
    per_frame = {"fwd": 2 * -(-hw * hw // chunk)}                  # 80
    total = {k: 0 for k in read_counts(fm, fb, fq)}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # -- uninterrupted run ------------------------------------------------
    run_a = os.path.join(logs, "lego_a")
    t0 = time.perf_counter()
    _, counts, steps, frames = drive_cli(
        fm, fb, fq, [*base, "--name", "lego_a", "--iters", "61"])
    cli_wall_s = time.perf_counter() - t0
    programs = drive_cli.programs
    add(counts)
    check_calls("cli train steps", steps, 60, {"fwd": 2, "bwd": 2})
    check_calls("cli validation and test frames", frames, 6, per_frame)
    ckpts = sorted(os.listdir(os.path.join(run_a, "torch_checkpoints")))
    if ckpts != ["000030.pt", "000060.pt"]:
        fail(f"cli checkpoints {ckpts}, expected steps 30 and 60")
    with open(os.path.join(run_a, "metrics.jsonl")) as fp:
        recs = [json.loads(line) for line in fp]
    logged = [r for r in recs if "lr" in r]
    if [r["step"] for r in logged] != [10, 20, 30, 40, 50, 60] or not all(
            np.isfinite(r["loss"]) for r in logged):
        fail(f"cli: logged steps or losses wrong: {logged}")
    test_rec = [r for r in recs if "test_psnr" in r]
    rays = float(np.median([r["rays_per_sec"] for r in logged]))
    step_ms = 1024 / rays * 1e3               # lego.txt's n_rays
    vals = [r["val_psnr"] for r in recs if "val_psnr" in r]
    from cvnerf_torch.data.datasets import load_scene
    from cvnerf_torch.utils.image import ssim_images
    t0 = time.perf_counter()
    scene = load_scene(data, "blender", half_res=True, testskip=1,
                       white_bkg=True)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssim_images(scene.images[0], scene.images[1])
    ssim_ms = (time.perf_counter() - t0) * 1e3
    rest_s = cli_wall_s - load_s - 60 * step_ms / 1e3
    print(f"cli: the uninterrupted run took {cli_wall_s:.2f} s wall: scene "
          f"loading {load_s:.2f} s (12 PNGs read and resized to 400x400, "
          f"timed apart), 60 steps ~{60 * step_ms / 1e3:.2f} s, the rest "
          f"{rest_s:.2f} s (set-up, 2 validations of 2 frames, 2 checkpoint "
          f"saves, the test eval of 2 frames; one SSIM {ssim_ms:.1f} ms)",
          flush=True)
    print(f"cli: 60 lego-shaped bf16 steps through python -m "
          f"cvnerf_torch.cli: loss {logged[0]['loss']:.4f} -> "
          f"{logged[-1]['loss']:.4f}, val psnr {vals}, test psnr "
          f"{test_rec[-1]['test_psnr']:.4f}; median step {step_ms:.3f} ms "
          f"({rays:.1f} rays/s, metrics.jsonl); launches {counts}; every "
          f"step 2 + 2, every frame {per_frame['fwd']} forward, plain 0",
          flush=True)

    # -- stopped at step 30, resumed to 60 ---------------------------------
    run_b = os.path.join(logs, "lego_b")
    _, counts, steps, _ = drive_cli(
        fm, fb, fq, [*base, "--name", "lego_b", "--iters", "31"])
    add(counts)
    check_calls("cli first half", steps, 30, {"fwd": 2, "bwd": 2})
    _, counts, steps, _ = drive_cli(
        fm, fb, fq, [*base, "--name", "lego_b", "--iters", "61"])
    add(counts)
    check_calls("cli resumed half", steps, 30, {"fwd": 2, "bwd": 2})
    a = torch.load(os.path.join(run_a, "torch_checkpoints", "000060.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(run_b, "torch_checkpoints", "000060.pt"),
                   weights_only=True)
    diffs = walk_diffs(a, b)
    print(f"cli resume: the run stopped at step 30 and resumed to 60 equals "
          f"the uninterrupted run bitwise: {not diffs} (params, Adam moments, "
          f"count, step)", flush=True)
    if diffs:
        fail(f"cli resume differs from the uninterrupted run: "
             f"{dict(list(diffs.items())[:8])}")

    # -- render-only: the test views, then int8 ----------------------------
    out, counts, steps, frames = drive_cli(
        fm, fb, fq, [*base, "--name", "lego_a", "--iters", "61",
                     "--render_only", "--render_test"])
    add(counts)
    check_calls("cli --render_only frames", frames, 2, per_frame)
    if steps or out.get("test_psnr") != test_rec[-1]["test_psnr"]:
        fail(f"--render_test psnr {out} != the logged {test_rec[-1]}")
    q, counts, _, frames = drive_cli(
        fm, fb, fq, [*base, "--name", "lego_a", "--iters", "61",
                     "--render_only", "--render_test", "--int8"])
    add(counts)
    check_calls("cli --render_only --int8 frames", frames, 2,
                {"int8": per_frame["fwd"]})
    print(f"cli --render_only --render_test: test psnr {out['test_psnr']:.6f}"
          f" (logged {test_rec[-1]['test_psnr']:.6f}, equal); --int8 "
          f"{q['test_psnr']:.4f}, {counts['int8']} int8 launches and no other",
          flush=True)
    if not np.isfinite(q["test_psnr"]):
        fail("int8 render-only test psnr is not finite")

    # -- serve the run -----------------------------------------------------
    r = NerfRenderer.from_run_dir(run_a, device="cuda")
    saved, step = restore_params(os.path.join(run_a, "torch_checkpoints"))
    same = step == r.step == 60 and all(
        torch.equal(u.cpu(), v) for u, v in zip(tree_leaves(r.params),
                                                tree_leaves(saved)))
    r.render_pose(pose(1.5))                                     # warm
    torch.cuda.synchronize()
    reset_counts(fm, fb, fq)
    t0 = time.perf_counter()
    rgb = r.render_pose(pose(0.5))
    frame_ms = (time.perf_counter() - t0) * 1e3
    served = read_counts(fm, fb, fq)
    add(served)
    want = {"fwd": 2 * -(-hw * hw // CHUNK), "bwd": 0, "int8": 0,
            "fwd_plain": 0, "bwd_plain": 0, "int8_plain": 0}
    print(f"cli: from_run_dir serves step {r.step}, params bitwise the "
          f"checkpoint's: {same}; a {rgb.shape} frame in {frame_ms:.1f} ms "
          f"wall, launches {served}", flush=True)
    if not same or served != want or not np.isfinite(rgb).all() \
            or rgb.shape != (hw, hw, 3):
        fail("from_run_dir did not serve the CLI's run as saved")

    # -- the checkpoint writer's enqueue and drain -------------------------
    template = create_train_state(PRNGKey(SEED),
                                  device="cuda")
    state = restore_checkpoint(os.path.join(run_a, "torch_checkpoints"),
                               template)
    enq, drain = [], []
    with Checkpointer(os.path.join(tmp, "ckpt_timing")) as w:
        for k in range(5):
            state.step = 100 + k
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w.save(state)
            t1 = time.perf_counter()
            w.wait()
            t2 = time.perf_counter()
            enq.append((t1 - t0) * 1e3)
            drain.append((t2 - t1) * 1e3)
    enqueue_ms, drain_ms = float(np.median(enq)), float(np.median(drain))

    # -- fp32, the --no-bf16 path -----------------------------------------
    f32, counts, steps, frames = drive_cli(
        fm, fb, fq, [*base, "--name", "lego_fp32", "--iters", "4",
                     "--no-bf16", "--val_freq", "0", "--ckpt_freq", "0"])
    add(counts)
    check_calls("cli fp32 steps", steps, 3, {"fwd": 2, "bwd": 2})
    check_calls("cli fp32 test frames", frames, 2, per_frame)
    if not np.isfinite(f32["loss"]):
        fail("cli fp32: the loss is not finite")

    print(f"cli summary: median step {step_ms:.3f} ms, {rays:.1f} rays/s "
          f"(metrics.jsonl of the uninterrupted run); checkpoint save "
          f"enqueue {enqueue_ms:.2f} ms, drain {drain_ms:.2f} ms (median of "
          f"5); fixture {fixture_s:.2f} s; launches {total}; card: {card}",
          flush=True)
    return {"counts": total, "step_ms": step_ms, "rays_per_sec": rays,
            "ckpt_enqueue_ms": enqueue_ms, "ckpt_drain_ms": drain_ms,
            "fixture_s": fixture_s, "cli_wall_s": cli_wall_s,
            "scene_load_s": load_s, "ssim_ms": ssim_ms,
            "served_frame_ms": frame_ms, "frame_programs": programs,
            "test_psnr": test_rec[-1]["test_psnr"],
            "int8_test_psnr": q["test_psnr"], "fp32_loss": f32["loss"]}


# Each lever alone on phase 5's lego-shaped bf16 configuration; the
# density-noise schedule needs density noise, so its case trains with
# noise_std 1.0 (the fern and llff bands' noise).
LEVERS = (
    ("ema_decay", dict(ema_decay=0.999)),
    ("noise_decay", dict(noise_decay=100)),
    ("freq_anneal", dict(freq_anneal=100)),
    ("distortion_loss", dict(distortion_loss=0.01, distortion_start=1,
                             distortion_ramp=2)),
    ("occlusion_loss", dict(occlusion_loss=0.01)),
    ("ray_batching", dict(ray_batching=True)),
    ("parity", dict(pixel_sampling="parity")),
)
LEVER_STEPS = 3
LEVER_TIMED = 8
LEVER_ROUNDS = 4


def plain_config(change: dict, kernels: str = "on"):
    """The step a lever is timed against: phase 5's, with density noise
    1.0 where the lever's case trains with it (a constant scale)."""
    tcfg = lego_train_config(torch.bfloat16, kernels)
    if "noise_decay" in change:
        tcfg = dataclasses.replace(tcfg, render=dataclasses.replace(
            tcfg.render, noise_std=1.0))
    return tcfg


def lever_config(change: dict, kernels: str = "on"):
    return dataclasses.replace(plain_config(change, kernels), **change)


def compare_steps(what: str, old, on, off, m_on: dict, m_off: dict,
                  lr: float) -> dict:
    """One step with the kernels against kernels="off" from the same
    state, at phase 6's bf16 tolerances: loss rel 2e-2; the gradients,
    read from Adam's first moment as (mu - 0.9 mu_old) / 0.1, within 0.15
    of each leaf's largest; params (and the EMA slot) within 2·lr; on an
    update count of 0, where Adam's step is ~lr·sign(g), within 1e-6 where
    |g| exceeds 0.3 of its leaf's largest."""
    from cvnerf_torch.utils.tree import tree_leaves
    first = old.opt_state.count == 0
    loss_err = abs(m_on["loss"] - m_off["loss"]) / abs(m_off["loss"])
    g_err, p_any, p_big = 0.0, 0.0, 0.0
    for a, b, m0, pa, pb in zip(tree_leaves(on.opt_state.mu),
                                tree_leaves(off.opt_state.mu),
                                tree_leaves(old.opt_state.mu),
                                tree_leaves(on.params),
                                tree_leaves(off.params)):
        g = (b - 0.9 * m0) / 0.1
        g_err = max(g_err, ((a - b).abs().max() / 0.1
                            / g.abs().max()).item())
        d = (pa - pb).abs()
        p_any = max(p_any, d.max().item())
        big = (g.abs() > 0.3 * g.abs().max()) & (g.abs() > 1e-6)
        if first and big.any():
            p_big = max(p_big, d[big].max().item())
    e_any = 0.0
    if on.ema_params is not None:
        e_any = max((a - b).abs().max().item() for a, b in zip(
            tree_leaves(on.ema_params), tree_leaves(off.ema_params)))
    ok = (loss_err <= 2e-2 and g_err <= 0.15 and p_any <= 2 * lr + 1e-6
          and p_big <= 1e-6 and e_any <= 2 * lr + 1e-6)
    if not ok:
        fail(f"{what}: the two steps disagree: loss rel "
             f"{loss_err:.2e}, grads {g_err:.2e}, params {p_any:.2e} "
             f"(large-|g| {p_big:.2e}), ema {e_any:.2e}")
    return {"loss_rel": loss_err, "grad_rel": g_err, "param_max": p_any,
            "param_big": p_big, "ema_max": e_any}


def time_trainer(tcfg, state, images, poses, steps: int,
                 grid=None) -> float:
    """Median ms between consecutive steps of ``Trainer.run`` (CUDA events
    recorded in a per-step callback, as phase 5 times its steps); with
    ``grid``, the occupancy steps through it."""
    from cvnerf_torch.train.loop import Trainer
    tr = Trainer(tcfg, state, images, poses, [0, 1], seed=SEED)
    if grid is not None:
        tr.set_occupancy(grid)
    events = []

    def on_step(i, trainer, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    tr.add_callback(1, on_step)
    tr.run(1, steps + 2)
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b)
                            for a, b in zip(events, events[1:])]))


def live_density(params: dict, tcfg, c2w) -> dict:
    """Each net's share of points with a positive raw density: every 25th
    pixel of the view ``c2w``, 64 depths from near to far, through the
    plain forward (uncounted). A net whose share is near 0 passes almost
    no gradient, so a step from it compares next to nothing."""
    from cvnerf_torch.ops.fused_mlp import fused_nerf_plain
    from cvnerf_torch.ops.rays import ray_grid
    o, d = ray_grid(tcfg.height, tcfg.width, tcfg.focal, c2w)
    o, d = o.reshape(-1, 3)[::25], d.reshape(-1, 3)[::25]
    t = torch.linspace(tcfg.near, tcfg.far, 64, device=o.device)
    pts = (o[:, None] + d[:, None] * t[None, :, None]).reshape(-1, 3)
    dirs = torch.nn.functional.normalize(d, dim=-1)[:, None].expand(
        -1, 64, 3).reshape(-1, 3)
    return {k: (fused_nerf_plain(p, pts, dirs, tcfg.render.mlp)[:, 3] > 0
                ).float().mean().item() for k, p in params.items()}


def op_times(tcfg, state, images, poses, n: int = 3) -> dict:
    """Host and device microseconds a step by op name, from
    ``torch.profiler`` over ``n`` steps of ``Trainer.run`` after two
    unprofiled ones: an op's self time on the host, a kernel's on the
    card."""
    from torch.profiler import ProfilerActivity, profile

    from cvnerf_torch.train.loop import Trainer
    tr = Trainer(tcfg, state, images, poses, [0, 1], seed=SEED)
    tr.run(1, 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(3, 3 + n)
        torch.cuda.synchronize()
    host, dev = {}, {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total / n
        else:
            host[e.key] = host.get(e.key, 0.0) + e.self_cpu_time_total / n
    return {"host": host, "device": dev}


def top_growth(lever: dict, plain: dict, k: int = 3) -> list:
    """The ``k`` names whose time a step grew most from ``plain`` to
    ``lever``, as ``[name, microseconds added]``."""
    grown = {n: lever.get(n, 0.0) - plain.get(n, 0.0)
             for n in set(lever) | set(plain)}
    return [[n[:60], round(d, 1)] for n, d in
            sorted(grown.items(), key=lambda kv: -kv[1])[:k]]


def phase_levers(fm, fb, fq, card: str) -> dict:
    """Each training lever alone at the lego training shape (main path):
    LEVER_STEPS steps through the kernels, each held against the same step
    with kernels="off" from the same state, exactly 2 + 2 launches a step
    and no plain call; then LEVER_ROUNDS rounds of LEVER_TIMED steps with
    the lever and LEVER_TIMED plain steps (the order alternating each
    round), their medians and spread; a profile of a few steps of each,
    naming the ops that grew most; and the cost of the pixel draws at the
    lego shape."""
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.ops.rng import (PRNGKey, choice_without_replacement,
                                      fold_in, sample_without_replacement)
    from cvnerf_torch.train.loop import make_train_step
    from cvnerf_torch.train.state import create_train_state
    images_np, poses_np = bench_scene(TRAIN_HW, TRAIN_HW)
    images = torch.as_tensor(images_np, device="cuda")
    poses = torch.as_tensor(poses_np, device="cuda")
    idx = torch.tensor([0, 1])

    # Every config has phase 5's lr and networks; a step leaves its input
    # state as it was, so one fresh state serves every run: phase 6's
    # (key SEED + 5), whose nets must put a positive density on a good
    # share of the training rays' points.
    base = lego_train_config(torch.bfloat16)
    start = create_train_state(PRNGKey(SEED + 5), lr=base.lr,
                               lr_decay=base.lr_decay, mlp=base.render.mlp,
                               device="cuda", ema=True)
    live = live_density(start.params, base, poses[0])
    print(f"levers: the starting nets' share of points with a positive "
          f"density along the first view's rays: {live}", flush=True)
    if min(live.values()) < 0.1:
        fail(f"levers: the starting state's density is <= 0 almost "
             f"everywhere ({live}); its steps would compare almost no "
             f"gradient")

    def fresh(tcfg):
        return dataclasses.replace(
            start, ema_params=start.ema_params if tcfg.ema_decay > 0
            else None)

    total = {k: 0 for k in read_counts(fm, fb, fq)}
    out, plain_ops = {}, {}
    for name, change in LEVERS:
        tcfg = lever_config(change)
        step_on = make_train_step(tcfg)
        step_off = make_train_step(lever_config(change, "off"))
        state, errs = fresh(tcfg), []
        for i in range(1, LEVER_STEPS + 1):
            key = fold_in(PRNGKey(SEED), i)
            torch.cuda.synchronize()
            reset_counts(fm, fb, fq)
            on, m_on = step_on(state, key, images, poses, idx, False)
            torch.cuda.synchronize()
            counts = read_counts(fm, fb, fq)
            for k, v in counts.items():
                total[k] += v
            if counts != {"fwd": 2, "bwd": 2, "int8": 0, "fwd_plain": 0,
                          "bwd_plain": 0, "int8_plain": 0}:
                fail(f"levers {name}: step {i} launched {counts}, not "
                     f"2 + 2 kernels and no plain call")
            off, m_off = step_off(state, key, images, poses, idx, False)
            m_on = {k: float(v) for k, v in m_on.items()}
            m_off = {k: float(v) for k, v in m_off.items()}
            if not all(np.isfinite(v) for v in m_on.values()):
                fail(f"levers {name}: non-finite metrics {m_on}")
            errs.append(compare_steps(f"levers {name}", state, on, off,
                                      m_on, m_off, tcfg.lr))
            state = on
        pcfg = plain_config(change)
        times = {"lever": [], "plain": []}
        for r in range(LEVER_ROUNDS):
            turns = (("plain", pcfg), ("lever", tcfg))
            for arm, cfg in turns if r % 2 == 0 else turns[::-1]:
                times[arm].append(time_trainer(cfg, fresh(cfg), images_np,
                                               poses_np, LEVER_TIMED))
        diffs = [a - b for a, b in zip(times["lever"], times["plain"])]
        noisy = "noise_decay" in change
        if noisy not in plain_ops:
            plain_ops[noisy] = op_times(pcfg, fresh(pcfg), images_np,
                                        poses_np)
        ops = op_times(tcfg, fresh(tcfg), images_np, poses_np)
        worst = {k: max(e[k] for e in errs) for k in errs[0]}
        out[name] = {
            "step_ms": float(np.median(times["lever"])),
            "plain_step_ms": float(np.median(times["plain"])),
            "step_ms_rounds": times["lever"],
            "plain_step_ms_rounds": times["plain"],
            "added_ms": float(np.median(diffs)),
            "added_ms_range": [min(diffs), max(diffs)],
            "host_growth_us": top_growth(ops["host"],
                                         plain_ops[noisy]["host"]),
            "device_growth_us": top_growth(ops["device"],
                                           plain_ops[noisy]["device"]),
            **worst}
        o = out[name]
        print(f"levers {name} ({change}): {LEVER_STEPS} steps 2 + 2 "
              f"launches each, plain 0; vs kernels='off' loss rel "
              f"{worst['loss_rel']:.2e}, grads {worst['grad_rel']:.2e}, "
              f"params {worst['param_max']:.2e} (large-|g| "
              f"{worst['param_big']:.2e}), ema {worst['ema_max']:.2e}; "
              f"{LEVER_ROUNDS} interleaved rounds of {LEVER_TIMED} steps: "
              f"lever {o['step_ms']:.3f} ms (rounds "
              f"{[round(t, 3) for t in times['lever']]}), plain "
              f"{o['plain_step_ms']:.3f} ms (rounds "
              f"{[round(t, 3) for t in times['plain']]}{', noise 1.0' if noisy else ''}), "
              f"added {o['added_ms']:+.3f} ms (rounds {min(diffs):+.3f} "
              f"to {max(diffs):+.3f}); profiler, most grown a step: host "
              f"{o['host_growth_us']} us, device {o['device_growth_us']} "
              f"us", flush=True)

    # The pixel draws at the lego shape, both on the card: the Feistel draw
    # (one kernel launch) and the parity permutation of all 160,000
    # pixels.
    key, n_rays = PRNGKey(SEED), lever_config({}).n_rays
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_without_replacement(key, n_rays, TRAIN_HW * TRAIN_HW, "cuda")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prp_ms = float(np.median(walls))
    parity_ms = time_ms(lambda: choice_without_replacement(
        key, n_rays, TRAIN_HW * TRAIN_HW, "cuda"))
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        choice_without_replacement(key, n_rays, TRAIN_HW * TRAIN_HW, "cuda")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    parity_wall_ms = float(np.median(walls))
    print(f"levers: pixel draw at {TRAIN_HW}x{TRAIN_HW}: prp (Feistel, "
          f"card) {prp_ms:.3f} ms wall; parity (2-round sort of "
          f"{TRAIN_HW * TRAIN_HW} keys, card) {parity_ms:.3f} ms by CUDA "
          f"events, {parity_wall_ms:.3f} ms wall; launches {total}; card: "
          f"{card}", flush=True)
    return {"counts": total, "levers": out, "live_density": live,
            "prp_draw_ms": prp_ms, "parity_draw_ms": parity_ms,
            "parity_draw_wall_ms": parity_wall_ms}


def walk_diffs(a, b) -> dict:
    """Leaves of two nested checkpoint dicts that are not bitwise equal."""
    diffs = {}

    def walk(x, y, path=""):
        if isinstance(x, dict):
            if sorted(x) != sorted(y):
                diffs[path] = (sorted(x), sorted(y))
                return
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                diffs[path] = (x - y).abs().max().item()
        elif x != y:
            diffs[path] = (x, y)
    walk(a, b)
    return diffs


def phase_lever_cli(fm, fb, fq, card: str, tmp: str, data: str) -> dict:
    """EMA and the frequency anneal through the training entry point (main
    path): ``--ema_decay 0.999 --freq_anneal 40`` on phase 7's fixture, an
    uninterrupted run to step 60 and one stopped at its step-30 checkpoint
    and resumed, whose final checkpoints (the EMA slot included) must be
    bitwise equal; then ``from_run_dir`` at the mid-anneal step 30 must
    serve the average through the window at 30 / 40, frame for frame."""
    from cvnerf_torch.models.nerf_mlp import (NerfMLPConfig,
                                              anneal_model_params)
    from cvnerf_torch.render.frames import render_image
    from cvnerf_torch.serve import NerfRenderer
    from cvnerf_torch.train.checkpoint import restore_params
    from cvnerf_torch.utils.tree import tree_leaves
    logs = os.path.join(tmp, "lever_logs")
    lego = str(Path(__file__).resolve().parent / "configs" / "lego.txt")
    base = ["--config", lego, "--data_dir", data,
            "--base_dir", logs, "--save_dir", logs, "--testskip", "1",
            "--ckpt_freq", "30", "--val_freq", "30", "--vid_freq", "0",
            "--print_freq", "10", "--deterministic_resample",
            "--ema_decay", "0.999", "--freq_anneal", "40"]
    per_frame = {"fwd": 2 * -(-SERVE_HW * SERVE_HW // 4096)}
    total = {k: 0 for k in read_counts(fm, fb, fq)}

    def drive(argv, n_steps, n_frames):
        _, counts, steps, frames = drive_cli(fm, fb, fq, argv)
        check_calls(f"lever cli {argv[-4:]} steps", steps, n_steps,
                    {"fwd": 2, "bwd": 2})
        check_calls(f"lever cli {argv[-4:]} frames", frames, n_frames,
                    per_frame)
        for k, v in counts.items():
            total[k] += v

    drive([*base, "--name", "a", "--iters", "61"], 60, 6)
    drive([*base, "--name", "b", "--iters", "31"], 30, 4)
    drive([*base, "--name", "b", "--iters", "61"], 30, 4)
    ck = {r: os.path.join(logs, r, "torch_checkpoints") for r in "ab"}
    a = torch.load(os.path.join(ck["a"], "000060.pt"), weights_only=True)
    b = torch.load(os.path.join(ck["b"], "000060.pt"), weights_only=True)
    diffs = walk_diffs(a, b)
    if "ema_params" not in a or diffs:
        fail(f"lever cli: the resumed EMA run differs from the "
             f"uninterrupted one (EMA slot saved: {'ema_params' in a}): "
             f"{dict(list(diffs.items())[:8])}")
    # Step 30 lies inside the anneal horizon of 40.
    r = NerfRenderer.from_run_dir(os.path.join(logs, "b"), step=30,
                                  device="cuda")
    ema, _ = restore_params(ck["b"], step=30)
    raw, _ = restore_params(ck["b"], step=30, prefer_ema=False)
    want = anneal_model_params(ema, NerfMLPConfig(), 30 / 40)
    same = r.step == 30 and all(
        torch.equal(u.cpu(), v) for u, v in zip(tree_leaves(r.params),
                                                tree_leaves(want)))
    differs_from_raw = any(not torch.equal(u, v) for u, v in zip(
        tree_leaves(ema), tree_leaves(raw)))
    c2w = torch.as_tensor(pose(0.5)[:3], device="cuda")
    reset_counts(fm, fb, fq)
    got = r.render_pose(pose(0.5))
    served = read_counts(fm, fb, fq)
    for k, v in served.items():
        total[k] += v
    nets = {k: fm.FusedNerfWeights({n: {q: t.to(r.device) for q, t in lay.items()}
                                    for n, lay in v.items()},
                                   NerfMLPConfig(), torch.bfloat16)
            for k, v in want.items()}
    ref = render_image(nets, r.height, r.width, r.focal, c2w, r.near, r.far,
                       r.cfg, chunk=r.chunk)["rgb"].cpu().numpy()
    frame_equal = bool(np.array_equal(got, ref))
    print(f"lever cli: --ema_decay 0.999 --freq_anneal 40, stopped at 30 "
          f"and resumed to 60, bitwise the uninterrupted run (params, Adam "
          f"moments, EMA slot, count, step): True; from_run_dir at the "
          f"mid-anneal step 30 serves the average through the window "
          f"30/40 (params bitwise: {same}; the average differs from the raw "
          f"params: {differs_from_raw}; its frame equals that of the "
          f"windowed average: {frame_equal}); launches {total}, every step "
          f"2 + 2, every frame {per_frame['fwd']} forward, plain 0; card: "
          f"{card}", flush=True)
    if not (same and differs_from_raw and frame_equal
            and served["fwd"] == 2 * -(-SERVE_HW * SERVE_HW // CHUNK)
            and served["fwd_plain"] == 0):
        fail("lever cli: from_run_dir does not serve the windowed average")
    return {"counts": total}


def phase_band(fm, fb, fq, card: str, tmp: str) -> dict:
    """A quality band on the card (main path): ``sphere_hi_3000`` through
    ``cvnerf_torch.quality_run`` at full width, every train step 2 + 2
    launches and every frame through the forward kernel; passes at or
    above the band's floor."""
    from cvnerf_torch import quality_run
    from cvnerf_torch.render import frames
    from cvnerf_torch.train import loop

    def counts():
        return read_counts(fm, fb, fq)
    with PerCall(counts, loop, "make_train_step", factory=True) as steps, \
            PerCall(counts, frames.FramePrograms, "__call__") as frame_calls, \
            GRAPHS.into(steps.deltas):
        torch.cuda.synchronize()
        reset_counts(fm, fb, fq)
        res = quality_run.run(["--scene", "sphere_hi", "--iters", "3000",
                               "--workdir", os.path.join(tmp, "band")])
        torch.cuda.synchronize()
        total = read_counts(fm, fb, fq)
    per_frame = {"fwd": 2 * -(-200 * 200 // 4096)}           # 20
    check_calls("band steps", steps.deltas, 2999, {"fwd": 2, "bwd": 2})
    check_calls("band frames", frame_calls.deltas, len(frame_calls.deltas),
                per_frame)
    print(f"band {res['key']}: test PSNR {res['psnr']:.4f} dB against the "
          f"floor {res['floor']} dB (the JAX package measured "
          f"{res['jax_measured']} dB); {res['steps']} steps in "
          f"{res['seconds']:.1f} s wall; launches {total} (every step "
          f"2 + 2, {len(frame_calls.deltas)} frames of {per_frame['fwd']}); "
          f"card: {card}", flush=True)
    if not res["passed"]:
        fail(f"band {res['key']}: {res['psnr']:.4f} dB is below the floor "
             f"{res['floor']} dB")
    return {"counts": total, **res}


def write_run_dir(run: str, cfg, init, gen_seed: int,
                  bf16: bool = True) -> None:
    """A run directory for the lego serving shape written by the port's
    own writers (``write_scene_snapshot`` and a ``Checkpointer``): seeded
    random weights (coarse, then fine, from one generator) at step 1000 and
    a few camera poses, which --int8 calibrates on."""
    from cvnerf_torch.serve import write_scene_snapshot
    from cvnerf_torch.train.checkpoint import Checkpointer
    from cvnerf_torch.train.state import TrainState, make_optimizer
    write_scene_snapshot(
        run, height=SERVE_HW, width=SERVE_HW, focal=555.0, near=2.0, far=6.0,
        ndc=False, ndc_variant="canonical", white_bkg=True, n_coarse=64,
        n_fine=128, bf16=bf16, mlp=cfg, sorted_resample=True, pallas="auto",
        calib_poses=np.stack([pose(t) for t in np.linspace(
            0, 2 * np.pi, 8, endpoint=False)]))
    from cvnerf_torch.ops.rng import PRNGKey, split
    params = {net: init(key, cfg)
              for net, key in zip(("coarse", "fine"), split(PRNGKey(gen_seed)))}
    state = TrainState(params=params,
                       opt_state=make_optimizer(5e-4, 500).init(params),
                       step=1000)
    with Checkpointer(os.path.join(run, "torch_checkpoints")) as ckpt:
        ckpt.save(state, wait=True)


def phase_int8_serve(fm, fb, fq, run: str, c2w, bf16_renderer, rgb_bf16,
                     acc_bf16, t_json_bf16):
    """Serve the run directory with ``--int8`` through the server's own
    startup (``renderer_from_args``, then the int8 step ``main`` runs):
    ``/health``, a png and a json+depth ``/render``; exactly 40 int8 launches
    a frame and nothing else. Then, outside the counted run: the served
    frame against the same pose rendered on the card with ``kernels="off"``
    from the same quantized nets (bitwise), and against phase 2's bf16
    frame of the same weights.

    The check against bf16: the last sample of a ray lies at ``far`` with
    delta 1e10, so a pixel whose far-end density lies near 0 renders that
    sample's colour or the background, whichever side of 0 it lands (its
    opacity jumps by ~1, its rgb by up to ~0.5). The random net has such
    pixels. So at most INT8_FLIP_SHARE of the pixels may flip (opacity
    differing by more than 0.5), each flipped pixel's terminal density must
    change sign between the two fine nets (the witness that the flip is
    that sample), and every other pixel must lie within the JAX package's
    int8 bound, 0.2 (tests/test_quantize.py:169, :251)."""
    from cvnerf_torch.ops.rays import ray_grid
    from cvnerf_torch.render.frames import render_image
    from cvnerf_torch.server import (build_parser, int8_from_args,
                                     make_server, renderer_from_args)
    args = build_parser().parse_args(["--run", run, "--device", "cuda",
                                      "--port", "0", "--int8"])
    reset_counts(fm, fb, fq)
    renderer = renderer_from_args(args)
    int8_from_args(renderer, args)
    srv = make_server(renderer, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        health = json.loads(http(url + "/health")[0])
        if health["status"] != "ok" or health["height"] != SERVE_HW:
            fail(f"bad /health under --int8: {health}")
        t0 = time.time()
        body, ctype = http(url + "/render", {"c2w": c2w})
        t_png = time.time() - t0
        check_png_or_ppm(body, ctype, SERVE_HW, SERVE_HW)
        t0 = time.time()
        body, _ = http(url + "/render", {"c2w": c2w, "format": "json",
                                         "include_depth": True})
        t_json = time.time() - t0
        torch.cuda.synchronize()
        counts = read_counts(fm, fb, fq)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    out = json.loads(body)
    rgb = np.asarray(out["rgb"], np.float32)
    depth = np.asarray(out["depth"], np.float32)
    if (rgb.shape != (SERVE_HW, SERVE_HW, 3)
            or depth.shape != (SERVE_HW, SERVE_HW)
            or not (np.isfinite(rgb).all() and np.isfinite(depth).all())):
        fail("int8 json render: wrong shape or non-finite values")
    acc = np.asarray(out["acc"], np.float32)
    per_frame = 2 * -(-SERVE_HW * SERVE_HW // CHUNK)          # 40
    want = {"fwd": 0, "bwd": 0, "int8": 2 * per_frame, "fwd_plain": 0,
            "bwd_plain": 0, "int8_plain": 0}
    print(f"serve --int8: 2 x 200 from /render (png {ctype}, json+depth); "
          f"png {t_png * 1e3:.1f} ms, json {t_json * 1e3:.1f} ms wall (bf16 "
          f"json {t_json_bf16 * 1e3:.1f} ms); launches {counts} (expected "
          f"{want})", flush=True)
    if counts != want:
        fail("int8 serving did not run exactly through the int8 kernel")

    # The same pose through the plain int8 version on the card, from the
    # served renderer's quantized nets: the kernel repeats every rounding.
    c2w_t = pose_on_card(c2w)
    calls = fq.fused_nerf_int8_plain.calls
    launches = fq.fused_nerf_apply_int8.launches
    plain = render_image({k: w.qp for k, w in renderer._nets.items()},
                         SERVE_HW, SERVE_HW, renderer.focal, c2w_t,
                         renderer.near, renderer.far,
                         dataclasses.replace(renderer.cfg, kernels="off"),
                         chunk=renderer.chunk, key=renderer._key)
    plain = {k: v.cpu().numpy() for k, v in plain.items()}
    if (fq.fused_nerf_int8_plain.calls - calls != per_frame
            or fq.fused_nerf_apply_int8.launches != launches):
        fail("the kernels='off' int8 render did not run the plain version")
    unequal = {k: int((plain[k] != v).sum())
               for k, v in (("rgb", rgb), ("acc", acc), ("depth", depth))}
    print(f"served int8 frame vs kernels='off' int8 frame on the card: "
          f"unequal values {unequal} (bitwise required)", flush=True)
    if any(unequal.values()):
        fail("the served int8 frame differs from its plain version")

    # Against bf16, with the witness of every flipped pixel: its terminal
    # sample (t = far) has densities of opposite sign under the two nets.
    flipped = np.abs(acc - acc_bf16) > 0.5
    drgb = np.abs(rgb - rgb_bf16).max(axis=-1)
    diff = float(drgb[~flipped].max())
    share = float(flipped.mean())
    rays_o, rays_d = (r.reshape(-1, 3) for r in ray_grid(
        SERVE_HW, SERVE_HW, renderer.focal, c2w_t))
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = rays_o + rays_d * torch.full_like(rays_o[:, :1], renderer.far)
    s8 = fq.fused_nerf_apply_int8(renderer._nets["fine"], pts, viewdirs
                                  )[:, 3].cpu().numpy()
    s16 = fm.fused_nerf_apply(bf16_renderer._nets["fine"], pts, viewdirs
                              )[:, 3].cpu().numpy()
    sign = ((s8 > 0) != (s16 > 0)).reshape(SERVE_HW, SERVE_HW)
    witnessed = int((flipped & sign).sum())
    sig_flip = (float(np.abs(s16[flipped.reshape(-1)]).max())
                if flipped.any() else 0.0)
    print(f"int8 vs bf16 frame: {share:.4%} of the pixels flip (tol "
          f"{INT8_FLIP_SHARE:.0%}), {witnessed} of {int(flipped.sum())} with "
          f"a terminal density of opposite sign under the two fine nets "
          f"({int(sign.sum())} such pixels in the frame); terminal |sigma| "
          f"bf16 at the flipped pixels max {sig_flip:.4e}, over the frame "
          f"median {float(np.median(np.abs(s16))):.4e}, |int8 - bf16| median "
          f"{float(np.median(np.abs(s8 - s16))):.4e}; the other pixels max "
          f"|rgb diff| {diff:.4e} (tol 0.2); all pixels max "
          f"{float(drgb.max()):.4f}", flush=True)
    if witnessed != int(flipped.sum()):
        fail("a flipped pixel is not explained by its terminal sample")
    if not (diff < 0.2 and share <= INT8_FLIP_SHARE):
        fail("the int8 frame is too far from the bf16 frame")

    # Phase 3's pose sequence under int8, for a frame time measured as
    # phase 3 measures the bf16 one.
    torch.cuda.synchronize()
    t0 = time.time()
    frames = renderer.render_video(np.stack([pose(0.3), pose(1.1)]))
    video_ms = (time.time() - t0) * 1e3
    if not np.array_equal(frames[0], rgb):
        fail("int8 render_video frame 0 differs from the served json render")
    print(f"int8 render_video: 2 frames in {video_ms:.1f} ms wall "
          f"({video_ms / 2:.1f} ms/frame)", flush=True)
    return counts


# -- phase 10: occupancy grids, mesh export, LPIPS --------------------------

OCC_RES = 192                 # the server's and the CLI's default lattice
OCC_BOUND = 1.5
MESH_RES = 256                # the mesh CLI's default lattice
OCC_REQUESTS = 10             # timed /render requests per server


def phase_occ_bake(fm, fb, fq, card: str, trained: dict, cfg) -> dict:
    """10a. The bake (main path of occupancy serving and training): the
    lego-shaped bf16 fine net of phase 5's trained state baked at res 192,
    dilate 1, bound 1.5 through the forward kernel: exactly
    ceil(192^3 / 65,536) = 108 launches and no plain call; the grid against
    the same bake with kernels="off" on the card within phase 1's bf16
    tolerance on sigma; the occupied share > 0; the bake's median ms."""
    from cvnerf_torch.render.occupancy import (bake_scene_occupancy,
                                               occupied_fraction)

    def bake(kernels="on"):
        return bake_scene_occupancy(trained, cfg, ndc=False, bound=OCC_BOUND,
                                    n_fine=128, resolution=OCC_RES,
                                    dilate=1, compute_dtype=torch.bfloat16,
                                    kernels=kernels)
    bake()                                                       # warm
    torch.cuda.synchronize()
    reset_counts(fm, fb, fq)
    grid = bake()
    torch.cuda.synchronize()
    counts = read_counts(fm, fb, fq)
    n_launch = -(-OCC_RES ** 3 // 65536)                          # 108
    check_calls("occupancy bake", [counts], 1, {"fwd": n_launch})
    off = bake("off")
    err = (grid.values - off.values).abs().max().item()
    frac = occupied_fraction(grid)
    bake_ms = time_ms(bake, reps=5, warmup=1)
    off_ms = time_ms(lambda: bake("off"), reps=3, warmup=0)
    print(f"occupancy bake: {OCC_RES}^3 lattice, dilate 1, bound "
          f"{OCC_BOUND}, the bf16 fine net of phase 5's trained state: "
          f"launches {counts} (expected {n_launch} forward, plain 0); vs "
          f"kernels='off' max |sigma diff| {err:.3e} (tol {TOL_BF16:g}); "
          f"occupied {frac:.4%}; bake {bake_ms:.3f} ms (median of 5, CUDA "
          f"events), kernels='off' {off_ms:.3f} ms; card: {card}",
          flush=True)
    if not err <= TOL_BF16:
        fail("occupancy bake: the kernel's grid disagrees with kernels='off'")
    if not 0.0 < frac:
        fail("occupancy bake: the trained net's grid is empty")
    return {"counts": counts, "bake_ms": bake_ms, "bake_off_ms": off_ms,
            "max_abs_err": err, "occupied_frac": frac}


def terminal_flips(fm, renderer, c2w_t, t_fine, hw: int) -> np.ndarray:
    """``[hw, hw]`` pixels whose terminal sample (the last fine depth,
    where the compositor's delta is 1e10) has a density of opposite sign
    through the forward kernel and its plain version. The grid places the
    samples, so both renders put every ray's samples at the same depths;
    such a pixel renders that sample's colour or what lies behind it,
    whichever side of 0 its density lands."""
    from cvnerf_torch.ops.rays import ray_grid
    rays_o, rays_d = (r.reshape(-1, 3) for r in ray_grid(
        hw, hw, renderer.focal, c2w_t))
    viewdirs = (rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
                ).contiguous()
    pts = (rays_o + rays_d * t_fine.reshape(-1, t_fine.shape[-1])[:, -1:]
           ).contiguous()
    s_k = fm.fused_nerf_apply(renderer._nets["fine"], pts, viewdirs)[:, 3]
    s_p = fm.fused_nerf_plain(renderer.params["fine"], pts, viewdirs,
                              renderer.cfg.mlp, renderer.cfg.compute_dtype
                              )[:, 3]
    return ((s_k > 0) != (s_p > 0)).reshape(hw, hw).cpu().numpy()


def serve_and_time(fm, fb, fq, run: str, flags: list[str], c2w) -> dict:
    """Start the server from its own argument parser with ``flags`` (the
    startup's launches counted apart), answer ``/render`` png
    OCC_REQUESTS times (counted, wall-timed) and a json+depth one;
    returns the renderer, the counts and times and the json frame."""
    from cvnerf_torch.server import (build_parser, int8_from_args,
                                     make_server, occupancy_from_args,
                                     renderer_from_args)
    args = build_parser().parse_args(["--run", run, "--device", "cuda",
                                      "--port", "0", *flags])
    torch.cuda.synchronize()
    reset_counts(fm, fb, fq)
    renderer = renderer_from_args(args)
    occupancy_from_args(renderer, args)
    int8_from_args(renderer, args)
    torch.cuda.synchronize()
    startup = read_counts(fm, fb, fq)
    srv = make_server(renderer, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        http(url + "/render", {"c2w": c2w})                       # warm
        torch.cuda.synchronize()
        reset_counts(fm, fb, fq)
        http_walls = []
        for _ in range(OCC_REQUESTS):
            t0 = time.perf_counter()
            body, ctype = http(url + "/render", {"c2w": c2w})
            http_walls.append((time.perf_counter() - t0) * 1e3)
        check_png_or_ppm(body, ctype, SERVE_HW, SERVE_HW)
        body, _ = http(url + "/render", {"c2w": c2w, "format": "json",
                                         "include_depth": True})
        torch.cuda.synchronize()
        frames = read_counts(fm, fb, fq)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    # The render alone, without HTTP and the png: render_pose wall, synced.
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.render_pose(c2w)
        walls.append((time.perf_counter() - t0) * 1e3)
    out = json.loads(body)
    frame = {k: np.asarray(out[k], np.float32) for k in ("rgb", "depth",
                                                         "acc")}
    if frame["rgb"].shape != (SERVE_HW, SERVE_HW, 3) or not all(
            np.isfinite(v).all() for v in frame.values()):
        fail(f"serve {flags}: wrong shape or non-finite frame")
    return {"renderer": renderer, "startup": startup, "frames": frames,
            "frame_ms": float(np.median(http_walls)),
            "frame_ms_all": http_walls, "render_ms": float(np.median(walls)),
            "frame": frame}


def phase_occ_serve(fm, fb, fq, card: str, run: str) -> dict:
    """10b, 10c. Occupancy serving (main path) of phase 7's trained run
    (400x400, 64 + 128 samples, bf16, its poses for int8): the server with
    ``--occupancy merge`` and ``full`` (each with trilinear, the server's
    default probe, and nearest) and ``full --occ_term 1e-3 --serve_coarse
    32 --serve_fine 64``, then ``--int8 --occupancy merge``, each answering
    /render at
    400x400: the startup bake 108 forward launches, then per frame 20
    fine launches (8,192 rays x 192 points in merge, x 128 in full, x 96
    with the reduced budget) and no coarse launch, no plain call (int8: 20
    int8 launches a frame and no forward launch). Each frame against the
    same pose rendered on the card with kernels="off" (the same nets, the
    same grid): int8 bitwise; bf16 at phase 4's tolerances (rgb 2e-2,
    depth 1e-1) on every pixel but those whose terminal density changes
    sign between the kernel and its plain version (at most
    INT8_FLIP_SHARE of them). Frame ms, median of OCC_REQUESTS png
    requests, beside the same requests to the plain bf16 server, and the
    render alone (``render_pose``, median of 5)."""
    from cvnerf_torch.render.frames import render_image
    c2w = pose(0.3)[:3].tolist()
    per_frame = -(-SERVE_HW * SERVE_HW // CHUNK)                  # 20
    n_frames = OCC_REQUESTS + 1
    bake = -(-OCC_RES ** 3 // 65536)
    plain = serve_and_time(fm, fb, fq, run, [], c2w)
    check_calls("plain server frames", [plain["frames"]], 1,
                 {"fwd": 2 * per_frame * n_frames})
    total = dict(plain["frames"])
    out, frames = {"plain_frame_ms": plain["frame_ms"],
                   "plain_render_ms": plain["render_ms"]}, {}
    modes = (("merge", ["--occupancy", "merge"], 192),
             ("merge_nearest", ["--occupancy", "merge", "--occ_interp",
                                "nearest"], 192),
             ("full_trilinear", ["--occupancy", "full"], 128),
             ("full_nearest", ["--occupancy", "full", "--occ_interp",
                               "nearest"], 128),
             ("full_term", ["--occupancy", "full", "--occ_term", "1e-3",
                            "--serve_coarse", "32", "--serve_fine", "64"],
              64),
             ("int8_merge", ["--int8", "--occupancy", "merge"], 192))
    for name, flags, points in modes:
        flags = [*flags, "--occupancy_res", str(OCC_RES)]
        s = serve_and_time(fm, fb, fq, run, flags, c2w)
        r = s["renderer"]
        int8 = "--int8" in flags
        check_calls(f"{name} startup", [s["startup"]], 1, {"fwd": bake})
        check_calls(f"{name} frames", [s["frames"]], 1,
                     {"int8" if int8 else "fwd": per_frame * n_frames})
        for k, v in s["startup"].items():
            total[k] += v + s["frames"][k]
        c2w_t = pose_on_card(c2w)
        rcfg = dataclasses.replace(r.cfg, kernels="off", return_weights=True)
        nets = ({k: w.qp for k, w in r._nets.items()} if int8
                else r.params)
        off = render_image(nets, SERVE_HW, SERVE_HW, r.focal, c2w_t, r.near,
                           r.far, rcfg, chunk=r.chunk, key=r._key,
                           occupancy=r.occupancy)
        got = s["frame"]
        ref = {k: off[k].cpu().numpy() for k in ("rgb", "depth", "acc")}
        seen = float((got["acc"] > 0.05).mean())
        if not seen > 0.01:
            fail(f"occupancy serve {name}: the frame is empty (acc > 0.05 "
                 f"on {seen:.4%} of the pixels): nothing to compare")
        if int8:
            unequal = {k: int((ref[k] != got[k]).sum()) for k in ref}
            print(f"occupancy serve {name}: vs kernels='off' from the same "
                  f"quantized nets and grid: unequal values {unequal} "
                  f"(bitwise required)", flush=True)
            if any(unequal.values()):
                fail(f"occupancy serve {name}: the int8 frame differs from "
                     f"its plain version")
            row = {"unequal": unequal}
        else:
            flips = terminal_flips(fm, r, c2w_t, off["t"], SERVE_HW)
            keep = ~flips
            d_rgb = float(np.abs(got["rgb"] - ref["rgb"]).max(-1)[keep].max())
            d_depth = float(np.abs(got["depth"] - ref["depth"])[keep].max())
            share = float(flips.mean())
            print(f"occupancy serve {name}: vs kernels='off' (same nets, "
                  f"same grid): max |rgb diff| {d_rgb:.3e} (tol 2e-2), "
                  f"max |depth diff| {d_depth:.3e} (tol 1e-1) over every "
                  f"pixel but the {share:.4%} whose terminal density "
                  f"changes sign between kernel and plain (tol "
                  f"{INT8_FLIP_SHARE:.0%}); all pixels max |rgb diff| "
                  f"{float(np.abs(got['rgb'] - ref['rgb']).max()):.3e}",
                  flush=True)
            if not (d_rgb <= 2e-2 and d_depth <= 1e-1
                    and share <= INT8_FLIP_SHARE):
                fail(f"occupancy serve {name}: the frame disagrees with "
                     f"kernels='off'")
            row = {"max_rgb_err": d_rgb, "max_depth_err": d_depth,
                   "terminal_flip_share": share}
        out[name] = {"frame_ms": s["frame_ms"], "render_ms": s["render_ms"],
                     "visible_share": seen,
                     "frame_ms_all": s["frame_ms_all"],
                     "points_per_launch": CHUNK * points,
                     "samples": [r.cfg.n_coarse, r.cfg.n_fine],
                     "startup": s["startup"], **row}
        print(f"occupancy serve {name} ({' '.join(flags)}): startup "
              f"{s['startup']}, {n_frames} frames {s['frames']} (expected "
              f"{per_frame} {'int8' if int8 else 'fine'} launches a frame of "
              f"{CHUNK} x {points} points, no coarse launch, plain 0); acc > "
              f"0.05 on {seen:.2%} of the pixels; frame "
              f"{s['frame_ms']:.1f} ms wall (median of {OCC_REQUESTS} png "
              f"requests; plain bf16 server {plain['frame_ms']:.1f} ms), "
              f"render_pose alone {s['render_ms']:.1f} ms (median of 5; "
              f"plain {plain['render_ms']:.1f} ms); card: {card}",
              flush=True)
        frames[name] = got["rgb"]
    out["counts"] = total
    return out, frames


def fine_only(state):
    """The fine net's params and Adam state of ``state`` (the leaves an
    occupancy step trains) for ``compare_steps``."""
    from types import SimpleNamespace
    return SimpleNamespace(
        params={"fine": state.params["fine"]}, ema_params=None,
        opt_state=SimpleNamespace(count=state.opt_state.count,
                                  mu={"fine": state.opt_state.mu["fine"]}))


def phase_occ_steps(fm, fb, fq, card: str) -> dict:
    """10d, in-process: three occupancy steps (merge) at phase 5's lego
    shape through the kernels, each held against the same step with
    kernels="off" from the same state and grid at phase 6's bf16
    tolerances (the fine net; the coarse net bitwise unchanged), exactly
    1 forward + 1 backward launch a step; then the occupancy step timed
    against the plain step in LEVER_ROUNDS interleaved rounds of
    LEVER_TIMED steps, as phase 8 times its levers."""
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.ops.rng import PRNGKey, fold_in
    from cvnerf_torch.render.occupancy import (bake_scene_occupancy,
                                               occupied_fraction)
    from cvnerf_torch.train.loop import make_train_step
    from cvnerf_torch.train.state import create_train_state
    from cvnerf_torch.utils.tree import tree_leaves
    images_np, poses_np = bench_scene(TRAIN_HW, TRAIN_HW)
    images = torch.as_tensor(images_np, device="cuda")
    poses = torch.as_tensor(poses_np, device="cuda")
    idx = torch.tensor([0, 1])
    tcfg = lego_train_config(torch.bfloat16)
    start = create_train_state(PRNGKey(SEED + 5), lr=tcfg.lr,
                               lr_decay=tcfg.lr_decay, mlp=tcfg.render.mlp,
                               device="cuda")
    grid = bake_scene_occupancy(start.params, tcfg.render.mlp, ndc=False,
                                bound=OCC_BOUND, n_fine=128,
                                resolution=OCC_RES,
                                compute_dtype=torch.bfloat16)
    frac = occupied_fraction(grid)
    if not frac > 0:
        fail("occupancy steps: the starting state's grid is empty")
    step_on = make_train_step(tcfg, with_occupancy=True)
    step_off = make_train_step(lego_train_config(torch.bfloat16, "off"),
                               with_occupancy=True)
    state, errs, coarse_same = start, [], True
    for i in range(1, 4):
        key = fold_in(PRNGKey(SEED), i)
        torch.cuda.synchronize()
        reset_counts(fm, fb, fq)
        on, m_on = step_on(state, grid, key, images, poses, idx, False)
        torch.cuda.synchronize()
        check_calls(f"occupancy step {i}", [read_counts(fm, fb, fq)], 1,
                     {"fwd": 1, "bwd": 1})
        off, m_off = step_off(state, grid, key, images, poses, idx, False)
        m_on = {k: float(v) for k, v in m_on.items()}
        m_off = {k: float(v) for k, v in m_off.items()}
        if not all(np.isfinite(v) for v in m_on.values()):
            fail(f"occupancy step {i}: non-finite metrics {m_on}")
        errs.append(compare_steps(f"occupancy step {i}", fine_only(state),
                                  fine_only(on), fine_only(off), m_on, m_off,
                                  tcfg.lr))
        coarse_same &= all(torch.equal(a, b) for a, b in zip(
            tree_leaves(on.params["coarse"]),
            tree_leaves(start.params["coarse"])))
        state = on
    if not coarse_same:
        fail("occupancy steps: the coarse net moved")
    times = {"occ": [], "plain": []}
    for r in range(LEVER_ROUNDS):
        turns = (("plain", None), ("occ", grid))
        for arm, g in turns if r % 2 == 0 else turns[::-1]:
            times[arm].append(time_trainer(
                tcfg, start, images_np, poses_np, LEVER_TIMED, g))
    worst = {k: max(e[k] for e in errs) for k in errs[0]}
    occ_ms, plain_ms = (float(np.median(times[k])) for k in ("occ", "plain"))
    print(f"occupancy steps (merge, res {OCC_RES}, occupied {frac:.4%}): 3 "
          f"steps 1 + 1 launches each, plain 0, coarse net bitwise "
          f"unchanged; vs kernels='off' loss rel {worst['loss_rel']:.2e}, "
          f"fine grads {worst['grad_rel']:.2e}, params "
          f"{worst['param_max']:.2e} (large-|g| {worst['param_big']:.2e}); "
          f"{LEVER_ROUNDS} interleaved rounds of {LEVER_TIMED} steps: "
          f"occupancy step {occ_ms:.3f} ms (rounds "
          f"{[round(t, 3) for t in times['occ']]}), plain step "
          f"{plain_ms:.3f} ms (rounds "
          f"{[round(t, 3) for t in times['plain']]}); card: {card}",
          flush=True)
    return {"step_ms": occ_ms, "plain_step_ms": plain_ms,
            "step_ms_rounds": times["occ"],
            "plain_step_ms_rounds": times["plain"], **worst}


def phase_occ_cli(fm, fb, fq, card: str, tmp: str) -> dict:
    """10d, through the CLI (main path): ``--occ_train --occ_train_warmup
    20 --occ_train_every 20`` (merge) on phase 7's fixture for 60 steps:
    steps 1-20 2 + 2 launches, from the switch on 1 + 1, frames 40 fine
    launches (the CLI's chunk 4096), plain 0; the verdicts switched,
    rebaked, rebaked in metrics.jsonl; the coarse net bitwise that of the
    step-20 checkpoint; a run stopped at 40 and resumed re-enters the
    occupancy step at once; a short full-mode run with ``--occ_floor 16``;
    ``from_run_dir`` of the run serves through a grid."""
    from cvnerf_torch.serve import NerfRenderer
    logs = os.path.join(tmp, "occ_logs")
    data = os.path.join(tmp, "lego_fixture")
    lego = str(Path(__file__).resolve().parent / "configs" / "lego.txt")
    base = ["--config", lego, "--data_dir", data,
            "--base_dir", logs, "--save_dir", logs, "--testskip", "1",
            "--ckpt_freq", "20", "--val_freq", "30", "--vid_freq", "0",
            "--print_freq", "10", "--deterministic_resample",
            "--occ_train", "--occ_train_warmup", "20",
            "--occ_train_every", "20", "--occupancy_res", str(OCC_RES)]
    occ_frame = {"fwd": -(-SERVE_HW * SERVE_HW // 4096)}          # 40
    bake = -(-OCC_RES ** 3 // 65536)
    total = {k: 0 for k in read_counts(fm, fb, fq)}

    def drive(argv, plain_steps, occ_steps, n_frames, n_bakes):
        n_blocks = len(GRAPHS.blocks)
        _, counts, steps, frames = drive_cli(fm, fb, fq, argv)
        # Each capture's eager warm-up step launches once more.
        warm = sum(b["captures"] * b["per_step"]["fwd"]
                   for b in GRAPHS.blocks[n_blocks:])
        check_calls(f"occ cli {argv[-6:]} plain steps", steps[:plain_steps],
                    plain_steps, {"fwd": 2, "bwd": 2})
        check_calls(f"occ cli {argv[-6:]} occupancy steps",
                    steps[plain_steps:], occ_steps, {"fwd": 1, "bwd": 1})
        check_calls(f"occ cli {argv[-6:]} frames", frames, n_frames,
                    occ_frame)
        want = (2 * plain_steps + occ_steps + n_frames * occ_frame["fwd"]
                + n_bakes * bake + warm)
        if counts["fwd"] != want or counts["fwd_plain"] \
                or counts["bwd_plain"]:
            fail(f"occ cli {argv[-6:]}: launches {counts}, expected "
                 f"{want} forward (bakes included) and no plain call")
        for k, v in counts.items():
            total[k] += v

    t0 = time.perf_counter()
    drive([*base, "--name", "a", "--iters", "61"], 20, 40, 6, 3)
    wall_s = time.perf_counter() - t0
    run_a = os.path.join(logs, "a")
    with open(os.path.join(run_a, "metrics.jsonl")) as fp:
        recs = [json.loads(line) for line in fp]
    verdicts = [(r["step"], r["occ_verdict"], r["occ_occupied_frac"])
                for r in recs if "occ_verdict" in r]
    if [v[:2] for v in verdicts] != [(20, "switched"), (40, "rebaked"),
                                     (60, "rebaked")]:
        fail(f"occ cli: verdicts {verdicts}")
    ck = os.path.join(run_a, "torch_checkpoints")
    at20 = torch.load(os.path.join(ck, "000020.pt"), weights_only=True)
    at60 = torch.load(os.path.join(ck, "000060.pt"), weights_only=True)
    coarse_diffs = walk_diffs(at20["coarse"], at60["coarse"])
    fine_moved = bool(walk_diffs(at20["fine"], at60["fine"]))
    if coarse_diffs or not fine_moved:
        fail(f"occ cli: coarse net moved after the switch "
             f"({list(coarse_diffs)[:4]}) or the fine net did not")
    logged = [r for r in recs if "lr" in r]
    test = [r for r in recs if "test_psnr" in r][-1]

    drive([*base, "--name", "b", "--iters", "41"], 20, 20, 4, 2)
    drive([*base, "--name", "b", "--iters", "61"], 0, 20, 4, 2)
    b60 = torch.load(os.path.join(logs, "b", "torch_checkpoints",
                                  "000060.pt"), weights_only=True)
    resumed_bitwise = not walk_diffs(at60, b60)

    drive([*base, "--name", "full", "--iters", "25", "--occ_train_mode",
           "full", "--occ_floor", "16", "--val_freq", "0", "--ckpt_freq",
           "0"], 20, 4, 2, 1)
    with open(os.path.join(logs, "full", "scene.json")) as fp:
        record = json.load(fp)["occ_train"]
    if record != {"resolution": OCC_RES, "bound": OCC_BOUND, "mode": "full",
                  "interp": "nearest", "floor": 16}:
        fail(f"occ cli: full-mode record {record}")

    torch.cuda.synchronize()
    reset_counts(fm, fb, fq)
    r = NerfRenderer.from_run_dir(run_a, device="cuda")
    rgb = r.render_pose(pose(0.5))
    torch.cuda.synchronize()
    served = read_counts(fm, fb, fq)
    check_calls("occ cli from_run_dir", [served], 1,
                 {"fwd": bake + -(-SERVE_HW * SERVE_HW // CHUNK)})
    if r.occupancy is None or r.cfg.occupancy_mode != "merge" \
            or not np.isfinite(rgb).all():
        fail("occ cli: from_run_dir did not serve the run through a grid")
    for k, v in served.items():
        total[k] += v
    print(f"occ cli: --occ_train (merge) 60 lego-shaped bf16 steps through "
          f"python -m cvnerf_torch.cli in {wall_s:.2f} s wall: verdicts "
          f"{verdicts}; steps 1-20 2 + 2 launches, 21-60 1 + 1, frames "
          f"{occ_frame['fwd']} fine launches, plain 0; loss "
          f"{logged[0]['loss']:.4f} -> {logged[-1]['loss']:.4f}, test psnr "
          f"{test['test_psnr']:.4f}; coarse net bitwise the step-20 "
          f"checkpoint's; stopped at 40 and resumed: every resumed step an "
          f"occupancy step, final checkpoint bitwise the uninterrupted "
          f"run's: {resumed_bitwise}; full mode --occ_floor 16: 4 "
          f"occupancy steps 1 + 1; from_run_dir serves through a grid "
          f"(mode {r.cfg.occupancy_mode}, {served}); launches {total}; "
          f"card: {card}", flush=True)
    return {"counts": total, "verdicts": verdicts, "cli_wall_s": wall_s,
            "resumed_bitwise": resumed_bitwise,
            "test_psnr": test["test_psnr"]}


def phase_mesh(fm, fb, fq, card: str, run: str, tmp: str) -> dict:
    """10e. ``python -m cvnerf_torch.render.mesh --run <phase-7 run>`` at
    its default --res 256 (main path): 16,777,216 grid points through the
    forward kernel in 256 launches, no plain call; the density grid against
    kernels="off" on the card at phase 1's bf16 tolerance; the mesh
    written, its vertex and face counts and the host seconds of the
    marching pass printed."""
    import contextlib
    import io
    from cvnerf_torch.render import mesh as tmesh
    from cvnerf_torch.serve import NerfRenderer
    out = os.path.join(tmp, "mesh.obj")
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts(fm, fb, fq)
    with contextlib.redirect_stdout(buf):
        rc = tmesh.main(["--run", run, "--out", out])
    torch.cuda.synchronize()
    counts = read_counts(fm, fb, fq)
    printed = buf.getvalue().strip()
    print(printed, flush=True)
    n_launch = -(-MESH_RES ** 3 // 65536)                         # 256
    check_calls("mesh grid query", [counts], 1, {"fwd": n_launch})
    m = re.search(r"(\d+) verts, (\d+) faces .*grid query ([\d.]+) s, "
                  r"marching ([\d.]+) s", printed)
    if rc != 0 or m is None or not os.path.exists(out):
        fail(f"mesh: the CLI did not write its mesh ({printed!r})")
    verts, faces = int(m.group(1)), int(m.group(2))
    query_s, march_s = float(m.group(3)), float(m.group(4))
    with open(out) as fp:
        head = fp.readline()
    if head != f"# cvnerf_torch mesh: {verts} verts, {faces} faces\n":
        fail(f"mesh: OBJ header {head!r}")
    r = NerfRenderer.from_run_dir(run, device="cuda")
    bb = ((-1.5,) * 3, (1.5,) * 3)
    grid = tmesh.query_density_grid(r._float_params["fine"], r.cfg.mlp, *bb,
                                    MESH_RES,
                                    compute_dtype=r.cfg.compute_dtype)
    off = tmesh.query_density_grid(r._float_params["fine"], r.cfg.mlp, *bb,
                                   MESH_RES,
                                   compute_dtype=r.cfg.compute_dtype,
                                   kernels="off")
    err = float(np.abs(grid - off).max())
    print(f"mesh: --res {MESH_RES} on phase 7's run (step {r.step}): launches "
          f"{counts} (expected {n_launch} forward, plain 0); density grid "
          f"vs kernels='off' on the card max |sigma diff| {err:.3e} (tol "
          f"{TOL_BF16:g}), sigma range [{float(grid.min()):.3f}, "
          f"{float(grid.max()):.3f}]; {verts} vertices, {faces} faces; grid "
          f"query {query_s:.3f} s, host marching pass {march_s:.3f} s; "
          f"card: {card}", flush=True)
    if not err <= TOL_BF16:
        fail("mesh: the kernel's density grid disagrees with kernels='off'")
    return {"counts": counts, "verts": verts, "faces": faces,
            "query_s": query_s, "march_s": march_s, "max_abs_err": err}


def phase_lpips(card: str, tmp: str, a: np.ndarray, b: np.ndarray) -> dict:
    """10f. LPIPS with seeded random weights in the loader's ``.npz``
    layout: the distance of two rendered frames on the card against the
    same call on the CPU, within 1e-5 relative."""
    from cvnerf_torch.utils.lpips import _STAGES, load_weights, lpips_images
    rng_np = np.random.RandomState(SEED)
    bundle = {}
    for i, (ch, k, _, _) in enumerate(_STAGES):
        cin = 3 if i == 0 else _STAGES[i - 1][0]
        bundle[f"conv{i}_w"] = rng_np.randn(ch, cin, k, k).astype(
            np.float32) * 0.1
        bundle[f"conv{i}_b"] = rng_np.randn(ch).astype(np.float32) * 0.1
        bundle[f"lin{i}"] = rng_np.rand(ch).astype(np.float32)
    path = os.path.join(tmp, "lpips_random.npz")
    np.savez(path, **bundle)
    w_gpu, w_cpu = load_weights(path, "cuda"), load_weights(path, "cpu")
    t0 = time.perf_counter()
    d_gpu = lpips_images(a, b, w_gpu)
    gpu_ms = (time.perf_counter() - t0) * 1e3
    d_cpu = lpips_images(a, b, w_cpu)
    rel = abs(d_gpu - d_cpu) / max(abs(d_cpu), 1e-30)
    print(f"lpips: two 400x400 occupancy frames (merge vs full with the "
          f"reduced budget), random "
          f"weights: card {d_gpu:.8f} ({gpu_ms:.1f} ms wall), CPU "
          f"{d_cpu:.8f}, rel diff {rel:.2e} (tol 1e-5); card: {card}",
          flush=True)
    if not (d_cpu > 0 and rel <= 1e-5):
        fail("lpips: the card's distance differs from the CPU's")
    return {"card": d_gpu, "cpu": d_cpu, "rel_diff": rel, "card_ms": gpu_ms}


# -- phase 11: ray-sharded data parallelism ---------------------------------

SHARD_STEPS = 3
SHARD_TIMED = 8


def free_port() -> int:
    """A TCP port free on this host now (bound to port 0, then released)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_shards(fm, fb, fq, card: str, run: str) -> dict:
    """Phase 11a, a two-shard in-process mesh on the one card
    (``make_mesh(devices=["cuda:0", "cuda:0"])``): SHARD_STEPS lego-shaped
    bf16 steps (512 rays a shard) each held against the unsharded step
    from the same state at phase 6's bf16 tolerances, with exactly 2 + 2
    launches a shard a step; ``NerfRenderer(use_mesh=<the mesh>)`` serving
    phase 7's run at 400x400 against the unsharded renderer (bf16 within
    phase 4's tolerances, the count of unequal values printed; int8
    bitwise), the frame's launches split over the shards; the sharded and
    unsharded step and frame timed (both shards run on one card, so these
    show the cost of the split, not a gain)."""
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.ops.rng import PRNGKey, fold_in
    from cvnerf_torch.parallel.mesh import make_mesh
    from cvnerf_torch.serve import NerfRenderer
    from cvnerf_torch.train.loop import make_train_step
    from cvnerf_torch.train.state import create_train_state
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    images_np, poses_np = bench_scene(TRAIN_HW, TRAIN_HW)
    images = torch.as_tensor(images_np, device="cuda")
    poses = torch.as_tensor(poses_np, device="cuda")
    idx = torch.tensor([0, 1])
    tcfg = lego_train_config(torch.bfloat16)
    step_mesh = make_train_step(tcfg, mesh)
    step_one = make_train_step(tcfg)
    state = create_train_state(PRNGKey(SEED + 5), lr=tcfg.lr,
                               lr_decay=tcfg.lr_decay, mlp=tcfg.render.mlp,
                               device="cuda")
    total = {k: 0 for k in read_counts(fm, fb, fq)}
    errs = []
    for i in range(1, SHARD_STEPS + 1):
        key = fold_in(PRNGKey(SEED), i)
        torch.cuda.synchronize()
        reset_counts(fm, fb, fq)
        on, m_on = step_mesh(state, key, images, poses, idx, False)
        torch.cuda.synchronize()
        counts = read_counts(fm, fb, fq)
        for k, v in counts.items():
            total[k] += v
        if counts != {"fwd": 4, "bwd": 4, "int8": 0, "fwd_plain": 0,
                      "bwd_plain": 0, "int8_plain": 0}:
            fail(f"shards: sharded step {i} launched {counts}, not 2 + 2 "
                 f"a shard and no plain call")
        one, m_one = step_one(state, key, images, poses, idx, False)
        m_on = {k: float(v) for k, v in m_on.items()}
        m_one = {k: float(v) for k, v in m_one.items()}
        if not all(np.isfinite(v) for v in m_on.values()):
            fail(f"shards: non-finite metrics {m_on}")
        errs.append(compare_steps(f"shards step {i}", state, on, one, m_on,
                                  m_one, tcfg.lr))
        state = on
    worst = {k: max(e[k] for e in errs) for k in errs[0]}

    def step_ms(step) -> float:
        st, times = state, []
        for i in range(SHARD_TIMED + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = step(st, fold_in(PRNGKey(SEED), 100 + i), images,
                         poses, idx, False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))
    ms = {"one": [], "mesh": []}
    for r in range(2):
        for arm in (("one", "mesh") if r == 0 else ("mesh", "one")):
            ms[arm].append(step_ms(step_one if arm == "one" else step_mesh))
    print(f"shards: {SHARD_STEPS} lego-shaped bf16 steps on a 2-shard mesh "
          f"of cuda:0 (512 rays a shard) against the unsharded step from "
          f"the same state: loss rel {worst['loss_rel']:.2e} (tol 2e-2), "
          f"grads {worst['grad_rel']:.2e} (tol 0.15), params "
          f"{worst['param_max']:.2e} (tol {2 * tcfg.lr:g}), large-|g| "
          f"{worst['param_big']:.2e} (tol 1e-6); launches 2 + 2 a shard a "
          f"step, plain 0; median step (wall, synchronised, {SHARD_TIMED} "
          f"steps, 2 rounds in turns) sharded {ms['mesh']} ms, unsharded "
          f"{ms['one']} ms; card: {card}", flush=True)

    def frame(r, c2w):
        r.render_pose(pose(1.5))                                  # warm
        torch.cuda.synchronize()
        reset_counts(fm, fb, fq)
        t0 = time.perf_counter()
        out = r.render_pose_extras(c2w, keys=("rgb", "depth", "acc"))
        wall = (time.perf_counter() - t0) * 1e3
        return out, wall, read_counts(fm, fb, fq)

    served = {}
    for name, use_mesh in (("one", False), ("mesh", mesh)):
        r = NerfRenderer.from_run_dir(run, device="cuda", chunk=CHUNK,
                                      use_mesh=use_mesh)
        if (r.mesh is mesh) != (name == "mesh"):
            fail(f"shards: NerfRenderer(use_mesh={use_mesh}) kept mesh "
                 f"{r.mesh}")
        served[name] = {"bf16": frame(r, pose(0.5))}
        served[name]["int8"] = frame(r.enable_int8(), pose(0.5))
    n_chunks = -(-SERVE_HW * SERVE_HW // CHUNK)
    want = {"bf16": {"fwd": 2 * n_chunks}, "int8": {"int8": 2 * n_chunks}}
    report = {}
    for dt in ("bf16", "int8"):
        (a, a_ms, a_n), (b, b_ms, b_n) = served["one"][dt], served["mesh"][dt]
        unequal = {k: int((a[k] != b[k]).sum()) for k in a}
        err = {k: float(np.abs(a[k] - b[k]).max()) for k in a}
        key = "fwd" if dt == "bf16" else "int8"
        zero = {k: 0 for k in total}
        if a_n != {**zero, key: want[dt][key]} or \
                b_n != {**zero, key: 2 * want[dt][key]}:
            fail(f"shards {dt}: frame launches {b_n} (sharded) and {a_n} "
                 f"(unsharded), expected {2 * want[dt][key]} and "
                 f"{want[dt][key]} {key} launches")
        for k, v in b_n.items():
            total[k] += v
        print(f"shards {dt} frame: NerfRenderer(use_mesh=<2 shards>) "
              f"against use_mesh=False at {SERVE_HW}x{SERVE_HW}, chunk "
              f"{CHUNK} split "
              f"into 2 x {CHUNK // 2}: unequal values {unequal} of "
              f"{SERVE_HW * SERVE_HW} a map, max abs {err}; {key} launches "
              f"{b_n[key]} ({n_chunks} chunks x 2 shards x 2 passes: "
              f"{b_n[key] // 2} a shard) against {a_n[key]} unsharded; "
              f"frame {b_ms:.1f} ms sharded, {a_ms:.1f} ms unsharded "
              f"(wall)", flush=True)
        if dt == "int8" and any(unequal.values()):
            fail("shards: the sharded int8 frame is not bitwise the "
                 "unsharded one")
        if err["rgb"] > 2e-2 or err["depth"] > 0.1:
            fail(f"shards {dt}: the sharded frame differs: {err}")
        report[dt] = {"unequal": unequal, "max_abs": err,
                      "frame_ms": b_ms, "plain_frame_ms": a_ms,
                      "launches": b_n[key], "unsharded_launches": a_n[key]}
    return {"counts": total, "step_ms": ms["mesh"],
            "unsharded_step_ms": ms["one"], **worst, "frames": report}


def phase_dist_cli(fm, fb, fq, card: str, tmp: str) -> dict:
    """Phase 11b, a one-rank NCCL world through the CLI: phase 7's run cut
    to 30 steps with ``--coordinator localhost:<free port>
    --num_processes 1 --process_id 0`` (every step 2 + 2 launches, every
    frame 80; its step-30 checkpoint bitwise phase 7's); then, in a
    one-rank world of this process's own, ``initialize_distributed``
    refusing a second world while it is live and 3 ``Trainer`` steps with
    ``fused_allreduce`` bitwise the steps without it."""
    import contextlib
    import io

    import torch.distributed as dist
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.parallel.mesh import initialize_distributed, make_mesh
    from cvnerf_torch.train.loop import Trainer
    from cvnerf_torch.train.state import create_train_state
    from cvnerf_torch.utils.tree import tree_leaves
    logs = os.path.join(tmp, "cli_logs")
    base = cli_base(tmp)
    per_frame = {"fwd": 2 * -(-SERVE_HW * SERVE_HW // 4096)}
    out = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            sys.__stdout__.write(s)
            return out.write(s)

    t0 = time.perf_counter()
    n_blocks = len(GRAPHS.blocks)
    with contextlib.redirect_stdout(Tee()):
        _, counts, steps, frames = drive_cli(
            fm, fb, fq, [*base, "--name", "lego_dist", "--iters", "31",
                         "--coordinator", f"localhost:{free_port()}",
                         "--num_processes", "1", "--process_id", "0"])
    wall_s = time.perf_counter() - t0
    printed = out.getvalue()
    blocks = GRAPHS.blocks[n_blocks:]
    reasons = {b["eager_reason"] for b in blocks} - {None}
    nccl = (f"eager: {sorted(reasons)}" if reasons else
            f"captured: {sum(b['replayed'] for b in blocks)} steps replayed "
            f"in {len(blocks)} blocks, {sum(b['captures'] for b in blocks)} "
            "captures")
    print(f"dist cli: the NCCL all-reduce in a block of {BLOCK}: {nccl}",
          flush=True)
    if not blocks:
        fail("dist cli: no block of steps ran")
    check_calls("dist cli steps", steps, 30, {"fwd": 2, "bwd": 2})
    check_calls("dist cli frames", frames, 4, per_frame)
    if "Distributed: process 0 of 1" not in printed or \
            "Device mesh: 1 x cuda" not in printed:
        fail("dist cli: no 'Distributed: process 0 of 1' or one-shard mesh "
             "line")
    if dist.is_initialized():
        fail("dist cli: the CLI left its process group live")
    a = torch.load(os.path.join(logs, "lego_a", "torch_checkpoints",
                                "000030.pt"), weights_only=True)
    b = torch.load(os.path.join(logs, "lego_dist", "torch_checkpoints",
                                "000030.pt"), weights_only=True)
    diffs = walk_diffs(a, b)
    print(f"dist cli: 30 lego-shaped bf16 steps in a one-rank NCCL world "
          f"({wall_s:.2f} s wall): every step 2 + 2, every frame "
          f"{per_frame['fwd']}, launches {counts}; its step-30 checkpoint "
          f"bitwise phase 7's: {not diffs}", flush=True)
    if diffs:
        fail(f"dist cli: the one-rank world's checkpoint differs: "
             f"{dict(list(diffs.items())[:8])}")

    images, poses = bench_scene(TRAIN_HW, TRAIN_HW)
    if not initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                  device="cuda"):
        fail("dist: initialize_distributed did not start a world")
    try:
        try:
            initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                   device="cuda")
            fail("dist: initialize_distributed joined a second world while "
                 "one was live")
        except RuntimeError:
            pass
        mesh = make_mesh(device="cuda")
        if not (mesh.distributed and mesh.size == 1):
            fail(f"dist: make_mesh() under a one-rank world gave {mesh}")
        runs = {}
        reset_counts(fm, fb, fq)
        for fused in (False, True):
            tcfg = dataclasses.replace(lego_train_config(torch.bfloat16),
                                       fused_allreduce=fused)
            state = create_train_state(PRNGKey(SEED + 5), lr=tcfg.lr,
                                       lr_decay=tcfg.lr_decay,
                                       mlp=tcfg.render.mlp, device="cuda")
            tr = Trainer(tcfg, state, images, poses, [0, 1], seed=SEED,
                         mesh=mesh)
            runs[fused] = (tr.run(1, 4), tr.state)
        torch.cuda.synchronize()
        fused_counts = read_counts(fm, fb, fq)
    finally:
        dist.destroy_process_group()
    (m0, s0), (m1, s1) = runs[False], runs[True]
    same = m0["loss"] == m1["loss"] and all(
        torch.equal(x, y) for x, y in zip(
            tree_leaves({"p": s0.params, "mu": s0.opt_state.mu,
                         "nu": s0.opt_state.nu}),
            tree_leaves({"p": s1.params, "mu": s1.opt_state.mu,
                         "nu": s1.opt_state.nu})))
    print(f"dist: a second initialize_distributed while the world is live "
          f"raises; 3 Trainer steps with fused_allreduce bitwise the "
          f"per-leaf all-reduce (loss {m1['loss']!r}): {same}; launches "
          f"{fused_counts} (2 + 2 a step); card: {card}", flush=True)
    if not same or fused_counts != {"fwd": 12, "bwd": 12, "int8": 0,
                                    "fwd_plain": 0, "bwd_plain": 0,
                                    "int8_plain": 0}:
        fail("dist: fused_allreduce differs from the per-leaf all-reduce "
             "in a one-rank world, or its steps left the kernels")
    for k, v in fused_counts.items():
        counts[k] += v
    return {"counts": counts, "cli_wall_s": wall_s, "nccl_blocks": nccl}


# -- phase 12: blocks of steps as CUDA-graph replays, every draw on the card -

# 32-bit integer operations a second: a Hopper SM issues 64 INT32 lanes a
# clock (16 a partition), so 132 SMs x 64 lanes x 1.98 GHz.
H100_INT_OPS = 132 * 64 * 1.98e9
# Integer operations of one threefry-2x32 of a counter pair: 2 key adds, the
# parity word (2 xors), 20 rounds of add, rotate and xor, 5 injections of 3
# adds (csrc/threefry.cu).
THREEFRY_OPS = 2 + 2 + 20 * 3 + 5 * 3
# One Feistel encryption: the halves (3), 4 rounds of a round-key xor, a
# threefry, a xor and a mask (3 + THREEFRY_OPS), the join (2), and the
# range test of the walk (1).
FEISTEL_OPS = 3 + 4 * (3 + THREEFRY_OPS) + 2 + 1
# The draws' domains: powers of two (no cycle walk), one above and below
# (the longest walks), the lego pixel grids (200x200, 400x400, 800x800) and
# the ray-batching pool of 8 views of 800x800.
FEISTEL_DRAWS = [(1024, 1024), (1023, 1023), (1025, 1025), (1024, 2 ** 20),
                 (1024, 2 ** 20 + 1), (1024, 2 ** 20 - 1), (1024, 40_000),
                 (1024, 160_000), (4096, 160_000), (1024, 640_000),
                 (1024, 8 * 800 * 800)]
BLOCK = 10                    # the CLI's --steps_per_call default
SCAN_ROUNDS = 4


def device_ms(fn, n: int = 200) -> float:
    """Milliseconds a launch of ``fn`` takes on the card, host excluded:
    ``n`` launches captured in one CUDA graph, replayed between CUDA
    events (a launch of a tiny kernel takes less time on the card than its
    wrapper on the host, so events around single launches time the host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, reps=7, warmup=2) / n


def feistel_encryptions(tf, key, n: int, m: int) -> int:
    """The encryptions a draw's data needs: one an element, and one more
    for each pass the element spends out of ``[0, m)``."""
    hb, passes = tf.feistel_plan(m)
    mask = (1 << hb) - 1
    k = key & 0xFFFFFFFF

    def encrypt(x):
        left, right = (x >> hb) & mask, x & mask
        for rnd in range(4):
            f, _ = tf.threefry2x32(k[0] ^ rnd, k[1], right,
                                   torch.full_like(right, rnd))
            left, right = right, (left ^ f) & mask
        return (left << hb) | right
    y = encrypt(torch.arange(n, dtype=torch.int64, device=key.device))
    total = n
    for _ in range(passes):
        out = y >= m
        total += int(out.sum())
        y = torch.where(out, encrypt(y), y)
    return total


def phase_draws(card: str) -> list[dict]:
    """12a: the draw kernels against their plain versions on the card,
    bitwise, at the key derivations', the lego step's ray streams' and the
    Feistel draws' shapes, each launched twice; ptxas spills 0; the
    kernels and the plain versions timed at the step's largest shapes.
    The launches made here are taken back off the counters."""
    from cvnerf_torch.ops import threefry as tf
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.utils.kernels import build_library
    lib = build_library("threefry", verbose=True)
    check_ptxas(lib, "threefry_bits_kernel")
    check_ptxas(lib, "feistel_draw_kernel")
    saved = (tf.threefry_bits.launches, tf.feistel_draw.launches)
    dev = torch.device("cuda")
    ids = torch.arange(1024, dtype=torch.int64, device=dev)
    step = torch.tensor([12], dtype=torch.int64, device=dev)
    cases = {                      # name -> (args, kwargs) of threefry_bits
        "fold_in": ((1, 1), dict(c1=12)),
        "fold_in_device_step": ((1, 1), dict(c1=step)),
        "split_3": ((1, 3), {}),
        "bits_1": ((1, 1), dict(layout="xor")),
        "bits_131072": ((1, 131072), dict(layout="xor")),
        "rays_1024x64": ((1024, 32), dict(c0=ids, layout="split",
                                          width=64)),
        "rays_1024x129": ((1024, 65), dict(c0=ids, layout="split",
                                           width=129)),
        "rays_1024x193": ((1024, 97), dict(c0=ids, layout="split",
                                           width=193)),
    }
    rows, bad = [], []
    for seed in (SEED, SEED + 7):
        key = PRNGKey(seed).to(dev)
        for name, (a, kw) in cases.items():
            got = tf.threefry_bits(key, *a, **kw)
            again = tf.threefry_bits(key, *a, **kw)
            want = tf.threefry_bits_plain(key, *a, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got, again) and torch.equal(got, want)):
                bad.append(("threefry_bits", name, seed))
        for n, m in FEISTEL_DRAWS:
            got = tf.feistel_draw(key, n, m)
            again = tf.feistel_draw(key, n, m)
            want = tf.feistel_draw_plain(key, n, m)
            torch.cuda.synchronize()
            if not (torch.equal(got, again) and torch.equal(got, want)
                    and got.unique().numel() == n):
                bad.append(("feistel_draw", (n, m), seed))
    print(f"draws: threefry_bits at {len(cases)} shapes and feistel_draw at "
          f"{len(FEISTEL_DRAWS)} (n, m), 2 keys, each bitwise its plain "
          f"version over two launches: {not bad}", flush=True)
    if bad:
        fail(f"draw kernels disagree with their plain versions: {bad[:6]}")
    key = PRNGKey(SEED).to(dev)
    (a, kw) = cases["rays_1024x129"]
    pairs = a[0] * a[1]
    t_ms = device_ms(lambda: tf.threefry_bits(key, *a, **kw))
    t_plain = time_ms(lambda: tf.threefry_bits_plain(key, *a, **kw), reps=7)
    ops = pairs * THREEFRY_OPS
    nbytes = 16 + 8 * a[0] + 8 * a[0] * kw["width"]
    bound = max(ops / H100_INT_OPS, nbytes / H100_BYTES_PER_S) * 1e3
    rows.append({"name": "threefry_bits", "shape": "rays 1024 x 129 (the "
                 "fine pass's sorted uniforms, 65 counter pairs a ray)",
                 "ms": t_ms, "plain_ms": t_plain, "bound_ms": bound,
                 "bound_by": ("operations" if ops / H100_INT_OPS
                              >= nbytes / H100_BYTES_PER_S else "bytes"),
                 "ops": ops, "bytes": nbytes})
    for n, m in ((1024, 160_000), (1024, 8 * 800 * 800)):
        enc = feistel_encryptions(tf, key, n, m)
        t_ms = device_ms(lambda: tf.feistel_draw(key, n, m))
        t_plain = time_ms(lambda: tf.feistel_draw_plain(key, n, m), reps=3,
                          warmup=1)
        ops, nbytes = enc * FEISTEL_OPS, 16 + 8 * n
        bound = max(ops / H100_INT_OPS, nbytes / H100_BYTES_PER_S) * 1e3
        rows.append({"name": "feistel_draw", "shape": f"n={n}, m={m}",
                     "ms": t_ms, "plain_ms": t_plain, "bound_ms": bound,
                     "bound_by": ("operations" if ops / H100_INT_OPS
                                  >= nbytes / H100_BYTES_PER_S
                                  else "bytes"),
                     "encryptions": enc, "ops": ops, "bytes": nbytes})
    for r in rows:
        print(f"draws: {r['name']} {r['shape']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.3f} ms), bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}; card: {card}", flush=True)
    tf.threefry_bits.launches, tf.feistel_draw.launches = saved
    return rows


def scan_trainer(tcfg, state, images, poses, spc: int, mesh=None):
    """A ``Trainer`` of ``spc`` steps a call."""
    from cvnerf_torch.train import loop
    return loop.Trainer(tcfg, state, images, poses, [0, 1], seed=SEED,
                        steps_per_call=spc, mesh=mesh)


def phase_blocks(fm, fb, fq, card: str) -> dict:
    """12b: ``Trainer(steps_per_call=10)`` against ``steps_per_call=1``
    from one state at phase 5's shape, steps 1-40 across the precrop switch
    at 12 and callbacks at 16 and 32: plain, occupancy (a rebake copied in
    at the first callback), EMA + anneal, noise + regularizers + ray
    batching, parity, and a two-shard mesh of the one card. Params, both
    moments, the count, the step and the EMA slot bitwise; no plain call;
    each captured step's launches 2 + 2 (1 + 1 occupancy, 2 + 2 a shard),
    and the blocks' run as many draws as the single steps' plus the
    warm-ups'."""
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.parallel.mesh import make_mesh
    from cvnerf_torch.render.occupancy import bake_occupancy
    from cvnerf_torch.train.loop import state_leaves
    from cvnerf_torch.train.state import create_train_state
    images, poses = bench_scene(TRAIN_HW, TRAIN_HW)
    cases = {"plain": {}, "occupancy": {},
             "ema_anneal": dict(ema_decay=0.999, freq_anneal=100),
             "levers": dict(noise_decay=100, distortion_loss=0.01,
                            distortion_ramp=20, occlusion_loss=0.01,
                            ray_batching=True),
             "parity": dict(pixel_sampling="parity"), "two_shards": {}}
    out = {}
    for name, change in cases.items():
        tcfg = dataclasses.replace(lego_train_config(torch.bfloat16),
                                   precrop_iters=12, **change)
        if name == "levers":      # the noise schedule needs density noise
            tcfg = dataclasses.replace(tcfg, render=dataclasses.replace(
                tcfg.render, noise_std=1.0))
        init = create_train_state(PRNGKey(SEED + 9), lr=tcfg.lr,
                                  lr_decay=tcfg.lr_decay,
                                  mlp=tcfg.render.mlp, device="cuda",
                                  ema=bool(change.get("ema_decay")))
        runs = {}
        mesh = (make_mesh(devices=["cuda:0", "cuda:0"])
                if name == "two_shards" else None)
        for spc in (1, BLOCK):
            tr = scan_trainer(tcfg, init, images, poses, spc, mesh=mesh)
            if name == "occupancy":
                grid = bake_occupancy(init.params["fine"], tcfg.render.mlp,
                                      (-1.5,) * 3, (1.5,) * 3, 64,
                                      compute_dtype=torch.bfloat16)
                grid.values.add_(1.0)    # young nets may bake empty
                tr.set_occupancy(grid)

                def rebake(i, t, m, grid=grid):
                    if i == 16:
                        t.set_occupancy(dataclasses.replace(
                            grid, values=grid.values * 0.5))
                tr.add_callback(16, rebake)
            else:
                tr.add_callback(16, lambda i, t, m: None)
            n_blocks = len(GRAPHS.blocks)
            torch.cuda.synchronize()
            before = GRAPHS.read()
            m = tr.run(1, 41)
            torch.cuda.synchronize()
            runs[spc] = (tr, m, {k: v - before[k]
                                 for k, v in GRAPHS.read().items()},
                         GRAPHS.blocks[n_blocks:])
        (t1, m1, c1, _), (tk, mk, ck, blocks) = runs[1], runs[BLOCK]
        same = m1["loss"] == mk["loss"] and t1.state.step == tk.state.step \
            and t1.state.opt_state.count == tk.state.opt_state.count \
            and all(torch.equal(a, b) for a, b in zip(
                state_leaves(t1.state), state_leaves(tk.state)))
        # Each captured step launches 2 + 2 (1 + 1 through the grid, 2 + 2
        # a shard) and one Adam, and the blocks' run launches what the
        # single steps' run does, plus one eager warm-up step a capture.
        mlp = {"occupancy": {"fwd": 1, "bwd": 1},
               "two_shards": {"fwd": 4, "bwd": 4}}.get(name,
                                                      {"fwd": 2, "bwd": 2})
        mlp = {**mlp, "adam": 1}
        graphed = [b for b in blocks if b["replayed"]]
        keys = ("fwd", "bwd", "threefry", "feistel", "adam")
        warm = {k: sum(b["captures"] * b["per_step"][k] for b in graphed)
                for k in keys}
        ok_launch = bool(graphed) and all(
            {k: b["per_step"][k] for k in mlp} == mlp
            and b["replayed"] == b["steps"] for b in graphed) and all(
                ck[k] == c1[k] + warm[k] for k in keys)
        plain = {k: c1[k] + ck[k] for k in c1 if k.endswith("plain")}
        ok_plain = not any(plain.values())
        stats = tk.scan_fn.runner.stats if name != "occupancy" else \
            tk._scan_fn_occ.runner.stats
        print(f"blocks {name}: 40 steps, K={BLOCK} blocks "
              f"{[(b['replayed'], b['captures']) for b in blocks]} (replayed "
              f"steps, captures) against single steps: bitwise {same}; "
              f"launches a captured step "
              f"{graphed[0]['per_step'] if graphed else None}; plain calls "
              f"{plain}; stats {stats}", flush=True)
        if not (same and ok_launch and ok_plain):
            fail(f"blocks {name}: not bitwise the single steps, or the "
                 f"captured step's launches are off")
        out[name] = {"bitwise": same,
                     "per_step": graphed[0]["per_step"] if graphed else None,
                     "stats": stats, "counts": ck}
    return out


def phase_block_timing(fm, fb, fq, card: str) -> dict:
    """12c: phase 5's step as eager steps and as blocks of 10 one-step
    graph replays, SCAN_ROUNDS rounds of 10 steps each in turn (the order
    alternating), median ms a step by CUDA events; the device's idle share
    of each by the profiler, the capture seconds and the graph pool's
    bytes."""
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.train.state import create_train_state
    images, poses = bench_scene(TRAIN_HW, TRAIN_HW)
    tcfg = lego_train_config(torch.bfloat16)
    kinds = {"eager": 1, "graph_1": BLOCK}
    trs = {}
    for kind, spc in kinds.items():
        state = create_train_state(PRNGKey(SEED), lr=tcfg.lr,
                                   lr_decay=tcfg.lr_decay,
                                   mlp=tcfg.render.mlp, device="cuda")
        trs[kind] = scan_trainer(tcfg, state, images, poses, spc)
        trs[kind].run(1, 1 + BLOCK)                      # capture, warm
    times = {k: [] for k in kinds}
    nxt = {k: 1 + BLOCK for k in kinds}
    order = list(kinds)
    for r in range(SCAN_ROUNDS):
        for kind in order[r % 2:] + order[:r % 2]:
            tr, i = trs[kind], nxt[kind]
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            tr.run(i, i + BLOCK)
            ev1.record()
            torch.cuda.synchronize()
            times[kind].append(ev0.elapsed_time(ev1) / BLOCK)
            nxt[kind] = i + BLOCK
    med = {k: float(np.median(v)) for k, v in times.items()}
    split = {k: profile_steps(trs[k], nxt[k], 2 * BLOCK, med[k])
             for k in kinds}
    stats = {k: trs[k].scan_fn.runner.stats for k in kinds if k != "eager"}
    caps = {k: (round(v["capture_s"], 3), v["pool_bytes"])
            for k, v in stats.items()}
    print(f"block timing: median ms a step over {SCAN_ROUNDS} interleaved "
          f"rounds of {BLOCK}: eager {med['eager']:.3f} "
          f"({[round(x, 3) for x in times['eager']]}), one-step graph x10 "
          f"{med['graph_1']:.3f} ({[round(x, 3) for x in times['graph_1']]})"
          f"; device idle "
          f"{ {k: round(v['idle_share'] or 0, 4) for k, v in split.items()} }"
          f"; capture s and pool bytes {caps}; card: {card}", flush=True)
    return {"median_ms": med, "rounds_ms": times, "split": split,
            "stats": stats}


def phase_cli_spc(fm, fb, fq, card: str, tmp: str) -> dict:
    """12d: phase 7's uninterrupted run again at ``--steps_per_call 1``:
    its checkpoints at 30 and 60 bitwise those of phase 7's run at the
    default 10 (whose stop at 30 and resume, phase 7, were at 10 too)."""
    logs = os.path.join(tmp, "cli_logs")
    _, counts, steps, _ = drive_cli(
        fm, fb, fq, [*cli_base(tmp), "--name", "lego_spc1", "--iters", "61",
                     "--steps_per_call", "1"])
    check_calls("cli --steps_per_call 1 steps", steps, 60,
                {"fwd": 2, "bwd": 2})
    diffs = {}
    for step in ("000030.pt", "000060.pt"):
        a, b = (torch.load(os.path.join(logs, run, "torch_checkpoints",
                                        step), weights_only=True)
                for run in ("lego_a", "lego_spc1"))
        diffs.update({f"{step}:{k}": v for k, v in walk_diffs(a, b).items()})
    print(f"cli --steps_per_call 1 against 10: checkpoints at 30 and 60 "
          f"bitwise: {not diffs}; launches {counts}; card: {card}",
          flush=True)
    if diffs:
        fail(f"cli: --steps_per_call 1 and 10 differ: "
             f"{dict(list(diffs.items())[:8])}")
    return {"counts": counts, "bitwise": not diffs}


# -- phase 12e: Adam's update of every leaf in one launch --------------------

ADAM_COUNTS = (0, 1, 2, 499, 500)
# Bytes of one Adam value: p, g, m, v read and p, m, v written, float32.
ADAM_BYTES = 7 * 4


def foreach_adam(params, grads, mu, nu, step: float, bc1: float, bc2: float,
                 b1: float, b2: float, eps: float):
    """The same update through ``torch._foreach_*`` (the yardstick; its
    scalars are host floats, frozen where it is captured)."""
    m = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                           torch._foreach_mul(mu, b1))
    v = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
        torch._foreach_mul(nu, b2))
    d = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)),
                           eps)
    u = torch._foreach_mul(torch._foreach_div(
        torch._foreach_div(m, bc1), d), step)
    return torch._foreach_add(params, u), m, v


def phase_adam(card: str) -> dict:
    """12e: ``fused_adam`` against ``adam_plain`` on the card at the lego
    nets' 48 leaves, p, m and v bitwise, at ADAM_COUNTS with random, zero
    and large gradients, and one launch captured in a CUDA graph replayed
    over three scalar rows; ptxas spills 0; the kernel, the plain version
    and ``foreach_adam`` timed through CUDA graphs (``device_ms``; the
    inputs stay in L2 between launches, a warm read). The launches and
    calls made here are taken back off the counters."""
    from cvnerf_torch.ops import adam as fa
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.train.state import Adam, create_train_state
    from cvnerf_torch.utils.tree import tree_leaves
    from cvnerf_torch.utils.kernels import build_library
    lib = build_library("adam", verbose=True)
    check_ptxas(lib, "fused_adam_kernel")
    ptxas = ptxas_report(lib, "fused_adam_kernel")
    saved = (fa.fused_adam.launches, fa.adam_plain.calls)
    dev = torch.device("cuda")
    opt = Adam(lr=5e-4, lr_decay=500)
    hyper = (opt.b1, opt.b2, opt.eps)
    params = tree_leaves(create_train_state(PRNGKey(SEED), device=dev).params)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def like(scale: float) -> list:
        return [scale * torch.randn(p.shape, generator=gen, device=dev)
                for p in params]

    def row(count: int) -> torch.Tensor:
        return torch.tensor(opt.scalars(count), device=dev)

    def same(got, want) -> bool:
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for x, y in zip(got, want) for a, b in zip(x, y))

    mu, nu = like(1e-4), [t.abs() for t in like(1e-7)]
    values = sum(p.numel() for p in params)
    bad = []
    for kind, scale in (("random", 1e-3), ("zero", 0.0), ("large", 1e15)):
        grads = like(scale)
        for count in ADAM_COUNTS:
            s = row(count)
            got = fa.fused_adam(params, grads, mu, nu, s, *hyper)
            want = fa.adam_plain(params, grads, mu, nu, s, *hyper)
            torch.cuda.synchronize()
            if not same(got, want):
                bad.append((kind, count))
    grads = like(1e-3)
    s = row(0)
    fa.fused_adam(params, grads, mu, nu, s, *hyper)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.fused_adam(params, grads, mu, nu, s, *hyper)
    for count in (3, 499, 500):
        s.copy_(row(count))
        graph.replay()
        want = fa.adam_plain(params, grads, mu, nu, s, *hyper)
        torch.cuda.synchronize()
        if not same(out, want):
            bad.append(("captured", count))
    del graph
    print(f"adam: {len(params)} leaves, {values} values, counts "
          f"{list(ADAM_COUNTS)} x random/zero/large gradients and a capture "
          f"replayed at 3 rows, p, m and v bitwise the plain version: "
          f"{not bad}", flush=True)
    if bad:
        fail(f"fused_adam differs from adam_plain: {bad}")
    s = row(ADAM_COUNTS[-1])
    step, bc1, bc2 = (float(x) for x in s)
    t_ms = device_ms(lambda: fa.fused_adam(params, grads, mu, nu, s, *hyper))
    t_plain = device_ms(
        lambda: fa.adam_plain(params, grads, mu, nu, s, *hyper), n=10)
    t_plain_eager = time_ms(
        lambda: fa.adam_plain(params, grads, mu, nu, s, *hyper))
    t_foreach = device_ms(lambda: foreach_adam(
        params, grads, mu, nu, step, bc1, bc2, *hyper), n=50)
    nbytes = ADAM_BYTES * values
    bound = nbytes / H100_BYTES_PER_S * 1e3
    result = {"name": "fused_adam", "shape": f"{len(params)} leaves, "
              f"{values} values (the lego nets)", "ms": t_ms,
              "plain_ms": t_plain, "plain_eager_ms": t_plain_eager,
              "library_ms": t_foreach, "bound_ms": bound, "bound_by": "bytes",
              "bytes": nbytes, "ptxas": ptxas}
    print(f"adam: fused_adam {t_ms:.4f} ms a launch (graph of 200), plain "
          f"{t_plain:.4f} ms (672 launches, graph of 10; eager by events "
          f"{t_plain_eager:.4f}), torch._foreach_* {t_foreach:.4f} ms, bound "
          f"{bound:.5f} ms by bytes ({nbytes} B); card: {card}", flush=True)
    fa.fused_adam.launches, fa.adam_plain.calls = saved
    return result


# -- phase 14: the Instant-NGP field's kernels and its train step -----------

NGP_LAUNCHES = (65_536, 196_608)   # a train step's encodings: coarse, fine
NGP_BWD_TOL = 1e-4                 # of the level's largest plain gradient
NGP_SPR = (64, 192)                # a ray's samples in those encodings


class StatsKey:
    """An attribute view of a ``stats`` dict, so that ``Graphs`` counts
    its keys as it counts the other kernels' ``launches``."""

    def __init__(self, stats: dict):
        object.__setattr__(self, "stats", stats)

    def __getattr__(self, key: str):
        return self.stats[key]

    def __setattr__(self, key: str, value) -> None:
        self.stats[key] = value


def ngp_touched(he, levels, unit: torch.Tensor) -> int:
    """Distinct table entries the positions ``unit`` touch, summed over
    the levels (the plain version's corners, on the card)."""
    return sum(int(torch.unique(he.corner_weights(unit, lv)[0]).numel())
               for lv in levels)


def phase_ngp_kernels(card: str) -> dict:
    """14a: the hash kernels (``csrc/hash_encode.cu``) and the skip-zero
    and L2 rules of ``fused_adam`` at the published widths (16 levels, 2^19
    entries a level) and a train step's two encodings, NGP_LAUNCHES
    samples, positions uniform in [-0.1, 1.1]^3 (a sixth of them clamped in
    some dimension): the forward bitwise its plain version in float32 and
    bfloat16; the backward per level within NGP_BWD_TOL of the level's
    largest plain gradient, with the same zero entries; ``fused_adam`` over
    the field's 21 leaves (30% of the table's gradients nonzero) p, m and v
    bitwise ``adam_plain``, eagerly and replayed from a CUDA graph, every
    zero-gradient entry left as it was. Each timed through CUDA graphs of
    launches (``device_ms``; the backward with its gradient buffer's
    zeroing, as a step runs it; inputs warm in L2), its plain version by
    CUDA events, and a bound from this run's inputs at 3.35 TB/s: the
    forward's and backward's positions (12 B), features or their
    gradients (128 B in float32, 64 in bfloat16) a sample and the distinct
    entries touched (8 B; the backward also writes the zeroed 48.8 MB
    buffer); Adam's 4 B of gradient a value and 24 B more a value it
    updates. ptxas registers and spills (a spill fails). The launches and
    calls made here are taken back off the counters."""
    from cvnerf_torch.models.ngp_field import NgpFieldConfig, init_ngp_params
    from cvnerf_torch.ops import adam as fa
    from cvnerf_torch.ops import hash_encode as he
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.train.state import make_optimizer
    from cvnerf_torch.utils.tree import tree_leaves
    from cvnerf_torch.utils.kernels import build_library
    lib = build_library("hash_encode", verbose=True)
    ptxas = {}
    for kernel in ("hash_encode_fwd", "hash_encode_bwd"):
        check_ptxas(lib, kernel)
        ptxas[kernel] = ptxas_report(lib, kernel)
    saved = (dict(he.stats), fa.fused_adam.launches, fa.adam_plain.calls)
    dev = torch.device("cuda")
    cfg = NgpFieldConfig()
    levels = cfg.levels
    params = init_ngp_params(PRNGKey(SEED), cfg, dev)
    tables = [params["field"]["table"][str(k)] for k in range(cfg.n_levels)]
    entries = he.total_entries(levels)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for n in NGP_LAUNCHES:
        unit = torch.rand(n, 3, generator=gen, device=dev) * 1.2 - 0.1
        grad = torch.randn(n, 2 * cfg.n_levels, generator=gen, device=dev)
        touched = ngp_touched(he, levels, unit)
        for dt in (torch.float32, torch.bfloat16):
            got = he.hash_encode_fwd(unit, tables, levels, dt)
            want = he.hash_encode_fwd(unit, tables, levels, dt, plain=True)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"hash_encode_fwd {dt} n={n}: not bitwise the plain "
                     f"version ({int((got != want).sum())} features differ)")
            nbytes = n * (12 + 2 * cfg.n_levels * got.element_size()) \
                + 8 * touched
            rows.append({
                "name": "hash_encode_fwd", "n": n, "dtype": str(dt)[6:],
                "max_abs_err": 0.0,
                "ms": device_ms(lambda: he.hash_encode_fwd(
                    unit, tables, levels, dt)),
                "plain_ms": time_ms(lambda: he.hash_encode_fwd(
                    unit, tables, levels, dt, plain=True), reps=3),
                "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S,
                "bound_by": "bytes", "bytes": nbytes, "touched": touched})
        got = he.hash_encode_bwd(unit, grad, levels)
        want = he.hash_encode_bwd(unit, grad, levels, plain=True)
        torch.cuda.synchronize()
        worst = 0.0
        for lv in levels:
            a, b = (x[lv.offset:lv.offset + lv.entries] for x in (got, want))
            if not torch.equal(a == 0, b == 0):
                fail(f"hash_encode_bwd n={n}: other zero entries than the "
                     f"plain version's on a level of {lv.entries}")
            worst = max(worst, float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30))
        if not worst <= NGP_BWD_TOL:
            fail(f"hash_encode_bwd n={n}: {worst:.2e} of a level's largest "
                 f"gradient (tol {NGP_BWD_TOL:g})")
        nbytes = n * (12 + 4 * 2 * cfg.n_levels) + 8 * touched + 8 * entries
        rows.append({
            "name": "hash_encode_bwd", "n": n, "dtype": "float32",
            "max_abs_err": worst,
            "ms": device_ms(lambda: he.hash_encode_bwd(unit, grad, levels),
                            n=20),
            "plain_ms": time_ms(lambda: he.hash_encode_bwd(
                unit, grad, levels, plain=True), reps=3),
            "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S, "bound_by": "bytes",
            "bytes": nbytes, "touched": touched})
        del got, want
    for r in rows:
        print(f"ngp: {r['name']} n={r['n']} {r['dtype']}: {r['ms']:.4f} ms "
              f"(graph of launches), plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms by bytes ({r['bytes']} B, "
              f"{r['touched']} entries touched), err {r['max_abs_err']:.2e}",
              flush=True)

    leaves = tree_leaves(params)
    grads = [torch.randn(t.shape, generator=gen, device=dev) * 1e-3
             * (torch.rand(t.shape, generator=gen, device=dev) < 0.3)
             for t in leaves]
    mu = [torch.randn(t.shape, generator=gen, device=dev) * 1e-4
          for t in leaves]
    nu = [torch.rand(t.shape, generator=gen, device=dev) * 1e-7
          for t in leaves]
    opt = make_optimizer(1e-2, 0, cfg)
    skip, l2 = opt.rules(params)
    hyper = (opt.b1, opt.b2, opt.eps)
    s = torch.tensor(opt.scalars(7), device=dev)

    def same(got, want) -> bool:
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for x, y in zip(got, want) for a, b in zip(x, y))
    got = fa.fused_adam(leaves, grads, mu, nu, s, *hyper, skip, l2)
    want = fa.adam_plain(leaves, grads, mu, nu, s, *hyper, skip, l2)
    torch.cuda.synchronize()
    kept = all(torch.equal(got[j][k][grads[k] == 0],
                           (leaves, mu, nu)[j][k][grads[k] == 0])
               for k in range(cfg.n_levels) for j in range(3))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.fused_adam(leaves, grads, mu, nu, s, *hyper, skip, l2)
    graph.replay()
    torch.cuda.synchronize()
    ok = same(got, want) and same(out, want) and kept
    del graph, out
    print(f"ngp adam: 21 leaves ({sum(skip)} skip-zero, "
          f"{sum(f > 0 for f in l2)} with L2), p, m and v bitwise the plain "
          f"version eagerly and replayed, zero-gradient entries kept: {ok}",
          flush=True)
    if not ok:
        fail("fused_adam's skip-zero / L2 update differs from adam_plain")
    values = sum(t.numel() for t in leaves)
    updated = sum(int((g != 0).sum()) if k else g.numel()
                  for g, k in zip(grads, skip))
    nbytes = 4 * values + (ADAM_BYTES - 4) * updated
    adam = {"name": "fused_adam", "shape": f"the NGP field's 21 leaves, "
            f"{values} values, {updated} updated", "max_abs_err": 0.0,
            "ms": device_ms(lambda: fa.fused_adam(
                leaves, grads, mu, nu, s, *hyper, skip, l2), n=20),
            "plain_ms": time_ms(lambda: fa.adam_plain(
                leaves, grads, mu, nu, s, *hyper, skip, l2), reps=3),
            "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S, "bound_by": "bytes",
            "bytes": nbytes}
    print(f"ngp adam: fused_adam {adam['ms']:.4f} ms (graph of 20), plain "
          f"{adam['plain_ms']:.3f} ms, bound {adam['bound_ms']:.4f} ms by "
          f"bytes ({nbytes} B); card: {card}", flush=True)
    he.stats.update(saved[0])
    fa.fused_adam.launches, fa.adam_plain.calls = saved[1:]
    return {"rows": rows, "adam": adam, "ptxas": ptxas}


# What a captured NGP step launches, read per replay.
STEP_KEYS = ("hash_fwd", "hash_bwd", "mlp_fwd", "mlp_bwd", "adam")


def phase_ngp_mlp(card: str) -> dict:
    """14a, the MLPs: the fused pair (``csrc/ngp_mlp.cu``) at a train step's
    two passes (NGP_LAUNCHES samples, NGP_SPR a ray), the published MLPs,
    features normal with σ 0.5 in bf16, an SH row a ray, a random upstream
    gradient: the forward within twice the plain bf16 version's own
    distance from the float32 chain; the backward's features' and five
    weight gradients no farther from the plain version's than the plain
    version is from the float32 chain's (the bf16 roundings the plain chain
    adds) and no farther from the float32 chain than twice the plain
    version; the backward bitwise over two launches. Each kernel timed
    through CUDA graphs (``device_ms``; the backward with its reduction),
    the plain version (the ``torch.matmul`` chain, forward and autograd's
    backward) by CUDA events, a bound from operations (the forward's 9,408
    and the backward's least 17,792 multiply-adds a sample at 989 TFLOP/s)
    and bytes (features 64 B and output 16 B a sample forward; features,
    gradient 16 B and features' gradient 128 B backward; 64 B of SH a ray;
    the weights once) at 3.35 TB/s. ptxas registers and spills (a spill
    fails). Launches and calls made here are taken back off the
    counters."""
    from cvnerf_torch.models.ngp_field import NgpFieldConfig, init_ngp_params
    from cvnerf_torch.ops import ngp_mlp as nm
    from cvnerf_torch.ops.encoding import sh_encode
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.utils.kernels import build_library
    lib = build_library("ngp_mlp", verbose=True)
    ptxas = {}
    for kernel in ("ngp_mlp_fwd", "ngp_mlp_bwd", "ngp_mlp_wgrad_reduce"):
        check_ptxas(lib, kernel)
        ptxas[kernel] = ptxas_report(lib, kernel)
    saved = dict(nm.stats)
    dev = torch.device("cuda")
    cfg = NgpFieldConfig()
    field = init_ngp_params(PRNGKey(SEED + 20), cfg, dev)["field"]
    weights = [field[net][name] for net, name, _, _ in nm.LAYERS]
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    fwd_macs = nm.WEIGHTS
    bwd_macs = 2 * nm.WEIGHTS - nm.SH * nm.HIDDEN

    def worst(a, b):
        return float((a.float() - b.float()).abs().max())

    def plain_grads(feats, sh, spr, grad, dt):
        x = feats.to(dt).detach().requires_grad_()
        leaves = {net: {k: v.detach().clone().requires_grad_()
                        for k, v in field[net].items()}
                  for net in ("density", "color")}
        out = nm.ngp_mlp_plain(x, sh, spr, leaves, dt)
        out.backward(grad)
        return out.detach(), [x.grad.float()] + [
            leaves[net][name].grad for net, name, _, _ in nm.LAYERS]

    def plain_step(feats, sh, spr, grad):
        x = feats.detach().requires_grad_()
        leaves = [w.detach().requires_grad_() for w in weights]
        it = iter(leaves)
        tree = {net: {name: next(it) for n2, name, _, _ in nm.LAYERS
                      if n2 == net} for net in ("density", "color")}
        out = nm.ngp_mlp_plain(x, sh, spr, tree, torch.bfloat16)
        torch.autograd.grad(out, [x] + leaves, grad)

    rows = []
    for n, spr in zip(NGP_LAUNCHES, NGP_SPR):
        feats = (torch.randn(n, 32, generator=gen, device=dev) * 0.5) \
            .to(torch.bfloat16)
        dirs = torch.randn(n // spr, 3, generator=gen, device=dev)
        sh = sh_encode(dirs / dirs.norm(dim=-1, keepdim=True))
        grad = torch.randn(n, 4, generator=gen, device=dev)
        got = nm.ngp_mlp_fwd(feats, sh, spr, weights)
        want, pgrads = plain_grads(feats, sh, spr, grad, torch.bfloat16)
        exact, egrads = plain_grads(feats, sh, spr, grad, torch.float32)
        fgrad, wgrads = nm.ngp_mlp_bwd(feats, sh, spr, weights, grad)
        again = nm.ngp_mlp_bwd(feats, sh, spr, weights, grad)
        torch.cuda.synchronize()
        own = worst(want, exact)
        fwd_err = worst(got, want)
        if not fwd_err <= 2 * own + 1e-6 * float(exact.abs().max()):
            fail(f"ngp_mlp_fwd n={n}: {fwd_err:.3e} from the plain version, "
                 f"whose own distance from float32 is {own:.3e}")
        bitwise = all(torch.equal(a, b) for a, b in
                      zip([fgrad, *wgrads], [again[0], *again[1]]))
        if not bitwise:
            fail(f"ngp_mlp_bwd n={n}: two launches differ")
        names = ["features"] + [f"{a} {b}" for a, b, _, _ in nm.LAYERS]
        errs = {}
        for name, k, p_, e in zip(names, [fgrad, *wgrads], pgrads, egrads):
            scale = float(p_.abs().max())
            plain_own = worst(p_, e)
            errs[name] = worst(k, p_) / scale
            if not (worst(k, p_) <= plain_own + 1e-6 * scale
                    and worst(k, e) <= 2 * plain_own + 1e-6 * scale):
                fail(f"ngp_mlp_bwd n={n} {name}: {worst(k, p_):.3e} from "
                     f"the plain version and {worst(k, e):.3e} from "
                     f"float32, against the plain version's own "
                     f"{plain_own:.3e} from float32")
        rays = n // spr
        for name, macs, nbytes, fn, plain in (
                ("ngp_mlp_fwd", fwd_macs,
                 n * (64 + 16) + rays * 64 + 4 * nm.WEIGHTS,
                 lambda: nm.ngp_mlp_fwd(feats, sh, spr, weights),
                 lambda: nm.ngp_mlp_plain(feats, sh, spr, field,
                                          torch.bfloat16)),
                ("ngp_mlp_bwd", bwd_macs,
                 n * (64 + 16 + 128) + rays * 64 + 8 * nm.WEIGHTS,
                 lambda: nm.ngp_mlp_bwd(feats, sh, spr, weights, grad),
                 lambda: plain_step(feats, sh, spr, grad))):
            ops = 2 * n * macs
            ops_ms = 1e3 * ops / H100_BF16_FLOPS
            bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
            rows.append({
                "name": name, "n": n, "samples_per_ray": spr,
                "max_abs_err": fwd_err if name == "ngp_mlp_fwd"
                else max(errs.values()),
                "ms": device_ms(fn, n=50), "plain_ms": time_ms(plain),
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "ops": ops, "bytes": nbytes, "bitwise_rerun": bitwise})
        print(f"ngp mlp n={n}: forward {fwd_err:.3e} from the plain version "
              f"(its own distance from float32 {own:.3e}); backward "
              f"{ {k: f'{v:.2e}' for k, v in errs.items()} } of each plain "
              f"gradient's largest, bitwise over two launches {bitwise}",
              flush=True)
        del feats, sh, grad, got, want, exact, pgrads, egrads, fgrad, wgrads
    for r in rows:
        plain = ("the torch.matmul chain" if r["name"] == "ngp_mlp_fwd"
                 else "the chain forward and autograd's backward")
        print(f"ngp mlp: {r['name']} n={r['n']}: {r['ms']:.4f} ms (graph "
              f"of 50), plain {r['plain_ms']:.3f} ms ({plain}), bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['ops']:.3g} "
              f"operations, {r['bytes']} B); card: {card}", flush=True)
    nm.stats.update(saved)
    return {"rows": rows, "ptxas": ptxas}


def phase_ngp_train(fm, card: str) -> dict:
    """14b: the Instant-NGP field through ``Trainer`` (main path) at the
    ``ngp-fern-train`` cell's shape: the published field, 1024 NDC rays of
    a 378x504 image, 64 + 128 samples queried from one field (2^18 a
    step), bf16, lr 1e-2: 3 single steps, then blocks of 10 graphed steps
    (one captured after an eager warm-up, then replayed), 103 steps in
    all. The hash kernels', the fused MLPs' and Adam's counters are set to
    0 just before and read just after (captured steps counted as they run,
    ``Graphs``): every step launched 2 + 2 hash kernels, 2 + 2 MLP kernels
    (``ngp_mlp.stats``) and one Adam, no plain version ran, the loss is
    finite and the table learned. The replayed blocks'
    median ms a step by CUDA events."""
    from cvnerf_torch.models.ngp_field import NgpFieldConfig
    from cvnerf_torch.ops import adam as fa
    from cvnerf_torch.ops import hash_encode as he
    from cvnerf_torch.ops import ngp_mlp as nm
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.render.renderer import RenderConfig
    from cvnerf_torch.train.loop import TrainConfig, Trainer
    from cvnerf_torch.train.state import create_train_state
    field = NgpFieldConfig()
    tcfg = TrainConfig(height=378, width=504, focal=407.6, near=0.0,
                       far=1.0, n_rays=1024, lr=1e-2, lr_decay=0, ndc=True,
                       render=RenderConfig(n_coarse=64, n_fine=128,
                                           perturb=True, mlp=field,
                                           compute_dtype=torch.bfloat16))
    state = create_train_state(PRNGKey(SEED + 14), lr=tcfg.lr,
                               lr_decay=tcfg.lr_decay, mlp=field,
                               device="cuda")
    table0 = state.params["field"]["table"]["0"].clone()
    rng = np.random.default_rng(SEED)
    images = rng.random((4, 378, 504, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (4, 1, 1))
    poses[:, :, 3] = rng.normal(0.0, 0.05, (4, 3))
    tr = Trainer(tcfg, state, images, poses, [0, 1, 2, 3], seed=SEED,
                 steps_per_call=BLOCK)
    saved = (fa.fused_adam.launches, fa.adam_plain.calls)
    torch.cuda.synchronize()
    for k in ("fwd_launches", "bwd_launches", "plain_calls", "samples",
              "lookups"):
        he.stats[k] = 0
    for k in nm.stats:
        nm.stats[k] = 0
    fa.fused_adam.launches = fa.adam_plain.calls = 0
    n_blocks = len(GRAPHS.blocks)
    for j in range(3):
        tr.run(j, j + 1)
    tr.run(3, 3 + BLOCK)
    times = []
    for i in range(3 + BLOCK, 3 + 10 * BLOCK, BLOCK):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        m = tr.run(i, i + BLOCK)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1) / BLOCK)
    counts = {"hash_fwd": he.stats["fwd_launches"],
              "hash_bwd": he.stats["bwd_launches"],
              "hash_plain": he.stats["plain_calls"],
              "mlp_fwd": nm.stats["fwd_launches"],
              "mlp_bwd": nm.stats["bwd_launches"],
              "mlp_plain": nm.stats["plain_calls"],
              "adam": fa.fused_adam.launches,
              "adam_plain": fa.adam_plain.calls}
    blocks = [b for b in GRAPHS.blocks[n_blocks:] if b["replayed"]]
    warm = sum(b["captures"] for b in blocks)
    steps = 3 + 10 * BLOCK
    per_step = blocks[0]["per_step"] if blocks else {}
    want = {"hash_fwd": 2 * (steps + warm), "hash_bwd": 2 * (steps + warm),
            "hash_plain": 0, "mlp_fwd": 2 * (steps + warm),
            "mlp_bwd": 2 * (steps + warm), "mlp_plain": 0,
            "adam": steps + warm, "adam_plain": 0}
    learned = not torch.equal(tr.state.params["field"]["table"]["0"], table0)
    med = float(np.median(times))
    print(f"ngp train: {steps} steps (3 single, {len(blocks)} graphed "
          f"blocks of {BLOCK}, {warm} eager warm-up steps), loss "
          f"{m['loss']:.5f}, table learned {learned}; launches {counts} "
          f"(expected {want}), a captured step "
          f"{ {k: per_step.get(k) for k in STEP_KEYS} }"
          f"; {med:.3f} ms a step ({[round(t, 3) for t in times]}); "
          f"trainer counters {tr.counters()}; card: {card}", flush=True)
    if not (counts == want and np.isfinite(m["loss"]) and learned
            and {k: per_step.get(k) for k in STEP_KEYS}
            == {"hash_fwd": 2, "hash_bwd": 2, "mlp_fwd": 2, "mlp_bwd": 2,
                "adam": 1}):
        fail("the NGP train step did not run exactly through its kernels")
    fa.fused_adam.launches += saved[0]
    fa.adam_plain.calls += saved[1]
    return {"counts": counts, "step_ms": med, "steps": steps,
            "warm_up_steps": warm, "loss": m["loss"]}


# -- phase 13: a frame as one CUDA-graph dispatch ----------------------------

FRAME_ROUNDS = 4              # interleaved rounds of eager and graphed frames
FRAMES_A_ROUND = 2
FRAME_KEYS = ("rgb", "rgb_coarse", "acc", "depth")


def copies(out: dict) -> dict:
    return {k: v.clone() for k, v in out.items()}


def frame_inputs(r, c2w, key=None, factor: int = 0, **change) -> dict:
    """The dynamic inputs of a frame of renderer ``r`` (nets, focal,
    pose, near, far, key, grid), with ``change`` put in their place."""
    x = {"nets": r._nets, "focal": r.focal / factor if factor else r.focal,
         "c2w": torch.from_numpy(np.asarray(c2w, np.float32)[:3, :4]),
         "near": r.near, "far": r.far, "key": r._key if key is None else key,
         "occupancy": r.occupancy}
    return {**x, **change}


def program_frame(r, c2w, key=None, factor: int = 0, **change):
    """One frame of renderer ``r`` through its frame programs (as
    ``render_pose_extras`` renders it), copied out, and its program."""
    h, w = r.height, r.width
    if factor:
        h, w = h // factor, w // factor
    x = frame_inputs(r, c2w, key, factor, **change)
    out = r.programs(x["nets"], h, w, x["focal"], x["c2w"], x["near"],
                     x["far"], r.cfg, device=r.device, take=copies,
                     ndc=r.ndc, ndc_variant=r.ndc_variant, chunk=r.chunk,
                     key=x["key"], occupancy=x["occupancy"], mesh=r.mesh)
    return out, r.programs.programs[-1]


def load_frame(prog, r, c2w, key=None, factor: int = 0, **change) -> None:
    """Copy a frame's inputs into ``prog``'s static buffers."""
    x = frame_inputs(r, c2w, key, factor, **change)
    prog.load(x["nets"], x["focal"], x["c2w"], x["near"], x["far"],
              x["key"], x["occupancy"])


def eager_frame(prog, r, c2w, key=None, factor: int = 0, **change) -> dict:
    """The frame through the program's body run eagerly, from the same
    static buffers: the reference a replay is held against."""
    load_frame(prog, r, c2w, key, factor, **change)
    prog._body()
    return copies(prog.out)


def traced_changes(r) -> dict:
    """Phase 13a's changes of the scalars and the grid that JAX traces:
    a new focal, near and far, and the grid's values scaled (its shape
    kept). A value frozen at capture would replay unchanged."""
    out = {"focal": {"focal": r.focal * 1.05}, "near": {"near": r.near + 0.3},
           "far": {"far": r.far - 0.5}}
    if r.occupancy is not None:
        g = r.occupancy
        out["grid"] = {"occupancy": _map_grid(g, lambda v: v * 0.5)}
    return out


def _map_grid(g, fn):
    """A grid (or each copy of a replicated one) with ``fn`` applied to
    its values."""
    from cvnerf_torch.parallel.mesh import Replicated
    if isinstance(g, Replicated):
        y = object.__new__(Replicated)
        y.copies = {d: _map_grid(v, fn) for d, v in g.copies.items()}
        return y
    return dataclasses.replace(g, values=fn(g.values))


def frame_variants(run: str, run32: str) -> dict:
    """Phase 13's frame variants: name -> (the run directory and the
    server's flags, or a mesh, that start the renderer; the launches of
    one frame)."""
    from cvnerf_torch.parallel.mesh import make_mesh
    per = 2 * -(-SERVE_HW * SERVE_HW // CHUNK)                    # 40
    occ = ["--occupancy_res", str(OCC_RES)]
    return {
        "bf16": ((run, []), {"fwd": per}),
        "fp32": ((run32, []), {"fwd": per}),
        "int8": ((run, ["--int8"]), {"int8": per}),
        "merge_trilinear": ((run, ["--occupancy", "merge", *occ]),
                            {"fwd": per // 2}),
        "merge_nearest": ((run, ["--occupancy", "merge", "--occ_interp",
                                 "nearest", *occ]), {"fwd": per // 2}),
        "full_trilinear": ((run, ["--occupancy", "full", *occ]),
                           {"fwd": per // 2}),
        "full_nearest": ((run, ["--occupancy", "full", "--occ_interp",
                                "nearest", *occ]), {"fwd": per // 2}),
        "full_term": ((run, ["--occupancy", "full", "--occ_term", "1e-3",
                             "--serve_coarse", "32", "--serve_fine", "64",
                             *occ]), {"fwd": per // 2}),
        "int8_merge": ((run, ["--int8", "--occupancy", "merge", *occ]),
                       {"int8": per // 2}),
        "stochastic": ((run, ["--stochastic"]), {"fwd": per}),
        "two_shards": ((run, make_mesh(devices=["cuda:0", "cuda:0"])),
                       {"fwd": 2 * per}),
    }


def fp32_copy(run: str, dst: str) -> str:
    """``run`` copied to ``dst`` with its snapshot saying ``"bf16":
    false``: the same weights served in fp32."""
    import shutil
    shutil.copytree(run, dst)
    path = os.path.join(dst, "scene.json")
    with open(path) as fp:
        geo = json.load(fp)
    with open(path, "w") as fp:
        json.dump({**geo, "bf16": False}, fp)
    return dst


def start_renderer(run: str, flags):
    """The server's renderer with its startup steps, or a renderer over a
    mesh when ``flags`` is one."""
    from cvnerf_torch.parallel.mesh import Mesh
    from cvnerf_torch.serve import NerfRenderer
    from cvnerf_torch.server import (build_parser, int8_from_args,
                                     occupancy_from_args, renderer_from_args)
    if isinstance(flags, Mesh):
        return NerfRenderer.from_run_dir(run, device="cuda", use_mesh=flags)
    args = build_parser().parse_args(["--run", run, "--device", "cuda",
                                      *flags])
    r = renderer_from_args(args)
    occupancy_from_args(r, args)
    int8_from_args(r, args)
    return r


def phase_frame_programs(fm, fb, fq, card: str, variants: dict) -> dict:
    """13a: every frame variant through its renderer's frame program on
    the card. A pose's first frame (eager, then the capture), the same pose
    replayed, another pose (and key) replayed and the same other frame
    through the body run eagerly: the replays bitwise their eager frames
    (rgb, rgb_coarse, acc, depth), each frame launching exactly what a
    frame of the variant launches (40, or 20 through a grid, 80 on two
    shards) and no plain version. Then a new focal, near, far and (through
    a grid) the grid's values scaled, one at a time: each a replay,
    bitwise the body run eagerly on the same buffers, and each frame moved
    off the first. One capture a program, every later frame a replay;
    capture seconds and pool bytes. Returns the rows, the renderers phase
    13b times and the launches of the frames rendered through the
    programs (the eager references' apart)."""
    from cvnerf_torch.ops.rng import PRNGKey
    a, b = pose(0.3), pose(1.9)
    rows, keep = {}, {}
    total = {k: 0 for k in MLP_COUNTS}
    for name, ((run, flags), want) in variants.items():
        r = start_renderer(run, flags)
        want = {"fwd": 0, "bwd": 0, "int8": 0, "fwd_plain": 0,
                "bwd_plain": 0, "int8_plain": 0, **want}
        key_b = PRNGKey(SEED + 13)
        counts, outs = [], {}
        for step, call in (
                ("first", lambda: program_frame(r, a)),
                ("replay", lambda: program_frame(r, a)),
                ("replay_b", lambda: program_frame(r, b, key=key_b)),
                ("eager_b", lambda: (eager_frame(prog, r, b, key=key_b),
                                     prog))):
            torch.cuda.synchronize()
            reset_counts(fm, fb, fq)
            outs[step], prog = call()
            torch.cuda.synchronize()
            counts.append(read_counts(fm, fb, fq))
        changes = traced_changes(r)
        for what, change in changes.items():
            torch.cuda.synchronize()
            reset_counts(fm, fb, fq)
            outs[what], _ = program_frame(r, a, **change)
            torch.cuda.synchronize()
            counts.append(read_counts(fm, fb, fq))
            outs[what + "_eager"] = eager_frame(prog, r, a, **change)
        pairs = [("first", "replay"), ("replay_b", "eager_b"),
                 *((w, w + "_eager") for w in changes)]
        same = {k: all(bool(torch.equal(outs[x][k], outs[y][k]))
                       for x, y in pairs) for k in FRAME_KEYS}
        moved = {w: not torch.equal(outs["first"]["rgb"], outs[w]["rgb"])
                 for w in ("replay_b", *changes)}
        stats = dict(prog.stats)
        ok_counts = all(c == want for c in counts)
        for i, c in enumerate(counts):
            if i != 3:             # the eager reference's launches apart
                for k in total:
                    total[k] += c[k]
        rows[name] = {"bitwise": same, "moved": moved, "launches": counts[1],
                      "capture_s": stats["capture_s"],
                      "pool_bytes": stats["pool_bytes"], "stats": stats}
        print(f"frame program {name}: replay bitwise its eager frame "
              f"{same}; another pose, {', '.join(changes)} moved the "
              f"frame: {moved}; launches a frame (first, replay, replay of "
              f"another pose, eager, then a replay per change) "
              f"{[c[k] for c in counts for k in ('fwd', 'int8')]} (expected "
              f"{want['fwd']} fwd, {want['int8']} int8, plain 0: "
              f"{ok_counts}); stats {stats}; card: {card}", flush=True)
        if not (all(same.values()) and all(moved.values()) and ok_counts
                and stats["captures"] == 1
                and stats["replays"] == 2 + len(changes)):
            fail(f"frame program {name}: a replay differs from its eager "
                 f"frame, an input did not move it, or its launches or "
                 f"captures are off")
        if name in ("bf16", "int8", "full_nearest", "merge_trilinear"):
            keep[name] = r
        del r, prog, outs
    return rows, keep, total


def frame_split(fn, n: int, frame_ms: float) -> dict | None:
    """A frame's device time by ``torch.profiler`` over ``n`` frames of
    ``fn``: the forward kernels, other device work, and the idle share of
    the median frame ``frame_ms``; None when the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    mlp = other = 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        if "fused_nerf" in e.key:
            mlp += e.self_device_time_total
        else:
            other += e.self_device_time_total
    busy = (mlp + other) / n / 1e3
    if busy <= 0:
        return None
    return {"kernel_ms": mlp / n / 1e3, "other_device_ms": other / n / 1e3,
            "idle_ms": frame_ms - busy, "idle_share": 1.0 - busy / frame_ms}


def time_program(prog, r, c2w, factor: int = 0) -> dict:
    """Eager frames (the body without a graph) against replays of
    ``prog``, FRAME_ROUNDS interleaved rounds of FRAMES_A_ROUND frames
    each (the order alternating), every frame's inputs copied in: median
    ms by CUDA events and by wall clock (synced), each frame's split and
    idle share by the profiler."""
    def eager():
        load_frame(prog, r, c2w, factor=factor)
        prog._body()

    def graph():
        load_frame(prog, r, c2w, factor=factor)
        prog.run()
    fns = {"eager": eager, "graph": graph}
    ms = {k: [] for k in fns}
    wall = {k: [] for k in fns}
    order = list(fns)
    for rnd in range(FRAME_ROUNDS):
        for kind in order[rnd % 2:] + order[:rnd % 2]:
            for _ in range(FRAMES_A_ROUND):
                torch.cuda.synchronize()
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                ev0.record()
                fns[kind]()
                ev1.record()
                torch.cuda.synchronize()
                wall[kind].append((time.perf_counter() - t0) * 1e3)
                ms[kind].append(ev0.elapsed_time(ev1))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    return {"median_ms": med,
            "median_wall_ms": {k: float(np.median(v))
                               for k, v in wall.items()},
            "rounds_ms": ms,
            "split": {k: frame_split(fns[k], 3, med[k]) for k in fns},
            "capture_s": prog.stats["capture_s"],
            "pool_bytes": prog.stats["pool_bytes"]}


def phase_frame_timing(card: str, run: str, kept: dict) -> dict:
    """13b: eager frames against graph replays, timed and profiled, at
    400x400 and chunk 8192 (the server's shape) for bf16, int8, occupancy
    ``full`` nearest and ``merge`` trilinear; bf16 at ``factor`` 2 and 4;
    a 200x200 frame at the CLI's chunk 4096 (the band fixture's validation
    shape). Then the trilinear and the nearest probe of one chunk's coarse
    points (8,192 rays x 64) alone, inside a CUDA graph."""
    from cvnerf_torch.ops.rays import ray_grid
    from cvnerf_torch.ops.sampling import stratified_samples
    from cvnerf_torch.render.occupancy import probe_sigma
    from cvnerf_torch.serve import NerfRenderer
    c2w = pose(0.7)
    shapes = {f"{k}_400": (kept[k], 0) for k in ("bf16", "int8",
                                                  "full_nearest",
                                                  "merge_trilinear")}
    shapes["bf16_factor2"] = (kept["bf16"], 2)
    shapes["bf16_factor4"] = (kept["bf16"], 4)
    shapes["val_200_chunk4096"] = (NerfRenderer.from_run_dir(
        run, chunk=4096, device="cuda"), 2)
    out = {}
    for name, (r, factor) in shapes.items():
        program_frame(r, pose(1.3), factor=factor)       # captured, warm
        _, prog = program_frame(r, pose(1.1), factor=factor)
        row = out[name] = time_program(prog, r, c2w, factor)
        sp = {k: [round(v, 3) for v in d.values()] if d else None
              for k, d in row["split"].items()}
        print(f"frame timing {name} ({prog.height}x{prog.width}, chunk "
              f"{prog.chunk}): median ms by CUDA events eager "
              f"{row['median_ms']['eager']:.3f}, graph "
              f"{row['median_ms']['graph']:.3f} (wall "
              f"{row['median_wall_ms']['eager']:.3f} / "
              f"{row['median_wall_ms']['graph']:.3f}); split ms (forward "
              f"kernels, other device, idle, idle share) eager "
              f"{sp['eager']}, graph {sp['graph']}; capture "
              f"{row['capture_s']:.3f} s, pool {row['pool_bytes']} B; card: "
              f"{card}", flush=True)
    r = kept["merge_trilinear"]
    rays_o, rays_d = (x.reshape(-1, 3)[:CHUNK] for x in ray_grid(
        SERVE_HW, SERVE_HW, r.focal, pose_on_card(c2w)))
    t = stratified_samples(r.near, r.far, r.cfg.n_coarse, CHUNK, False,
                           device="cuda")
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    probe = {interp: device_ms(lambda i=interp: probe_sigma(r.occupancy,
                                                            pts, i), n=20)
             for interp in ("trilinear", "nearest")}
    out["probe_ms_a_chunk"] = probe
    print(f"frame timing: the occupancy probe of one chunk's coarse points "
          f"({CHUNK} x {r.cfg.n_coarse}) inside a CUDA graph: trilinear "
          f"{probe['trilinear']:.4f} ms, nearest {probe['nearest']:.4f} ms; "
          f"card: {card}", flush=True)
    return out


def phase_frame_sequence(fm, fb, fq, card: str, r) -> dict:
    """13c: three poses through ``render_video`` (one frame in flight,
    each copied out before the next replay) against three
    ``render_pose`` calls, bitwise; every frame 40 launches."""
    poses = [pose(0.3), pose(1.1), pose(2.5)]
    torch.cuda.synchronize()
    reset_counts(fm, fb, fq)
    video = r.render_video(np.stack(poses))
    torch.cuda.synchronize()
    counts = read_counts(fm, fb, fq)
    singles = [r.render_pose(p) for p in poses]
    same = all(np.array_equal(v, s) for v, s in zip(video, singles))
    distinct = not np.array_equal(video[0], video[1])
    want = 3 * 2 * -(-SERVE_HW * SERVE_HW // CHUNK)
    print(f"frame sequence: render_video of 3 poses bitwise 3 render_pose "
          f"calls: {same} (frames distinct: {distinct}); launches {counts} "
          f"(expected fwd {want}); card: {card}", flush=True)
    if not (same and distinct and counts["fwd"] == want
            and counts["fwd_plain"] == 0):
        fail("render_video lost or changed a frame")
    return {"bitwise": same, "counts": counts}


def phase_cli_validation(card: str, tmp: str, programs: dict) -> dict:
    """13d: phase 7's uninterrupted CLI run (60 steps, validation at 30 and
    60, the test eval): its frames went through one captured program (one
    capture, every other frame a replay), and each validation PSNR it
    logged equals the same views scored from the step's checkpoint through
    frames rendered eagerly (the program's body without a graph)."""
    from cvnerf_torch.data.datasets import load_scene
    from cvnerf_torch.serve import NerfRenderer
    from cvnerf_torch.utils.image import psnr_images
    run_a = os.path.join(tmp, "cli_logs", "lego_a")
    with open(os.path.join(run_a, "metrics.jsonl")) as fp:
        logged = {r["step"]: r["val_psnr"] for r in map(json.loads, fp)
                  if "val_psnr" in r}
    scene = load_scene(os.path.join(tmp, "lego_fixture"), "blender",
                       half_res=True, testskip=1, white_bkg=True)
    views = np.asarray(scene.val_idx)[:4]
    eager = {}
    for step in (30, 60):
        r = NerfRenderer.from_run_dir(run_a, step=step, which="last",
                                      chunk=4096, device="cuda")
        _, prog = program_frame(r, scene.poses[int(views[0])])
        eager[step] = float(np.mean([
            psnr_images(eager_frame(prog, r, scene.poses[int(i)])["rgb"]
                        .cpu().numpy(), scene.images[int(i)])
            for i in views]))
    equal = logged == eager
    # 2 validation frames at 30, 2 at 60, 2 test frames: the first eager
    # and captured, 5 replays.
    one = programs == {"captures": 1, "replays": 5, "eager_frames": 1}
    print(f"cli validation: the uninterrupted run's frames through frame "
          f"programs {programs} (one capture, the rest replays: {one}); "
          f"val psnr logged {logged}, scored eagerly from the checkpoints "
          f"{eager}: equal {equal}; card: {card}", flush=True)
    if not (equal and one):
        fail("cli validation: the frames did not replay one program, or "
             "their psnr differs from eager scoring")
    return {"programs": programs, "val_psnr": logged, "equal": equal}


def check_png_or_ppm(body: bytes, ctype: str, h: int, w: int) -> None:
    if ctype == "image/png":
        if body[:8] != b"\x89PNG\r\n\x1a\n":
            fail("png response without the PNG signature")
        got = (int.from_bytes(body[20:24], "big"),
               int.from_bytes(body[16:20], "big"))   # IHDR height, width
    elif ctype == "image/x-portable-pixmap":
        head = body.split(b"\n", 3)
        wh = head[1].split()
        got = (int(wh[1]), int(wh[0]))
        if len(head[3]) != h * w * 3:
            fail("PPM payload has the wrong size")
    else:
        fail(f"unexpected content type {ctype!r}")
    if got != (h, w):
        fail(f"image is {got}, expected {(h, w)}")


def http(url: str, payload: dict | None = None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            fail(f"{url} answered {resp.status}")
        return resp.read(), resp.headers["Content-Type"]


def pose(theta: float, radius: float = 4.0) -> np.ndarray:
    """A camera on a circle around the origin, looking at it."""
    c, s = np.cos(theta), np.sin(theta)
    cam = np.array([radius * s, -radius * c, 1.5], np.float32)
    fwd = -cam / np.linalg.norm(cam)
    right = np.cross(fwd, [0, 0, 1.0]).astype(np.float32)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    return np.stack([right, up, -fwd, cam], axis=1).astype(np.float32)


def pose_on_card(c2w) -> torch.Tensor:
    """A ``[3+, 4]`` pose as a ``[3, 4]`` float32 tensor on the card."""
    return torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4],
                           device="cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params
    from cvnerf_torch.ops import fused_mlp as fm
    from cvnerf_torch.ops import fused_mlp_bwd as fb
    from cvnerf_torch.ops import fused_mlp_int8 as fq
    from cvnerf_torch.ops import quantize as tq
    from cvnerf_torch.ops import rng
    from cvnerf_torch.render.frames import render_image
    from cvnerf_torch.render.renderer import RenderConfig
    from cvnerf_torch.server import build_parser, make_server, renderer_from_args

    global GRAPHS
    from cvnerf_torch.ops import adam as fa
    from cvnerf_torch.ops import hash_encode as he
    from cvnerf_torch.ops import threefry as tf
    GRAPHS = Graphs(all_counters(fm, fb, fq))
    GRAPHS.install()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    cfg = NerfMLPConfig()
    params = init_nerf_params(rng.PRNGKey(SEED), cfg, "cuda")

    # -- 1. kernels against their plain versions --------------------------
    rows = phase_kernels(fm, cfg, params)
    # -- 1b. the backward kernel against its plain version ----------------
    bwd_rows = phase_backward(fm, fb, cfg, params)
    # -- 1c. the int8 kernel against its plain version --------------------
    int8_rows = phase_int8(fm, fq, tq, rng, cfg, params)
    # -- 12a. the draw kernels against their plain versions ---------------
    draw_rows = phase_draws(card)
    # -- 12e. Adam's kernel against its plain version ----------------------
    adam_row = phase_adam(card)
    # -- 14a. the NGP field's kernels against their plain versions --------
    ngp = phase_ngp_kernels(card)
    ngp_mlp_row = phase_ngp_mlp(card)
    # From here on every draw and Adam launch counts (the comparisons above
    # are taken back off the counters).
    tf.threefry_bits.launches = tf.feistel_draw.launches = 0
    fa.fused_adam.launches = fa.adam_plain.calls = 0

    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "lego_serve")
        write_run_dir(run, cfg, init_nerf_params, SEED + 2)

        # -- 2. serve over HTTP (main path) -------------------------------
        args = build_parser().parse_args(["--run", run, "--device", "cuda",
                                          "--port", "0"])
        renderer = renderer_from_args(args)
        srv = make_server(renderer, "127.0.0.1", 0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        c2w = pose(0.3)[:3].tolist()
        try:
            health = json.loads(http(url + "/health")[0])
            if health["status"] != "ok" or health["height"] != SERVE_HW:
                fail(f"bad /health: {health}")
            fm.fused_nerf_apply.launches = 0
            fm.fused_nerf_plain.calls = 0
            t0 = time.time()
            body, ctype = http(url + "/render", {"c2w": c2w})
            t_png = time.time() - t0
            check_png_or_ppm(body, ctype, SERVE_HW, SERVE_HW)
            t0 = time.time()
            body, _ = http(url + "/render", {"c2w": c2w, "format": "json",
                                             "include_depth": True})
            t_json = time.time() - t0
            out = json.loads(body)
            rgb = np.asarray(out["rgb"], np.float32)
            depth = np.asarray(out["depth"], np.float32)
            if (rgb.shape != (SERVE_HW, SERVE_HW, 3)
                    or depth.shape != (SERVE_HW, SERVE_HW)
                    or not (np.isfinite(rgb).all() and np.isfinite(depth).all())):
                fail("json render: wrong shape or non-finite values")
            body, _ = http(url + "/render", {"c2w": c2w, "factor": 2,
                                             "format": "json"})
            small = np.asarray(json.loads(body)["rgb"], np.float32)
            if small.shape != (SERVE_HW // 2, SERVE_HW // 2, 3) \
                    or not np.isfinite(small).all():
                fail("factor-2 render: wrong shape or non-finite values")
            serve_launches = fm.fused_nerf_apply.launches
            serve_plain = fm.fused_nerf_plain.calls
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=30)
        per_frame = 2 * -(-SERVE_HW * SERVE_HW // CHUNK)          # 40
        half = 2 * -(-(SERVE_HW // 2) ** 2 // CHUNK)               # 10
        print(f"serve: 3 x 200 from /render (png {ctype}, json+depth, "
              f"factor 2); png {t_png * 1e3:.1f} ms, json {t_json * 1e3:.1f}"
              f" ms wall; kernel launches {serve_launches} (expected "
              f"{2 * per_frame + half}), plain calls {serve_plain}",
              flush=True)
        if serve_launches != 2 * per_frame + half or serve_plain != 0:
            fail("the serving path did not run exactly through the kernel")

        # -- 3. pose sequence (main path) ---------------------------------
        poses = np.stack([pose(0.3), pose(1.1)])
        fm.fused_nerf_apply.launches = 0
        fm.fused_nerf_plain.calls = 0
        torch.cuda.synchronize()
        t0 = time.time()
        frames = renderer.render_video(poses)
        video_ms = (time.time() - t0) * 1e3
        video_launches = fm.fused_nerf_apply.launches
        video_plain = fm.fused_nerf_plain.calls
        # One frame is in flight, so both frames land together: report the
        # sequence's wall time per frame.
        print(f"render_video: 2 frames {frames.shape} in {video_ms:.1f} ms "
              f"wall ({video_ms / 2:.1f} ms/frame), kernel launches "
              f"{video_launches} (expected {2 * per_frame}), plain calls "
              f"{video_plain}", flush=True)
        if (frames.shape != (2, SERVE_HW, SERVE_HW, 3)
                or not np.isfinite(frames).all()):
            fail("render_video: wrong shape or non-finite frames")
        if video_launches != 2 * per_frame or video_plain != 0:
            fail("render_video did not run exactly through the kernel")
        if not np.allclose(frames[0], rgb, atol=1e-6):
            fail("render_video frame 0 differs from the served json render")

        # -- 2b. int8 serving over HTTP (main path) -----------------------
        int8_counts = phase_int8_serve(fm, fb, fq, run, c2w, renderer, rgb,
                                       np.asarray(out["acc"], np.float32),
                                       t_json)

        # -- 3b. fp32 serving, the --no-bf16 path (main path) -------------
        run32 = os.path.join(tmp, "lego_serve_fp32")
        write_run_dir(run32, cfg, init_nerf_params, SEED + 2, bf16=False)
        frame32_counts, frame32_ms = phase_frame_fp32(fm, fb, fq, run32)

    # -- 4. kernel vs kernels="off", end to end, on the card -------------
    nets = {k: init_nerf_params(rng.PRNGKey(SEED + 3 + i),
                                cfg, "cuda")
            for i, k in enumerate(("coarse", "fine"))}
    c2w = torch.as_tensor(pose(0.7)[:3], device="cuda")
    for dt, tol_rgb, tol_depth in ((torch.float32, 1e-4, 1e-3),
                                   (torch.bfloat16, 2e-2, 1e-1)):
        base = RenderConfig(n_coarse=64, n_fine=128, white_bkg=True, mlp=cfg,
                            compute_dtype=dt, deterministic_resample=True
                            ).eval_mode()
        on = render_image({k: fm.FusedNerfWeights(v, cfg, dt)
                           for k, v in nets.items()}, 48, 64, 70.0, c2w,
                          2.0, 6.0, base, chunk=1000)
        off = render_image(nets, 48, 64, 70.0, c2w, 2.0, 6.0,
                           dataclasses.replace(base, kernels="off"),
                           chunk=1000)
        errs = {k: (on[k] - off[k]).abs().max().item() for k in on}
        print(f"end to end {str(dt)[6:]} kernel vs kernels='off': "
              + " ".join(f"{k}={v:.2e}" for k, v in errs.items()), flush=True)
        for k, v in errs.items():
            if not v <= (tol_depth if k == "depth" else tol_rgb):
                fail(f"end-to-end {dt} {k} differs by {v}")

    # -- 5. train through Trainer (main path) -----------------------------
    train_counts, step_ms, split, trained = phase_train(fm, fb, fq, card)
    # -- 5b. fp32 training, the --no-bf16 path (main path) ----------------
    train32_counts, step32_ms, split32 = phase_train_fp32(fm, fb, fq, card)

    # -- 6. one train step, kernels vs kernels="off", on the card ----------
    phase_step_vs_off(cfg)
    # -- 10a. the occupancy bake of phase 5's trained nets (main path) ----
    occ_bake = phase_occ_bake(fm, fb, fq, card, trained, cfg)
    del trained
    # -- 10d. occupancy steps against kernels="off", and timed ------------
    occ_steps = phase_occ_steps(fm, fb, fq, card)

    with tempfile.TemporaryDirectory() as tmp:
        # -- 7. the training entry point (main path) ----------------------
        cli = phase_cli(fm, fb, fq, card, tmp)
        # -- 8. the training levers (main path) ---------------------------
        levers = phase_levers(fm, fb, fq, card)
        lever_cli = phase_lever_cli(fm, fb, fq, card, tmp,
                                    os.path.join(tmp, "lego_fixture"))
        # -- 9. a quality band (main path) --------------------------------
        band = phase_band(fm, fb, fq, card, tmp)
        # -- 10b, 10c. occupancy serving of phase 7's run, bf16 and int8 --
        run_a = os.path.join(tmp, "cli_logs", "lego_a")
        occ_serve, occ_frames = phase_occ_serve(fm, fb, fq, card, run_a)
        # -- 10f. LPIPS of two of those frames, card against CPU ----------
        lpips = phase_lpips(card, tmp, occ_frames["merge"],
                            occ_frames["full_term"])
        # -- 10d. occupancy training through the CLI (main path) ----------
        occ_cli = phase_occ_cli(fm, fb, fq, card, tmp)
        # -- 10e. the mesh CLI on phase 7's run (main path) ---------------
        mesh = phase_mesh(fm, fb, fq, card, run_a, tmp)
        # -- 11a. a two-shard mesh on the one card (main path) ------------
        shards = phase_shards(fm, fb, fq, card, run_a)
        # -- 11b. a one-rank NCCL world through the CLI (main path) -------
        dist_cli = phase_dist_cli(fm, fb, fq, card, tmp)
        # -- 12d. phase 7's run at --steps_per_call 1 against 10 ----------
        cli_spc = phase_cli_spc(fm, fb, fq, card, tmp)
        # -- 13a. every frame variant replayed against its eager frame ----
        run32 = fp32_copy(run_a, os.path.join(tmp, "lego_a_fp32"))
        frame_rows, kept, frame_counts = phase_frame_programs(
            fm, fb, fq, card, frame_variants(run_a, run32))
        # -- 13b. eager frames against replays, timed and profiled --------
        frame_timing = phase_frame_timing(card, run_a, kept)
        # -- 13c. a pose sequence against single frames -------------------
        frame_seq = phase_frame_sequence(fm, fb, fq, card, kept["bf16"])
        del kept
        # -- 13d. the CLI's validations through one program ---------------
        cli_val = phase_cli_validation(card, tmp, cli["frame_programs"])
    # -- 12b. blocks of captured steps against single steps (main path) --
    blocks = phase_blocks(fm, fb, fq, card)
    # -- 12c. blocks against single steps, timed -------------------------
    block_timing = phase_block_timing(fm, fb, fq, card)
    # -- 14b. the NGP field through Trainer (main path) ------------------
    ngp_train = phase_ngp_train(fm, card)
    late = [levers["counts"], lever_cli["counts"], band["counts"],
            occ_cli["counts"], shards["counts"], dist_cli["counts"],
            cli_spc["counts"], frame_counts, frame_seq["counts"],
            *({k: v[k] for k in MLP_COUNTS}
              for v in (b["counts"] for b in blocks.values()))]
    sharded = {"shards": {k: v for k, v in shards.items() if k != "counts"},
               "dist_cli": {k: v for k, v in dist_cli.items()
                            if k != "counts"}}
    occ_fwd = (occ_bake["counts"]["fwd"] + occ_serve["counts"]["fwd"]
               + mesh["counts"]["fwd"])

    main_launches = (serve_launches + video_launches + train_counts["fwd"]
                     + cli["counts"]["fwd"] + sum(c["fwd"] for c in late)
                     + occ_fwd)
    serve_row = next(r for r in rows
                     if r["n"] == CHUNK * 192 and r["dtype"] == "bfloat16")
    fine_row = next(r for r in bwd_rows
                    if r["n"] == 1024 * 192 and r["dtype"] == "bfloat16")

    def fp32_of(shape_rows, n):
        r = next(r for r in shape_rows
                 if r["n"] == n and r["dtype"] == "float32")
        return {k: v for k, v in r.items() if k not in ("n", "dtype")}
    report = {"kernels": [{
        "name": "fused_nerf_apply", "route": "cuda",
        "source": "cvnerf_torch/csrc/fused_mlp.cu",
        "replaces": "cvnerf_tpu/ops/pallas/fused_mlp.py:398",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": serve_row["ms"], "plain_ms": serve_row["plain_ms"],
        "bound_ms": serve_row["bound_ms"], "bound_by": serve_row["bound_by"],
        "library_ms": None,
        "shapes": rows,
        "fp32": {"kernel": "fused_nerf_ffma",
                 "launches": frame32_counts["fwd"] + train32_counts["fwd"],
                 "frame_ms": frame32_ms, **fp32_of(rows, CHUNK * 192)},
        "cli": {k: v for k, v in cli.items() if k != "counts"},
        "occupancy": {
            "bake": {k: v for k, v in occ_bake.items() if k != "counts"},
            "serve": {k: v for k, v in occ_serve.items() if k != "counts"},
            "mesh": {k: v for k, v in mesh.items() if k != "counts"},
            "lpips": lpips},
        "parallel": sharded,
        "frames": {"programs": frame_rows, "timing": frame_timing,
                   "sequence": {k: v for k, v in frame_seq.items()
                                if k != "counts"},
                   "cli_validation": cli_val},
        "note": "ms/plain_ms/bound_ms at the fine-pass chunk "
                f"(n={CHUNK * 192}, bf16: fused_nerf_wgmma); fp32 (the "
                "--no-bf16 path, fused_nerf_ffma) at the same chunk, its "
                "launches from one fp32 frame and the fp32 train steps; "
                "launches include phase 7's (the CLI: train steps, "
                "validation, test, render-only and serving frames, in bf16 "
                "and fp32), whose numbers stand under cli, and phases 8-9's "
                "(the levers and the sphere_hi_3000 band) and phase 10's "
                "(occupancy bakes, occupancy frames, occupancy training "
                "through the CLI, the mesh grid), whose numbers stand under "
                "occupancy, and phase 11's (a two-shard mesh's steps and "
                "frames, a one-rank NCCL world through the CLI), whose "
                "numbers stand under parallel, and phase 13's program "
                "frames (13a's, not its eager references; 13c's); frames: "
                "phase 13 (each frame variant's program replayed against "
                "its eager frame, eager frames against replays timed and "
                "profiled, a pose sequence, the CLI's validations); no "
                "single PyTorch call "
                "computes this function, so library_ms is null",
    }, {
        "name": "fused_nerf_bwd", "route": "cuda",
        "source": "cvnerf_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "cvnerf_tpu/ops/pallas/fused_mlp_bwd.py:207",
        "launches": (train_counts["bwd"] + cli["counts"]["bwd"]
                     + sum(c["bwd"] for c in late)),
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "ms": fine_row["ms"], "plain_ms": fine_row["plain_ms"],
        "bound_ms": fine_row["bound_ms"], "bound_by": fine_row["bound_by"],
        "library_ms": None,
        "shapes": bwd_rows,
        "step_ms": step_ms,
        "step_split_ms": split,
        "levers": {k: v for k, v in levers.items() if k != "counts"},
        "band": {k: v for k, v in band.items() if k != "counts"},
        "occupancy": {"steps": occ_steps,
                      "cli": {k: v for k, v in occ_cli.items()
                              if k != "counts"}},
        "fp32": {"kernels": ["fused_nerf_bwd_ffma", "wgrad_ffma"],
                 "launches": train32_counts["bwd"], "step_ms": step32_ms,
                 "step_split_ms": split32, **fp32_of(bwd_rows, 1024 * 192)},
        "note": "ms/plain_ms/bound_ms at a train step's fine pass "
                "(n=196608, bf16), pass1_ms the pass-1 kernel "
                "fused_nerf_bwd_wgmma alone (profiler; in fp32, the "
                "--no-bf16 path, fused_nerf_bwd_ffma, then wgrad_ffma); "
                "levers: phase 8 (each lever's median step against the "
                "plain step, its worst distance from kernels='off', the "
                "pixel draws' cost); band: phase 9 (sphere_hi_3000); "
                "occupancy: phase 10d (the occupancy step, 1 + 1 launches, "
                "against the plain step; the --occ_train CLI runs, whose "
                "launches count here); launches include phase 11's "
                "(sharded steps, the one-rank NCCL world's); "
                "max_abs_err is the largest per-leaf error "
                "relative to the leaf's largest gradient; the bound counts "
                "the least work (wgrad of 12 layers + dgrad of 11), not the "
                "forward recompute; no single PyTorch call computes this "
                "function, so library_ms is null",
    }, {
        "name": "fused_nerf_apply_int8", "route": "cuda",
        "source": "cvnerf_torch/csrc/fused_mlp_int8.cu",
        "replaces": "cvnerf_tpu/ops/pallas/fused_mlp_int8.py:268",
        "launches": (int8_counts["int8"] + cli["counts"]["int8"]
                     + occ_serve["counts"]["int8"]
                     + shards["counts"]["int8"] + frame_counts["int8"]),
        "max_abs_err": max(r["max_abs_err"] for r in int8_rows),
        "ms": int8_rows[-1]["ms"], "plain_ms": int8_rows[-1]["plain_ms"],
        "bound_ms": int8_rows[-1]["bound_ms"],
        "bound_by": int8_rows[-1]["bound_by"],
        "library_ms": None,
        "shapes": int8_rows,
        "note": f"ms/plain_ms/bound_ms at the fine-pass chunk (n={CHUNK * 192}"
                "), real head scales; launches include phase 10c's "
                "(--int8 --occupancy merge frames), phase 11a's (a "
                "sharded int8 frame) and phase 13a's program frames; the "
                "bound counts "
                "1,186,816 int8 "
                "operations a point at 1,979 TOPS; no single PyTorch call "
                "computes this function, so library_ms is null; yardstick "
                "int8_gemm_chain_ms (the products unfused through "
                f"torch._int_mm) {int8_rows[-1]['int8_gemm_chain_ms']:.4f}",
    }]}
    fold = draw_rows[0]
    walk = draw_rows[1]
    hash_stats = dict(he.stats)
    scan_note = {"blocks": blocks, "timing": block_timing,
                 "cli_spc": {k: v for k, v in cli_spc.items()
                             if k != "counts"},
                 "nccl_blocks": dist_cli["nccl_blocks"]}
    report["kernels"] += [{
        "name": "threefry_bits", "route": "cuda",
        "source": "cvnerf_torch/csrc/threefry.cu",
        "replaces": "cvnerf_tpu/ops/rng.py:36",
        "launches": tf.threefry_bits.launches, "max_abs_err": 0.0,
        "ms": fold["ms"], "plain_ms": fold["plain_ms"],
        "bound_ms": fold["bound_ms"], "bound_by": fold["bound_by"],
        "library_ms": None, "shapes": [fold],
        "scan": scan_note,
        "note": "no TPU kernel: the JAX package's threefry2x32 (rng.py:36, "
                "under jax.random's fold_in, split, bits and _ray_bits "
                "rng.py:71) is plain jnp; ms at the fine pass's sorted "
                "uniforms (1024 rays x 129 words); bitwise its plain "
                "version at every shape of phase 12a (max_abs_err 0); "
                "launches: every launch after phase 12a's comparisons, "
                "the eager steps' and each replayed step's (9 a lego "
                "step) and the renders' draws; the bound counts "
                f"{THREEFRY_OPS} 32-bit integer operations a counter pair "
                f"at {H100_INT_OPS:.3g}/s against the int64 words written; "
                "no single PyTorch call computes threefry, so library_ms "
                "is null; scan: phase 12's blocks (12b), their timing "
                "against eager steps (12c, ms a step, the profiler's idle "
                "share, capture seconds, pool bytes) and the CLI at "
                "--steps_per_call 1 against 10 (12d)",
    }, {
        "name": "feistel_draw", "route": "cuda",
        "source": "cvnerf_torch/csrc/threefry.cu",
        "replaces": "cvnerf_tpu/ops/rng.py:141",
        "launches": tf.feistel_draw.launches, "max_abs_err": 0.0,
        "ms": walk["ms"], "plain_ms": walk["plain_ms"],
        "bound_ms": walk["bound_ms"], "bound_by": walk["bound_by"],
        "library_ms": None, "shapes": draw_rows[1:],
        "note": "no TPU kernel: the JAX package's "
                "sample_without_replacement (rng.py:141) is plain jnp; ms "
                "at the lego step's draw (1024 of 400x400 pixels); bitwise "
                "its plain version at every (n, m) of phase 12a; launches: "
                "one a step after phase 12a's comparisons; the bound counts "
                f"{FEISTEL_OPS} integer operations an encryption, as many "
                "encryptions as this draw's cycle walks took (encryptions), "
                "against the int64 indices written; no single PyTorch call "
                "computes the draw, so library_ms is null",
    }, {
        "name": "fused_adam", "route": "cuda",
        "source": "cvnerf_torch/csrc/adam.cu", "replaces": None,
        "launches": fa.fused_adam.launches, "max_abs_err": 0.0,
        "ms": adam_row["ms"], "plain_ms": adam_row["plain_ms"],
        "bound_ms": adam_row["bound_ms"], "bound_by": "bytes",
        "library_ms": adam_row["library_ms"],
        "shapes": [adam_row, ngp["adam"]],
        "note": "no TPU kernel: the JAX package's optimizer is optax's adam "
                "in plain jnp; ms at the lego nets' 48 leaves (1,191,688 "
                "values), a launch of a CUDA graph of 200 (warm L2); "
                "bitwise its plain version at every case of phase 12e; "
                "launches: one a train step after phase 12e, its plain "
                "version never on the card; the bound counts 28 bytes a "
                "value at 3.35 TB/s; library_ms: the same update through "
                "torch._foreach_*; plain_ms: the plain version's 672 "
                "launches in a CUDA graph; shapes[1]: the NGP field's "
                "skip-zero and L2 rules (phase 14a), bitwise adam_plain, "
                "its bound the bytes of that run's gradients",
    }]
    fwd_rows = [r for r in ngp["rows"] if r["name"] == "hash_encode_fwd"]
    bwd_rows_ngp = [r for r in ngp["rows"] if r["name"] == "hash_encode_bwd"]

    def step_sum(rs, key):
        return sum(r[key] for r in rs if r["dtype"] == "bfloat16"
                   or r["name"] == "hash_encode_bwd")
    for name, rs, launches in (
            ("hash_encode_fwd", fwd_rows, hash_stats["fwd_launches"]),
            ("hash_encode_bwd", bwd_rows_ngp, hash_stats["bwd_launches"])):
        report["kernels"].append({
            "name": name, "route": "cuda",
            "source": "cvnerf_torch/csrc/hash_encode.cu", "replaces": None,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": step_sum(rs, "ms"), "plain_ms": step_sum(rs, "plain_ms"),
            "bound_ms": step_sum(rs, "bound_ms"), "bound_by": "bytes",
            "library_ms": None, "shapes": rs, "ptxas": ngp["ptxas"][name],
            "train": ngp_train if name == "hash_encode_fwd" else None,
            "note": "no TPU kernel: the JAX package has no hash grid; "
                    "ms/plain_ms/bound_ms a train step (the coarse and "
                    "fine encodings, NGP_LAUNCHES samples; the forward's "
                    "bfloat16 features, as the bf16 step reads them; the "
                    "backward with its buffer's zeroing), phase 14a; "
                    "launches: phase 14b's NGP steps (2 a step, as they "
                    "ran), the plain version never; no single PyTorch "
                    "call computes it, so library_ms is null"})
    if not (tf.threefry_bits.launches and tf.feistel_draw.launches):
        fail("the draw kernels did not launch on the main path")
    if not fa.fused_adam.launches or fa.adam_plain.calls:
        fail("Adam did not run through its kernel on the main path")
    if not hash_stats["fwd_launches"] or hash_stats["plain_calls"]:
        fail("the hash kernels did not run on the main path")
    mlp_rows = ngp_mlp_row["rows"]
    for name, launches in (("ngp_mlp_fwd", ngp_train["counts"]["mlp_fwd"]),
                           ("ngp_mlp_bwd", ngp_train["counts"]["mlp_bwd"])):
        rs = [r for r in mlp_rows if r["name"] == name]
        report["kernels"].append({
            "name": name, "route": "cuda",
            "source": "cvnerf_torch/csrc/ngp_mlp.cu", "replaces": None,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": rs[-1]["bound_by"], "library_ms": None,
            "shapes": rs,
            "ptxas": ngp_mlp_row["ptxas"][name]
            + (ngp_mlp_row["ptxas"]["ngp_mlp_wgrad_reduce"]
               if name == "ngp_mlp_bwd" else []),
            "note": "no TPU kernel: the JAX package has no hash grid; "
                    "ms/plain_ms/bound_ms a train step (the coarse and "
                    "fine passes, NGP_LAUNCHES samples; the backward with "
                    "ngp_mlp_wgrad_reduce), phase 14a; max_abs_err: the "
                    "forward's largest distance from the bf16 plain "
                    "version, the backward's largest per-leaf share of "
                    "the plain gradient's largest; launches: phase 14b's "
                    "NGP steps (2 a step, as they ran), the plain version "
                    "never; no single PyTorch call computes it, so "
                    "library_ms is null"})
    print(json.dumps(report), flush=True)
    print(f"card: {card}", flush=True)
    print('kernels: ["fused_nerf_apply", "fused_nerf_bwd", '
          '"fused_nerf_apply_int8", "threefry_bits", "feistel_draw", '
          '"fused_adam", "hash_encode_fwd", "hash_encode_bwd", '
          '"ngp_mlp_fwd", "ngp_mlp_bwd"]', flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
