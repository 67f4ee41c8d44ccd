"""Where the fp32 kernels (the fp32 forward ``fused_nerf_ffma`` and the fp32
backward's pass 1 ``fused_nerf_bwd_ffma``) spend their time: time variants
of ``cvnerf_torch/csrc/fused_mlp.cu`` and ``fused_mlp_bwd.cu``, and of their
shared block ``nerf_ffma.cuh``, with one cost taken out each, on one NVIDIA
card, at n = 65,573 and a train step's fine pass (1024 rays x 192 =
196,608 points), the lego net with seeded random weights.

    python3 scripts/fp32_cost_probe.py

Each variant is the sources with text substitutions (the script fails if a
source no longer holds a text it replaces), built with the port's nvcc
flags into ``build/fp32_cost_probe/<variant>/`` and called through the C
entry points. Their outputs are wrong on purpose; only their times mean
something:
  base         the kernels as they are;
  no_bulk      the producer completes each weight stage without copying it;
  no_encode    no frequency encoding;
  no_store     the epilogues write nothing to the shared activation buffer;
  no_barriers  the consumer warps never wait for each other (named
               barriers removed);
  no_stash     (pass 1) nothing is stored to the stash;
  no_colsums   (pass 1) no column sums (bias, wa and w11 gradients);
  no_masks     (pass 1) no ReLU mask bits kept or applied.
Prints the card's name and power limit, then per variant and shape the
median of 5 launches of the forward and of the whole backward (CUDA
events), and pass 1's device time from ``torch.profiler`` (3 launches), in
two rounds of turns.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params  # noqa: E402
from cvnerf_torch.ops import fused_mlp as fm  # noqa: E402
from cvnerf_torch.ops import fused_mlp_bwd as fb  # noqa: E402
from cvnerf_torch.ops.rng import PRNGKey  # noqa: E402
from cvnerf_torch.utils import kernels  # noqa: E402

CSRC = ROOT / "cvnerf_torch" / "csrc"
OUT = ROOT / "build" / "fp32_cost_probe"
SOURCES = ("fused_mlp.cu", "fused_mlp_bwd.cu")
BLOCK = "nerf_ffma.cuh"


def sub(files: dict, name: str, old: str, new: str) -> dict:
    if old not in files[name]:
        raise SystemExit(f"{name} no longer holds:\n{old}")
    return {**files, name: files[name].replace(old, new)}


def variants() -> dict[str, dict]:
    base = {name: (CSRC / name).read_text() for name in (*SOURCES, BLOCK)}
    v = {"base": base}
    v["no_bulk"] = sub(base, BLOCK, """  mbar_arrive_expect_tx(r.full_bar(), bytes);
  bulk_load(r.tile(), src, bytes, r.full_bar());""", """  mbar_arrive(r.full_bar());""")
    v["no_encode"] = sub(base, BLOCK, """  constexpr int PAIRS = TILE * 3;
  const int tid = threadIdx.x;""", """  constexpr int PAIRS = TILE * 3;
  const int tid = threadIdx.x;
  return;""")
    v["no_store"] = sub(base, BLOCK, """        float* row = buf + t.col(j) * TILE + 4 * (t.pg ^ (t.cg & 7));""",
                        """        if (j >= 0) return;
        float* row = buf + t.col(j) * TILE + 4 * (t.pg ^ (t.cg & 7));""")
    nb = base
    for name in (*SOURCES, BLOCK):
        nb = sub(nb, name, "named_sync(BAR, CONSUMER_THREADS);", "")
    v["no_barriers"] = nb
    v["no_stash"] = sub(sub(base, "fused_mlp_bwd.cu", """  const int vw = width / 4;
  for (int i = threadIdx.x; i < ffma::TILE * vw; i += ffma::CONSUMER_THREADS) {""",
                            """  const int vw = width / 4;
  return;
  for (int i = threadIdx.x; i < ffma::TILE * vw; i += ffma::CONSUMER_THREADS) {"""),
                        "fused_mlp_bwd.cu", """                                           const ffma::Thr& t) {
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc)
    if (ffma::chunk_in(jc, N, t))
#pragma unroll
      for (int i = 0; i < 8; ++i)
        __stcs(""", """                                           const ffma::Thr& t) {
  return;
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc)
    if (ffma::chunk_in(jc, N, t))
#pragma unroll
      for (int i = 0; i < 8; ++i)
        __stcs(""")
    v["no_colsums"] = sub(base, "fused_mlp_bwd.cu", """                                           const Val& val) {
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc) {
    const bool in = ffma::chunk_in(jc, N, t);""", """                                           const Val& val) {
  return;
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc) {
    const bool in = ffma::chunk_in(jc, N, t);""")
    v["no_masks"] = sub(sub(base, "fused_mlp_bwd.cu", """  uint32_t w[2] = {0u, 0u};""",
                            """  return;
  uint32_t w[2] = {0u, 0u};"""),
                        "fused_mlp_bwd.cu", """  const uint32_t w[2] = {msk[threadIdx.x], msk[ffma::CONSUMER_THREADS + threadIdx.x]};""",
                        """  return;
  const uint32_t w[2] = {msk[threadIdx.x], msk[ffma::CONSUMER_THREADS + threadIdx.x]};""")
    return v


def build(job: tuple[str, dict, str]) -> Path:
    """One source of a variant beside csrc/'s headers (the variant's block),
    in a directory of its own."""
    name, files, source = job
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        (out / h.name).write_text(files.get(h.name, h.read_text()))
    cu, so = out / source, out / source.replace(".cu", ".so")
    cu.write_text(files[source])
    res = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}/{source}:\n{res.stderr[-3000:]}")
    return so


def median_ms(launch, reps: int = 5) -> float:
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    jobs = [(name, files, src) for name, files in variants().items()
            for src in SOURCES]
    with ThreadPoolExecutor() as pool:
        built = list(pool.map(build, jobs))
    libs = {}
    for (name, _, src), so in zip(jobs, built):
        lib = ctypes.CDLL(str(so))
        (fm._bind_forward if src == "fused_mlp.cu" else fb._bind_backward)(lib)
        libs.setdefault(name, {})[src] = lib
    cfg = NerfMLPConfig()
    params = init_nerf_params(PRNGKey(0), cfg, "cuda")
    w = fm.FusedNerfWeights(params, cfg, torch.float32)
    wt = fb.out_in_matrices(w)
    size = fm.packed_size(cfg)
    gen = torch.Generator().manual_seed(1)
    dims = (cfg.trunk_width, cfg.head_width, cfg.xyz_freqs, cfg.dir_freqs)
    stream = torch.cuda.current_stream().cuda_stream
    for n in (2 ** 16 + 37, 1024 * 192):
        pts = (torch.randn(n, 3, generator=gen) * 2).cuda()
        dirs = torch.nn.functional.normalize(
            torch.randn(n, 3, generator=gen), dim=-1).cuda()
        g = (torch.randn(n, 4, generator=gen) * 1e-3).cuda()
        out, grads = torch.empty(n, 4, device="cuda"), torch.empty(size, device="cuda")
        nbytes = libs["base"]["fused_mlp_bwd.cu"].cvnerf_fused_nerf_bwd_workspace(n, *dims, 0)
        ws = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
        fwd = {name: [] for name in libs}
        bwd = {name: [] for name in libs}
        pass1 = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                def forward():
                    err = lib["fused_mlp.cu"].cvnerf_fused_nerf_forward(
                        pts.data_ptr(), dirs.data_ptr(), w.wmat.data_ptr(),
                        w.wvec.data_ptr(), out.data_ptr(), n, *dims, 0, stream)
                    if err != 0:
                        raise SystemExit(f"{name} forward: CUDA error {err}")

                def backward():
                    err = lib["fused_mlp_bwd.cu"].cvnerf_fused_nerf_backward(
                        pts.data_ptr(), dirs.data_ptr(), g.data_ptr(),
                        w.wmat.data_ptr(), wt.data_ptr(), w.wvec.data_ptr(),
                        ws.data_ptr(), nbytes, grads.data_ptr(), n, *dims, 0,
                        stream)
                    if err != 0:
                        raise SystemExit(f"{name} backward: CUDA error {err}")
                fwd[name].append(median_ms(forward))
                bwd[name].append(median_ms(backward))
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        backward()
                    torch.cuda.synchronize()
                pass1[name].append(sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if "fused_nerf_bwd_ffma" in e.key) / 3 / 1e3)
        for name in libs:
            print(f"n={n} {name}: forward {', '.join(f'{t:.4f}' for t in fwd[name])} ms;"
                  f" backward {', '.join(f'{t:.4f}' for t in bwd[name])} ms; pass 1 "
                  f"{', '.join(f'{t:.4f}' for t in pass1[name])} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
