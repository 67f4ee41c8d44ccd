"""Where the bf16 backward's pass 1 (``fused_nerf_bwd_wgmma``) spends its
time: time variants of ``cvnerf_torch/csrc/fused_mlp_bwd.cu`` with one cost
taken out each, on one NVIDIA card, at a train step's fine pass (1024 rays
x 192 = 196,608 points) and coarse pass (x 64 = 65,536), the lego net with
seeded random weights.

    python3 scripts/backward_cost_probe.py

Each variant is the source with text substitutions (the script fails if
the source no longer holds a text it replaces), built with the port's nvcc
flags into ``build/backward_cost_probe/<variant>/`` and called through the C entry
point. Their gradients are wrong on purpose; only their times mean
something:
  base         the kernel as it is;
  no_stash     pass 1 stores nothing to the stash (the weight-gradient
               pass reads whatever the workspace holds);
  no_colsums   no column sums (bias, wa and w11 gradients): no shuffle tree
               and no slab update;
  no_tma       the producer completes each weight stage without loading it;
  no_encode    no frequency encoding;
  stash_4b     (an alternative, gradients right) the stash stores as 4-byte
               stores of the fragments as they lie (8 rows x 16 B a warp
               instruction, write-back caching), without the quad transpose.
Prints the card's name and power limit, then per variant and shape the
median of 5 launches of the whole backward (CUDA events) and pass 1's
device time from ``torch.profiler`` (3 launches), in two rounds of turns.
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
OUT = ROOT / "build" / "backward_cost_probe"


def variants() -> dict[str, str]:
    src = (CSRC / "fused_mlp_bwd.cu").read_text()

    def sub(s: str, old: str, new: str) -> str:
        if old not in s:
            raise SystemExit(f"fused_mlp_bwd.cu no longer holds:\n{old}")
        return s.replace(old, new)

    v = {"base": src}
    s = sub(src, """  __nv_bfloat16* out = dst + (long)(p0 + warp * 16 + lane / 4 + 8 * (q & 1)) * N + 8 * (q >> 1);""",
            """  __nv_bfloat16* out = dst + (long)(p0 + warp * 16 + lane / 4 + 8 * (q & 1)) * N + 8 * (q >> 1);
  return;""")
    v["no_stash"] = sub(s, """  const int vw = width / 8;
  for (int i = threadIdx.x % WG; i < WG_ROWS * vw; i += WG) {""",
                        """  const int vw = width / 8;
  return;
  for (int i = threadIdx.x % WG; i < WG_ROWS * vw; i += WG) {""")
    v["no_colsums"] = sub(src, """  const float old = col < N ? dst[col] : 0.f;
  float s[8];""", """  return;
  const float old = col < N ? dst[col] : 0.f;
  float s[8];""")
    v["no_tma"] = sub(src, """            ring_load(ring, &maps.fwd[m], k0, (uint32_t)wgmma_rows(N) * KCHUNK * 2);""",
                      """            {
              mbar_wait(ring.empty_bar(ring.stage), ring.phase ^ 1);
              mbar_arrive(ring.full_bar());
              ring.advance();
            }""")
    v["no_tma"] = sub(v["no_tma"], """            ring_load(ring, &maps.dg[j], k0, dg_bytes);""",
                      """          {
            mbar_wait(ring.empty_bar(ring.stage), ring.phase ^ 1);
            mbar_arrive(ring.full_bar());
            ring.advance();
          }""")
    v["no_encode"] = sub(src, "    encode_wg(pts, dirs, p0, n, d, KX, KD, ex, ldx, ed(), ldd, "
                              "raw, 1 + wg, opaque(tid));", "")
    v["stash_4b"] = sub(src, """      uint32_t r0 = a[c][0], r1 = a[c][1], r2 = a[c][2], r3 = a[c][3];""",
                        """      {
        uint32_t* w0 = reinterpret_cast<uint32_t*>(
            dst + (long)(p0 + warp * 16 + lane / 4) * N + 16 * c + 2 * q);
        w0[0] = a[c][0];
        w0[4 * N] = a[c][1];
        w0[4] = a[c][2];
        w0[4 * N + 4] = a[c][3];
        continue;
      }
      uint32_t r0 = a[c][0], r1 = a[c][1], r2 = a[c][2], r3 = a[c][3];""")
    return v


def build(name: str, src: str) -> Path:
    """The variant's source beside csrc/'s headers, in a directory of its own."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        (out / h.name).write_text(h.read_text())
    cu, so = out / "fused_mlp_bwd.cu", out / "fused_mlp_bwd.so"
    cu.write_text(src)
    res = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{res.stderr[-3000:]}")
    return so


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    with ThreadPoolExecutor() as pool:
        libs = dict(zip(variants(), pool.map(lambda kv: build(*kv),
                                             variants().items())))
    cfg = NerfMLPConfig()
    params = init_nerf_params(PRNGKey(0), cfg, "cuda")
    w = fm.FusedNerfWeights(params, cfg, torch.bfloat16)
    wt = fb.in_out_matrices(w)
    size = fm.packed_size(cfg)
    fns = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        fb._bind_backward(lib)
        fns[name] = lib
    gen = torch.Generator().manual_seed(1)
    dims = (cfg.trunk_width, cfg.head_width, cfg.xyz_freqs, cfg.dir_freqs)
    for n in (1024 * 192, 1024 * 64):
        pts = (torch.randn(n, 3, generator=gen) * 2).cuda()
        dirs = torch.nn.functional.normalize(
            torch.randn(n, 3, generator=gen), dim=-1).cuda()
        g = (torch.randn(n, 4, generator=gen) * 1e-3).cuda()
        out = torch.empty(size, device="cuda")
        nbytes = fns["base"].cvnerf_fused_nerf_bwd_workspace(n, *dims, 1)
        ws = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
        times = {name: [] for name in fns}
        pass1 = {name: [] for name in fns}
        for _ in range(2):
            for name, lib in fns.items():
                def launch():
                    err = lib.cvnerf_fused_nerf_backward(
                        pts.data_ptr(), dirs.data_ptr(), g.data_ptr(),
                        w.wmat.data_ptr(), wt.data_ptr(), w.wvec.data_ptr(),
                        ws.data_ptr(), nbytes, out.data_ptr(), n, *dims, 1,
                        torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise SystemExit(f"{name}: CUDA error {err}")
                launch()
                torch.cuda.synchronize()
                for _ in range(5):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    launch()
                    end.record()
                    torch.cuda.synchronize()
                    times[name].append(start.elapsed_time(end))
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        launch()
                    torch.cuda.synchronize()
                pass1[name].append(sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if "fused_nerf_bwd_wgmma" in e.key) / 3 / 1e3)
        for name in fns:
            print(f"n={n} {name}: backward median {float(np.median(times[name])):.4f}"
                  f" ms over {len(times[name])} launches; pass 1 "
                  f"{', '.join(f'{t:.4f}' for t in pass1[name])} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
