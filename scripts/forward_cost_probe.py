"""Where the bf16 forward kernel's time goes: time variants of
``cvnerf_torch/csrc/fused_mlp.cu`` with one cost taken out each, on one
NVIDIA card, at the serving chunks (lego net, seeded random weights).

    python3 scripts/forward_cost_probe.py

Each variant is the kernel's sources with one text substitution (the
script fails if they no longer hold the text it replaces), built with the
port's nvcc flags into ``build/forward_cost_probe/<variant>/`` and called
through the C entry point. Their outputs are wrong on purpose; only their times mean
something:
  base         the kernel as it is;
  no_tma       the producer completes each weight stage without loading it
               (no L2 traffic: the weights the products read are stale);
  no_encode    no frequency encoding (the encoding buffers keep whatever
               they held);
  no_epilogue  no bias, ReLU or bf16 cast between layers (the accumulator
               bits are the next layer's A fragment).
Prints the card's name and power limit, then the median of 5 launches
(CUDA events) per variant and chunk, in three rounds of turns.
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

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params  # noqa: E402
from cvnerf_torch.ops import fused_mlp as fm  # noqa: E402
from cvnerf_torch.ops.rng import PRNGKey  # noqa: E402
from cvnerf_torch.utils import kernels  # noqa: E402

CSRC = ROOT / "cvnerf_torch" / "csrc"
OUT = ROOT / "build" / "forward_cost_probe"


def variants() -> dict[str, dict[str, str]]:
    """Per variant, the sources that differ from csrc/: file name -> text."""
    src = (CSRC / "fused_mlp.cu").read_text()
    head = (CSRC / "nerf_wgmma.cuh").read_text()

    def sub(s: str, old: str, new: str) -> str:
        if old not in s:
            raise SystemExit(f"the kernel's sources no longer hold:\n{old}")
        return s.replace(old, new)

    v = {"base": {}}
    v["no_tma"] = {"fused_mlp.cu": sub(src, """            ring_load(ring, &maps.m[m], k0, (uint32_t)wgmma_rows(N) * KCHUNK * 2);""",
                                       """            {
              mbar_wait(ring.empty_bar(ring.stage), ring.phase ^ 1);
              mbar_arrive(ring.full_bar());
              ring.advance();
            }""")}
    v["no_encode"] = {"fused_mlp.cu": sub(src, "    encode_wg(pts, dirs, p0, n, d, KX, KD, ex, pl.ldx, "
                                               "ed, pl.ldd, raw, 1 + wg, tid);", "")}
    e = sub(head, """      const float2 b0 = __ldg(reinterpret_cast<const float2*>(bias + c * 16 + 2 * q));
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(bias + c * 16 + 8 + 2 * q));""",
            "      const float2 b0 = make_float2(0.f, 0.f), b1 = b0;")
    v["no_epilogue"] = {"nerf_wgmma.cuh": sub(e, """      for (int i = 0; i < 4; ++i) a[c][i] = pack_bf16(v[2 * i], v[2 * i + 1]);""",
                                              """      for (int i = 0; i < 4; ++i) a[c][i] = __float_as_uint(acc[8 * c + 2 * i]);""")}
    return v


def build(name: str, files: dict[str, str]) -> Path:
    """The kernel with `files` in place of csrc/'s, in a directory of its own."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    for f in list(CSRC.glob("*.cuh")) + [CSRC / "fused_mlp.cu"]:
        (out / f.name).write_text(files.get(f.name, f.read_text()))
    so = out / "fused_mlp.so"
    res = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(out / "fused_mlp.cu")],
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
    fns = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        fm._bind_forward(lib)
        fns[name] = lib.cvnerf_fused_nerf_forward
    gen = torch.Generator().manual_seed(1)
    for n in (8192 * 192, 8192 * 64):
        pts = (torch.randn(n, 3, generator=gen) * 2).cuda()
        dirs = torch.nn.functional.normalize(
            torch.randn(n, 3, generator=gen), dim=-1).cuda()
        out = torch.empty(n, 4, device="cuda")
        times = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                def launch():
                    err = fn(pts.data_ptr(), dirs.data_ptr(), w.wmat.data_ptr(),
                             w.wvec.data_ptr(), out.data_ptr(), n,
                             cfg.trunk_width, cfg.head_width, cfg.xyz_freqs,
                             cfg.dir_freqs, 1,
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
        for name, t in times.items():
            print(f"n={n} {name}: median {float(np.median(t)):.4f} ms over "
                  f"{len(t)} launches", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
