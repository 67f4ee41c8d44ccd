"""Where the int8 forward kernel's time goes: time variants of
``cvnerf_torch/csrc/fused_mlp_int8.cu`` with one cost taken out (or one
arithmetic choice changed) each, on one NVIDIA card, at the serving chunks
(lego net quantized on the card, seeded random weights).

    python3 scripts/int8_cost_probe.py

Each variant is the kernel source with one text substitution (the script
fails if the source no longer holds the text it replaces), built with the
port's nvcc flags into ``build/int8_cost_probe/`` and called through the C
entry point. Outputs of the cost-removing variants are wrong on purpose;
only their times mean something:
  base          the kernel as it is;
  no_tma        the producer completes each weight stage without loading it
                (no L2 traffic: the weights the products read are stale);
  no_encode     no frequency encoding (the int8 encoding buffers keep
                whatever they held);
  no_requant    no dequantize / round / clamp between layers (the low byte
                of each accumulator is packed as it is);
  magic_i2f     the int32 -> fp32 cast of the requant by adding 1.5 x 2^23
                to the bits and subtracting it in fp32 instead of
                __int2float_rn (exact only for |acc| < 2^22);
  alu_clamps    the ReLU layers' requant clamped by fminf/fmaxf (the ALU
                pipe) as the feature layer's is, not by round_relu's
                saturating multiply;
  no_pingpong   the two consumer warpgroups issue their products as soon as
                their stages have landed, not in turns;
  generic_smem  the shared-memory base aligned through an integer cast, so
                the compiler addresses the encodings, scales and head
                weights as generic 64-bit pointers (LD/ST, not LDS/STS).
Prints each variant's ptxas registers and spills, the card's name and
power limit, then the median of 5 launches (CUDA events) per variant and
chunk, in three rounds of turns.
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
from cvnerf_torch.ops import fused_mlp_int8 as fq  # noqa: E402
from cvnerf_torch.ops import quantize as tq  # noqa: E402
from cvnerf_torch.ops import rng  # noqa: E402
from cvnerf_torch.utils import kernels  # noqa: E402

CSRC = ROOT / "cvnerf_torch" / "csrc"
OUT = ROOT / "build" / "int8_cost_probe"


def variants() -> dict[str, str]:
    src = (CSRC / "fused_mlp_int8.cu").read_text()

    def sub(s: str, old: str, new: str) -> str:
        if old not in s:
            raise SystemExit(f"fused_mlp_int8.cu no longer holds:\n{old}")
        return s.replace(old, new)

    v = {"base": src}
    v["no_tma"] = sub(src, """            ring_load(ring, &maps.m[m], k0, (uint32_t)wgmma_rows(N) * KCHUNK);""",
                      """            {
              mbar_wait(ring.empty_bar(ring.stage), ring.phase ^ 1);
              mbar_arrive(ring.full_bar());
              ring.advance();
            }""")
    v["no_encode"] = sub(src, "    encode_staged(pts, dirs, p0, n, d, raw, 1 + wg, tid, emit);", "")
    dequant = "  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);"
    v["no_requant"] = sub(src, """  if (lo == 0.f) {
    const uint32_t x =""", """  return pack4(a0, a1, a2, a3);
  if (lo == 0.f) {
    const uint32_t x =""")
    v["magic_i2f"] = sub(src, dequant, """  const float x = __fsub_rn(__int_as_float(acc + 0x4B400000), ROUND_MAGIC);
  return __fadd_rn(__fmul_rn(x, s), b);""")
    v["alu_clamps"] = sub(src, "  if (lo == 0.f) {", "  if (false) {")
    v["no_pingpong"] = sub(sub(src, "named_sync(TURN + wg, CONSUMERS * WG);", ""),
                           "named_arrive(TURN + 1 - wg, CONSUMERS * WG);", "")
    v["generic_smem"] = sub(src, """  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);""",
                            """  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));""")
    return v


def build(name: str, src: str) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        (OUT / h.name).write_text(h.read_text())
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    res = subprocess.run([kernels.nvcc(), "-Xptxas=-v", *kernels.NVCC_FLAGS, "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{res.stderr[-3000:]}")
    kernels.ptxas_log(so).write_text(res.stderr)
    return so


def ptxas_summary(so: Path) -> str:
    """Registers and spills of each instantiation, from the build's report."""
    import re
    out, name = [], None
    for line in kernels.ptxas_log(so).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = "fixed" if "ILi256E" in m.group(1) else "run-time"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.append(f"{name}: spill {m.group(1)}/{m.group(2)} B")
    return ", ".join(out)


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
    for name, so in libs.items():
        print(f"ptxas {name}: {ptxas_summary(so)}", flush=True)
    cfg = NerfMLPConfig()
    params = init_nerf_params(rng.PRNGKey(0), cfg, "cuda")
    cpts, cdirs = tq.calibration_samples(rng.PRNGKey(6), 1 << 17,
                                         (-6.0,) * 3, (6.0,) * 3, "cuda")
    w = fq.QuantizedNerfWeights(tq.quantize_nerf(params, cfg, cpts, cdirs),
                                cfg)
    fns = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        fq._bind(lib)
        fns[name] = lib.cvnerf_fused_nerf_int8_forward
    gen = torch.Generator().manual_seed(1)
    for n in (8192 * 192, 8192 * 64):
        pts = (torch.randn(n, 3, generator=gen) * 2).cuda()
        dirs = torch.nn.functional.normalize(
            torch.randn(n, 3, generator=gen), dim=-1).cuda()
        out = torch.empty(n, 4, device="cuda")
        want = fq.fused_nerf_apply_int8(w, pts, dirs)
        times = {name: [] for name in fns}
        exact = {}
        for _ in range(3):
            for name, fn in fns.items():
                def launch():
                    err = fn(pts.data_ptr(), dirs.data_ptr(), w.qmat.data_ptr(),
                             w.qvec.data_ptr(), out.data_ptr(), n,
                             cfg.trunk_width, cfg.head_width, cfg.xyz_freqs,
                             cfg.dir_freqs,
                             torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise SystemExit(f"{name}: CUDA error {err}")
                launch()
                torch.cuda.synchronize()
                exact[name] = torch.equal(out, want)
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
                  f"{len(t)} launches (output equal to the kernel's: "
                  f"{exact[name]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
