"""What the benchmark runs loads neither JAX nor the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cvnerf_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = loaded_after(
        "import sys; sys.path.insert(0, '.')\n"
        "from nerfbench import harness, control, sweep, run\n"
        "from nerfbench.families import nerf\n"
        "import cvnerf_torch.server, cvnerf_torch.train.loop\n"
        "b = harness.load_benchmark()\n"
        "from nerfbench.trace import Trace\n"
        "t = Trace([], [], (0, 1))\n"
        "for m in b['per_layer']:\n"
        "    harness.read_metric(m['name'], t, {'steps': 0, 'frame_spans':"
        " [], 'cfg': {}, 'peak': 1.0})\n")
    assert "cvnerf_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = loaded_after("import sys; sys.path.insert(0, '.')\n"
                         "import nerfbench.reference.nerf, "
                         "nerfbench.reference.rng")
    assert "cvnerf_torch" not in names
    assert not names & FORBIDDEN
    for f in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {"cvnerf_torch"}, \
                    (f.name, m)


def test_every_benchmark_module_names_no_jax():
    for f in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert not {m.split(".")[0] for m in mods} & FORBIDDEN, f
