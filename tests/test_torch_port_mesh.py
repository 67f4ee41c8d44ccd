"""The port's mesh extraction (``cvnerf_torch/render/mesh.py``) against the
JAX package's ``render/mesh.py``.

The marching tetrahedra, the case table, the largest-component filter and
the OBJ writer are numpy code, so they are held bitwise against the JAX
module on the same numpy grids (a sphere, an empty, a full, an anisotropic
one). The density grid goes through the forward kernel's plain version on
the CPU against JAX's jitted query (1e-5: the same lattice bitwise, the
MLP's fp32 sums in another order), and the whole extraction through
``NerfRenderer.extract_mesh`` and ``python -m cvnerf_torch.render.mesh``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.models.nerf_mlp import init_nerf_params as jax_init
from cvnerf_tpu.render import mesh as jmesh
from cvnerf_tpu.utils.convert import torch_state_dict_from_params
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops import fused_mlp as fm
from cvnerf_torch.render import mesh as tmesh
from cvnerf_torch.utils.convert import params_from_jax

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)


def _grids():
    ax = np.linspace(-1.5, 1.5, 23, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sphere = 1.0 - np.sqrt(x * x + y * y + z * z)
    rng = np.random.RandomState(0)
    aniso = rng.randn(9, 14, 6).astype(np.float32)
    return {"sphere": (sphere, 0.0, (-1.5,) * 3, (ax[1] - ax[0],) * 3),
            "empty": (np.zeros((5, 5, 5), np.float32), 0.5, (0, 0, 0),
                      (1, 1, 1)),
            "full": (np.ones((5, 5, 5), np.float32), 0.5, (0, 0, 0),
                     (1, 1, 1)),
            "anisotropic": (aniso, 0.1, (-1.0, 0.5, 2.0), (0.1, 0.3, 0.05))}


@pytest.mark.parametrize("name", list(_grids()))
def test_marching_tetrahedra_is_the_jax_modules_bitwise(name):
    grid, iso, origin, spacing = _grids()[name]
    want = jmesh.marching_tetrahedra(grid, iso, origin=origin,
                                     spacing=spacing)
    for slab in (8, 3):
        got = tmesh.marching_tetrahedra(grid, iso, origin=origin,
                                        spacing=spacing, slab=slab)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert (len(want[1]) > 0) == (name in ("sphere", "anisotropic"))
    np.testing.assert_array_equal(tmesh._TET_CASES, jmesh._TET_CASES)
    kept = tmesh.largest_component(*got)
    for g, w in zip(kept, jmesh.largest_component(*want)):
        np.testing.assert_array_equal(g, w)


def test_save_obj_bytes_equal_the_jax_writer(tmp_path):
    """The OBJ bytes are the JAX writer's, apart from the package named in
    the comment line (the port's sources never name the JAX package)."""
    grid, iso, origin, spacing = _grids()["anisotropic"]
    verts, faces = tmesh.marching_tetrahedra(grid, iso, origin=origin,
                                             spacing=spacing)
    tmesh.save_obj(str(tmp_path / "a.obj"), verts, faces)
    jmesh.save_obj(str(tmp_path / "b.obj"), verts, faces)
    with open(tmp_path / "a.obj", "rb") as a, open(tmp_path / "b.obj",
                                                   "rb") as b:
        ours, theirs = a.read(), b.read()
    assert ours == theirs.replace(b"# cvnerf_tpu mesh:",
                                  b"# cvnerf_torch mesh:", 1)
    assert ours.startswith(b"# cvnerf_torch mesh: ") and len(faces) > 0


def _jax_params(alpha_bias=0.0, seed=0):
    p = {"coarse": jax_init(jax.random.PRNGKey(seed), JaxCfg(**TINY)),
         "fine": jax_init(jax.random.PRNGKey(seed + 1), JaxCfg(**TINY))}
    for net in p.values():
        net["alpha"]["b"] = net["alpha"]["b"] + alpha_bias
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("res", [7, (5, 9, 6)])
def test_query_density_grid_matches_jax(res):
    """Raw (pre-ReLU) sigma on the lattice, through the forward kernel's
    plain version (``ceil(n / chunk)`` calls) and through ``apply_nerf``
    (``kernels="off"``)."""
    p = _jax_params(alpha_bias=-0.05)
    lo, hi = (-1.2, -0.7, -1.0), (0.9, 1.3, 1.0)
    want = jmesh.query_density_grid(p["fine"], JaxCfg(**TINY), lo, hi, res,
                                    chunk=64)
    tp = params_from_jax(p)["fine"]
    for kernels in ("on", "off"):
        calls = fm.fused_nerf_plain.calls
        got = tmesh.query_density_grid(tp, NerfMLPConfig(**TINY), lo, hi, res,
                                       chunk=50, kernels=kernels)
        assert got.shape == want.shape and got.dtype == np.float32
        n = want.size
        assert fm.fused_nerf_plain.calls - calls == (
            -(-n // 50) if kernels == "on" else 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (want < 0).any() and (want > 0).any()


def _write_run(run, params, ndc=False, n_fine=8):
    os.makedirs(os.path.join(run, "torch_checkpoints"), exist_ok=True)
    scene = {"height": 8, "width": 8, "focal": 9.0, "near": 2.0, "far": 6.0,
             "ndc": ndc, "ndc_variant": "canonical", "white_bkg": True,
             "n_coarse": 8, "n_fine": n_fine, "bf16": False,
             "sorted_resample": True, "pallas": "auto", "mlp": TINY}
    with open(os.path.join(run, "scene.json"), "w") as fp:
        json.dump(scene, fp)
    torch.save({"coarse": torch_state_dict_from_params(params["coarse"]),
                "fine": torch_state_dict_from_params(params["fine"]),
                "step": 5},
               os.path.join(run, "torch_checkpoints", "000005.pt"))


@pytest.mark.parametrize("ndc,n_fine,keep", [(False, 8, "all"),
                                             (True, 8, "largest"),
                                             (False, 0, "all")])
def test_extract_mesh_matches_jax_and_the_cli_writes_it(tmp_path, capsys,
                                                        ndc, n_fine, keep):
    """``NerfRenderer.extract_mesh`` (the NDC box for an NDC run, the coarse
    net when ``n_fine == 0``) against JAX ``extract_mesh`` of the same
    weights, and ``python -m cvnerf_torch.render.mesh`` writing the OBJ.
    The isovalue sits inside the field's range and no lattice value lies
    within 1e-4 of it, so both fields cross the same edges (faces
    bitwise); a vertex moves along its edge by the spacing times the
    field's error over the edge's value step, so the vertices agree to
    1e-4."""
    from cvnerf_torch.serve import NerfRenderer
    p = _jax_params(alpha_bias=0.05)
    run = str(tmp_path / "run")
    _write_run(run, p, ndc=ndc, n_fine=n_fine)
    net = "fine" if n_fine else "coarse"
    bb = ((-1.0, -1.0, 0.0), (1.0, 1.0, 1.0)) if ndc else \
        ((-1.3,) * 3, (1.3,) * 3)
    field = jmesh.query_density_grid(p[net], JaxCfg(**TINY), *bb, 12)
    iso = float(np.median(field))
    iso += 0.02 * (1 if (np.abs(field - iso) < 1e-4).any() else 0)
    want = jmesh.extract_mesh(p, JaxCfg(**TINY), net=net, bbox_min=bb[0],
                              bbox_max=bb[1], resolution=12, iso=iso,
                              keep=keep)
    r = NerfRenderer.from_run_dir(run, device="cpu")
    timings = {}
    got = r.extract_mesh(resolution=12, iso=iso, bound=1.3, keep=keep,
                         timings=timings)
    assert set(timings) == {"query_s", "march_s"}
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert len(want[1]) > 0
    out = str(tmp_path / "m.obj")
    assert tmesh.main(["--run", run, "--device", "cpu", "--res", "12",
                       "--iso", str(iso), "--bound", "1.3", "--keep", keep,
                       "--out", out]) == 0
    printed = capsys.readouterr().out
    assert f"wrote {out}: {len(want[0])} verts, {len(want[1])} faces" \
        in printed
    with open(out) as fp:
        lines = fp.read().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == len(want[0])
    assert sum(ln.startswith("f ") for ln in lines) == len(want[1])


def test_extract_mesh_validates_its_arguments():
    tp = params_from_jax(_jax_params())
    with pytest.raises(KeyError, match="no 'middle' network"):
        tmesh.extract_mesh(tp, NerfMLPConfig(**TINY), net="middle")
    with pytest.raises(ValueError, match="keep must be"):
        tmesh.extract_mesh(tp, NerfMLPConfig(**TINY), keep="some")
    with pytest.raises(ValueError, match="bad grid spec"):
        tmesh.query_density_grid(tp["fine"], NerfMLPConfig(**TINY),
                                 (0, 0, 0), (1, 1, 1), 1)
