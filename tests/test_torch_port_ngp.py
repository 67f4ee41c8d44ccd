"""The Instant-NGP field on the port's path, on the CPU with the kernels'
plain versions at tiny widths (4 levels, 2^8 entries a level, MLPs 16
wide), each part held against the plain reference ``tests/reference_ngp.py``
on seeded random weights: the grid's indices, the encoding forward and
backward, the SH basis, the field, one train step's loss, gradients and
Adam update, a checkpoint round trip, a served frame, the CLI, and the
benchmark's copy of the reference. Tolerances are stated beside each test
with their reason; "bitwise" where both sides do the same float32 ops in
the same order."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import reference_ngp as ref
from cvnerf_torch.models.ngp_field import (NgpFieldConfig, apply_ngp,
                                           empty_ngp_params, init_ngp_params,
                                           ngp_param_count, unit_positions)
from cvnerf_torch.ops import hash_encode as he
from cvnerf_torch.ops import ngp_mlp as nm
from cvnerf_torch.ops.adam import adam_plain
from cvnerf_torch.ops.encoding import sh_encode
from cvnerf_torch.ops.rng import PRNGKey, ray_sorted_uniform, ray_uniform
from cvnerf_torch.render.renderer import RenderConfig, render_rays
from cvnerf_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from cvnerf_torch.train.state import (AdamState, TrainState,
                                      create_train_state, make_optimizer,
                                      tree_leaves)

TINY = NgpFieldConfig(n_levels=4, log2_table=8, base_res=4, max_res=32,
                      hidden=16)
# The reference's configuration of the same field, and of a scene.
RCFG = {"n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 8,
        "base_resolution": 4, "max_resolution": 32, "n_neurons": 16,
        "n_hidden_layers": 1, "geo_feat_dim": 16, "rgb_n_hidden_layers": 2,
        "sh_degree": 4, "bound": 1.0, "lrate": 1e-2, "lrate_decay": 0,
        "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6,
        "N_samples": 8, "N_importance": 8, "white_bkgd": False,
        "H": 12, "W": 16, "focal": 14.0, "ndc": True, "near": 0.0,
        "far": 1.0}


def _params(seed=0, scale=0.5):
    """The tiny field from ``PRNGKey(seed)``, its table drawn wide enough
    (``U(±scale)``) that the encoding moves the output."""
    p = init_ngp_params(PRNGKey(seed), dataclasses.replace(
        TINY, init_scale=scale), "cpu")
    return p


def _rays(n=24, seed=1):
    g = torch.Generator().manual_seed(seed)
    o = (torch.rand(n, 3, generator=g) - 0.5) * 0.2
    o[:, 2] = -1.0
    d = torch.randn(n, 3, generator=g) * 0.2
    d[:, 2] = 2.0
    vd = torch.randn(n, 3, generator=g)
    return o, d, vd / torch.linalg.norm(vd, dim=-1, keepdim=True)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


# -- the grid -----------------------------------------------------------------
def test_published_grid_is_instant_ngps():
    """Levels 0-4 dense (res 16, 23, 31, 43, 59; entries rounded up to 8),
    5-15 hashed at 2^19: 12,196,240 table values, 9,408 MLP weights."""
    levels = NgpFieldConfig().levels
    assert [lv.res for lv in levels[:6]] == [16, 23, 31, 43, 59, 81]
    assert [lv.entries for lv in levels[:5]] == [4096, 12168, 29792, 79512,
                                                  205384]
    assert [lv.dense for lv in levels] == [True] * 5 + [False] * 11
    assert all(lv.entries == 1 << 19 for lv in levels[5:])
    assert ngp_param_count(NgpFieldConfig()) == (12_196_240, 9_408)
    want = ref.levels({**RCFG, "n_levels": 16, "log2_hashmap_size": 19,
                       "base_resolution": 16, "max_resolution": 2048})
    assert [(lv.scale, lv.res, lv.entries, lv.dense) for lv in levels] == [
        (w["scale"], w["res"], w["entries"], w["dense"]) for w in want]


@pytest.mark.parametrize("case", ["dense", "hash", "wrap", "modulo"])
def test_corner_indices_by_hand(case):
    """Indices of corners computed by hand: a dense level's ``x0 + x1 res +
    x2 res²``, the hash's uint32 products that wrap, and the modulo."""
    dense = he.GridLevel(15.0, 16, 4096, True, 0)
    hashed = he.GridLevel(80.0, 81, 1 << 19, False, 0)
    q, lv, want = {
        "dense": ([3, 5, 7], dense, 3 + 5 * 16 + 7 * 256),
        # 2 * 2654435761 = 5308871522 wraps to 1013904226.
        "hash": ([1, 2, 0], hashed, (1 ^ 1013904226) % (1 << 19)),
        "wrap": ([80, 80, 80], hashed,
                 (80 ^ (80 * 2654435761 % 2 ** 32)
                  ^ (80 * 805459861 % 2 ** 32)) % (1 << 19)),
        # A corner past the last row (res) wraps modulo the entries.
        "modulo": ([16, 16, 16], dense, (16 + 256 + 4096) % 4096),
    }[case]
    got = he.corner_index(lv, torch.tensor([q]))
    assert int(got) == want
    lvd = {"dense": lv.dense, "res": lv.res, "entries": lv.entries}
    assert int(ref.hash_index(lvd, [torch.tensor(v) for v in q])) == want


# -- the encoding -------------------------------------------------------------
def test_encoding_forward_is_the_references_bitwise():
    """The plain version against ``reference_ngp.encode``: the same float32
    ops in the same order, so bitwise (positions outside [0, 1] clamp)."""
    p = _params()
    tables = [p["field"]["table"][str(k)] for k in range(4)]
    unit = torch.rand(500, 3, generator=torch.Generator().manual_seed(2)) \
        * 1.2 - 0.1
    got = he.hash_encode_plain(unit, tables, TINY.levels)
    want = ref.encode(unit, tables, ref.levels(RCFG))
    assert torch.equal(_bits(got), _bits(want))


def test_encoding_backward_matches_reference_autograd():
    """The plain backward's ``index_add_`` against autograd's scatter of
    the reference: the sums' order differs, so within 1e-6 of the largest
    gradient."""
    p = _params()
    tables = [p["field"]["table"][str(k)].clone().requires_grad_()
              for k in range(4)]
    unit = torch.rand(500, 3, generator=torch.Generator().manual_seed(3))
    g = torch.randn(500, 8, generator=torch.Generator().manual_seed(4))
    flat = he.hash_encode_bwd_plain(unit, g, TINY.levels)
    (ref.encode(unit, tables, ref.levels(RCFG)) * g).sum().backward()
    for lv, t in zip(TINY.levels, tables):
        got = flat[lv.offset:lv.offset + lv.entries]
        scale = float(t.grad.abs().max())
        assert float((got - t.grad).abs().max()) <= 1e-6 * scale
    # Through the autograd function: the tables' gradients, views of one
    # buffer, and none for the positions.
    leaves = [t.detach().clone().requires_grad_() for t in tables]
    (he.hash_encode(unit, leaves, TINY.levels) * g).sum().backward()
    for lv, t in zip(TINY.levels, leaves):
        assert torch.equal(t.grad, flat[lv.offset:lv.offset + lv.entries])


def test_sh_is_the_closed_form():
    """Against the real SH with the Condon-Shortley phase from scipy's
    associated Legendre functions, in float64: within float32 rounding
    (2e-6); and against the reference's term-by-term formula, which sums
    in another order (1e-6)."""
    from scipy.special import lpmv
    d = torch.randn(200, 3, generator=torch.Generator().manual_seed(5))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    got = sh_encode(d).double().numpy()
    x, y, z = d.double().numpy().T
    theta, phi = np.arccos(np.clip(z, -1, 1)), np.arctan2(y, x)
    for l in range(4):
        for m in range(-l, l + 1):
            a = abs(m)
            k = math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - a)
                          / math.factorial(l + a))
            p = lpmv(a, l, np.cos(theta))
            want = k * p * (1.0 if m == 0 else math.sqrt(2.0)) * (
                np.cos(a * phi) if m >= 0 else np.sin(a * phi))
            assert np.abs(got[:, l * l + l + m] - want).max() < 2e-6
    assert torch.allclose(sh_encode(d), ref.sh(d), rtol=0, atol=1e-6)


# -- the field and a train step -----------------------------------------------
def test_field_matches_the_reference():
    """``apply_ngp`` in float32 against ``reference_ngp.field``: the same
    ops but the products (1e-5 of the output's scale)."""
    p = _params()
    o, d, vd = _rays()
    t = torch.rand(24, 8, generator=torch.Generator().manual_seed(6))
    pts = o[:, None] + d[:, None] * t[..., None]
    got = apply_ngp(p, pts, vd, TINY)
    want = ref.field(p, pts, vd, RCFG)
    assert got.shape == (24, 8, 4)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[..., 3] >= 0, torch.ones_like(got[..., 3],
                                                         dtype=torch.bool))


def _port_step(params, o, d, vd, target, key):
    cfg = RenderConfig(n_coarse=8, n_fine=8, mlp=TINY)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    tree = {"field": {k: {n: next(it) for n in v}
                      for k, v in params["field"].items()}}
    out = render_rays(tree, o, d, vd, 0.0, 1.0, cfg, key=key)
    target = target
    loss = torch.mean((out["rgb"] - target) ** 2) + torch.mean(
        (out["rgb_coarse"] - target) ** 2)
    return loss, torch.autograd.grad(loss, leaves)


def test_one_train_step_matches_the_reference():
    """The port's render, loss and gradients (one field for both passes,
    the draws of ``ops/rng`` handed to the reference) and its Adam update
    against the reference's: loss within 1e-5, every leaf's gradient within
    1e-4 of its norm, the new params within 1e-5 (Adam's ε 1e-15 makes an
    update ``lr · sign(g)`` where gradients are tiny, so the compare is on
    the values, and the touched set is the same)."""
    p = _params()
    o, d, vd = _rays()
    target = torch.rand(24, 3, generator=torch.Generator().manual_seed(7))
    key = PRNGKey(11)
    ids = torch.arange(24)
    draws = {"u_strat": ray_uniform(key, 1, ids, 8),
             "u_pdf": ray_sorted_uniform(key, 2, ids, 8)}
    loss, grads = _port_step(p, o, d, vd, target, key)
    state = ref.fresh_state(p)
    new, out = ref._step(state, o, d, vd, 0.0, 1.0, target, RCFG, ref.fp32,
                         draws)
    assert abs(float(loss.detach()) - float(out["loss"])) \
        <= 1e-5 * float(out["loss"])
    want = ref.leaves(out["grads"])
    l2 = make_optimizer(1e-2, 0, TINY).rules(p)[1]
    for g, w, x, f in zip(grads, want, tree_leaves(p), l2):
        g = g + f * x
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-12
    opt = make_optimizer(1e-2, 0, TINY)
    gtree = ref.rebuild(p, list(grads))
    newp, st = opt.update(gtree, opt.init(p), p,
                          torch.tensor(opt.scalars(0)))
    for a, b in zip(tree_leaves(newp), ref.leaves(new["params"])):
        assert torch.allclose(a, b, rtol=0, atol=1e-5)
    touched = [bool((g != 0).any()) for g in grads[:4]]
    assert all(touched)


@pytest.mark.parametrize("count", [0, 9])
def test_adam_skip_zero_and_l2_rule(count):
    """``Adam.update`` of the field runs ``adam_plain`` with the table's
    leaves under ``skip_zero`` and the MLP's under L2 (β₂ 0.99, ε 1e-15):
    bitwise the plain version and the reference's update; a table entry
    whose gradient is 0 keeps its value and moments."""
    p = _params(3)
    rng = torch.Generator().manual_seed(8 + count)
    leaves = tree_leaves(p)
    grads = [torch.randn(t.shape, generator=rng) * 1e-3
             * (torch.rand(t.shape, generator=rng) < 0.4) for t in leaves]
    mu = [torch.randn(t.shape, generator=rng) * 1e-4 for t in leaves]
    nu = [torch.rand(t.shape, generator=rng) * 1e-7 for t in leaves]
    opt = make_optimizer(1e-2, 0, TINY)
    assert (opt.b2, opt.eps, opt.l2) == (0.99, 1e-15, 1e-6)
    skip, l2 = opt.rules(p)
    assert skip == [True] * 4 + [False] * 5
    assert l2 == [0.0] * 4 + [1e-6] * 5
    scalars = torch.tensor(opt.scalars(count))
    st = AdamState(count=count, mu=ref.rebuild(p, mu), nu=ref.rebuild(p, nu))
    calls = adam_plain.calls
    before = dict(opt.stats)
    new, st2 = opt.update(ref.rebuild(p, grads), st, p, scalars)
    assert adam_plain.calls == calls + 1
    assert opt.stats["skip_zero_leaves"] - before["skip_zero_leaves"] == 4
    assert opt.stats["skip_zero_values"] - before["skip_zero_values"] == \
        sum(t.numel() for t in leaves[:4])
    want = adam_plain(leaves, grads, mu, nu, scalars, 0.9, 0.99, 1e-15,
                      skip, l2)
    for got, exp in zip((new, st2.mu, st2.nu), want):
        for a, b in zip(tree_leaves(got), exp):
            assert torch.equal(_bits(a), _bits(b))
    for k in range(4):
        zero = grads[k] == 0
        assert torch.equal(tree_leaves(new)[k][zero], leaves[k][zero])
        assert torch.equal(tree_leaves(st2.nu)[k][zero], nu[k][zero])
    r = ref.adam_update({"params": p, "mu": st.mu, "nu": st.nu,
                         "count": count}, grads, RCFG)
    for a, b in zip(tree_leaves(new), ref.leaves(r["params"])):
        assert torch.equal(_bits(a), _bits(b))


# -- checkpoint, serving and the CLI ------------------------------------------
def test_checkpoint_round_trip(tmp_path):
    """A field's state saved and restored bitwise into a fresh template;
    a template of other widths is refused."""
    st = create_train_state(PRNGKey(4), lr=1e-2, lr_decay=0, mlp=TINY,
                            device="cpu")
    st = TrainState(params=st.params, opt_state=AdamState(
        count=7, mu=st.params, nu=st.params), step=7)
    save_checkpoint(str(tmp_path), st)
    fresh = create_train_state(PRNGKey(5), lr=1e-2, lr_decay=0, mlp=TINY,
                               device="cpu")
    got = restore_checkpoint(str(tmp_path), fresh)
    assert (got.step, got.opt_state.count) == (7, 7)
    for a, b in zip(tree_leaves(got.params) + tree_leaves(got.opt_state.nu),
                    tree_leaves(st.params) * 2):
        assert torch.equal(a, b)
    other = create_train_state(PRNGKey(5), mlp=dataclasses.replace(
        TINY, hidden=8), device="cpu")
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), other)


def test_a_served_frame_is_the_references(tmp_path):
    """``NerfRenderer`` of a params-only NGP checkpoint renders a
    deterministic 12x16 NDC frame within 1e-4 of the reference's frame of
    the same pose (float32; the products' order differs)."""
    from cvnerf_torch.serve import NerfRenderer
    p = _params(6)
    path = str(tmp_path / "f.pt")
    torch.save({"model": "ngp", "params": p, "step": 3}, path)
    r = NerfRenderer(path, height=12, width=16, focal=14.0, near=0.0,
                     far=1.0, ndc=True, cfg=RenderConfig(n_coarse=8,
                                                         n_fine=8,
                                                         mlp=TINY),
                     chunk=64, device="cpu")
    assert r.step == 3
    c2w = np.array([[1, 0, 0, 0.05], [0, 1, 0, -0.02], [0, 0, 1, 0.1]],
                   np.float32)
    got = r.render_pose(c2w)
    want = ref.render_frame(p, RCFG, torch.from_numpy(c2w)).numpy()
    assert got.shape == (12, 16, 3)
    assert np.abs(got - want).max() < 1e-4
    for nerf_only in (r.enable_int8, r.enable_occupancy):
        with pytest.raises(ValueError):
            nerf_only()
    with pytest.raises(ValueError):
        NerfRenderer(path, height=12, width=16, focal=14.0, near=0.0,
                     far=1.0, cfg=RenderConfig(mlp=dataclasses.replace(
                         TINY, n_levels=3)), device="cpu")


def test_cli_trains_and_serves_an_ngp_field(tmp_path, monkeypatch):
    """``cli.py --model ngp`` for a few steps on a tiny scene (the field's
    defaults made ``TINY``'s: the CLI takes the published widths): it
    trains (finite loss, the table learns), writes a checkpoint of the
    field and a snapshot that says ``ngp``, resumes, and ``from_run_dir``
    serves it; NeRF's levers are refused."""
    from cvnerf_torch import cli
    from cvnerf_torch.data.synthetic import main as synth
    from cvnerf_torch.serve import NerfRenderer
    data = str(tmp_path / "data")
    synth(["--scene", "sphere", "--out", data, "--views", "4", "--size",
           "16", "16"])
    init = NgpFieldConfig.__init__
    monkeypatch.setattr(init, "__defaults__", tuple(
        getattr(TINY, f.name) for f in dataclasses.fields(NgpFieldConfig)))
    assert NgpFieldConfig() == TINY
    argv = ["--config", os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "demo_sphere.txt"),
            "--device", "cpu", "--data_dir", data, "--base_dir",
            str(tmp_path), "--save_dir", str(tmp_path), "--name", "ngp",
            "--iters", "8", "--ckpt_freq", "4", "--val_freq", "100",
            "--print_freq", "4", "--n_rays", "32", "--n_coarse_samples", "8",
            "--n_fine_samples", "8", "--precrop_iters", "0", "--chunk",
            "128", "--no-bf16", "--model", "ngp", "--lr", "1e-2",
            "--steps_per_call", "2"]
    m = cli.main(argv)
    assert np.isfinite(m["loss"])
    run = str(tmp_path / "ngp")
    snap = json.load(open(os.path.join(run, "scene.json")))
    assert snap["model"] == "ngp" and snap["mlp"]["n_levels"] == 4
    blob = torch.load(os.path.join(run, "torch_checkpoints", "000007.pt"),
                      weights_only=True)
    assert blob["model"] == "ngp" and blob["opt_state"]["count"] == 7
    m2 = cli.main([*argv[:argv.index("--iters") + 1], "10",
                   *argv[argv.index("--iters") + 2:]])
    assert np.isfinite(m2["loss"])
    r = NerfRenderer.from_run_dir(run, device="cpu", chunk=128)
    assert r.step == 9 and r.render_pose(np.eye(4)[:3]).shape == (16, 16, 3)
    with pytest.raises(SystemExit):
        cli.main([*argv, "--int8"])


def test_the_benchmarks_reference_is_this_one_bitwise():
    """``nerfbench/reference/ngp.py`` (the benchmark's copy) against
    ``tests/reference_ngp.py``: the encoding, the field, a render, a train
    step's loss, gradients and Adam update, bitwise."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from nerfbench.reference import ngp as bench
    p = _params(2)
    o, d, vd = _rays()
    key = PRNGKey(3)
    ids = torch.arange(24)
    draws = {"u_strat": ray_uniform(key, 1, ids, 8),
             "u_pdf": ray_sorted_uniform(key, 2, ids, 8)}
    target = torch.rand(24, 3, generator=torch.Generator().manual_seed(9))
    for fn in ("levels", "mlp_layers"):
        assert getattr(bench, fn)(RCFG) == getattr(ref, fn)(RCFG)
    outs = []
    for mod in (bench, ref):
        st = mod.fresh_state(p)
        new, out = mod._step(st, o, d, vd, 0.0, 1.0, target, RCFG,
                             mod.fp32, draws)
        outs.append([out["loss"], *mod.leaves(out["grads"]),
                     *mod.leaves(new["params"]), *mod.leaves(new["nu"]),
                     *mod.render_rays(p, o, d, vd, 0.0, 1.0, RCFG, mod.fp32,
                                      draws)])
    for a, b in zip(*outs):
        assert torch.equal(_bits(a.reshape(-1)), _bits(b.reshape(-1)))


def test_unit_positions_and_the_shape_template():
    """NDC's ``[-1, 1]³`` maps onto the unit cube; the shape template
    holds every leaf the initialiser draws, in its order."""
    x = torch.tensor([[-1.0, 0.0, 1.0]])
    assert unit_positions(x, TINY).tolist() == [[0.0, 0.5, 1.0]]
    want = init_ngp_params(PRNGKey(0), TINY, "cpu")
    shapes = [t.shape for t in tree_leaves(empty_ngp_params(TINY))]
    assert shapes == [t.shape for t in tree_leaves(want)]


# -- the MLPs' plain version and the kernels' wrapper -------------------------
def _apply_before(params, points, viewdirs, cfg, dt):
    """``apply_ngp`` as it ran before the MLPs moved to ``ops/ngp_mlp.py``
    (the encoding's plain version, then the ``torch.matmul`` chain)."""
    field = params.get("field", params)
    lead = points.shape[:-1]
    tables = [field["table"][str(k)] for k in range(cfg.n_levels)]
    feats = he.hash_encode(unit_positions(points, cfg), tables, cfg.levels,
                           out_dtype=dt)

    def lin(x, w, out32=False):
        x, w = x.to(dt), w.to(dt)
        if out32:
            return torch.matmul(x.float(), w.float())
        return torch.matmul(x, w)
    h = torch.relu(lin(feats, field["density"]["l0"]))
    geo = lin(h, field["density"]["l1"], out32=True)
    sh = sh_encode(viewdirs, 4)
    if viewdirs.dim() == points.dim() - 1:
        sh = sh[..., None, :].expand(*lead, sh.shape[-1])
    h = torch.cat([geo, sh.reshape(-1, sh.shape[-1])], -1)
    for k in range(3):
        h = lin(h, field["color"][f"l{k}"], out32=k == 2)
        if k < 2:
            h = torch.relu(h)
    return torch.cat([h, torch.exp(geo[:, :1])], -1).reshape(*lead, 4)


def _leaf_tree(params):
    leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    return leaves, {"field": {k: {n: next(it) for n in v}
                              for k, v in params["field"].items()}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_ray", [True, False])
def test_plain_mlps_are_the_field_before_the_move_bitwise(dtype, per_ray):
    """``apply_ngp`` on the CPU (the encoding's and ``ngp_mlp_plain``'s
    plain versions) against the field as it ran before: the same ops in the
    same order, so the output and every leaf's gradient bitwise, in both
    compute dtypes, with directions a ray or a sample."""
    p = _params(4)
    o, d, vd = _rays()
    t = torch.rand(24, 8, generator=torch.Generator().manual_seed(12))
    pts = o[:, None] + d[:, None] * t[..., None]
    if not per_ray:
        vd = vd[:, None].expand(24, 8, 3).contiguous()
    g = torch.randn(24, 8, 4, generator=torch.Generator().manual_seed(13))
    outs = []
    for fn in (lambda tree: apply_ngp(tree, pts, vd, TINY, dtype),
               lambda tree: _apply_before(tree, pts, vd, TINY, dtype)):
        leaves, tree = _leaf_tree(p)
        out = fn(tree)
        grads = torch.autograd.grad(out, leaves, g)
        outs.append([out, *grads])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n,spr", [(24 * 8, 8), (5 * 64, 64), (7, 1)])
def test_sample_sh_reads_row_sample_over_samples_per_ray(n, spr):
    """The SH a sample reads: row ``i // samples_per_ray`` of the per-ray
    SH (the kernels' indexing), equal to the per-ray SH expanded over a
    ray's samples as ``apply_ngp`` formed it before."""
    vd = torch.randn(n // spr, 3, generator=torch.Generator().manual_seed(n))
    sh = sh_encode(vd / torch.linalg.norm(vd, dim=-1, keepdim=True))
    rows = torch.arange(n) // spr
    got = nm.sample_sh(sh, n, spr)
    expanded = sh[:, None, :].expand(n // spr, spr, 16).reshape(-1, 16)
    assert torch.equal(got, sh[rows]) and torch.equal(got, expanded)


def test_plain_calls_count_cpu_calls():
    """Each CPU call of the field runs the plain version once (counted with
    its samples) and launches no kernel."""
    p = _params()
    o, d, vd = _rays()
    pts = o[:, None] + d[:, None] * torch.rand(
        24, 8, generator=torch.Generator().manual_seed(14))[..., None]
    before = dict(nm.stats)
    apply_ngp(p, pts, vd, TINY, torch.bfloat16)
    apply_ngp(p, pts, vd, TINY, torch.float32, kernels="off")
    assert nm.stats["plain_calls"] - before["plain_calls"] == 2
    assert nm.stats["samples"] - before["samples"] == 2 * 24 * 8
    assert nm.stats["fwd_launches"] == before["fwd_launches"]
    assert nm.stats["bwd_launches"] == before["bwd_launches"]


def _kernel_args():
    """Arguments the kernels take, but on the CPU: 6 samples, 2 a ray, the
    published MLPs' leaf shapes."""
    return {"feats": torch.zeros(6, 32, dtype=torch.bfloat16),
            "sh": torch.zeros(3, 16), "samples_per_ray": 2,
            "weights": [torch.zeros(a, b) for _, _, a, b in nm.LAYERS]}


@pytest.mark.parametrize("case", [
    "device", "feats_dtype", "feats_width", "feats_strided", "sh_dtype",
    "sh_width", "sh_rows", "sh_strided", "weight_width", "weight_dtype",
    "weight_strided", "weight_count", "samples_per_ray"])
def test_the_kernel_wrappers_refuse_what_they_do_not_take(case):
    """``ngp_mlp_fwd`` and ``ngp_mlp_bwd`` raise on a device, dtype, width
    or layout the kernels do not take (checked before any library is
    loaded), each naming the problem; correct card tensors are the only
    way in."""
    a = _kernel_args()
    w = list(a["weights"])
    change = {
        "device": {},
        "feats_dtype": {"feats": a["feats"].float()},
        "feats_width": {"feats": torch.zeros(6, 16, dtype=torch.bfloat16)},
        "feats_strided": {"feats": torch.zeros(32, 6, dtype=torch.bfloat16).t()},
        "sh_dtype": {"sh": a["sh"].double()},
        "sh_width": {"sh": torch.zeros(3, 9)},
        "sh_rows": {"sh": torch.zeros(4, 16)},
        "sh_strided": {"sh": torch.zeros(16, 3).t()},
        "weight_width": {"weights": w[:1] + [torch.zeros(64, 8)] + w[2:]},
        "weight_dtype": {"weights": [w[0].to(torch.bfloat16)] + w[1:]},
        "weight_strided": {"weights": w[:3] + [w[3].t()] + w[4:]},
        "weight_count": {"weights": w[:4]},
        "samples_per_ray": {"samples_per_ray": 0},
    }[case]
    a.update(change)
    with pytest.raises(ValueError,
                       match="card" if case == "device" else "."):
        nm.ngp_mlp_fwd(**a)
    with pytest.raises(ValueError):
        nm.ngp_mlp_bwd(**a, grad=torch.zeros(6, 4))


@pytest.mark.parametrize("cfg", [TINY, dataclasses.replace(
    NgpFieldConfig(), hidden=32), dataclasses.replace(NgpFieldConfig(),
                                                      n_levels=8)])
def test_other_widths_are_refused_for_the_kernels(cfg):
    """A field whose MLPs are not 64 wide or whose encoding is not 32
    features cannot take the kernels: the check names ``kernels='off'``;
    the published field passes."""
    with pytest.raises(ValueError, match="kernels='off'"):
        nm.check_kernel_config(cfg)
    nm.check_kernel_config(NgpFieldConfig())


def test_trainer_counters_report_the_mlps():
    """``Trainer.counters`` carries the MLPs' counts under ``mlp_``, beside
    the hash encoding's; a CPU step runs the plain version, twice (coarse
    and fine)."""
    from cvnerf_torch.train.loop import TrainConfig, Trainer
    cfg = TrainConfig(height=12, width=16, focal=14.0, near=0.0, far=1.0,
                      n_rays=16, lr=1e-2, lr_decay=0, ndc=True,
                      render=RenderConfig(n_coarse=4, n_fine=4, mlp=TINY))
    state = create_train_state(PRNGKey(2), lr=1e-2, lr_decay=0, mlp=TINY,
                               device="cpu")
    images = np.random.default_rng(2).random((2, 12, 16, 3)) \
        .astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (2, 1, 1))
    tr = Trainer(cfg, state, images, poses, [0, 1], steps_per_call=1)
    before = nm.stats["plain_calls"]
    tr.run(0, 1)
    counters = tr.counters()
    assert counters["mlp_plain_calls"] - before == 2
    assert {f"mlp_{k}" for k in nm.stats} <= set(counters)
    assert "hash_plain_calls" in counters
