"""The port's training entry point (``python -m cvnerf_torch.cli``) on the
CPU: train, checkpoint, resume and render; fresh runs and their backups;
best-validation tracking; crash recovery from the best checkpoint; serving
the run; the training levers' flags (and the recorded ``freq_anneal`` and
``ema_decay`` staying in force on resume); the flags once refused, the
multi-process ones among them; and
parity with the JAX package's CLI, plain and with EMA, the frequency anneal
and the noise decay on.

Parity (fp32, the kernels' plain versions here, JAX with its Pallas kernels
off): both CLIs fine-tune the same JAX state (saved by each package's
own checkpoint writer) for three steps with validation and test on. The
logged ``loss`` and ``psnr`` agree at rtol 1e-4 at every step (the
three-step test's bound, ``test_torch_port_train.py``), validation and test
PSNR within 1e-3 dB, and the final params and Adam moments per leaf at
``test_three_train_steps_match_jax``'s tolerances.
"""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cvnerf_torch import cli
from cvnerf_torch.data.synthetic import make_blender_dataset
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.serve import NerfRenderer
from cvnerf_torch.train import checkpoint as tckpt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: these runs are many tiny ops, as fast on one
    thread, and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TINY_FLAGS = [
    "--device", "cpu", "--no-bf16",
    "--dtype", "blender", "--white_bkg", "--testskip", "1",
    "--n_rays", "64", "--n_coarse_samples", "8", "--n_fine_samples", "8",
    "--trunk_width", "32", "--head_width", "16",
    "--xyz_freqs", "4", "--dir_freqs", "2",
    "--noise", "1.0",
    "--chunk", "256", "--print_freq", "5", "--vid_freq", "0",
    "--val_freq", "0", "--lr", "5e-3",
]


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    make_blender_dataset(d, n_train=4, n_val=1, n_test=1, h=24, w=24)
    return d


def _base(blender_dir, logdir, name):
    return ["--data_dir", blender_dir, "--base_dir", logdir,
            "--save_dir", logdir, "--name", name, *TINY_FLAGS]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as fp:
        return [json.loads(line) for line in fp]


def test_train_checkpoint_resume_render(blender_dir, tmp_path):
    logdir = str(tmp_path / "logs")
    base = _base(blender_dir, logdir, "e2e")
    cli.main([*base, "--iters", "16", "--ckpt_freq", "10"])
    run_dir = os.path.join(logdir, "e2e")
    assert os.path.exists(os.path.join(run_dir, "config_resolved.json"))
    assert any("loss" in r for r in _records(run_dir))
    ckpt_dir = os.path.join(run_dir, "torch_checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["000010.pt", "000015.pt"]

    # Resume from step 15 and train to 20.
    cli.main([*base, "--iters", "21", "--ckpt_freq", "0"])
    steps = [r["step"] for r in _records(run_dir) if "loss" in r]
    assert max(steps) == 20 and [s for s in steps if s > 15]
    assert tckpt.latest_step(ckpt_dir) == 20

    # Render-only from the checkpoint, with the disparity video.
    out = cli.main([*base, "--render_only", "--render_factor", "4",
                    "--render_depth", "--iters", "21"])
    assert out == {"step": 20}
    names = os.listdir(run_dir)
    assert [f for f in names if "spiral" in f], names
    assert [f for f in names if "_disp" in f], names


def test_render_test_scores_the_logged_test_psnr(blender_dir, tmp_path):
    """``--render_only --render_test`` renders the test views with the
    test eval's chunking; with the evenly spaced resample the frames do not
    depend on the key, so the score equals the one logged at the end of
    training. ``--int8`` renders the same views through the int8 path."""
    logdir = str(tmp_path / "logs")
    base = [*_base(blender_dir, logdir, "rt"), "--deterministic_resample",
            "--iters", "6", "--ckpt_freq", "0"]
    final = cli.main(base)
    logged = [r for r in _records(os.path.join(logdir, "rt"))
              if "test_psnr" in r][-1]
    assert final["test_psnr"] == logged["test_psnr"]
    out = cli.main([*base, "--render_only", "--render_test"])
    assert out == {"step": 5, "test_psnr": logged["test_psnr"],
                   "test_ssim": logged["test_ssim"]}
    q = cli.main([*base, "--render_only", "--render_test", "--int8",
                  "--int8_calib", "4096"])
    assert q["step"] == 5 and abs(q["test_psnr"] - out["test_psnr"]) < 1.0


def test_no_reload_starts_fresh(blender_dir, tmp_path):
    logdir = str(tmp_path / "logs")
    base = _base(blender_dir, logdir, "fresh")
    cli.main([*base, "--iters", "6", "--ckpt_freq", "5"])
    cli.main([*base, "--iters", "6", "--ckpt_freq", "0", "--no_reload"])
    steps = [r["step"] for r in _records(os.path.join(logdir, "fresh"))
             if "loss" in r]
    assert steps.count(5) >= 2


def test_no_reload_backup_does_not_collide(blender_dir, tmp_path):
    logdir = str(tmp_path / "logs")
    base = _base(blender_dir, logdir, "bak")
    for extra in ([], ["--no_reload"], ["--no_reload"]):
        cli.main([*base, "--iters", "6", "--ckpt_freq", "5", *extra])
    run_dir = os.path.join(logdir, "bak")
    baks = sorted(d for d in os.listdir(run_dir)
                  if d.startswith("torch_checkpoints.bak"))
    assert baks == ["torch_checkpoints.bak-5", "torch_checkpoints.bak-5.1"]


def test_profile_dir_writes_a_trace(blender_dir, tmp_path):
    logdir = str(tmp_path / "logs")
    prof = str(tmp_path / "trace")
    cli.main([*_base(blender_dir, logdir, "prof"), "--iters", "25",
              "--ckpt_freq", "0", "--profile_dir", prof])
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    steps = [r["step"] for r in _records(os.path.join(logdir, "prof"))
             if "loss" in r]
    assert max(steps) == 24


def test_train_then_serve_from_run_dir(blender_dir, tmp_path):
    """Train, then serve the run with ``cvnerf_torch.server --run`` (no
    geometry flags): the HTTP render equals a direct render of the
    renderer's own nets."""
    from cvnerf_torch.render.frames import render_image
    from cvnerf_torch.server import build_parser, make_server, \
        renderer_from_args
    logdir = str(tmp_path / "logs")
    cli.main([*_base(blender_dir, logdir, "srv"), "--iters", "8",
              "--ckpt_freq", "5"])
    run_dir = os.path.join(logdir, "srv")
    args = build_parser().parse_args(["--run", run_dir, "--chunk", "256",
                                      "--device", "cpu"])
    r = renderer_from_args(args)
    assert r.step == 7
    saved = tckpt.restore_params(os.path.join(run_dir, "torch_checkpoints"))
    for net in ("coarse", "fine"):
        for layer, leaves in saved[0][net].items():
            for q, t in leaves.items():
                assert torch.equal(r.params[net][layer][q], t)
    srv = make_server(r, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        from cvnerf_torch.data.datasets import load_scene
        scene = load_scene(blender_dir, "blender", testskip=1,
                           white_bkg=True)
        pose = np.asarray(scene.poses[0])[:3, :4]
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/render",
            data=json.dumps({"c2w": pose.tolist(),
                             "format": "json"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            served = np.asarray(json.loads(resp.read())["rgb"], np.float32)
        direct = render_image(r._nets, r.height, r.width, r.focal,
                              torch.as_tensor(pose), r.near, r.far, r.cfg,
                              chunk=r.chunk)["rgb"].numpy()
        assert served.shape == direct.shape == (24, 24, 3)
        np.testing.assert_allclose(served, direct, atol=1e-6)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)


def test_track_best_checkpoint_and_metrics(blender_dir, tmp_path, capsys):
    logdir = str(tmp_path / "logs")
    base = [*_base(blender_dir, logdir, "tb"), "--val_freq", "5",
            "--track_best"]
    cli.main([*base, "--iters", "11", "--ckpt_freq", "0"])
    run_dir = os.path.join(logdir, "tb")
    assert os.path.isdir(os.path.join(run_dir, "torch_checkpoints_best"))
    best = [r for r in _records(run_dir) if "test_psnr_best" in r]
    assert best and best[-1]["best_step"] in (5, 10)
    assert "best_val_psnr" in best[-1] and "test_ssim_best" in best[-1]
    best_step = int(best[-1]["best_step"])
    assert json.load(open(os.path.join(run_dir, "best.json")))["step"] == \
        best_step

    r_auto = NerfRenderer.from_run_dir(run_dir, chunk=128, device="cpu")
    assert r_auto.step == best_step and r_auto.which == "best"
    assert NerfRenderer.from_run_dir(run_dir, chunk=128, device="cpu",
                                     which="best").step == best_step
    r_last = NerfRenderer.from_run_dir(run_dir, chunk=128, device="cpu",
                                       which="last")
    assert r_last.step == 10 and r_last.which == "last"

    capsys.readouterr()
    out = cli.main([*base, "--iters", "11", "--render_only",
                    "--render_factor", "4"])
    assert out["step"] == best_step
    if best_step != 10:
        assert f"rendering the best-val model (step {best_step})" in \
            capsys.readouterr().out


def test_resume_falls_back_to_best_checkpoint(blender_dir, tmp_path, capsys):
    import shutil
    logdir = str(tmp_path / "logs")
    base = [*_base(blender_dir, logdir, "fb"), "--val_freq", "5",
            "--track_best"]
    cli.main([*base, "--iters", "11", "--ckpt_freq", "5"])
    run_dir = os.path.join(logdir, "fb")
    shutil.rmtree(os.path.join(run_dir, "torch_checkpoints"))  # the crash
    best_step = json.load(open(os.path.join(run_dir, "best.json")))["step"]
    capsys.readouterr()
    cli.main([*base, "--iters", "16", "--ckpt_freq", "0"])
    out = capsys.readouterr().out
    assert "resuming from best" in out
    assert f"Resumed from checkpoint at step {best_step}" in out
    assert max(r["step"] for r in _records(run_dir) if "loss" in r) == 15


def test_no_reload_backs_up_an_orphan_best_checkpoint(blender_dir, tmp_path):
    import shutil
    logdir = str(tmp_path / "logs")
    base = [*_base(blender_dir, logdir, "orph"), "--ckpt_freq", "5",
            "--val_freq", "5", "--track_best"]
    cli.main([*base, "--iters", "11"])
    run_dir = os.path.join(logdir, "orph")
    shutil.rmtree(os.path.join(run_dir, "torch_checkpoints"))
    cli.main([*base, "--iters", "11", "--no_reload"])
    names = os.listdir(run_dir)
    assert any(n.startswith("torch_checkpoints.bak") and n.endswith("_best")
               for n in names), names
    assert json.load(open(os.path.join(run_dir, "best.json")))["step"] <= 10
    assert [r for r in _records(run_dir) if "test_psnr_best" in r]


REFUSED = [
    (["--ema_decay", "0.99"], "--ema_decay", "item 9"),
    (["--freq_anneal", "0.08"], "--freq_anneal", "item 9"),
    (["--noise_decay", "100"], "--noise_decay", "item 9"),
    (["--distortion_loss", "0.01"], "--distortion_loss", "item 9"),
    (["--occlusion_loss", "0.01"], "--occlusion_loss", "item 9"),
    (["--ray_batching"], "--ray_batching", "item 9"),
    (["--pixel_sampling", "parity"], "--pixel_sampling parity", "item 9"),
    (["--occ_train", "--occ_train_warmup", "4", "--occ_train_every", "4",
      "--occupancy_res", "8"], "--occ_train", "item 10"),
    (["--occupancy", "merge"], "--occupancy", "item 10"),
    (["--lpips_weights", "missing.npz"], "--lpips_weights", "item 10"),
    (["--coordinator", "localhost:{port}", "--num_processes", "1",
      "--process_id", "0"], "--coordinator", "item 11"),
    (["--num_processes", "2"], "--num_processes", "item 11"),
    (["--process_id", "0"], "--process_id", "item 11"),
]
# What each item-9 flag resolves to in config_resolved.json, and the key
# scene.json records for the two that stay in force on resume.
LEVER_RECORD = {"--ema_decay": ("ema_decay", 0.99, "ema_decay"),
                "--freq_anneal": ("freq_anneal", 1, "freq_anneal"),
                "--noise_decay": ("noise_decay", 100, None),
                "--distortion_loss": ("distortion_loss", 0.01, None),
                "--occlusion_loss": ("occlusion_loss", 0.01, None),
                "--ray_batching": ("ray_batching", True, None),
                "--pixel_sampling parity": ("pixel_sampling", "parity",
                                            None)}


@pytest.mark.parametrize("flags,name,item", REFUSED,
                         ids=[r[1].split()[0][2:] + ("_parity" if "parity"
                                                     in r[1] else "")
                              for r in REFUSED])
def test_unported_flags_are_refused_before_anything_is_written(
        blender_dir, tmp_path, capsys, flags, name, item):
    """The flags of ROADMAP Queue 1 items 9, 10 and 11, once refused here
    before anything was written, now run. Item 11: the three flags start a
    one-rank gloo world (the JAX CLI's "Distributed: process 0 of 1"), the
    run trains and writes its run directory, and the process group is
    gone when the CLI returns; a coordinator without the world size
    raises before anything is written; ``--num_processes`` or
    ``--process_id`` alone is ignored, as in the JAX CLI (no coordinator,
    no process group). The item-9 run records the resolved flag
    (``--freq_anneal 0.08``
    of 12 iters is 1 step), and a recorded ``freq_anneal`` or ``ema_decay``
    stays in force when the resumed run omits the flag; ``--occ_train``
    records its bake in ``scene.json``, ``--occupancy`` is ignored during
    training (as in the JAX CLI) and ``--lpips_weights`` names a missing
    file (the JAX loader's error) or is ignored below 32 px, saying so."""
    logdir = str(tmp_path / "logs")
    base = [*_base(blender_dir, logdir, "x"), "--ckpt_freq", "0"]
    if item == "item 10":
        run_dir = os.path.join(logdir, "x")
        if name == "--lpips_weights":
            with pytest.raises(FileNotFoundError, match="LPIPS weights not"):
                cli.main([*base, "--iters", "3", *flags])
            from test_torch_port_lpips import _bundle
            weights = str(tmp_path / "w.npz")
            _bundle(weights)
            flags = ["--lpips_weights", weights]
        out = cli.main([*base, "--iters", "12", *flags])
        assert np.isfinite(out["loss"]) and np.isfinite(out["test_psnr"])
        assert "test_lpips" not in out
        snap = json.load(open(os.path.join(run_dir, "scene.json")))
        printed = capsys.readouterr().out
        if name == "--occ_train":
            assert snap["occ_train"] == {"resolution": 8, "bound": 1.5,
                                         "mode": "merge",
                                         "interp": "nearest", "floor": 0}
            verdicts = [r["occ_verdict"] for r in _records(run_dir)
                        if "occ_verdict" in r]
            assert len(verdicts) == 2 and set(verdicts) <= {
                "switched", "rebaked", "postponed", "kept"}
        else:
            assert "occ_train" not in snap
        if name == "--lpips_weights":
            assert "--lpips_weights ignored: 24x24 frames" in printed
        return
    if item == "item 11":
        import torch.distributed as dist
        from test_torch_port_parallel import free_port
        flags = [f.format(port=free_port()) for f in flags]
        if name == "--coordinator":
            with pytest.raises(ValueError, match="num_processes"):
                cli.main([*base, "--iters", "3", *flags[:2]])
            assert not os.path.exists(logdir)
        out = cli.main([*base, "--iters", "4", *flags])
        assert np.isfinite(out["loss"]) and np.isfinite(out["test_psnr"])
        assert not dist.is_initialized()
        printed = capsys.readouterr().out
        assert ("Distributed: process 0 of 1" in printed) == (
            name == "--coordinator")
        assert "Device mesh: 1 x cpu" in printed
        run_dir = os.path.join(logdir, "x")
        assert max(r["step"] for r in _records(run_dir) if "loss" in r) == 3
        assert tckpt.latest_step(os.path.join(run_dir,
                                              "torch_checkpoints")) == 3
        return
    key, value, recorded = LEVER_RECORD[name]
    out = cli.main([*base, "--iters", "12", *flags])
    assert np.isfinite(out["loss"]) and np.isfinite(out["test_psnr"])
    run_dir = os.path.join(logdir, "x")
    assert json.load(open(os.path.join(run_dir, "config_resolved.json")))[
        key] == value
    snap = json.load(open(os.path.join(run_dir, "scene.json")))
    assert snap.get(recorded) == (value if recorded else None)
    cli.main([*base, "--iters", "14"])                  # resumed, no flag
    assert max(r["step"] for r in _records(run_dir) if "loss" in r) == 13
    resolved = json.load(open(os.path.join(run_dir, "config_resolved.json")))
    if recorded:
        assert resolved[key] == value
        assert json.load(open(os.path.join(run_dir, "scene.json")))[
            recorded] == value
    if name == "--ema_decay":
        blob = torch.load(os.path.join(run_dir, "torch_checkpoints",
                                       "000013.pt"), weights_only=True)
        assert "ema_params" in blob


@pytest.mark.parametrize("record,name", [
    ({"freq_anneal": 240}, "--freq_anneal"),
    ({"ema_decay": 0.995}, "--ema_decay"),
    ({"occ_train": {"resolution": 64, "bound": 1.5, "mode": "merge",
                    "interp": "nearest", "floor": 0}}, "--occ_train")],
    ids=["freq_anneal", "ema_decay", "occ_train"])
def test_a_run_dir_that_recorded_a_lever_is_refused_unless_fresh(
        blender_dir, tmp_path, capsys, record, name):
    """A recorded ``freq_anneal``, ``ema_decay`` or ``occ_train``, once
    refused, now stays in force on a resume that omits the flag (the JAX
    CLI's messages; ``scene.json`` keeps it: an occupancy-trained run's
    checkpoints carry an untrained coarse net), and ``--no_reload`` drops
    it, saying so."""
    logdir = str(tmp_path / "logs")
    base = [*_base(blender_dir, logdir, "rec"), "--iters", "3",
            "--ckpt_freq", "0"]
    cli.main(base)
    run_dir = os.path.join(logdir, "rec")
    snap_path = os.path.join(run_dir, "scene.json")
    snap = json.load(open(snap_path))
    json.dump({**snap, **record}, open(snap_path, "w"))
    key, value = next(iter(record.items()))
    capsys.readouterr()
    cli.main([*base[:-4], "--iters", "5", "--ckpt_freq", "0"])
    if name == "--occ_train":
        assert "omits it: preserving the occupancy serving metadata" in \
            capsys.readouterr().out
    else:
        what = {"freq_anneal": "anneal horizon", "ema_decay": "decay"}[key]
        assert f"using the run dir's recorded {what} {value}" in \
            capsys.readouterr().out
        assert json.load(open(os.path.join(
            run_dir, "config_resolved.json")))[key] == value
    assert json.load(open(snap_path))[key] == value
    capsys.readouterr()
    cli.main([*base, "--no_reload"])
    assert name[2:] not in json.load(open(snap_path))
    assert ("dropping the occupancy serving metadata" if name == "--occ_train"
            else "for this fresh (--no_reload) run") in capsys.readouterr().out


def test_pallas_interpret_and_a_missing_card_are_refused(blender_dir,
                                                         tmp_path,
                                                         monkeypatch):
    logdir = str(tmp_path / "logs")
    with pytest.raises(ValueError, match="interpret"):
        cli.main([*_base(blender_dir, logdir, "x"), "--pallas",
                  "interpret"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _base(blender_dir, logdir, "x")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([*argv, "--iters", "3"])
    assert not os.path.exists(logdir)


def test_a_fresh_run_starts_from_the_jax_clis_weights(blender_dir,
                                                      tmp_path):
    """``--seed`` gives the JAX CLI's nets bit for bit: a run of no steps
    saves them unchanged."""
    from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
    from cvnerf_tpu.train.state import create_train_state as jax_create
    from test_torch_port_train import TINY
    logdir = str(tmp_path / "logs")
    cli.main([*_base(blender_dir, logdir, "s"), "--iters", "1",
              "--ckpt_freq", "0", "--seed", "4"])
    got, step = tckpt.restore_params(
        os.path.join(logdir, "s", "torch_checkpoints"))
    want = jax_create(jax.random.PRNGKey(4), mlp=JaxCfg(**TINY)).params
    assert step == 0
    for net, layers in want.items():
        for layer, leaves in layers.items():
            for q, w in leaves.items():
                np.testing.assert_array_equal(got[net][layer][q].numpy(),
                                              np.asarray(w))


# ---------- parity with the JAX CLI ----------

PARITY_FLAGS = ["--no-bf16", "--dtype", "blender", "--white_bkg",
                "--testskip", "1", "--n_rays", "64",
                "--n_coarse_samples", "8", "--n_fine_samples", "8",
                "--trunk_width", "32", "--head_width", "16",
                "--xyz_freqs", "4", "--dir_freqs", "2", "--noise", "1.0",
                "--chunk", "256", "--print_freq", "1", "--vid_freq", "0",
                "--val_freq", "2", "--ckpt_freq", "0", "--lr", "5e-4",
                "--lr_decay", "1", "--iters", "4"]


def test_cli_matches_the_jax_cli_in_fp32(tmp_path):
    _cli_parity(tmp_path, [])


def test_cli_occ_train_matches_the_jax_cli(tmp_path):
    """``--occ_train`` through both CLIs from one biased state (its bake is
    occupied from the start): the switch at step 2 and the occupancy step
    3, the validation at 2 through the fresh grid, the verdicts and
    occupied fractions in ``metrics.jsonl``, the final checkpoints (the
    coarse net frozen at the switch) and the ``scene.json`` records."""
    _cli_parity(tmp_path, ["--occ_train", "--occ_train_warmup", "2",
                           "--occ_train_every", "2", "--occupancy_res", "10",
                           "--occ_train_mode", "full", "--occ_floor", "2"],
                alpha_bias=1.0)


def test_cli_levers_match_the_jax_cli(tmp_path):
    """EMA, the frequency anneal and the noise decay on (both CLIs warm-
    start the average from the fine-tuned state, which has none): the
    same metrics, and the final checkpoints, the average included, at the
    three-step test's tolerances."""
    _cli_parity(tmp_path, ["--ema_decay", "0.9", "--freq_anneal", "4",
                           "--noise_decay", "3"])


def _cli_parity(tmp_path, levers, alpha_bias=0.0):
    from cvnerf_tpu.cli import main as jax_main
    from cvnerf_tpu.data.synthetic import make_blender_dataset as jax_make
    from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
    from cvnerf_tpu.train.checkpoint import restore_checkpoint as jax_restore
    from cvnerf_tpu.train.checkpoint import save_checkpoint as jax_save
    from cvnerf_tpu.train.state import create_train_state as jax_create
    from cvnerf_torch.train.state import create_train_state
    from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
    from cvnerf_torch.utils.convert import train_state_from_jax
    from test_torch_port_train import TINY, _compare_states

    data = str(tmp_path / "scene")
    jax_make(data, n_train=4, n_val=2, n_test=2, h=24, w=24)
    jstate = jax_create(jax.random.PRNGKey(2), lr=5e-4, lr_decay=1,
                        mlp=JaxCfg(**TINY))
    for net in jstate.params.values():
        net["alpha"]["b"] = net["alpha"]["b"] + alpha_bias
    jax_save(str(tmp_path / "jax_ft"), jstate)
    tckpt.save_checkpoint(str(tmp_path / "torch_ft"), train_state_from_jax(
        jax.tree.map(np.asarray, jstate)))

    def run(main, name, extra):
        logdir = str(tmp_path / name)
        main(["--data_dir", data, "--base_dir", logdir, "--save_dir",
              logdir, "--name", "p", *PARITY_FLAGS,
              "--ft_path", str(tmp_path / f"{name}_ft"), *extra])
        return os.path.join(logdir, "p")

    jrun = run(jax_main, "jax", levers)
    trun = run(cli.main, "torch", ["--device", "cpu", *levers])
    jrec, trec = _records(jrun), _records(trun)
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    logged = 0
    for t, j in zip(trec, jrec):
        assert t["step"] == j["step"]
        for k in ("loss", "psnr", "mse_fine", "grad_norm"):
            if k in j:
                np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
                logged += k == "loss"
        for k in ("val_psnr", "test_psnr"):
            if k in j:
                assert abs(t[k] - j[k]) <= 1e-3, (k, t[k], j[k])
        for k in ("lr", "val_views", "test_views"):
            if k in j:
                assert t[k] == pytest.approx(j[k], rel=1e-6), k
        for k in ("occ_verdict", "occ_occupied_frac"):
            if k in j:
                assert t[k] == j[k], k
    assert logged == 4          # steps 1-3 and the final record
    if "--occ_train" in levers:
        assert [r["occ_verdict"] for r in trec if "occ_verdict" in r] == [
            "switched"]
    assert any("test_psnr" in r for r in trec)

    ema = "--ema_decay" in levers
    tfinal = tckpt.restore_checkpoint(
        os.path.join(trun, "torch_checkpoints"), create_train_state(
            PRNGKey(0), mlp=NerfMLPConfig(**TINY),
            device="cpu", ema=ema))
    jfinal = jax_restore(os.path.join(jrun, "checkpoints"), jax_create(
        jax.random.PRNGKey(2), lr=5e-4, lr_decay=1, mlp=JaxCfg(**TINY),
        ema=ema))
    assert (tfinal.ema_params is not None) == ema
    assert tfinal.step == int(jfinal.step) == 3
    _compare_states(jfinal, tfinal, 5e-4, 3)
    for name in ("config_resolved.json", "scene.json"):
        got = json.load(open(os.path.join(trun, name)))
        want = json.load(open(os.path.join(jrun, name)))
        got.pop("device", None)
        for k in ("ft_path", "base_dir", "save_dir"):
            want.pop(k, None), got.pop(k, None)
        assert got == want, name


def _biased_ft(tmp_path, bias=1.0) -> str:
    """A fresh state whose density heads are shifted by ``bias`` (so its
    bake is occupied everywhere, or, negative, empty), saved for
    ``--ft_path``."""
    from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
    from cvnerf_torch.train.state import create_train_state
    st = create_train_state(PRNGKey(3), lr=5e-3, mlp=NerfMLPConfig(
        xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16),
        device="cpu")
    for net in st.params.values():
        net["alpha"]["b"] += bias
    path = str(tmp_path / f"ft{bias:+}")
    tckpt.save_checkpoint(path, st)
    return path


def test_occ_train_sticks_resumes_renders_and_serves(blender_dir, tmp_path,
                                                     capsys):
    """An ``--occ_train`` run (from a state whose bake is occupied): the
    switch at the warm-up and a rebake, the coarse net frozen from the
    switch on; a resume past the warm-up re-enters occupancy training with
    the recorded mode; a plain ``--render_only`` renders through the
    recorded grid; ``from_run_dir`` serves through one; and the JAX CLI's
    exits for ``n_fine_samples 0`` and ``--occ_train_every 0``."""
    logdir = str(tmp_path / "logs")
    occ = ["--occ_train", "--occ_train_warmup", "4", "--occ_train_every",
           "4", "--occupancy_res", "12"]
    base = [*_base(blender_dir, logdir, "occ"), "--ckpt_freq", "4"]
    cli.main([*base, *occ, "--occ_train_mode", "full", "--occ_floor", "2",
              "--iters", "9", "--ft_path", _biased_ft(tmp_path)])
    run_dir = os.path.join(logdir, "occ")
    recs = _records(run_dir)
    assert [(r["step"], r["occ_verdict"]) for r in recs
            if "occ_verdict" in r] == [(4, "switched"), (8, "rebaked")]
    assert all(r["occ_occupied_frac"] > 0 for r in recs
               if "occ_verdict" in r)
    snap_path = os.path.join(run_dir, "scene.json")
    assert json.load(open(snap_path))["occ_train"] == {
        "resolution": 12, "bound": 1.5, "mode": "full", "interp": "nearest",
        "floor": 2}
    ckpts = os.path.join(run_dir, "torch_checkpoints")
    at4, _ = tckpt.restore_params(ckpts, step=4)
    at8, _ = tckpt.restore_params(ckpts, step=8)
    for layer, leaves in at4["coarse"].items():
        for q, t in leaves.items():
            assert torch.equal(at8["coarse"][layer][q], t)
    assert not torch.equal(at8["fine"]["l1"]["w"], at4["fine"]["l1"]["w"])

    capsys.readouterr()
    cli.main([*base, *occ, "--iters", "11"])
    out = capsys.readouterr().out
    assert "using the run dir's recorded sampling mode 'full'" in out
    assert "occupancy training active from step 8 (res=12)" in out
    at10, _ = tckpt.restore_params(ckpts)
    for layer, leaves in at4["coarse"].items():
        for q, t in leaves.items():
            assert torch.equal(at10["coarse"][layer][q], t)

    res = cli.main([*base, "--render_only", "--render_factor", "4",
                    "--iters", "11"])
    out = capsys.readouterr().out
    assert res == {"step": 10}
    assert "preserving the occupancy serving metadata" in out
    assert "rendering through the run dir's recorded occupancy mode 'full'" \
        in out and "occupancy grid active: mode=full res=12" in out
    r = NerfRenderer.from_run_dir(run_dir, device="cpu")
    assert r.occupancy is not None and r.cfg.occupancy_mode == "full"
    assert (r.cfg.occ_floor, r.cfg.occupancy_interp) == (2, "nearest")
    assert np.isfinite(r.render_pose(np.eye(4)[:3] + [[0, 0, 0, 0],
                                                      [0, 0, 0, 0],
                                                      [0, 0, 0, 4.0]])).all()
    for bad, msg in ((["--n_fine_samples", "0"], "requires n_fine_samples"),
                     (["--occ_train_every", "0"], "must be > 0")):
        with pytest.raises(SystemExit, match=msg):
            cli.main([*base, "--occ_train", "--iters", "11", *bad])


def test_render_only_occupancy_of_a_plain_run(blender_dir, tmp_path, capsys):
    """``--render_only --occupancy merge`` bakes from the restored weights
    and renders through the grid (the fine pass alone per chunk); an empty
    bake renders grid-less with the JAX CLI's warning."""
    from cvnerf_torch.ops import fused_mlp as fm
    for bias, name in ((1.0, "occupied"), (-50.0, "empty")):
        logdir = str(tmp_path / name)
        base = [*_base(blender_dir, logdir, "ro"), "--ckpt_freq", "0",
                "--iters", "4", "--deterministic_resample"]
        cli.main([*base, "--ft_path", _biased_ft(tmp_path, bias)])
        capsys.readouterr()
        calls = fm.fused_nerf_plain.calls
        res = cli.main([*base, "--render_only", "--render_test",
                        "--occupancy", "merge", "--occupancy_res", "10"])
        out = capsys.readouterr().out
        # The bake's 1,000 points in one call, then the test view's 24x24
        # rays in 3 chunks of 256: a fine pass each through the grid, a
        # coarse and a fine pass each without it.
        if name == "occupied":
            assert "occupancy grid active: mode=merge res=10" in out
            assert fm.fused_nerf_plain.calls - calls == 1 + 3
        else:
            assert "occupancy bake found no positive density" in out
            assert fm.fused_nerf_plain.calls - calls == 1 + 6
        assert res["step"] == 3 and np.isfinite(res["test_psnr"])
