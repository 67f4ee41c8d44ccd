"""The port's HTTP server on the CPU (a live localhost server on port 0)."""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params
from cvnerf_torch.ops import fused_mlp_int8 as fq
from cvnerf_torch.ops.rng import PRNGKey, split
from cvnerf_torch.ops import fused_mlp as fm
from cvnerf_torch.server import (build_parser, int8_from_args, main,
                                 make_server, occupancy_from_args,
                                 renderer_from_args)
from cvnerf_torch.utils.convert import torch_state_dict_from_params

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)
POSE = [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 4.0]]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    run = str(tmp_path_factory.mktemp("server") / "run")
    os.makedirs(os.path.join(run, "torch_checkpoints"))
    scene = {"height": 12, "width": 16, "focal": 14.0, "near": 2.0,
             "far": 6.0, "ndc": False, "ndc_variant": "canonical",
             "white_bkg": False, "n_coarse": 4, "n_fine": 4, "bf16": False,
             "pallas": "auto", "mlp": TINY}
    with open(os.path.join(run, "scene.json"), "w") as fp:
        json.dump(scene, fp)
    blob = {}
    for net, key in zip(("coarse", "fine"), split(PRNGKey(0))):
        p = init_nerf_params(key, NerfMLPConfig(**TINY))
        p["alpha"]["b"] += 1.0
        blob[net] = torch_state_dict_from_params(p)
    blob["step"] = 7
    torch.save(blob, os.path.join(run, "torch_checkpoints", "000007.pt"))
    return run


@pytest.fixture(scope="module")
def server_url(run_dir):
    args = build_parser().parse_args(["--run", run_dir, "--device", "cpu",
                                      "--chunk", "128", "--port", "0"])
    srv = make_server(renderer_from_args(args), "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def test_health(server_url):
    def health():
        with urllib.request.urlopen(server_url + "/health",
                                    timeout=30) as resp:
            return json.loads(resp.read())
    body = health()
    assert body["status"] == "ok" and body["step"] == 7
    assert (body["height"], body["width"]) == (12, 16)
    assert body["deterministic"] is True
    # The queue's counters: one more render is one more job, batch and
    # frame, and nothing refused.
    before = body["queue_stats"]
    assert set(before) == {"admitted", "rejected_full", "timed_out",
                           "failed", "batches", "frames",
                           "abandoned_skipped"}
    # The renderer's frame programs: none dropped from its cache.
    assert body["frame_stats"] == {"evictions": 0}
    _post(server_url + "/render", {"c2w": POSE}).read()
    after = health()["queue_stats"]
    assert {k: after[k] - before[k] for k in before} == {
        "admitted": 1, "rejected_full": 0, "timed_out": 0, "failed": 0,
        "batches": 1, "frames": 1, "abandoned_skipped": 0}


def test_render_png(server_url):
    with _post(server_url + "/render", {"c2w": POSE}) as resp:
        ctype = resp.headers["Content-Type"]
        data = resp.read()
    if ctype == "image/png":
        assert data[:4] == b"\x89PNG"
    else:   # no PNG encoder installed: the labelled PPM fallback
        assert ctype == "image/x-portable-pixmap" and data[:6] == b"P6\n16 "


def test_render_json_with_depth_is_deterministic(server_url):
    out = []
    for _ in range(2):
        with _post(server_url + "/render", {"c2w": POSE, "format": "json",
                                            "include_depth": True}) as resp:
            out.append(json.loads(resp.read()))
    assert out[0]["shape"] == [12, 16, 3]
    rgb = np.asarray(out[0]["rgb"], np.float32)
    assert np.isfinite(rgb).all() and rgb.std() > 1e-4
    assert np.asarray(out[0]["depth"]).shape == (12, 16)
    assert np.asarray(out[0]["acc"]).shape == (12, 16)
    assert out[0] == out[1]


def test_render_factor(server_url):
    with _post(server_url + "/render",
               {"c2w": POSE + [[0, 0, 0, 1.0]], "factor": 2,
                "format": "json"}) as resp:
        assert json.loads(resp.read())["shape"] == [6, 8, 3]


@pytest.mark.parametrize("payload,msg", [
    ({}, "c2w"),
    ({"c2w": [[1, 2], [3, 4]]}, "3,4"),
    ({"c2w": POSE, "format": "bmp"}, "png|json"),
    ({"c2w": POSE, "include_depth": True}, "format=json"),
])
def test_bad_requests_are_400(server_url, payload, msg):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server_url + "/render", payload)
    assert ei.value.code == 400
    assert msg in json.loads(ei.value.read())["error"].replace("'", "")


def test_unknown_paths_are_404(server_url):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(server_url + "/nope", timeout=30)
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server_url + "/nope", {})
    assert ei.value.code == 404


@pytest.mark.parametrize("flags,msg", [
    (["--occ_term", "0.001"], "need --occupancy"),
    (["--serve_fine", "64"], "need --occupancy"),
    (["--int8", "--int8_calib", "0"], "--int8_calib"),
    (["--int8", "--int8_bound", "0"], "--int8_bound must be positive"),
    (["--int8", "--int8_bound", "-2"], "--int8_bound must be positive"),
    (["--height", "8"], "drop --height"),
    (["--which", "best"], None),
])
def test_cli_refuses_what_it_cannot_serve(run_dir, flags, msg):
    argv = (["--ckpt", "x.pt", "--which", "best"] if msg is None
            else ["--run", run_dir, "--device", "cpu", *flags])
    with pytest.raises(SystemExit) as ei:
        main(argv)
    assert msg is None or msg in str(ei.value.code)


def test_cli_stochastic_serves_the_keyed_resample(run_dir):
    """``--stochastic`` serves the stochastic resample with ``PRNGKey(0)``
    (the JAX server's default seed): the same pose renders the same image
    twice, and it differs from the deterministic render."""
    r = renderer_from_args(build_parser().parse_args(
        ["--run", run_dir, "--device", "cpu", "--stochastic"]))
    assert not r.cfg.deterministic_resample
    det = renderer_from_args(build_parser().parse_args(
        ["--run", run_dir, "--device", "cpu"]))
    a, b = r.render_pose_extras(POSE), r.render_pose_extras(POSE)
    np.testing.assert_array_equal(a["rgb"], b["rgb"])
    assert not np.array_equal(a["depth"], det.render_pose_extras(POSE)["depth"])


def test_cli_requires_geometry_without_run():
    with pytest.raises(SystemExit) as ei:
        main(["--ckpt", "x.pt"])
    assert "--height" in str(ei.value.code)


def test_cli_int8_serves_renders(run_dir, capsys):
    """``--int8`` quantizes at startup through the step ``main`` runs and
    the server answers ``/render`` through the int8 path (its plain version
    on the CPU); the snapshot has no poses, so calibration uses the
    ``±--int8_bound`` cube."""
    defaults = build_parser().parse_args(["--run", run_dir])
    assert (defaults.int8, defaults.int8_calib, defaults.int8_bound) == (
        False, 1 << 17, None)
    args = build_parser().parse_args(
        ["--run", run_dir, "--device", "cpu", "--chunk", "128", "--port", "0",
         "--int8", "--int8_calib", "2048", "--int8_bound", "3.5"])
    renderer = renderer_from_args(args)
    int8_from_args(renderer, args)
    assert ("int8 quantized serving active (calibrated on 2048 samples via "
            "±3.5 cube)") in capsys.readouterr().out
    assert isinstance(renderer._nets["fine"], fq.QuantizedNerfWeights)
    srv = make_server(renderer, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        calls = fq.fused_nerf_int8_plain.calls
        with _post(url + "/render", {"c2w": POSE, "format": "json",
                                     "include_depth": True}) as resp:
            out = json.loads(resp.read())
        # 192 rays in chunks of 128: two chunks, a coarse and a fine pass each
        assert fq.fused_nerf_int8_plain.calls == calls + 4
        with _post(url + "/render", {"c2w": POSE}) as resp:
            assert resp.status == 200
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    rgb = np.asarray(out["rgb"], np.float32)
    assert out["shape"] == [12, 16, 3] and np.isfinite(rgb).all()
    assert np.asarray(out["depth"]).shape == (12, 16)
    renderer.calib_poses = np.asarray([POSE], np.float32)
    int8_from_args(renderer, args)
    assert "via run poses" in capsys.readouterr().out


OCC_FLAGS = ("occupancy", "occupancy_res", "occupancy_bound", "occ_interp",
             "occ_floor", "occ_term", "serve_coarse", "serve_fine")


def test_occupancy_flags_default_as_the_jax_server():
    """Every occupancy flag of the JAX server, with its default and choices
    (``--occ_interp`` is trilinear on the server, nearest in the CLI),
    and the JAX server's exit for the termination flags without
    ``--occupancy``."""
    from cvnerf_tpu.server import build_parser as jax_parser
    from cvnerf_tpu.server import main as jax_main
    ours, theirs = build_parser(), jax_parser()
    a, b = ours.parse_args([]), theirs.parse_args([])
    assert {k: getattr(a, k) for k in OCC_FLAGS} == {
        k: getattr(b, k) for k in OCC_FLAGS}
    assert a.occ_interp == "trilinear"
    choices = {x.dest: x.choices for x in ours._actions}
    assert all(choices[k] == {x.dest: x.choices
                              for x in theirs._actions}[k] for k in OCC_FLAGS)
    for flags in (["--occ_term", "0.01"], ["--serve_coarse", "8"]):
        with pytest.raises(SystemExit) as mine:
            main(["--ckpt", "x.pt", *flags])
        with pytest.raises(SystemExit) as jax_exit:
            jax_main(["--ckpt", "x.pt", *flags])
        assert str(mine.value.code) == str(jax_exit.value.code)


def test_cli_occupancy_serves_renders(run_dir, capsys):
    """``--occupancy full --occ_term --serve_coarse --serve_fine`` bakes at
    startup and the server answers ``/render`` through the grid: the fine
    pass alone per chunk (no coarse query), equal to the renderer's own
    render of the pose."""
    args = build_parser().parse_args(
        ["--run", run_dir, "--device", "cpu", "--chunk", "128", "--port", "0",
         "--occupancy", "full", "--occupancy_res", "16", "--occ_term", "1e-3",
         "--serve_coarse", "6", "--serve_fine", "8"])
    renderer = renderer_from_args(args)
    occupancy_from_args(renderer, args)
    assert ("occupancy grid active: mode=full res=16 interp=trilinear "
            "term=0.001 samples=6+8") in capsys.readouterr().out
    assert renderer.occupancy.values.shape == (16, 16, 16)
    want = renderer.render_pose_extras(POSE, keys=("rgb", "depth"))
    srv = make_server(renderer, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        calls = fm.fused_nerf_plain.calls
        with _post(url + "/render", {"c2w": POSE, "format": "json",
                                     "include_depth": True}) as resp:
            out = json.loads(resp.read())
        # 192 rays in chunks of 128: two chunks, a fine pass each
        assert fm.fused_nerf_plain.calls == calls + 2
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    np.testing.assert_allclose(np.asarray(out["rgb"], np.float32),
                               want["rgb"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out["depth"], np.float32),
                               want["depth"], rtol=0, atol=1e-5)
