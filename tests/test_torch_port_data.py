"""The port's data path against the JAX package's and the libraries it
replaces: the PNG codec against ``imageio`` (bitwise), ``area_resize``
against ``cv2.resize(INTER_AREA)`` (bitwise, except a 1-channel float
2 × 2 box, where OpenCV's scalar tail adds in another order: 1 ulp), the
scene loaders and generators against the JAX package's (bitwise), the pose
functions (bitwise), the metrics (exact) and ``write_video``'s PNG
fallback on a host without ``imageio`` or ``cv2`` (bitwise).
"""

import dataclasses
import json
import os
import struct
import sys
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from cvnerf_torch.data import poses as tposes
from cvnerf_torch.data import synthetic as tsyn
from cvnerf_torch.data.datasets import load_scene
from cvnerf_torch.utils import image as timage
from cvnerf_torch.utils.metrics import MetricsLogger
from cvnerf_torch.utils.png import read_image, read_png, write_png
from cvnerf_torch.utils.resize import area_resize
from cvnerf_tpu.data import load_scene as jax_load_scene
from cvnerf_tpu.data import poses as jposes
from cvnerf_tpu.data import synthetic as jsyn
from cvnerf_tpu.utils import image as jimage
from cvnerf_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: these runs are many tiny ops, as fast on one
    thread, and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(h, w, c, seed=0):
    """Smooth content plus noise, so every row filter has work to do."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    chans = [(3 * x + (k + 1) * y + rng.randint(0, 30, (h, w))) % 256
             for k in range(c)]
    img = np.stack(chans, -1).astype(np.uint8)
    return img[..., 0] if c == 1 else img


# ---------- PNG ----------

@pytest.mark.parametrize("c", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb",
                                                  "rgba"])
def test_read_png_matches_imageio_on_imageio_files(tmp_path, c):
    path = str(tmp_path / "a.png")
    imageio.imwrite(path, _img(23, 31, c))
    want = imageio.imread(path)
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_read_png_matches_imageio_on_pil_files(tmp_path, mode):
    """PIL picks a filter per row (None, Sub, Up, Paeth on this content);
    a palette image expands to RGB, as imageio expands it."""
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 3}[mode]
    img = Image.fromarray(_img(40, 52, c, seed=1))
    if mode == "P":
        img = img.convert("P", palette=Image.ADAPTIVE, colors=60)
    path = str(tmp_path / "p.png")
    img.save(path)
    np.testing.assert_array_equal(read_png(path), imageio.imread(path))


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """A PNG of ``img`` whose row ``y`` is filtered ``filters[y]``,
    straight from the PNG specification, byte by byte."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c).astype(int)
    raw = bytearray()
    for y in range(h):
        f = filters[y]
        raw.append(f)
        for i in range(w * c):
            a = rows[y, i - c] if i >= c else 0
            b = rows[y - 1, i] if y > 0 else 0
            cc = rows[y - 1, i - c] if (y > 0 and i >= c) else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc
                                                          else cc)
            raw.append((rows[y, i] - pred) % 256)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_read_png_decodes_each_row_filter(tmp_path, filters):
    img = _img(11, 13, 3, seed=2)
    per_row = ([filters] * 11 if filters != "mixed"
               else [3, 4, 4, 1, 3, 0, 2, 4, 3, 3, 1])
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, per_row))
    np.testing.assert_array_equal(imageio.imread(str(path)), img)
    np.testing.assert_array_equal(read_png(str(path)), img)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_imageio_reads_the_port_writer_bitwise(tmp_path, c):
    img = _img(29, 17, c, seed=3)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_read_png_refuses_what_it_does_not_decode(tmp_path):
    path = str(tmp_path / "16.png")
    imageio.imwrite(path, (np.arange(64, dtype=np.uint16) * 1000)
                    .reshape(8, 8))
    with pytest.raises(ValueError, match="only 8-bit"):
        read_png(path)
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, np.zeros((4, 4), np.float32))


def test_read_image_reads_a_jpeg_only_through_imageio(tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "v.jpg")
    imageio.imwrite(path, _img(16, 16, 3))
    np.testing.assert_array_equal(read_image(path), imageio.imread(path))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(RuntimeError, match="v.jpg.*imageio"):
        read_image(path)


# ---------- area resize ----------

def _cv2(img, size):
    return cv2.resize(img, size, interpolation=cv2.INTER_AREA)


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("hw", [(40, 40), (64, 90), (800, 800)])
def test_area_resize_float_half_is_bitwise(hw, c):
    img = np.random.RandomState(0).rand(*hw, c).astype(np.float32)
    size = (hw[1] // 2, hw[0] // 2)
    got = area_resize(img, size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _cv2(img, size))


def test_area_resize_float_half_one_channel_within_one_ulp():
    """OpenCV's vector path adds a 2 × 2 box's two row pairs first; the
    scalar tail of a row (lanes left over) adds in row-major order. The
    port follows the vector path, so tail pixels may differ by 1 ulp
    (with OpenCV 5.0 on x86-64: at most 5.96e-8, on 1.3% of a 35-wide
    row's pixels)."""
    img = np.random.RandomState(1).rand(64, 70).astype(np.float32)
    got, want = area_resize(img, (35, 32)), _cv2(img, (35, 32))
    assert got.shape == want.shape
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("src,factor", [((37, 53), 2.0), ((100, 130), 8),
                                        ((96, 128), 3), ((41, 47), 2.5),
                                        ((90, 120), 3),
                                        ((96, 128), 8), ((80, 80), 2)])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_area_resize_matches_cv2(src, factor, dtype, c):
    """Fractional-area weights (non-integer factors) and integer boxes,
    as the LLFF loader's ``--factor`` resizes uint8 images."""
    rng = np.random.RandomState(2)
    shape = src if c == 1 else (*src, c)
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    if dtype == np.float32:
        img = (img / 255.0).astype(np.float32)
    size = (int(src[1] / factor), int(src[0] / factor))
    got, want = area_resize(img, size), _cv2(img, size)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.float32 and c == 1 and factor == 2:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:
        np.testing.assert_array_equal(got, want)


def test_area_resize_same_size_is_a_copy():
    img = _img(9, 7, 3)
    out = area_resize(img, (7, 9))
    np.testing.assert_array_equal(out, img)
    assert out is not img


# ---------- poses ----------

def test_pose_functions_match_jax():
    rng = np.random.RandomState(4)
    for t, p, r in ((30.0, -30.0, 4.0), (-170.0, -10.0, 2.5)):
        np.testing.assert_array_equal(tposes.pose_spherical(t, p, r),
                                      jposes.pose_spherical(t, p, r))
    np.testing.assert_array_equal(tposes.spherical_render_poses(),
                                  jposes.spherical_render_poses())
    z, up, pos = rng.randn(3), rng.randn(3), rng.randn(3)
    np.testing.assert_array_equal(tposes.view_matrix(z, up, pos),
                                  jposes.view_matrix(z, up, pos))
    poses = np.concatenate([rng.randn(9, 3, 4), np.tile(
        [[[40.0], [50.0], [60.0]]], (9, 1, 1))], 2).astype(np.float32)
    for fn in ("average_pose", "recenter_poses"):
        np.testing.assert_array_equal(getattr(tposes, fn)(poses),
                                      getattr(jposes, fn)(poses))
    bounds = rng.rand(9, 2).astype(np.float32) + 1.0
    for a, b in zip(tposes.spherify_poses(poses, bounds),
                    jposes.spherify_poses(poses, bounds)):
        np.testing.assert_array_equal(a, b)
    c2w = jposes.average_pose(poses)
    np.testing.assert_array_equal(
        tposes.spiral_render_path(c2w, up, np.abs(pos), 3.0),
        jposes.spiral_render_path(c2w, up, np.abs(pos), 3.0))


# ---------- scene loading ----------

@pytest.fixture(scope="module")
def jax_scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_scenes")
    jsyn.make_blender_dataset(str(d / "blender"), n_train=3, n_val=2,
                              n_test=3, h=40, w=40)
    jsyn.make_blender_dataset(str(d / "blender_odd"), n_train=2, n_val=0,
                              n_test=2, h=37, w=53, texture="checker")
    jsyn.make_llff_dataset(str(d / "llff"), n=9, h=32, w=40)
    jsyn.make_llff_360_dataset(str(d / "llff_360"), n=10, h=40, w=40)
    return d


def _assert_scenes_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, f.name


BLENDER_CASES = [dict(half_res=False, testskip=1, white_bkg=True),
                 dict(half_res=True, testskip=1, white_bkg=True),
                 dict(half_res=True, testskip=2, white_bkg=False),
                 dict(half_res=False, testskip=0, white_bkg=False)]


@pytest.mark.parametrize("kw", BLENDER_CASES,
                         ids=["plain", "half_res", "half_skip_black",
                              "skip0"])
@pytest.mark.parametrize("name", ["blender", "blender_odd"])
def test_load_blender_scene_matches_jax(jax_scenes, name, kw):
    path = str(jax_scenes / name)
    _assert_scenes_equal(load_scene(path, "blender", **kw),
                         jax_load_scene(path, "blender", **kw))


LLFF_CASES = [dict(factor=1), dict(factor=2), dict(factor=3),
              dict(factor=8, no_ndc=True), dict(factor=2, spherify=True),
              dict(factor=0, llffhold=0), dict(factor=1, llffhold=3)]


@pytest.mark.parametrize("kw", LLFF_CASES,
                         ids=["f1", "f2", "f3", "f8_no_ndc", "spherify",
                              "hold0", "hold3"])
@pytest.mark.parametrize("name", ["llff", "llff_360"])
def test_load_llff_scene_matches_jax(jax_scenes, name, kw):
    path = str(jax_scenes / name)
    _assert_scenes_equal(load_scene(path, "llff", **kw),
                         jax_load_scene(path, "llff", **kw))


def test_load_scene_refuses_an_unknown_dtype(jax_scenes):
    with pytest.raises(ValueError, match="invalid dtype"):
        load_scene(str(jax_scenes / "blender"), "colmap")


@pytest.mark.parametrize("scene", ["sphere", "checker", "llff_plane",
                                   "llff_360"])
def test_port_generators_write_the_jax_scenes(tmp_path, scene):
    """Both generators write the same pixels and the same metadata, and
    both packages load the port's files to the same arrays."""
    size = dict(h=24, w=32) if scene != "llff_plane" else dict(h=24, w=32,
                                                               focal=30.0)
    count = {"sphere": dict(n_train=3), "checker": dict(n_train=2),
             "llff_plane": dict(n=9), "llff_360": dict(n=6)}[scene]
    tsyn.generate(scene, str(tmp_path / "t"), **size, **count)
    jsyn.generate(scene, str(tmp_path / "j"), **size, **count)
    files = sorted(os.path.relpath(os.path.join(dp, f), tmp_path / "j")
                   for dp, _, fs in os.walk(tmp_path / "j") for f in fs)
    for rel in files:
        t, j = str(tmp_path / "t" / rel), str(tmp_path / "j" / rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(imageio.imread(t),
                                          imageio.imread(j), err_msg=rel)
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(t), np.load(j))
        else:
            assert json.load(open(t)) == json.load(open(j)), rel
    kind = "blender" if scene in ("sphere", "checker") else "llff"
    kw = dict(factor=1) if kind == "llff" else dict(testskip=1)
    _assert_scenes_equal(load_scene(str(tmp_path / "t"), kind, **kw),
                         jax_load_scene(str(tmp_path / "t"), kind, **kw))


def test_generator_cli_writes_a_scene(tmp_path, capsys):
    tsyn.main(["--scene", "sphere", "--out", str(tmp_path / "s"),
               "--views", "2", "--size", "16", "16"])
    assert "python -m cvnerf_torch.cli" in capsys.readouterr().out
    scene = load_scene(str(tmp_path / "s"), "blender", testskip=1)
    assert scene.images.shape == (8, 16, 16, 3)


# ---------- metrics and image output ----------

def test_psnr_and_ssim_match_jax():
    rng = np.random.RandomState(5)
    a = rng.rand(21, 17, 3).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.05, 0, 1)
    assert timage.psnr_images(a, b) == jimage.psnr_images(a, b)
    assert timage.ssim_images(a, b) == jimage.ssim_images(a, b)
    assert timage.psnr(0.0) == jimage.psnr(0.0)
    with pytest.raises(ValueError):
        timage.ssim_images(a, b[:-1])


def test_write_png_matches_jax(tmp_path):
    rgb = np.random.RandomState(6).rand(9, 11, 3).astype(np.float32)
    timage.write_png(str(tmp_path / "t" / "a.png"), rgb)
    jimage.write_png(str(tmp_path / "j" / "a.png"), rgb)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "t" / "a.png"),
                                  imageio.imread(tmp_path / "j" / "a.png"))


def test_write_video_falls_back_to_png_frames_without_imageio_or_cv2(
        tmp_path, monkeypatch):
    """On a host with neither library, the PNG-directory fallback writes
    every frame through the port's codec (it imported imageio once, and
    raised ModuleNotFoundError there)."""
    for name in ("imageio", "imageio.v2", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    frames = np.random.RandomState(7).rand(3, 10, 12, 3).astype(np.float32)
    out = timage.write_video(str(tmp_path / "v" / "x.mp4"), frames)
    assert out == str(tmp_path / "v" / "x.mp4") + ".frames"
    names = sorted(os.listdir(out))
    assert names == ["000.png", "001.png", "002.png"]
    for i, name in enumerate(names):
        np.testing.assert_array_equal(read_png(os.path.join(out, name)),
                                      timage.to_byte(frames[i]))


def test_metrics_logger_writes_the_jax_records(tmp_path, capsys):
    def records(cls, d):
        log = cls(str(tmp_path / d), enable_tensorboard=False)
        log.log(10, loss=np.float32(0.25), psnr=12.5, rays_per_sec=1e3,
                lr=np.float32(4e-4), grad_norm=0.5)
        log.log(10, val_psnr=11.0, val_views=2)
        log.log_image(10, "val_render", np.zeros((4, 4, 3)))
        log.close()
        recs = [json.loads(line)
                for line in open(tmp_path / d / "metrics.jsonl")]
        for r in recs:
            r.pop("time")
        return recs, capsys.readouterr().out
    assert records(MetricsLogger, "t") == records(JaxMetricsLogger, "j")
