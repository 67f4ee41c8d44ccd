"""Synthetic demo datasets (the port's own copy of the JAX package's
``data/synthetic.py``): tiny, multi-view-consistent analytic scenes written
in the exact Blender and LLFF on-disk formats the loaders ingest, and the
benchmarks' ``bench_scene``.

Bit for bit the JAX package's arrays and files' pixels; the PNGs go
through the port's own codec (``utils/png.py``), so a host without
``imageio`` writes every seeded fixture::

    python -m cvnerf_torch.data.synthetic --scene sphere --out data/demo_sphere

Scenes
------
* **sphere** (Blender format): an emissive sphere at the origin shaded by
  surface normal — band-limited content a reference-shaped NeRF can fit to
  >30 dB, the defect-sensitive fixture.
* **checker** (Blender format): the same sphere with a high-frequency
  spherical checkerboard — stresses the top positional-encoding bands.
* **llff_plane** (LLFF format): forward-facing cameras on small lateral
  offsets looking at a sinusoid-textured plane — the fern/NDC workload.
* **llff_360** (LLFF format): rings of inward-facing cameras around a
  checker sphere — the ``--spherify`` workload.

All randomness is seeded; the written datasets are bit-reproducible.
"""

from __future__ import annotations

import json
import os

import numpy as np

from cvnerf_torch.data.poses import pose_spherical
from cvnerf_torch.utils.png import write_png


def _ray_grid_np(h, w, focal, c2w):
    """Host-side pinhole ray grid (mirrors ops.rays.compute_rays, which
    mirrors reference main.py:19-46) — numpy so generation needs no jax."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    dirs = np.stack([(x - w * 0.5) / focal, -(y - h * 0.5) / focal,
                     -np.ones_like(x)], -1)
    dirs_w = np.einsum("hwk,jk->hwj", dirs, c2w[:3, :3])
    origins = np.broadcast_to(c2w[:3, -1], dirs_w.shape)
    return origins, dirs_w


def render_sphere_scene(h, w, focal, c2w, radius=1.0, texture="normals"):
    """Analytic render: an emissive sphere at the origin over white.

    ``texture="normals"`` colors by surface normal (smooth);
    ``texture="checker"`` adds a high-frequency checkerboard in spherical
    coordinates (stresses the upper positional-encoding bands).
    Returns float32 RGBA in [0, 1].
    """
    o, d = _ray_grid_np(h, w, focal, c2w)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    # |o + t d|^2 = r^2
    b = 2 * np.sum(o * d, -1)
    c = np.sum(o * o, -1) - radius ** 2
    disc = b ** 2 - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2, 0.0)
    p = o + t[..., None] * d
    normal = p / max(radius, 1e-9)
    rgb = np.clip(0.5 + 0.5 * normal, 0, 1).astype(np.float32)
    if texture == "checker":
        theta = np.arctan2(normal[..., 1], normal[..., 0])
        phi = np.arccos(np.clip(normal[..., 2], -1, 1))
        checker = ((np.floor(theta / np.pi * 8)
                    + np.floor(phi / np.pi * 8)) % 2)
        rgb = rgb * (0.35 + 0.65 * checker[..., None]).astype(np.float32)
    alpha = hit.astype(np.float32)[..., None]
    rgb = rgb * alpha  # premultiplied-style: background black under alpha 0
    return np.concatenate([rgb, alpha], -1)


def make_blender_dataset(basedir: str, n_train: int = 6, n_val: int = 2,
                         n_test: int = 2, h: int = 40, w: int = 40,
                         camera_angle_x: float = 0.8,
                         texture: str = "normals") -> None:
    """Write a Blender-format micro-scene (sphere at origin, cameras at r=4).

    On-disk layout matches what ``load_blender_data`` (and the reference
    loader, ``data_helpers.py:46-81``) expects: ``transforms_{split}.json``
    with ``camera_angle_x`` + per-frame ``file_path``/``transform_matrix``,
    RGBA PNGs under ``{split}/r_{i}.png``.
    """
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    rng = np.random.RandomState(0)
    for split, n in counts.items():
        frames = []
        os.makedirs(os.path.join(basedir, split), exist_ok=True)
        for i in range(n):
            theta = float(rng.uniform(-180, 180))
            phi = float(rng.uniform(-60, -10))
            pose = pose_spherical(theta, phi, 4.0)
            rgba = render_sphere_scene(h, w, focal, pose, texture=texture)
            rel = f"./{split}/r_{i}"
            write_png(os.path.join(basedir, f"{split}/r_{i}.png"),
                      (rgba * 255).astype(np.uint8))
            frames.append({"file_path": rel,
                           "transform_matrix": pose.tolist()})
        with open(os.path.join(basedir, f"transforms_{split}.json"),
                  "w") as fp:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames},
                      fp)


def bench_scene(h, w):
    """The benchmarks' 2-image synthetic scene, shape-identical to the lego
    training workload at ``(400, 400)``.

    Returns ``(images [2,h,w,3] float32, poses [2,3,4] float32)`` — a
    gradient+stripe texture, its vertical flip, and two identity-rotation
    cameras at z=4 (the blender-scene camera distance).
    """
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.stack([xx / w, yy / h, ((xx + yy) % 40) / 40.0],
                   -1).astype(np.float32)
    images = np.stack([img, img[::-1].copy()], 0)
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    poses[:, 2, 3] = 4.0
    return images, poses


def render_plane_scene(h, w, focal, c2w, plane_z=-2.0):
    """Analytic render: a textured plane at world z=plane_z (forward-facing).

    Returns float32 RGB in [0, 1].
    """
    o, d = _ray_grid_np(h, w, focal, c2w)
    t = (plane_z - o[..., 2]) / d[..., 2]
    p = o + t[..., None] * d
    u, v = p[..., 0], p[..., 1]
    rgb = np.stack([0.5 + 0.5 * np.sin(3 * u),
                    0.5 + 0.5 * np.cos(3 * v),
                    0.5 + 0.25 * np.sin(5 * (u + v))], -1)
    return np.clip(rgb, 0, 1).astype(np.float32)


def _llff_row(c2w, h, w, focal, near, far) -> np.ndarray:
    """One poses_bounds.npy row from a NeRF-convention [3,4] c2w.

    LLFF disk layout: rotation columns permuted [-y, x, z] relative to NeRF
    convention — the loader's fixup [y,-x,z] inverts this — with the [h,w,f]
    column appended and the two depth bounds at the end (reference
    data_helpers.py:119-132)."""
    pose_llff = np.concatenate(
        [-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:]], axis=1)
    hwf = np.array([[h], [w], [focal]], np.float64)
    return np.concatenate(
        [np.concatenate([pose_llff, hwf], 1).reshape(-1), [near, far]])


def make_llff_dataset(basedir: str, n: int = 9, h: int = 32, w: int = 40,
                      focal: float = 40.0) -> None:
    """Write an LLFF-format micro-scene: forward-facing cameras looking at a
    textured plane, `poses_bounds.npy` + `images/` exactly as COLMAP+LLFF
    tooling lays them out (reference data_helpers.py:115-132)."""
    imgdir = os.path.join(basedir, "images")
    os.makedirs(imgdir, exist_ok=True)
    rng = np.random.RandomState(1)
    rows = []
    for i in range(n):
        # Small lateral offsets, cameras at z=0 looking down -z.
        tx, ty = rng.uniform(-0.3, 0.3, 2)
        c2w = np.array([[1, 0, 0, tx],
                        [0, 1, 0, ty],
                        [0, 0, 1, 0.0]], np.float64)
        rgb = render_plane_scene(h, w, focal, c2w.astype(np.float32))
        write_png(os.path.join(imgdir, f"img_{i:03d}.png"),
                  (rgb * 255).astype(np.uint8))
        rows.append(_llff_row(c2w, h, w, focal, 1.5, 4.0))
    np.save(os.path.join(basedir, "poses_bounds.npy"), np.stack(rows, 0))


def _look_at(campos, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
    """NeRF-convention c2w (camera looks down its -z) from a position."""
    campos = np.asarray(campos, np.float64)
    z = campos - np.asarray(target, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, campos], axis=1)  # [3, 4]


def make_llff_360_dataset(basedir: str, n: int = 12, h: int = 40, w: int = 40,
                          focal: float = 50.0, radius: float = 4.0,
                          texture: str = "checker") -> None:
    """Write an LLFF-format 360-degree inward-facing capture: cameras on a
    ring around the origin looking at a textured sphere — the --spherify
    workload (reference parses the flag but ignores it, main.py:450).

    The sphere is composited over a WHITE surround, mirroring real captures
    where every pixel has scene content. A black-void background makes the
    scene untrainable for a reference-recipe NeRF at spherify's unit scale:
    rendering nothing exactly matches 3/4 of the pixels, the per-sample
    alpha gradient is tiny (delta ~= 0.013 after rescale), and sigma
    saturates negative (dead ReLU) — measured: acc stays exactly 0 through
    16k steps, eval frozen at the all-background 11.0 dB."""
    imgdir = os.path.join(basedir, "images")
    os.makedirs(imgdir, exist_ok=True)
    rows = []
    elevs = (0.4, 1.2, 2.2)                 # three rings for pose diversity
    for i in range(n):
        theta = 2 * np.pi * i / n
        elev = elevs[i % len(elevs)]
        campos = np.array([radius * np.cos(theta), radius * np.sin(theta),
                           elev])
        c2w = _look_at(campos)
        rgba = render_sphere_scene(h, w, focal, c2w.astype(np.float32),
                                   texture=texture)
        rgb = rgba[..., :3] + (1.0 - rgba[..., 3:])   # over white surround
        write_png(os.path.join(imgdir, f"img_{i:03d}.png"),
                  (rgb * 255).astype(np.uint8))
        dist = np.linalg.norm(campos)
        rows.append(_llff_row(c2w, h, w, focal, dist - 1.5, dist + 1.5))
    np.save(os.path.join(basedir, "poses_bounds.npy"), np.stack(rows, 0))


# --------------------------------------------------------------------------
# python -m cvnerf_torch.data.synthetic
# --------------------------------------------------------------------------

# Per-scene: (generator kwargs, suggested trainer flags). The suggested
# flags mirror scripts/quality_run.py's banded configurations so a demo
# run lands in known-good territory.
_SCENES = {
    "sphere": dict(
        kind="blender",
        gen=dict(n_train=40, n_val=2, n_test=4, h=200, w=200,
                 texture="normals"),
        train_flags="--dtype blender --white_bkg --testskip 1 "
                    "--precrop_iters 500 --precrop_frac 0.5",
        note="band-limited; trains past 30 dB test PSNR by ~3k steps",
    ),
    "checker": dict(
        kind="blender",
        gen=dict(n_train=10, n_val=2, n_test=4, h=100, w=100,
                 texture="checker"),
        train_flags="--dtype blender --white_bkg --testskip 1 "
                    "--precrop_iters 500 --precrop_frac 0.5",
        note="high-frequency texture; ~22 dB test ceiling is fixture "
             "aliasing, not model quality",
    ),
    "llff_plane": dict(
        kind="llff",
        gen=dict(n=12, h=96, w=128, focal=120.0),
        train_flags="--dtype llff --factor 1 --llffhold 8 --noise 1.0",
        note="forward-facing NDC workload (fern config shape)",
    ),
    "llff_360": dict(
        kind="llff_360",
        gen=dict(n=30, h=100, w=100, focal=120.0),
        train_flags="--dtype llff --factor 1 --llffhold 5 --spherify "
                    "--no_ndc --noise 1.0 --noise_decay 25000 --track_best",
        note="360-degree inward capture (--spherify); best-val checkpoint "
             "selection recommended (sparse-capture overfit)",
    ),
}


def generate(scene: str, out: str, **overrides) -> None:
    """Write the named demo scene under ``out``.

    ``overrides`` replace the scene's default generator kwargs (see
    ``_SCENES``); unknown keys raise TypeError from the generator.
    """
    if scene not in _SCENES:
        raise ValueError(f"unknown scene {scene!r}; "
                         f"choose from {sorted(_SCENES)}")
    spec = _SCENES[scene]
    kwargs = {**spec["gen"], **overrides}
    if spec["kind"] == "blender":
        make_blender_dataset(out, **kwargs)
    elif spec["kind"] == "llff":
        make_llff_dataset(out, **kwargs)
    else:
        make_llff_360_dataset(out, **kwargs)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m cvnerf_torch.data.synthetic",
        description="Generate a seeded synthetic demo dataset (no downloads "
                    "needed) in the Blender or LLFF on-disk format, ready "
                    "for python -m cvnerf_torch.cli.")
    ap.add_argument("--scene", default="sphere", choices=sorted(_SCENES),
                    help="which demo scene to write (default: sphere)")
    ap.add_argument("--out", required=True, help="output dataset directory")
    ap.add_argument("--views", type=int, default=None,
                    help="override the number of training views "
                         "(blender scenes) or total views (llff scenes)")
    ap.add_argument("--size", type=int, nargs=2, metavar=("H", "W"),
                    default=None, help="override image resolution")
    args = ap.parse_args(argv)

    overrides = {}
    if args.views is not None:
        if args.views < 1:
            ap.error("--views must be >= 1")
        key = "n_train" if _SCENES[args.scene]["kind"] == "blender" else "n"
        overrides[key] = args.views
    if args.size is not None:
        if min(args.size) < 8:
            ap.error("--size dimensions must be >= 8")
        overrides["h"], overrides["w"] = args.size

    os.makedirs(args.out, exist_ok=True)
    generate(args.scene, args.out, **overrides)

    spec = _SCENES[args.scene]
    print(f"wrote demo scene '{args.scene}' to {args.out}  ({spec['note']})")
    print("train it with:")
    print(f"  python -m cvnerf_torch.cli --data_dir {args.out} "
          f"--name {args.scene} "
          f"{spec['train_flags']} \\\n"
          f"      --n_rays 1024 --n_coarse_samples 64 --n_fine_samples 128 "
          f"--iters 3000")


if __name__ == "__main__":
    main()
