"""Isosurface extraction: trained density field → triangle mesh (port of
the JAX package's ``render/mesh.py``, ``cvnerf-mesh``)::

    python -m cvnerf_torch.render.mesh --run logs/lego [--res 256]

The density query is the occupancy bake's lattice query
(``render/occupancy.py``): the raw (pre-ReLU) sigma of one net at the
vertices of ``linspace(bbox_min, bbox_max, res)`` per axis, through the
forward kernel with zero view directions, chunk by chunk on the render
device (density does not depend on the view: the ``alpha`` head taps the
trunk before the view-direction concat). Surface extraction runs on the
host in exact vectorized numpy: marching tetrahedra over the Freudenthal
6-simplex decomposition of each cell, with a case table derived at import,
vertices welded by global lattice-edge id and triangles wound outward
(toward lower density). This numpy code is the JAX package's, kept here as
the port's own copy.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.render.occupancy import grid_spec, query_lattice

# ---------------------------------------------------------------------------
# Tetrahedron case table (derived, not transcribed)
# ---------------------------------------------------------------------------

# The 6 edges of a tetrahedron as local-vertex pairs, and the reverse map.
_TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_EDGE_INDEX = {frozenset(e): i for i, e in enumerate(_TET_EDGES)}

# Freudenthal decomposition: 6 tetrahedra per cell, one per axis-order path
# from the min corner to the max corner. Corner k of a cell is the offset
# (k & 1, k >> 1 & 1, k >> 2 & 1). Translation-invariant, hence conforming
# across neighboring cells.
_CUBE_TETS = np.array([
    [0, 1, 3, 7],   # x, y, z
    [0, 1, 5, 7],   # x, z, y
    [0, 2, 3, 7],   # y, x, z
    [0, 2, 6, 7],   # y, z, x
    [0, 4, 5, 7],   # z, x, y
    [0, 4, 6, 7],   # z, y, x
], dtype=np.int32)
_CORNER_OFFSETS = np.stack(
    [np.array([k & 1, (k >> 1) & 1, (k >> 2) & 1]) for k in range(8)]
).astype(np.int32)                                           # [8, 3]


def _build_tet_case_table() -> np.ndarray:
    """``[6, 16, 2, 3]`` oriented triangle table: (tet index, mask of
    above-iso vertices) → up to two triangles, each as three tet-edge
    indices (-1 padding), wound counter-clockwise seen from the below-iso
    (outward, low-density) side.

    Derivation: a tet edge crosses the surface iff its endpoints straddle
    iso. One vertex isolated (3 crossing edges) → one triangle; a 2–2 split
    (4 crossing edges) → a quad whose cyclic order is
    (a1,b1)(a1,b2)(a2,b2)(a2,b1) — consecutive edges share a tet vertex —
    split into two triangles.

    Winding is baked per (tet, mask, triangle) from edge-midpoint geometry:
    the sign of ``dot(normal, below_centroid - above_centroid)`` is
    invariant over all interpolation parameters in (0, 1) (the triangle
    separates the above vertices from the below vertices inside the tet and
    can only change orientation through a zero-area configuration), so the
    midpoint check fixes it exactly. The 6 Freudenthal tets are mirror
    images of alternating parity — which is why the table is per-tet — and
    positive axis scalings (grid spacing) preserve orientation, so unit-cell
    geometry suffices.
    """
    table = np.full((6, 16, 2, 3), -1, dtype=np.int32)
    corners = _CORNER_OFFSETS.astype(np.float64)
    for t, tet in enumerate(_CUBE_TETS):
        pos = corners[tet]                               # [4, 3] unit cell
        for mask in range(1, 15):
            above = [i for i in range(4) if mask >> i & 1]
            below = [i for i in range(4) if not mask >> i & 1]
            if len(above) == 1 or len(below) == 1:
                lone = above[0] if len(above) == 1 else below[0]
                others = [i for i in range(4) if i != lone]
                tris = [[_EDGE_INDEX[frozenset((lone, o))]
                         for o in others]]
            else:
                (a1, a2), (b1, b2) = above, below
                quad = [_EDGE_INDEX[frozenset(p)]
                        for p in ((a1, b1), (a1, b2), (a2, b2), (a2, b1))]
                tris = [[quad[0], quad[1], quad[2]],
                        [quad[0], quad[2], quad[3]]]
            axis = pos[below].mean(0) - pos[above].mean(0)
            for slot, tri in enumerate(tris):
                mid = np.stack([pos[list(_TET_EDGES[e])].mean(0)
                                for e in tri])
                normal = np.cross(mid[1] - mid[0], mid[2] - mid[0])
                side = float(np.dot(normal, axis))
                assert side != 0.0, (t, mask, tri)  # midpoints: generic
                table[t, mask, slot] = (tri if side > 0
                                        else [tri[0], tri[2], tri[1]])
    return table


_TET_CASES = _build_tet_case_table()


# ---------------------------------------------------------------------------
# Marching tetrahedra (host, exact vectorized numpy)
# ---------------------------------------------------------------------------

def marching_tetrahedra(grid: np.ndarray, iso: float,
                        origin=(0.0, 0.0, 0.0),
                        spacing=(1.0, 1.0, 1.0),
                        slab: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Extract the ``grid > iso`` isosurface as a welded triangle mesh.

    Args:
        grid: ``[X, Y, Z]`` scalar field sampled on a regular lattice
            (``ij`` indexing: vertex ``(i,j,k)`` sits at
            ``origin + (i,j,k) * spacing``).
        iso: isovalue; "inside" is strictly greater.
        slab: cells processed per batch along x (memory bound, exactness
            unaffected — welding is by global edge id across slabs).

    Returns:
        ``(verts [V,3] float32, faces [F,3] int32)``. Vertices are welded
        exactly (one vertex per crossed lattice edge); triangles wind
        counter-clockwise seen from outside (lower-density side).
    """
    grid = np.asarray(grid, np.float32)
    if grid.ndim != 3 or min(grid.shape) < 2:
        raise ValueError(f"grid must be [X>=2, Y>=2, Z>=2], got {grid.shape}")
    nx, ny, nz = grid.shape
    flat = grid.reshape(-1)
    tet_range = np.arange(6, dtype=np.int32)[None, :]
    edge_pairs = []

    for x0 in range(0, nx - 1, slab):
        x1 = min(x0 + slab, nx - 1)
        # Cell min-corner lattice coordinates for this slab: [n_cells, 3].
        ci, cj, ck = np.meshgrid(np.arange(x0, x1), np.arange(ny - 1),
                                 np.arange(nz - 1), indexing="ij")
        cells = np.stack([ci, cj, ck], -1).reshape(-1, 3).astype(np.int32)
        # Global flat vertex ids of each cell's 8 corners: [n_cells, 8].
        corner_coords = cells[:, None, :] + _CORNER_OFFSETS[None]
        gid = (corner_coords[..., 0] * ny + corner_coords[..., 1]) * nz \
            + corner_coords[..., 2]
        # Per-tet corner ids and above-iso masks: [n_cells, 6, 4].
        tet_gid = gid[:, _CUBE_TETS]
        tet_above = flat[tet_gid] > iso
        mask = (tet_above << np.arange(4, dtype=np.int32)).sum(-1)
        tris = _TET_CASES[tet_range, mask]            # [n_cells, 6, 2, 3]
        has_tri = tris[..., 0] >= 0                   # [n_cells, 6, 2]
        c_id, t_id, _ = np.nonzero(has_tri)
        if c_id.size == 0:
            continue
        tri_edges = tris[has_tri]                     # [n_tris, 3] edge idx
        corners = tet_gid[c_id, t_id]                 # [n_tris, 4] global ids
        # Triangle vertices as global lattice-edge endpoint pairs; the
        # welded pair key is order-free, so sorting loses nothing — the
        # winding already lives in the per-tet oriented case table.
        te = np.asarray(_TET_EDGES, np.int32)[tri_edges]   # [n_tris, 3, 2]
        pair = np.take_along_axis(
            corners[:, None, :].repeat(3, 1).reshape(-1, 4),
            te.reshape(-1, 2), axis=1)                # [n_tris*3, 2]
        edge_pairs.append(np.sort(pair, axis=1))

    if not edge_pairs:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    pairs = np.concatenate(edge_pairs)                # [n_tris*3, 2]

    # Exact weld: one mesh vertex per unique crossed lattice edge.
    uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)

    origin = np.asarray(origin, np.float32)
    spacing = np.asarray(spacing, np.float32)

    def lattice_pos(ids: np.ndarray) -> np.ndarray:
        i, rem = np.divmod(ids.astype(np.int64), ny * nz)
        j, k = np.divmod(rem, nz)
        return origin + np.stack([i, j, k], -1).astype(np.float32) * spacing

    va, vb = flat[uniq[:, 0]], flat[uniq[:, 1]]
    # Crossing edges straddle iso strictly on the ">" side, so vb != va.
    t = np.clip((iso - va) / (vb - va), 0.0, 1.0)[:, None]
    verts = lattice_pos(uniq[:, 0]) * (1 - t) + lattice_pos(uniq[:, 1]) * t
    return verts.astype(np.float32), faces


# ---------------------------------------------------------------------------
# Density grid query (device, chunked through the forward kernel)
# ---------------------------------------------------------------------------

def query_density_grid(net_params: dict, mlp: NerfMLPConfig,
                       bbox_min, bbox_max, resolution,
                       chunk: int = 65536,
                       compute_dtype: torch.dtype = torch.float32,
                       kernels: str = "on") -> np.ndarray:
    """Raw density of ONE net (``params["fine"]`` or ``["coarse"]``) on a
    regular grid, ``[X, Y, Z]`` float32 on the host: the bake's lattice
    query before its ReLU, on the net's device (``kernels="off"``: the
    plain MLP). The raw field keeps the gradient information below zero
    for isovalue exploration; any iso > 0 threshold is the same either
    way."""
    res, lo, hi = grid_spec(bbox_min, bbox_max, resolution)
    return query_lattice(net_params, mlp, res, lo, hi, chunk, compute_dtype,
                         kernels).cpu().numpy()


def largest_component(verts: np.ndarray, faces: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Keep only the largest connected surface component.

    Density noise (the reference's own regularizer, main.py:186-191)
    leaves small floater blobs in trained fields; measured on the 3k-step
    sphere fixture the main surface holds >99.8% of the faces and the
    rest is ~90 tiny shells. Unreferenced vertices are dropped and faces
    reindexed.
    """
    if len(faces) == 0:
        return verts[:0], faces
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    adj = coo_matrix((np.ones(len(e), np.int8), (e[:, 0], e[:, 1])),
                     shape=(len(verts), len(verts)))
    n, label = connected_components(adj, directed=False)
    keep = label == np.bincount(label, minlength=n).argmax()
    faces = faces[keep[faces[:, 0]]]
    remap = np.cumsum(keep) - 1
    return verts[keep], remap[faces].astype(np.int32)


def extract_mesh(params: dict, mlp: NerfMLPConfig, *,
                 net: str = "fine",
                 bbox_min=(-1.5, -1.5, -1.5), bbox_max=(1.5, 1.5, 1.5),
                 resolution: int = 256, iso: float = 50.0,
                 chunk: int = 65536,
                 compute_dtype: torch.dtype = torch.float32,
                 keep: str = "all", kernels: str = "on",
                 timings: dict | None = None,
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Grid-sample ``params[net]``'s density and mesh the ``> iso`` surface.

    Returns ``(verts [V,3], faces [F,3])`` in scene coordinates (NDC
    coordinates for an NDC-trained model: pass the NDC box). ``iso=50`` is
    the customary NeRF density threshold for opaque surfaces. A
    ``timings`` dict receives the seconds of the grid query
    (``"query_s"``, the device synchronized) and of the host marching
    pass (``"march_s"``).
    """
    if net not in params:
        raise KeyError(f"params has no {net!r} network "
                       f"(available: {sorted(params)})")
    if keep not in ("all", "largest"):
        raise ValueError(f"keep must be 'all' or 'largest', got {keep!r}")
    t0 = time.perf_counter()
    grid = query_density_grid(params[net], mlp, bbox_min, bbox_max,
                              resolution, chunk=chunk,
                              compute_dtype=compute_dtype, kernels=kernels)
    t1 = time.perf_counter()
    res = np.broadcast_to(np.asarray(resolution, np.int32), (3,))
    lo = np.asarray(bbox_min, np.float32)
    hi = np.asarray(bbox_max, np.float32)
    spacing = (hi - lo) / (res - 1).astype(np.float32)
    verts, faces = marching_tetrahedra(grid, iso, origin=lo,
                                       spacing=spacing)
    if keep == "largest":
        verts, faces = largest_component(verts, faces)
    if timings is not None:
        timings.update(query_s=t1 - t0, march_s=time.perf_counter() - t1)
    return verts, faces


# ---------------------------------------------------------------------------
# OBJ output + CLI
# ---------------------------------------------------------------------------

def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a minimal Wavefront OBJ (1-indexed faces)."""
    with open(path, "w") as fp:
        fp.write(f"# cvnerf_torch mesh: {len(verts)} verts, "
                 f"{len(faces)} faces\n")
        np.savetxt(fp, verts, fmt="v %.6f %.6f %.6f")
        np.savetxt(fp, np.asarray(faces) + 1, fmt="f %d %d %d")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cvnerf_torch.render.mesh",
        description="Extract a triangle mesh from a trained run's density "
                    "field (the reference has no geometry export).")
    p.add_argument("--run", required=True,
                   help="training run directory (reads scene.json + "
                        "torch_checkpoints/, as the server's --run does)")
    p.add_argument("--out", default=None,
                   help="output .obj path (default: <run>/mesh.obj)")
    p.add_argument("--net", default="fine", choices=["fine", "coarse"],
                   help="which network's density to mesh (default fine)")
    p.add_argument("--res", type=int, default=256,
                   help="grid resolution per axis")
    p.add_argument("--iso", type=float, default=50.0,
                   help="density isovalue (raw sigma)")
    p.add_argument("--bound", type=float, default=1.5,
                   help="half-width of the sampling cube around the origin "
                        "(ignored for NDC runs, which use the NDC box)")
    p.add_argument("--chunk", type=int, default=65536,
                   help="grid points per forward-kernel launch")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--which", default="auto",
                   choices=["auto", "best", "last"],
                   help="which model to mesh: 'auto' uses the best-val "
                        "checkpoint when the run tracked one "
                        "(--track_best), else the last periodic one")
    p.add_argument("--keep", default="all", choices=["all", "largest"],
                   help="'largest' drops floater components (small "
                        "density-noise shells), keeping the main surface")
    p.add_argument("--device", default="cuda",
                   help="torch device of the density query (default cuda; "
                        "raises when CUDA is missing — pass cpu explicitly)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # The serving loader: scene.json gives the architecture, dtype and NDC
    # mode, torch_checkpoints/ the weights.
    from cvnerf_torch.serve import NerfRenderer
    r = NerfRenderer.from_run_dir(args.run, step=args.step, which=args.which,
                                  device=args.device, use_mesh=False)
    net = args.net
    if net == "fine" and r.cfg.n_fine == 0:
        print("n_fine=0 run: meshing the coarse network")
    timings = {}
    verts, faces = r.extract_mesh(net=net, resolution=args.res,
                                  iso=args.iso, bound=args.bound,
                                  chunk=args.chunk, keep=args.keep,
                                  timings=timings)
    out = args.out or os.path.join(args.run, "mesh.obj")
    save_obj(out, verts, faces)
    print(f"wrote {out}: {len(verts)} verts, {len(faces)} faces "
          f"(res {args.res}, iso {args.iso}, step {r.step}; grid query "
          f"{timings['query_s']:.3f} s, marching {timings['march_s']:.3f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
