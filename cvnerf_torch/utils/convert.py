"""Checkpoint conversion (port of the JAX package's ``utils/convert.py``:
state_dict mapping, ``.pt`` loader, importer and exporter), and the
carry-over of params, int8 params and train states from the JAX package.

The port serves the plain-tensor two-net ``.pt`` that the JAX tool writes
(``cvnerf-import --export <run>/checkpoints <file>.pt``: ``{"coarse": sd,
"fine": sd, "step": N}``) and the reference's own ``.pt`` layouts. A
state_dict holds reference-``Model`` ``nn.Linear`` layers ``l1``..``l11``
and ``l_alpha`` with ``weight`` ``[out, in]``; the port's params keep the
JAX layout ``{"w": [in, out], "b": [out]}``.

The command line (the JAX package's ``cvnerf-import``, same flags and
messages)::

    python -m cvnerf_torch.utils.convert reference.pt logs/imported \
        [--step N] [--height H --width W --focal F --near N --far F]
    python -m cvnerf_torch.utils.convert --export logs/run/torch_checkpoints \
        out.pt [--step N]

Import writes the port's own full checkpoint,
``<dst>/torch_checkpoints/<step:06d>.pt`` (the params, a fresh Adam state,
the stamped step), which ``--ft_path``, a resume and ``--run`` serving
take; with all five geometry flags also ``<dst>/scene.json``. Export
writes the two-net plain-tensor ``.pt`` of a run's checkpoint.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.quantize import QuantizedNerfParams

# our layer name -> reference nn.Module attribute
_NAME_MAP = {
    "l1": "l1", "l2": "l2", "l3": "l3", "l4": "l4", "l5": "l5",
    "l6": "l6", "l7": "l7", "l8": "l8", "l9": "l9",
    "alpha": "l_alpha", "l10": "l10", "l11": "l11",
}

# (coarse, fine) key pairs seen in the wild for two-net NeRF checkpoints.
_NET_KEY_PAIRS = [
    ("coarse", "fine"),
    ("model", "model_fine"),
    ("network_fn", "network_fine"),
    ("network_fn_state_dict", "network_fine_state_dict"),
    ("coarse_model", "fine_model"),
]


def _as_state_dict(obj) -> dict | None:
    """Normalize a candidate network entry to a flat state_dict."""
    if obj is None:
        return None
    if hasattr(obj, "state_dict"):          # a live nn.Module
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and any(k.endswith(".weight") for k in obj):
        return obj
    return None


def params_from_torch_state_dict(sd: dict) -> tuple[dict, NerfMLPConfig]:
    """One reference-``Model`` state_dict → (params, inferred cfg), on the
    CPU in fp32. Widths and encoding bands are read off the shapes."""
    params = {}
    for ours, theirs in _NAME_MAP.items():
        try:
            w = torch.as_tensor(sd[f"{theirs}.weight"]).detach()
            b = torch.as_tensor(sd[f"{theirs}.bias"]).detach()
        except KeyError as e:
            raise KeyError(
                f"state_dict is missing {e.args[0]!r} — not a reference "
                f"Model checkpoint (expected Linear layers "
                f"{sorted(set(_NAME_MAP.values()))})") from None
        params[ours] = {"w": w.float().cpu().t().contiguous(),
                        "b": b.float().cpu().clone()}

    xyz_dim, trunk = params["l1"]["w"].shape
    head = params["l10"]["w"].shape[1]
    dir_dim = params["l10"]["w"].shape[0] - trunk
    for name, dim in (("xyz", xyz_dim), ("dir", dir_dim)):
        if (dim - 3) % 6:
            raise ValueError(
                f"{name} encoding input dim {dim} is not 3 + 6*L — "
                "not a frequency-encoded reference checkpoint")
    cfg = NerfMLPConfig(xyz_freqs=(xyz_dim - 3) // 6,
                        dir_freqs=(dir_dim - 3) // 6,
                        trunk_width=trunk, head_width=head)
    expect = {"l6": (trunk + xyz_dim, trunk), "l9": (trunk, trunk),
              "alpha": (trunk, 1), "l11": (head, 3)}
    for name, shape in expect.items():
        got = tuple(params[name]["w"].shape)
        if got != shape:
            raise ValueError(
                f"layer {name}: weight shape {got} != {shape} expected "
                f"for the inferred architecture {cfg}")
    return params, cfg


def load_torch_checkpoint(path: str, prefer_ema: bool = True,
                          allow_pickle: bool = False
                          ) -> tuple[dict, NerfMLPConfig, int | None]:
    """A ``.pt`` file → ``({"coarse": ..., "fine": ...}, cfg, step)``.

    Loads with ``weights_only=True``: only plain tensors, no pickled code.
    Checkpoints that pickled live ``nn.Module`` objects need
    ``allow_pickle=True``, which runs their pickle code: only use it on
    checkpoints you trust. ``step`` is the file's ``"step"`` entry, or
    None when it has none. A single-net checkpoint serves as both nets. A
    checkpoint of an EMA run (the port's trainer stores the Polyak average
    under ``"ema_params"``) gives the average, its deployable model,
    unless ``prefer_ema=False``.
    """
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_pickle:
            raise ValueError(
                f"{path} is not a plain-tensor checkpoint (weights_only "
                f"load failed: {e}). If you trust its source, retry with "
                "allow_pickle=True / --allow_pickle (this executes the "
                "file's pickle code).") from e
        blob = torch.load(path, map_location="cpu", weights_only=False)
    if prefer_ema and isinstance(blob, dict) and \
            isinstance(blob.get("ema_params"), dict):
        blob = {**blob["ema_params"], "step": blob.get("step")}
    coarse = fine = None
    if isinstance(blob, dict):
        for ck, fk in _NET_KEY_PAIRS:
            c = _as_state_dict(blob.get(ck))
            if c is not None:
                coarse, fine = c, _as_state_dict(blob.get(fk))
                break
    if coarse is None:
        coarse = _as_state_dict(blob)
    if coarse is None:
        raise ValueError(
            f"{path}: unrecognized checkpoint layout — expected a "
            f"state_dict or a dict holding one under {_NET_KEY_PAIRS}")

    params_c, cfg = params_from_torch_state_dict(coarse)
    if fine is not None:
        params_f, cfg_f = params_from_torch_state_dict(fine)
        if cfg_f != cfg:
            raise ValueError(
                f"coarse/fine architectures disagree: {cfg} vs {cfg_f}")
    else:
        params_f = params_c
    step = blob.get("step") if isinstance(blob, dict) else None
    return ({"coarse": params_c, "fine": params_f}, cfg,
            None if step is None else int(step))


def torch_state_dict_from_params(params: dict) -> dict:
    """One net's params → a reference-``Model`` state_dict (weights back to
    ``[out, in]``)."""
    sd = {}
    for ours, theirs in _NAME_MAP.items():
        sd[f"{theirs}.weight"] = params[ours]["w"].detach().float().cpu().t().contiguous()
        sd[f"{theirs}.bias"] = params[ours]["b"].detach().float().cpu().clone()
    return sd


def params_from_jax(tree: dict, device: str | torch.device = "cpu") -> dict:
    """A numpy pytree of the JAX package's params (``{"coarse": {...},
    "fine": {...}}`` or one net) → the port's params. The layouts are the
    same, so this is a copy into fp32 tensors on ``device``, with no
    transposes."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, np.float32)).to(device)
    return conv(tree)


def quantized_params_from_jax(qp, device: str | torch.device = "cpu"
                              ) -> QuantizedNerfParams:
    """The JAX package's ``QuantizedNerfParams`` of one net (arrays or
    numpy leaves) → the port's, on ``device``: ``qw`` int8, ``s``, ``b``
    and ``inv_act`` fp32, with no transposes (the layouts are the same)."""
    def conv(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(device)
    return QuantizedNerfParams(
        layers={name: {"qw": conv(lay["qw"], np.int8),
                       "s": conv(lay["s"], np.float32),
                       "b": conv(lay["b"], np.float32)}
                for name, lay in qp.layers.items()},
        inv_act={k: conv(v, np.float32) for k, v in qp.inv_act.items()})


def train_state_from_jax(state, device: str | torch.device = "cpu"):
    """A JAX package ``TrainState`` (arrays or numpy) → the port's
    ``TrainState`` on ``device``: params, the Adam moments ``mu``/``nu``
    and count of its ``optax.adam`` state, the step and the EMA slot. Lets both
    frameworks continue from one mid-run state."""
    from cvnerf_torch.train.state import AdamState, TrainState

    adam = state.opt_state[0]
    ema = getattr(state, "ema_params", None)
    return TrainState(
        params=params_from_jax(state.params, device),
        opt_state=AdamState(count=int(np.asarray(adam.count)),
                            mu=params_from_jax(adam.mu, device),
                            nu=params_from_jax(adam.nu, device)),
        step=int(np.asarray(state.step)),
        ema_params=None if ema is None else params_from_jax(ema, device))


def import_torch_checkpoint(path: str, out_dir: str, step: int = 0,
                            allow_pickle: bool = False) -> NerfMLPConfig:
    """Convert a reference ``.pt`` into the port's run checkpoint
    ``<out_dir>/torch_checkpoints/<step:06d>.pt``: its params, the fresh
    Adam state of ``create_train_state(PRNGKey(0), mlp=cfg)`` and
    ``step``; ``--ft_path``, a resume and ``NerfRenderer`` take it.
    Returns the inferred architecture."""
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.serve import CKPT_SUBDIR
    from cvnerf_torch.train.checkpoint import save_checkpoint
    from cvnerf_torch.train.state import TrainState, create_train_state

    params, cfg, _ = load_torch_checkpoint(path, allow_pickle=allow_pickle)
    template = create_train_state(PRNGKey(0), mlp=cfg, device="cpu")
    state = TrainState(params=params, opt_state=template.opt_state,
                       step=int(step))
    save_checkpoint(os.path.join(out_dir, CKPT_SUBDIR), state)
    return cfg


def export_torch_checkpoint(ckpt_dir: str, out_path: str,
                            step: int | None = None) -> int:
    """A port run checkpoint → a two-net torch ``.pt`` file:
    ``{"coarse": state_dict, "fine": state_dict, "step": N}``, plain
    tensors only, loadable with ``torch.load(weights_only=True)``. Returns
    the exported step (the latest unless ``step`` is given); an EMA run
    exports its average. A raw checkpoint (``"raw_params": True``, as the
    port's trainer writes) from inside the ``freq_anneal`` horizon that
    the run's ``scene.json`` (beside ``ckpt_dir``) records is exported
    with the training-time frequency window applied, as the JAX exporter
    exports it; a file without the marker was exported already and is
    written as it is."""
    from cvnerf_torch.models.nerf_mlp import anneal_model_params
    from cvnerf_torch.train.checkpoint import checkpoint_path, restore_params

    params, got_step = restore_params(ckpt_dir, step=step)
    blob = torch.load(checkpoint_path(ckpt_dir, got_step),
                      map_location="cpu", weights_only=True)
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(ckpt_dir)),
                               "scene.json")) as fp:
            geo = json.load(fp)
    except (OSError, ValueError):
        geo = None   # no or corrupt snapshot: plain export
    fa = geo.get("freq_anneal", 0) if isinstance(geo, dict) else 0
    if (isinstance(fa, (int, float)) and int(fa) > 0 and got_step < fa
            and blob.get("raw_params")):
        params = anneal_model_params(params, NerfMLPConfig(**geo["mlp"]),
                                     got_step / int(fa))
        print(f"exporting a mid-anneal checkpoint (step {got_step} < "
              f"freq_anneal {int(fa)}): applying the training-time "
              f"frequency window")
    torch.save({"coarse": torch_state_dict_from_params(params["coarse"]),
                "fine": torch_state_dict_from_params(params["fine"]),
                "step": int(got_step)}, out_path)
    return int(got_step)


def build_parser():
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m cvnerf_torch.utils.convert",
        description="Convert checkpoints between the reference's PyTorch "
                    "format and the port's run checkpoints")
    p.add_argument("src", help="import: path to the .pt file; "
                               "--export: the run's torch_checkpoints dir")
    p.add_argument("dst", help="import: run directory to create (gets a "
                               "torch_checkpoints/ subdir); --export: the "
                               ".pt path to write")
    p.add_argument("--export", action="store_true",
                   help="reverse direction: run checkpoint → torch .pt "
                        "({'coarse': state_dict, 'fine': state_dict, "
                        "'step': N}, plain tensors, weights_only-loadable)")
    p.add_argument("--step", type=int, default=None,
                   help="import: step to stamp on the imported state "
                        "(default 0); --export: which checkpoint step to "
                        "export (default latest)")
    p.add_argument("--allow_pickle", action="store_true",
                   help="permit full-pickle checkpoints (EXECUTES the "
                        "file's pickle code — trusted sources only)")
    # Optional scene geometry: with all five given, a scene.json snapshot
    # is written so the imported run serves with --run.
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--focal", type=float, default=None)
    p.add_argument("--near", type=float, default=None)
    p.add_argument("--far", type=float, default=None)
    p.add_argument("--ndc", action="store_true",
                   help="scene.json NDC mode (forward-facing LLFF scenes)")
    p.add_argument("--white_bkg", action="store_true")
    p.add_argument("--n_coarse_samples", type=int, default=64)
    p.add_argument("--n_fine_samples", type=int, default=128)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.export:
        # args.step is None unless given: an explicit --step 0 exports the
        # step-0 checkpoint (the norm for imported runs), not the latest.
        step = export_torch_checkpoint(args.src, args.dst, step=args.step)
        print(f"Exported {args.src} (step {step}) -> {args.dst} "
              "(reference-Model state_dicts under 'coarse'/'fine')")
        return
    step = 0 if args.step is None else args.step
    cfg = import_torch_checkpoint(args.src, args.dst, step=step,
                                  allow_pickle=args.allow_pickle)
    print(f"Imported {args.src} -> {args.dst}/torch_checkpoints "
          f"(architecture: {cfg})")
    ckpt = os.path.join(args.dst, "torch_checkpoints", f"{step:06d}.pt")
    geo = (args.height, args.width, args.focal, args.near, args.far)
    if all(v is not None for v in geo):
        from cvnerf_torch.serve import write_scene_snapshot
        write_scene_snapshot(
            args.dst, height=args.height, width=args.width,
            focal=args.focal, near=args.near, far=args.far, ndc=args.ndc,
            ndc_variant="canonical", white_bkg=args.white_bkg,
            n_coarse=args.n_coarse_samples, n_fine=args.n_fine_samples,
            bf16=False, mlp=cfg)
        print(f"Serve with: python -m cvnerf_torch.server --run {args.dst}")
    elif any(v is not None for v in geo):
        print("[WARN] partial geometry given — scene.json needs all of "
              "--height --width --focal --near --far; skipped")
        print(f"Serve with: python -m cvnerf_torch.server --ckpt {ckpt} "
              "--height ...")
    else:
        print(f"Serve with: python -m cvnerf_torch.server --ckpt {ckpt} "
              "--height ... (or re-import with --height/--width/--focal/"
              "--near/--far to enable `python -m cvnerf_torch.server "
              "--run`)")


if __name__ == "__main__":
    main()
