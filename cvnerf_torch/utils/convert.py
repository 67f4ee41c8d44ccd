"""Checkpoint conversion (port of the JAX package's ``utils/convert.py``:
state_dict mapping and ``.pt`` loader), and the carry-over of params,
int8 params and train states from the JAX package.

The port serves the plain-tensor two-net ``.pt`` that the JAX tool writes
(``cvnerf-import --export <run>/checkpoints <file>.pt``: ``{"coarse": sd,
"fine": sd, "step": N}``) and the reference's own ``.pt`` layouts. A
state_dict holds reference-``Model`` ``nn.Linear`` layers ``l1``..``l11``
and ``l_alpha`` with ``weight`` ``[out, in]``; the port's params keep the
JAX layout ``{"w": [in, out], "b": [out]}``.
"""

from __future__ import annotations

import numpy as np
import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.quantize import QuantizedNerfParams
from cvnerf_torch.train.state import AdamState, TrainState

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


def load_torch_checkpoint(path: str, prefer_ema: bool = True
                          ) -> tuple[dict, NerfMLPConfig, int | None]:
    """A ``.pt`` file → ``({"coarse": ..., "fine": ...}, cfg, step)``.

    Loads with ``weights_only=True``: only plain tensors, no pickled code.
    ``step`` is the file's ``"step"`` entry, or None when it has none. A
    single-net checkpoint serves as both nets. A checkpoint of an EMA run
    (the port's trainer stores the Polyak average under ``"ema_params"``)
    gives the average, its deployable model, unless ``prefer_ema=False``.
    """
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(
            f"{path} is not a plain-tensor checkpoint (weights_only load "
            f"failed: {e})") from e
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
    adam = state.opt_state[0]
    ema = getattr(state, "ema_params", None)
    return TrainState(
        params=params_from_jax(state.params, device),
        opt_state=AdamState(count=int(np.asarray(adam.count)),
                            mu=params_from_jax(adam.mu, device),
                            nu=params_from_jax(adam.nu, device)),
        step=int(np.asarray(state.step)),
        ema_params=None if ema is None else params_from_jax(ema, device))
