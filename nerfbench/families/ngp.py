"""The Instant-NGP family: Müller et al. 2022's multiresolution hash-grid
field (16 levels of 2 features, 2^19 entries a level, resolutions 16 to
2048; a density MLP 32 → 64 → 16 and a colour MLP 32 → 64 → 64 → 3, no
biases), as the port runs it (``cvnerf_torch.models.ngp_field``) and as
the plain reference computes it (``reference/ngp.py``). One field serves
both render passes. The functions are those ``families/nerf.py``
documents; beside them, the bytes the hash kernels move, which their
roofline readers (``metrics/hash_*_roofline.train``) divide by the card's
bandwidth.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from nerfbench import scene
from nerfbench.reference import ngp as ref
from nerfbench.reference.common import fp32, no_tf32
from nerfbench.train_cell import change, clone

try:
    # A checkout whose port lacks the field stops here, before the scene.
    import cvnerf_torch.models.ngp_field  # noqa: F401
except ModuleNotFoundError as err:
    raise SystemExit(f"model family 'ngp': this checkout's port has no "
                     f"Instant-NGP field ({err.name} is missing)") from err

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Bytes a value of a table entry, a position and a feature: float32.
F32 = 4


def init_params(cfg: dict, gen, device) -> dict:
    """The field from one draw on ``device``: table entries ``U(-s, s)``
    (``init_scale``, the paper's 1e-4), MLP weights Xavier-uniform
    ``U(±sqrt(6 / (fan_in + fan_out)))``, as tiny-cuda-nn draws them."""
    lvs = ref.levels(cfg)
    feats = cfg["n_features_per_level"]
    layers = ref.mlp_layers(cfg)
    n_table = feats * sum(lv["entries"] for lv in lvs)
    n_mlp = sum(fi * fo for _, _, fi, fo in layers)
    u = torch.rand(n_table + n_mlp, generator=gen, device=device) * 2.0 - 1.0
    s = cfg["init_scale"]
    table, at = {}, 0
    for k, lv in enumerate(lvs):
        n = feats * lv["entries"]
        table[str(k)] = (u[at:at + n] * s).view(lv["entries"], feats).clone()
        at += n
    field = {"table": table, "density": {}, "color": {}}
    for net, name, fi, fo in layers:
        bound = math.sqrt(6.0 / (fi + fo))
        field[net][name] = (u[at:at + fi * fo] * bound).view(fi, fo).clone()
        at += fi * fo
    return {"field": field}


def fit(params: dict, sc: dict, cfg: dict, gen) -> dict:
    """The field trained ``scene.FIT["steps"]`` Adam steps (the family's
    rule, at ``lrate``) on the scene by the plain reference (TF32 allowed:
    these are inputs, not a comparison), ``FIT["rays"]`` pixels a step
    drawn with replacement (from the centre crop for the first
    ``FIT["precrop_steps"]``), with density noise ``FIT["noise_std"]``."""
    plan = scene.FIT
    n_rays, noise_std = plan["rays"], plan["noise_std"]
    images, poses = sc["images"], sc["poses"]
    dev = images.device
    train_idx = torch.from_numpy(sc["train_idx"]).to(dev)
    h, w, f = cfg["H"], cfg["W"], float(np.float32(cfg["focal"]))
    nc, nf = cfg["N_samples"], cfg["N_importance"]
    state = ref.fresh_state(clone(params))
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for step in range(plan["steps"]):
            im = train_idx[torch.randint(len(train_idx), (), generator=gen,
                                         device=dev)]
            if step < plan["precrop_steps"]:
                dh = int(h // 2 * cfg["precrop_frac"])
                dw = int(w // 2 * cfg["precrop_frac"])
                py = torch.randint(h // 2 - dh, h // 2 + dh, (n_rays,),
                                   generator=gen, device=dev)
                px = torch.randint(w // 2 - dw, w // 2 + dw, (n_rays,),
                                   generator=gen, device=dev)
            else:
                py = torch.randint(0, h, (n_rays,), generator=gen, device=dev)
                px = torch.randint(0, w, (n_rays,), generator=gen, device=dev)
            target = images[im, py, px]
            o, d = ref.pixel_rays(px, py, w, h, f, poses[im])
            vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
            if cfg["ndc"]:
                o, d = ref.ndc(h, w, f, 1.0, o, d)
            draws = {"u_strat": torch.rand((n_rays, nc), generator=gen,
                                           device=dev),
                     "u_pdf": torch.sort(torch.rand((n_rays, nf),
                                                    generator=gen,
                                                    device=dev)).values}
            if noise_std > 0:
                draws["noise_c"] = noise_std * torch.randn(
                    (n_rays, nc), generator=gen, device=dev)
                draws["noise_f"] = noise_std * torch.randn(
                    (n_rays, nc + nf), generator=gen, device=dev)
            state, _ = ref._step(state, o, d, vd, cfg["near"], cfg["far"],
                                 target, cfg, fp32, draws)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
    return state["params"]


def leaves(params: dict) -> list[torch.Tensor]:
    return ref.leaves(params)


def field_config(cfg: dict):
    """The port's ``NgpFieldConfig`` of a configuration file, whose fixed
    widths have to be the port's."""
    from cvnerf_torch.models import ngp_field as nf
    from cvnerf_torch.ops.hash_encode import FEATURES
    fixed = {"n_hidden_layers": 1, "n_features_per_level": FEATURES,
             "geo_feat_dim": nf.GEO_FEATURES,
             "rgb_n_hidden_layers": nf.COLOR_LAYERS,
             "sh_degree": nf.SH_DEGREE}
    off = {k: cfg[k] for k, v in fixed.items() if cfg[k] != v}
    if off:
        raise SystemExit(f"the port's Instant-NGP field has {fixed}, not "
                         f"{off}")
    return nf.NgpFieldConfig(
        n_levels=cfg["n_levels"], log2_table=cfg["log2_hashmap_size"],
        base_res=cfg["base_resolution"], max_res=cfg["max_resolution"],
        hidden=cfg["n_neurons"], bound=cfg["bound"],
        init_scale=cfg["init_scale"], adam_b2=cfg["beta2"],
        adam_eps=cfg["epsilon"], l2_reg=cfg["l2_reg"])


def _render_config(cfg: dict, **train):
    from cvnerf_torch.render.renderer import RenderConfig
    return RenderConfig(n_coarse=cfg["N_samples"],
                        n_fine=cfg["N_importance"],
                        white_bkg=cfg["white_bkgd"], mlp=field_config(cfg),
                        compute_dtype=DTYPES[cfg["dtype"]], **train)


def port_train_config(cfg: dict):
    """The port's ``TrainConfig`` of a configuration file."""
    from cvnerf_torch.train.loop import TrainConfig
    render = _render_config(cfg, perturb=True,
                            noise_std=cfg["raw_noise_std"])
    return TrainConfig(height=cfg["H"], width=cfg["W"], focal=cfg["focal"],
                       near=cfg["near"], far=cfg["far"], n_rays=cfg["N_rand"],
                       lr=cfg["lrate"], lr_decay=cfg["lrate_decay"],
                       precrop_iters=cfg["precrop_iters"],
                       precrop_frac=cfg["precrop_frac"], ndc=cfg["ndc"],
                       render=render)


def reference_run(cfg: dict, sc: dict, params0: dict, seed: int, start: int,
                  singles: int, block: int, q, rows: int | None) -> dict:
    """The reference's first ``singles + block`` steps from ``params0``,
    read as ``check.train_numbers`` reads the program's; ``grads1`` are the
    gradients Adam saw (the L2 term included), as the program's are read
    off its first moment."""
    data = {"images": sc["images"], "poses": sc["poses"],
            "train_idx": sc["train_idx"]}
    st = ref.fresh_state(clone(params0))
    out: dict = {"losses": []}
    with no_tf32():
        for j in range(singles + block):
            step = start + j
            st, o = ref.train_step(st, cfg, data, seed, step, q,
                                   precrop=step < cfg["precrop_iters"],
                                   rows=rows)
            if j == 0:
                out["grads1"] = ref.leaves(o["grads"])
            if j < singles:
                out["losses"].append(float(o["loss"]))
            if j == singles - 1:
                out["change"] = change(leaves, st["params"], params0)
    out["block_loss"] = float(o["loss"])
    out["block_change"] = change(leaves, st["params"], params0)
    return out


def write_checkpoint(params: dict, path: str) -> str:
    """The field as the port's params-only Instant-NGP checkpoint
    (``{"model": "ngp", "params": tree, "step": 0}``)."""
    def host(t):
        return ({k: host(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach().float().cpu().clone())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"model": "ngp", "params": host(params), "step": 0}, path)
    return path


def load_renderer(cfg: dict, ckpt: str, device: torch.device):
    """The port's ``NerfRenderer`` of checkpoint ``ckpt``, deterministic,
    in chunks of ``cfg["chunk"]`` rays."""
    from cvnerf_torch.serve import NerfRenderer
    return NerfRenderer(ckpt, height=cfg["H"], width=cfg["W"],
                        focal=cfg["focal"], near=cfg["near"], far=cfg["far"],
                        ndc=cfg["ndc"], cfg=_render_config(cfg),
                        chunk=cfg["chunk"], deterministic=True,
                        device=device)


def reference_frame(params: dict, cfg: dict, c2w: torch.Tensor,
                    q) -> torch.Tensor:
    return ref.render_frame(params, cfg, c2w, q=q)


def samples_per_ray(cfg: dict) -> int:
    """Field queries a ray: the coarse samples, then coarse and fine."""
    return 2 * cfg["N_samples"] + cfg["N_importance"]


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of both MLPs at one sample (9,408 published)."""
    return sum(fi * fo for _, _, fi, fo in ref.mlp_layers(cfg))


def backward_macs(cfg: dict) -> int:
    """Least multiply-adds of the MLPs' backward at one sample (17,792):
    the weight gradients, and the input gradients of every layer but the
    SH rows of the colour MLP's first (the encoded features need theirs:
    the table learns)."""
    sh = cfg["sh_degree"] ** 2
    first_color = [fo for net, name, _, fo in ref.mlp_layers(cfg)
                   if (net, name) == ("color", "l0")][0]
    return 2 * forward_macs(cfg) - sh * first_color


def step_ops(cfg: dict) -> int:
    """Model operations of one train step: the MLPs forward and back at
    every sample (1.426e10 at 1024 rays); the encoding's blends are not
    counted."""
    return (2 * cfg["N_rand"] * samples_per_ray(cfg)
            * (forward_macs(cfg) + backward_macs(cfg)))


def frame_ops(cfg: dict) -> int:
    """Model operations of one frame: the MLPs forward at every sample."""
    return 2 * cfg["H"] * cfg["W"] * samples_per_ray(cfg) * forward_macs(cfg)


def _touched(cfg: dict, samples: int) -> int:
    """Table entries a launch over ``samples`` can touch: at most 8 a
    sample, at most the level's entries, summed over the levels."""
    return sum(min(8 * samples, lv["entries"]) for lv in ref.levels(cfg))


def _launches(cfg: dict) -> list[int]:
    """Samples of each encoding launch of a train step: coarse, fine."""
    n = cfg["N_rand"]
    return [n * cfg["N_samples"], n * (cfg["N_samples"]
                                       + cfg["N_importance"])]


def _moved(cfg: dict, feature_bytes: int) -> int:
    """A step's bytes of positions (12 B a sample), features or their
    gradients (``feature_bytes`` a value) and every table entry a launch
    can touch (8 B), each counted once, over the coarse and fine
    launches."""
    enc = cfg["n_levels"] * cfg["n_features_per_level"] * feature_bytes
    ent = cfg["n_features_per_level"] * F32
    return sum(s * (3 * F32 + enc) + ent * _touched(cfg, s)
               for s in _launches(cfg))


def hash_fwd_bytes(cfg: dict) -> int:
    """Bytes ``hash_encode_fwd`` moves in one train step, each counted
    once: a sample's position (12 B) in and features out (32 values in the
    configuration's dtype, which the first layer reads: 64 B in bfloat16,
    128 B in float32), and every table entry a launch can touch (8 B)."""
    return _moved(cfg, 2 if cfg["dtype"] == "bfloat16" else F32)


def hash_bwd_bytes(cfg: dict) -> int:
    """Bytes ``hash_encode_bwd`` moves in one train step: a sample's
    feature gradients (32 float32, 128 B) and position (12 B) in, and
    every gradient entry a launch can touch written once (8 B)."""
    return _moved(cfg, F32)
