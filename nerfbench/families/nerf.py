"""The NeRF family: the two MLPs of Mildenhall et al. 2020 (coarse and
fine, 8 layers of ``netwidth`` with the skip into layer 6, a view head of
``netwidth / 2``), as the port runs them (``cvnerf_torch.models.nerf_mlp``)
and as the plain reference computes them (``reference/nerf.py``).

A family module defines these functions; the cells call nothing else of
the model, so a new family is a new module beside this one, named by its
configurations' ``"family"`` key:

``init_params(cfg, gen, device)``
    The starting weights, drawn from the seed's generator ``gen`` on
    ``device``, in the tree the port's ``TrainState`` takes.
``fit(params, sc, cfg, gen)``
    The weights fitted to scene ``sc`` by the plain reference
    (``scene.FIT``, read when called), drawing from ``gen``: the weights
    every cell starts from.
``leaves(params)``
    The tensors of a weights tree (or of an optimizer moment of that
    shape) in one fixed order: what the training numbers compare leaf by
    leaf.
``port_train_config(cfg)``
    The port's ``TrainConfig``; the cell builds the port's ``Trainer``
    and optimizer from it.
``reference_run(cfg, sc, params0, seed, start, singles, block, q, rows)``
    The reference's first ``singles + block`` train steps from
    ``params0``, the draws of the port's run keyed by ``seed`` from step
    ``start``, products through ``q`` (``reference.common``), the loss
    over the first ``rows`` rays of a step (None: all): the ``losses`` of
    the single steps, ``grads1``, ``change``, ``block_loss`` and
    ``block_change`` as ``check.train_numbers`` reads them.
``write_checkpoint(params, path)``
    The weights as the checkpoint file the port's renderer loads;
    returns ``path``.
``load_renderer(cfg, ckpt, device)``
    The port's renderer of that checkpoint, as the server serves it.
``reference_frame(params, cfg, c2w, q)``
    The reference's deterministic ``[H, W, 3]`` frame of pose ``c2w``.
``step_ops(cfg)``, ``frame_ops(cfg)``
    The model operations of one train step and of one frame, which
    ``flops.step_ops`` and ``flops.frame_ops`` return for the family.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from nerfbench import flops, scene
from nerfbench.reference import nerf as ref
from nerfbench.reference.common import no_tf32
from nerfbench.train_cell import change, clone

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_params(cfg: dict, gen, device) -> dict:
    """Both nets' weights and biases, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``
    as ``nn.Linear`` draws them, from one draw on ``device``."""
    shapes = [(name, fi, fo) for name, fi, fo in ref.layers(cfg)]
    per_net = sum(fi * fo + fo for _, fi, fo in shapes)
    u = torch.rand(2 * per_net, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for net in ("coarse", "fine"):
        layer = {}
        for name, fi, fo in shapes:
            bound = 1.0 / math.sqrt(fi)
            w = u[at:at + fi * fo].view(fi, fo) * bound
            at += fi * fo
            b = u[at:at + fo] * bound
            at += fo
            layer[name] = {"w": w.clone(), "b": b.clone()}
        out[net] = layer
    return out


def fit(params: dict, sc: dict, cfg: dict, gen) -> dict:
    """The nets trained ``scene.FIT["steps"]`` Adam steps on the scene by
    the plain reference (TF32 allowed: these are inputs, not a
    comparison), ``FIT["rays"]`` pixels a step drawn with replacement (from
    the centre crop for the first ``FIT["precrop_steps"]``), with density
    noise ``FIT["noise_std"]`` (without it a white background's nets fall
    to an empty scene), so that a frame is not uniform and the density is
    not poised at zero everywhere as at initialisation."""
    plan = scene.FIT
    n_rays, noise_std = plan["rays"], plan["noise_std"]
    images, poses = sc["images"], sc["poses"]
    dev = images.device
    train_idx = torch.from_numpy(sc["train_idx"]).to(dev)
    h, w, f = cfg["H"], cfg["W"], float(np.float32(cfg["focal"]))
    nc, nf = cfg["N_samples"], cfg["N_importance"]
    state = ref.fresh_state({k: {n: {p: t.clone() for p, t in lay.items()}
                                 for n, lay in v.items()}
                             for k, v in params.items()})
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
            state = _fit_step(state, o, d, vd, target, cfg, draws)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
    return state["params"]


def _fit_step(state, o, d, vd, target, cfg, draws):
    p = ref.rebuild(state["params"], [x.detach().requires_grad_()
                                      for x in ref.leaves(state["params"])])
    rgb_f, rgb_c = ref.render_rays(p, o, d, vd, cfg["near"], cfg["far"],
                                   cfg, ref.fp32, draws)
    loss = ((rgb_f - target) ** 2).mean() + ((rgb_c - target) ** 2).mean()
    grads = torch.autograd.grad(loss, ref.leaves(p))
    return ref.adam_update(state, grads, cfg)


def leaves(params: dict) -> list[torch.Tensor]:
    return ref.leaves(params)


def _render_config(cfg: dict, **train):
    from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
    from cvnerf_torch.render.renderer import RenderConfig
    mlp = NerfMLPConfig(xyz_freqs=cfg["multires"],
                        dir_freqs=cfg["multires_views"],
                        trunk_width=cfg["netwidth"],
                        head_width=cfg["netwidth"] // 2)
    return RenderConfig(n_coarse=cfg["N_samples"],
                        n_fine=cfg["N_importance"],
                        white_bkg=cfg["white_bkgd"], mlp=mlp,
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
    read as ``check.train_numbers`` reads the program's (``q`` and
    ``rows``: see ``ref.train_step``)."""
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
    """Both nets as a two-net ``.pt`` of reference-``Model`` state dicts
    (``l1`` .. ``l9``, ``l_alpha``, ``l10``, ``l11``; weights ``[out,
    in]``), the format a NeRF server loads."""
    def sd(net):
        out = {}
        for name, layer in net.items():
            key = "l_alpha" if name == "alpha" else name
            out[f"{key}.weight"] = layer["w"].detach().float().cpu().t() \
                .contiguous()
            out[f"{key}.bias"] = layer["b"].detach().float().cpu().clone()
        return out
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"coarse": sd(params["coarse"]), "fine": sd(params["fine"]),
                "step": 0}, path)
    return path


def load_renderer(cfg: dict, ckpt: str, device: torch.device):
    """The port's ``NerfRenderer`` of checkpoint ``ckpt``, deterministic
    (no jitter, no noise), in chunks of ``cfg["chunk"]`` rays."""
    from cvnerf_torch.serve import NerfRenderer
    return NerfRenderer(ckpt, height=cfg["H"], width=cfg["W"],
                        focal=cfg["focal"], near=cfg["near"], far=cfg["far"],
                        ndc=cfg["ndc"], cfg=_render_config(cfg),
                        chunk=cfg["chunk"], deterministic=True,
                        device=device)


def reference_frame(params: dict, cfg: dict, c2w: torch.Tensor,
                    q) -> torch.Tensor:
    return ref.render_frame(params, cfg, c2w, q=q)


def step_ops(cfg: dict) -> int:
    """Model operations of one train step: every point forward and back
    (9.146e11 at 1024 rays)."""
    return (cfg["N_rand"] * flops.points_per_ray(cfg)
            * (flops.forward_ops(cfg) + flops.backward_ops(cfg)))


def frame_ops(cfg: dict) -> int:
    """Model operations of one frame: every real ray's points forward."""
    return (cfg["H"] * cfg["W"] * flops.points_per_ray(cfg)
            * flops.forward_ops(cfg))
