"""The model families, NeRF's coarse/fine pair (``nerf_mlp.py``) and the
Instant-NGP field (``ngp_field.py``): each answers what the port asks of a
model, so no module outside ``models/`` tests which one it runs. A family
is found by its config's type (:func:`family_of`), by a name or a file's
tag (:func:`family_named`), or by a params tree (:func:`family_of_params`).
A new family is one object here, beside its ``ops/`` and ``csrc/`` files.
"""

from __future__ import annotations

import torch

from cvnerf_torch.models.nerf_mlp import (NerfMLPConfig, apply_nerf,
                                          init_nerf_params)
from cvnerf_torch.models.ngp_field import (NgpFieldConfig, apply_ngp,
                                           empty_ngp_params, init_ngp_params)
from cvnerf_torch.ops import hash_encode, ngp_mlp
from cvnerf_torch.ops.encoding import freq_encode
from cvnerf_torch.ops.fused_mlp import FusedNerfWeights, fused_nerf_apply
from cvnerf_torch.ops.fused_mlp_bwd import fused_nerf_train_apply
from cvnerf_torch.ops.fused_mlp_int8 import (QuantizedNerfWeights,
                                             fused_nerf_apply_int8,
                                             fused_nerf_int8_plain)
from cvnerf_torch.ops.quantize import QuantizedNerfParams
from cvnerf_torch.ops.rng import split
from cvnerf_torch.utils.convert import (load_torch_checkpoint,
                                        params_from_torch_state_dict,
                                        torch_state_dict_from_params)
from cvnerf_torch.utils.tree import match_tree, tree_map


class _Family:
    refuses: frozenset = frozenset()

    def refused(self, **levers) -> list[str]:
        """The levers asked for (``name=`` a true value) it does not take."""
        return [lv for lv, on in levers.items() if on and lv in self.refuses]


class Nerf(_Family):
    """Two MLPs, ``{"coarse": net, "fine": net}``, stored as reference
    ``Model`` state dicts at the file's top level with no tag, as an
    exported file (``load_torch_checkpoint``)."""
    name = "nerf"
    tag = None
    config = NerfMLPConfig

    def config_from_args(self, args, ndc: bool) -> NerfMLPConfig:
        return NerfMLPConfig(xyz_freqs=args.xyz_freqs,
                             dir_freqs=args.dir_freqs,
                             trunk_width=args.trunk_width,
                             head_width=args.head_width)

    def init_params(self, key: torch.Tensor, cfg: NerfMLPConfig,
                    device) -> dict:
        """The JAX package's nets for ``key``, bit for bit."""
        kc, kf = split(key)
        return {"coarse": init_nerf_params(kc, cfg, device),
                "fine": init_nerf_params(kf, cfg, device)}

    def adam(self, cfg: NerfMLPConfig) -> dict:
        return {}

    def net(self, params: dict, name: str):
        return params[name]

    def query(self, net, points: torch.Tensor, viewdirs: torch.Tensor,
              rcfg) -> torch.Tensor:
        """One net's raw ``[n_rays, n_samples, 4]``: with ``kernels="on"``
        (plain versions for CPU tensors) packed weights run the forward
        kernel, a params dict ``fused_nerf_train_apply`` (differentiable),
        an int8 net the int8 kernel, ignoring ``compute_dtype`` as JAX
        does; with ``kernels="off"`` the plain graphs."""
        int8 = isinstance(net, (QuantizedNerfWeights, QuantizedNerfParams))
        if rcfg.kernels == "off" and not int8:
            if isinstance(net, FusedNerfWeights):
                net = net.params
            d = freq_encode(viewdirs, rcfg.mlp.dir_freqs)
            return apply_nerf(net, freq_encode(points, rcfg.mlp.xyz_freqs),
                              d[..., None, :].expand(*points.shape[:-1],
                                                     d.shape[-1]),
                              rcfg.mlp, compute_dtype=rcfg.compute_dtype)
        n_rays, n_samples = points.shape[:2]
        flat = (points.reshape(-1, 3).contiguous(),
                viewdirs[:, None, :].expand(n_rays, n_samples, 3)
                .reshape(-1, 3).contiguous())
        if int8 and rcfg.kernels == "off":
            qp = net.qp if isinstance(net, QuantizedNerfWeights) else net
            raw = fused_nerf_int8_plain(qp, *flat, rcfg.mlp)
        elif int8:
            if isinstance(net, QuantizedNerfParams):
                net = QuantizedNerfWeights(net, rcfg.mlp)
            raw = fused_nerf_apply_int8(net, *flat)
        elif isinstance(net, FusedNerfWeights):
            raw = fused_nerf_apply(net, *flat)
        else:
            raw = fused_nerf_train_apply(net, *flat, rcfg.mlp,
                                         rcfg.compute_dtype)
        return raw.reshape(*points.shape[:2], 4)

    def frame_nets(self, params: dict, rcfg) -> dict:
        """Packed once for the forward kernel (``kernels="on"``)."""
        if rcfg.kernels == "off":
            return params
        return {k: FusedNerfWeights(v, rcfg.mlp, rcfg.compute_dtype)
                for k, v in params.items()}

    def counters(self, opt) -> dict:
        return {}

    def encode(self, tree: dict) -> dict:
        """Each net as a reference state dict, on the host."""
        return {net: torch_state_dict_from_params(p)
                for net, p in tree.items()}

    def file_params(self, encoded: dict) -> dict:
        return encoded

    def stored_params(self, blob: dict) -> dict:
        return blob

    def decode(self, stored: dict, template: dict, path: str, what: str,
               device) -> dict:
        """The nets in ``template``'s leaf order on ``device``."""
        return {net: match_tree(params_from_torch_state_dict(stored[net])[0],
                                want, path, f"{what} {net}", device)
                for net, want in template.items()}

    def read(self, path: str, cfg: NerfMLPConfig | None = None,
             prefer_ema: bool = True) -> tuple[dict, int | None]:
        """A file's params on the CPU, checked against ``cfg``, and step."""
        params, found, step = load_torch_checkpoint(path,
                                                    prefer_ema=prefer_ema)
        if cfg is not None and found != cfg:
            raise ValueError(f"{path} holds architecture {found}, the "
                             f"render config expects {cfg}")
        return params, step


class Ngp(_Family):
    """One field, ``{"field": ...}``, for both passes, stored as ``{"model":
    "ngp", "params": tree, ...}``."""
    name = "ngp"
    tag = "ngp"
    config = NgpFieldConfig
    refuses = frozenset({"occ_train", "occupancy", "int8", "freq_anneal",
                         "meshing"})

    def config_from_args(self, args, ndc: bool) -> NgpFieldConfig:
        """The published widths, in the NDC or ``--occupancy_bound`` cube."""
        return NgpFieldConfig(bound=1.0 if ndc else args.occupancy_bound)

    def init_params(self, key: torch.Tensor, cfg: NgpFieldConfig,
                    device) -> dict:
        return init_ngp_params(key, cfg, device)

    def adam(self, cfg: NgpFieldConfig) -> dict:
        return cfg.adam()

    def net(self, params: dict, name: str):
        return params["field"]

    def query(self, net, points: torch.Tensor, viewdirs: torch.Tensor,
              rcfg) -> torch.Tensor:
        return apply_ngp(net, points, viewdirs, rcfg.mlp, rcfg.compute_dtype,
                         rcfg.kernels)

    def frame_nets(self, params: dict, rcfg) -> dict:
        return params

    def counters(self, opt) -> dict:
        """Adam's, the hash encoding's (``hash_``) and the MLPs' (``mlp_``)
        counts."""
        return {**opt.stats,
                **{f"hash_{k}": v for k, v in hash_encode.stats.items()},
                **{f"mlp_{k}": v for k, v in ngp_mlp.stats.items()}}

    def encode(self, tree: dict) -> dict:
        return tree_map(lambda t: t.detach().cpu().clone(), tree)

    def file_params(self, encoded: dict) -> dict:
        return {"model": self.tag, "params": encoded}

    def stored_params(self, blob: dict) -> dict:
        return blob["params"]

    def decode(self, stored: dict, template: dict, path: str, what: str,
               device) -> dict:
        return match_tree(stored, template, path, what, device)

    def read(self, path: str, cfg: NgpFieldConfig | None = None,
             prefer_ema: bool = True) -> tuple[dict, int | None]:
        """A file's field on the CPU, checked against ``cfg``, and step."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(blob, dict) or blob.get("model") != self.tag:
            raise ValueError(f"{path} holds no Instant-NGP field")
        params = blob["params"]
        if prefer_ema and isinstance(blob.get("ema_params"), dict):
            params = blob["ema_params"]
        if cfg is not None:
            params = match_tree(params, empty_ngp_params(cfg), path,
                                "params", "cpu")
        step = blob.get("step")
        return params, None if step is None else int(step)


NERF, NGP = Nerf(), Ngp()
FAMILIES = {f.name: f for f in (NERF, NGP)}


def family_of(mlp) -> Nerf | Ngp:
    """The family of a model config (``RenderConfig.mlp``)."""
    for fam in FAMILIES.values():
        if isinstance(mlp, fam.config):
            return fam
    raise TypeError(f"no model family takes a {type(mlp).__name__}")


def family_named(tag: str | None) -> Nerf | Ngp:
    """The family of ``--model``'s name or a file's ``"model"`` tag (None:
    NeRF's files carry none)."""
    for fam in FAMILIES.values():
        if tag in (fam.name, fam.tag):
            return fam
    raise ValueError(f"no model family is named {tag!r}")


def family_of_params(params: dict) -> Nerf | Ngp:
    """The family of a params tree: the field's holds ``"field"``."""
    return NGP if "field" in params else NERF

