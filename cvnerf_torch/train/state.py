"""Train state: coarse+fine params, Adam state, step counter (port of the
JAX package's ``train/state.py``).

Adam(b1 0.9, b2 0.999, eps 1e-8) over both nets with the exponential decay
``lr · 0.1^(k / (1000 · lr_decay))``, written out as optax computes it, in
float32: ``k`` is the update count, 0 at the first update; the moments are
``(1 - b) · g^p + b · m``, bias-corrected by ``1 - b^(k+1)``; the update is
``-lr(k) · m̂ / (sqrt(v̂) + eps)`` (eps outside the root). The per-update
scalars ``-lr(k)``, ``1 - b1^(k+1)`` and ``1 - b2^(k+1)`` are formed on
the CPU in float32 (``Adam.scalars``) and enter the update as a float32
tensor on the params' device, so a step captured in a CUDA graph reads
each update's own values from a table instead of freezing them. The
optimizer returns new tensors and leaves its inputs as they were, like the
JAX one; on a card an update of every leaf is one kernel launch
(``ops/adam.py``).
An EMA run (``--ema_decay``) also carries the Polyak average of the params
(``ema_update``).

The Instant-NGP field's family (``models/family.py``) adds the paper's β₂,
ε, an L2 on the MLP weights (``l2_on``) and no step where a table entry's
gradient is 0 (``skip_zero``), which ``Adam.stats`` counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvnerf_torch import resolve_device
from cvnerf_torch.models.family import family_of
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.adam import fused_adam
from cvnerf_torch.utils.tree import leaf_paths, tree_leaves, tree_like, tree_map


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the update count and both moments."""
    count: int
    mu: dict
    nu: dict


@dataclasses.dataclass
class TrainState:
    """Everything that changes during training. ``ema_params`` is the
    Polyak average of the params (``--ema_decay``), the deployable weights
    of an EMA run; None when EMA is off."""
    params: dict      # {"coarse": net, "fine": net}, or {"field": ...}
    opt_state: AdamState
    step: int
    ema_params: dict | None = None


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(exponential_decay(lr, 1000 · lr_decay, 0.1))``, with
    two per-leaf rules: ``l2`` times the leaf added to the gradient of the
    leaves under a path of ``l2_on``, and no update of a value whose
    gradient is exactly 0 in the leaves under a path of ``skip_zero``."""
    lr: float
    lr_decay: int
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    skip_zero: tuple[str, ...] = ()
    l2: float = 0.0
    l2_on: tuple[str, ...] = ()
    stats: dict = dataclasses.field(
        default_factory=lambda: {"updates": 0, "skip_zero_leaves": 0,
                                 "skip_zero_values": 0},
        compare=False, hash=False, repr=False)

    def rules(self, params: dict) -> tuple[list[bool], list[float]]:
        """Each leaf's ``skip_zero`` flag and L2 factor, by its path."""
        def under(path, prefixes):
            return any(path == p or path.startswith(p + "/")
                       for p in prefixes)
        paths = leaf_paths(params)
        return ([under(p, self.skip_zero) for p in paths],
                [self.l2 if under(p, self.l2_on) else 0.0 for p in paths])

    def learning_rate(self, count: int) -> torch.Tensor:
        """The float32 step size at update count ``count`` (optax's
        ``exponential_decay``: exactly ``lr`` at ``count <= 0``)."""
        lr = _f32(self.lr)
        steps = 1000 * self.lr_decay
        if count <= 0 or steps <= 0:
            return lr
        p = _f32(count) / steps
        return lr * torch.pow(_f32(0.1), p)

    def init(self, params: dict) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p.detach()), params)
        return AdamState(count=0, mu=zeros,
                         nu=tree_map(torch.zeros_like, zeros))

    def scalars(self, count: int) -> np.ndarray:
        """The float32 scalars of update ``count`` (0 at the first):
        ``(-lr(count), 1 - b1^(count+1), 1 - b2^(count+1))``, each formed
        on the CPU in float32."""
        c1 = count + 1
        return torch.stack([-self.learning_rate(count),
                            1 - _f32(self.b1) ** c1,
                            1 - _f32(self.b2) ** c1]).numpy()

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict,
               scalars: torch.Tensor) -> tuple[dict, AdamState]:
        """One Adam step: ``(new params, new state)``. ``scalars`` is
        :meth:`scalars` of ``state.count`` as a float32 ``[3]`` tensor on
        the params' device (the train step's row). Every leaf in one
        launch on a card, the plain version on the CPU
        (``ops/adam.py::fused_adam``)."""
        skip, l2 = self.rules(params)
        leaves = fused_adam(*(tree_leaves(t) for t in (
            params, grads, state.mu, state.nu)), scalars, self.b1, self.b2,
            self.eps, skip_zero=skip, l2=l2)
        self.stats["updates"] += 1
        self.stats["skip_zero_leaves"] += sum(skip)
        self.stats["skip_zero_values"] += sum(
            t.numel() for t, f in zip(tree_leaves(params), skip) if f)
        new, mu, nu = (tree_like(params, ls) for ls in leaves)
        return new, AdamState(count=state.count + 1, mu=mu, nu=nu)


def make_lr_schedule(lr: float, lr_decay: int):
    """``lr · 0.1^(k / (1000 · lr_decay))`` as a function of the update
    count ``k``: the float32 step size Adam takes (the JAX package's
    ``make_lr_schedule``)."""
    return Adam(lr=lr, lr_decay=lr_decay).learning_rate


def make_optimizer(lr: float, lr_decay: int, mlp=NerfMLPConfig()) -> Adam:
    """The optimizer of ``mlp``'s model: NeRF's Adam, or the Instant-NGP
    paper's (see the module docstring)."""
    return Adam(lr=lr, lr_decay=lr_decay, **family_of(mlp).adam(mlp))


def clone_tree(tree: dict) -> dict:
    """A copy of a nested dict of tensors, no tensor shared."""
    return tree_map(lambda t: t.detach().clone(), tree)


def ema_update(ema: dict, params: dict, decay: float) -> dict:
    """The Polyak average after one update, ``e·d + p·(1 - d)`` over
    every leaf with ``d`` and ``1 - d`` in float32 (the JAX step's order of
    operations), in three multi-tensor launches."""
    d = np.float32(decay)
    e, p = tree_leaves(ema), [t.detach() for t in tree_leaves(params)]
    return tree_like(ema, torch._foreach_add(torch._foreach_mul(e, float(d)),
                                         torch._foreach_mul(p, float(1 - d))))


def create_train_state(key: torch.Tensor, lr: float = 5e-4,
                       lr_decay: int = 250,
                       mlp: NerfMLPConfig = NerfMLPConfig(),
                       device: str | torch.device = "cuda",
                       ema: bool = False) -> TrainState:
    """Fresh params of ``mlp``'s family and a zeroed Adam state, on
    ``device``: coarse+fine networks, the JAX package's
    ``create_train_state(key)`` nets bit for bit, or with ``mlp`` an
    ``NgpFieldConfig`` one Instant-NGP field from ``key``.
    ``ema=True`` allocates the Polyak-average slot as a copy of the fresh
    params (pair it with ``TrainConfig.ema_decay > 0``)."""
    params = family_of(mlp).init_params(key, mlp, resolve_device(device))
    return TrainState(params=params,
                      opt_state=make_optimizer(lr, lr_decay, mlp)
                      .init(params),
                      step=0, ema_params=clone_tree(params) if ema else None)
