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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvnerf_torch import resolve_device
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params
from cvnerf_torch.ops.adam import fused_adam
from cvnerf_torch.ops.rng import split


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
    params: dict      # {"coarse": net, "fine": net}
    opt_state: AdamState
    step: int
    ema_params: dict | None = None


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _like(tree: dict, leaves: list) -> dict:
    """``leaves`` (in ``tree_leaves`` order) in the nested layout of
    ``tree``."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(exponential_decay(lr, 1000 · lr_decay, 0.1))``."""
    lr: float
    lr_decay: int
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

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
        zeros = _tree_map(lambda p: torch.zeros_like(p.detach()), params)
        return AdamState(count=0, mu=zeros,
                         nu=_tree_map(torch.zeros_like, zeros))

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
        leaves = fused_adam(*(tree_leaves(t) for t in (
            params, grads, state.mu, state.nu)), scalars, self.b1, self.b2,
            self.eps)
        new, mu, nu = (_like(params, ls) for ls in leaves)
        return new, AdamState(count=state.count + 1, mu=mu, nu=nu)


def make_lr_schedule(lr: float, lr_decay: int):
    """``lr · 0.1^(k / (1000 · lr_decay))`` as a function of the update
    count ``k``: the float32 step size Adam takes (the JAX package's
    ``make_lr_schedule``)."""
    return Adam(lr=lr, lr_decay=lr_decay).learning_rate


def make_optimizer(lr: float, lr_decay: int) -> Adam:
    return Adam(lr=lr, lr_decay=lr_decay)


def clone_tree(tree: dict) -> dict:
    """A copy of a nested dict of tensors, no tensor shared."""
    return _tree_map(lambda t: t.detach().clone(), tree)


def ema_update(ema: dict, params: dict, decay: float) -> dict:
    """The Polyak average after one update, ``e·d + p·(1 - d)`` over
    every leaf with ``d`` and ``1 - d`` in float32 (the JAX step's order of
    operations), in three multi-tensor launches."""
    d = np.float32(decay)
    e, p = tree_leaves(ema), [t.detach() for t in tree_leaves(params)]
    return _like(ema, torch._foreach_add(torch._foreach_mul(e, float(d)),
                                         torch._foreach_mul(p, float(1 - d))))


def create_train_state(key: torch.Tensor, lr: float = 5e-4,
                       lr_decay: int = 250,
                       mlp: NerfMLPConfig = NerfMLPConfig(),
                       device: str | torch.device = "cuda",
                       ema: bool = False) -> TrainState:
    """Fresh coarse+fine networks and a zeroed Adam state, on ``device``.
    The nets are the JAX package's ``create_train_state(key)`` nets bit for
    bit: the ``PRNGKey`` ``key`` is split into a coarse and a fine key.
    ``ema=True`` allocates the Polyak-average slot as a copy of the fresh
    params (pair it with ``TrainConfig.ema_decay > 0``)."""
    dev = resolve_device(device)
    kc, kf = split(key)
    params = {"coarse": init_nerf_params(kc, mlp, dev),
              "fine": init_nerf_params(kf, mlp, dev)}
    return TrainState(params=params,
                      opt_state=make_optimizer(lr, lr_decay).init(params),
                      step=0, ema_params=clone_tree(params) if ema else None)
