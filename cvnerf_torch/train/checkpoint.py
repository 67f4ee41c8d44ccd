"""Checkpoint save/restore of a whole ``TrainState`` (port of the JAX
package's ``train/checkpoint.py``, without orbax).

A checkpoint is one plain-tensor file ``<dir>/<step:06d>.pt``::

    {"coarse": state_dict, "fine": state_dict, "step": N,
     "opt_state": {"count": int, "mu": {"coarse": sd, "fine": sd},
                   "nu": {"coarse": sd, "fine": sd}},
     "raw_params": True}

and, for a state with the EMA slot, ``"ema_params": {"coarse": sd,
"fine": sd}``, the Polyak average (the deployable weights, which
``restore_params`` and serving prefer). The state dicts are
reference-``Model`` ``nn.Linear`` layouts
(``utils/convert.py::torch_state_dict_from_params``), the Adam moments in
the same layout, so ``torch.load(weights_only=True)`` reads the file and
``load_torch_checkpoint`` and ``NerfRenderer`` serve it as they serve an
exported one. ``raw_params`` marks weights saved as training holds them
(not windowed for serving, as ``cvnerf-import --export`` writes them).

A state of the Instant-NGP field (``{"field": ...}`` params) is saved as
its trees, ``{"model": "ngp", "params": tree, "step": N, "opt_state":
{"count", "mu": tree, "nu": tree}, "raw_params": True}`` (and
``"ema_params": tree``); a params-only file (``{"model": "ngp", "params":
tree}``) serves too (``load_ngp_checkpoint``).
"""

from __future__ import annotations

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from cvnerf_torch.train.state import (AdamState, TrainState, clone_tree,
                                      tree_leaves)
from cvnerf_torch.utils.convert import (load_torch_checkpoint,
                                        params_from_torch_state_dict,
                                        torch_state_dict_from_params)

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(ckpt_dir: str) -> list[int]:
    """The steps of the ``<step>.pt`` files in ``ckpt_dir``, ascending."""
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, names) if m)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step:06d}.pt")


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _host(tree: dict) -> dict:
    return {k: _host(v) if isinstance(v, dict) else v.detach().cpu().clone()
            for k, v in tree.items()}


def _payload(state: TrainState) -> dict:
    """The checkpoint of ``state``, copied to the host."""
    opt = state.opt_state
    if "field" in state.params:
        out = {"model": "ngp", "params": _host(state.params),
               "step": int(state.step),
               "opt_state": {"count": int(opt.count), "mu": _host(opt.mu),
                             "nu": _host(opt.nu)},
               "raw_params": True}
        if state.ema_params is not None:
            out["ema_params"] = _host(state.ema_params)
        return out

    def sds(tree):
        return {net: torch_state_dict_from_params(p)
                for net, p in tree.items()}
    out = {**sds(state.params), "step": int(state.step),
           "opt_state": {"count": int(opt.count), "mu": sds(opt.mu),
                         "nu": sds(opt.nu)},
           "raw_params": True}
    if state.ema_params is not None:
        out["ema_params"] = sds(state.ema_params)
    return out


class Checkpointer:
    """A persistent, asynchronous checkpoint writer for a training run.

    ``save`` copies the state to the host and returns; one background
    thread writes the file (to a temporary name, then renamed, so a reader
    never sees half a file) while training goes on. At most one save is in
    flight: a save first waits for the previous one, and raises its error
    if it failed. ``close`` drains the writer.

    A save at the directory's latest step is a no-op (the final save
    landing on the last periodic one); a save below it raises, because the
    newer checkpoint would shadow it at resume time. ``max_to_keep`` keeps
    the newest checkpoints.
    """

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.ckpt_dir = ckpt_dir
        self.max_to_keep = max_to_keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="checkpoint")
        self._pending: Future | None = None

    def save(self, state: TrainState, wait: bool = False) -> None:
        """Enqueue a save of ``state`` at its step; with ``wait`` return
        only once the file is durable (the final save of a run)."""
        step = int(state.step)
        self.wait()
        existing = latest_step(self.ckpt_dir)
        if existing is not None:
            if step == existing:
                return
            if step < existing:
                raise RuntimeError(
                    f"refusing to save step {step} into {self.ckpt_dir} "
                    f"whose latest step is {existing}: the newer checkpoint "
                    "would shadow this one at resume time; remove or move "
                    "the stale checkpoint directory")
        self._pending = self._pool.submit(self._write, step, _payload(state))
        if wait:
            self.wait()

    def _write(self, step: int, payload: dict) -> None:
        path = checkpoint_path(self.ckpt_dir, step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fp:
            torch.save(payload, fp)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, path)
        for old in _steps(self.ckpt_dir)[:-self.max_to_keep]:
            os.remove(checkpoint_path(self.ckpt_dir, old))

    def wait(self) -> None:
        """Block until the save in flight (if any) is on disk."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    max_to_keep: int = 3) -> None:
    """One-shot synchronous save."""
    with Checkpointer(ckpt_dir, max_to_keep) as ckpt:
        ckpt.save(state, wait=True)


def _find(ckpt_dir: str, step: int | None) -> str | None:
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None
    path = checkpoint_path(ckpt_dir, step)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at step {step} in {ckpt_dir}")
    return path


def restore_params(ckpt_dir: str, step: int | None = None,
                   prefer_ema: bool = True) -> tuple[dict, int]:
    """Template-free restore of the params (on the CPU) and their step,
    from a checkpoint of this module or a params-only exported one: the
    Polyak average of an EMA run unless ``prefer_ema=False``, which reads
    the raw last iterate. Raises FileNotFoundError when the directory
    holds no checkpoint."""
    path = _find(ckpt_dir, step)
    if path is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and blob.get("model") == "ngp":
        params, found = _ngp_params(blob, prefer_ema)
        return params, int(found or 0)
    params, _, found = load_torch_checkpoint(path, prefer_ema=prefer_ema)
    return params, int(found or 0)


def load_ngp_checkpoint(path: str, prefer_ema: bool = True
                        ) -> tuple[dict, int | None]:
    """An Instant-NGP checkpoint's params (on the CPU) and step (None where
    the file has none): the Polyak average of an EMA run unless
    ``prefer_ema=False``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("model") != "ngp":
        raise ValueError(f"{path} holds no Instant-NGP field")
    return _ngp_params(blob, prefer_ema)


def _ngp_params(blob: dict, prefer_ema: bool) -> tuple[dict, int | None]:
    params = blob["params"]
    if prefer_ema and isinstance(blob.get("ema_params"), dict):
        params = blob["ema_params"]
    step = blob.get("step")
    return params, None if step is None else int(step)


def match_tree(got: dict, want: dict, path: str, what: str, device) -> dict:
    """``got`` in ``want``'s layout and leaf order on ``device``; raises
    where a leaf is missing or of another shape."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path}: {what} holds keys "
                             f"{sorted(got) if isinstance(got, dict) else got}"
                             f", the run expects {sorted(want)}")
        return {k: match_tree(got[k], v, path, f"{what}.{k}", device)
                for k, v in want.items()}
    if got.shape != want.shape:
        raise ValueError(f"{path}: {what} has shape {tuple(got.shape)}, "
                         f"the run expects {tuple(want.shape)}")
    return got.to(device)


def restore_checkpoint(ckpt_dir: str, template: TrainState,
                       step: int | None = None) -> TrainState | None:
    """Restore the latest (or given) step as a ``TrainState`` on the
    device of ``template``'s params, bitwise the saved state; None if the
    directory holds no checkpoint. The template's shapes must match.

    The template decides the EMA slot: a template with one restores the
    stored average, or, from a checkpoint without one, starts it as a copy
    of the restored params (the fresh-state warm start); a template
    without one drops a stored average, with a warning."""
    path = _find(ckpt_dir, step)
    if path is None:
        return None
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or "opt_state" not in blob:
        raise ValueError(
            f"{path} holds parameters only, with no optimizer state (as "
            "an export writes them): a run cannot resume from it. "
            "NerfRenderer serves it; to fine-tune from it, import it "
            "(python -m cvnerf_torch.utils.convert <file.pt> <run>) and "
            "pass --ft_path <run>/torch_checkpoints")
    device = tree_leaves(template.params)[0].device
    if blob.get("model") == "ngp" or "field" in template.params:
        if blob.get("model") != "ngp" or "field" not in template.params:
            raise ValueError(f"{path}: the checkpoint's model and the run's "
                             f"differ (one is an Instant-NGP field)")
        opt = blob["opt_state"]
        def tree(got, what):
            return match_tree(got, template.params, path, what, device)
        params = tree(blob["params"], "params")
        stored = blob.get("ema_params")
        ema = None
        if template.ema_params is not None:
            ema = (tree(stored, "ema_params") if stored is not None
                   else clone_tree(params))
        return TrainState(
            params=params,
            opt_state=AdamState(count=int(opt["count"]),
                                mu=tree(opt["mu"], "mu"),
                                nu=tree(opt["nu"], "nu")),
            step=int(blob["step"]), ema_params=ema)

    def nets(sds: dict, what: str) -> dict:
        out = {}
        for net, want in template.params.items():
            got, _ = params_from_torch_state_dict(sds[net])
            for layer, leaves in want.items():
                for q, t in leaves.items():
                    if got[layer][q].shape != t.shape:
                        raise ValueError(
                            f"{path}: {what} {net}.{layer}.{q} has shape "
                            f"{tuple(got[layer][q].shape)}, the run expects "
                            f"{tuple(t.shape)}")
            # The template's leaf order, which the train step follows.
            out[net] = {layer: {q: got[layer][q].to(device) for q in leaves}
                        for layer, leaves in want.items()}
        return out

    opt = blob["opt_state"]
    params = nets({k: blob[k] for k in template.params}, "params")
    stored = blob.get("ema_params")
    ema = None
    if template.ema_params is not None:
        ema = (nets(stored, "ema_params") if stored is not None
               else clone_tree(params))
    elif stored is not None:
        print(f"[WARN] checkpoint at step {int(blob['step'])} carries an "
              f"EMA average but this invocation disables --ema_decay: "
              f"dropping it — later checkpoints will serve the raw "
              f"params", flush=True)
    return TrainState(
        params=params,
        opt_state=AdamState(count=int(opt["count"]),
                            mu=nets(opt["mu"], "mu"),
                            nu=nets(opt["nu"], "nu")),
        step=int(blob["step"]), ema_params=ema)
