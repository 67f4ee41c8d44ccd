"""Checkpoint save/restore of a whole ``TrainState`` (port of the JAX
package's ``train/checkpoint.py``, without orbax).

A checkpoint is one plain-tensor file ``<dir>/<step:06d>.pt``: the params
in their family's layout (``models/family.py``), ``"step"``,
``"opt_state": {"count", "mu", "nu"}`` (the moments in the same layout),
``"raw_params": True`` (not windowed for serving, as ``cvnerf-import
--export`` writes them) and, with the EMA slot, ``"ema_params"``, the
Polyak average that ``restore_params`` and serving prefer.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from cvnerf_torch.models.family import family_named, family_of_params
from cvnerf_torch.train.state import AdamState, TrainState, clone_tree
from cvnerf_torch.utils.tree import tree_leaves

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


def _payload(state: TrainState) -> dict:
    """The checkpoint of ``state``, copied to the host."""
    fam = family_of_params(state.params)
    opt = state.opt_state
    out = {**fam.file_params(fam.encode(state.params)),
           "step": int(state.step),
           "opt_state": {"count": int(opt.count), "mu": fam.encode(opt.mu),
                         "nu": fam.encode(opt.nu)},
           "raw_params": True}
    if state.ema_params is not None:
        out["ema_params"] = fam.encode(state.ema_params)
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
    fam = family_named(blob.get("model") if isinstance(blob, dict) else None)
    params, found = fam.read(path, prefer_ema=prefer_ema)
    return params, int(found or 0)


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
    fam = family_of_params(template.params)
    if family_named(blob.get("model")) is not fam:
        raise ValueError(f"{path}: the checkpoint's model and the run's "
                         f"differ (one is an Instant-NGP field)")
    device = tree_leaves(template.params)[0].device

    def tree(stored: dict, what: str) -> dict:
        return fam.decode(stored, template.params, path, what, device)

    opt = blob["opt_state"]
    params = tree(fam.stored_params(blob), "params")
    stored = blob.get("ema_params")
    ema = None
    if template.ema_params is not None:
        ema = (tree(stored, "ema_params") if stored is not None
               else clone_tree(params))
    elif stored is not None:
        print(f"[WARN] checkpoint at step {int(blob['step'])} carries an "
              f"EMA average but this invocation disables --ema_decay: "
              f"dropping it — later checkpoints will serve the raw "
              f"params", flush=True)
    return TrainState(
        params=params,
        opt_state=AdamState(count=int(opt["count"]),
                            mu=tree(opt["mu"], "mu"),
                            nu=tree(opt["nu"], "nu")),
        step=int(blob["step"]), ema_params=ema)
