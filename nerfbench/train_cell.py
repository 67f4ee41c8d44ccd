"""Traffic of the ``train`` kind: the port's ``Trainer`` in graphed blocks
of steps, as its CLI trains without file I/O.

Set-up makes the scene from the seed and the weights of the
configuration's family (``families/``) fitted to it (a trained state, as
at step 500 of a run, and not one poised at initialisation), builds one
``Trainer`` from the family's ``TrainConfig`` and drives it through its
first steps with the window's own call, ``Trainer.run``: the checked
single steps, then one block of
``steps_per_call`` steps (its CUDA graph captured and replayed). The window
then calls ``Trainer.run`` for ``steps_per_run`` steps at a time until
``--seconds`` have passed; each call ends in the host read of the last
step's metrics, as a CLI run reads them at every ``print_freq``. After the
window the family's reference follows the same first steps from the same
weights, and ``check.train_numbers`` compares.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from nerfbench import check, families, scene, trace
from nerfbench.reference.common import fp32


def clone(tree: dict) -> dict:
    return {k: clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def change(leaves, params: dict, params0: dict) -> list[torch.Tensor]:
    """Each leaf of ``params`` less ``params0``'s (``leaves``: the
    family's)."""
    return [x.detach() - y for x, y in zip(leaves(params), leaves(params0))]


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, t0: float) -> dict:
    from cvnerf_torch.train.loop import Trainer
    from cvnerf_torch.train.state import TrainState, make_optimizer

    family = families.get(cfg)
    sc, params0, _, fit_s = scene.inputs(cfg, seed, device)
    phases = {"fit_s": fit_s, "inputs_s": time.perf_counter() - t0}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tcfg = family.port_train_config(cfg)
    start, block = traffic["start_step"], traffic["steps_per_call"]
    singles = traffic["checked_single_steps"]
    key_seed = seed % 2 ** 31           # a PRNGKey seed is 32-bit signed
    state = TrainState(params=clone(params0),
                       opt_state=make_optimizer(tcfg.lr, tcfg.lr_decay)
                       .init(params0), step=start)
    trainer = Trainer(tcfg, state, sc["images"], sc["poses"],
                      sc["train_idx"], seed=key_seed, steps_per_call=block)
    prog: dict = {"losses": []}
    for j in range(singles):
        prog["losses"].append(trainer.run(start + j, start + j + 1)["loss"])
        if j == 0:
            # Adam's first moment after one update is 0.1 g.
            prog["grads1"] = [m / 0.1 for m in
                              family.leaves(trainer.state.opt_state.mu)]
    prog["change"] = change(family.leaves, trainer.state.params, params0)
    phases["single_steps_s"] = time.perf_counter() - t0
    i = start + singles
    prog["block_loss"] = trainer.run(i, i + block)["loss"]
    prog["block_change"] = change(family.leaves, trainer.state.params,
                                  params0)
    i += block
    scene.sync(device)
    # The fit is the reference's work, not the program's set-up.
    setup_s = time.perf_counter() - t0 - fit_s

    per_run = traffic["steps_per_run"]
    span = min(seconds, traffic["trace_seconds"]) if traced else seconds
    steps = 0
    with trace.profiled(traced) as got:
        if traced:
            # A first call under the profiler falls before the window, which
            # then holds the calls of a steady run only.
            trainer.run(i, i + per_run)
            i += per_run
            scene.sync(device)
        with record_function(trace.WINDOW):
            tw0 = time.perf_counter()
            while True:
                with record_function("nerfbench.trainer_run"):
                    trainer.run(i, i + per_run)
                i += per_run
                steps += per_run
                if time.perf_counter() - tw0 >= span:
                    break
            scene.sync(device)
            tw1 = time.perf_counter()
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    stats = dict(trainer.scan_fn.runner.stats)
    del trainer, state
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = check.train_numbers(
        prog, family.reference_run(cfg, sc, params0, key_seed, start,
                                   singles, block, fp32, None))
    return {
        "setup_s": setup_s, "attempted": steps, "failed": 0,
        "metrics": {"train_rays_per_s": steps * cfg["N_rand"] / (tw1 - tw0),
                    "setup_s": setup_s},
        "numbers": numbers, "memory_peak_bytes": memory,
        "trace": got[0] if got else None,
        "context": {"steps": steps, "window_s": tw1 - tw0},
        "notes": {"block_stats": stats, "setup_phases": phases},
    }
