"""Traffic of the ``train`` kind: the port's ``Trainer`` in graphed blocks
of steps, as its CLI trains without file I/O.

Set-up makes the scene from the seed and the nets fitted to it (a trained
state, as at step 500 of a run, and not one poised at initialisation),
builds one
``Trainer`` and drives it through its first steps with the window's own
call, ``Trainer.run``: the checked single steps, then one block of
``steps_per_call`` steps (its CUDA graph captured and replayed). The window
then calls ``Trainer.run`` for ``steps_per_run`` steps at a time until
``--seconds`` have passed; each call ends in the host read of the last
step's metrics, as a CLI run reads them at every ``print_freq``. After the
window the reference follows the same first steps from the same weights,
and ``check.train_numbers`` compares.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from nerfbench import check, scene, trace
from nerfbench.reference import nerf as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def clone(tree: dict) -> dict:
    return {k: clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def port_config(cfg: dict):
    """The port's ``TrainConfig`` of a configuration file."""
    from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
    from cvnerf_torch.render.renderer import RenderConfig
    from cvnerf_torch.train.loop import TrainConfig
    mlp = NerfMLPConfig(xyz_freqs=cfg["multires"],
                        dir_freqs=cfg["multires_views"],
                        trunk_width=cfg["netwidth"],
                        head_width=cfg["netwidth"] // 2)
    render = RenderConfig(n_coarse=cfg["N_samples"],
                          n_fine=cfg["N_importance"], perturb=True,
                          noise_std=cfg["raw_noise_std"],
                          white_bkg=cfg["white_bkgd"], mlp=mlp,
                          compute_dtype=DTYPES[cfg["dtype"]])
    return TrainConfig(height=cfg["H"], width=cfg["W"], focal=cfg["focal"],
                       near=cfg["near"], far=cfg["far"], n_rays=cfg["N_rand"],
                       lr=cfg["lrate"], lr_decay=cfg["lrate_decay"],
                       precrop_iters=cfg["precrop_iters"],
                       precrop_frac=cfg["precrop_frac"], ndc=cfg["ndc"],
                       render=render)


def _minus(a: dict, b: dict) -> list[torch.Tensor]:
    return [x.detach() - y for x, y in zip(ref.leaves(a), ref.leaves(b))]


def reference_run(cfg: dict, sc: dict, params0: dict, seed: int, start: int,
                  singles: int, block: int, q=ref.fp32,
                  rows: int | None = None) -> dict:
    """The reference's first ``singles + block`` steps from ``params0``,
    read as ``check.train_numbers`` reads the program's (``q`` and
    ``rows``: see ``ref.train_step``)."""
    data = {"images": sc["images"], "poses": sc["poses"],
            "train_idx": sc["train_idx"]}
    st = ref.fresh_state(clone(params0))
    out: dict = {"losses": []}
    with ref.no_tf32():
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
                out["change"] = _minus(st["params"], params0)
    out["block_loss"] = float(o["loss"])
    out["block_change"] = _minus(st["params"], params0)
    return out


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, t0: float) -> dict:
    from cvnerf_torch.train.loop import Trainer
    from cvnerf_torch.train.state import TrainState, make_optimizer

    sc, params0, _, fit_s = scene.inputs(cfg, seed, device)
    phases = {"fit_s": fit_s, "inputs_s": time.perf_counter() - t0}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tcfg = port_config(cfg)
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
                              ref.leaves(trainer.state.opt_state.mu)]
    prog["change"] = _minus(trainer.state.params, params0)
    phases["single_steps_s"] = time.perf_counter() - t0
    i = start + singles
    prog["block_loss"] = trainer.run(i, i + block)["loss"]
    prog["block_change"] = _minus(trainer.state.params, params0)
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
        prog, reference_run(cfg, sc, params0, key_seed, start, singles,
                            block))
    return {
        "setup_s": setup_s, "attempted": steps, "failed": 0,
        "metrics": {"train_rays_per_s": steps * cfg["N_rand"] / (tw1 - tw0),
                    "setup_s": setup_s},
        "numbers": numbers, "memory_peak_bytes": memory,
        "trace": got[0] if got else None,
        "context": {"steps": steps, "window_s": tw1 - tw0},
        "notes": {"block_stats": stats, "setup_phases": phases},
    }
