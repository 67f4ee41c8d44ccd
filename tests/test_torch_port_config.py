"""The port's config parser against the JAX package's: the same namespace
(apart from the port's own ``--device`` and ``--model``, ``PORT_ONLY``) for
every shipped config, with and without CLI overrides; every boolean flag settable from a file; the same
errors; the same ``config_resolved.json``. Exact equality throughout."""

import argparse
import glob
import json
import os

import pytest

from cvnerf_torch import config as tconfig
from cvnerf_tpu import config as jconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.txt")))
OVERRIDES = [
    [],
    ["--iters", "61", "--no-white_bkg", "--lr", "1e-3", "--name", "x"],
    ["--half_res", "--testskip", "1", "--no-bf16", "--track_best",
     "--chunk", "8192", "--freq_anneal", "0.08", "--pallas", "off"],
]


# The port's own flags, which the JAX parser does not have.
PORT_ONLY = {("device", "_StoreAction", "cuda", ()),
             ("model", "_StoreAction", "nerf", ("nerf", "ngp"))}


def _vars(mod, argv):
    out = vars(mod.parse_args(argv))
    for dest, *_ in PORT_ONLY:
        out.pop(dest, None)
    return out


@pytest.mark.parametrize("extra", OVERRIDES, ids=["plain", "overrides",
                                                   "bools"])
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_parse_matches_jax_for_every_config(path, extra):
    argv = ["--config", path, *extra]
    assert _vars(tconfig, argv) == _vars(jconfig, argv)


def test_parse_without_a_config_matches_jax():
    assert _vars(tconfig, []) == _vars(jconfig, [])
    assert tconfig.parse_args([]).device == "cuda"
    assert tconfig.parse_args(["--device", "cpu"]).device == "cpu"


def test_the_parsers_hold_the_same_flags():
    def flags(p):
        return {(a.dest, type(a).__name__, a.default,
                 tuple(a.choices or ())) for a in p._actions}
    port = flags(tconfig.build_parser())
    jax = flags(jconfig.build_parser())
    assert port - jax == PORT_ONLY
    assert jax <= port


def test_every_bool_flag_is_config_file_settable(tmp_path):
    parser = tconfig.build_parser()
    bools = sorted(a.dest for a in parser._actions
                   if isinstance(a, argparse.BooleanOptionalAction))
    assert bools == sorted(jconfig._bool_flags(jconfig.build_parser()))
    cfg = tmp_path / "all_bools.txt"
    for value in (True, False):
        cfg.write_text("".join(f"{b} = {value}\n" for b in bools))
        args = tconfig.parse_args(["--config", str(cfg)])
        for b in bools:
            assert getattr(args, b) is value, b
        assert _vars(tconfig, ["--config", str(cfg)]) == \
            _vars(jconfig, ["--config", str(cfg)])


@pytest.mark.parametrize("line", ["just words", "white_bkg = maybe"],
                         ids=["no_equals", "bad_boolean"])
def test_a_bad_line_raises_the_same_error(tmp_path, line):
    cfg = tmp_path / "bad.txt"
    cfg.write_text(f"name = x\n{line}\n")
    with pytest.raises(ValueError) as want:
        jconfig.parse_args(["--config", str(cfg)])
    with pytest.raises(ValueError) as got:
        tconfig.parse_args(["--config", str(cfg)])
    assert str(got.value) == str(want.value)


def test_resolve_freq_anneal_matches_jax():
    for v in (None, 0, 0.0, 0.08, 0.5, 1, 240, 4000.0):
        for iters in (1, 3000, 50000):
            assert tconfig.resolve_freq_anneal(v, iters) == \
                jconfig.resolve_freq_anneal(v, iters)


def test_snapshot_config_writes_the_same_json(tmp_path):
    argv = ["--config", os.path.join(ROOT, "configs", "lego.txt"),
            "--iters", "61"]
    tpath = tconfig.snapshot_config(tconfig.parse_args(argv),
                                    str(tmp_path / "t"))
    jpath = jconfig.snapshot_config(jconfig.parse_args(argv),
                                    str(tmp_path / "j"))
    got, want = json.load(open(tpath)), json.load(open(jpath))
    assert got.pop("device") == "cuda"
    assert got == want
    assert os.path.basename(tpath) == os.path.basename(jpath)
