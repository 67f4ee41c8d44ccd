"""The port's LPIPS (``cvnerf_torch/utils/lpips.py``) against the JAX
package's.

No pretrained weights exist here, so both sides load one numpy-seeded
random bundle of the published shapes from the same ``.npz``. Distances of
the same image pairs agree to 1e-5 relative (the convolutions' fp32 sums
run in different orders); the loader refuses what the JAX loader refuses,
with the same messages.
"""

import numpy as np
import pytest
import torch

from cvnerf_tpu.utils import lpips as jlp
from cvnerf_torch.utils import lpips as tlp


def _bundle(path, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for i, (ch, k, _, _) in enumerate(jlp._STAGES):
        cin = 3 if i == 0 else jlp._STAGES[i - 1][0]
        out[f"conv{i}_w"] = rng.randn(ch, cin, k, k).astype(np.float32) * 0.1
        out[f"conv{i}_b"] = rng.randn(ch).astype(np.float32) * 0.1
        out[f"lin{i}"] = rng.rand(ch).astype(np.float32)
    np.savez(path, **out)
    return out


@pytest.mark.parametrize("shape", [(32, 32), (67, 53)])
def test_distances_match_jax(tmp_path, shape):
    path = str(tmp_path / "w.npz")
    _bundle(path)
    jw, tw = jlp.load_weights(path), tlp.load_weights(path)
    rng = np.random.RandomState(sum(shape))
    a = rng.rand(*shape, 3).astype(np.float32)
    near = np.clip(a + 0.02 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    far = rng.rand(*shape, 3).astype(np.float32)
    for b in (near, far):
        want = jlp.lpips_images(a, b, jw)
        got = tlp.lpips_images(a, b, tw)
        assert want > 0
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert tlp.lpips_images(torch.from_numpy(b), torch.from_numpy(a),
                                tw) == pytest.approx(got, rel=1e-6)
    assert abs(tlp.lpips_images(a, a, path)) < 1e-9
    assert tlp.lpips_images(a, near, tw) < tlp.lpips_images(a, far, tw)


def test_loader_refuses_what_the_jax_loader_refuses(tmp_path):
    with pytest.raises(FileNotFoundError, match="export"):
        tlp.load_weights(str(tmp_path / "missing.npz"))
    for name, edit in (("lin3", lambda b: b.pop("lin3")),
                       ("conv2_w", lambda b: b.__setitem__(
                           "conv2_w", b["conv2_w"][:, :10])),
                       ("lin1", lambda b: b.__setitem__(
                           "lin1", b["lin1"][:5]))):
        bad = _bundle(str(tmp_path / "ok.npz"))
        edit(bad)
        path = str(tmp_path / f"bad_{name}.npz")
        np.savez(path, **bad)
        with pytest.raises(ValueError) as mine:
            tlp.load_weights(path)
        with pytest.raises(ValueError) as theirs:
            jlp.load_weights(path)
        assert name in str(mine.value)
        assert str(mine.value) == str(theirs.value)


def test_shape_checks_and_the_export_snippet(tmp_path):
    _bundle(str(tmp_path / "w.npz"))
    tw = tlp.load_weights(str(tmp_path / "w.npz"))
    a = np.zeros((48, 48, 3), np.float32)
    with pytest.raises(ValueError, match="matching"):
        tlp.lpips_images(a, np.zeros((48, 40, 3), np.float32), tw)
    with pytest.raises(ValueError, match="too small"):
        tlp.lpips_images(np.zeros((16, 16, 3), np.float32),
                         np.zeros((16, 16, 3), np.float32), tw)
    assert tlp.export_weights_script() == jlp.export_weights_script()


def test_eval_reports_lpips_as_the_jax_eval(tmp_path):
    """``python -m cvnerf_torch.eval --lpips_weights`` scores each view and
    the mean as ``cvnerf_tpu.eval`` does on the same weights (a state
    carried over with ``train_state_from_jax``): the LPIPS values, rounded
    to 5 decimals by both, within 2e-5 (1e-5 relative plus the
    rounding)."""
    import dataclasses
    import json
    import os

    import jax

    from cvnerf_torch.eval import main as eval_main
    from cvnerf_torch.train.checkpoint import save_checkpoint
    from cvnerf_torch.utils.convert import train_state_from_jax
    from cvnerf_tpu.config import parse_args as jax_parse_args
    from cvnerf_tpu.config import snapshot_config as jax_snapshot_config
    from cvnerf_tpu.data.synthetic import make_blender_dataset
    from cvnerf_tpu.eval import main as jax_eval_main
    from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
    from cvnerf_tpu.serve import write_scene_snapshot
    from cvnerf_tpu.train.checkpoint import save_checkpoint as jax_save
    from cvnerf_tpu.train.state import create_train_state as jax_create

    tiny = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)
    data, run_dir = str(tmp_path / "scene"), str(tmp_path / "run")
    make_blender_dataset(data, n_train=1, n_val=1, n_test=2, h=32, w=32)
    jax_snapshot_config(jax_parse_args(["--dtype", "blender", "--white_bkg",
                                        "--testskip", "1"]), run_dir)
    write_scene_snapshot(run_dir, height=32, width=32,
                         focal=0.5 * 32 / np.tan(0.4), near=2.0, far=6.0,
                         ndc=False, ndc_variant="canonical", white_bkg=True,
                         n_coarse=8, n_fine=8, bf16=False,
                         mlp=JaxCfg(**tiny))
    st = jax.tree.map(np.asarray, jax_create(jax.random.PRNGKey(3),
                                             mlp=JaxCfg(**tiny)))
    for net in st.params.values():
        net["alpha"]["b"] = net["alpha"]["b"] + 1.0
    st = dataclasses.replace(st, step=np.int32(5))
    jax_save(os.path.join(run_dir, "checkpoints"), st)
    save_checkpoint(os.path.join(run_dir, "torch_checkpoints"),
                    train_state_from_jax(st))
    weights = str(tmp_path / "w.npz")
    _bundle(weights)
    argv = ["--run", run_dir, "--data_dir", data, "--chunk", "256",
            "--lpips_weights", weights]
    got = eval_main([*argv, "--device", "cpu"])
    jax_eval_main([*argv, "--out", str(tmp_path / "j.json")])
    with open(tmp_path / "j.json") as fp:
        want = json.load(fp)
    assert got["n_views"] == want["n_views"] == 2
    assert abs(got["lpips"] - want["lpips"]) <= 2e-5
    for a, b in zip(got["per_view"], want["per_view"]):
        assert a["lpips"] > 0 and abs(a["lpips"] - b["lpips"]) <= 2e-5
