"""Port parity on the CPU: the NeRF eval CLI (plenoctree_tpu_torch/cli/eval.py,
utils/io.py) against the JAX package's on one checkpoint: psnr.txt and
ssim.txt, the eval scalars, the PNGs, and the poll mode. Small sizes: a
2 x 32 SH-degree-1 NeRF, 8 + 8 samples, a blender-layout scene of 2 test
views at 24 x 24.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from plenoctree_tpu.cli import eval as jeval_cli
from plenoctree_tpu_torch.cli import eval as eval_cli
from plenoctree_tpu_torch.data.synthetic import write_blender_dataset
from plenoctree_tpu_torch.models.nerf import construct_nerf
from plenoctree_tpu_torch.models.params import init_trunk_params, params_from_flax
from plenoctree_tpu_torch.utils import checkpoints as ckpt
from plenoctree_tpu_torch.utils import config as tconfig
from plenoctree_tpu_torch.utils import io as io_utils
from plenoctree_tpu_torch.utils.metrics_writer import read_scalars
from plenoctree_tpu_torch.utils.png import read_png

torch.set_num_threads(1)  # as tests/test_torch_extract.py: several xdist workers share the cores

# Explicit flags, no --config: the JAX CLIs let the config file override
# the command line, the port's CLIs the other way round.
MODEL = ["--nouse_viewdirs", "--net_depth", "2", "--net_width", "32", "--sh_deg", "1",
         "--num_coarse_samples", "8", "--num_fine_samples", "8", "--chunk", "256",
         "--factor", "0", "--norandomized"]
# The two packages' averages: f32 models whose sums run in other orders
# (the whole-model forward agrees to 1e-5, tests/test_torch_train.py).
METRIC_ATOL = 1e-3


def _write_checkpoint(train_dir, step, seed=0):
    """A port checkpoint of the MODEL net with seeded weights (biases
    N(0, 0.3), so the renders are not flat). The sigma heads' biases are
    raised by 2 so that no ray is empty: an empty ray's disparity is
    1 / max(eps, depth / acc) with depth and acc near 0, where the last
    sample's 1e10 far cap makes it ill-conditioned (ROADMAP.md's traps);
    with the biases as drawn one disparity pixel of 576 differed by 164
    levels between the packages."""
    cfg = tconfig.default_config(net_depth=2, net_width=32, sh_deg=1, num_coarse_samples=8,
                                 num_fine_samples=8, use_viewdirs=False)
    model = construct_nerf(cfg)
    rng = np.random.default_rng(seed)
    tree = {name: init_trunk_params(rng, 63, 2, 32, 4, 1, 12, bias_std=0.3)
            for name in ("MLP_0", "MLP_1")}
    for mlp in tree.values():
        mlp["Dense_2"]["bias"] += 2.0
    model.load_state_dict(params_from_flax(tree))
    state = ckpt.create_train_state(model)
    state.step = step
    ckpt.save_checkpoint(train_dir, state, step)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("nerf_eval")
    return write_blender_dataset(str(root / "data"), n_train=1, n_test=2, resolution=24)


def _run_jax(argv):
    jeval_cli.FLAGS(["eval"] + argv)
    try:
        jeval_cli.main(None)
    finally:
        jeval_cli.FLAGS.unparse_flags()


def _read(path):
    with open(path) as f:
        return float(f.read())


def test_eval_cli_matches_jax(scene, tmp_path):
    """One checkpoint (written by the port, restored by each package), each
    package's eval CLI into its own train dir: psnr.txt / ssim.txt within
    METRIC_ATOL, the eval scalars written, every PNG (colour and greyscale
    disparity, as PIL writes a 2-D image) within one level."""
    dirs = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        _write_checkpoint(d, 3)
        dirs[pkg] = d
    common = MODEL + ["--dataset", "blender", "--data_dir", scene]
    _run_jax(common + ["--train_dir", dirs["jax"]])
    psnr, ssim = eval_cli.main(common + ["--train_dir", dirs["port"], "--device", "cpu"])
    assert np.isfinite(psnr) and 5.0 < psnr < 40.0
    for name in ("psnr.txt", "ssim.txt"):
        got, want = (_read(os.path.join(dirs[p], name)) for p in ("port", "jax"))
        assert abs(got - want) <= METRIC_ATOL, (name, got, want)
    assert _read(os.path.join(dirs["port"], "psnr.txt")) == psnr
    assert read_scalars(os.path.join(dirs["port"], "eval"), "eval_psnr") == [(3, psnr)]
    assert read_scalars(os.path.join(dirs["port"], "eval"), "eval_ssim") == [(3, ssim)]
    names = sorted(os.listdir(os.path.join(dirs["jax"], "test_preds")))
    assert names == ["000.png", "001.png", "disp_000.png", "disp_001.png"]
    assert sorted(os.listdir(os.path.join(dirs["port"], "test_preds"))) == names
    for name in names:
        want = np.array(Image.open(os.path.join(dirs["jax"], "test_preds", name)))
        got = read_png(os.path.join(dirs["port"], "test_preds", name))
        if want.ndim == 2:
            want = want[..., None]
        assert got.shape == want.shape == (24, 24, 1 if name.startswith("disp") else 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


def test_eval_cli_skip_and_no_output(scene, tmp_path):
    """--approx_eval_skip 2 evaluates view 0 only; --nosave_output writes no
    PNGs; --render_path, ported now, is refused for a blender scene as the
    loader refuses it (the LLFF render path: tests/test_torch_datasets.py),
    and --dataset llff on a blender scene's directory finds no images/."""
    d = str(tmp_path / "t")
    _write_checkpoint(d, 1)
    common = MODEL + ["--dataset", "blender", "--data_dir", scene, "--train_dir", d,
                      "--device", "cpu"]
    psnr, _ = eval_cli.main(common + ["--approx_eval_skip", "2", "--nosave_output"])
    assert not os.path.exists(os.path.join(d, "test_preds"))
    full, _ = eval_cli.main(common)
    assert psnr != full and np.isfinite(psnr)
    with pytest.raises(ValueError, match="render_path cannot be used for the blender"):
        eval_cli.main(common + ["--render_path"])
    with pytest.raises(ValueError, match="doesn't exist"):
        eval_cli.main(common + ["--dataset", "llff"])


def test_eval_cli_polls_until_max_steps(scene, tmp_path, monkeypatch):
    """Without --eval_once the CLI evaluates the newest checkpoint, then waits
    (10 s sleeps) for a newer one and stops after evaluating one at
    max_steps: here the sleep stands in for the trainer and writes
    checkpoint_7."""
    d = str(tmp_path / "t")
    _write_checkpoint(d, 5)
    sleeps = []

    def fake_sleep(seconds):
        sleeps.append(seconds)
        if len(sleeps) == 2:
            _write_checkpoint(d, 7, seed=1)

    monkeypatch.setattr(eval_cli.time, "sleep", fake_sleep)
    eval_cli.main(MODEL + ["--dataset", "blender", "--data_dir", scene, "--train_dir", d,
                           "--device", "cpu", "--noeval_once", "--max_steps", "7",
                           "--nosave_output"])
    assert sleeps == [eval_cli.POLL_SECONDS] * 2
    steps = [s for s, _ in read_scalars(os.path.join(d, "eval"), "eval_psnr")]
    assert steps == [5, 7]


def test_save_img_matches_pil(tmp_path):
    """save_img's clip, x255 and truncating uint8 cast, as the JAX package's
    (through PIL) writes them: RGB and 2-D greyscale."""
    rng = np.random.default_rng(0)
    for shape in ((9, 11, 3), (9, 11)):
        img = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
        path = str(tmp_path / f"{len(shape)}.png")
        io_utils.save_img(img, path)
        want = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
        np.testing.assert_array_equal(np.array(Image.open(path)), want)
        assert json.dumps(read_png(path).shape[:2]) == json.dumps(shape[:2])
