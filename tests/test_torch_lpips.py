"""Port parity on the CPU: the torch VGG-LPIPS (plenoctree_tpu_torch/ops/
lpips.py) against the JAX package's ops/lpips.py, on seeded random weights
in the shared npz layout (the pretrained weights cannot be downloaded).

LPIPS_RTOL = 1e-5: the same network in f32; the convolutions accumulate in
another order (oneDNN vs XLA) and the distance is a mean of small squared
differences (measured <= 2.2e-7 relative).
"""

import numpy as np
import pytest
import torch

from plenoctree_tpu.ops import lpips as J
from plenoctree_tpu_torch.ops import lpips as P

torch.set_num_threads(1)  # see tests/test_torch_tile_opt.py

LPIPS_RTOL = 1e-5


def random_weights(rng):
    """Seeded VGG16 + LPIPS-head weights in the npz layout: conv kernels
    HWIO N(0, 0.05), biases N(0, 0.01), heads U(0, 1)."""
    w = {}
    cin, conv_i = 3, 0
    for v in J._VGG_CFG:
        if v == "M":
            continue
        w[f"conv{conv_i}/kernel"] = (rng.normal(size=(3, 3, cin, v)) * 0.05).astype(np.float32)
        w[f"conv{conv_i}/bias"] = (rng.normal(size=(v,)) * 0.01).astype(np.float32)
        cin, conv_i = v, conv_i + 1
    for i, (_, c) in enumerate(J.tap_structure()):
        w[f"lin{i}"] = rng.random(size=(c,)).astype(np.float32)
    return w


def test_tap_structure_equal():
    assert P.tap_structure() == J.tap_structure()
    assert [t[0] for t in P.tap_structure()] == [3, 8, 15, 22, 29]
    assert P._VGG_CFG == J._VGG_CFG and P._TAP_AFTER == J._TAP_AFTER


@pytest.mark.parametrize("size", [(32, 32), (37, 45)])
def test_distance_matches_jax(size, tmp_path, monkeypatch):
    rng = np.random.default_rng(sum(size))
    w = random_weights(rng)
    img0 = rng.random(size + (3,)).astype(np.float32)
    img1 = np.clip(img0 + 0.2 * rng.standard_normal(img0.shape), 0, 1).astype(np.float32)
    want = float(J._lpips_distance(w, img0, img1))
    path = tmp_path / "w.npz"
    np.savez(path, **w)
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(path))
    fn = P.get_lpips_fn("cpu")
    got = fn(img0, img1)
    assert want > 1e-3 and abs(got - want) <= LPIPS_RTOL * want, (got, want)
    assert fn(img0, img0) == pytest.approx(0.0, abs=1e-7)
    assert fn(torch.from_numpy(img1), img0) == pytest.approx(got, rel=LPIPS_RTOL)


def test_feature_shapes_and_layout():
    """NCHW taps of the right widths; the HWIO -> OIHW transpose gives the
    JAX package's first feature map."""
    import jax.numpy as jnp

    w = random_weights(np.random.default_rng(1))
    x = np.random.default_rng(2).random((1, 16, 16, 3)).astype(np.float32) * 2 - 1
    tw = {k: torch.from_numpy(v.transpose(3, 2, 0, 1).copy() if k.endswith("/kernel") else v)
          for k, v in w.items()}
    feats = P._vgg_features(tw, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(f.shape[1:]) for f in feats] == [(64, 16, 16), (128, 8, 8), (256, 4, 4),
                                                   (512, 2, 2), (512, 1, 1)]
    want = np.asarray(J._vgg_features(w, jnp.asarray(x))[0])
    np.testing.assert_allclose(feats[0].permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-6)


def test_no_weights_gives_none(tmp_path, monkeypatch):
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path / "missing.npz"))
    assert P.get_lpips_fn("cpu") is None
    monkeypatch.delenv("LPIPS_WEIGHTS_NPZ")
    # The default file is the port's own, not the JAX package's.
    assert P._weights_path().endswith("plenoctree_tpu_torch/ops/../data/lpips_vgg.npz")
