"""The NSVF and LLFF loaders (PNG and JPEG frames), the LLFF pose
helpers, the fixture writers and the area resize: the port against the JAX
package (and PIL, cv2) on the CPU.

Fixtures are written by both packages' writers (the port's through
utils/png.py, the JAX package's through PIL) at small sizes; the loaders
read them with the same flags. Rays and poses agree to 1e-6 (measured: bit
for bit), pixels are equal.
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from plenoctree_tpu.data import get_dataset as jax_get_dataset
from plenoctree_tpu.data import poses as jposes
from plenoctree_tpu.data import synthetic as jsynthetic
from plenoctree_tpu.utils import config as jconfig
from plenoctree_tpu_torch.data import poses as tposes
from plenoctree_tpu_torch.data import synthetic as tsynthetic
from plenoctree_tpu_torch.data.datasets import _resize_area, get_dataset
from plenoctree_tpu_torch.utils import config as tconfig

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{(kind, package): directory} of fixtures written by each writer."""
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for pkg, mod in (("port", tsynthetic), ("jax", jsynthetic)):
        out["nsvf", pkg] = mod.write_nsvf_dataset(str(root / f"nsvf_{pkg}"), n_train=4,
                                                  n_test=2, resolution=16)
        out["llff", pkg] = mod.write_llff_dataset(str(root / f"llff_{pkg}"), n_views=7,
                                                  resolution=16)
    return out


def _both(scenes, kind, split, **flags):
    kw = dict(dict(dataset=kind, batch_size=8, factor=0, llffhold=3), **flags)
    port = get_dataset(split, tconfig.default_config(data_dir=scenes[kind, "port"], **kw))
    ref = jax_get_dataset(split, jconfig.default_config(data_dir=scenes[kind, "jax"], **kw),
                          prefetch=False)
    return port, ref


def _same(port, ref):
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_allclose(port.camtoworlds, ref.camtoworlds, **TOL)
    assert (port.h, port.w, port.size) == (ref.h, ref.w, ref.size)
    np.testing.assert_allclose(port.focal, ref.focal, rtol=1e-7)
    for a, b in zip(port.rays, ref.rays):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("factor", [0, 2])
def test_nsvf_loader_matches_jax(scenes, split, factor):
    """Split prefixes (test falls back to 1_ when there is no 2_), the
    cam_trans round trip, --factor 2 (box mean; JAX: cv2 INTER_AREA), the
    focal, the rays, and bbox.txt."""
    port, ref = _both(scenes, "nsvf", split, factor=factor)
    assert port.size == (4 if split == "train" else 2)
    assert port.h == 16 // max(factor, 1)
    np.testing.assert_allclose(port.images, ref.images, rtol=0, atol=1e-6)  # cv2 vs numpy mean
    if factor == 0:
        _same(port, ref)
    np.testing.assert_array_equal(port.bbox, ref.bbox)
    np.testing.assert_allclose(port.bbox[:6], [-1, -1, -1, 1, 1, 1])
    if split == "train":
        batch = next(port)
        assert batch["pixels"].shape == (8, 3) and batch["rays"].origins.shape == (8, 3)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("mode", ["ndc", "spherify"])
def test_llff_loader_matches_jax(scenes, split, mode):
    """llffhold split, recentring, spherify or NDC rays, and on the test
    split the render path's rays (a spiral, or a circle when spherified),
    against the JAX loader."""
    port, ref = _both(scenes, "llff", split, spherify=mode == "spherify")
    assert port.size == (4 if split == "train" else 3)
    _same(port, ref)
    if split == "test":
        assert port.render_rays.origins.shape == (120, 16, 16, 3)
        for a, b in zip(port.render_rays, ref.render_rays):
            np.testing.assert_allclose(a, b, **TOL)
    if mode == "ndc":
        # NDC origins lie on the near plane z = -1 of the NDC cube
        np.testing.assert_allclose(port.rays.origins[..., 2], -1.0, atol=1e-5)


def test_llff_render_path_serves_path_rays(scenes):
    """--render_path: the test split yields the path's rays, without
    pixels, one pose after another."""
    port, ref = _both(scenes, "llff", "test", render_path=True)
    assert port.size == ref.size == 120
    for _ in range(2):
        a, b = next(port), next(ref)
        assert "pixels" not in a
        for x, y in zip(a["rays"], b["rays"]):
            np.testing.assert_allclose(x, y, **TOL)
    with pytest.raises(ValueError, match="render_path"):
        _both(scenes, "nsvf", "test", render_path=True)


def test_pose_helpers_match_jax():
    """normalize, viewmatrix, poses_avg, recenter_poses, spiral_path and
    spherify_poses against the JAX package's at 1e-6."""
    rng = np.random.default_rng(0)
    poses = []
    for _ in range(6):
        back = np.array([0.1 * rng.standard_normal(), 0.1 * rng.standard_normal(), 1.0])
        pos = np.array([0.5 * rng.standard_normal(), 0.5 * rng.standard_normal(), 3.0])
        m = tposes.viewmatrix(back, np.array([0.0, 1.0, 0.0]), pos)
        np.testing.assert_allclose(m, jposes.viewmatrix(back, np.array([0.0, 1.0, 0.0]), pos),
                                   **TOL)
        poses.append(np.concatenate([m, [[16.0], [16.0], [20.0]]], 1))
    poses = np.stack(poses).astype(np.float32)
    bds = rng.uniform(1.0, 6.0, (6, 2)).astype(np.float32)
    v = rng.normal(size=3)
    np.testing.assert_allclose(tposes.normalize(v), jposes.normalize(v), **TOL)
    np.testing.assert_allclose(tposes.poses_avg(poses), jposes.poses_avg(poses), **TOL)
    np.testing.assert_allclose(tposes.recenter_poses(poses), jposes.recenter_poses(poses), **TOL)
    np.testing.assert_allclose(tposes.spiral_path(poses, bds), jposes.spiral_path(poses, bds),
                               **TOL)
    for a, b in zip(tposes.spherify_poses(poses, bds, True),
                    jposes.spherify_poses(poses, bds, True)):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("kind", ["nsvf", "llff"])
def test_writers_match_the_jax_writers(scenes, kind):
    """The port's fixture writers (utils/png.py) against the JAX package's
    (PIL): the same files, every PNG decoded by PIL to the same pixels, the
    same text and npy files."""
    a, b = scenes[kind, "port"], scenes[kind, "jax"]
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    for rel in files:
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.array(Image.open(os.path.join(a, rel))),
                                          np.array(Image.open(os.path.join(b, rel))))
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(a, rel)),
                                          np.load(os.path.join(b, rel)))
        else:
            np.testing.assert_array_equal(np.loadtxt(os.path.join(a, rel)),
                                          np.loadtxt(os.path.join(b, rel)))


@pytest.mark.parametrize("k,shape", [
    (3, (18, 24, 3)), (4, (16, 12, 4)), (8, (32, 40, 3)),  # the factor divides the size
    (2, (50, 67, 3)), (4, (23, 37, 3)), (16, (1080, 1920, 3)),  # it does not
    (2, (50, 67, 4)), (4, (23, 37, 4)), (5, (48, 48, 3)), (2, (48, 64, 4)), (2, (49, 51)),
])
def test_resize_area_matches_cv2(k, shape):
    """The loaders' --factor k: cv2.resize(INTER_AREA) to (w // k, h // k),
    bitwise (cv2's float32 summation order mirrored): its integer-scale
    path where k divides the size (the 2x2 SIMD sums at 1 and 4 channels),
    its fractional-weight path where it does not (67x50 / 2, 37x23 / 4,
    1920x1080 / 16: the parent's box mean dropped the remainder rows and
    columns and was 0.39, 0.26 and 0.06 away)."""
    img = np.random.default_rng(k * shape[0]).random(shape, dtype=np.float32)
    want = cv2.resize(img, (shape[1] // k, shape[0] // k), interpolation=cv2.INTER_AREA)
    got = _resize_area(img, shape[1] // k, shape[0] // k)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def nsvf48(tmp_path_factory):
    root = tmp_path_factory.mktemp("nsvf48")
    return {pkg: mod.write_nsvf_dataset(str(root / pkg), n_train=3, n_test=2, resolution=48)
            for pkg, mod in (("port", tsynthetic), ("jax", jsynthetic))}


@pytest.mark.parametrize("split", ["train", "test"])
def test_nsvf_loader_at_a_factor_that_does_not_divide(nsvf48, split):
    """--factor 5 on 48x48 views (9x9, cv2's general INTER_AREA path):
    images bitwise the JAX loader's, the focal divided by 5."""
    kw = dict(dataset="nsvf", batch_size=8, factor=5)
    port = get_dataset(split, tconfig.default_config(data_dir=nsvf48["port"], **kw))
    ref = jax_get_dataset(split, jconfig.default_config(data_dir=nsvf48["jax"], **kw),
                          prefetch=False)
    assert (port.h, port.w) == (ref.h, ref.w) == (9, 9)
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_allclose(port.focal, ref.focal, rtol=1e-7)
    for a, b in zip(port.rays, ref.rays):
        np.testing.assert_allclose(a, b, **TOL)


def _as_jpeg(src, dst, kind):
    """A copy of a fixture scene with every frame a JPEG written by PIL
    (4:2:0, quality 90, restart intervals on every other frame)."""
    import shutil

    shutil.copytree(src, dst)
    folder = os.path.join(dst, "rgb" if kind == "nsvf" else "images")
    for i, name in enumerate(sorted(os.listdir(folder))):
        png = os.path.join(folder, name)
        Image.open(png).convert("RGB").save(png[:-4] + ".jpg", format="JPEG", quality=90,
                                            **({"restart_marker_blocks": 1} if i % 2 else {}))
        os.remove(png)
    return dst


@pytest.mark.parametrize("kind", ["nsvf", "llff", "llff_spherify"])
def test_jpeg_frames_load_and_equal_the_jax_loaders(scenes, tmp_path, kind, capsys):
    """Every frame a JPEG: the port's loaders (utils/jpeg.py) read the
    same images as the JAX loaders (PIL) and make the same rays, bitwise;
    LLFF with NDC rays and spherified. One `jpeg:` line names the path."""
    base = kind.split("_")[0]
    d = _as_jpeg(scenes[base, "port"], str(tmp_path / kind), base)
    kw = dict(dataset=base, data_dir=d, batch_size=8, factor=0, llffhold=3,
              spherify=kind == "llff_spherify")
    for split in ("train", "test"):
        port = get_dataset(split, tconfig.default_config(**kw))
        assert "jpeg:" in capsys.readouterr().out
        ref = jax_get_dataset(split, jconfig.default_config(**kw), prefetch=False)
        assert port.images.dtype == ref.images.dtype == np.float32
        np.testing.assert_array_equal(port.images, ref.images)
        for a, b in zip(port.rays, ref.rays):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if split == "test" and base == "llff":
            for a, b in zip(port.render_rays, ref.render_rays):
                np.testing.assert_array_equal(a, b)


def test_cmyk_jpeg_frame_raises_naming_the_file(scenes, tmp_path):
    """A 4-component (CMYK) JPEG frame raises a ValueError naming it (PIL
    gives 4 channels there, which the JAX loader takes for RGBA)."""
    d = _as_jpeg(scenes["nsvf", "port"], str(tmp_path / "cmyk"), "nsvf")
    first = sorted(os.listdir(os.path.join(d, "rgb")))[0]
    path = os.path.join(d, "rgb", first)
    Image.open(path).convert("CMYK").save(path, format="JPEG")
    cfg = tconfig.default_config(dataset="nsvf", data_dir=d, batch_size=8, factor=0)
    with pytest.raises(ValueError, match=rf"{first}: 4-component \(CMYK/YCCK\)"):
        get_dataset("train", cfg)


def test_llff_eval_cli_render_path_and_normalized_disparity(scenes, tmp_path):
    """The NeRF eval CLI on an LLFF scene: test views with PSNR and a
    disparity min-max normalised to [0, 1] per image (engine.render_image's
    normalize_disp, the JAX engine's formula); --render_path writes the
    spiral's frames into path_renders/ and computes no metrics."""
    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.cli import eval as eval_cli
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.models.nerf import construct_nerf
    from plenoctree_tpu_torch.utils import checkpoints as ckpt
    from plenoctree_tpu_torch.utils.png import read_png

    model_flags = ["--dataset", "llff", "--data_dir", scenes["llff", "port"], "--factor", "0",
                   "--llffhold", "3", "--net_depth", "2", "--net_width", "16",
                   "--num_coarse_samples", "4", "--num_fine_samples", "4", "--sh_deg", "1",
                   "--nouse_viewdirs", "--chunk", "1024", "--device", "cpu"]
    d = str(tmp_path / "t")
    cfg = tconfig.parse_flags(train_cli.build_parser(), model_flags + ["--train_dir", d])
    model = construct_nerf(cfg, seed=0)
    state = ckpt.create_train_state(model)
    state.step = 1
    ckpt.save_checkpoint(d, state, 1)
    psnr, ssim = eval_cli.main(model_flags + ["--train_dir", d, "--eval_once"])
    assert np.isfinite(psnr) and np.isfinite(ssim)
    disp = read_png(os.path.join(d, "test_preds", "disp_000.png"))
    assert disp.min() == 0 and disp.max() >= 254
    test = get_dataset("test", cfg)
    _, raw, _ = engine.render_image(model, next(test)["rays"], chunk=1024)
    _, norm, _ = engine.render_image(model, next(get_dataset("test", cfg))["rays"], chunk=1024,
                                     normalize_disp=True)
    np.testing.assert_allclose(norm, (raw - raw.min()) / (raw.max() - raw.min()), rtol=1e-6)
    os.remove(os.path.join(d, "psnr.txt"))
    psnr, _ = eval_cli.main(model_flags + ["--train_dir", d, "--eval_once", "--render_path"])
    assert np.isnan(psnr) and not os.path.exists(os.path.join(d, "psnr.txt"))
    frames = sorted(os.listdir(os.path.join(d, "path_renders")))
    assert len(frames) == 240 and frames[0] == "000.png"  # colour and disparity per pose
    assert read_png(os.path.join(d, "path_renders", "119.png")).shape == (16, 16, 3)
