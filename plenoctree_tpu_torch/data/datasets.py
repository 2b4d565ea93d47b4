"""Dataset loaders (host numpy): the `Dataset` base, Blender, LLFF, NSVF
and Synthetic.

Port of plenoctree_tpu/data/datasets.py. Batches leave this module as host
numpy; the renderer moves what it needs to its device. Under a process
group each rank's train split serves batch_size // data rays (the JAX
package's per-host split; `data` is the world size without tensor
parallelism), from a sampler seeded with the rank's data index. Differences
from the JAX package: no prefetch thread (batches are built on demand), a
seeded batch sampler, and no PIL or cv2. Frames are read by their
signature, PNG through the port's own decoder (`utils/png.py`) and JPEG
through its own (`utils/jpeg.py`), each giving the pixels PIL gives; any
other file raises a ValueError naming it. A split's frames are decoded on a
thread pool, in file order, and a loader that read a JPEG prints one
`jpeg:` line naming the decoder's path. Downsampling is `_resize_area`, a
numpy port of cv2's INTER_AREA at any ratio, where the JAX package calls
cv2.
"""

import json
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from os import path

import numpy as np

from plenoctree_tpu_torch.data import poses as pose_utils
from plenoctree_tpu_torch.data.rays import Rays, convert_to_ndc, generate_rays, namedtuple_map
from plenoctree_tpu_torch.data.synthetic import render_synthetic_scene
from plenoctree_tpu_torch.parallel import mesh as mesh_lib
from plenoctree_tpu_torch.utils import jpeg
from plenoctree_tpu_torch.utils.png import is_png, read_png


def get_dataset(split, args):
    if args.dataset not in dataset_dict:
        raise NotImplementedError(
            f"dataset {args.dataset!r} is not ported yet (ROADMAP.md); "
            f"ported: {sorted(dataset_dict)}"
        )
    return dataset_dict[args.dataset](split, args)


def _area_table(ssize, dsize):
    """cv2's computeResizeAreaTab: (destination, source, weight) entries in
    the order cv2 accumulates them (weights float32, as cv2 stores them)."""
    scale = 1.0 / (dsize / ssize)
    dst, src, weight = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            dst.append(dx), src.append(sx1 - 1), weight.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            dst.append(dx), src.append(sx), weight.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            dst.append(dx), src.append(sx2), weight.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return np.array(dst), np.array(src), np.array(weight, np.float32)


def _weighted_sums(x, n, table):
    """out[d] = the float32 sum, in table order, of w * x[s] over d's
    entries along axis 0 (cv2's resizeArea_ row and column passes)."""
    dst, src, w = table
    out = np.zeros((n,) + x.shape[1:], np.float32)
    nth = np.arange(dst.size) - np.searchsorted(dst, dst)  # entry's place within its run
    for k in range(int(nth.max()) + 1):
        sel = nth == k
        wk = w[sel].reshape((-1,) + (1,) * (x.ndim - 1))
        out[dst[sel]] += x[src[sel]] * wk
    return out


def _resize_area(image, new_w, new_h):
    """cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_AREA) of a
    float32 [H, W] or [H, W, C] image, downscaling, with cv2's float32
    summation order: its integer-scale path where both scales are integers
    (resizeAreaFast: a block's samples row by row, four at a time, times
    1/area; at 2x2 with 1 or 4 channels its 4-lane SIMD pairs, which give
    ((a + b) + (c + d)) * 0.25, on every whole group of 4 outputs of a
    row), else its general path (computeResizeAreaTab's fractional cell
    weights with their 1e-3 thresholds: each row's columns summed, then the
    rows)."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    if new_w > w or new_h > h or new_w < 1 or new_h < 1:
        raise ValueError(f"_resize_area downscales; {w}x{h} -> {new_w}x{new_h}")
    sx, sy = 1.0 / (new_w / w), 1.0 / (new_h / h)
    kx, ky = round(sx), round(sy)
    if abs(sx - kx) < np.finfo(np.float64).eps and abs(sy - ky) < np.finfo(np.float64).eps:
        blocks = image[: ky * new_h, : kx * new_w].reshape(new_h, ky, new_w, kx,
                                                           *image.shape[2:])
        vals = [blocks[:, y, :, x] for y in range(ky) for x in range(kx)]
        total = np.zeros_like(vals[0])
        k = 0
        while k + 4 <= len(vals):
            total += ((vals[k] + vals[k + 1]) + vals[k + 2]) + vals[k + 3]
            k += 4
        for v in vals[k:]:
            total += v
        out = total * (np.float32(1) / np.float32(len(vals)))
        cn = 1 if image.ndim == 2 else image.shape[2]
        if (kx, ky) == (2, 2) and cn in (1, 4):
            simd = ((vals[0] + vals[1]) + (vals[2] + vals[3])) * np.float32(0.25)
            cols = new_w if cn == 4 else new_w - new_w % 4
            out[:, :cols] = simd[:, :cols]
        return out
    cols = _weighted_sums(np.moveaxis(image, 1, 0), new_w, _area_table(w, new_w))
    return _weighted_sums(np.moveaxis(cols, 0, 1), new_h, _area_table(h, new_h))


class Dataset:
    """Base dataset: loads renderings, generates rays, serves batches."""

    def __init__(self, split, args):
        self.split = split
        if split == "train":
            self._train_init(args)
        elif split in ("test", "val"):
            self._test_init(args)
        else:
            raise ValueError(f"split must be train/val/test, got {split}")
        share, shares = mesh_lib.data_world()
        if split == "train" and args.batch_size % shares:
            raise ValueError(
                f"--batch_size {args.batch_size} does not divide over {shares} ranks"
            )
        self.batch_size = args.batch_size // shares
        self.image_batching = args.image_batching
        self.render_path = args.render_path
        # The training batch sampler: one stream per share of the batch (the
        # ranks along "model" take the same rows).
        self._rng = np.random.default_rng(share)

    def __iter__(self):
        return self

    def __next__(self):
        return self._next_train() if self.split == "train" else self._next_test()

    @property
    def size(self):
        return self.n_examples

    def __len__(self):
        return self.size

    def _train_init(self, args):
        self._load_renderings(args)
        self._generate_rays()
        if args.image_batching:
            self.images = self.images.reshape([-1, 3])
            self.rays = namedtuple_map(
                lambda r: r.reshape([-1, r.shape[-1]]), self.rays
            )
        else:
            self.images = self.images.reshape([-1, self.resolution, 3])
            self.rays = namedtuple_map(
                lambda r: r.reshape([-1, self.resolution, r.shape[-1]]), self.rays
            )

    def _test_init(self, args):
        self._load_renderings(args)
        self._generate_rays()
        self.it = 0

    def _next_train(self):
        if self.image_batching:
            idx = self._rng.integers(0, self.rays[0].shape[0], (self.batch_size,))
            pixels = self.images[idx]
            rays = namedtuple_map(lambda r: r[idx], self.rays)
        else:
            img = self._rng.integers(0, self.n_examples)
            idx = self._rng.integers(0, self.rays[0][0].shape[0], (self.batch_size,))
            pixels = self.images[img][idx]
            rays = namedtuple_map(lambda r: r[img][idx], self.rays)
        return {"pixels": pixels, "rays": rays}

    def _next_test(self):
        idx = self.it
        self.it = (self.it + 1) % self.n_examples
        if self.render_path:
            return {"rays": namedtuple_map(lambda r: r[idx], self.render_rays)}
        return {
            "pixels": self.images[idx],
            "rays": namedtuple_map(lambda r: r[idx], self.rays),
        }

    def _generate_rays(self):
        self.rays = _camera_rays(self.w, self.h, self.focal, self.camtoworlds)

    # The scene's bbox (NSVF bbox.txt: min xyz, max xyz, voxel size), None
    # elsewhere; the extract CLI's --bbox_from_data reads it.
    bbox = None


def _load_image(fname):
    """A frame as float32 in [0, 1], as np.array(Image.open(f)) / 255
    gives it: [H, W] greyscale, [H, W, C] otherwise."""
    if is_png(fname):
        image = read_png(fname)
        if image.shape[-1] == 1:
            image = image[..., 0]
    elif jpeg.is_jpeg(fname):
        image = jpeg.read_jpeg(fname)
    else:
        raise ValueError(f"{fname}: neither PNG nor JPEG; the port reads PNG and JPEG frames")
    return image.astype(np.float32) / 255.0


def _load_images(fnames):
    """_load_image of each file, on a thread pool (the C++ scan decoder and
    numpy release the GIL), in file order; prints one `jpeg:` line when any
    frame was a JPEG."""
    before = dict(jpeg.timing)
    workers = max(1, min(len(fnames), os.cpu_count() or 1, 8))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        images = list(pool.map(_load_image, fnames))
    wall = time.perf_counter() - t0
    files = jpeg.timing["files"] - before["files"]
    if files:
        nbytes = jpeg.timing["bytes"] - before["bytes"]
        pixels = jpeg.timing["pixels"] - before["pixels"]
        entropy = jpeg.timing["entropy_s"] - before["entropy_s"]
        rest = jpeg.timing["rest_s"] - before["rest_s"]
        print(f"jpeg: {files} frames, {nbytes} bytes, {8 * nbytes / pixels:.3f} bits/pixel, "
              f"{wall:.3f} s on {workers} threads (entropy decoding {entropy:.3f} s, the rest "
              f"{rest:.3f} s, summed over threads), {jpeg.summary()}", flush=True)
    return images


def _camera_rays(w, h, focal, camtoworlds, post=None):
    """generate_rays (then `post`) one camera at a time on a thread pool,
    each written into its slice of one array per field: bitwise the batched
    call, since every ray depends on its own camera alone, in a fraction of
    its time on a full-resolution capture (numpy's stacked 3x3 matmuls and
    the NDC's elementwise passes release the GIL)."""
    n = camtoworlds.shape[0]

    def one(i):
        rays = generate_rays(w, h, focal, camtoworlds[i:i + 1])
        return rays if post is None else post(rays)

    if n <= 1:
        return one(0) if n else generate_rays(w, h, focal, camtoworlds)
    out = None
    with ThreadPoolExecutor(max(1, min(n, os.cpu_count() or 1, 8))) as pool:
        for i, rays in enumerate(pool.map(one, range(n))):
            if out is None:
                out = Rays(*(np.empty((n,) + r.shape[1:], r.dtype) for r in rays))
            for dst, src in zip(out, rays):
                dst[i] = src[0]
    return out


def _composite_white(image, white_bkgd):
    if image.shape[-1] == 4 and white_bkgd:
        return image[..., :3] * image[..., -1:] + (1.0 - image[..., -1:])
    return image[..., :3]


class Blender(Dataset):
    """NeRF-synthetic: transforms_{split}.json + per-frame PNGs."""

    def _load_renderings(self, args):
        if args.render_path:
            raise ValueError("render_path cannot be used for the blender dataset.")
        with open(
            path.join(args.data_dir, f"transforms_{self.split}.json"), "r"
        ) as fp:
            meta = json.load(fp)
        if args.factor > 0 and args.factor != 2:
            raise ValueError(f"Blender dataset only supports factor=0 or 2, {args.factor} set.")
        frames = _load_images([os.path.join(args.data_dir, frame["file_path"] + ".png")
                               for frame in meta["frames"]])
        images, cams = [], []
        for frame, image in zip(meta["frames"], frames):
            if args.factor == 2:
                image = _resize_area(image, image.shape[1] // 2, image.shape[0] // 2)
            cams.append(frame["transform_matrix"])
            images.append(_composite_white(image, args.white_bkgd))
        self.images = np.stack(images, axis=0)
        self.h, self.w = self.images.shape[1:3]
        self.resolution = self.h * self.w
        self.camtoworlds = np.stack(cams, axis=0).astype(np.float32)
        self.focal = 0.5 * self.w / np.tan(0.5 * float(meta["camera_angle_x"]))
        self.n_examples = self.images.shape[0]


class LLFF(Dataset):
    """Real forward-facing / 360 captures: images[_N]/ + poses_bounds.npy.
    Every llffhold-th image is held out for test/val; rays are in NDC
    unless --spherify; the test split carries the render path (a spiral, or
    a circle when spherified) as `render_rays`."""

    def _load_renderings(self, args):
        data_dir = path.expanduser(args.data_dir)
        factor = args.factor if args.factor > 0 else 1
        imgdir = path.join(data_dir, "images" + (f"_{args.factor}" if args.factor > 0 else ""))
        if not path.exists(imgdir):
            raise ValueError(f"Image folder {imgdir} doesn't exist.")
        imgfiles = [
            path.join(imgdir, f)
            for f in sorted(os.listdir(imgdir))
            if f.lower().endswith(("jpg", "png"))
        ]
        # Every llffhold-th frame is the test split. Only the split's frames
        # are decoded (the JAX loader decodes all of them for each split).
        n_images = len(imgfiles)
        i_test = np.arange(n_images)[:: args.llffhold]
        indices = (
            i_test
            if self.split != "train"
            else np.array([i for i in np.arange(n_images) if i not in i_test])
        )
        images = np.stack(_load_images([imgfiles[i] for i in indices]), axis=0)

        with open(path.join(data_dir, "poses_bounds.npy"), "rb") as fp:
            poses_arr = np.load(fp)
        poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
        bds = poses_arr[:, -2:].transpose([1, 0])
        if poses.shape[-1] != n_images:
            raise RuntimeError(f"Mismatch between imgs {n_images} and poses {poses.shape[-1]}")

        # Correct intrinsics for downsampling.
        poses[:2, 4, :] = np.array(images.shape[1:3]).reshape([2, 1])
        poses[2, 4, :] = poses[2, 4, :] / factor

        # [down, right, backwards] -> [right, up, backwards] axis flip.
        poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
        poses = np.moveaxis(poses, -1, 0).astype(np.float32)
        bds = np.moveaxis(bds, -1, 0).astype(np.float32)

        scale = 1.0 / (bds.min() * 0.75)
        poses[:, :3, 3] *= scale
        bds *= scale
        poses = pose_utils.recenter_poses(poses)

        if args.spherify:
            poses, render_poses, bds = pose_utils.spherify_poses(
                poses, bds, make_render_path=self.split == "test"
            )
            if render_poses is not None:
                self.render_poses = render_poses
            self.spherify = True
        else:
            self.spherify = False
        if not args.spherify and self.split == "test":
            self.render_poses = pose_utils.spiral_path(poses, bds)

        poses = poses[indices]

        self.images = images
        self.camtoworlds = poses[:, :3, :4]
        self.focal = poses[0, -1, -1]
        self.h, self.w = images.shape[1:3]
        self.resolution = self.h * self.w
        self.n_examples = self.render_poses.shape[0] if args.render_path else images.shape[0]

    def _generate_rays(self):
        """NDC rays for forward-facing captures, one camera a thread. The
        test split's render
        path gets its rays when they are read: `render_rays` (every pose,
        made once) or, under --render_path, one pose per batch. The JAX
        loader makes them at load beside the test views' (its 120 poses
        hold 53 GB of rays at 4032x3024); a pose's rays are the same
        either way, bitwise."""
        self.rays = _camera_rays(self.w, self.h, self.focal, self.camtoworlds, self._ndc)

    def _ndc(self, rays):
        if self.spherify:
            return rays
        ndc_o, ndc_d = convert_to_ndc(rays.origins, rays.directions, self.focal, self.w, self.h)
        return Rays(origins=ndc_o.astype(np.float32), directions=ndc_d.astype(np.float32),
                    viewdirs=rays.viewdirs)

    def _path_rays(self, poses):
        return self._ndc(generate_rays(self.w, self.h, self.focal, poses))

    _render_rays = None

    @property
    def render_rays(self):
        """The render path's rays, [poses, H, W, 3] each (test split)."""
        if self._render_rays is None:
            self._render_rays = self._path_rays(self.render_poses)
        return self._render_rays

    def _next_test(self):
        if not self.render_path:
            return super()._next_test()
        idx = self.it
        self.it = (self.it + 1) % self.n_examples
        if self._render_rays is not None:
            return {"rays": namedtuple_map(lambda r: r[idx], self._render_rays)}
        return {"rays": namedtuple_map(lambda r: r[0],
                                       self._path_rays(self.render_poses[idx:idx + 1]))}


class NSVF(Dataset):
    """NSVF layout: intrinsics.txt + pose/ + rgb/ (+ optional bbox.txt).
    Files prefixed 0_ are the train split, 1_ val, 2_ test (1_ when there
    is no 2_)."""

    def _load_renderings(self, args):
        if args.render_path:
            raise ValueError("render_path cannot be used for the NSVF dataset.")
        data_dir = path.expanduser(args.data_dir)
        K = np.loadtxt(path.join(data_dir, "intrinsics.txt"))
        pose_files = sorted(os.listdir(path.join(data_dir, "pose")))
        img_files = sorted(os.listdir(path.join(data_dir, "rgb")))

        def with_prefix(files, prefix):
            return [x for x in files if x.startswith(prefix)]

        if self.split == "train":
            pose_files, img_files = with_prefix(pose_files, "0_"), with_prefix(img_files, "0_")
        elif self.split == "val":
            pose_files, img_files = with_prefix(pose_files, "1_"), with_prefix(img_files, "1_")
        else:  # test: prefer 2_, fall back to 1_
            prefix = "2_" if with_prefix(pose_files, "2_") else "1_"
            pose_files, img_files = with_prefix(pose_files, prefix), with_prefix(img_files, prefix)

        if len(img_files) != len(pose_files):
            raise ValueError(
                f"{data_dir}: {len(img_files)} images but {len(pose_files)} poses "
                f"for the {self.split} split"
            )
        cam_trans = np.diag(np.array([1, -1, -1, 1], dtype=np.float32))
        frames = _load_images([path.join(data_dir, "rgb", f) for f in img_files])
        images, cams = [], []
        for image, pose_fname in zip(frames, pose_files):
            cams.append(np.loadtxt(path.join(data_dir, "pose", pose_fname)) @ cam_trans)
            image = _composite_white(image, args.white_bkgd)
            if args.factor > 1:
                image = _resize_area(image, image.shape[1] // args.factor,
                                     image.shape[0] // args.factor)
            images.append(image)
        self.images = np.stack(images, axis=0)
        self.n_examples, self.h, self.w = self.images.shape[:3]
        self.resolution = self.h * self.w
        self.camtoworlds = np.stack(cams, axis=0).astype(np.float32)
        self.focal = (K[0, 0] + K[1, 1]) * 0.5
        if args.factor > 1:
            self.focal /= args.factor

        bbox_path = path.join(data_dir, "bbox.txt")
        if path.exists(bbox_path):
            self.bbox = np.loadtxt(bbox_path).reshape(-1)[:7].astype(np.float32)


class Synthetic(Dataset):
    """Procedural analytic scene rendered at init: no disk data needed."""

    def _load_renderings(self, args):

        n_views = 12 if self.split == "train" else 4
        res = getattr(args, "synthetic_resolution", 64)
        images, camtoworlds, focal = render_synthetic_scene(
            split=self.split,
            n_views=n_views,
            resolution=res,
            white_bkgd=args.white_bkgd,
            near=args.near,
            far=args.far,
        )
        # Copies: the rendered views are memoized read-only arrays.
        self.images = images.copy()
        self.camtoworlds = camtoworlds.copy()
        self.focal = focal
        self.h, self.w = images.shape[1:3]
        self.resolution = self.h * self.w
        self.n_examples = images.shape[0]


dataset_dict = {
    "blender": Blender,
    "llff": LLFF,
    "nsvf": NSVF,
    "synthetic": Synthetic,
}
