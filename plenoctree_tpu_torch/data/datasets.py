"""Dataset loaders (host numpy): the `Dataset` base, Blender, LLFF, NSVF
and Synthetic.

Port of plenoctree_tpu/data/datasets.py. Batches leave this module as host
numpy; the renderer moves what it needs to its device. Under a process
group each rank's train split serves batch_size // data rays (the JAX
package's per-host split; `data` is the world size without tensor
parallelism), from a sampler seeded with the rank's data index. Differences
from the JAX package: no prefetch thread
(batches are built on demand), a seeded batch sampler, and images are read
with the port's own PNG decoder (`utils/png.py`) and downsampled with a
numpy k x k box mean (`_box_mean`, cv2's INTER_AREA at an integer factor),
so no loader needs PIL or cv2. Frames must be PNG: a JPEG (or any other
format) raises a ValueError naming the file, since the GPU host has no
JPEG decoder (ROADMAP.md A).
"""

import json
import os
from os import path

import numpy as np

from plenoctree_tpu_torch.data import poses as pose_utils
from plenoctree_tpu_torch.data.rays import Rays, convert_to_ndc, generate_rays, namedtuple_map
from plenoctree_tpu_torch.data.synthetic import render_synthetic_scene
from plenoctree_tpu_torch.parallel import mesh as mesh_lib
from plenoctree_tpu_torch.utils.png import is_png, read_png


def get_dataset(split, args):
    if args.dataset not in dataset_dict:
        raise NotImplementedError(
            f"dataset {args.dataset!r} is not ported yet (ROADMAP.md); "
            f"ported: {sorted(dataset_dict)}"
        )
    return dataset_dict[args.dataset](split, args)


def _box_mean(image, k):
    """The mean of each k x k pixel block, in float64, cast back:
    cv2.resize(image, (w // k, h // k), interpolation=cv2.INTER_AREA) when
    k divides the size (the loaders' --factor k); a remainder of rows or
    columns is dropped."""
    h, w = image.shape[0] // k, image.shape[1] // k
    blocks = image[: k * h, : k * w].reshape(h, k, w, k, *image.shape[2:])
    return blocks.mean(axis=(1, 3), dtype=np.float64).astype(image.dtype)


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
        self.rays = generate_rays(self.w, self.h, self.focal, self.camtoworlds)

    # The scene's bbox (NSVF bbox.txt: min xyz, max xyz, voxel size), None
    # elsewhere; the extract CLI's --bbox_from_data reads it.
    bbox = None


def _load_image(fname):
    if not is_png(fname):
        raise ValueError(
            f"{fname}: not a PNG file; the port reads PNG frames only (the GPU host has "
            "no JPEG decoder; ROADMAP.md A lists a numpy baseline-JPEG reader as open). "
            "Convert the frames to PNG, or use a folder of PNGs (images_4/, images_8/)."
        )
    return read_png(fname).astype(np.float32) / 255.0


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
        images, cams = [], []
        for frame in meta["frames"]:
            fname = os.path.join(args.data_dir, frame["file_path"] + ".png")
            image = _load_image(fname)
            if args.factor == 2:
                image = _box_mean(image, 2)
            elif args.factor > 0:
                raise ValueError(
                    f"Blender dataset only supports factor=0 or 2, {args.factor} set."
                )
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
        images = np.stack([_load_image(f) for f in imgfiles], axis=-1)

        with open(path.join(data_dir, "poses_bounds.npy"), "rb") as fp:
            poses_arr = np.load(fp)
        poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
        bds = poses_arr[:, -2:].transpose([1, 0])
        if poses.shape[-1] != images.shape[-1]:
            raise RuntimeError(
                f"Mismatch between imgs {images.shape[-1]} and poses {poses.shape[-1]}"
            )

        # Correct intrinsics for downsampling.
        poses[:2, 4, :] = np.array(images.shape[:2]).reshape([2, 1])
        poses[2, 4, :] = poses[2, 4, :] / factor

        # [down, right, backwards] -> [right, up, backwards] axis flip.
        poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
        poses = np.moveaxis(poses, -1, 0).astype(np.float32)
        images = np.moveaxis(images, -1, 0)
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

        i_test = np.arange(images.shape[0])[:: args.llffhold]
        indices = (
            i_test
            if self.split != "train"
            else np.array([i for i in np.arange(images.shape[0]) if i not in i_test])
        )
        images = images[indices]
        poses = poses[indices]

        self.images = images
        self.camtoworlds = poses[:, :3, :4]
        self.focal = poses[0, -1, -1]
        self.h, self.w = images.shape[1:3]
        self.resolution = self.h * self.w
        self.n_examples = self.render_poses.shape[0] if args.render_path else images.shape[0]

    def _generate_rays(self):
        """NDC rays for forward-facing captures; on the test split also the
        render path's rays."""
        if self.split == "test":
            n_render_poses = self.render_poses.shape[0]
            self.camtoworlds = np.concatenate([self.render_poses, self.camtoworlds], axis=0)
        super()._generate_rays()
        if not self.spherify:
            ndc_o, ndc_d = convert_to_ndc(
                self.rays.origins, self.rays.directions, self.focal, self.w, self.h
            )
            self.rays = Rays(
                origins=ndc_o.astype(np.float32),
                directions=ndc_d.astype(np.float32),
                viewdirs=self.rays.viewdirs,
            )
        if self.split == "test":
            self.camtoworlds = self.camtoworlds[n_render_poses:]
            split0, split1 = zip(*[np.split(r, [n_render_poses], 0) for r in self.rays])
            self.render_rays = Rays(*split0)
            self.rays = Rays(*split1)


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
        images, cams = [], []
        for img_fname, pose_fname in zip(img_files, pose_files):
            image = _load_image(path.join(data_dir, "rgb", img_fname))
            cams.append(np.loadtxt(path.join(data_dir, "pose", pose_fname)) @ cam_trans)
            image = _composite_white(image, args.white_bkgd)
            if args.factor > 1:
                image = _box_mean(image, args.factor)
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
