"""Dataset loaders (host numpy): the `Dataset` base, Blender and Synthetic.

Port of plenoctree_tpu/data/datasets.py for the loaders the serving slice
needs. Batches leave this module as host numpy; the renderer moves what it
needs to its device. Differences from the JAX package: a single host (no
jax.process_count), no prefetch thread (batches are built on demand), a
seeded batch sampler, and PIL is imported inside the Blender loader, so the
synthetic path runs without it. LLFF and NSVF wait (ROADMAP.md).
"""

import json
import os
from os import path

import numpy as np

from plenoctree_tpu_torch.data.rays import generate_rays, namedtuple_map
from plenoctree_tpu_torch.data.synthetic import render_synthetic_scene


def get_dataset(split, args):
    if args.dataset not in dataset_dict:
        raise NotImplementedError(
            f"dataset {args.dataset!r} is not ported yet (ROADMAP.md); "
            f"ported: {sorted(dataset_dict)}"
        )
    return dataset_dict[args.dataset](split, args)


def _resize_area(image, new_w, new_h):
    """Area-averaging resize (cv2.INTER_AREA equivalent)."""
    import cv2

    return cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_AREA)


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
        self.batch_size = args.batch_size
        self.image_batching = args.image_batching
        self.render_path = args.render_path
        self._rng = np.random.default_rng(0)  # training batch sampler

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
        return {
            "pixels": self.images[idx],
            "rays": namedtuple_map(lambda r: r[idx], self.rays),
        }

    def _generate_rays(self):
        self.rays = generate_rays(self.w, self.h, self.focal, self.camtoworlds)


def _load_image(fname):
    from PIL import Image

    with open(fname, "rb") as f:
        return np.array(Image.open(f), dtype=np.float32) / 255.0


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
                image = _resize_area(image, image.shape[1] // 2, image.shape[0] // 2)
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
    "synthetic": Synthetic,
}
