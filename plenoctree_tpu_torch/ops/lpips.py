"""LPIPS perceptual metric: a torch VGG16 feature stack + the LPIPS heads.

Port of plenoctree_tpu/ops/lpips.py (the reference uses the `lpips`
package, octree/nerf/utils.py:461-486). The pretrained weights cannot be
downloaded here, so `get_lpips_fn()` loads them from $LPIPS_WEIGHTS_NPZ
(or the port's own plenoctree_tpu_torch/data/lpips_vgg.npz) when present
and returns None otherwise; callers then report NaN for LPIPS.

Weights npz layout (shared with the JAX package): conv kernels
'conv<i>/kernel' [kh, kw, cin, cout] (HWIO; i = 0-based conv index within
torchvision VGG16 `features`), biases 'conv<i>/bias', LPIPS linear heads
'lin<k>' [c]. The kernels are transposed to torch's OIHW at load time.

The convolutions run with cuDNN's TF32 off (three decimal digits would
move the distance), inside a local `torch.backends.cudnn.flags` context.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv structure in torchvision `features` order; 'M' = maxpool.
# LPIPS-VGG taps the relu outputs relu1_2/2_2/3_3/4_3/5_3, i.e. torchvision
# `features` indices {3, 8, 15, 22, 29}, the relus after the
# 2nd/4th/7th/10th/13th conv (1-based conv count).
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_TAP_AFTER = {2, 4, 7, 10, 13}  # 1-based conv count after whose relu we tap
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_CACHE = {}  # (path, device) -> torch weights


def _weights_path():
    p = os.environ.get("LPIPS_WEIGHTS_NPZ")
    if p:
        return p
    return os.path.join(os.path.dirname(__file__), "..", "data", "lpips_vgg.npz")


def load_weights(device="cpu"):
    """The npz weights as torch tensors on `device` (conv kernels OIHW), or
    None when the file does not exist."""
    path = _weights_path()
    key = (os.path.abspath(path), str(torch.device(device)))
    if key not in _CACHE:
        if not os.path.exists(path):
            return None
        z = np.load(path)
        w = {}
        for k in z.files:
            a = np.asarray(z[k], np.float32)
            if k.endswith("/kernel"):
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            w[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        _CACHE[key] = w
    return _CACHE[key]


def _vgg_features(weights, x):
    """x: [N, 3, H, W] in [-1, 1] (the LPIPS input convention) -> the five
    tapped relu outputs, NCHW."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    feats = []
    conv_i = 0
    for v in _VGG_CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = F.conv2d(x, weights[f"conv{conv_i}/kernel"], weights[f"conv{conv_i}/bias"], padding=1)
        x = F.relu(x)
        conv_i += 1
        if conv_i in _TAP_AFTER:
            feats.append(x)
    return feats


def lpips_distance(weights, img0, img1):
    """LPIPS between two [H, W, 3] images in [0, 1] (arrays or tensors),
    computed on the weights' device; a 0-dim f32 tensor."""
    dev = weights["conv0/kernel"].device

    def prep(img):
        x = torch.as_tensor(np.asarray(img, np.float32) if not isinstance(img, torch.Tensor) else img)
        x = x.to(dev, torch.float32)
        return (x.permute(2, 0, 1)[None] * 2.0 - 1.0).contiguous()

    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic, allow_tf32=False,
    ):
        f0s = _vgg_features(weights, prep(img0))
        f1s = _vgg_features(weights, prep(img1))
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i, (f0, f1) in enumerate(zip(f0s, f1s)):
            n0 = f0 / torch.sqrt(torch.sum(f0**2, 1, keepdim=True) + 1e-10)
            n1 = f1 / torch.sqrt(torch.sum(f1**2, 1, keepdim=True) + 1e-10)
            diff = (n0 - n1) ** 2
            lin = weights[f"lin{i}"].reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(diff * lin, dim=1))
    return total


def get_lpips_fn(device="cpu"):
    """Returns lpips(img0, img1) -> float, or None if weights unavailable."""
    weights = load_weights(device)
    if weights is None:
        return None
    return lambda a, b: float(lpips_distance(weights, a, b))


def tap_structure():
    """(torchvision_features_index, channels) for each tapped relu.

    Pure bookkeeping over _VGG_CFG/_TAP_AFTER, pinned by the tests against
    the documented LPIPS-VGG taps {3, 8, 15, 22, 29}.
    """
    taps = []
    feat_idx = 0  # index into torchvision vgg16().features
    conv_i = 0
    for v in _VGG_CFG:
        if v == "M":
            feat_idx += 1  # MaxPool2d
            continue
        conv_i += 1
        feat_idx += 2  # Conv2d + ReLU
        if conv_i in _TAP_AFTER:
            taps.append((feat_idx - 1, v))  # index of the ReLU just applied
    return taps
