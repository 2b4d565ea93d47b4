"""Image quality metrics: PSNR and a tf.image.ssim-compatible SSIM.

Port of plenoctree_tpu/ops/metrics.py. SSIM is the same separable Gaussian
formulation: two 1-D depthwise "valid" convolutions (H, then W) with the
tf.image constants. The convolutions run through cuDNN on the card, so the
package turns cuDNN's TF32 off (plenoctree_tpu_torch/__init__.py).
"""

import torch
import torch.nn.functional as F


def compute_psnr(mse):
    """PSNR assuming max pixel value 1.0 (tensor or Python float in, tensor out)."""
    mse = torch.as_tensor(mse, dtype=torch.float32)
    # Filled on the device: a copy from the host would wait for a GPU (and
    # cannot be captured in a CUDA graph).
    ln10 = torch.log(torch.full((), 10.0, dtype=torch.float32, device=mse.device))
    return -10.0 * torch.log(mse) / ln10


def _gaussian_filter(filter_size, filter_sigma, dtype, device):
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((torch.arange(filter_size, dtype=dtype, device=device) - hw + shift) / filter_sigma) ** 2
    filt = torch.exp(-0.5 * f_i)
    return filt / torch.sum(filt)


def compute_ssim(
    img0,
    img1,
    max_val,
    filter_size=11,
    filter_sigma=1.5,
    k1=0.01,
    k2=0.03,
    return_map=False,
):
    """SSIM between two images [..., H, W, C] (tensors), modeled after tf.image.ssim."""
    dtype = torch.promote_types(img0.dtype, torch.float32)
    img0 = img0.to(dtype)
    img1 = img1.to(dtype)
    filt = _gaussian_filter(filter_size, filter_sigma, dtype, img0.device)

    batch_shape = img0.shape[:-3]
    h, w, c = img0.shape[-3:]
    kern_h = filt.reshape(1, 1, filter_size, 1).expand(c, 1, filter_size, 1)
    kern_w = filt.reshape(1, 1, 1, filter_size).expand(c, 1, 1, filter_size)

    def blur(z):
        # [..., H, W, C] -> NCHW depthwise separable blur, "valid" padding.
        zb = z.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
        zb = F.conv2d(zb, kern_h, groups=c)
        zb = F.conv2d(zb, kern_w, groups=c)
        zb = zb.permute(0, 2, 3, 1)
        return zb.reshape(batch_shape + zb.shape[1:])

    mu0 = blur(img0)
    mu1 = blur(img1)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = blur(img0**2) - mu00
    sigma11 = blur(img1**2) - mu11
    sigma01 = blur(img0 * img1) - mu01

    sigma00 = torch.clamp(sigma00, min=0.0)
    sigma11 = torch.clamp(sigma11, min=0.0)
    sigma01 = torch.sign(sigma01) * torch.minimum(
        torch.sqrt(sigma00 * sigma11), torch.abs(sigma01)
    )

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    if return_map:
        return ssim_map
    return torch.mean(ssim_map, dim=tuple(range(len(batch_shape), ssim_map.ndim)))
