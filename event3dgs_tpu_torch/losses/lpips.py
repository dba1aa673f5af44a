"""LPIPS perceptual metric (counterpart of ``event3dgs_tpu/losses/lpips.py``).

The LPIPS v0.1 architecture the reference vendors
(`lpipsPyTorch/modules/lpips.py:8-36`, `networks.py`, `utils.py`): ImageNet
normalization, backbone features at 5 (AlexNet, VGG16) or 7 (SqueezeNet
1.1) stages, channelwise unit normalization, 1×1 linear heads, spatial
averaging and a sum over stages.

Weights come only from a user ``.npz`` in the JAX package's layout
(:func:`weight_shapes`): convolutions in HWIO as ``{name}_w`` with biases
``{name}_b``, heads as ``lin{i}_w`` of shape [C].  One file serves both
packages; :func:`load_weights` turns the kernels into PyTorch's OIHW once.
Inside, images are NCHW.  Without weights :func:`lpips_fn` returns None and
the evaluation reports SSIM/PSNR only.  Nothing is downloaded.

The convolutions run in full float32 (:func:`fp32_convolutions`): with
TF32 the card's distance is off by about 1e-3 against float32.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from event3dgs_tpu_torch.losses.basic import fp32_convolutions

# ImageNet statistics used by LPIPS's scaling layer (`modules/utils.py`)
_SHIFT = (0.485, 0.456, 0.406)
_SCALE = (0.229, 0.224, 0.225)

# AlexNet feature config: (out_channels, kernel, stride, padding) per conv,
# maxpool after convs 0 and 1, as in torchvision's AlexNet.features
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}

# VGG16 features: conv out-channels with 'M' maxpool markers; LPIPS taps the
# relu after each block (relu1_2, 2_2, 3_3, 4_3, 5_3) — `networks.py` VGG16
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_VGG_TAPS = {1, 3, 6, 9, 12}

# SqueezeNet 1.1 fire modules: (in, squeeze, expand) channels
_FIRE_CFG = [(64, 16, 64), (128, 16, 64), (128, 32, 128), (256, 32, 128),
             (256, 48, 192), (384, 48, 192), (384, 64, 256), (512, 64, 256)]


def _conv(x, params, name, stride=1, padding=0):
    return F.conv2d(x, params[f"{name}_w"], params[f"{name}_b"],
                    stride=stride, padding=padding)


def _normalize_channels(x, eps=1e-10):
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


def alexnet_features(params: dict, x: torch.Tensor) -> list:
    """Five relu-stage feature maps of AlexNet for [N, 3, H, W] input."""
    feats = []
    for i, (_, _, stride, pad) in enumerate(_ALEX_CONVS):
        x = F.relu(_conv(x, params, f"conv{i}", stride, pad))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return feats


def vgg16_features(params: dict, x: torch.Tensor) -> list:
    """Five relu-stage feature maps of VGG16 for [N, 3, H, W] input."""
    feats = []
    ci = 0
    for item in _VGG_CFG:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = F.relu(_conv(x, params, f"conv{ci}", 1, 1))
        if ci in _VGG_TAPS:
            feats.append(x)
        ci += 1
    return feats


def _fire(x, params, name):
    """SqueezeNet fire module: 1×1 squeeze → relu → concat(1×1, 3×3 expand)."""
    s = F.relu(_conv(x, params, f"{name}_s"))
    e1 = F.relu(_conv(s, params, f"{name}_e1"))
    e3 = F.relu(_conv(s, params, f"{name}_e3", 1, 1))
    return torch.cat([e1, e3], dim=1)


def _ceil_maxpool(x):
    """3×3 stride-2 maxpool with ceil_mode=True (torch SqueezeNet), as the
    JAX package computes it: pad the bottom and right with -inf to the next
    window, then pool without padding."""
    h, w = x.shape[2], x.shape[3]
    ph = (-(h - 3)) % 2
    pw = (-(w - 3)) % 2
    x = F.pad(x, (0, pw, 0, ph), value=-torch.inf)
    return F.max_pool2d(x, 3, 2)


def squeezenet_features(params: dict, x: torch.Tensor) -> list:
    """Seven tapped stages of SqueezeNet 1.1 (`networks.py` squeeze,
    N_slices=7): conv1 | pool+fire1-2 | pool+fire3-4 | pool+fire5 | fire6 |
    fire7 | fire8."""
    feats = []
    x = F.relu(_conv(x, params, "conv0", 2, 0))
    feats.append(x)
    x = _ceil_maxpool(x)
    x = _fire(x, params, "fire1")
    x = _fire(x, params, "fire2")
    feats.append(x)
    x = _ceil_maxpool(x)
    x = _fire(x, params, "fire3")
    x = _fire(x, params, "fire4")
    feats.append(x)
    x = _ceil_maxpool(x)
    x = _fire(x, params, "fire5")
    feats.append(x)
    for i in (6, 7, 8):
        x = _fire(x, params, f"fire{i}")
        feats.append(x)
    return feats


_BACKBONES = {
    "alex": (alexnet_features, 5),
    "vgg": (vgg16_features, 5),
    "squeeze": (squeezenet_features, 7),
}


def weight_shapes(net: str = "alex") -> dict:
    """The ``.npz`` layout of one backbone: key → shape (HWIO kernels,
    [C] biases and heads), as :func:`convert_torch_weights` writes it."""
    shapes, heads = {}, []

    def conv(name, k, cin, cout):
        shapes[f"{name}_w"] = (k, k, cin, cout)
        shapes[f"{name}_b"] = (cout,)

    if net == "alex":
        cin = 3
        for i, (cout, k, _, _) in enumerate(_ALEX_CONVS):
            conv(f"conv{i}", k, cin, cout)
            cin = cout
            heads.append(cout)
    elif net == "vgg":
        cin, ci = 3, 0
        for item in _VGG_CFG:
            if item == "M":
                continue
            conv(f"conv{ci}", 3, cin, item)
            if ci in _VGG_TAPS:
                heads.append(item)
            cin, ci = item, ci + 1
    elif net == "squeeze":
        conv("conv0", 3, 3, 64)
        for i, (cin, cs, ce) in enumerate(_FIRE_CFG):
            conv(f"fire{i + 1}_s", 1, cin, cs)
            conv(f"fire{i + 1}_e1", 1, cs, ce)
            conv(f"fire{i + 1}_e3", 3, cs, ce)
        # the stages after conv0: fires 2, 4, 5, 6, 7, 8, each 2 × expand
        heads = [64] + [2 * _FIRE_CFG[i][2] for i in (1, 3, 4, 5, 6, 7)]
    else:
        raise ValueError(f"unknown LPIPS backbone {net!r}")
    for i, c in enumerate(heads):
        shapes[f"lin{i}_w"] = (c,)
    return shapes


def params_from_arrays(arrays, device=None) -> dict:
    """``.npz`` arrays (HWIO kernels) → float32 tensors on ``device`` with
    the kernels in OIHW, the layout ``F.conv2d`` takes."""
    out = {}
    for key in arrays:
        a = np.asarray(arrays[key], np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO → OIHW
        out[key] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return out


def load_weights(path: str, device=None) -> dict:
    """Read an LPIPS ``.npz`` into :func:`params_from_arrays`'s layout."""
    with np.load(path) as data:
        return params_from_arrays({k: data[k] for k in data.files}, device)


def lpips_distance(params: dict, img1: torch.Tensor, img2: torch.Tensor,
                   net: str = "alex") -> torch.Tensor:
    """LPIPS distance between two [H, W, 3] images in [0, 1]; ``params`` as
    :func:`load_weights` returns them, on the images' device."""
    shift = torch.tensor(_SHIFT, dtype=img1.dtype, device=img1.device)
    scale = torch.tensor(_SCALE, dtype=img1.dtype, device=img1.device)

    def prep(im):
        return ((im - shift) / scale).permute(2, 0, 1)[None]

    features, _ = _BACKBONES[net]
    with fp32_convolutions():
        f1 = features(params, prep(img1))
        f2 = features(params, prep(img2))
    total = img1.new_zeros(())
    for i, (a, b) in enumerate(zip(f1, f2)):
        d = (_normalize_channels(a) - _normalize_channels(b)) ** 2
        head = params[f"lin{i}_w"]  # [C] non-negative weights (1x1 conv)
        total = total + torch.mean(torch.sum(d * head[None, :, None, None],
                                             dim=1))
    return total


class LPIPS(nn.Module):
    """LPIPS with its converted weights held as buffers: ``module.to(device)``
    moves them, and ``module(img1, img2)`` gives the distance of two
    [H, W, 3] images in [0, 1]."""

    def __init__(self, params: dict, net: str = "alex"):
        super().__init__()
        if net not in _BACKBONES:
            raise ValueError(f"unknown LPIPS backbone {net!r}")
        self.net = net
        for key, value in params.items():
            self.register_buffer(key, value)

    @torch.no_grad()
    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return lpips_distance(dict(self.named_buffers()), img1, img2, self.net)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def convert_torch_weights(alexnet_state: dict, lpips_state: dict, out_path: str,
                          net: str = "alex"):
    """Convert torch backbone ``.features`` + LPIPS linear-head dicts to npz.

    ``alexnet_state``: torchvision ``features`` state dict for the chosen
    backbone (keys like `0.weight` [Cout, Cin, kh, kw]); ``lpips_state``:
    LPIPS lin-layer dict (keys like `lin0.model.1.weight` [1, C, 1, 1]).
    Supported nets: alex (5 convs), vgg (13 convs), squeeze (conv + 8 fires).
    The file holds the JAX package's layout (HWIO kernels).
    """
    out = {}

    def conv(src_key, dst_name):
        w = _numpy(alexnet_state[f"{src_key}.weight"])
        out[f"{dst_name}_w"] = w.transpose(2, 3, 1, 0)  # OIHW → HWIO
        out[f"{dst_name}_b"] = _numpy(alexnet_state[f"{src_key}.bias"])

    if net == "alex":
        for i, ci in enumerate([0, 3, 6, 8, 10]):
            conv(str(ci), f"conv{i}")
        n_heads = 5
    elif net == "vgg":
        for i, ci in enumerate([0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]):
            conv(str(ci), f"conv{i}")
        n_heads = 5
    elif net == "squeeze":
        conv("0", "conv0")
        for i, fi in enumerate([3, 4, 6, 7, 9, 10, 11, 12]):
            conv(f"{fi}.squeeze", f"fire{i + 1}_s")
            conv(f"{fi}.expand1x1", f"fire{i + 1}_e1")
            conv(f"{fi}.expand3x3", f"fire{i + 1}_e3")
        n_heads = 7
    else:
        raise ValueError(f"unknown LPIPS backbone {net!r}")
    for i in range(n_heads):
        for key in (f"lin{i}.model.1.weight", f"lin.{i}.model.1.weight",
                    f"lins.{i}.model.1.weight"):
            if key in lpips_state:
                out[f"lin{i}_w"] = _numpy(lpips_state[key])[0, :, 0, 0]
                break
    np.savez(out_path, **out)


def lpips_fn(weights_path: Optional[str] = None, net: str = "alex",
             device=None) -> Optional[Callable]:
    """Return an :class:`LPIPS` module on ``device``, or None if weights are
    unavailable.

    Looks at ``weights_path``, then ``$EVENT3DGS_LPIPS_WEIGHTS``.  ``net``
    picks the backbone (alex/vgg/squeeze) — the reference uses alex for
    training-time eval (`image_utils.py:22-41`) and vgg in `metrics.py`.
    """
    path = weights_path or os.environ.get("EVENT3DGS_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        warnings.warn(
            "LPIPS weights not found"
            + (f" at {path!r}" if path else "")
            + ": evaluation will report SSIM/PSNR ONLY and omit LPIPS. "
            "To enable it, download the torch LPIPS v0.1 checkpoint on a "
            "machine with network access (pip install lpips; "
            "lpips.LPIPS(net='alex') caches torchvision alexnet + linear "
            "heads), convert with "
            "event3dgs_tpu_torch.losses.lpips.convert_torch_weights(out='lpips_"
            "alex.npz'), and point $EVENT3DGS_LPIPS_WEIGHTS (or "
            "--lpips_weights) at the .npz.",
            stacklevel=2,
        )
        return None
    return LPIPS(load_weights(path, device), net=net).eval()
