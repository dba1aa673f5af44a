"""Dataset preparation utilities (reference `dataset_utils/`; counterpart of
``event3dgs_tpu/tools/dataset_prep.py``, numpy and PIL on the host).

- :func:`generate_blurry_images`: synthetic blur for the deblur mode — mean
  of ``window`` consecutive frames each pre-smoothed by a box filter
  (`dataset_utils/blurry_gen.py:6-37`: 3-frame average of 7×7-box-filtered
  images).
- :func:`recolor_background`: replace near-black/near-white backgrounds
  (`dataset_utils/change_bg.py`).
- :func:`rename_for_e2vid` / :func:`rename_for_tumvie`: timestamp/rename
  munging for external tools (`dataset_utils/e2_timestap.py`, `tummie.py`).
- :func:`images_to_video` / :func:`video_to_images`: gated on an available
  backend (the environment has no cv2/ffmpeg bindings; falls back to an
  informative error).
"""

from __future__ import annotations

import os
import shutil

import numpy as np


def _box_filter(img: np.ndarray, k: int) -> np.ndarray:
    """Separable k×k box filter with edge padding (cv2.blur equivalent)."""
    pad = k // 2
    out = np.pad(img, [(pad, pad), (pad, pad)] + [(0, 0)] * (img.ndim - 2),
                 mode="edge")
    c = np.cumsum(out, axis=0)
    out = (np.vstack([c[k - 1 : k], c[k:] - c[:-k]])) / k
    c = np.cumsum(out, axis=1)
    out = np.hstack([c[:, k - 1 : k], c[:, k:] - c[:, :-k]]) / k
    return out


def generate_blurry_images(
    src_dir: str, out_dir: str, window: int = 3, box: int = 7
) -> int:
    """Write `images_blurry/` from `images/` (reference blurry_gen)."""
    from event3dgs_tpu_torch.utils.image_io import load_image_f32, save_image

    names = sorted(
        f for f in os.listdir(src_dir) if f.lower().endswith((".png", ".jpg"))
    )
    os.makedirs(out_dir, exist_ok=True)
    half = window // 2
    imgs = [
        _box_filter(load_image_f32(os.path.join(src_dir, n)), box)
        for n in names
    ]
    for i, name in enumerate(names):
        lo, hi = max(0, i - half), min(len(imgs), i + half + 1)
        save_image(os.path.join(out_dir, name), np.mean(imgs[lo:hi], axis=0))
    return len(names)


def recolor_background(
    src_dir: str, out_dir: str, threshold: float = 0.02,
    new_color=(0.5, 0.5, 0.5), dark: bool = True,
) -> int:
    """Recolor near-black (or near-white) pixels (reference change_bg)."""
    from event3dgs_tpu_torch.utils.image_io import load_image_f32, save_image

    names = sorted(
        f for f in os.listdir(src_dir) if f.lower().endswith((".png", ".jpg"))
    )
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        img = load_image_f32(os.path.join(src_dir, name))
        if dark:
            mask = (img < threshold).all(axis=-1)
        else:
            mask = (img > 1.0 - threshold).all(axis=-1)
        img[mask] = np.asarray(new_color)
        save_image(os.path.join(out_dir, name), img)
    return len(names)


def rename_for_e2vid(
    src_dir: str, out_dir: str, dt_us: int = 1000, start_us: int = 0
) -> str:
    """Copy frames renamed to microsecond timestamps + write timestamps.txt
    (the layout E2VID-style intensity-reconstruction tools consume)."""
    from PIL import Image  # noqa: F401  (validate importability)

    names = sorted(
        f for f in os.listdir(src_dir) if f.lower().endswith((".png", ".jpg"))
    )
    os.makedirs(out_dir, exist_ok=True)
    ts_path = os.path.join(out_dir, "timestamps.txt")
    with open(ts_path, "w") as ts:
        for i, name in enumerate(names):
            t = start_us + i * dt_us
            ext = os.path.splitext(name)[1]
            shutil.copyfile(
                os.path.join(src_dir, name),
                os.path.join(out_dir, f"{t:012d}{ext}"),
            )
            ts.write(f"{t / 1e6:.6f}\n")
    return ts_path


def rename_for_tumvie(src_dir: str, out_dir: str) -> int:
    """Sequential frame_%05d renaming (TUM-VIE tooling layout)."""
    names = sorted(
        f for f in os.listdir(src_dir) if f.lower().endswith((".png", ".jpg"))
    )
    os.makedirs(out_dir, exist_ok=True)
    for i, name in enumerate(names):
        ext = os.path.splitext(name)[1]
        shutil.copyfile(
            os.path.join(src_dir, name),
            os.path.join(out_dir, f"frame_{i:05d}{ext}"),
        )
    return len(names)


def images_to_video(src_dir: str, out_path: str, fps: int = 30):
    """Images → video; requires an encoder backend (cv2 or imageio)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "images_to_video needs cv2 (not available in this environment); "
            "frames remain individually usable"
        ) from e
    names = sorted(os.listdir(src_dir))
    first = cv2.imread(os.path.join(src_dir, names[0]))
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for n in names:
        vw.write(cv2.imread(os.path.join(src_dir, n)))
    vw.release()


def video_to_images(video_path: str, out_dir: str):
    """Video → frames; requires a decoder backend (cv2)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "video_to_images needs cv2 (not available in this environment)"
        ) from e
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        cv2.imwrite(os.path.join(out_dir, f"{i:05d}.png"), frame)
        i += 1
    cap.release()
    return i
