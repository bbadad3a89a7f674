"""Frame decode + CLIP preprocessing (host side).

Replaces the reference's PIL + transformers.CLIPImageProcessor pipeline
(hoi_forecast/dataset/video_utils.py, handsonvlm/handsonvlm_utils.py) with a
torch-free numpy implementation of the same math: shortest-side 224 bicubic
resize, center crop, rescale 1/255, normalize with the CLIP mean/std.
Optional /dev/shm cache mirrors the reference's tensor cache
(video_utils.py:33-53). Video decode goes through imageio/cv2 when
available (decord is CUDA-era; gated).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence

import numpy as np

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
CLIP_SIZE = 224


def expand2square(img: "PIL.Image.Image", background_color):
    from PIL import Image

    width, height = img.size
    if width == height:
        return img
    side = max(width, height)
    result = Image.new(img.mode, (side, side), background_color)
    if width > height:
        result.paste(img, (0, (width - height) // 2))
    else:
        result.paste(img, ((height - width) // 2, 0))
    return result


def clip_preprocess(img, size: int = CLIP_SIZE) -> np.ndarray:
    """PIL image -> (3, size, size) float32, CLIPImageProcessor math."""
    from PIL import Image

    w, h = img.size
    # resize shortest side to `size` (bicubic), then center crop
    if w <= h:
        new_w, new_h = size, max(int(round(h * size / w)), size)
    else:
        new_w, new_h = max(int(round(w * size / h)), size), size
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - size) // 2
    top = (new_h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    x = np.asarray(img.convert("RGB"), np.float32) / 255.0
    x = (x - CLIP_MEAN) / CLIP_STD
    return np.transpose(x, (2, 0, 1))


# /dev/shm budget for the preprocessed-frame cache. The reference cached
# unboundedly (hoi_forecast/dataset/video_utils.py:33-53 — fills shm on big
# runs); here writes stop at the cap and the oldest files are evicted.
CACHE_MAX_BYTES = int(os.environ.get("HANDSONVLM_FRAME_CACHE_BYTES", 2 * 1024**3))
_cache_usage = {"bytes": -1, "checked": 0.0}


def _cache_evict(cache_dir: str, incoming: int) -> bool:
    """True if `incoming` bytes may be written; evicts oldest-mtime files
    when over budget. Usage is recomputed at most every 5 s (many loader
    threads hit this path)."""
    import time

    now = time.time()
    if _cache_usage["bytes"] < 0 or now - _cache_usage["checked"] > 5.0:
        total = 0
        try:
            with os.scandir(cache_dir) as it:
                entries = [(e.stat().st_mtime, e.path, e.stat().st_size) for e in it]
            total = sum(s for _, _, s in entries)
            if total + incoming > CACHE_MAX_BYTES:
                entries.sort()  # oldest first
                for _, path, s in entries:
                    if total + incoming <= CACHE_MAX_BYTES * 0.9:
                        break
                    try:
                        os.unlink(path)
                        total -= s
                    except OSError:
                        pass
        except OSError:
            return False
        _cache_usage["bytes"] = total
        _cache_usage["checked"] = now
    if _cache_usage["bytes"] + incoming > CACHE_MAX_BYTES:
        return False
    _cache_usage["bytes"] += incoming
    return True


def load_image(
    image_file: str,
    image_aspect_ratio: str = "square",
    cache_dir: Optional[str] = "/dev/shm/handsonvlm_images",
    size: int = CLIP_SIZE,
) -> np.ndarray:
    """JPEG path -> (3,size,size) with optional bounded /dev/shm .npy cache."""
    cache_file = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        h = hashlib.md5(image_file.encode()).hexdigest()[:8]
        cache_file = os.path.join(cache_dir, f"{os.path.basename(image_file)}_{h}_{size}.npy")
        if os.path.exists(cache_file):
            try:
                return np.load(cache_file)
            except Exception:
                pass
    from PIL import Image

    img = Image.open(image_file).convert("RGB")
    if image_aspect_ratio == "pad":
        img = expand2square(img, tuple(int(x * 255) for x in CLIP_MEAN))
    out = clip_preprocess(img, size)
    if cache_file and _cache_evict(os.path.dirname(cache_file), out.nbytes):
        try:
            np.save(cache_file, out)
        except Exception:
            pass
    return out


def load_video_frames(
    frame_paths: Sequence[str], image_aspect_ratio: str = "square", cache_dir=None,
    size: int = CLIP_SIZE,
) -> np.ndarray:
    """List of frame paths -> (T, 3, size, size)."""
    return np.stack(
        [load_image(p, image_aspect_ratio, cache_dir, size) for p in frame_paths], axis=0
    )


def load_video(video_path: str, num_frames: int, size: int = CLIP_SIZE) -> np.ndarray:
    """Decode an mp4, uniformly sample num_frames, CLIP-preprocess.

    Mirrors handsonvlm_utils.load_video's linspace sampling; uses imageio
    (ffmpeg) or cv2 instead of decord.
    """
    frames = _decode_video(video_path)
    idx = np.round(np.linspace(0, len(frames) - 1, num_frames)).astype(int)
    from PIL import Image

    out = []
    for i in idx:
        out.append(clip_preprocess(Image.fromarray(frames[i]), size))
    return np.stack(out, axis=0)


def _decode_video(video_path: str) -> List[np.ndarray]:
    try:
        import cv2

        cap = cv2.VideoCapture(video_path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if frames:
            return frames
    except ImportError:
        pass
    try:
        import imageio.v3 as iio

        return list(iio.imread(video_path, index=None))
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "no video decoder available (cv2/imageio); install one or "
            "pre-extract frames"
        ) from e
