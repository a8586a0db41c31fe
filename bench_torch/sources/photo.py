"""A pool of photo-like JPEGs made from the seed: low-resolution noise
upsampled (bicubic) to `width` x `height`, plus fine grain of +-6, saved
at `quality` with `subsampling` (PIL's code: 2 is 4:2:0). After
chip_smoke.py's `_photo`; each image has a generator of its own, made
from the seed and its index, so the pool is made by a few threads."""

import io
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def photo(w: int, h: int, rng) -> np.ndarray:
    from PIL import Image

    small = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3),
                         dtype=np.uint8)
    img = np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC),
                     dtype=np.int16)
    img += rng.integers(-6, 7, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _one(params: dict, seed: int, i: int) -> bytes:
    from PIL import Image

    rng = np.random.default_rng([seed, 100 + i])
    buf = io.BytesIO()
    Image.fromarray(photo(params["width"], params["height"], rng)).save(
        buf, format="JPEG", quality=params["quality"],
        subsampling=params["subsampling"])
    return buf.getvalue()


def generate(params: dict, seed: int, out_dir: Path, bench: Path) -> dict:
    n = params["count"]
    with ThreadPoolExecutor(min(n, 4)) as pool:
        datas = list(pool.map(lambda i: _one(params, seed, i), range(n)))
    out = {}
    for i, data in enumerate(datas):
        path = out_dir / f"photo{i}.jpg"
        path.write_bytes(data)
        out[path.name] = path
    return out
