"""The pool of `photo.py` saved as progressive JPEGs: each image's pixels
are those `photo.py` makes for the seed and its index (the same
generator, `np.random.default_rng([seed, 100 + i])`), saved by PIL with
`progressive=True` at `quality` and `subsampling`, which writes
libjpeg-turbo's `jpeg_simple_progression` script (10 scans for YCbCr).
A seed thus gives the same pixels, and so the same quantised
coefficients, as the baseline pool of `photo.py`, only reordered into
scans."""

import importlib.util
import io
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def _photo_module():
    """sources/photo.py, loaded by its path beside this file."""
    path = Path(__file__).resolve().with_name("photo.py")
    spec = importlib.util.spec_from_file_location(
        "bench_torch_sources_progressive_photo_base", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one(photo, params: dict, seed: int, i: int) -> bytes:
    from PIL import Image

    rng = np.random.default_rng([seed, 100 + i])
    buf = io.BytesIO()
    Image.fromarray(photo(params["width"], params["height"], rng)).save(
        buf, format="JPEG", quality=params["quality"],
        subsampling=params["subsampling"], progressive=True)
    return buf.getvalue()


def generate(params: dict, seed: int, out_dir: Path, bench: Path) -> dict:
    photo = _photo_module().photo
    n = params["count"]
    with ThreadPoolExecutor(min(n, 4)) as pool:
        datas = list(pool.map(lambda i: _one(photo, params, seed, i),
                              range(n)))
    out = {}
    for i, data in enumerate(datas):
        path = out_dir / f"photo{i}.jpg"
        path.write_bytes(data)
        out[path.name] = path
    return out
