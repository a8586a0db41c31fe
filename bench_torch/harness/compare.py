"""What decides `correct`: every answer of the window against the plain
reference (`imaging`), once the window has closed and the server has
stopped.

Each served body is decoded and compared with the decoded reference
JPEG for its source and query. Three numbers are held to the limits of
the cell's configuration:

* `bad_answers`: requests that got no 200, no body, or a body that
  does not decode to the reference's size (limit 0);
* `px_diff_pct`: over the distinct bodies served, the largest share of
  decoded sample values that differ from the reference's, in percent.
  The program's exact route rounds like the reference except at
  near-ties, so a few 8x8 blocks may re-quantise; a lower precision
  re-quantises most of them;
* `px_max_diff`: over the distinct bodies served, the largest absolute
  difference of a decoded sample value from the reference's, in levels
  of 0-255. A near-tie re-quantises a block by a few levels; a local
  gross error (a band of rows, a few wrong blocks) that moves too few
  values to show in `px_diff_pct` moves them by far more.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List

import numpy as np

from . import imaging


def body_hash(body: bytes) -> str:
    return hashlib.blake2b(body, digest_size=16).hexdigest()


def check(records: List, bodies: Dict[str, bytes], sources: Dict[str, bytes],
          device, limits: dict) -> dict:
    """{"numbers": {name: (value, limit)}, "ok": bool, "wrong": hashes
    of the bodies that failed, "seconds": s, "distinct": n} over
    `records` (loadgen.Record) whose bodies are in `bodies` by hash;
    `sources` maps a source name to its bytes."""
    t0 = time.perf_counter()
    bad = sum(1 for r in records if r.status != 200 or r.body_hash is None)
    served = {}
    for r in records:
        if r.status == 200 and r.body_hash is not None:
            served.setdefault((r.src, r.query), set()).add(r.body_hash)
    planes = (None, None)  # one source's planes at a time
    worst = 0.0
    widest = 0
    wrong = set()
    for (src, query), hashes in sorted(served.items()):
        if planes[0] != src:
            planes = (None, None)  # frees the last source's first
            planes = (src, imaging.source_planes(
                imaging.decode_rgb(sources[src]), device))
        want = imaging.reference_image(planes[1], query)
        for h in sorted(hashes):
            try:
                got = imaging.decode_rgb(bodies[h])
            except Exception:
                wrong.add(h)
                continue
            if got.shape != want.shape:
                wrong.add(h)
                continue
            diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
            share = 100.0 * float(np.mean(diff != 0))
            most = int(diff.max())
            worst, widest = max(worst, share), max(widest, most)
            if share > limits["px_diff_pct"] or most > limits["px_max_diff"]:
                wrong.add(h)
    bad += sum(1 for r in records if r.status == 200 and r.body_hash in wrong
               and r.body_hash is not None)
    numbers = {"bad_answers": (bad, limits["bad_answers"]),
               "px_diff_pct": (worst, limits["px_diff_pct"]),
               "px_max_diff": (widest, limits["px_max_diff"])}
    ok = all(v <= lim for v, lim in numbers.values())
    return {"numbers": numbers, "ok": ok, "wrong": wrong,
            "distinct": sum(len(h) for h in served.values()),
            "seconds": time.perf_counter() - t0}
