"""Progressive JPEG originals on the port's serving path, on the CPU,
against the benchmark's plain reference (bench_torch/harness/imaging.py:
PIL's decode, the `image` crate's Lanczos3 weights, PIL's JPEG encode):
the cell `progressive-srcset-closed` at small sizes.

Under a runner that stages (the server's micro-batcher) a progressive
JPEG takes the slot route, its answer decodes within the configuration's
limits of the reference, and it is byte-equal to the answer for the
baseline twin of the same pixels (the same quantised coefficients, in
other scans). The engine's reader counters (`read_stats`) are exact on
both routes; the header reports the coding process; the corpus generator
`sources/progressive_photo.py` is deterministic, writes SOF2 4:2:0 and
gives `sources/photo.py`'s pixels; the three metric readers read their
ratios from /stats, and nothing where the server lacks the counters; and
a whole traced run of a small progressive cell against the port's CPU
server is correct and reports them; and the counters lose no update
across the codec threads."""

import copy
import io
import os
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu_torch.engine import jpeg_coeffs, native_codecs
from fanlin_tpu_torch.engine.batcher import BatchingRunner, MicroBatcher
from fanlin_tpu_torch.engine.processor import Engine
from fanlin_tpu_torch.ops import fused
from fanlin_tpu_torch.spec.content import Format
from fanlin_tpu_torch.spec.query import parse_query

BENCH = Path(__file__).resolve().parents[1] / "bench_torch"
# the harness by its path, after the repository's own `tests` directory
# (bench_torch/tests would otherwise take the name `tests.conftest`)
sys.path.append(str(BENCH))
from harness import cell as hcell  # noqa: E402
from harness import imaging, runner  # noqa: E402

CPU = torch.device("cpu")
CONFIG = hcell.load_json("configs", "camera-12mp-progressive")
LIMITS = CONFIG["limits"]
SUBSAMPLING = {420: 2, 444: 0}  # PIL's argument
QUERY = "w=160&h=120"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_native(monkeypatch):
    """The port's encoders as on the card's machine, which has no native
    codec library (FANLIN_NATIVE=0 there): PIL encodes the answer, as the
    reference does."""
    monkeypatch.setattr(native_codecs, "_TRIED", True)
    monkeypatch.setattr(native_codecs, "_LIB", None)


def _photo(w, h, seed=7):
    photo = hcell.load_module("sources", "photo").photo
    return photo(w, h, np.random.default_rng([seed, 100]))


def _jpeg(img, subsamp=420, progressive=False, restart=0, quality=90):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality,
                              subsampling=SUBSAMPLING[subsamp],
                              progressive=progressive,
                              restart_marker_blocks=restart)
    return buf.getvalue()


@pytest.fixture
def staging():
    """An Engine serving through a CPU micro-batcher, as the server's
    does, its runner recording what it was asked to run."""
    b = MicroBatcher(max_batch=4, window_ms=1.0, device=CPU)
    runner_ = BatchingRunner(b)
    runner_.ran = []
    run = runner_.run

    def record_run(plans, images, kinds=None):
        runner_.ran.extend(images)
        return run(plans, images, kinds)

    runner_.run = record_run
    try:
        yield Engine(CPU, runner=runner_)
    finally:
        assert b.close()


def _answer(engine, data, qs=QUERY) -> bytes:
    mime, body = engine.process_image(data, parse_query(qs), Format())
    assert mime == "image/jpeg"
    return body


def _counts(engine) -> dict:
    """read_stats without its ms, which must have grown if anything was
    read."""
    stats = dict(engine.read_stats)
    ms = stats.pop("read_ms_total")
    assert (ms > 0) == (stats["reads"] > 0)
    return stats


@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("w,h", [(401, 301), (64, 48)])
@pytest.mark.parametrize("subsamp", [420, 444])
def test_progressive_answers_as_its_baseline_twin(staging, no_native, subsamp,
                                                  w, h, restart):
    """The slot route; within the limits of the plain reference; the
    same bytes as the baseline twin, through the same Engine."""
    img = _photo(w, h)
    prog = _jpeg(img, subsamp, progressive=True, restart=restart)
    base = _jpeg(img, subsamp, restart=restart)
    got = _answer(staging, prog)
    slot, = staging.runner.ran
    assert isinstance(slot, fused.WireSlot)
    assert _counts(staging) == {"slot_reads": 1, "reads": 1,
                                "progressive_reads": 1,
                                "read_scans_total": 10}
    assert _answer(staging, base) == got
    assert _counts(staging) == {"slot_reads": 2, "reads": 2,
                                "progressive_reads": 1,
                                "read_scans_total": 11}
    want = imaging.reference_image(
        imaging.source_planes(imaging.decode_rgb(prog), CPU), QUERY)
    out = imaging.decode_rgb(got)
    assert out.shape == want.shape
    diff = np.abs(out.astype(np.int16) - want.astype(np.int16))
    assert 100.0 * float(np.mean(diff != 0)) <= LIMITS["px_diff_pct"]
    assert int(diff.max()) <= LIMITS["px_max_diff"]


@pytest.mark.parametrize("route", ["slot", "dict"])
@pytest.mark.parametrize("coding,scans", [
    ("baseline", 1), ("progressive", 10), ("gray progressive", 6)])
def test_read_stats_count_on_both_routes(staging, route, coding, scans):
    """Each JPEG the reader decodes counts once, with its scans (PIL's
    progressive script: 10 for YCbCr, 6 for gray), on the slot route and
    on the dict route (an Engine on its own runner) alike."""
    img = _photo(97, 61)
    if coding.startswith("gray"):
        buf = io.BytesIO()
        Image.fromarray(img).convert("L").save(buf, "JPEG", quality=90,
                                               progressive=True)
        data = buf.getvalue()
    else:
        data = _jpeg(img, progressive=coding == "progressive")
    engine = staging if route == "slot" else Engine(CPU)
    _answer(engine, data)
    _answer(engine, data, "w=50&h=40")
    assert _counts(engine) == {
        "slot_reads": 2 * (route == "slot"), "reads": 2,
        "progressive_reads": 2 * ("progressive" in coding),
        "read_scans_total": 2 * scans}
    assert engine.stats == {"pixel_src": 0, "coef_src": 2}


def _sof1(data: bytes) -> bytes:
    """A baseline stream relabelled extended sequential (SOF1): the same
    Huffman coding."""
    at = data.index(b"\xff\xc0")
    return data[:at] + b"\xff\xc1" + data[at + 2:]


@pytest.mark.parametrize("marker,progressive", [
    ("SOF0", False), ("SOF1", False), ("SOF2", True)])
def test_header_reports_the_coding_process(marker, progressive):
    img = _photo(65, 47)
    base = _jpeg(img)
    data = {"SOF0": base, "SOF1": _sof1(base),
            "SOF2": _jpeg(img, progressive=True)}[marker]
    head = jpeg_coeffs.read_header(data)
    assert head is not None and head.progressive is progressive
    got = jpeg_coeffs.read_dict(data)
    assert got.head == head and got.scans == (10 if progressive else 1)
    # the coefficients of every coding are the baseline stream's
    want = jpeg_coeffs.read_jpeg_coeffs(base)
    for key in ("y", "cb", "cr", "lq", "cq"):
        assert np.array_equal(got.meta[key], want[key]), key


def _generate(name, seed, out_dir):
    params = {"count": 2, "width": 160, "height": 120, "quality": 90,
              "subsampling": 2}
    out_dir.mkdir()
    paths = hcell.load_module("sources", name).generate(params, seed, out_dir,
                                                       BENCH)
    return {n: p.read_bytes() for n, p in paths.items()}


def test_progressive_photo_generator(tmp_path):
    """Deterministic for a seed (a large one, past 32 signed bits), SOF2
    at 4:2:0, and the pixels and coefficients of photo.py's pool for the
    seed."""
    seed = 2**31 + 4077
    prog = _generate("progressive_photo", seed, tmp_path / "a")
    assert sorted(prog) == ["photo0.jpg", "photo1.jpg"]
    assert _generate("progressive_photo", seed, tmp_path / "b") == prog
    assert _generate("progressive_photo", seed + 1, tmp_path / "c") != prog
    base = _generate("photo", seed, tmp_path / "d")
    for name, data in prog.items():
        head = jpeg_coeffs.read_header(data)
        assert head.progressive and head.subsamp == 420
        assert (head.w, head.h) == (160, 120)
        assert not jpeg_coeffs.read_header(base[name]).progressive
        assert np.array_equal(imaging.decode_rgb(data),
                              imaging.decode_rgb(base[name]))
        a, b = (jpeg_coeffs.read_jpeg_coeffs(d) for d in (data, base[name]))
        for key in ("y", "cb", "cr"):
            assert np.array_equal(a[key], b[key]), key


def _window(before: dict, after: dict):
    return SimpleNamespace(stats_before={"engine": before},
                           stats_after={"engine": after})


@pytest.mark.parametrize("name,want", [
    ("engine.read_ms", 150.0), ("engine.progressive_share", 75.0),
    ("engine.scans_per_read", 7.75)])
def test_metric_readers(name, want):
    """The window's deltas: 4 reads, 600 ms, 3 progressive, 31 scans;
    None without the counters or without a read in the window."""
    read = hcell.load_module("metrics", name).read
    before = {"reads": 6, "read_ms_total": 900.0, "progressive_reads": 1,
              "read_scans_total": 9, "coef_src": 6}
    after = {"reads": 10, "read_ms_total": 1500.0, "progressive_reads": 4,
             "read_scans_total": 40, "coef_src": 10}
    assert read(_window(before, after)) == pytest.approx(want)
    assert read(_window(before, dict(before))) is None
    older = {"coef_src": 6}  # a server without the counters
    assert read(_window(older, dict(older, coef_src=10))) is None


def test_traced_cpu_run_of_a_small_progressive_cell():
    """The cell's configuration at 320x240, 4 sources, against the port's
    server on the CPU (bench_torch/tests/cpu_server.py): correct, every
    JPEG read progressive into its slot in 10 scans."""
    conf = copy.deepcopy(CONFIG)
    conf["corpus"].update(count=4, width=320, height=240)
    conf["server"]["tpu"] = {"warmup": False, "batch_window_ms": 30}
    traffic = {"loop": "closed", "connections": 8,
               "queries": [{"query": "w=160&h=120"},
                           {"query": "w=200&h=150"}]}
    real = hcell.load_cell("progressive-srcset-closed")
    cell = hcell.Cell("test-progressive", 1, "camera-12mp-progressive",
                      "test-srcset", conf, traffic, real.end_to_end,
                      real.per_layer)
    launcher = BENCH / "tests" / "cpu_server.py"
    env = dict(os.environ, FANLIN_NATIVE="0")  # as on the card's machine
    out = runner.run_cell(
        cell, 2**40 + 12345, 2.0, True, time.perf_counter(),
        argv_for=lambda cfg: [sys.executable, str(launcher), "-j", cfg],
        on_card=False, env=env)
    assert out["correct"] is True and out["failed"] == 0
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert metrics["engine.progressive_share"] == 100.0
    assert metrics["engine.slot_read_share"] == 100.0
    assert metrics["engine.scans_per_read"] == 10.0
    assert metrics["engine.read_ms"] > 0


def test_read_counters_lose_no_update_across_threads():
    """16 threads (more than the cores) count reads at a shortened switch
    interval, as the codec pool does: every one is counted."""
    engine = Engine(CPU)
    head = jpeg_coeffs.read_header(_jpeg(_photo(32, 16), progressive=True))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(500):
                engine._note_read(head, 10, 1_000_000, slot=i % 2 == 0)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert engine.read_stats == {
        "slot_reads": 4000, "reads": 8000, "read_ms_total": 8000.0,
        "progressive_reads": 8000, "read_scans_total": 80000}
