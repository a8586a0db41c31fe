"""The readers of the port's spans and counters (harness/spans.py and
the metrics that use it) on hand-made /stats reads and a hand-made
trace with `fanlin` events; each returns None where a program without
them leaves nothing to read."""

import io
import json
import types

import pytest

from harness import cell, spans

PID, DEV, COLLECT, LOOP, CODEC = 1, 11, 12, 13, 14


def _x(name, ts, dur, tid, **args):
    return {"ph": "X", "cat": "fanlin", "name": name, "pid": PID, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _async(name, ts, dur, rid, tid=LOOP, **args):
    common = {"cat": "fanlin", "name": name, "id": rid, "pid": PID,
              "tid": tid}
    return [dict(common, ph="b", ts=ts, args=dict(args, rid=rid)),
            dict(common, ph="e", ts=ts + dur)]


def _dev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": PID, "tid": 7,
            "ts": ts, "dur": dur}


# A 1 ms capture from t = 1000 µs: one request (rid 5) in one batch (7).
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": spans.CLOCK_SYNC,
     "pid": PID, "tid": 2, "ts": 1000.0, "dur": 1.0},
    *_async("fanlin.request", 1010, 900, 5, path="/img/a.jpg", status=200),
    *_async("fanlin.gateway.admit", 1010, 10, 5),
    *_async("fanlin.origin.fetch", 1020, 40, 5),
    *_async("fanlin.engine.pool_wait", 1060, 20, 5, tid=CODEC),
    _x("fanlin.engine.decode", 1080, 100, CODEC, rid=5),
    _x("fanlin.engine.device", 1180, 600, CODEC, rid=5),
    _x("fanlin.engine.encode", 1780, 80, CODEC, rid=5),
    *_async("fanlin.engine.pool_return", 1860, 30, 5),
    *_async("fanlin.batcher.queue", 1181, 99, 5, tid=DEV, batch=7),
    _x("fanlin.batcher.stage", 1280, 100, DEV, batch=7, n=1, rids=[5],
       cpu_ms=0.09),
    _x("fanlin.batcher.permit_wait", 1380, 0, DEV, batch=7, n=1, rids=[5],
       cpu_ms=0.0),
    _x("fanlin.batcher.submit", 1380, 200, DEV, batch=7, n=1, rids=[5],
       cpu_ms=0.05, pageable_uploads=1, pageable_bytes=4096),
    _x("fanlin.assembly.pageable_upload", 1400, 150, DEV, bytes=4096),
    _x("fanlin.batcher.device_wait", 1600, 100, COLLECT, batch=7, n=1,
       rids=[5], cpu_ms=0.01, queued_ms=0.02),
    _x("fanlin.batcher.unpack", 1700, 50, COLLECT, batch=7, n=1, rids=[5],
       cpu_ms=0.05),
    *_async("fanlin.batcher.handoff", 1750, 25, 5, tid=CODEC, batch=7),
    # a warm batch's staging: not served, never "feeding"
    _x("fanlin.batcher.stage", 1900, 50, DEV, batch=1, n=2, rids=[],
       cpu_ms=0.05, warm=True),
    # the card: the pageable copy inside the upload span, a kernel after,
    # and the host calls that issued the copies (one outside any span)
    dict(_dev(spans.PAGEABLE_COPY, 1420, 100, cat="gpu_memcpy"),
         args={"correlation": 1}),
    _dev("void gemm_kernel<1>(Args)", 1550, 40),
    dict(_dev(spans.PAGEABLE_COPY, 1560, 10, cat="gpu_memcpy"),
         args={"correlation": 2}),
    dict(_dev("cudaMemcpyAsync", 1401, 140, cat="cuda_runtime"),
         args={"correlation": 1}),
    dict(_dev("cudaMemcpyAsync", 1590, 5, cat="cuda_runtime"),
         args={"correlation": 2}),
]


def _run(tmp_path, events=EVENTS, before=None, after=None, records=()):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    cap = types.SimpleNamespace(trace_file=str(path), seconds=0.001,
                                t0=10.0, t1=11.0)
    return types.SimpleNamespace(
        capture=cap, stats_before=before or {}, stats_after=after or {},
        records=list(records), seconds=4.0, t0=9.0, t_end=13.0)


STATS_BEFORE = {"t_ms": 1000.0,
                "engine": {"requests": 10, "pool_wait_ms_total": 5.0},
                "batcher": {"batches": 4, "images": 8, "stage_ms_total": 40.0,
                            "permit_wait_ms_total": 1.0,
                            "submit_ms_total": 20.0,
                            "device_wait_ms_total": 8.0,
                            "handoff_ms_total": 0.8, "pageable_bytes": 0}}
STATS_AFTER = {"t_ms": 3000.0,
               "engine": {"requests": 30, "pool_wait_ms_total": 105.0},
               "batcher": {"batches": 14, "images": 28,
                           "stage_ms_total": 240.0,
                           "permit_wait_ms_total": 31.0,
                           "submit_ms_total": 120.0,
                           "device_wait_ms_total": 28.0,
                           "handoff_ms_total": 4.8,
                           "pageable_bytes": 50_000_000}}


@pytest.mark.parametrize("metric, want", [
    ("engine.pool_wait_ms", 100.0 / 20),
    ("batcher.stage_ms", 200.0 / 10),
    ("batcher.permit_wait_ms", 30.0 / 10),
    ("batcher.submit_ms", 100.0 / 10),
    ("assembly.pageable_mb", 50.0 / 20),
    ("batcher.device_thread_busy", 100.0 * 300.0 / 2000.0),
    ("batcher.device_wait_ms", 20.0 / 10),
    ("batcher.handoff_ms", 4.0 / 20),
])
def test_counter_metrics(tmp_path, metric, want):
    run = _run(tmp_path, before=STATS_BEFORE, after=STATS_AFTER)
    run.capture = None  # read as in an untraced window
    assert cell.load_module("metrics", metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "engine.pool_wait_ms", "batcher.stage_ms", "batcher.permit_wait_ms",
    "batcher.submit_ms", "assembly.pageable_mb", "batcher.device_thread_busy",
    "batcher.device_wait_ms", "batcher.handoff_ms", "device.idle_feeding.sat"])
def test_a_program_without_them_reads_none(tmp_path, metric):
    """The parent's /stats lack the counters and its trace the spans."""
    old = {"batcher": {"batches": 4, "images": 8},
           "engine": {"pixel_src": 0, "coef_src": 3}}
    new = {"batcher": {"batches": 14, "images": 28},
           "engine": {"pixel_src": 0, "coef_src": 23}}
    events = [e for e in EVENTS if e.get("cat") != "fanlin"]
    run = _run(tmp_path, events=events, before=old, after=new)
    assert cell.load_module("metrics", metric).read(run) is None


def test_idle_feeding(tmp_path):
    """Feeding 1280-1580 (stage, permit, submit; the warm stage left
    out), the card busy 1420-1520 and 1550-1590: idle and feeding for
    300 - 100 - 30 µs of the 1000 µs capture (the runtime calls are the
    host's, not the card's)."""
    run = _run(tmp_path)
    assert spans.idle_feeding_pct(run) == pytest.approx(17.0)
    assert cell.load_module("metrics", "device.idle_feeding.sat").read(
        run) == pytest.approx(17.0)


def test_residuals_and_enclosure(tmp_path):
    s = spans.Spans.load(_run(tmp_path).capture.trace_file)
    assert s.start == 1000.0
    # 900 µs less admit 10, fetch 40, pool wait 20, decode 100, device
    # 600, encode 80: 50 left, 20 with the way back
    assert spans.request_residuals(s) == [(900.0, 50.0)]
    assert spans.request_residuals(s, with_return=True) == [(900.0, 20.0)]
    # 600 µs less queue 99, stage 100, permit 0, submit 200, device wait
    # 100 + 20 queued, unpack 50, hand-back 25
    (total, left), = spans.device_residuals(s)
    assert total == 600.0 and left == pytest.approx(6.0)
    assert spans.covered_share([(900.0, 50.0)], 1000.0) == 1.0
    assert spans.covered_share([(100000.0, 6000.0)], 1000.0) == 0.0
    # the first issued and done inside the upload span, the second
    # issued outside any
    assert spans.pageable_enclosed(s) == (1, 1, 2)
    means = spans.phase_means(s)
    assert means["fanlin.batcher.stage"] == (1, pytest.approx(0.1),
                                             pytest.approx(0.09))


def test_idle_gaps_named_by_batcher_spans(tmp_path):
    s = spans.Spans.load(_run(tmp_path).capture.trace_file)
    gaps = spans.idle_gaps(s, 0.001)
    # 1000-1420: stage 1280-1380 overlaps most (permit is empty, submit
    # 1380-1420 and the upload 1400-1420 less)
    assert gaps[0][0] == pytest.approx(0.42)
    assert gaps[0][1:3] == ("fanlin.batcher.stage", "")
    assert [round(g[0], 3) for g in gaps] == [0.42, 0.41, 0.03]


def test_report_prints_inside_and_around(tmp_path):
    rec = types.SimpleNamespace
    records = [rec(done=10.5, status=200, latency_s=0.01),
               rec(done=12.0, status=200, latency_s=0.03),
               rec(done=12.5, status=200, latency_s=0.05),
               rec(done=9.5, status=200, latency_s=0.02)]
    run = _run(tmp_path, records=records)
    out = io.StringIO()
    spans.report(run, out)
    text = out.getvalue()
    parts = json.loads(text.splitlines()[0].split("capture ", 1)[1])
    assert parts["before"] == {"img_per_s": 1.0, "p50_ms": 20.0}
    assert parts["inside"] == {"img_per_s": 1.0, "p50_ms": 10.0}
    assert parts["after"] == {"img_per_s": 1.0, "p50_ms": 30.0}
    assert "request+return coverage 1.0 of 1" in text
    assert "pageable_upload span 1 of 2, done inside it 1" in text
    spans.report(run, out)  # once per run
    assert out.getvalue() == text
