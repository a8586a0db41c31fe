"""Every file of a cell is found by its name, and BENCHMARK.json keeps
to the form the benchmark's contract gives it."""

import json
import re

import pytest

from harness import cell

BENCH = json.loads((cell.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (cell.REPO / p).is_dir()
    assert any(w.startswith(tuple(BENCH["paths"])) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_configs_found_by_name():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"bench_torch/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        conf = cell.load_json("configs", c["name"])
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert cell.load_module("sources", conf["corpus"]["generator"])
        assert set(conf["limits"]) == {"bad_answers", "px_diff_pct",
                                       "px_max_diff"}


def test_workloads_found_by_name():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        c = cell.load_cell(w["name"])
        assert c.traffic["loop"] in ("open", "closed")
        assert c.traffic["queries"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        len(CELLS) // 4, 1)
    assert len(set(CELLS)) == len(CELLS)


def test_metrics_found_by_name():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(BENCH["per_layer"]) <= 128
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(cell.load_module("end_to_end", m["name"]).read)
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert callable(cell.load_module("metrics", m["name"]).read)
        for w in m.get("workloads", CELLS):
            c = cell.load_cell(w)
            assert m["moves"] in [x["name"] for x in c.end_to_end]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for name in CELLS:
        c = cell.load_cell(name)
        reported = [x["name"] for x in c.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer


def test_camera_serves_every_width_its_source_lists_that_fanlin_serves():
    """Each width the source quotes (Next.js's default deviceSizes) at
    4:3 of the 4032x3024 sources, half up, is asked where fanlin's size
    range (w 20-2000, h 20-1000) serves it, and only there."""
    from fanlin_tpu_torch.spec import query

    conf = cell.load_json("configs", "camera-12mp")
    listed = re.search(r"deviceSizes ([0-9, ]+);", conf["source"]).group(1)
    widths = [int(w) for w in listed.split(", ")]
    assert widths == [640, 750, 828, 1080, 1200, 1920, 2048, 3840]
    asked = [f"w={w}&h={(w * 3024 * 2 + 4032) // (2 * 4032)}" for w in widths]
    served = [q for q in asked
              if not query.parse_query(q).unsupported_scale_size()]
    assert len(served) == 5
    queries = [q["query"] for q in
               cell.load_json("traffic", "camera-srcset-closed")["queries"]]
    assert queries == served
    assert conf["reduced"] == []
    warm = conf["server"]["tpu"]["warmup_shapes"]
    assert warm == [f"4032x3024:{q}" for q in queries]


@pytest.mark.parametrize("kernel", ["resample", "jpeg_decode_rgb"])
def test_work_found_by_kernel_name(kernel):
    work = cell.load_module("work", kernel)
    assert work.TRACE_NAME and work.CALL_NAME.startswith(work.TRACE_NAME)


def test_a_missing_file_is_an_error():
    with pytest.raises(FileNotFoundError):
        cell.load_module("metrics", "no.such.metric")
    with pytest.raises(KeyError):
        cell.load_cell("no-such-cell")
