"""Whole runs of the harness against the port's server on the CPU
(tests/cpu_server.py): the look for a card is skipped, the rest of a
run is driven. A sound server is correct; the control (`tpu.fast`, the
port's bf16 products) and each planted fault are not."""

import copy
import os
import sys
import time

import pytest

from harness import cell, runner

LAUNCHER = cell.BENCH / "tests" / "cpu_server.py"
SMALL_PHOTOS = {
    "source": "test", "reduced": [], "provider": "img",
    "corpus": {"generator": "photo", "count": 4, "width": 320,
               "height": 240, "quality": 90, "subsampling": 2},
    "server": {"max_clients": 50,
               "client": {"s3": {"aws_region": "x"},
                          "web": {"user_agent": "t", "timeout": 5}},
               "tpu": {"warmup": False, "batch_window_ms": 30}},
}
SRCSET = {"loop": "closed", "connections": 8,
          "queries": [{"query": "w=160&h=120"}, {"query": "w=200&h=150"}]}


def _cell(name, config_name, traffic_name, config=None, traffic=None,
          like="readme-jpeg-serial"):
    """A cell made of the named files (or of `config` and `traffic`),
    reporting the metrics of the benchmark's cell `like`."""
    bench = cell.load_json("configs", config_name) if config is None else config
    conf = copy.deepcopy(bench)
    conf["server"].setdefault("tpu", {})["warmup"] = False
    conf.setdefault("limits", cell.load_cell(like).config["limits"])
    tr = cell.load_json("traffic", traffic_name) if traffic is None else traffic
    real = cell.load_cell(like)
    return cell.Cell(name, 1, config_name, traffic_name, conf, tr,
                     real.end_to_end, real.per_layer)


def _run(c, fault="none", control=None, seconds=2.0):
    env = dict(os.environ, FANLIN_NATIVE="0")  # as on the card's machine

    def argv_for(cfg):
        return [sys.executable, str(LAUNCHER), "--fault", fault, "-j", cfg]

    return runner.run_cell(c, 2**31 + 77, seconds, False, time.perf_counter(),
                           argv_for=argv_for, control=control, on_card=False,
                           env=env)


@pytest.fixture(scope="module")
def readme():
    return _cell("test-readme-serial", "readme-lenna", "readme-jpeg-serial")


def test_sound_server_is_correct(readme):
    out = _run(readme)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"p50_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    for k in ("px_diff_pct", "px_max_diff"):
        assert out["checks"][k]["value"] <= out["checks"][k]["limit"]


def test_control_lower_precision_is_not_correct(readme):
    out = _run(readme, control="fast")
    assert out["correct"] is False
    assert out["checks"]["px_diff_pct"]["value"] > \
        out["checks"]["px_diff_pct"]["limit"]


def test_altered_answer_is_not_correct(readme):
    out = _run(readme, fault="alter")
    assert out["correct"] is False


@pytest.fixture(scope="module")
def photos():
    return _cell("test-photos", "photos", "srcset", SMALL_PHOTOS, SRCSET,
                 like="camera-srcset-closed")


def test_band_of_rows_is_not_correct(photos):
    out = _run(photos, fault="band")
    assert out["correct"] is False
    assert out["checks"]["px_max_diff"]["value"] > \
        out["checks"]["px_max_diff"]["limit"]


def test_half_batch_left_out_is_not_correct(photos):
    sound = _run(photos)
    assert sound["correct"] is True
    assert set(sound["metrics"]) == {"img_per_s", "setup_s"}
    out = _run(photos, fault="half")
    assert out["correct"] is False
    assert out["checks"]["bad_answers"]["value"] > 0
