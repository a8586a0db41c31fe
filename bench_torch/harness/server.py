"""The server under test: one process of the port's HTTP server
(`python -m fanlin_tpu_torch.cli -j <config>`), started in a process
group of its own and stopped with it.

Its output (a JSON log line per request) goes to a pipe that a thread
of the harness reads, keeping the last lines in memory; they are
written to a log file when the server stops. A log file on the
machine's disk would put the disk's stalls on the served path (the
server writes each line from its event loop).
"""

from __future__ import annotations

import collections
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Iterable, List, Optional

BOOT_S = 300.0  # spawn to warm, a first run's kernel build included
STOP_S = 30.0
KEEP_LINES = 2000


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_argv(config_json: str) -> List[str]:
    return [sys.executable, "-m", "fanlin_tpu_torch.cli", "-j", config_json]


class ServerDied(RuntimeError):
    pass


def split_cores() -> tuple:
    """(harness, server) CPU sets: on a machine of four cores or more
    the load generator gets the last core to itself and the server the
    rest, so neither takes the other's time slices; on a smaller one
    both get every core."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return set(cores), set(cores)
    return {cores[-1]}, set(cores[:-1])


class Server:
    """`argv` started from `cwd`, its process (and every thread and
    child it makes) on `cpus` when given; the tail of its output goes
    to `log` when it stops."""

    def __init__(self, argv: List[str], cwd: Path, env: dict, log: Path,
                 port: int, cpus: Optional[Iterable[int]] = None):
        self.argv, self.cwd, self.env, self.log = argv, cwd, env, log
        self.cpus = set(cpus) if cpus is not None else None
        self.base = f"http://127.0.0.1:{port}"
        self.proc: Optional[subprocess.Popen] = None
        self.t_banner = math.nan  # perf_counter when the banner was seen
        self._lines = collections.deque(maxlen=KEEP_LINES)
        self._up = threading.Event()
        self._warm = threading.Event()
        self._reader: Optional[threading.Thread] = None

    def start(self) -> None:
        self.proc = subprocess.Popen(
            self.argv, cwd=self.cwd, env=self.env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            start_new_session=True)
        if self.cpus:
            # before the interpreter has started a thread: they inherit it
            os.sched_setaffinity(self.proc.pid, self.cpus)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for raw in iter(self.proc.stdout.readline, b""):
            line = raw.decode("utf-8", "replace").rstrip()
            self._lines.append(line)
            if not self._up.is_set() and "listening on" in line:
                self.t_banner = time.perf_counter()
                self._up.set()
            if not self._warm.is_set() and line.startswith("{"):
                try:
                    m = json.loads(line)
                except ValueError:
                    continue
                if m.get("target") == "fanlin.warmup" and str(
                        m.get("message", "")).startswith(("warmed ",
                                                          "warmup stopped")):
                    self._warm.set()
        self.proc.stdout.close()

    def tail(self, n: int = 30) -> str:
        return "\n".join(list(self._lines)[-n:])

    def wait_ready(self, warmup: bool, timeout: float = BOOT_S) -> None:
        """Until the banner is out and, with `warmup`, the startup
        warmup has logged its end; raises ServerDied when the process
        exits first or the time runs out."""
        deadline = time.monotonic() + timeout
        while not (self._up.is_set() and (self._warm.is_set() or not warmup)):
            if self.proc.poll() is not None:
                self._reader.join(timeout=5)
                raise ServerDied(f"the server exited {self.proc.returncode}:\n"
                                 + self.tail())
            if time.monotonic() > deadline:
                raise ServerDied("the server was not ready in time:\n"
                                 + self.tail())
            time.sleep(0.05)

    def stop(self) -> Optional[int]:
        """SIGTERM to the group, then SIGKILL after STOP_S; waits for the
        process, writes the tail of its output to `log` and returns its
        exit code."""
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                self.proc.wait(timeout=STOP_S)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)  # leftovers of the group
        except ProcessLookupError:
            pass
        code = self.proc.wait()
        self._reader.join(timeout=STOP_S)
        self.log.parent.mkdir(parents=True, exist_ok=True)
        self.log.write_text("\n".join(self._lines) + "\n")
        return code
