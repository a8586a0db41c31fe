"""One torch.profiler capture at a time in this process.

torch.profiler drives one process-wide Kineto session, but tells only
the thread that started it that it is on: a second capture started from
another thread is not refused, and stopping the first then ends the
second's session under it (the process can crash there). So every
capture of the port (the gateway's `GET /profile`, `tpu.profile_dir`)
goes through `exclusive`, which refuses a second one with ProfilerBusy
instead. A capture opened with torch.profiler directly is not seen:
start none beside a server that has the route.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

_LOCK = threading.Lock()


class ProfilerBusy(RuntimeError):
    """A capture is already running in this process."""


@contextlib.contextmanager
def exclusive(cuda: bool):
    """torch.profiler over the block: host activity of every thread
    (Kineto's `profile_all_threads`: the batcher's device thread launches
    the kernels), and the CUDA device's when `cuda` (a process that must
    not touch CUDA passes False). Raises ProfilerBusy while another
    capture of the port runs, or when this thread is already
    profiling."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    if not _LOCK.acquire(blocking=False):
        raise ProfilerBusy("a torch.profiler capture is already running in "
                           "this process")
    try:
        if torch.autograd._profiler_enabled():
            raise ProfilerBusy("this thread is already profiling")
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            yield prof
    finally:
        _LOCK.release()


def prepare(cuda: bool) -> None:
    """Let Kineto initialise here, with an empty capture. It initialises
    at a process's first capture, and only on the thread that imported
    torch: a first capture started from another thread (an aiohttp
    handler's worker thread) records nothing, the card's kernels
    included. Call it from that thread before serving captures; while
    another capture runs, Kineto is up already and it does nothing."""
    try:
        with exclusive(cuda):
            pass
    except ProfilerBusy:
        pass


def capture_trace(trace_dir: str, seconds: float, cuda: bool) -> str:
    """Profile this process for `seconds` and write the capture into
    `trace_dir` as a Chrome trace; returns the file's path."""
    os.makedirs(trace_dir, exist_ok=True)
    with exclusive(cuda) as prof:
        time.sleep(seconds)
    path = os.path.join(trace_dir, f"fanlin-{os.getpid()}-"
                                   f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path
