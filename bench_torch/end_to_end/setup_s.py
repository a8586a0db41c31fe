"""Seconds from the harness's start to the window's first request:
the server's spawn, imports, kernel load (a build on a checkout's
first run) and startup warmup, the corpus, and the warm-up of the
cell's own shapes."""


def read(run):
    return run.setup_s
