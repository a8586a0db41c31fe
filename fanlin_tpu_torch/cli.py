"""CLI entrypoint: ``python -m fanlin_tpu_torch.cli [-c CONF] [-j JSON]``.

Port of fanlin_tpu/cli.py (the reference's clap interface, reference
src/main.rs:21-41): -c/--conf (default fanlin.json), -j/--json inline
config wins over the file. Serves on the CUDA device, with graceful
shutdown on SIGINT/SIGTERM (main.rs:276-294): one process, or with
`tpu.workers` > 1 N gateway workers around one device service
(`server.workers`). `tpu.warmup` warms the kernels and caches at
startup (`engine.warmup`) in the background."""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys
import threading
from typing import Optional

import torch

from aiohttp import web

from . import config as config_mod
from .engine import warmup as warmup_mod
from .server.app import build_state, check_ported, create_app
from .utils import logging as json_logging


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="fanlin-tpu-torch",
        description="A web server to process and serve images, on PyTorch and CUDA",
    )
    parser.add_argument("-c", "--conf", default="fanlin.json",
                        help="path to a config file (default: fanlin.json)")
    parser.add_argument("-j", "--json", default=None,
                        help="inline JSON config (takes precedence over --conf)")
    return parser.parse_args(argv)


async def serve(cfg: config_mod.Config,
                device: Optional[torch.device] = None) -> None:
    state = await build_state(cfg, device=device)
    if cfg.tpu.warmup:
        # configured shapes join the defaults; without them the
        # fallback images' geometries do
        shapes = warmup_mod.shapes_from_state(state,
                                              tuple(cfg.tpu.warmup_shapes))

        def warm():
            warmup_mod.warm_host(shapes)
            warmup_mod.warm(state.engine.runner.batcher, shapes,
                            device_decode=state.engine.device_decode,
                            device_dct=cfg.tpu.device_dct,
                            fast_decode=cfg.tpu.fast_decode)

        threading.Thread(target=warm, name="fanlin-warmup",
                         daemon=True).start()
    app = create_app(cfg, state)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, cfg.bind_addr, cfg.port)
    await site.start()

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    print(f"fanlin-tpu-torch listening on {cfg.bind_addr}:{cfg.port} "
          f"({state.engine.runner.device})", flush=True)
    await stop.wait()
    await runner.cleanup()


def main(argv=None, device: Optional[torch.device] = None) -> int:
    """device: where to serve; None is CUDA (raising where there is
    none). Tests pass torch.device("cpu")."""
    args = parse_args(argv)
    try:
        if args.json is not None:
            cfg = config_mod.Config.from_str(args.json)
        else:
            cfg = config_mod.Config.from_file(args.conf)
        check_ported(cfg)
    except (config_mod.ConfigError, OSError) as e:
        print(f"failed to load config: {e}", file=sys.stderr)
        return 1
    json_logging.setup(bool(cfg.suppress_logging))
    if cfg.tpu.workers > 1:
        # N gateway workers around one device service: branch before any
        # asyncio or CUDA state exists (the workers fork from here)
        from .server.workers import serve_multiworker

        return serve_multiworker(cfg, device=device)
    try:
        asyncio.run(serve(cfg, device))
    except config_mod.ConfigError as e:
        # what only the device can tell (tpu.data_parallel's count)
        print(f"failed to start: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
