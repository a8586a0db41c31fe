"""CLI entrypoint: ``python -m fanlin_tpu_torch.cli [-c CONF] [-j JSON]``.

Port of fanlin_tpu/cli.py (the reference's clap interface, reference
src/main.rs:21-41): -c/--conf (default fanlin.json), -j/--json inline
config wins over the file. One process serving on the CUDA device,
with graceful shutdown on SIGINT/SIGTERM (main.rs:276-294)."""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from aiohttp import web

from . import config as config_mod
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


async def serve(cfg: config_mod.Config) -> None:
    state = await build_state(cfg)
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


def main(argv=None) -> int:
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
    asyncio.run(serve(cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
