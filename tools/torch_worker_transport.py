#!/usr/bin/env python3
"""Worker mode's transport on the card, in turns: the port's (a message's
arrays in a memfd passed over the unix socket) against the JAX package's
framing (the whole pickle streamed through the socket), both with
`tpu.workers` 4, and one process (`workers` 1) as the yardstick.

Usage, from the repository root on a machine with a CUDA card:
    python3 tools/torch_worker_transport.py

Builds the kernels (chip_smoke.py phase 1), writes phase 5's and 7's
sources, boots the three servers with chip_smoke.py's phase 8 helpers,
waits for their warmup, then runs 16 and 64 concurrent README requests
(each on its own connection) against each server in turns, 7 times.
Prints, per server and burst size, img/s (median and each turn), the
median f_device of the responses and the device service's mean receive
ms per request (handler start to request decoded).
"""

import asyncio
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# the JAX package's framing (fanlin_tpu/server/workers.py:_send/_recv),
# installed before the CLI forks, so the service and every worker use it
STREAM = '''
import pickle, sys
import fanlin_tpu_torch.server.workers as w
def _send(sock, obj):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(w._HDR.pack(len(data)) + data)
def _recv(sock, deadline=None):
    (n,) = w._HDR.unpack(w._recvn(sock, w._HDR.size, deadline))
    return pickle.loads(w._recvn(sock, n, deadline))
w._send, w._recv = _send, _recv
from fanlin_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
'''
TURNS = 7


class _StreamServer(cs._CliServer):
    def command(self, cfg_json: str) -> list:
        return [sys.executable, "-c", STREAM, "-j", cfg_json]


async def main() -> None:
    cs.phase0()
    cs.phase1()
    cs._gen_sources()
    folder = cs._gen_cmyk_sources()
    from fanlin_tpu_torch.engine import warmup

    servers = {"workers 1": cs._CliServer(folder, workers=1),
               "workers 4, socket stream": _StreamServer(folder, workers=4),
               "workers 4, memfd": cs._CliServer(folder, workers=4)}
    try:
        for srv in servers.values():
            srv.wait_banners()
        want = (len(warmup.DEFAULT_SHAPES) * 2
                * len(warmup._kinds(device_decode=True, device_dct=False)))
        for srv in servers.values():
            await cs._wait_warm(srv, want)
        rows = {(k, n): {"walls": [], "f_device": [], "recv": []}
                for k in servers for n in (16, 64)}
        async with cs._fresh_session() as s:
            for turn in range(TURNS):
                order = list(servers) if turn % 2 == 0 else list(servers)[::-1]
                for k in order:
                    base = servers[k].base
                    for n in (16, 64):
                        st0 = await cs._get_stats(s, base)
                        t0 = time.perf_counter()
                        got = await asyncio.gather(
                            *(cs._get(s, base, cs.README) for _ in range(n)))
                        wall = time.perf_counter() - t0
                        st1 = await cs._get_stats(s, base)
                        cs.check(all(g[0] == 200 for g in got),
                                 f"{k}: statuses {sorted({g[0] for g in got})}")
                        row = rows[(k, n)]
                        row["walls"].append(wall)
                        row["f_device"] += [g[2]["f_device"] for g in got]
                        if st1.get("service"):
                            d = cs._diff(st1["service"], st0["service"])
                            row["recv"].append(
                                d["recv_ms_total"] / max(d["runs"], 1))
        for (k, n), row in rows.items():
            med = statistics.median(row["walls"])
            print(f"{k}, {n} concurrent README requests: {n / med:.2f} img/s "
                  f"(median of {TURNS}; turns "
                  f"{[round(n / x, 2) for x in row['walls']]}), f_device "
                  f"median {statistics.median(row['f_device']):.1f} ms, "
                  f"service receive ms per request "
                  f"{[round(x, 3) for x in row['recv']] or None}", flush=True)
        for srv in servers.values():
            srv.terminate()
    finally:
        for srv in servers.values():
            srv.kill()


if __name__ == "__main__":
    asyncio.run(main())
