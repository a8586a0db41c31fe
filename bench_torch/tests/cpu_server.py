"""The port's server on the CPU, for the harness's tests: the same CLI
(`fanlin_tpu_torch.cli.main`) given torch.device("cpu"), where the
kernels run their plain torch versions, optionally with a fault
planted in the served path. `--device cuda` serves from the card
instead, to read a planted fault at a cell's own size there.

    python bench_torch/tests/cpu_server.py [--fault NAME] [--device D] -j CONFIG

Faults:
  alter  every answer altered where it is produced: the image's red
         and blue planes swapped before the encoder sees it;
  band   a local gross error in every answer: 8 rows across its middle
         set to black before the encoder sees them;
  half   half of every device batch left out: those requests are
         answered with the first image of their batch.
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def plant(fault: str) -> None:
    if fault == "alter":
        from fanlin_tpu_torch.engine import codecs

        encode = codecs.encode

        def altered(img, fmt, quality, mode):
            img = img.copy()
            img[:, :, [0, 2]] = img[:, :, [2, 0]]
            return encode(img, fmt, quality, mode)

        codecs.encode = altered
    elif fault == "band":
        from fanlin_tpu_torch.engine import codecs

        encode = codecs.encode

        def banded(img, fmt, quality, mode):
            img = img.copy()
            mid = img.shape[0] // 2
            img[max(mid - 4, 0):mid + 4] = 0
            return encode(img, fmt, quality, mode)

        codecs.encode = banded
    elif fault == "half":
        from fanlin_tpu_torch.engine import batcher

        collect_batch = batcher.MicroBatcher._collect_batch

        def halved(self, asm, out, futures, watch, releaser):
            collect = asm.collect

            def first_half(o):
                res = list(collect(o))
                keep = (len(res) + 1) // 2
                return res[:keep] + [res[0]] * (len(res) - keep)

            asm.collect = first_half
            return collect_batch(self, asm, out, futures, watch, releaser)

        batcher.MicroBatcher._collect_batch = halved
    elif fault != "none":
        raise SystemExit(f"unknown fault {fault!r}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", default="none")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("-j", "--json", required=True)
    args = ap.parse_args()
    import torch

    plant(args.fault)
    from fanlin_tpu_torch import cli

    # the card as the served path takes it: the CLI's own default
    device = None if args.device == "cuda" else torch.device(args.device)
    return cli.main(["-j", args.json], device=device)


if __name__ == "__main__":
    sys.exit(main())
