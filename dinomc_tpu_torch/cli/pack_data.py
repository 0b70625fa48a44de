"""Offline corpus packer: decode a SeCo-style (or flat) image tree once into
the packed-shard format (``data/packed.py``), so that training reads raw
uint8 records by mmap instead of decoding JPEG/TIFF every epoch (the
reference's 10-worker PIL pool, ``main_dino_mc.py:195-201``).

Counterpart of ``dinomc_tpu/cli/pack_data.py``: the same flags, the same
shards and index, the same JSON line. Usage::

    python -m dinomc_tpu_torch.cli.pack_data --src /data/seco_100k \\
        --out /data/seco_100k_packed --size 256

``python -m dinomc_tpu_torch.cli.train_dino --data_path <out>`` then trains
from it (``--data_mode tp`` for DINO-TP).
"""

from __future__ import annotations

import argparse
import json
import time


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("pack_data", add_help=False)
    p.add_argument("--src", required=True, help="source image tree")
    p.add_argument("--out", required=True, help="output packed directory")
    p.add_argument("--size", default=256, type=int,
                   help="record resolution (decode+resize target)")
    p.add_argument("--records_per_shard", default=2048, type=int)
    p.add_argument("--threads", default=8, type=int, help="native decode threads")
    return p


def main(argv=None) -> dict:
    """Pack ``--src`` into ``--out``, print one JSON line and return it."""
    args = argparse.ArgumentParser("pack_data", parents=[get_args_parser()]).parse_args(argv)
    from dinomc_tpu_torch.data.packed import pack_dataset

    t0 = time.perf_counter()
    index = pack_dataset(args.src, args.out, size=args.size,
                         records_per_shard=args.records_per_shard, threads=args.threads)
    dt = time.perf_counter() - t0
    line = {
        "packed": index["n"],
        "groups": len(index["groups"]),
        "shards": len(index["shards"]),
        "record_shape": index["record_shape"],
        "seconds": round(dt, 1),
        "images_per_sec": round(index["n"] / max(dt, 1e-9), 1),
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
