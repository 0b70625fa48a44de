#!/usr/bin/env python3
"""Time the photometric kernel K3 at the DINO step's crop sizes on one GPU,
for this checkout or another one.

Run from the root of a checkout on a machine with a CUDA card:

    python scripts/photometric_sizes.py [--root DIR]

``--root`` imports ``dinomc_tpu_torch`` from DIR (default: this checkout),
so a parent commit unpacked there is timed by the same code in the same
call (parent, change, change, parent). At B = 8 and each size of
``chip_smoke.PHOTO_SIZES``, on ``chip_smoke._branch_rows`` (every branch,
flip rows on and off), with chip_smoke.py's timers: the kernel alone,
without the flip, as device time; and a crop's flip and photometric chain
as ``ops/augment._crop`` issues it, as device time and with the host's
cost of issuing it: one call with ``flip=True`` where the kernel takes it,
else ``torch.where`` over ``flip(-1)`` followed by the kernel; and each
device kernel's time a crop call, by function name, from a
``torch.profiler`` trace of 20 calls (the tracer's clock, not the
spin-queued events; a trace with no device events says so).
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _split_us(torch, fn, calls=20) -> dict:
    """Device µs a call of ``fn`` spends in each kernel, by function name,
    from a torch.profiler trace of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    us = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            m = re.search(r"(\w+)(<[^(]*>)?\(", e["name"])
            us[m.group(1) if m else e["name"][:40]] += e["dur"] / calls
    return dict(us)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=str(ROOT), help="checkout whose dinomc_tpu_torch is timed")
    args = p.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's: its timers, sizes and rows

    sys.path.insert(0, str(root))  # ahead of it: the package under test
    import torch

    from dinomc_tpu_torch.ops.hopper import augment as ha

    if not torch.cuda.is_available():
        raise SystemExit("photometric_sizes: torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    takes_flip = "flip" in inspect.signature(ha.photometric_kernel).parameters
    print(f"{smi}  root {root}  flip inside the kernel: {takes_flip}", flush=True)
    for S in cs.PHOTO_SIZES:
        B = 8
        gen = torch.Generator(device="cuda").manual_seed(S)
        imgs = torch.rand(B, 3, S, S, generator=gen, device="cuda")
        rows = cs._branch_rows(torch, B, S)
        if takes_flip:
            def crop():
                return ha.photometric_kernel(imgs, rows, flip=True)
        else:
            def crop():
                flip = (rows[:, ha.P_FLIP] > 0.5)[:, None, None, None]
                return ha.photometric_kernel(torch.where(flip, imgs.flip(-1), imgs), rows)
        t = {
            "kernel_ms": cs._time_ms(torch, lambda: ha.photometric_kernel(imgs, rows)),
            "crop_ms": cs._time_ms(torch, crop),
            "host_crop_ms": cs._host_ms(torch, crop),
        }
        print(f"[photometric sizes] S={S} B={B}: {cs._fmt(t)}", flush=True)
        split = _split_us(torch, crop)
        print(f"[photometric sizes] S={S} B={B} device us a crop call by kernel: "
              + ("  ".join(f"{k} {v:.2f}" for k, v in split.items())
                 or "no device events in the trace"), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
