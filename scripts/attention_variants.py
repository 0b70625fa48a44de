#!/usr/bin/env python3
"""Time variants of the Hopper attention kernels K2 and K4 on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python scripts/attention_variants.py "BWD_WGS=1" "BWD_WGS=2" \\
        "FWD_WGS=1" "FWD_WGS=2 FWD_STAGES=3"

Each argument is one variant: overrides of the ``constexpr int`` tile
constants in ``dinomc_tpu_torch/csrc/*.cu`` (``BWD_WGS``, ``BWD_STAGES``,
``FWD_WGS``, ``FWD_STAGES``, ...). Each variant runs in a process of its own
that copies ``csrc/`` to a temporary directory, rewrites the constants there,
builds that library and, on chip_smoke.py's shapes, checks K2 (at the five
main-path shapes of phase 2) and K4 (at the first three of phase 5) against
their plain versions with chip_smoke.py's bounds, K2 also bit-identical on a
repeated call, and times them as chip_smoke.py does (device time, CUDA events
behind a spin kernel). The variants run in the order given and then in
reverse (A B B A), so a drift of the card's speed falls on each alike.
"""

from __future__ import annotations

import math
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _patched_csrc(variant: str, src: Path, dst: Path) -> None:
    """Copy ``src`` to ``dst`` with each NAME=VALUE of ``variant`` applied
    to the one ``constexpr int NAME = ...;`` that defines it."""
    shutil.copytree(src, dst)
    for item in variant.split():
        name, value = item.split("=")
        pattern = re.compile(rf"constexpr int {name} = [^;]+;")
        hits = 0
        for f in dst.glob("*.cu"):
            text, n = pattern.subn(f"constexpr int {name} = {value};", f.read_text())
            if n:
                f.write_text(text)
                hits += n
        if hits != 1:
            raise SystemExit(f"{name}: {hits} definitions found in csrc/*.cu, want 1")


def _child(variant: str) -> None:
    import torch

    import chip_smoke as cs
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.ops.hopper import attention as ha
    from dinomc_tpu_torch.ops.hopper import attention_long as hl

    tmp = Path(tempfile.mkdtemp())
    try:
        _patched_csrc(variant, _build.CSRC_DIR, tmp / "csrc")
        _build.CSRC_DIR, _build.BUILD_DIR = tmp / "csrc", tmp / "build"
        _build.library()
        tag = f"[{variant}]"
        for i, (what, B, N, h, d, bd) in enumerate(cs.ATTN_SHAPES[:5]):
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            q, k, v = torch.randn(B, N, 3, h, d, generator=gen, device="cuda").bfloat16().unbind(2)
            do = torch.randn(B, N, h, d, generator=gen, device="cuda").bfloat16()
            s = 1.0 / math.sqrt(d)
            o, lse = ha.attention_fwd(q, k, v, s, bd)
            grads, again = (ha.attention_bwd(q, k, v, o, lse, do, s, bd) for _ in range(2))
            xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            ref = torch.autograd.grad(ha.fused_mha_reference(*xs, s, bd), xs, do)
            rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                      for a, b in zip(grads, ref))
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            if not (rel <= cs.ATTN_GRAD_RTOL and same):
                raise AssertionError(f"{tag} K2 disagrees with its plain version at {what}")
            _, delta = ha.attention_bwd_dq(q, k, v, o, lse, do, s, bd)
            t = cs._time_ms(torch, lambda: ha.attention_bwd(q, k, v, o, lse, do, s, bd))
            t_dq = cs._time_ms(torch, lambda: ha.attention_bwd_dq(q, k, v, o, lse, do, s, bd))
            t_dkv = cs._time_ms(torch, lambda: ha.attention_bwd_dkv(
                q, k, v, lse, delta, do, s, bd))
            print(f"{tag} K2 {what}: max rel {rel:.3e}, repeat bit-identical  ms {t:.4f} "
                  f"(dQ {t_dq:.4f}, dK/dV {t_dkv:.4f})", flush=True)
        for i, (what, B, N, h, d) in enumerate(cs.LONG_SHAPES[:3]):
            gen = torch.Generator(device="cuda").manual_seed(200 + i)
            q, k, v = torch.randn(B, N, 3, h, d, generator=gen, device="cuda").bfloat16().unbind(2)
            s = 1.0 / math.sqrt(d)
            o, _ = hl.long_attention_fwd(q, k, v, s)
            err = (o.float() - hl.long_mha_reference(q, k, v, s).float()).abs().max().item()
            if not err <= cs.ATTN_FWD_ATOL:
                raise AssertionError(f"{tag} K4 disagrees with its plain version at {what}")
            t = cs._time_ms(torch, lambda: hl.long_attention_fwd(q, k, v, s))
            print(f"{tag} K4 {what}: max|diff| {err:.3e}  ms {t:.4f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _child(sys.argv[2])
        return 0
    variants = sys.argv[1:]
    if not variants or any(v.startswith("-") for v in variants):
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for variant in variants + variants[::-1]:
        subprocess.run([sys.executable, __file__, "--child", variant], check=True, cwd=ROOT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
