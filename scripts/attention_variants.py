#!/usr/bin/env python3
"""Time variants of the hand-written kernels K1-K11 on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python scripts/attention_variants.py --kernels K5,K10 \\
        "DQ_KEYS=64" "DQ_KEYS=128 STACKED_BWD_HEADS=2"

Each argument is one variant: overrides of the ``constexpr int`` tile
constants in ``dinomc_tpu_torch/csrc/*.cu`` (``PHOTO_THREADS``,
``PART_ROWS`` for K3; ``ATTN_FWD_KEYS``,
``ATTN_FWD_STAGES`` for K1; ``BWD_WGS``, ``BWD_STAGES`` for K2; ``FWD_WGS``,
``FWD_STAGES`` for K4; ``DQ_WGS``, ``DQ_KEYS``, ``DQ_STAGES`` for K5;
``DKV_WGS``, ``DKV_STAGES`` for K6; ``WIN_FWD_STAGES`` for K7;
``WIN_BWD_STAGES`` for K8; ``WINS_FWD_STAGES`` for K9;
``WINS_BWD_STAGES`` for K10; ``MLP384_ROW_GROUPS``, ``MLP384_COL_SPLIT``,
``MLP384_CHUNK``, ``MLP384_STAGES`` for K11 at the ViT-S width; ...), and
of ``STACKED_FWD_HEADS`` and ``STACKED_BWD_HEADS``, K9's and K10's most
heads a block (``ops/hopper/window_attention.STACKED_HEADS``). Each variant
runs in a process of its own that copies ``csrc/`` to a temporary
directory, rewrites the constants there and builds that library (into the
package's build directory, named by the sources' hash, so a variant that
differs only in the Python constants, or comes round again, reuses it).
On chip_smoke.py's shapes, it checks each kernel of ``--kernels`` (default
all eleven) against its plain version with chip_smoke.py's bounds and times
it as chip_smoke.py does (device time, CUDA events behind a spin kernel):
K3 with the flip at every crop size of phase 3 (also with the host's
cost); K1 and K2 at the five main-path shapes of phase 2, K4, K5 and K6 at
the first three of phase 5, K7, K8, K9 and K10 at the four 224 px stages of
phase 7 (K7 and K9 also with the host's cost, and weighed 2/2/6/2 over the
stages as a Swin-T step launches them), K11 at the ViT-S rows of phase 9
beside the dense ``F.linear``, ``F.gelu``, ``F.linear`` chain; K2, K3, K5,
K6, K7, K8, K9 and K10 also bit-identical on a repeated call. The variants
run in the order given and then in reverse (A B B A), so a drift of the
card's speed falls on each alike.
"""

from __future__ import annotations

import argparse
import math
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11")
# Python constants, not csrc ones: the knob -> its STACKED_HEADS key
HEADS_KNOBS = {"STACKED_FWD_HEADS": "fwd", "STACKED_BWD_HEADS": "bwd"}
STAGE_WEIGHTS = (2, 2, 6, 2)  # Swin-T's blocks a stage


def _patched_csrc(variant: str, src: Path, dst: Path) -> None:
    """Copy ``src`` to ``dst`` with each NAME=VALUE of ``variant`` applied
    to the one ``constexpr int NAME = ...;`` that defines it."""
    shutil.copytree(src, dst)
    for item in variant.split():
        name, value = item.split("=")
        if name in HEADS_KNOBS:
            continue
        pattern = re.compile(rf"constexpr int {name} = [^;]+;")
        hits = 0
        for f in dst.glob("*.cu"):
            text, n = pattern.subn(f"constexpr int {name} = {value};", f.read_text())
            if n:
                f.write_text(text)
                hits += n
        if hits != 1:
            raise SystemExit(f"{name}: {hits} definitions found in csrc/*.cu, want 1")


def _inputs(torch, seed, B, N, h, d):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = torch.randn(B, N, 3, h, d, generator=gen, device="cuda").bfloat16().unbind(2)
    do = torch.randn(B, N, h, d, generator=gen, device="cuda").bfloat16()
    return q, k, v, do, 1.0 / math.sqrt(d)


def _rel(got, ref) -> float:
    return max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(got, ref))


def _short(torch, cs, ha, tag, kernels):
    for i, (what, B, N, h, d, bd) in enumerate(cs.ATTN_SHAPES[:5]):
        q, k, v, do, s = _inputs(torch, 100 + i, B, N, h, d)
        o, lse = ha.attention_fwd(q, k, v, s, bd)
        if "K1" in kernels:
            err = (o.float() - ha.fused_mha_reference(q, k, v, s, bd).float()).abs().max().item()
            if not err <= cs.ATTN_FWD_ATOL:
                raise AssertionError(f"{tag} K1 disagrees with its plain version at {what}")
            t = cs._time_ms(torch, lambda: ha.attention_fwd(q, k, v, s, bd))
            print(f"{tag} K1 {what}: max|diff| {err:.3e}  ms {t:.4f}", flush=True)
        if "K2" in kernels:
            grads, again = (ha.attention_bwd(q, k, v, o, lse, do, s, bd) for _ in range(2))
            xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            rel = _rel(grads, torch.autograd.grad(ha.fused_mha_reference(*xs, s, bd), xs, do))
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


def _photometric(torch, cs, ha, tag):
    for S in cs.PHOTO_SIZES:
        gen = torch.Generator(device="cuda").manual_seed(S)
        imgs = torch.rand(8, 3, S, S, generator=gen, device="cuda")
        rows = cs._branch_rows(torch, 8, S)
        out, again = (ha.photometric_kernel(imgs, rows, flip=True) for _ in range(2))
        err = (out - ha.photometric_reference(imgs, rows, flip=True)).abs().max().item()
        if not (err <= cs.PHOTO_ATOL and torch.equal(out, again)):
            raise AssertionError(f"{tag} K3 disagrees with its plain version at S={S}")
        t = cs._time_ms(torch, lambda: ha.photometric_kernel(imgs, rows, flip=True))
        host = cs._host_ms(torch, lambda: ha.photometric_kernel(imgs, rows, flip=True))
        print(f"{tag} K3 S={S}: max|diff| {err:.3e}, repeat bit-identical  ms {t:.4f}  "
              f"host ms {host:.4f}", flush=True)


def _long(torch, cs, hl, tag, kernels):
    for i, (what, B, N, h, d) in enumerate(cs.LONG_SHAPES[:3]):
        q, k, v, do, s = _inputs(torch, 200 + i, B, N, h, d)
        o, lse = hl.long_attention_fwd(q, k, v, s)
        if "K4" in kernels:
            err = (o.float() - hl.long_mha_reference(q, k, v, s).float()).abs().max().item()
            if not err <= cs.ATTN_FWD_ATOL:
                raise AssertionError(f"{tag} K4 disagrees with its plain version at {what}")
            t = cs._time_ms(torch, lambda: hl.long_attention_fwd(q, k, v, s))
            print(f"{tag} K4 {what}: max|diff| {err:.3e}  ms {t:.4f}", flush=True)
        if "K5" in kernels:
            (dq, delta), (dq2, delta2) = (hl.long_attention_dq(q, k, v, o, lse, do, s)
                                          for _ in range(2))
            xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            ref = torch.autograd.grad(hl.long_mha_reference(*xs, s), xs[0], do)
            rel = _rel((dq,), ref)
            same = torch.equal(dq, dq2) and torch.equal(delta, delta2)
            if not (rel <= cs.ATTN_GRAD_RTOL and same):
                raise AssertionError(f"{tag} K5 disagrees with its plain version at {what}")
            t = cs._time_ms(torch, lambda: hl.long_attention_dq(q, k, v, o, lse, do, s))
            print(f"{tag} K5 {what}: max rel {rel:.3e}, repeat bit-identical  ms {t:.4f}",
                  flush=True)
            del xs, ref
        if "K6" in kernels:
            _, delta = hl.long_attention_dq(q, k, v, o, lse, do, s)
            grads, again = (hl.long_attention_dkv(q, k, v, lse, delta, do, s) for _ in range(2))
            xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            ref = torch.autograd.grad(hl.long_mha_reference(*xs, s), xs[1:], do)
            rel = _rel(grads, ref)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            if not (rel <= cs.ATTN_GRAD_RTOL and same):
                raise AssertionError(f"{tag} K6 disagrees with its plain version at {what}")
            t = cs._time_ms(torch, lambda: hl.long_attention_dkv(q, k, v, lse, delta, do, s))
            print(f"{tag} K6 {what}: max rel {rel:.3e}, repeat bit-identical  ms {t:.4f}",
                  flush=True)
            del xs, ref


def _window(torch, cs, wa, tag, kernels):
    forwards = [(name, fn) for name, fn in (("K7", wa.window_attention_fwd),
                                            ("K9", wa.window_attention_stacked_fwd))
                if name in kernels]
    launchers = [(name, fn) for name, fn in (("K8", wa.window_attention_bwd),
                                             ("K10", wa.window_attention_stacked_bwd))
                 if name in kernels]
    weighed = {}
    for i, (what, nB, heads, side, shift) in enumerate(cs.SWIN_SHAPES[:4]):
        q, k, v, bias, mask, do = cs._window_inputs(torch, nB, heads, side, shift, 300 + i)
        ref = wa.window_attention_reference(q, k, v, bias, mask, heads)
        for name, fwd in forwards:
            o, again = (fwd(q, k, v, bias, mask, heads) for _ in range(2))
            err = (o.float() - ref.float()).abs().max().item()
            if not (err <= cs.ATTN_FWD_ATOL and torch.equal(o, again)):
                raise AssertionError(f"{tag} {name} disagrees with its plain version at {what}")
            t = cs._time_ms(torch, lambda: fwd(q, k, v, bias, mask, heads))
            host = cs._host_ms(torch, lambda: fwd(q, k, v, bias, mask, heads))
            hc = 1 if name == "K7" else wa.head_chunk(heads, wa.STACKED_HEADS["fwd"])
            weighed[name] = weighed.get(name, 0.0) + STAGE_WEIGHTS[i] * t
            print(f"{tag} {name} {what} ({hc} heads a block): max|diff| {err:.3e}, repeat "
                  f"bit-identical  ms {t:.4f}  host ms {host:.4f}", flush=True)
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
        ref = torch.autograd.grad(wa.window_attention_reference(*xs, mask, heads), xs, do)
        for name, bwd in launchers:
            grads, again = (bwd(q, k, v, bias, mask, do, heads) for _ in range(2))
            rel = _rel(grads, ref)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            if not (rel <= cs.ATTN_GRAD_RTOL and same):
                raise AssertionError(f"{tag} {name} disagrees with its plain version at {what}")
            t = cs._time_ms(torch, lambda: bwd(q, k, v, bias, mask, do, heads))
            hc = 1 if name == "K8" else wa.head_chunk(heads, wa.STACKED_HEADS["bwd"])
            weighed[name] = weighed.get(name, 0.0) + STAGE_WEIGHTS[i] * t
            print(f"{tag} {name} {what} ({hc} heads a block): max rel {rel:.3e}, repeat "
                  f"bit-identical  ms {t:.4f}", flush=True)
        del xs, ref
    for name, total in weighed.items():
        print(f"{tag} {name} weighed {'/'.join(map(str, STAGE_WEIGHTS))} over stages 1-4: "
              f"ms {total:.4f}", flush=True)


def _mlp(torch, cs, fm, tag):
    F = torch.nn.functional
    for i, (what, M, D, Fd) in enumerate(cs.MLP_SHAPES):
        if D != 384:
            continue
        (x, w1, b1, w2, b2), _ = cs._mlp_inputs(torch, M, D, Fd, 400 + i)
        out = fm.fused_mlp_fwd(x, w1, b1, w2, b2, True).float()
        ref = fm.fused_mlp_reference(x, w1, b1, w2, b2, True).float()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        if not rel <= cs.MLP_RTOL:
            raise AssertionError(f"{tag} K11 disagrees with its plain version at {what}")
        t = cs._time_ms(torch, lambda: fm.fused_mlp_fwd(x, w1, b1, w2, b2, True))
        dense = cs._time_ms(torch, lambda: F.linear(
            F.gelu(F.linear(x, w1, b1), approximate="tanh"), w2, b2))
        print(f"{tag} K11 {what}: rel {rel:.3e}  ms {t:.4f} ({4 * M * D * Fd / t / 1e9:.1f} "
              f"TFLOP/s)  dense chain {dense:.4f}", flush=True)


def _child(variant: str, kernels: list) -> None:
    import torch

    import chip_smoke as cs
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.ops.hopper import attention as ha
    from dinomc_tpu_torch.ops.hopper import attention_long as hl
    from dinomc_tpu_torch.ops.hopper import augment as hp
    from dinomc_tpu_torch.ops.hopper import fused_mlp as fm
    from dinomc_tpu_torch.ops.hopper import window_attention as wa

    tmp = Path(tempfile.mkdtemp())
    try:
        _patched_csrc(variant, _build.CSRC_DIR, tmp / "csrc")
        for item in variant.split():
            name, value = item.split("=")
            if name in HEADS_KNOBS:
                wa.STACKED_HEADS[HEADS_KNOBS[name]] = int(value)
        _build.CSRC_DIR = tmp / "csrc"
        _build.library()
        tag = f"[{variant}]"
        if "K3" in kernels:
            _photometric(torch, cs, hp, tag)
        if {"K1", "K2"} & set(kernels):
            _short(torch, cs, ha, tag, kernels)
        if {"K4", "K5", "K6"} & set(kernels):
            _long(torch, cs, hl, tag, kernels)
        if {"K7", "K8", "K9", "K10"} & set(kernels):
            _window(torch, cs, wa, tag, kernels)
        if "K11" in kernels:
            _mlp(torch, cs, fm, tag)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("variants", nargs="+")
    p.add_argument("--kernels", default=",".join(KERNELS),
                   help=f"comma-separated subset of {','.join(KERNELS)} to check and time")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(f"--kernels: choose from {KERNELS}")
    if args.child:
        _child(args.variants[0], kernels)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for variant in args.variants + args.variants[::-1]:
        subprocess.run([sys.executable, __file__, "--child", "--kernels", args.kernels, variant],
                       check=True, cwd=ROOT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
