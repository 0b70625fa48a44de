#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``dinomc_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing its results on lines of its own; any failure raises and the
script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (``nvcc`` from ``dinomc_tpu_torch/csrc``, timed);
2. attention K1 (forward) and K2 (backward) against their plain version
   on the card, in bf16, at the main path's shapes and a few small ones;
3. photometric K3 against its plain version at 224 and 84 px, with rows
   that cover every branch;
4. the real entry point, ``dinomc_tpu_torch.cli.train_dino.train_dino``,
   for 5 ViT-S/8 steps (out_dim 65536, batch 8, synthetic images, weights
   from a seed), with every kernel's launch count over that run;
5. long-sequence attention K4 (forward), K5 (dQ) and K6 (dK/dV) against
   their plain version on the card, in bf16, at the segmentation path's
   shapes (4097 tokens at 512 px, patch 8), past the TPU kernel's 5120 cap,
   and a few ragged small ones;
6. the segmentation entry point, ``dinomc_tpu_torch.cli.train_seg.train_seg``,
   twice at the published widths (ViT-S/8 UPerNet, 512 px, batch 4, 8 UAVid
   classes, synthetic data, weights from a seed): decoder-only and with the
   backbone trained, 4 steps and a validation pass each, with the kernels'
   launch counts over each run;
7. Swin window attention K7 (forward) and K8 (backward, dbias included)
   against their plain version on the card, in bf16, at the four stage
   shapes of Swin-T at 224 px (16 images), the 184 px stage-1 shape (shift +
   pad masks), the 84 px stage-4 shape (a pad-only mask) and a ragged small
   one; every 224 px stage timed as kernel, plain version and
   ``F.scaled_dot_product_attention`` with the float mask bias + mask, on
   the device and, apart, with the host's launch cost in;
8. the pretraining entry point again, for 5 Swin-T steps (``--arch swin_t``,
   out_dim 65536, batch 8), with K3, K7 and K8 launched exactly as often as
   the configuration implies and no other kernel launched.

Then one JSON line with each kernel's launches, error, times, bound and
library time, and as the last line ``{"ok": true, "device": {...}}``. With
no CUDA device it exits with 1 and prints no result.

Every time in that line is device time: CUDA events around 10 calls
(after 2 warm-up calls) queued behind a spin kernel (``torch.cuda._sleep``)
that holds the card until the host has issued them all, so the card runs
them back to back and the host's cost of issuing them is not in it; the
script checks that the card was still spinning when the last call was
queued, and fails if it never was. A ``host_`` time (phase 7) is CUDA
events around 10 calls issued back to back with no spin kernel, so it also
holds the host's cost of issuing them where that exceeds the device's.

Each kernel's bound is the least time the card could take for the work:
the larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s and its operations over the peak rate of their
type (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them),
from the H100 SXM data sheet. Its library time is one PyTorch call that
computes the same function, timed here and used nowhere in the port.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

# Tolerances, kernel against its plain version on the same inputs:
# attention outputs are rounded to bf16 (2^-8 relative) and the kernels also
# round P to bf16 before the PV product (and dS before dQ/dK), at different
# points than the plain version does; forward |diff| <= 1e-2 absolute and
# gradients max|diff| / max|ref| <= 2e-2 leave room for that and no more.
ATTN_FWD_ATOL = 1e-2
ATTN_GRAD_RTOL = 2e-2
# photometric: f32 both sides; the slack is FMA contraction and the order of
# the mean-gray reduction, amplified by up to 1/0.225 in the normalize.
PHOTO_ATOL = 1e-4

ATTN_SHAPES = [  # (what, B, N, heads, head_dim, boundary)
    ("global 224px", 16, 785, 6, 64, 0),
    ("packed 184+84 px", 8, 631, 6, 64, 530),
    ("packed 164+124 px", 8, 627, 6, 64, 401),
    ("packed 144+104 px", 8, 495, 6, 64, 325),
    ("single 84px", 8, 101, 6, 64, 0),
    ("ragged small", 2, 70, 2, 32, 33),
    ("ragged d16", 3, 50, 4, 16, 0),
]
TRAIN_ARGS = [
    "--arch", "vit_small", "--patch_size", "8", "--out_dim", "65536",
    "--batch_size_per_gpu", "8", "--data_path", "synthetic", "--max_steps", "5",
    "--device", "cuda", "--print_freq", "1", "--num_workers", "4",
]
LONG_SHAPES = [  # (what, B, N, heads, head_dim); the first is timed
    ("ViT-S/8 at 512 px", 4, 4097, 6, 64),
    ("ViT-S/16 at 512 px", 4, 1025, 6, 64),
    ("ViT-S/8 at 600 px", 2, 5626, 6, 64),
    ("ragged d32", 1, 1100, 2, 32),
    ("ragged d16", 1, 1030, 4, 16),
]
SEG_STEPS = 4
SWIN_SHAPES = [  # (what, windows, heads, map side, shift); the first four are timed
    ("stage 1, 224 px", 1024, 3, 56, 3),
    ("stage 2, 224 px", 256, 6, 28, 3),
    ("stage 3, 224 px", 64, 12, 14, 3),
    ("stage 4, 224 px", 16, 24, 7, 0),
    ("stage 1, 184 px", 8 * 49, 3, 46, 3),
    ("stage 4, 84 px", 8, 24, 3, 0),
    ("ragged small", 8, 2, 10, 3),
]
SWIN_TRAIN_ARGS = [
    "--arch", "swin_t", "--out_dim", "65536", "--batch_size_per_gpu", "8",
    "--data_path", "synthetic", "--max_steps", "5", "--device", "cuda",
    "--print_freq", "1", "--num_workers", "4",
]
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SEG_ARGS = [
    "--device", "cuda", "--dataset", "uavid", "--data_root", "synthetic",
    "--arch", "vit_small", "--patch_size", "8", "--image_size", "512",
    "--batch_size", "4", "--max_steps", str(SEG_STEPS), "--epochs", "1",
    "--print_freq", "1",
]


_SPIN_CYCLES_PER_MS = []


def _spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` a millisecond, read once."""
    if not _SPIN_CYCLES_PER_MS:
        cycles = 20_000_000
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        _SPIN_CYCLES_PER_MS.append(cycles / a.elapsed_time(b))
    return _SPIN_CYCLES_PER_MS[0]


def _time_ms(torch, fn, iters=10, warmup=2, tries=5) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel twice as long as the host took to issue
    them, so the card runs them back to back. Valid only if the card was
    still spinning when the last call was queued; else it tries again with
    a longer spin and half the calls, and raises after ``tries``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3 / iters  # a call, on the host
    torch.cuda.synchronize()
    for attempt in range(tries):
        spin_ms = 2 ** (attempt + 1) * issue_ms * iters + 1.0
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms(torch)))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        queued = not a.query()  # the card is still spinning: nothing ran yet
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / iters
        iters = max(1, iters // 2)
    raise AssertionError("the host never got ahead of the card: a timed call syncs with it")


def _host_ms(torch, fn, iters=10, warmup=2) -> float:
    """ms of one call of ``fn`` between CUDA events around ``iters`` calls:
    device time, or the host's cost of issuing them where that is larger."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _fmt(times: dict) -> str:
    """``key value`` pairs of a phase's times; a bound prints as ms (what)."""
    return "  ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v[0]:.4f} ({v[1]})"
                     for k, v in times.items())


def _bound(nbytes: float, flops: float, peak: float):
    """(least ms, what bounds it) for work that moves ``nbytes`` and does
    ``flops`` operations at the ``peak`` rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_times(torch, q, k, v, do, attn_mask=None, timer=_time_ms):
    """Forward and backward ms of ``F.scaled_dot_product_attention`` over
    (B, h, N, d) inputs: the library yardstick of an attention kernel. The
    backward's times are for all of dq, dk, dv (and the mask's gradient
    when the mask requires it), and for dq alone and dk, dv alone."""
    F = torch.nn.functional
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*xs, attn_mask=attn_mask)
    wrt = xs + ([attn_mask] if attn_mask is not None and attn_mask.requires_grad else [])
    fixed = None if attn_mask is None else attn_mask.detach()
    return {
        "fwd": timer(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=fixed)),
        "bwd": timer(torch, lambda: torch.autograd.grad(out, wrt, do, retain_graph=True)),
        "dq": timer(torch, lambda: torch.autograd.grad(out, xs[0], do, retain_graph=True)),
        "dkv": timer(torch, lambda: torch.autograd.grad(out, xs[1:], do, retain_graph=True)),
    }


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] torch: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    from dinomc_tpu_torch.ops.hopper import _build

    path, seconds = _build.build()
    _build.library()
    print(f"[build] {path.name}: nvcc {seconds:.1f} s")
    return smi


def phase_attention(torch):
    from dinomc_tpu_torch.ops.hopper.attention import (
        attention_bwd, attention_fwd, fused_mha, fused_mha_reference,
    )

    worst_fwd, worst_grad, worst_grad_rel, timing = 0.0, 0.0, 0.0, None
    for i, (what, B, N, h, d, boundary) in enumerate(ATTN_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        qkv = torch.randn(B, N, 3, h, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(B, N, h, d, generator=gen, device="cuda").bfloat16()
        scale = 1.0 / math.sqrt(d)

        qkv_k = qkv.clone().requires_grad_()
        out = fused_mha(*qkv_k.unbind(2), scale, boundary)
        (g_k,) = torch.autograd.grad(out, qkv_k, do)
        torch.cuda.synchronize()
        qkv_r = qkv.clone().requires_grad_()
        ref = fused_mha_reference(*qkv_r.unbind(2), scale, boundary)
        (g_r,) = torch.autograd.grad(ref, qkv_r, do, retain_graph=True)
        torch.cuda.synchronize()

        fwd_err = (out.float() - ref.float()).abs().max().item()
        grad_err = (g_k.float() - g_r.float()).abs().amax(dim=(0, 1, 3, 4))
        grad_rel = (grad_err / g_r.float().abs().amax(dim=(0, 1, 3, 4))).max().item()
        print(f"[attention] {what}: B={B} N={N} h={h} d={d} boundary={boundary}  "
              f"fwd max|diff| {fwd_err:.3e}  dq/dk/dv max abs {grad_err.tolist()}  "
              f"max rel {grad_rel:.3e}")
        if not (fwd_err <= ATTN_FWD_ATOL and grad_rel <= ATTN_GRAD_RTOL):
            raise AssertionError(f"attention kernel disagrees with its plain version at {what}")
        worst_fwd = max(worst_fwd, fwd_err)
        worst_grad = max(worst_grad, grad_err.max().item())
        worst_grad_rel = max(worst_grad_rel, grad_rel)

        if i < 5:  # main-path shapes: time kernel against plain
            q, k, v = qkv.unbind(2)
            o, lse = attention_fwd(q, k, v, scale, boundary)
            t = {
                "fwd_ms": _time_ms(torch, lambda: attention_fwd(q, k, v, scale, boundary)),
                "fwd_plain_ms": _time_ms(torch, lambda: fused_mha_reference(q, k, v, scale, boundary)),
                "bwd_ms": _time_ms(torch, lambda: attention_bwd(q, k, v, o, lse, do, scale, boundary)),
                "bwd_plain_ms": _time_ms(torch, lambda: torch.autograd.grad(
                    ref, qkv_r, do, retain_graph=True)),
            }
            if timing is None:  # the first shape: the library's time and the bound too
                lib = _sdpa_times(torch, *(x.transpose(1, 2).contiguous() for x in (q, k, v, do)))
                t.update(fwd_library_ms=lib["fwd"], bwd_library_ms=lib["bwd"])
                elems, prod = B * N * h * d, B * h * N * N * d  # boundary 0: every key live
                t["fwd_bound"] = _bound(4 * elems * 2 + B * h * N * 4, 4 * prod, BF16_FLOPS)
                t["bwd_bound"] = _bound(8 * elems * 2 + B * h * N * 4, 10 * prod, BF16_FLOPS)
                timing = t
            print(f"[attention] {what} times: {_fmt(t)}")
        del qkv_r, ref, g_r
    print(f"[attention] worst: fwd max|diff| {worst_fwd:.3e} (bound {ATTN_FWD_ATOL}), grad "
          f"max|diff| {worst_grad:.3e}, max rel {worst_grad_rel:.3e} (bound {ATTN_GRAD_RTOL})")
    return worst_fwd, worst_grad, timing


def _branch_rows(torch, B, S):
    from dinomc_tpu_torch.ops.hopper import augment as ha

    gen = torch.Generator(device="cuda").manual_seed(7 + S)
    rows = ha.draw_photometric_params(gen, B, (0.8, 0.8, 0.8, 0.2), 0.5, 0.5, 0.5, 0.5, device="cuda")
    flags = torch.tensor([  # jitter, gray, blur, solarize per sample
        [1, 0, 1, 0], [0, 0, 1, 1], [1, 1, 0, 0], [0, 1, 0, 1],
        [1, 0, 1, 1], [0, 0, 0, 0], [1, 0, 0, 0], [1, 1, 1, 1],
    ], dtype=torch.float32, device="cuda")[:B]
    rows[:, [ha.P_JIT, ha.P_GRAY, ha.P_BLUR, ha.P_SOL]] = flags
    return rows


def phase_photometric(torch):
    from dinomc_tpu_torch.ops.hopper import augment as ha

    worst, timing = 0.0, None
    for S in (224, 84):
        B = 8
        gen = torch.Generator(device="cuda").manual_seed(S)
        imgs = torch.rand(B, 3, S, S, generator=gen, device="cuda")
        rows = _branch_rows(torch, B, S)
        for mean, std in ((ha.IMAGENET_MEAN, ha.IMAGENET_STD), ((0.0,) * 3, (1.0,) * 3)):
            out = ha.photometric_kernel(imgs, rows, mean, std)
            torch.cuda.synchronize()
            ref = ha.photometric_reference(imgs, rows, mean, std)
            err = (out - ref).abs().max().item()
            print(f"[photometric] S={S} B={B} mean={mean}: max|diff| {err:.3e}")
            if not err <= PHOTO_ATOL:
                raise AssertionError(f"photometric kernel disagrees with its plain version at S={S}")
            worst = max(worst, err)
        if S == 224:
            # ~30 f32 operations a pixel, ~110 with the blur (csrc/photometric.cu)
            blurred = int(rows[:, ha.P_BLUR].sum().item())
            flops = S * S * (110 * blurred + 30 * (B - blurred))
            timing = {
                "ms": _time_ms(torch, lambda: ha.photometric_kernel(imgs, rows)),
                "plain_ms": _time_ms(torch, lambda: ha.photometric_reference(imgs, rows)),
                "bound": _bound(2 * imgs.numel() * 4 + rows.numel() * 4, flops, F32_FLOPS),
            }
            print(f"[photometric] S=224 B=8 times: kernel {timing['ms']:.4f} ms  "
                  f"plain {timing['plain_ms']:.4f} ms")
    return worst, timing


def _train_run(torch, smi, train_args, tag):
    """One 5-step ``train_dino`` run: checks the losses, that the student
    trained and the teacher followed by EMA, and prints the step times.
    Returns (launches over the run, args, config)."""
    from dinomc_tpu_torch.cli.train_dino import build_config, get_args_parser, train_dino
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.dino_trainer import init_dino_train_state

    with tempfile.TemporaryDirectory() as out_dir:
        args = get_args_parser().parse_args(train_args + ["--output_dir", out_dir])
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        summary = train_dino(args)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    print(f"[{tag}] losses {summary.losses}")
    print(f"[{tag}] launches over the run: {launches}")
    if len(summary.losses) != 5 or not all(math.isfinite(x) for x in summary.losses):
        raise AssertionError(f"expected 5 finite losses, got {summary.losses}")

    mc_cfg, cfg = build_config(args, 1)
    init = init_dino_train_state(cfg, args.seed, "cuda")
    st = summary.state
    moved = max((a - b).abs().max().item() for a, b in
                zip(st.student.parameters(), init.student.parameters()))
    ema = max((a - b).abs().max().item() for a, b in
              zip(st.teacher.parameters(), init.teacher.parameters()))
    gap = max((a - b).abs().max().item() for a, b in
              zip(st.teacher.parameters(), st.student.parameters()))
    print(f"[{tag}] student max|change| {moved:.3e}  teacher max|change| {ema:.3e}  "
          f"teacher-student max|gap| {gap:.3e}")
    if not (moved > 0 and ema > 0 and gap > 0):
        raise AssertionError("student did not train or teacher did not follow by EMA")
    med = sorted(summary.step_ms)[len(summary.step_ms) // 2]
    print(f"[{tag}] step ms (CUDA events, augmentation + step): "
          f"{[round(x, 3) for x in summary.step_ms]}")
    print(f"[{tag}] median step {med:.3f} ms, {8 / (med / 1e3):.3f} images/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"wall {wall:.1f} s  [{smi}]")
    return launches, mc_cfg, cfg


def phase_train(torch, smi):
    launches, _, _ = _train_run(torch, smi, TRAIN_ARGS, "train")
    for name in ("attention_fwd", "attention_bwd", "photometric"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    return launches


def phase_long_attention(torch):
    from dinomc_tpu_torch.ops.hopper import attention_long as hl

    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "rel": 0.0}
    timing = None
    for i, (what, B, N, h, d) in enumerate(LONG_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        qkv = torch.randn(B, N, 3, h, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(B, N, h, d, generator=gen, device="cuda").bfloat16()
        scale = 1.0 / math.sqrt(d)
        q, k, v = qkv.unbind(2)
        o, lse = hl.long_attention_fwd(q, k, v, scale)
        dq, dk, dv = hl.long_attention_bwd(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
        ref = hl.long_mha_reference(qr, kr, vr, scale)
        g_r = torch.autograd.grad(ref, (qr, kr, vr), do, retain_graph=True)
        torch.cuda.synchronize()

        fwd_err = (o.float() - ref.float()).abs().max().item()
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip((dq, dk, dv), g_r)]
        rel = max(e / b.float().abs().max().item() for e, b in zip(errs, g_r))
        print(f"[long attention] {what}: B={B} N={N} h={h} d={d}  fwd max|diff| "
              f"{fwd_err:.3e}  dq/dk/dv max abs {errs}  max rel {rel:.3e}")
        if not (fwd_err <= ATTN_FWD_ATOL and rel <= ATTN_GRAD_RTOL):
            raise AssertionError(f"long attention kernels disagree with their plain version at {what}")
        worst = {"fwd": max(worst["fwd"], fwd_err), "dq": max(worst["dq"], errs[0]),
                 "dkv": max(worst["dkv"], errs[1], errs[2]), "rel": max(worst["rel"], rel)}

        if i == 0:  # the main path's shape: each kernel against its plain version
            dob = do.contiguous()
            _, delta = hl.long_attention_dq(q, k, v, o, lse, dob, scale)
            timing = {
                "fwd_ms": _time_ms(torch, lambda: hl.long_attention_fwd(q, k, v, scale)),
                "fwd_plain_ms": _time_ms(torch, lambda: hl.long_mha_reference(q, k, v, scale)),
                "dq_ms": _time_ms(torch, lambda: hl.long_attention_dq(q, k, v, o, lse, dob, scale)),
                "dq_plain_ms": _time_ms(torch, lambda: torch.autograd.grad(
                    ref, qr, do, retain_graph=True)),
                "dkv_ms": _time_ms(torch, lambda: hl.long_attention_dkv(
                    q, k, v, lse, delta, dob, scale)),
                "dkv_plain_ms": _time_ms(torch, lambda: torch.autograd.grad(
                    ref, (kr, vr), do, retain_graph=True)),
            }
            lib = _sdpa_times(torch, *(x.transpose(1, 2).contiguous() for x in (q, k, v, do)))
            timing.update(fwd_library_ms=lib["fwd"], dq_library_ms=lib["dq"],
                          dkv_library_ms=lib["dkv"])
            elems, prod, rows = B * N * h * d * 2, B * h * N * N * d, B * h * N * 4
            timing.update(  # K5 also reads o and writes delta; K6 reads delta
                fwd_bound=_bound(4 * elems + rows, 4 * prod, BF16_FLOPS),
                dq_bound=_bound(6 * elems + 2 * rows, 6 * prod, BF16_FLOPS),
                dkv_bound=_bound(6 * elems + 2 * rows, 8 * prod, BF16_FLOPS))
            print(f"[long attention] {what} times: {_fmt(timing)}")
        del ref, g_r, qr, kr, vr
    print(f"[long attention] worst: fwd max|diff| {worst['fwd']:.3e} (bound {ATTN_FWD_ATOL}), "
          f"grad max rel {worst['rel']:.3e} (bound {ATTN_GRAD_RTOL})")
    return worst, timing


def _seg_run(torch, train_backbone: bool, smi):
    """One ``train_seg`` run; returns (summary, launches over the run)."""
    from dinomc_tpu_torch.cli.train_seg import get_args_parser, train_seg
    from dinomc_tpu_torch.ops.hopper import _build

    flag = "true" if train_backbone else "false"
    with tempfile.TemporaryDirectory() as out_dir:
        args = get_args_parser().parse_args(
            SEG_ARGS + ["--train_backbone", flag, "--output_dir", out_dir])
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        summary = train_seg(args)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    med = sorted(summary.step_ms)[len(summary.step_ms) // 2]
    print(f"[seg train_backbone={flag}] losses {summary.losses}")
    print(f"[seg train_backbone={flag}] launches over the run: {launches}")
    print(f"[seg train_backbone={flag}] step ms (CUDA events, augmentation + step): "
          f"{[round(x, 3) for x in summary.step_ms]}")
    print(f"[seg train_backbone={flag}] median step {med:.3f} ms, {4 / (med / 1e3):.3f} "
          f"images/s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"val mIoU {summary.best_miou:.4f}, wall {wall:.1f} s  [{smi}]")
    return summary, launches


def phase_seg(torch, smi):
    from dinomc_tpu_torch.cli.train_seg import get_args_parser
    from dinomc_tpu_torch.data.seg_datasets import SPECS
    from dinomc_tpu_torch.models.upernet import UPerNetConfig
    from dinomc_tpu_torch.train.seg_trainer import SegConfig, init_seg_train_state

    total = {}
    for train_backbone in (False, True):
        summary, launches = _seg_run(torch, train_backbone, smi)
        if len(summary.losses) != SEG_STEPS or not all(math.isfinite(x) for x in summary.losses):
            raise AssertionError(f"expected {SEG_STEPS} finite losses, got {summary.losses}")
        if not 0.0 <= summary.scores["miou"] <= 1.0:
            raise AssertionError(f"validation mIoU {summary.scores['miou']} outside [0, 1]")
        bwd = ("long_attention_dq", "long_attention_dkv")
        if launches.get("long_attention_fwd", 0) <= 0:
            raise AssertionError("kernel long_attention_fwd was not launched by the seg path")
        for name in bwd:
            if (launches.get(name, 0) > 0) != train_backbone:
                raise AssertionError(f"kernel {name} launched {launches.get(name, 0)} times with "
                                     f"train_backbone={train_backbone}")
        args = get_args_parser().parse_args(SEG_ARGS)
        cfg = SegConfig(model=UPerNetConfig(num_classes=SPECS[args.dataset].num_classes))
        init = dict(init_seg_train_state(cfg, args.seed, "cuda").model.named_parameters())
        final = dict(summary.state.model.named_parameters())
        bb = [n for n in final if n.startswith("backbone.")]
        dec = [n for n in final if not n.startswith("backbone.")]
        bb_moved = max((final[n] - init[n]).abs().max().item() for n in bb)
        dec_moved = max((final[n] - init[n]).abs().max().item() for n in dec)
        print(f"[seg train_backbone={train_backbone}] backbone max|change| {bb_moved:.3e}  "
              f"decoder max|change| {dec_moved:.3e}")
        if not dec_moved > 0:
            raise AssertionError("the decoder did not train")
        if train_backbone != (bb_moved > 0):
            raise AssertionError(f"backbone max|change| {bb_moved} with train_backbone={train_backbone}")
        if not train_backbone and not all(torch.equal(final[n], init[n]) for n in bb):
            raise AssertionError("the frozen backbone is not bit-identical")
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c
    return total


def phase_window_attention(torch):
    from dinomc_tpu_torch.models.swin import _attn_mask
    from dinomc_tpu_torch.ops.hopper import window_attention as wa

    worst = {"fwd": 0.0, "grad": 0.0, "rel": 0.0}
    timings = []
    for i, (what, nB, heads, side, shift) in enumerate(SWIN_SHAPES):
        C = heads * 32
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        qkv = torch.randn(nB, 49, 3 * C, generator=gen, device="cuda").bfloat16()
        bias = 0.1 * torch.randn(heads, 49, 49, generator=gen, device="cuda")
        do = torch.randn(nB, 49, C, generator=gen, device="cuda").bfloat16()
        mask = _attn_mask(side, side, 7, shift, torch.device("cuda"))
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        o = wa.window_attention_fwd(q, k, v, bias, mask, heads)
        grads = wa.window_attention_bwd(q, k, v, bias, mask, do, heads)
        torch.cuda.synchronize()
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
        ref = wa.window_attention_reference(*xs, mask, heads)
        g_ref = torch.autograd.grad(ref, xs, do, retain_graph=True)
        torch.cuda.synchronize()

        fwd_err = (o.float() - ref.float()).abs().max().item()
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, g_ref)]
        rel = max(e / b.float().abs().max().item() for e, b in zip(errs, g_ref))
        print(f"[window attention] {what}: windows={nB} heads={heads} map={side} shift={shift} "
              f"mask={None if mask is None else tuple(mask.shape)}  fwd max|diff| {fwd_err:.3e}  "
              f"dq/dk/dv/dbias max abs {errs}  max rel {rel:.3e}")
        if not (fwd_err <= ATTN_FWD_ATOL and rel <= ATTN_GRAD_RTOL):
            raise AssertionError(f"window attention kernels disagree with their plain version at {what}")
        worst = {"fwd": max(worst["fwd"], fwd_err), "grad": max(worst["grad"], *errs),
                 "rel": max(worst["rel"], rel)}

        if i < 4:  # the 224 px stages: kernel, plain version and library
            # the library: SDPA with the float mask bias[h] + mask[w mod nW]
            heads_first = [x.reshape(nB, 49, heads, 32).transpose(1, 2).contiguous()
                           for x in (q, k, v, do)]
            am = bias[None].expand(nB, heads, 49, 49)
            if mask is not None:
                nW = mask.shape[0]
                am = (am.reshape(nB // nW, nW, heads, 49, 49) + mask[:, None]).reshape(am.shape)
            am = am.to(torch.bfloat16).contiguous().requires_grad_()
            t = {}
            for tag, timer in (("", _time_ms), ("host_", _host_ms)):
                lib = _sdpa_times(torch, *heads_first, attn_mask=am, timer=timer)
                t.update({
                    f"{tag}fwd_ms": timer(torch, lambda: wa.window_attention_fwd(
                        q, k, v, bias, mask, heads)),
                    f"{tag}fwd_plain_ms": timer(torch, lambda: wa.window_attention_reference(
                        q, k, v, bias, mask, heads)),
                    f"{tag}fwd_library_ms": lib["fwd"],
                    f"{tag}bwd_ms": timer(torch, lambda: wa.window_attention_bwd(
                        q, k, v, bias, mask, do, heads)),
                    f"{tag}bwd_plain_ms": timer(torch, lambda: torch.autograd.grad(
                        ref, xs, do, retain_graph=True)),
                    f"{tag}bwd_library_ms": lib["bwd"],
                })
            elems, wbytes = nB * 49 * C * 2, heads * 49 * 49 * 4
            mbytes = 0 if mask is None else mask.numel() * 4
            prod = nB * heads * 49 * 49 * 32
            t["fwd_bound"] = _bound(4 * elems + wbytes + mbytes, 4 * prod, BF16_FLOPS)
            t["bwd_bound"] = _bound(7 * elems + 2 * wbytes + mbytes, 10 * prod, BF16_FLOPS)
            print(f"[window attention] {what} times: {_fmt(t)}")
            timings.append(t)
        del xs, ref, g_ref
    print(f"[window attention] worst: fwd max|diff| {worst['fwd']:.3e} (bound {ATTN_FWD_ATOL}), "
          f"grad max rel {worst['rel']:.3e} (bound {ATTN_GRAD_RTOL})")
    return worst, timings


def phase_swin_train(torch, smi):
    """Swin-T pretraining: K3, K7 and K8 launched exactly as the
    configuration implies (one backbone call per crop size, teacher over the
    globals, student over every crop; Swin does not pack crops), and no
    attention kernel of the ViT."""
    launches, mc_cfg, cfg = _train_run(torch, smi, SWIN_TRAIN_ARGS, "swin train")
    steps = 5
    blocks = cfg.encoder(True).swin_config().num_blocks
    buckets = len(set(mc_cfg.local_sizes))
    want = {
        "photometric": steps * (2 + len(mc_cfg.local_sizes)),
        "window_attention_fwd": steps * blocks * (2 + buckets),
        "window_attention_bwd": steps * blocks * (1 + buckets),
    }
    print(f"[swin train] launches implied by the configuration: {want}")
    if launches != want:
        raise AssertionError(f"Swin kernel launches {launches}, the configuration implies {want}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = phase_card(torch)
    fwd_err, grad_err, attn_t = phase_attention(torch)
    photo_err, photo_t = phase_photometric(torch)
    launches = phase_train(torch, smi)
    long_err, long_t = phase_long_attention(torch)
    seg_launches = phase_seg(torch, smi)
    win_err, win_t = phase_window_attention(torch)
    swin_launches = phase_swin_train(torch, smi)

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dinomc_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad[:5]}")
    src = "dinomc_tpu_torch/csrc/"

    def entry(name, source, replaces, n, err, ms, plain_ms, bound, library_ms):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}

    kernels = [
        entry("attention_fwd", "attention.cu", "dinomc_tpu/ops/pallas/attention.py:162",
              launches.get("attention_fwd", 0), fwd_err, attn_t["fwd_ms"], attn_t["fwd_plain_ms"],
              attn_t["fwd_bound"], attn_t["fwd_library_ms"]),
        entry("attention_bwd", "attention.cu", "dinomc_tpu/ops/pallas/attention.py:188",
              launches.get("attention_bwd", 0), grad_err, attn_t["bwd_ms"], attn_t["bwd_plain_ms"],
              attn_t["bwd_bound"], attn_t["bwd_library_ms"]),
        entry("photometric", "photometric.cu", "dinomc_tpu/ops/pallas/augment.py:194",
              launches.get("photometric", 0), photo_err, photo_t["ms"], photo_t["plain_ms"],
              photo_t["bound"], None),
    ]
    for name, line, key in (("long_attention_fwd", 150, "fwd"), ("long_attention_dq", 174, "dq"),
                            ("long_attention_dkv", 187, "dkv")):
        kernels.append(entry(
            name, "attention_long.cu", f"dinomc_tpu/ops/pallas/attention_long.py:{line}",
            seg_launches.get(name, 0), long_err[key], long_t[f"{key}_ms"],
            long_t[f"{key}_plain_ms"], long_t[f"{key}_bound"], long_t[f"{key}_library_ms"]))
    stage1 = win_t[0]  # the timed shape: stage 1 of the 224 px globals
    for name, line, key, err in (("window_attention_fwd", 281, "fwd", win_err["fwd"]),
                                 ("window_attention_bwd", 319, "bwd", win_err["grad"])):
        kernels.append(entry(
            name, "window_attention.cu", f"dinomc_tpu/ops/pallas/window_attention.py:{line}",
            swin_launches.get(name, 0), err, stage1[f"{key}_ms"], stage1[f"{key}_plain_ms"],
            stage1[f"{key}_bound"], stage1[f"{key}_library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
