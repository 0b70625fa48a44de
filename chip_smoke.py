#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``dinomc_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing its results on lines of its own; any failure raises and the
script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (``nvcc`` from ``dinomc_tpu_torch/csrc``, timed);
2. attention K1 (forward) and K2 (backward) against their plain version
   on the card, in bf16, at the main path's shapes and a few small ones;
   K2's gradients bit-identical on a repeated call; K1 and K2 timed with
   and without the host's cost, K2 also as its two launches (dQ, dK/dV)
   beside SDPA's dq and dk/dv;
3. photometric K3 against its plain version at 224 and 84 px, with rows
   that cover every branch, the flip applied and not; bit-identical on a
   repeat; timed with the flip, as the DINO step calls it, at every crop
   size of the step (224 and 184 ... 84 px), with and without the host's
   cost;
4. the real entry point, ``dinomc_tpu_torch.cli.train_dino.train_dino``,
   for 5 ViT-S/8 steps (out_dim 65536, batch 8, synthetic images, weights
   from a seed), with every kernel's launch count over that run;
5. long-sequence attention K4 (forward), K5 (dQ) and K6 (dK/dV) against
   their plain version on the card, in bf16, at the segmentation path's
   shapes (4097 tokens at 512 px, patch 8), past the TPU kernel's 5120 cap,
   and a few ragged small ones; K5's dQ and delta and K6's dK/dV
   bit-identical on a repeated call; K4 and K5 timed with and without the
   host's cost;
6. the segmentation entry point, ``dinomc_tpu_torch.cli.train_seg.train_seg``,
   twice at the published widths (ViT-S/8 UPerNet, 512 px, batch 4, 8 UAVid
   classes, synthetic data, weights from a seed): decoder-only and with the
   backbone trained, 4 steps and a validation pass each, with the kernels'
   launch counts over each run;
7. Swin window attention K7 (forward) and K8 (backward, dbias included)
   against their plain version on the card, in bf16, at the four stage
   shapes of Swin-T at 224 px (16 images), the 184 px stage-1 shape (shift +
   pad masks), the 84 px stage-4 shape (a pad-only mask) and a ragged small
   one; K7's output and K8's gradients bit-identical on a repeated call;
   every 224 px stage timed as kernel, plain version and
   ``F.scaled_dot_product_attention`` with the float mask bias + mask, on
   the device and, apart, with the host's launch cost in;
8. the pretraining entry point again, for 5 Swin-T steps (``--arch swin_t``,
   out_dim 65536, batch 8), with K3, K7 and K8 launched exactly as often as
   the configuration implies and no other kernel launched;
9. the fused MLP K11 against its plain version on the card, in bf16, at the
   DINO step's row counts at ViT-S, at ViT-B and ViT-Ti widths and a ragged
   small M, both GELU forms, its gradients (a plain backward) equal to the
   plain route's bit for bit; timed at every ViT-S row count beside the
   dense ``F.linear``, ``F.gelu``, ``F.linear`` chain and with the host's
   cost, and at the 224 px globals beside the plain version;
10. the head-stacked window attention K9 (forward) and K10 (backward) against
   their plain version at phase 7's shapes, K10's gradients bit-identical on
   a repeated call; each 224 px stage timed beside
   K7/K8 (phase 7's plain, SDPA and bound columns apply); then its main path,
   ``window_attention(..., variant='stacked')`` through autograd over the 12
   Swin-T blocks' shapes at 224 px (16 images), as the JAX package's callers
   reach it: by a direct call (no model names the variant);
11. the ViT-S/8 DINO step with ``mlp_impl='fused'`` (out_dim 65536, batch 8,
   weights from a seed): 5 steps of the trainer's step function with K11 on
   teacher and student, against the same 5 steps with the dense MLP from the
   same weights, images and draws; then the step under no remat and the
   ``full``, ``attn`` and ``qkv+attn+mlp`` policies, both MLP forms: step
   time, peak memory and K1/K2/K11 launches a step against what the policy
   implies.

Then one JSON line with each kernel's launches, error, times, bound and
library time, and as the last line ``{"ok": true, "device": {...}}``. With
no CUDA device it exits with 1 and prints no result.

Every time in that line is device time: CUDA events around 10 calls
(after 2 warm-up calls) queued behind a spin kernel (``torch.cuda._sleep``)
that holds the card until the host has issued them all, so the card runs
them back to back and the host's cost of issuing them is not in it; the
script checks that the card was still spinning when the last call was
queued, and fails if it never was. A ``host_`` time is CUDA
events around 10 calls issued back to back with no spin kernel, so it also
holds the host's cost of issuing them where that exceeds the device's
(phases 2, 3, 5, 7 and 9; K1, K2, K4, K5, K6, K7, K8, K10 and K11 encode
their TMA tensor maps on the host at every call).

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
# fused MLP, max|diff| / max|ref|: both sides accumulate in f32 and round the
# GELU'd hidden and the output to bf16 once each; a different f32 summation
# order can flip one rounding, one bf16 ulp (2^-8 = 3.9e-3 relative) of the
# output, and 1e-2 leaves room for that and no more.
MLP_RTOL = 1e-2
# The DINO loss with the fused MLP against the dense one, per step, relative:
# the two round the (M, F) hidden activation at different places (dense:
# x W1^T + b1 to bf16 before GELU; fused: after GELU), about 2^-9 relative an
# element in 12 layers; the features move by ~1e-3 relative and the loss
# (about ln 65536 = 11.1 at the start) by less. 5e-3 is about one bf16 ulp
# of the loss.
LOSS_RTOL = 5e-3

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
# the DINO step's crop sizes at B = 8: K3 is checked at the first and the
# last, timed at all
PHOTO_SIZES = (224, 184, 164, 144, 124, 104, 84)
SWIN_SHAPES = [  # (what, windows, heads, map side, shift); the first four are timed
    ("stage 1, 224 px", 1024, 3, 56, 3),
    ("stage 2, 224 px", 256, 6, 28, 3),
    ("stage 3, 224 px", 64, 12, 14, 3),
    ("stage 4, 224 px", 16, 24, 7, 0),
    ("stage 1, 184 px", 8 * 49, 3, 46, 3),
    ("stage 4, 84 px", 8, 24, 3, 0),
    ("ragged small", 8, 2, 10, 3),
]
MLP_SHAPES = [  # (what, M, D, F); the first is timed
    ("ViT-S/8 globals, 2 x 8 at 224 px", 12560, 384, 1536),
    ("packed 184+84 px", 5048, 384, 1536),
    ("packed 164+124 px", 5016, 384, 1536),
    ("packed 144+104 px", 3960, 384, 1536),
    ("84 px alone", 808, 384, 1536),
    ("ViT-B/8 globals", 12560, 768, 3072),
    ("ragged small, ViT-Ti width", 70, 192, 768),
]
# Swin-T's 12 blocks at 224 px over 16 images: (windows, heads, map side,
# shift); the odd block of each stage is shifted (stage 4's 7 x 7 map is one
# window and never shifts)
SWIN_BLOCKS = ([(1024, 3, 56, 0), (1024, 3, 56, 3), (256, 6, 28, 0), (256, 6, 28, 3)]
               + [(64, 12, 14, 0), (64, 12, 14, 3)] * 3 + [(16, 24, 7, 0)] * 2)
REMAT_RUNS = [None, "full", "attn", "qkv+attn+mlp"]  # None: ViTConfig.remat=False
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
        attention_bwd, attention_bwd_dkv, attention_bwd_dq, attention_fwd, fused_mha,
        fused_mha_reference,
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
        # K2 is deterministic (no atomics): a second call on the same inputs
        # gives the same bits
        q, k, v = qkv.unbind(2)
        o, lse = attention_fwd(q, k, v, scale, boundary)
        first, again = (attention_bwd(q, k, v, o, lse, do, scale, boundary) for _ in range(2))
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        print(f"[attention] {what}: B={B} N={N} h={h} d={d} boundary={boundary}  "
              f"fwd max|diff| {fwd_err:.3e}  dq/dk/dv max abs {grad_err.tolist()}  "
              f"max rel {grad_rel:.3e}  backward bit-identical on a repeat: {same}")
        if not (fwd_err <= ATTN_FWD_ATOL and grad_rel <= ATTN_GRAD_RTOL and same):
            raise AssertionError(f"attention kernel disagrees with its plain version at {what}")
        worst_fwd = max(worst_fwd, fwd_err)
        worst_grad = max(worst_grad, grad_err.max().item())
        worst_grad_rel = max(worst_grad_rel, grad_rel)

        if i < 5:  # main-path shapes: time kernel against plain
            _, delta = attention_bwd_dq(q, k, v, o, lse, do, scale, boundary)
            t = {
                "fwd_ms": _time_ms(torch, lambda: attention_fwd(q, k, v, scale, boundary)),
                "fwd_plain_ms": _time_ms(torch, lambda: fused_mha_reference(q, k, v, scale, boundary)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_fwd_ms": _host_ms(torch, lambda: attention_fwd(q, k, v, scale, boundary)),
                "bwd_ms": _time_ms(torch, lambda: attention_bwd(q, k, v, o, lse, do, scale, boundary)),
                # K2's two launches apart: dQ (and delta), then dK/dV
                "dq_ms": _time_ms(torch, lambda: attention_bwd_dq(
                    q, k, v, o, lse, do, scale, boundary)),
                "dkv_ms": _time_ms(torch, lambda: attention_bwd_dkv(
                    q, k, v, lse, delta, do, scale, boundary)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_bwd_ms": _host_ms(torch, lambda: attention_bwd(
                    q, k, v, o, lse, do, scale, boundary)),
                "bwd_plain_ms": _time_ms(torch, lambda: torch.autograd.grad(
                    ref, qkv_r, do, retain_graph=True)),
            }
            if timing is None:  # the first shape: the library's time and the bound too
                lib = _sdpa_times(torch, *(x.transpose(1, 2).contiguous() for x in (q, k, v, do)))
                t.update(fwd_library_ms=lib["fwd"], bwd_library_ms=lib["bwd"],
                         dq_library_ms=lib["dq"], dkv_library_ms=lib["dkv"])
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
    flags = torch.tensor([  # jitter, gray, blur, solarize, flip per sample
        [1, 0, 1, 0, 1], [0, 0, 1, 1, 0], [1, 1, 0, 0, 1], [0, 1, 0, 1, 0],
        [1, 0, 1, 1, 0], [0, 0, 0, 0, 1], [1, 0, 0, 0, 0], [1, 1, 1, 1, 1],
    ], dtype=torch.float32, device="cuda")[:B]
    rows[:, [ha.P_JIT, ha.P_GRAY, ha.P_BLUR, ha.P_SOL, ha.P_FLIP]] = flags
    return rows


def phase_photometric(torch):
    from dinomc_tpu_torch.ops.hopper import augment as ha

    worst, timing = 0.0, None
    for S in PHOTO_SIZES:
        B = 8
        gen = torch.Generator(device="cuda").manual_seed(S)
        imgs = torch.rand(B, 3, S, S, generator=gen, device="cuda")
        rows = _branch_rows(torch, B, S)
        if S in (PHOTO_SIZES[0], PHOTO_SIZES[-1]):
            for flip in (False, True):
                for mean, std in ((ha.IMAGENET_MEAN, ha.IMAGENET_STD), ((0.0,) * 3, (1.0,) * 3)):
                    out = ha.photometric_kernel(imgs, rows, mean, std, flip)
                    again = ha.photometric_kernel(imgs, rows, mean, std, flip)
                    torch.cuda.synchronize()
                    ref = ha.photometric_reference(imgs, rows, mean, std, flip)
                    err = (out - ref).abs().max().item()
                    same = torch.equal(out, again)
                    print(f"[photometric] S={S} B={B} flip={flip} mean={mean}: max|diff| "
                          f"{err:.3e}  bit-identical on a repeat: {same}")
                    if not (err <= PHOTO_ATOL and same):
                        raise AssertionError(f"photometric kernel disagrees with its plain "
                                             f"version at S={S} flip={flip}")
                    worst = max(worst, err)
        # as the DINO step calls it, the flip inside; ~30 f32 operations a
        # pixel, ~110 with the blur (csrc/photometric.cu)
        blurred = int(rows[:, ha.P_BLUR].sum().item())
        flops = S * S * (110 * blurred + 30 * (B - blurred))
        t = {
            "ms": _time_ms(torch, lambda: ha.photometric_kernel(imgs, rows, flip=True)),
            "plain_ms": _time_ms(torch, lambda: ha.photometric_reference(imgs, rows, flip=True)),
            # with the host's cost of issuing (two launches a call)
            "host_ms": _host_ms(torch, lambda: ha.photometric_kernel(imgs, rows, flip=True)),
            "bound": _bound(2 * imgs.numel() * 4 + rows.numel() * 4, flops, F32_FLOPS),
        }
        print(f"[photometric] S={S} B={B} flip=True times: {_fmt(t)}")
        if timing is None:  # the timed shape: the 224 px globals
            timing = t
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
        # K5 and K6 are deterministic (no atomics): a second call gives the
        # same bits
        dq2, delta = hl.long_attention_dq(q, k, v, o, lse, do, scale)
        _, delta2 = hl.long_attention_dq(q, k, v, o, lse, do, scale)
        same_dq = torch.equal(dq, dq2) and torch.equal(delta, delta2)
        same = same_dq and all(torch.equal(a, b) for a, b in zip(
            (dk, dv), hl.long_attention_dkv(q, k, v, lse, delta, do, scale)))
        print(f"[long attention] {what}: B={B} N={N} h={h} d={d}  fwd max|diff| "
              f"{fwd_err:.3e}  dq/dk/dv max abs {errs}  max rel {rel:.3e}  dQ and delta "
              f"bit-identical on a repeat: {same_dq}, dK/dV too: {same}")
        if not (fwd_err <= ATTN_FWD_ATOL and rel <= ATTN_GRAD_RTOL and same):
            raise AssertionError(f"long attention kernels disagree with their plain version at {what}")
        worst = {"fwd": max(worst["fwd"], fwd_err), "dq": max(worst["dq"], errs[0]),
                 "dkv": max(worst["dkv"], errs[1], errs[2]), "rel": max(worst["rel"], rel)}

        if i == 0:  # the main path's shape: each kernel against its plain version
            dob = do.contiguous()
            timing = {
                "fwd_ms": _time_ms(torch, lambda: hl.long_attention_fwd(q, k, v, scale)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_fwd_ms": _host_ms(torch, lambda: hl.long_attention_fwd(q, k, v, scale)),
                "fwd_plain_ms": _time_ms(torch, lambda: hl.long_mha_reference(q, k, v, scale)),
                "dq_ms": _time_ms(torch, lambda: hl.long_attention_dq(q, k, v, o, lse, dob, scale)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_dq_ms": _host_ms(torch, lambda: hl.long_attention_dq(
                    q, k, v, o, lse, dob, scale)),
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
        # K7 and K8 are deterministic (no atomics): a second call gives the
        # same bits
        same_fwd = torch.equal(o, wa.window_attention_fwd(q, k, v, bias, mask, heads))
        same = same_fwd and all(torch.equal(a, b) for a, b in zip(
            grads, wa.window_attention_bwd(q, k, v, bias, mask, do, heads)))
        print(f"[window attention] {what}: windows={nB} heads={heads} map={side} shift={shift} "
              f"mask={None if mask is None else tuple(mask.shape)}  fwd max|diff| {fwd_err:.3e}  "
              f"dq/dk/dv/dbias max abs {errs}  max rel {rel:.3e}  forward bit-identical on a "
              f"repeat: {same_fwd}, backward too: {same}")
        if not (fwd_err <= ATTN_FWD_ATOL and rel <= ATTN_GRAD_RTOL and same):
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


def _mlp_inputs(torch, M, D, Fd, seed):
    """x (M, D), W1 (F, D), b1, W2 (D, F), b2 and dO in bf16 on the card;
    weights scaled by 1/sqrt(fan-in) so activations stay O(1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, D, generator=gen, device="cuda").bfloat16()
    w1 = (torch.randn(Fd, D, generator=gen, device="cuda") / math.sqrt(D)).bfloat16()
    w2 = (torch.randn(D, Fd, generator=gen, device="cuda") / math.sqrt(Fd)).bfloat16()
    b1, b2 = ((0.1 * torch.randn(n, generator=gen, device="cuda")).bfloat16() for n in (Fd, D))
    do = torch.randn(M, D, generator=gen, device="cuda").bfloat16()
    return (x, w1, b1, w2, b2), do


def phase_fused_mlp(torch):
    from dinomc_tpu_torch.ops.hopper import fused_mlp as fm

    F = torch.nn.functional
    worst_abs, worst_rel, timing = 0.0, 0.0, None
    for i, (what, M, D, Fd) in enumerate(MLP_SHAPES):
        args, do = _mlp_inputs(torch, M, D, Fd, 400 + i)
        for approx in (True, False):
            outs, grads = [], []
            for forward in (fm.fused_mlp_fwd, fm.fused_mlp_reference):
                xs = [a.clone().requires_grad_() for a in args]
                out = fm.FusedMLP.apply(*xs, approx, forward)
                outs.append(out.float())
                grads.append(torch.autograd.grad(out, xs, do))
            torch.cuda.synchronize()
            err = (outs[0] - outs[1]).abs().max().item()
            rel = err / outs[1].abs().max().item()
            same = all(torch.equal(a, b) for a, b in zip(*grads))
            print(f"[fused mlp] {what}: M={M} D={D} F={Fd} gelu={'tanh' if approx else 'erf'}  "
                  f"fwd max|diff| {err:.3e}  rel {rel:.3e}  gradients equal to the plain "
                  f"route's: {same}")
            if not (rel <= MLP_RTOL and same):
                raise AssertionError(f"fused MLP kernel disagrees with its plain version at {what}")
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if D == 384:  # the ViT-S rows: kernel beside the dense chain, the bound
            x, w1, b1, w2, b2 = args
            t = {
                "ms": _time_ms(torch, lambda: fm.fused_mlp_fwd(x, w1, b1, w2, b2, True)),
                # three PyTorch calls (cuBLAS, an elementwise GELU, cuBLAS): no one
                # PyTorch call computes this function
                "library_ms": _time_ms(torch, lambda: F.linear(
                    F.gelu(F.linear(x, w1, b1), approximate="tanh"), w2, b2)),
                # with the host's cost of issuing (tensor maps encoded per call)
                "host_ms": _host_ms(torch, lambda: fm.fused_mlp_fwd(x, w1, b1, w2, b2, True)),
                "bound": _bound(2 * (2 * M * D + 2 * D * Fd + Fd + D), 4 * M * D * Fd, BF16_FLOPS),
            }
            if i == 0:  # the 224 px globals: the plain version too
                t["plain_ms"] = _time_ms(torch, lambda: fm.fused_mlp_reference(
                    x, w1, b1, w2, b2, True))
                timing = t
            print(f"[fused mlp] {what} times: {_fmt(t)}")
    print(f"[fused mlp] worst: fwd max|diff| {worst_abs:.3e}, rel {worst_rel:.3e} (bound {MLP_RTOL})")
    return worst_abs, timing


def _window_inputs(torch, nB, heads, side, shift, seed):
    from dinomc_tpu_torch.models.swin import _attn_mask

    C = heads * 32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(nB, 49, 3 * C, generator=gen, device="cuda").bfloat16()
    bias = 0.1 * torch.randn(heads, 49, 49, generator=gen, device="cuda")
    do = torch.randn(nB, 49, C, generator=gen, device="cuda").bfloat16()
    mask = _attn_mask(side, side, 7, shift, torch.device("cuda"))
    return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], bias, mask, do


def phase_window_attention_stacked(torch, win_t):
    """K9/K10 against the plain version at phase 7's shapes (the same
    inputs), both bit-identical on a repeat and K9 also between qkv column
    slices and tensors of their own; each 224 px stage timed beside K7/K8
    (device time, and K9/K7 with the host's cost); then the main path."""
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.ops.hopper import window_attention as wa

    worst = {"fwd": 0.0, "grad": 0.0, "rel": 0.0}
    timings = []
    for i, (what, nB, heads, side, shift) in enumerate(SWIN_SHAPES):
        q, k, v, bias, mask, do = _window_inputs(torch, nB, heads, side, shift, 300 + i)
        o = wa.window_attention_stacked_fwd(q, k, v, bias, mask, heads)
        grads = wa.window_attention_stacked_bwd(q, k, v, bias, mask, do, heads)
        torch.cuda.synchronize()
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
        ref = wa.window_attention_reference(*xs, mask, heads)
        g_ref = torch.autograd.grad(ref, xs, do)
        torch.cuda.synchronize()
        fwd_err = (o.float() - ref.float()).abs().max().item()
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, g_ref)]
        rel = max(e / b.float().abs().max().item() for e, b in zip(errs, g_ref))
        # K9 and K10 are deterministic (no atomics): a second call gives the
        # same bits, and so do q, k, v as tensors of their own (a map each)
        same_fwd = torch.equal(o, wa.window_attention_stacked_fwd(q, k, v, bias, mask, heads))
        apart_fwd = torch.equal(o, wa.window_attention_stacked_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), bias, mask, heads))
        same = all(torch.equal(a, b) for a, b in zip(
            grads, wa.window_attention_stacked_bwd(q, k, v, bias, mask, do, heads)))
        print(f"[stacked window attention] {what}: windows={nB} heads={heads} "
              f"(a block: {wa.head_chunk(heads, wa.STACKED_HEADS['fwd'])} / "
              f"{wa.head_chunk(heads, wa.STACKED_HEADS['bwd'])} heads)  fwd max|diff| "
              f"{fwd_err:.3e}  dq/dk/dv/dbias max abs {errs}  max rel {rel:.3e}  "
              f"forward bit-identical on a repeat: {same_fwd}, q/k/v apart: {apart_fwd}; "
              f"backward on a repeat: {same}")
        if not (fwd_err <= ATTN_FWD_ATOL and rel <= ATTN_GRAD_RTOL
                and same_fwd and apart_fwd and same):
            raise AssertionError(f"stacked window attention kernels disagree with their plain "
                                 f"version at {what}")
        worst = {"fwd": max(worst["fwd"], fwd_err), "grad": max(worst["grad"], *errs),
                 "rel": max(worst["rel"], rel)}
        if i < 4:  # the 224 px stages: K9/K10 beside K7/K8 in this call
            t = {
                "fwd_ms": _time_ms(torch, lambda: wa.window_attention_stacked_fwd(
                    q, k, v, bias, mask, heads)),
                "perhead_fwd_ms": _time_ms(torch, lambda: wa.window_attention_fwd(
                    q, k, v, bias, mask, heads)),
                "host_fwd_ms": _host_ms(torch, lambda: wa.window_attention_stacked_fwd(
                    q, k, v, bias, mask, heads)),
                "perhead_host_fwd_ms": _host_ms(torch, lambda: wa.window_attention_fwd(
                    q, k, v, bias, mask, heads)),
                "bwd_ms": _time_ms(torch, lambda: wa.window_attention_stacked_bwd(
                    q, k, v, bias, mask, do, heads)),
                "perhead_bwd_ms": _time_ms(torch, lambda: wa.window_attention_bwd(
                    q, k, v, bias, mask, do, heads)),
            }
            t.update({key: win_t[i][key] for key in (
                "fwd_plain_ms", "fwd_library_ms", "fwd_bound",
                "bwd_plain_ms", "bwd_library_ms", "bwd_bound")})
            print(f"[stacked window attention] {what} times: {_fmt(t)}")
            timings.append(t)
        del xs, ref, g_ref
    print(f"[stacked window attention] worst: fwd max|diff| {worst['fwd']:.3e} (bound "
          f"{ATTN_FWD_ATOL}), grad max rel {worst['rel']:.3e} (bound {ATTN_GRAD_RTOL})")

    # The main path: the public entry over Swin-T's 12 block shapes, forward
    # and backward through autograd.
    inputs = [_window_inputs(torch, *blk, 500 + j) for j, blk in enumerate(SWIN_BLOCKS)]
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    for (q, k, v, bias, mask, do), (_, heads, _, _) in zip(inputs, SWIN_BLOCKS):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
        out = wa.window_attention(*xs, mask, heads, variant="stacked")
        torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = {"window_attention_stacked_fwd": len(SWIN_BLOCKS),
            "window_attention_stacked_bwd": len(SWIN_BLOCKS)}
    print(f"[stacked window attention] main path, window_attention(variant='stacked') over "
          f"Swin-T's {len(SWIN_BLOCKS)} blocks at 224 px: launches {launches}")
    if launches != want:
        raise AssertionError(f"stacked window attention launches {launches}, want {want}")
    return worst, timings, launches


def _dino_setup(torch):
    """The ViT-S/8 DINO configuration of phase 4 (out_dim 65536, B = 8) and 5
    steps of its inputs: images and multi-crop draws made on the card from a
    seed, augmented once and shared by every run below."""
    from dinomc_tpu_torch.cli.train_dino import build_config, build_schedules, get_args_parser
    from dinomc_tpu_torch.ops.augment import draw_multicrop, multicrop_augment

    args = get_args_parser().parse_args(TRAIN_ARGS)
    mc_cfg, cfg = build_config(args, 1)
    sch = build_schedules(args, args.batch_size_per_gpu, 1)
    gen = torch.Generator(device="cuda").manual_seed(11)
    B, S = args.batch_size_per_gpu, args.image_size
    batches = []
    for _ in range(5):
        images = torch.rand(B, S, S, 3, generator=gen, device="cuda")
        batches.append(multicrop_augment(images, draw_multicrop(gen, B, S, S, mc_cfg, device="cuda"),
                                         mc_cfg))
    return cfg, sch, batches


def _set_backbones(torch, state, **fields):
    import dataclasses

    for model in (state.student, state.teacher):
        model["backbone"].cfg = dataclasses.replace(model["backbone"].cfg, **fields)


def _step(torch, state, batch, sch, cfg):
    """One ``dino_train_step``; returns (loss, ms between CUDA events around
    it, launches, peak memory GiB)."""
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train.dino_trainer import dino_train_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    metrics = dino_train_step(state, *batch, sch, cfg)
    b.record()
    b.synchronize()
    return (metrics["loss"].item(), a.elapsed_time(b), dict(_build.LAUNCHES),
            torch.cuda.max_memory_allocated() / 2**30)


def phase_fused_mlp_train(torch, smi):
    """5 DINO steps with the fused MLP against 5 with the dense one, from the
    same weights and inputs; then the step under the remat policies. Returns
    the fused run's launches (the main path of K11)."""
    from dinomc_tpu_torch.train.dino_trainer import init_dino_train_state

    cfg, sch, batches = _dino_setup(torch)
    depth = cfg.encoder(True).vit_config().depth
    # one teacher call (the globals), four student calls (the globals and the
    # three packed local pairs 184+84, 164+124, 144+104); the default 'attn'
    # remat keeps K1's output, and torch's recompute replays K11
    teacher_calls, student_calls = 1, 4
    want = {"attention_fwd": depth * (teacher_calls + student_calls),
            "attention_bwd": depth * student_calls,
            "fused_mlp": depth * (teacher_calls + 2 * student_calls)}
    losses, launches = {}, {}
    for impl in ("fused", "dense"):
        state = init_dino_train_state(cfg, 0, "cuda")
        _set_backbones(torch, state, mlp_impl=impl)
        losses[impl], total = [], {}
        for i, batch in enumerate(batches):
            loss, ms, got, peak = _step(torch, state, batch, sch, cfg)
            losses[impl].append(loss)
            for name, c in got.items():
                total[name] = total.get(name, 0) + c
            if impl == "fused" and {n: got.get(n, 0) for n in want} != want:
                raise AssertionError(f"fused-MLP step {i}: launches {got}, the policy implies {want}")
        launches[impl] = total
        print(f"[fused mlp train] mlp_impl={impl}: losses {losses[impl]}  launches over 5 steps "
              f"{total}")
        del state
    print(f"[fused mlp train] launches a step implied by remat_policy='attn': {want}")
    if launches["dense"].get("fused_mlp", 0):
        raise AssertionError("the dense MLP launched K11")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["fused"], losses["dense"])]
    print(f"[fused mlp train] loss |fused - dense| / |dense| per step {[f'{r:.3e}' for r in rel]} "
          f"(bound {LOSS_RTOL})")
    if not (all(math.isfinite(x) for x in losses["fused"]) and max(rel) <= LOSS_RTOL):
        raise AssertionError("the fused-MLP DINO steps disagree with the dense ones")

    # Remat on the card: one state; a warm-up step for each configuration,
    # then 3 rounds that take 2 steps of each in turn, so a drift of the
    # host's speed falls on every configuration alike. Step ms: CUDA events
    # around the step, the host's issuing in it where the card waits on it
    # (the step syncs the host; device busy time is profile_torch_step.py's).
    state = init_dino_train_state(cfg, 0, "cuda")
    runs = [(impl, policy) for impl in ("dense", "fused") for policy in REMAT_RUNS]
    seen = {run: [] for run in runs}
    for r in range(4):
        for impl, policy in runs:
            _set_backbones(torch, state, mlp_impl=impl, remat=policy is not None,
                           remat_policy=policy or "attn")
            for j in range(1 if r == 0 else 2):
                result = _step(torch, state, batches[(r + j) % 5], sch, cfg)
                if r:
                    seen[(impl, policy)].append(result)
    for impl, policy in runs:
        results = seen[(impl, policy)]
        ms = sorted(x[1] for x in results)
        got = results[-1][2]
        reruns_attn = policy == "full"
        expect = {"attention_fwd": depth * (teacher_calls + student_calls * (1 + reruns_attn)),
                  "attention_bwd": depth * student_calls,
                  "fused_mlp": 0 if impl == "dense" else
                  depth * (teacher_calls + student_calls * (1 + (policy is not None)))}
        counts = {n: got.get(n, 0) for n in expect}
        print(f"[remat] mlp_impl={impl} remat={policy or 'off'}: step ms median "
              f"{(ms[2] + ms[3]) / 2:.3f} (of {[round(x, 3) for x in ms]})  peak "
              f"{max(x[3] for x in results):.3f} GiB  launches a step {counts} "
              f"(implied {expect})  [{smi}]")
        if any({n: x[2].get(n, 0) for n in expect} != expect for x in results):
            raise AssertionError(f"remat {policy}: launches {counts}, the policy implies {expect}")
    return launches["fused"]


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
    mlp_err, mlp_t = phase_fused_mlp(torch)
    wins_err, wins_t, wins_launches = phase_window_attention_stacked(torch, win_t)
    mlp_launches = phase_fused_mlp_train(torch, smi)

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
    stacked1 = wins_t[0]
    for name, line, key, err in (("window_attention_stacked_fwd", 558, "fwd", wins_err["fwd"]),
                                 ("window_attention_stacked_bwd", 591, "bwd", wins_err["grad"])):
        kernels.append(entry(
            name, "window_attention_stacked.cu",
            f"dinomc_tpu/ops/pallas/window_attention.py:{line}", wins_launches.get(name, 0), err,
            stacked1[f"{key}_ms"], stacked1[f"{key}_plain_ms"], stacked1[f"{key}_bound"],
            stacked1[f"{key}_library_ms"]))
    kernels.append(entry(
        "fused_mlp", "fused_mlp.cu", "dinomc_tpu/ops/pallas/fused_mlp.py:64",
        mlp_launches.get("fused_mlp", 0), mlp_err, mlp_t["ms"], mlp_t["plain_ms"], mlp_t["bound"],
        mlp_t["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
