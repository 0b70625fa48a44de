"""Port window attention (ops/hopper/window_attention.py) against the JAX
package's.

The plain version is held to JAX ``packed_window_attention`` in Pallas
interpret mode, both variants (``'perhead'``, K7/K8's, and ``'stacked'``,
K9/K10's), and to the einsum core of tests/test_window_attention.py, on that
file's cases (shift masks, the 24-head case, both grouping regimes of the
JAX kernel) and on pad-only (nW, 1, 49) and shift + pad masks, in f32 at
that file's bounds: forward 2e-5, dQ/dK/dV/dbias 2e-4. The CUDA kernels
K7/K8 and K9/K10 are held to the plain version on the card
(``cuda``-marked, skipped without one) in bf16 at chip_smoke.py's bounds.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.models import swin as jsw
from dinomc_tpu.ops.pallas.window_attention import packed_window_attention
from dinomc_tpu_torch.models import swin as tsw
from dinomc_tpu_torch.ops.hopper import _build
from dinomc_tpu_torch.ops.hopper import window_attention as wa
from test_window_attention import CASES, _xla_core
from _torch_port import cuda_device, n, one_torch_thread, t  # noqa: F401

WW = 49
# (nB, C, heads, mask kind, JAX group): pad-only and shift + pad masks of a
# 10 x 10 map padded to 14 x 14 (4 windows)
MASKED = [(8, 192, 6, "pad", 4), (8, 96, 3, "shift+pad", 4)]
ALL = [(nB, C, h, nW, g) for nB, C, h, nW, g in CASES] + MASKED


def _variants(cases):
    """Each case with both variants; a perhead case keeps its plain id."""
    return [pytest.param(*c, v, id="-".join(map(str, c)) + ("-stacked" if v == "stacked" else ""))
            for v in ("perhead", "stacked") for c in cases]


def _mask(kind, nW):
    if kind is None:
        return None
    if kind == "pad":
        return jsw._pad_mask(10, 10, 14, 14, 7)
    if kind == "shift+pad":
        return jsw._shift_mask(14, 14, 7, 3) + jsw._pad_mask(10, 10, 14, 14, 7)
    side = int(round(kind ** 0.5)) * 7
    return jsw._shift_mask(side, side, 7, 3)


def _data(seed, nB, C, heads, kind):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((nB, WW, C)).astype(np.float32) for _ in range(3))
    bias = (0.1 * rng.standard_normal((heads, WW, WW))).astype(np.float32)
    return q, k, v, bias, _mask(kind, nB)


def _n_windows(mask, nB):
    return nB if mask is None else mask.shape[0]


@pytest.mark.parametrize("nB,C,heads,kind,group,variant", _variants(ALL))
def test_reference_matches_jax_kernel_and_einsum(nB, C, heads, kind, group, variant):
    q, k, v, bias, mask = _data(0, nB, C, heads, kind)
    out = wa.window_attention(t(q), t(k), t(v), t(bias), None if mask is None else t(mask), heads,
                              variant)
    ker = packed_window_attention(*map(jnp.asarray, (q, k, v, bias)), mask, heads,
                                  _n_windows(mask, nB), group=group, interpret=True,
                                  variant=variant)
    np.testing.assert_allclose(n(out), np.asarray(ker), rtol=2e-5, atol=2e-5)
    if mask is None or mask.shape[1] == WW:  # the einsum core takes full masks only
        np.testing.assert_allclose(n(out), np.asarray(_xla_core(q, k, v, jnp.asarray(bias), mask)),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nB,C,heads,kind,group,variant", _variants(CASES[:3] + MASKED))
def test_reference_grads_match_jax(nB, C, heads, kind, group, variant):
    q, k, v, bias, mask = _data(1, nB, C, heads, kind)
    nW = _n_windows(mask, nB)

    def loss_ker(*a):
        return (packed_window_attention(*a, mask, heads, nW, group=group, interpret=True,
                                        variant=variant) ** 2).sum()

    g_ker = jax.grad(loss_ker, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    xs = [t(x).requires_grad_() for x in (q, k, v, bias)]
    out = wa.window_attention(*xs, None if mask is None else t(mask), heads, variant)
    g = torch.autograd.grad((out ** 2).sum(), xs)
    for a, b, name in zip(g, g_ker, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=2e-4, atol=2e-4, err_msg=name)


def test_masks_and_index_match_jax():
    """The model's mask and index builders are the JAX package's."""
    np.testing.assert_array_equal(tsw._rel_index(7), jsw._rel_index(7))
    for H, W, shift in ((14, 14, 3), (10, 12, 3), (46, 46, 3), (3, 3, 0), (7, 7, 0), (10, 10, 0)):
        Hp, Wp = -(-H // 7) * 7, -(-W // 7) * 7
        want = jsw._pad_mask(H, W, Hp, Wp, 7)
        if shift:
            s = jsw._shift_mask(Hp, Wp, 7, shift)
            want = s if want is None else s + want
        got = tsw._attn_mask(H, W, 7, shift, torch.device("cpu"))
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(n(got), want)
    # values: -100 for a shifted or padded key, -200 where both meet
    assert set(np.unique(n(tsw._attn_mask(46, 46, 7, 3, torch.device("cpu"))))) == {-200.0, -100.0, 0.0}


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, WW, 96, dtype=torch.bfloat16)
    bias = torch.zeros(3, WW, WW)
    for fwd in (wa.window_attention_fwd, wa.window_attention_stacked_fwd):
        with pytest.raises(ValueError, match="CUDA"):
            fwd(q, q, q, bias, None, 3)
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_stacked_bwd(q, q, q, bias, None, q, 3)
    with pytest.raises(ValueError, match="variant"):
        wa.window_attention(q, q, q, bias, None, 3, "blocked")


@pytest.mark.parametrize("heads,fwd,bwd", [(3, 3, 3), (6, 3, 3), (12, 3, 3), (24, 3, 3), (2, 2, 2)])
def test_stacked_head_chunks(heads, fwd, bwd):
    """K9 and K10 each take up to 3 heads a block, always a divisor of the
    head count: Swin-T's stages take 1/2/4/8 chunks."""
    assert wa.head_chunk(heads, wa.STACKED_HEADS["fwd"]) == fwd
    assert wa.head_chunk(heads, wa.STACKED_HEADS["bwd"]) == bwd


def _instantiated(direction):
    """The head chunks csrc/window_attention_stacked.cu launches and sizes
    for K9 (``fwd``) or K10 (``bwd``): the templates its switches reach."""
    src = (_build.CSRC_DIR / "window_attention_stacked.cu").read_text()
    launched = set(map(int, re.findall(rf"launch_wins_{direction}<(\d+)>\(", src)))
    sized = set(map(int, re.findall(rf"return wins_{direction}_per_sm<(\d+)>\(\)", src)))
    assert launched == sized, (launched, sized)
    return launched


@pytest.mark.parametrize("heads", [2, 3, 6, 12, 24])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_stacked_chunks_are_instantiated(direction, heads):
    """Every chunk the wrapper picks for Swin-T's head counts (and the
    ragged cases' 2) is one the C side instantiates (K9: 1, 2, 3, 4 or 6
    heads, what fits in shared memory; K10: 1 to 3), so none reaches a
    launch that refuses."""
    chunk = wa.head_chunk(heads, wa.STACKED_HEADS[direction])
    assert chunk in _instantiated(direction)
    assert chunk <= {"fwd": 6, "bwd": 3}[direction]


# (what, nB, heads, mask kind); the first four are the stage shapes of the
# main path at 224 px and 16 images, shift masks on the odd blocks
CARD_SHAPES = [
    ("stage 1", 1024, 3, ("shift", 56)), ("stage 2", 256, 6, ("shift", 28)),
    ("stage 3", 64, 12, ("shift", 14)), ("stage 4", 16, 24, None),
    ("184 px stage 1", 8 * 49, 3, ("shift+pad", 46)), ("84 px stage 4", 8, 24, ("pad", 3)),
    ("ragged", 8, 2, ("shift+pad", 10)),
]


def card_mask(kind, device):
    """The (nW, 49 or 1, 49) mask of a map side ``kind[1]`` on the card."""
    if kind is None:
        return None
    what, side = kind
    return tsw._attn_mask(side, side, 7, 0 if what == "pad" else 3, device)


@pytest.mark.cuda
@pytest.mark.parametrize("what,nB,heads,kind,variant", _variants(CARD_SHAPES))
def test_kernels_match_plain_on_card(cuda_device, what, nB, heads, kind, variant):
    fwd_name, bwd_name = {"perhead": ("window_attention_fwd", "window_attention_bwd"),
                          "stacked": ("window_attention_stacked_fwd",
                                      "window_attention_stacked_bwd")}[variant]
    C = heads * 32
    gen = torch.Generator(device="cuda").manual_seed(nB + heads)
    qkv = torch.randn(nB, WW, 3 * C, generator=gen, device="cuda").bfloat16()
    bias = 0.1 * torch.randn(heads, WW, WW, generator=gen, device="cuda")
    do = torch.randn(nB, WW, C, generator=gen, device="cuda").bfloat16()
    mask = card_mask(kind, cuda_device)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    before = dict(_build.LAUNCHES)
    o = getattr(wa, fwd_name)(q, k, v, bias, mask, heads)
    grads = getattr(wa, bwd_name)(q, k, v, bias, mask, do, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fwd_name] == before.get(fwd_name, 0) + 1
    assert _build.LAUNCHES[bwd_name] == before.get(bwd_name, 0) + 1
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
    ref = wa.window_attention_reference(*xs, mask, heads)
    g_ref = torch.autograd.grad(ref, xs, do)
    assert (o.float() - ref.float()).abs().max().item() <= 1e-2, what
    for a, b, name in zip(grads, g_ref, ("dq", "dk", "dv", "dbias")):
        rel = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert rel.item() <= 2e-2, f"{what} {name}: {rel.item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("nB,heads,side", [(256, 6, 28), (1029, 3, 49)],
                         ids=["256x6", "ragged-1029x3"])
@pytest.mark.parametrize("bwd", ["window_attention_bwd", "window_attention_stacked_bwd"])
def test_dbias_is_deterministic_on_card(cuda_device, bwd, nB, heads, side):
    """q, k, v and dO as tensors of their own (K8 encodes a map each); 1029
    windows are no multiple of the grid's windows a block."""
    C = heads * 32
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(nB, WW, C, generator=gen, device="cuda").bfloat16() for _ in range(4))
    bias = torch.randn(heads, WW, WW, generator=gen, device="cuda")
    mask = card_mask(("shift", side), cuda_device)
    first = getattr(wa, bwd)(q, k, v, bias, mask, do, heads)
    again = getattr(wa, bwd)(q, k, v, bias, mask, do, heads)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert math.isfinite(first[3].abs().sum().item())


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
@pytest.mark.parametrize("what,nB,heads,kind", CARD_SHAPES + [("ragged 1029", 1029, 3, ("shift", 49))])
def test_perhead_bwd_is_deterministic_on_card(cuda_device, what, nB, heads, kind, masked):
    """K8 has no atomics: two calls on the same inputs give the same dq, dk,
    dv and dbias bits, with the shape's mask and without one; and q, k, v
    as column slices of one qkv tensor (one tensor map for the three) give
    the same bits as q, k, v copied to tensors of their own (a map each)."""
    C = heads * 32
    gen = torch.Generator(device="cuda").manual_seed(5 * nB + heads)
    qkv = torch.randn(nB, WW, 3 * C, generator=gen, device="cuda").bfloat16()
    bias = 0.1 * torch.randn(heads, WW, WW, generator=gen, device="cuda")
    do = torch.randn(nB, WW, C, generator=gen, device="cuda").bfloat16()
    mask = card_mask(kind, cuda_device) if masked else None
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    first = wa.window_attention_bwd(q, k, v, bias, mask, do, heads)
    again = wa.window_attention_bwd(q, k, v, bias, mask, do, heads)
    apart = wa.window_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), bias, mask,
                                    do, heads)
    torch.cuda.synchronize()
    for a, b, c, name in zip(first, again, apart, ("dq", "dk", "dv", "dbias")):
        assert torch.equal(a, b), f"{what} {name}"
        assert torch.equal(a, c), f"{what} {name}, q/k/v apart"


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
@pytest.mark.parametrize("what,nB,heads,kind,variant",
                         _variants(CARD_SHAPES + [("ragged 1029", 1029, 3, ("shift", 49))]))
def test_perhead_fwd_is_deterministic_on_card(cuda_device, what, nB, heads, kind, variant, masked):
    """K7 and K9 have no atomics: two calls on the same inputs give the same
    bits, with the shape's mask and without one; and q, k, v as column
    slices of one qkv tensor (one tensor map for the three) give the same
    bits as q, k, v copied to tensors of their own (a map each)."""
    fwd = {"perhead": wa.window_attention_fwd, "stacked": wa.window_attention_stacked_fwd}[variant]
    C = heads * 32
    gen = torch.Generator(device="cuda").manual_seed(3 * nB + heads)
    qkv = torch.randn(nB, WW, 3 * C, generator=gen, device="cuda").bfloat16()
    bias = 0.1 * torch.randn(heads, WW, WW, generator=gen, device="cuda")
    mask = card_mask(kind, cuda_device) if masked else None
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    first = fwd(q, k, v, bias, mask, heads)
    again = fwd(q, k, v, bias, mask, heads)
    apart = fwd(q.contiguous(), k.contiguous(), v.contiguous(), bias, mask, heads)
    torch.cuda.synchronize()
    assert torch.equal(first, again), what
    assert torch.equal(first, apart), f"{what}, q/k/v apart"
    ref = wa.window_attention_reference(q, k, v, bias, mask, heads)
    assert (first.float() - ref.float()).abs().max().item() <= 1e-2, what


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
@pytest.mark.parametrize("what,nB,heads,kind", CARD_SHAPES)
def test_stacked_bwd_is_deterministic_on_card(cuda_device, what, nB, heads, kind, masked):
    """K10 has no atomics: two calls on the same inputs give the same dq, dk,
    dv and dbias bits, with the shape's mask and without one; and q, k, v
    as column slices of one qkv tensor (one tensor map for the three) give
    the same bits as q, k, v copied to tensors of their own (a map each)."""
    C = heads * 32
    gen = torch.Generator(device="cuda").manual_seed(7 * nB + heads)
    qkv = torch.randn(nB, WW, 3 * C, generator=gen, device="cuda").bfloat16()
    bias = 0.1 * torch.randn(heads, WW, WW, generator=gen, device="cuda")
    do = torch.randn(nB, WW, C, generator=gen, device="cuda").bfloat16()
    mask = card_mask(kind, cuda_device) if masked else None
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    first = wa.window_attention_stacked_bwd(q, k, v, bias, mask, do, heads)
    again = wa.window_attention_stacked_bwd(q, k, v, bias, mask, do, heads)
    apart = wa.window_attention_stacked_bwd(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                                            mask, do, heads)
    torch.cuda.synchronize()
    for a, b, c, name in zip(first, again, apart, ("dq", "dk", "dv", "dbias")):
        assert torch.equal(a, b), f"{what} {name}"
        assert torch.equal(a, c), f"{what} {name}, q/k/v apart"
