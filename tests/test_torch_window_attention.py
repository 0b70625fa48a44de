"""Port window attention (ops/hopper/window_attention.py) against the JAX
package's.

The plain version is held to JAX ``packed_window_attention`` in Pallas
interpret mode and to the einsum core of tests/test_window_attention.py,
on that file's cases (shift masks, the 24-head case, both grouping regimes
of the JAX kernel) and on pad-only (nW, 1, 49) and shift + pad masks, in f32
at that file's bounds: forward 2e-5, dQ/dK/dV/dbias 2e-4. The CUDA kernels
K7/K8 are held to the plain version on the card (``cuda``-marked, skipped
without one) in bf16 at chip_smoke.py's bounds.
"""

import math

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


@pytest.mark.parametrize("nB,C,heads,kind,group", ALL)
def test_reference_matches_jax_kernel_and_einsum(nB, C, heads, kind, group):
    q, k, v, bias, mask = _data(0, nB, C, heads, kind)
    out = wa.window_attention_reference(t(q), t(k), t(v), t(bias), None if mask is None else t(mask), heads)
    ker = packed_window_attention(*map(jnp.asarray, (q, k, v, bias)), mask, heads,
                                  _n_windows(mask, nB), group=group, interpret=True)
    np.testing.assert_allclose(n(out), np.asarray(ker), rtol=2e-5, atol=2e-5)
    if mask is None or mask.shape[1] == WW:  # the einsum core takes full masks only
        np.testing.assert_allclose(n(out), np.asarray(_xla_core(q, k, v, jnp.asarray(bias), mask)),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nB,C,heads,kind,group", CASES[:3] + MASKED)
def test_reference_grads_match_jax(nB, C, heads, kind, group):
    q, k, v, bias, mask = _data(1, nB, C, heads, kind)
    nW = _n_windows(mask, nB)

    def loss_ker(*a):
        return (packed_window_attention(*a, mask, heads, nW, group=group, interpret=True) ** 2).sum()

    g_ker = jax.grad(loss_ker, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    xs = [t(x).requires_grad_() for x in (q, k, v, bias)]
    out = wa.window_attention(*xs, None if mask is None else t(mask), heads)
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
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_fwd(q, q, q, bias, None, 3)


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
@pytest.mark.parametrize("what,nB,heads,kind", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda_device, what, nB, heads, kind):
    C = heads * 32
    gen = torch.Generator(device="cuda").manual_seed(nB + heads)
    qkv = torch.randn(nB, WW, 3 * C, generator=gen, device="cuda").bfloat16()
    bias = 0.1 * torch.randn(heads, WW, WW, generator=gen, device="cuda")
    do = torch.randn(nB, WW, C, generator=gen, device="cuda").bfloat16()
    mask = card_mask(kind, cuda_device)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    before = dict(_build.LAUNCHES)
    o = wa.window_attention_fwd(q, k, v, bias, mask, heads)
    grads = wa.window_attention_bwd(q, k, v, bias, mask, do, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["window_attention_fwd"] == before.get("window_attention_fwd", 0) + 1
    assert _build.LAUNCHES["window_attention_bwd"] == before.get("window_attention_bwd", 0) + 1
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v, bias)]
    ref = wa.window_attention_reference(*xs, mask, heads)
    g_ref = torch.autograd.grad(ref, xs, do)
    assert (o.float() - ref.float()).abs().max().item() <= 1e-2, what
    for a, b, name in zip(grads, g_ref, ("dq", "dk", "dv", "dbias")):
        rel = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert rel.item() <= 2e-2, f"{what} {name}: {rel.item():.3e}"


@pytest.mark.cuda
def test_dbias_is_deterministic_on_card(cuda_device):
    nB, heads = 256, 6
    C = heads * 32
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(nB, WW, C, generator=gen, device="cuda").bfloat16() for _ in range(4))
    bias = torch.randn(heads, WW, WW, generator=gen, device="cuda")
    mask = card_mask(("shift", 28), cuda_device)
    first = wa.window_attention_bwd(q, k, v, bias, mask, do, heads)
    again = wa.window_attention_bwd(q, k, v, bias, mask, do, heads)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert math.isfinite(first[3].abs().sum().item())
