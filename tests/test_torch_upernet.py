"""Port UPerNet and the seg train step against the JAX package.

Both sides start from the JAX package's init, carried across with
``ckpt/from_jax.load_jax_params`` (strict state-dict load through
``torch_export.upernet_state_dict``), and compute in f32. The input is
132 px at patch 4: 1090 tokens, padded 1152 > 1024, so the port's ViT takes
the long-sequence route (``long_mha``'s plain version on the CPU) while the
JAX package runs dense attention, as its ``mha`` does on a CPU. Dropout
masks are the JAX step's own draws, injected into the port.

Bounds: ViT taps 2e-5, the ViT tests' bound (tests/test_torch_vit.py).
The forward's logits reach ~10 after the BatchNorms, and f32
convolutions sum in another order in the two frameworks: 1e-4 on logits,
and 2e-6 on BatchNorm statistics, means over ~10^4 values. The train steps
keep the DINO step's bounds (tests/test_torch_dino_step.py): loss 1e-5 per
step, parameters and BatchNorm statistics 5e-4 (AdamW moves
near-zero-gradient elements by O(lr) in the sign of f32 summation noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.ckpt.torch_export import upernet_state_dict
from dinomc_tpu.models import upernet as jup
from dinomc_tpu.train import seg_trainer as jtr
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.models import upernet as tup
from dinomc_tpu_torch.ops import attention as tatt
from dinomc_tpu_torch.train import seg_trainer as ttr
from _torch_port import n, one_torch_thread, t  # noqa: F401

B, S, C = 2, 132, 5
SMALL = dict(num_classes=C, arch="vit_test", patch_size=4, out_indices=(0, 1, 2, 2),
             channels=32, aux_channels=16)


def _cfgs(**kw):
    j = jup.UPerNetConfig(**SMALL, compute_dtype=jnp.float32, **kw)
    return j, tup.UPerNetConfig(**SMALL, compute_dtype=torch.float32, **kw)


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    masks = rng.integers(0, C, (B, S, S)).astype(np.int32)
    return images, masks


def _compare_state(model, params, bn_state, atol, what):
    """Every parameter and BatchNorm statistic against the JAX trees
    (``num_batches_tracked`` is torch's count, which JAX does not keep)."""
    ref = upernet_state_dict(jax.device_get(params), jax.device_get(bn_state))
    ours = model.state_dict()
    assert set(ours) == set(ref), set(ours) ^ set(ref)
    for k in sorted(ref):
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(n(ours[k]), np.asarray(ref[k], np.float32),
                                   atol=atol, rtol=0, err_msg=f"{what}{k}")


@pytest.mark.parametrize("neck", [False, True], ids=["uperhead", "fpn-neck"])
def test_forward_matches_jax_on_the_long_route(neck, monkeypatch):
    jcfg, tcfg = _cfgs(use_fpn_neck=neck)
    params, state = jup.init_upernet(jax.random.PRNGKey(0), jcfg)
    model = tup.UPerNet(tcfg)
    load_jax_params(model, jax.device_get((params, state)))
    long_calls = []
    long_mha = tatt.long_mha
    monkeypatch.setattr(tatt, "long_mha", lambda *a: long_calls.append(a[0].shape) or long_mha(*a))
    images, _ = _batch(1)
    x = jnp.asarray(images)
    for train in (False, True):
        logits, new_state, aux = jup.upernet_forward(params, state, x, jcfg, train=train,
                                                     with_aux=True)
        with torch.no_grad():
            out, out_aux = tup.upernet_forward(model, t(images), train=train, with_aux=True)
        assert out.shape == (B, S, S, C) and out.dtype == torch.float32
        np.testing.assert_allclose(n(out), np.asarray(logits), atol=1e-4)
        np.testing.assert_allclose(n(out_aux), np.asarray(aux), atol=1e-4)
        _compare_state(model, params, new_state, 2e-6, f"train={train} ")
        assert int(model.decode_head.fpn_bottleneck.bn.num_batches_tracked) == int(train)
    # every ViT layer of both forwards went through the long-sequence route
    assert long_calls == [(B, (S // 4) ** 2 + 1, 2, 16)] * 6


@pytest.mark.parametrize("apply_norm", [True, False], ids=["final-norm", "raw-taps"])
def test_vit_intermediate_layers_match_jax(apply_norm):
    from dinomc_tpu.models import vit as jvit
    from dinomc_tpu_torch.models import vit as tvit

    jcfg = jvit.vit_test(img_size=16, compute_dtype=jnp.float32)
    params = jvit.init_vit(jax.random.PRNGKey(1), jcfg)
    model = tvit.VisionTransformer(tvit.vit_test(img_size=16, compute_dtype=torch.float32))
    load_jax_params(model, jax.device_get(params))
    x = np.random.default_rng(4).standard_normal((2, 24, 20, 3)).astype(np.float32)
    ref = jvit.vit_intermediate_layers(params, jnp.asarray(x), jcfg, (2, 0, 1), apply_norm)
    out = tvit.vit_intermediate_layers(model, t(x), (2, 0, 1), apply_norm)
    assert out.shape == ref.shape == (3, 2, 31, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=2e-5)


def _jax_drop_masks(jstate, cfg):
    """The dropout keep-masks of the JAX step: ``rng, step_rng =
    split(state.rng)`` (seg_trainer.py:80), then ``_, rd = split(step_rng)``
    and ``_, ra = split(rng')`` in upernet_forward (upernet.py:282-299)."""
    Hf = S // cfg.patch_size
    _, step_rng = jax.random.split(jstate.rng)
    rng, rd = jax.random.split(step_rng)
    _, ra = jax.random.split(rng)
    keep = 1.0 - cfg.dropout_rate
    dec = jax.random.bernoulli(rd, keep, (B, 2 * Hf, 2 * Hf, cfg.channels))
    aux = jax.random.bernoulli(ra, keep, (B, Hf // 2, Hf // 2, cfg.aux_channels))
    return {k: t(np.asarray(m), None).permute(0, 3, 1, 2) for k, m in (("decode", dec),
                                                                       ("aux", aux))}


@pytest.mark.parametrize("train_backbone,use_aux", [(False, False), (True, True)],
                         ids=["frozen-backbone", "full-finetune-aux"])
def test_train_steps_match_jax(train_backbone, use_aux):
    jcfg_m, tcfg_m = _cfgs()
    jcfg = jtr.SegConfig(model=jcfg_m, train_backbone=train_backbone, use_aux_loss=use_aux,
                         ignore_index=0)
    tcfg = ttr.SegConfig(model=tcfg_m, train_backbone=train_backbone, use_aux_loss=use_aux,
                         ignore_index=0)
    jstate = jtr.init_seg_train_state(jax.random.PRNGKey(3), jcfg)
    tstate = ttr.init_seg_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    backbone0 = {k: v.clone() for k, v in tstate.model.state_dict().items()
                 if k.startswith("backbone.")}
    lrs, wd = (3e-4, 2e-4, 1e-4), 0.05  # the reference's lr 3e-4, cosine-decayed
    for i, lr in enumerate(lrs):
        images, masks = _batch(10 + i)
        drop = _jax_drop_masks(jstate, jcfg_m)
        jstate, jm = jtr.seg_train_step(jstate, jnp.asarray(images), jnp.asarray(masks),
                                        jnp.float32(lr), jnp.float32(wd), jcfg)
        tm = ttr.seg_train_step(tstate, t(images), t(masks, torch.long), lr, wd, tcfg,
                                drop_masks=drop)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        # argmax over logits equal to ~1e-5 may flip a near-tied pixel: 1e-4
        # allows 3 of the batch's 34,848
        np.testing.assert_allclose(float(tm["pixel_acc"]), float(jm["pixel_acc"]), atol=1e-4)
    assert tstate.step == int(jstate.step) == len(lrs)
    _compare_state(tstate.model, jstate.params, jstate.bn_state, 5e-4, "")
    moved = any(not torch.equal(v, tstate.model.state_dict()[k]) for k, v in backbone0.items())
    assert moved == train_backbone
    if not train_backbone:  # bit-identical, and AdamW never touched it
        assert all(tstate.opt_state["count"][k] == 0 for k in backbone0 if "num_batches" not in k)
    if not use_aux:
        # The unused auxiliary head gets zero gradients in JAX, so AdamW only
        # decays its conv weights, p *= 1 - lr * wd each step: the same to
        # f32 rounding here, where the 5e-4 bound above would not see it.
        ref = upernet_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.bn_state))
        w = "auxiliary_head.conv_seg.weight"
        np.testing.assert_allclose(n(tstate.model.state_dict()[w]), ref[w], atol=1e-8, rtol=0)
        assert tstate.opt_state["count"][w] == len(lrs)


def test_frozen_backbone_runs_no_backbone_backward():
    """With the backbone frozen its forward runs without autograd, so no
    backbone parameter is reached by the backward (nor the auxiliary head,
    which runs only ``with_aux``)."""
    _, tcfg_m = _cfgs()
    tcfg = ttr.SegConfig(model=tcfg_m, train_backbone=False)
    tstate = ttr.init_seg_train_state(tcfg, seed=1)
    images, masks = _batch(2)
    logits = tup.upernet_forward(tstate.model, t(images[:, :64, :64]), train=True,
                                 stop_backbone_grad=True)
    logits.sum().backward()
    for name, p in tstate.model.named_parameters():
        assert (p.grad is None) == name.startswith(("backbone.", "auxiliary_head.")), name


def test_seg_predict_is_the_eval_forward():
    _, tcfg_m = _cfgs()
    model = ttr.init_seg_train_state(ttr.SegConfig(model=tcfg_m), seed=2).model
    x = t(_batch(3)[0][:, :48, :48])
    out = ttr.seg_predict(model, x)
    assert not out.requires_grad and out.shape == (B, 48, 48, C)
    with torch.no_grad():
        assert torch.equal(out, tup.upernet_forward(model, x, train=False))


def test_state_dict_layout_is_the_export_layout():
    for neck in (False, True):
        jcfg, tcfg = _cfgs(use_fpn_neck=neck)
        params, state = jax.eval_shape(lambda: jup.init_upernet(jax.random.PRNGKey(0), jcfg))
        ref = upernet_state_dict(
            jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), params),
            jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), state),
        )
        ours = tup.UPerNet(tcfg).state_dict()
        assert {k: tuple(v.shape) for k, v in ours.items()} == {
            k: tuple(np.shape(v)) for k, v in ref.items()}
