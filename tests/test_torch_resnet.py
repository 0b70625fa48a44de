"""Port ResNets (dinomc_tpu_torch/models/resnet.py, the strided
``models/layers.conv_apply``) and BN-in-head (models/dino_head.py) against
the JAX package.

Both packages start from the JAX package's weights and BatchNorm state,
carried across with ``ckpt/from_jax.load_jax_params``, and see the same
numpy inputs, in f32. Bounds are the JAX package's own (tests/test_syncbn.py):
features and pooled output 1e-4, of their largest value where that exceeds
1, running means 1e-5 absolute and running variances 1e-4 relative;
gradients 1e-4 of the largest. The scale matters in train mode: each
BatchNorm divides by a batch's standard deviation, and over the network's
17 of them the JAX package's own f32 result drifts from a float64 run of the
same weights by up to 1.4e-4 at 64 px and 3.0e-4 at 32 px (the last stage
normalizes 4 values a channel there), while the port stays within 4e-5 and
2.2e-4 of it.

This file imports only JAX modules that need no flax (models/resnet.py,
layers.py, dino_head.py, ckpt/torch_export.py), so its ``cuda`` test also
runs on a card's machine that has jax but not flax.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.ckpt import torch_export as jexport
from dinomc_tpu.models import dino_head as jhead
from dinomc_tpu.models import resnet as jrn
from dinomc_tpu_torch.ckpt import state_dicts as tsd
from dinomc_tpu_torch.ckpt.from_jax import head_state_dict, load_jax_params
from dinomc_tpu_torch.ckpt.torch_import import load_backbone
from dinomc_tpu_torch.models import dino_head as thead
from dinomc_tpu_torch.models import resnet as trn
from dinomc_tpu_torch.models.encoders import EncoderConfig
from _torch_port import cuda_device, n, one_torch_thread, t  # noqa: F401

B = 4
# one compiled program a call, not one a JAX op
_features = jax.jit(jrn.resnet_features, static_argnames=("cfg", "train"))
_forward = jax.jit(jrn.resnet_forward, static_argnames=("cfg", "train"))


def _jax_resnet(arch="resnet_test", seed=0, stats_seed=None):
    """A JAX ResNet in f32 from ``seed``; with ``stats_seed`` its running
    statistics are drawn too (means N(0, 0.1), variances U(0.5, 1.5)), so an
    eval-mode forward differs from the identity statistics of an init."""
    cfg = jrn.RESNET_FACTORIES[arch](compute_dtype=jnp.float32)
    params, state = jax.device_get(jrn.init_resnet(jax.random.PRNGKey(seed), cfg))
    if stats_seed is not None:
        rng = np.random.default_rng(stats_seed)

        def draw(s):
            return {"bn": {"mean": (0.1 * rng.standard_normal(s["bn"]["mean"].shape)).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, s["bn"]["var"].shape).astype(np.float32)}}

        state = {k: ([{kk: draw(vv) for kk, vv in blk.items()} for blk in v]
                     if isinstance(v, list) else draw(v)) for k, v in state.items()}
    return cfg, params, state


def _port_resnet(params, state, arch="resnet_test"):
    model = trn.ResNet(trn.RESNET_FACTORIES[arch](compute_dtype=torch.float32))
    load_jax_params(model, (params, state))
    return model


def _stats(state):
    """A JAX BatchNorm state tree -> {torchvision BatchNorm name: (mean, var)}."""
    out = {"bn1": state["stem"]}
    for stage in range(1, 5):
        for b, bs in enumerate(state[f"layer{stage}"]):
            out.update({f"layer{stage}.{b}.bn{i}": bs[f"conv{i}"] for i in (1, 2, 3)})
            if "down" in bs:
                out[f"layer{stage}.{b}.downsample.1"] = bs["down"]
    return {k: (s["bn"]["mean"], s["bn"]["var"]) for k, s in out.items()}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("size", [32, 64])
def test_resnet_test_features_match_jax(train, size):
    """The 5 taps (NHWC, 64/256/512/1024/2048 channels at strides 2-32) and
    the pooled embedding, in train mode (batch statistics, running ones
    moved once a BatchNorm) and eval mode (drawn running statistics)."""
    cfg, params, state = _jax_resnet(stats_seed=None if train else 3)
    model = _port_resnet(params, state)
    x = np.random.default_rng(size).standard_normal((B, size, size, 3)).astype(np.float32)
    jfeats, jpooled, jstate = _features(params, state, jnp.asarray(x), cfg, train)
    feats, pooled = trn.resnet_features(model, t(x), train)
    assert [f.shape[-1] for f in feats] == [64, 256, 512, 1024, 2048]
    assert [f.shape[1] for f in feats] == [size // s for s in (2, 4, 8, 16, 32)]
    for ours, ref in list(zip(feats, jfeats)) + [(pooled, jpooled)]:
        ref = np.asarray(ref)
        np.testing.assert_allclose(n(ours), ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())),
                                   rtol=0)
    ours = {k[: -len(".running_mean")]: (n(v), n(model.state_dict()[k[: -len("mean")] + "var"]))
            for k, v in model.state_dict().items() if k.endswith(".running_mean")}
    ref = _stats(jax.device_get(jstate))
    assert set(ours) == set(ref)
    for k, (mean, var) in ref.items():
        np.testing.assert_allclose(ours[k][0], mean, atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(ours[k][1], var, rtol=1e-4, err_msg=k)
    tracked = {int(v) for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
    assert tracked == {1 if train else 0}


def test_resnet_test_grads_match_jax():
    """Gradients of a scalar of the pooled embedding through train-mode
    BatchNorm, every parameter, within 1e-4 of the largest gradient."""
    cfg, params, state = _jax_resnet(seed=1)
    model = _port_resnet(params, state)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 48, 48, 3)).astype(np.float32)
    w = rng.standard_normal((2048,)).astype(np.float32)

    def loss(p):
        pooled, _ = jrn.resnet_forward(p, state, jnp.asarray(x), cfg, True)
        return jnp.sum(jnp.tanh(pooled) * w)

    gj = tsd.resnet_state_dict(jax.device_get(jax.jit(jax.grad(loss))(params)), state)
    out = trn.resnet_forward(model, t(x), True)
    (out.tanh() * t(w)).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == {k for k in gj if not k.endswith(("running_mean", "running_var",
                                                             "num_batches_tracked"))}
    scale = max(float(np.abs(np.asarray(gj[k])).max()) for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(n(g), np.asarray(gj[k]), atol=1e-4 * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["resnet50", "wide_resnet50_2"])
def test_full_width_loads_the_jax_export_strictly(arch):
    """The JAX init's torchvision export (``torch_export.resnet_state_dict``)
    loads into the port's module with ``strict=True``: the same keys and
    shapes, no forward at full width."""
    cfg, params, state = _jax_resnet(arch)
    sd = jexport.resnet_state_dict(params, state)
    model = trn.ResNet(trn.RESNET_FACTORIES[arch]())
    ours = model.state_dict()
    assert set(ours) == set(sd)
    assert all(tuple(ours[k].shape) == sd[k].shape for k in sd)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    assert torch.equal(model.layer3[5].conv2.weight, t(sd["layer3.5.conv2.weight"]))
    assert EncoderConfig(arch=arch).embed_dim == 2048
    width = 128 if arch == "wide_resnet50_2" else 64
    assert model.layer1[0].conv2.weight.shape == (width, width, 3, 3)


def test_a_torchvision_pth_loads_with_its_running_statistics(tmp_path):
    """A torchvision-layout ``.pth`` (here the JAX export of drawn running
    statistics, under a DINO checkpoint's ``teacher`` key and ``backbone.``
    prefix) loads through ``load_backbone`` and gives JAX's eval-mode
    features."""
    cfg, params, state = _jax_resnet(stats_seed=7)
    sd = jexport.resnet_state_dict(params, state, prefix="backbone.")
    sd["head.mlp.1.running_mean"] = np.zeros(4, np.float32)  # not the backbone's
    torch.save({"teacher": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               tmp_path / "rn.pth")
    model = trn.ResNet(trn.resnet_test(compute_dtype=torch.float32))
    load_backbone(model, str(tmp_path / "rn.pth"))
    assert torch.equal(model.layer2[0].bn1.running_var, t(sd["backbone.layer2.0.bn1.running_var"]))
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref, _ = _forward(params, state, jnp.asarray(x), cfg, False)
    np.testing.assert_allclose(n(trn.resnet_forward(model, t(x))), np.asarray(ref), atol=1e-4)


# --- BN-in-head --------------------------------------------------------------

def _bn_heads(seed=1):
    jcfg = jhead.DINOHeadConfig(in_dim=32, out_dim=64, hidden_dim=48, bottleneck_dim=16,
                                use_bn=True, compute_dtype=jnp.float32)
    params = jax.device_get(jhead.init_dino_head(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for j in range(2):  # non-unit BatchNorm scales and biases
        params[f"mlp_{j}"]["bn_scale"] = rng.uniform(0.5, 1.5, 48).astype(np.float32)
        params[f"mlp_{j}"]["bn_bias"] = (0.1 * rng.standard_normal(48)).astype(np.float32)
    head = thead.DINOHead(thead.DINOHeadConfig(in_dim=32, out_dim=64, hidden_dim=48,
                                               bottleneck_dim=16, use_bn=True,
                                               compute_dtype=torch.float32))
    load_jax_params(head, params)
    return jcfg, params, head


def test_bn_head_forward_and_grads_match_jax():
    """The reference's shifted names (Linear at mlp.0/3/6, BatchNorm at
    mlp.1/4), batch statistics with the biased variance, no running
    statistics; logits within 1e-5 and every gradient within 1e-5 of its
    largest."""
    jcfg, params, head = _bn_heads()
    assert sorted(k for k in head.state_dict() if k.startswith("mlp.")) == sorted(
        f"mlp.{i}.{w}" for i in (0, 1, 3, 4, 6) for w in ("weight", "bias"))
    assert not list(head.buffers())
    rng = np.random.default_rng(4)
    x = rng.standard_normal((10, 32)).astype(np.float32)
    w = rng.standard_normal((10, 64)).astype(np.float32)
    ref = np.asarray(jhead.dino_head_forward(params, jnp.asarray(x), jcfg))
    xt = t(x).requires_grad_()
    out = thead.dino_head_forward(head, xt)
    np.testing.assert_allclose(n(out), ref, atol=1e-5)

    def loss(p, xx):
        return jnp.sum(jnp.tanh(jhead.dino_head_forward(p, xx, jcfg)) * w)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    (out.tanh() * t(w)).sum().backward()
    ref_grads = head_state_dict(jax.device_get(gp))
    grads = dict(head.named_parameters())
    assert set(grads) == set(ref_grads)
    # of the largest gradient of any tensor: a bias just before a
    # batch-statistics BatchNorm has a zero gradient up to rounding
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref_grads.values())
    for k, p in grads.items():
        np.testing.assert_allclose(n(p.grad), np.asarray(ref_grads[k]), atol=1e-5 * scale,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(n(xt.grad), np.asarray(gx),
                               atol=1e-5 * float(np.abs(np.asarray(gx)).max()))


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_resnet_dino_step_on_the_card_launches_k3_only(cuda_device):
    """A bf16 ResNet DINO step on the card (resnet_test, LARS, BN head, the
    CLI's crops: 2 x 224 px and 6 locals of 184 ... 84 px): the photometric
    kernel K3 launches once a crop (8) and no other hand-written kernel
    does; the student's and the teacher's running statistics move, the
    student's once a crop-size bucket (7) and the teacher's once."""
    from dinomc_tpu_torch.cli.train_dino import build_config, build_schedules, get_args_parser
    from dinomc_tpu_torch.ops.augment import draw_multicrop, multicrop_augment
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train import dino_trainer as ttr

    args = get_args_parser().parse_args(["--optimizer", "lars", "--use_bn_in_head", "true",
                                         "--out_dim", "4096", "--batch_size_per_gpu", "4"])
    args.arch = "resnet_test"
    mc_cfg, cfg = build_config(args, 10)
    sch = build_schedules(args, 4, 10)
    state = ttr.init_dino_train_state(cfg, 0, cuda_device)
    before = {w: {k: v.clone() for k, v in getattr(state, w).state_dict().items()}
              for w in ("student", "teacher")}
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    images = torch.rand(4, 256, 256, 3, generator=gen, device=cuda_device)
    _build.LAUNCHES.clear()
    g, locs = multicrop_augment(images, draw_multicrop(gen, 4, 256, 256, mc_cfg,
                                                       device=cuda_device), mc_cfg)
    loss = ttr.dino_train_step(state, g, locs, sch, cfg)["loss"]
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"photometric": 8}
    assert math.isfinite(float(loss))
    for which, calls in (("student", 1 + len(set(mc_cfg.local_sizes))), ("teacher", 1)):
        now = getattr(state, which).state_dict()
        assert int(now["backbone.bn1.num_batches_tracked"]) == calls
        assert not torch.equal(now["backbone.layer4.0.bn3.running_var"],
                               before[which]["backbone.layer4.0.bn3.running_var"])
