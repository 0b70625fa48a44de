"""Port OSCD change detection (the OSCD and soft-IoU losses of
objectives/segmentation.py, models/siamese.py, train/oscd_trainer.py,
data/oscd.py, cli/oscd.py and ``ckpt/from_jax``'s siamese mapping) against
the JAX package.

Both packages start from the JAX package's ``init_siamese`` weights and
BatchNorm state, carried across with ``ckpt/from_jax.load_jax_params``, and
see the same numpy inputs, in f32 (the JAX ``SiameseConfig`` has no
compute dtype, nor the port's: the tests give both packages'
``resnet_test`` factories f32). Bounds: each loss
1e-6 relative (f32 sums of ~10^4 terms); the siamese logits and taps
within 1e-4 of their largest value, the bound of tests/test_torch_resnet.py
(17 train-mode BatchNorms in a row); three Adam steps those of
tests/test_torch_convnet_step.py: loss 1e-5 a step with the encoder frozen
(its classification step's bound) and 5e-5 with it trained (its ResNet
step's bound: the train-mode BatchNorms' f32 rounding), each parameter's
change from the init held as its change check holds it, but at 99% of the
elements (``_assert_adam_changes_close``), parameters and BatchNorm
statistics also 5e-4 after the steps, the encoder bit-identical when
frozen. Adam's first step
moves each element by lr times the sign of its gradient, and a few
elements of a 1x1 lateral conv have gradients within f32 summation noise
(3e-8 against a noise of 8e-7 at 64 px), so they move 2 lr apart. The
steps' lr is a tenth of the reference's 1e-3; the loss gaps below were
measured there. A step's F1 comes from thresholded logits: a pixel within rounding of 0 may fall on the other
side, so F1 is held to 4 / (changed pixels), the most one such pixel can
move it. With the encoder trained, those ±lr moves reach the encoder's
convolutions ahead of 17 train-mode BatchNorms: the loss gap, 8e-7 at the
first step, grows to 1.3e-5 and 1.8e-4 at the next two (measured at lr
1e-4), so the trained encoder is held for one step, which both packages
take from the same parameters. ``OSCDTiles`` equal exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dinomc_tpu.ckpt import torch_export as jexport
from dinomc_tpu.data import oscd as joscd
from dinomc_tpu.models import resnet as jrn
from dinomc_tpu.models import siamese as jsiam
from dinomc_tpu.objectives import segmentation as jloss
from dinomc_tpu.train import oscd_trainer as jtr
from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params, siamese_state_dict
from dinomc_tpu_torch.cli import oscd as cli
from dinomc_tpu_torch.data import oscd as toscd
from dinomc_tpu_torch.models import resnet as trn
from dinomc_tpu_torch.models import siamese as tsiam
from dinomc_tpu_torch.objectives import segmentation as tloss
from dinomc_tpu_torch.train import oscd_trainer as ttr
from _torch_port import n, one_torch_thread, t  # noqa: F401

B, S = 4, 64
LRS = (1e-4, 9.5e-5, 9.025e-5)


@pytest.fixture(autouse=True)
def f32_resnet_test(monkeypatch):
    monkeypatch.setitem(jrn.RESNET_FACTORIES, "resnet_test",
                        functools.partial(jrn.resnet_test, compute_dtype=jnp.float32))
    monkeypatch.setitem(trn.RESNET_FACTORIES, "resnet_test",
                        functools.partial(trn.resnet_test, compute_dtype=torch.float32))


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 20), (2, 16, 20, 1)])
def test_dice_bce_loss_and_grad_match_jax(shape):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    target = (rng.uniform(size=shape) > 0.7).astype(np.float32)
    ref, g_ref = jax.value_and_grad(jloss.dice_bce_loss)(jnp.asarray(logits), jnp.asarray(target))
    x = t(logits).requires_grad_()
    out = tloss.dice_bce_loss(x, t(target))
    (g,) = torch.autograd.grad(out, x)
    assert _rel(out, ref) <= 1e-6
    np.testing.assert_allclose(n(g), np.asarray(g_ref), rtol=1e-5, atol=1e-6 * np.abs(g_ref).max())


@pytest.mark.parametrize("name", ["miou_loss", "mmiou_loss", "liou_loss"])
@pytest.mark.parametrize("raw", [False, True], ids=["logits", "probabilities"])
def test_soft_iou_losses_match_jax(name, raw):
    """mmIoU uses its input raw (the reference's softmax is commented out):
    also held on probability-like inputs, its intended domain."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 10, 5)).astype(np.float32)
    if raw:
        x = np.asarray(jax.nn.softmax(jnp.asarray(x), -1))
    target = rng.integers(0, 5, (2, 12, 10))
    ref = getattr(jloss, name)(jnp.asarray(x), jnp.asarray(target))
    out = getattr(tloss, name)(t(x), torch.from_numpy(target))
    assert out.dtype == torch.float32 and _rel(out, ref) <= 1e-6


def test_soft_iou_one_hot_zeroes_out_of_range_targets():
    probs = torch.softmax(torch.randn(1, 3, 3, 4, generator=torch.Generator().manual_seed(2)), -1)
    target = torch.tensor([[[0, 1, 7], [2, 3, -1], [1, 1, 4]]])
    ref = jloss._soft_iou_per_class(jnp.asarray(probs.numpy()),
                                    jax.nn.one_hot(jnp.asarray(target.numpy()), 4))
    ours = tloss._soft_iou_per_class(probs, tloss._one_hot(target, 4))
    np.testing.assert_allclose(n(ours), np.asarray(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# the siamese model and the step
# ---------------------------------------------------------------------------


def _models(freeze, seed=0):
    jcfg = jsiam.SiameseConfig(arch="resnet_test", freeze_encoder=freeze)
    params, state = jax.device_get(jsiam.init_siamese(jax.random.PRNGKey(seed), jcfg))
    model = tsiam.Siamese(tsiam.SiameseConfig(arch="resnet_test", freeze_encoder=freeze))
    load_jax_params(model, (params, state))
    return jcfg, params, state, model


def _pair(seed, size=S):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(size=(B, size, size, 3)).astype(np.float32)
    change = (rng.uniform(size=(B, size, size)) > 0.8).astype(np.float32)
    x2 = np.clip(x1 + 0.4 * change[..., None] + 0.05 * rng.standard_normal(x1.shape), 0, 1)
    return x1, x2.astype(np.float32), change


def _close_scaled(ours, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(ours), ref, rtol=0, atol=1e-4 * max(np.abs(ref).max(), 1.0),
                               err_msg=what)


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "trained"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_siamese_forward_matches_jax(freeze, train):
    jcfg, params, state, model = _models(freeze)
    x1, x2, _ = _pair(3)
    ref, new_state = jsiam.siamese_forward(params, state, jnp.asarray(x1), jnp.asarray(x2),
                                           jcfg, train)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        out = tsiam.siamese_forward(model, t(x1), t(x2), train)
    assert out.shape == (B, S, S) and out.dtype == torch.float32
    _close_scaled(out, ref, "logits")
    if not train:
        jcfg_step = jtr.OSCDConfig(model=jcfg)
        _close_scaled(ttr.oscd_predict(model, t(x1), t(x2)),
                      jtr.oscd_predict(params, state, jnp.asarray(x1), jnp.asarray(x2), jcfg_step),
                      "oscd_predict")
    now = model.state_dict()
    moved = train and not freeze
    ref_sd = siamese_state_dict(params, jax.device_get(new_state))
    for k, v in now.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == (2 if moved and k.startswith("encoder.") else 0), k
        elif "running_" in k:
            if moved:  # twice a forward, t1 then t2, as the JAX state threads them
                np.testing.assert_allclose(n(v), ref_sd[k], rtol=1e-4, atol=1e-5, err_msg=k)
                assert not torch.equal(v, before[k])
            else:
                assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "trained"])
def test_frozen_encoder_is_cut_out_of_the_backward(freeze):
    """A frozen encoder runs without autograd: no encoder tensor takes part
    in the graph, as JAX's stop_gradient skips both encoder backwards."""
    _, _, _, model = _models(freeze)
    x1, x2, _ = _pair(4, 32)
    out = tsiam.siamese_forward(model, t(x1), t(x2), train=True)
    enc = [p for name, p in model.named_parameters() if name.startswith("encoder.")]
    grads = torch.autograd.grad(out.sum(), enc, allow_unused=True)
    assert all(g is None for g in grads) == freeze


def _assert_adam_changes_close(ours, ref, init):
    """Each parameter's change from the shared ``init``, ours against JAX's:
    within the bound of test_torch_convnet_step.py's change check (1e-2 of
    JAX's largest change, plus 4 ulp of the leaf's largest value) at all
    but 1% of its elements (rounded down), and within twice JAX's largest
    change, plus those ulp, at every one. Adam divides each gradient by
    its own root mean square, so an element whose gradient is within f32
    summation noise moves by up to lr either way in each package: such
    elements, 0.4% of a leaf at most (measured, three frozen steps and one
    trained), may differ by up to 2 lr. A skipped, doubled or
    sign-flipped update misses the 1e-2 bound at most of a leaf's
    elements."""
    eps = float(np.finfo(np.float32).eps)
    for k in sorted(init):
        r = np.asarray(ref[k], np.float32)
        d_ref = r - init[k]
        ulp = 4 * eps * np.abs(r).max()
        err = np.abs(n(ours[k]) - init[k] - d_ref)
        top = np.abs(d_ref).max()
        off = int((err > 1e-2 * top + ulp).sum())
        assert off <= d_ref.size // 100, f"{k}: {off} of {d_ref.size} elements off"
        assert err.max() <= 2 * top + ulp, f"{k}: {err.max()} against {top}"


@pytest.mark.parametrize("freeze,loss", [(True, "bce"), (True, "dice_bce"), (False, "bce")],
                         ids=["frozen-bce", "frozen-dice_bce", "trained-bce"])
def test_three_oscd_steps_match_jax(freeze, loss):
    """Three steps with the encoder frozen (the reference's mode), one with
    it trained (see the module docstring): the loss, F1, precision, recall
    and IoU at each; after, every parameter's change from the init, and
    the parameters and BatchNorm statistics themselves."""
    jcfg = jtr.OSCDConfig(model=jsiam.SiameseConfig(arch="resnet_test", freeze_encoder=freeze),
                          loss=loss)
    tcfg = ttr.OSCDConfig(model=tsiam.SiameseConfig(arch="resnet_test", freeze_encoder=freeze),
                          loss=loss)
    jstate = jtr.init_oscd_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = ttr.init_oscd_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    init = {k: n(v).copy() for k, v in tstate.model.named_parameters()}
    lrs = LRS if freeze else LRS[:1]
    for step, lr in enumerate(lrs):
        x1, x2, m = _pair(10 + step)
        jstate, jm = jtr.oscd_train_step(jstate, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(m),
                                         jnp.float32(lr), jcfg)
        tm = ttr.oscd_train_step(tstate, t(x1), t(x2), t(m), lr, tcfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=0,
                                   atol=1e-5 if freeze else 5e-5, err_msg=f"loss at step {step}")
        for k in ("f1", "precision", "recall", "iou"):
            assert abs(float(tm[k]) - float(jm[k])) <= 4 / m.sum(), (k, step)
    assert tstate.step == int(jstate.step) == len(lrs)
    params, bn = jax.device_get((jstate.params, jstate.bn_state))
    ref = siamese_state_dict(params, bn)
    now = tstate.model.state_dict()
    _assert_adam_changes_close(now, ref, init)
    for k in ref:
        if k.endswith("num_batches_tracked"):
            assert int(now[k]) == (0 if freeze or not k.startswith("encoder.") else 2 * len(lrs)), k
        else:
            np.testing.assert_allclose(n(now[k]), ref[k], atol=5e-4, rtol=0, err_msg=k)
    dec = [k for k in init if not k.startswith("encoder.")]
    assert all(not torch.equal(now[k], before[k]) for k in dec)
    enc = [k for k in init if k.startswith("encoder.")]
    assert all(torch.equal(now[k], before[k]) for k in enc) == freeze
    stats = [k for k in now if k.startswith("encoder.") and "running_" in k]
    assert all(torch.equal(now[k], before[k]) for k in stats) == freeze


def test_init_with_a_pretrained_encoder_matches_jax():
    """``init_oscd_train_state`` with a pretrained encoder and its BatchNorm
    state: the encoder is the given one, the decoder the seed's, as JAX's
    ``init_oscd_train_state(key, cfg, params, bn_state)`` builds it."""
    params, state = jax.device_get(jrn.init_resnet(jax.random.PRNGKey(5), jrn.resnet_test()))
    state = jax.tree_util.tree_map(lambda v: np.full(v.shape, 0.3, np.float32), state)
    jcfg = jtr.OSCDConfig(model=jsiam.SiameseConfig(arch="resnet_test"))
    jstate = jax.device_get(jtr.init_oscd_train_state(jax.random.PRNGKey(0), jcfg, params, state))
    enc = {k: torch.from_numpy(np.array(v)) for k, v in
           jexport.resnet_state_dict(params, state).items()}
    tstate = ttr.init_oscd_train_state(ttr.OSCDConfig(model=tsiam.SiameseConfig(
        arch="resnet_test")), seed=0, pretrained_encoder=enc)
    ref = siamese_state_dict(jstate.params, jstate.bn_state)
    now = tstate.model.state_dict()
    for k, v in enc.items():
        assert torch.equal(now["encoder." + k], v.to(now["encoder." + k].dtype)), k
        np.testing.assert_array_equal(now["encoder." + k].numpy(), ref["encoder." + k])
    assert tstate.step == 0 and all(int(c) == 0 for c in tstate.opt_state["count"].values())


def test_exponential_lr_is_the_jax_schedule():
    for epoch in range(5):
        assert ttr.exponential_lr(1e-3, epoch) == jtr.exponential_lr(1e-3, epoch)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _write_cities(root, layout):
    """Two cities of seeded PNGs, 200 x 150: ``layout`` 'dirs'
    (imgs_1 / imgs_2 / cm) or 'files' (t1.png / t2.png / cm.png)."""
    for ci, city in enumerate(["beirut", "brasilia"]):
        d = root / city
        rng = np.random.default_rng(30 + ci)
        imgs = [rng.integers(0, 256, (200, 150, 3), dtype=np.uint8) for _ in range(2)]
        cm = ((rng.uniform(size=(200, 150)) > 0.7) * 255).astype(np.uint8)
        if layout == "dirs":
            for sub, arr in (("imgs_1", imgs[0]), ("imgs_2", imgs[1]), ("cm", cm)):
                (d / sub).mkdir(parents=True)
                Image.fromarray(arr).save(d / sub / f"{city}.png")
        else:
            d.mkdir(parents=True)
            for name, arr in (("t1.png", imgs[0]), ("t2.png", imgs[1]), ("cm.png", cm)):
                Image.fromarray(arr).save(d / name)
    (root / "notes.txt").write_text("not a city")
    (root / "empty_city").mkdir()


@pytest.mark.parametrize("layout", ["dirs", "files"])
@pytest.mark.parametrize("tile,cities", [(96, None), (64, ["brasilia"])])
def test_oscd_tiles_equal_jax(tmp_path, layout, tile, cities):
    _write_cities(tmp_path, layout)
    ref = joscd.OSCDTiles(str(tmp_path), tile, cities)
    ours = toscd.OSCDTiles(str(tmp_path), tile, cities)
    assert ours.samples == ref.samples
    assert len(ours) == (2 if tile == 96 else 1) * (2 if tile == 96 else 6)
    items = [ours[i] for i in range(len(ours))]
    for i, item in enumerate(items):
        for a, b in zip(item, ref[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(toscd.collate_pairs(items), joscd.collate_pairs([ref[i] for i in range(len(ref))])):
        np.testing.assert_array_equal(a, b)
    assert toscd.TRAIN_CITIES == joscd.TRAIN_CITIES and toscd.TEST_CITIES == joscd.TEST_CITIES


def test_iter_index_batches_covers_every_sample():
    """The JAX package's own cases (tests/test_cli_smoke.py), then the
    chunks of both functions on shuffled orders."""
    from dinomc_tpu.cli.oscd import iter_index_batches as jax_batches

    chunks = list(cli.iter_index_batches(np.arange(23), 8, 4, False, 0, trim=False))
    assert [len(c) for c in chunks] == [8, 8, 7]
    assert sorted(np.concatenate(chunks).tolist()) == list(range(23))
    chunks = list(cli.iter_index_batches(np.arange(23), 8, 4, False, 0, trim=True))
    assert [len(c) for c in chunks] == [8, 8]
    chunks = list(cli.iter_index_batches(np.arange(6), 8, 4, False, 0, trim=True))
    assert [len(c) for c in chunks] == [4]
    for args in ((np.arange(31), 8, 1, True, 3, False), (np.arange(31), 8, 1, True, 3, True),
                 (np.arange(5, 40), 6, 4, True, 1, True), (np.arange(2), 32, 1, False, 0, True)):
        ours, ref = list(cli.iter_index_batches(*args)), list(jax_batches(*args))
        assert len(ours) == len(ref) and all(np.array_equal(a, b) for a, b in zip(ours, ref))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _args(**overrides):
    args = cli.get_args_parser().parse_args(["--device", "cpu"])
    for k, v in overrides.items():
        assert hasattr(args, k), k
        setattr(args, k, v)
    return args


def test_oscd_cli(tmp_path):
    """The port-side twin of ``test_oscd_cli``."""
    out = cli.run(_args(epochs=1, max_steps=2, batch_size=4, output_dir=str(tmp_path),
                        print_freq=1, panel_samples=3))
    assert 0.0 <= out.best_f1 <= 100.0
    assert len(out.losses) == 2 and all(np.isfinite(out.losses))
    # per-epoch (img1|img2|gt|pred) panels, reference main_oscd.py:54-78
    panels = sorted((tmp_path / "panels" / "epoch_000").glob("*.png"))
    assert len(panels) == 3
    assert all(p.stat().st_size > 0 for p in panels)
    assert np.asarray(Image.open(panels[0])).shape == (96 + 4, 4 * 98 + 2, 3)


def test_oscd_cli_city_split(tmp_path, capsys):
    """The port-side twin of ``test_oscd_cli_city_split``: beirut and paris
    train, brasilia validates."""
    root = tmp_path / "oscd"
    for ci, city in enumerate(["beirut", "paris", "brasilia"]):
        d = root / city
        d.mkdir(parents=True)
        rng = np.random.default_rng(40 + ci)
        for name in ["t1.png", "t2.png", "cm.png"]:
            arr = (rng.random((192, 192, 3)) * 255).astype(np.uint8)
            if name == "cm.png":
                arr = (arr[..., 0] > 128).astype(np.uint8) * 255
            Image.fromarray(arr).save(d / name)
    out = cli.run(_args(data_path=str(root), epochs=1, max_steps=1, batch_size=2,
                        output_dir=str(tmp_path / "out")))
    assert out.best_f1 == out.best_f1 and len(out.losses) == 1
    assert "city split: 8 train / 4 val tiles" in capsys.readouterr().out


def test_oscd_cli_frozen_then_resumed_then_trained(tmp_path, capsys):
    """Frozen: the encoder (parameters and running statistics) stays
    bit-identical and the decoder moves; a rerun resumes from the best
    checkpoint; with the encoder trained its statistics move twice a step."""
    common = dict(batch_size=4, print_freq=1, panel_samples=0)
    args = _args(epochs=2, max_steps=2, output_dir=str(tmp_path / "frozen"), **common)
    args.backbone = "resnet_test"  # parsed flags keep the JAX CLI's choices
    first = cli.run(args)
    init = ttr.init_oscd_train_state(ttr.OSCDConfig(model=tsiam.SiameseConfig(
        arch="resnet_test")), seed=args.seed).model.state_dict()
    now = first.state.model.state_dict()
    assert all(torch.equal(now[k], init[k]) for k in now if k.startswith("encoder."))
    assert not all(torch.equal(now[k], init[k]) for k in now if not k.startswith("encoder."))
    assert [r["step"] for r in first.epochs] == [2]  # both steps in epoch 0

    again = cli.run(args)
    assert "resumed from checkpoint at epoch 0" in capsys.readouterr().out
    assert again.start_epoch == 1 and again.best_f1 >= first.best_f1
    saved = CheckpointManager(str(tmp_path / "frozen" / "checkpoints"))
    assert saved.metrics() and max(saved.metrics().values()) == again.best_f1

    args = _args(epochs=1, max_steps=2, output_dir=str(tmp_path / "trained"),
                 freeze_encoder=False, **common)
    args.backbone = "resnet_test"
    out = cli.run(args)
    now = out.state.model.state_dict()
    tracked = {int(v) for k, v in now.items() if k.endswith("num_batches_tracked")
               and k.startswith("encoder.")}
    assert tracked == {4}  # 2 steps, t1 and t2 each
    assert not all(torch.equal(now[k], init[k]) for k in now
                   if k.startswith("encoder.") and "num_batches" not in k)


def test_oscd_cli_loads_a_reference_resnet_teacher(tmp_path):
    """``--pretrained_weights``: a DINO teacher's torchvision-layout ResNet
    (``backbone.`` prefixed, BatchNorm statistics drawn) lands in the
    encoder; a JAX orbax directory raises with the routes to a .pth."""
    params, state = jax.device_get(jrn.init_resnet(jax.random.PRNGKey(7), jrn.resnet_test()))
    state = jax.tree_util.tree_map(lambda v: np.full(v.shape, 0.7, np.float32), state)
    sd = jexport.resnet_state_dict(params, state, "backbone.")
    path = tmp_path / "teacher.pth"
    torch.save({"teacher": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    args = _args(epochs=1, max_steps=1, batch_size=4, output_dir=str(tmp_path / "out"),
                 pretrained_weights=str(path), panel_samples=0)
    args.backbone = "resnet_test"
    out = cli.run(args)
    enc = out.state.model.encoder.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(enc[k[len("backbone."):]].numpy(),
                                      np.asarray(v).astype(enc[k[len("backbone."):]].numpy().dtype))
    (tmp_path / "orbax" / "3").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="cli.convert_ckpt"):
        cli.run(_args(pretrained_weights=str(tmp_path / "orbax"), output_dir=str(tmp_path / "o2")))
