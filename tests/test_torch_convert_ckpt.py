"""The port's checkpoint converter against the JAX package's writers.

The chain on the port's side: a JAX train state (initialized in JAX, the
teacher, the BatchNorm statistics and the centre then moved off the init so
every tensor is told apart) -> ``ckpt/from_jax.load_jax_params`` into the
port's train state -> ``ckpt/checkpoint.CheckpointManager.save`` ->
``cli.convert_ckpt.run``. The oracle: the JAX package's writers
(``dinomc_tpu.ckpt.torch_export.export_*``) on the same trees. The two
files must be equal: the same keys at every level, and each tensor of the
same shape, dtype and value (exact). Covered: ViT-tiny, ``resnet_test``
(BatchNorm state; written under ``--arch resnet50``, as the JAX writers
take no other ResNet name) and Swin-T at full width (the JAX ``SwinConfig``
has no depth knob; a conversion runs no forward pass), for every ``--what``.
``--what auto`` is held to the JAX CLI itself, run on an orbax save of the
same JAX state.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dinomc_tpu.ckpt import torch_export as jexp
from dinomc_tpu.ckpt.orbax_io import save_pytree
from dinomc_tpu.cli import convert_ckpt as jcli
from dinomc_tpu.models import upernet as jup
from dinomc_tpu.train import cls_trainer as jcls
from dinomc_tpu.train import dino_trainer as jdino
from dinomc_tpu.train import seg_trainer as jseg
from dinomc_tpu_torch.ckpt import torch_export as tex
from dinomc_tpu_torch.ckpt import torch_import as timport
from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.cli import convert_ckpt as tcli
from dinomc_tpu_torch.models import upernet as tup
from dinomc_tpu_torch.train import cls_trainer as tcls
from dinomc_tpu_torch.train import dino_trainer as tdino
from dinomc_tpu_torch.train import seg_trainer as tseg
from _torch_port import one_torch_thread  # noqa: F401

STEP = 7
# family -> (the configs' arch, the writers' --arch, config fields)
ARCHS = {
    "vit": ("vit_tiny", "vit_tiny", dict(patch_size=16)),
    "resnet": ("resnet_test", "resnet50", {}),
    "swin": ("swin_t", "swin_t", {}),
}


def _moved(tree, seed, scale=0.01):
    """``tree`` with every leaf moved by seeded noise: off the init, and
    told apart from the tree it was copied from."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        return a + scale * rng.standard_normal(a.shape).astype(a.dtype)

    return jax.tree_util.tree_map(move, jax.device_get(tree))


def _stats(tree, seed):
    """BatchNorm statistics drawn positive, so a lost buffer shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), jax.device_get(tree))


def _port(kind, tstate, jstate, root):
    """The JAX state loaded into the port's state and saved by the port's
    CheckpointManager at ``STEP``; returns the directory."""
    load_jax_params(tstate, jstate)
    d = root / f"port_{kind}"
    CheckpointManager(str(d)).save(tstate.step, tstate)
    return d


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    """Per family: the JAX DINO and classification states and the port's
    checkpoint directories of both; ViT also a seg state."""
    root = tmp_path_factory.mktemp("convert")
    out = {}
    for fam, (arch, _, extra) in ARCHS.items():
        common = dict(arch=arch, out_dim=32, **extra)
        jcfg = jdino.DinoConfig(**common)
        js = jdino.init_dino_train_state(jax.random.PRNGKey(0), jcfg)
        js = js.replace(step=np.int32(STEP), teacher=_moved(js.teacher, 1),
                        student_state=_stats(js.student_state, 2),
                        teacher_state=_stats(js.teacher_state, 3),
                        center=np.random.default_rng(4).standard_normal(32).astype(np.float32))
        dino_dir = _port("dino", tdino.init_dino_train_state(tdino.DinoConfig(**common)), js,
                         root / fam)

        ccommon = dict(arch=arch, num_classes=5, **extra)
        jc = jcls.init_cls_train_state(jax.random.PRNGKey(5), jcls.ClsConfig(**ccommon))
        jc = jc.replace(step=np.int32(STEP), params=_moved(jc.params, 6),
                        bn_state=_stats(jc.bn_state, 7))
        cls_dir = _port("cls", tcls.init_cls_train_state(tcls.ClsConfig(**ccommon)), jc, root / fam)
        out[fam] = dict(dino=(js, dino_dir), cls=(jc, cls_dir))

    ucommon = dict(num_classes=5, arch="vit_tiny", patch_size=16, channels=32, aux_channels=16)
    jsg = jseg.init_seg_train_state(jax.random.PRNGKey(8),
                                    jseg.SegConfig(model=jup.UPerNetConfig(**ucommon)))
    jsg = jsg.replace(step=np.int32(STEP), bn_state=_stats(jsg.bn_state, 9))
    seg_dir = _port("seg", tseg.init_seg_train_state(
        tseg.SegConfig(model=tup.UPerNetConfig(**ucommon))), jsg, root / "vit")
    out["vit"]["seg"] = (jsg, seg_dir)
    return out


def _assert_same(ours, ref, where="file"):
    """Equal nested dicts: the same keys, tensors equal in shape, dtype and
    value, everything else equal."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), \
            f"{where}: {set(ours) ^ set(ref) if isinstance(ours, dict) else type(ours)}"
        for k in ref:
            _assert_same(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, torch.Tensor):
        assert isinstance(ours, torch.Tensor), where
        assert (ours.shape, ours.dtype) == (ref.shape, ref.dtype), \
            f"{where}: {ours.shape} {ours.dtype} vs {ref.shape} {ref.dtype}"
        assert torch.equal(ours, ref), where
    else:
        assert ours == ref, f"{where}: {ours!r} vs {ref!r}"


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _convert(ckpt, out, *flags):
    args = tcli.get_args_parser().parse_args(["--ckpt", str(ckpt), "--out", str(out), *flags])
    return tcli.run(args)


def _bn(tree):
    return tree or None


# (family, what is converted, extra flags): "cls-backbone" / "seg-backbone"
# are --what backbone on a classification / seg state
CASES = [
    (fam, what, flags) for fam in ARCHS for what, flags in (
        ("dino", ()), ("backbone", ("--source", "teacher")),
        ("backbone", ("--source", "student", "--checkpoint_key", "none")),
        ("cls", ()), ("cls-backbone", ()))
] + [("vit", "seg", ()), ("vit", "seg-backbone", ())]


@pytest.mark.parametrize("fam,what,flags", CASES,
                         ids=[f"{f}-{w}{'-' + '-'.join(x) if x else ''}" for f, w, x in CASES])
def test_convert_matches_the_jax_writers(states, tmp_path, fam, what, flags):
    arch = ARCHS[fam][1]
    ref, ours = tmp_path / "ref.pth", tmp_path / "ours.pth"
    flag = dict(zip(flags[::2], flags[1::2]))
    if what == "dino":
        js, d = states[fam]["dino"]
        jexp.export_dino_checkpoint(str(ref), arch, student=js.student, teacher=js.teacher,
                                    student_state=_bn(js.student_state),
                                    teacher_state=_bn(js.teacher_state), epoch=STEP,
                                    center=js.center)
    elif what == "backbone":
        js, d = states[fam]["dino"]
        src = flag["--source"]
        key = flag.get("--checkpoint_key", "teacher")
        jexp.export_backbone(str(ref), arch, getattr(js, src)["backbone"],
                             _bn(getattr(js, f"{src}_state")),
                             checkpoint_key=None if key == "none" else key)
    elif what == "cls":
        jc, d = states[fam]["cls"]
        jexp.export_cls_checkpoint(str(ref), arch, jax.device_get(jc.params), _bn(jc.bn_state),
                                   epoch=STEP)
    elif what == "cls-backbone":
        jc, d = states[fam]["cls"]
        jexp.export_backbone(str(ref), arch, jax.device_get(jc.params["backbone"]),
                             _bn(jc.bn_state))
    elif what == "seg":
        jsg, d = states[fam]["seg"]
        jexp.export_seg_checkpoint(str(ref), jax.device_get(jsg.params),
                                   jax.device_get(jsg.bn_state), epoch=STEP)
    else:  # seg-backbone
        jsg, d = states[fam]["seg"]
        jexp.export_backbone(str(ref), arch, jax.device_get(jsg.params["backbone"]), None)
    what_flag = what.split("-")[-1] if "-" in what else what
    assert _convert(d, ours, "--arch", arch, "--what", what_flag, *flags) == str(ours)
    _assert_same(_load(ours), _load(ref))


@pytest.mark.parametrize("fam,kind", [("vit", "dino"), ("resnet", "cls"), ("vit", "seg")])
def test_auto_picks_what_the_jax_cli_picks(states, tmp_path, fam, kind):
    """``--what auto`` on the port's save and the JAX CLI's ``--what auto``
    on an orbax save of the same JAX state write equal files."""
    jstate, d = states[fam][kind]
    save_pytree(str(tmp_path / "orbax" / str(STEP)), jax.device_get(jstate))
    ref, ours = tmp_path / "ref.pth", tmp_path / "ours.pth"
    arch = ARCHS[fam][1]
    jcli.run(jcli.get_args_parser().parse_args(
        ["--ckpt", str(tmp_path / "orbax"), "--arch", arch, "--out", str(ref)]))
    _convert(d, ours, "--arch", arch)
    assert tcli.kind_of(_load(next(d.glob("ckpt_*.pth")))) == kind
    _assert_same(_load(ours), _load(ref))


def test_step_and_file_selection(tmp_path):
    """The newest ``ckpt_<step>.pth`` by default, ``--step`` picks another,
    one file works as ``--ckpt``, and a missing step is named."""
    cfg = tdino.DinoConfig(arch="vit_test", patch_size=4, out_dim=8, global_crop_size=16)
    st = tdino.init_dino_train_state(cfg)
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=3)
    for step in (1, 2):
        st.step = step
        with torch.no_grad():
            st.teacher["backbone"].cls_token.fill_(float(step))
        mgr.save(step, st)
    for flags, want in (((), 2.0), (("--step", "1"), 1.0)):
        _convert(tmp_path / "c", tmp_path / "o.pth", "--arch", "vit_test", "--what", "backbone",
                 *flags)
        assert float(_load(tmp_path / "o.pth")["teacher"]["cls_token"].flatten()[0]) == want
    _convert(mgr.path(1), tmp_path / "f.pth", "--arch", "vit_test")
    assert _load(tmp_path / "f.pth")["epoch"] == 1
    with pytest.raises(FileNotFoundError, match="step 5"):
        _convert(tmp_path / "c", tmp_path / "o.pth", "--step", "5", "--arch", "vit_test")


def test_the_converted_files_load_into_the_port(states, tmp_path):
    """What the converter writes, the port's importers read back bit for
    bit: a DINO teacher into a ViT, a classifier, a UPerNet."""
    js, d = states["vit"]["dino"]
    _convert(d, tmp_path / "dino.pth", "--arch", "vit_tiny")
    saved = _load(next(d.glob("ckpt_*.pth")))
    vit = tdino.DinoConfig(arch="vit_tiny", patch_size=16).encoder(False).build(None)
    timport.load_backbone(vit, str(tmp_path / "dino.pth"), "teacher")
    for k, v in vit.state_dict().items():
        assert torch.equal(v, saved["teacher"][f"backbone.{k}"]), k

    jc, d = states["resnet"]["cls"]
    _convert(d, tmp_path / "cls.pth", "--arch", "resnet50")
    model = tcls.init_cls_train_state(tcls.ClsConfig(arch="resnet_test", num_classes=5),
                                      seed=9).model
    timport.load_cls_checkpoint(model, str(tmp_path / "cls.pth"))
    saved = _load(next(d.glob("ckpt_*.pth")))["model"]
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, saved[k]), k

    jsg, d = states["vit"]["seg"]
    _convert(d, tmp_path / "seg.pth", "--what", "seg")
    sd = timport.read_upernet_state_dict(str(tmp_path / "seg.pth"))
    saved = _load(next(d.glob("ckpt_*.pth")))["model"]
    assert set(sd) == set(saved) and all(torch.equal(sd[k], saved[k]) for k in sd)


def test_refusals(states, tmp_path):
    """XCiT has no reference layout in either package; an orbax directory
    names the JAX CLI; a kind that the state is not, a wrong ``--arch`` and
    a BatchNorm-in-head DINO file are refused."""
    for mod in (tex, jexp):
        with pytest.raises(ValueError, match="no torch exporter for arch 'xcit_small_12'"):
            mod.backbone_state_dict_for_arch("xcit_small_12", {})
    js, d = states["vit"]["dino"]
    with pytest.raises(ValueError, match="no torch exporter"):
        _convert(d, tmp_path / "x.pth", "--arch", "xcit_small_12", "--what", "backbone")
    with pytest.raises(ValueError, match="not a resnet50 backbone"):
        _convert(d, tmp_path / "x.pth", "--arch", "resnet50", "--what", "backbone")
    with pytest.raises(ValueError, match="not a classification train state"):
        _convert(d, tmp_path / "x.pth", "--what", "cls")
    save_pytree(str(tmp_path / "orbax" / "3"), {"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match=r"python -m dinomc_tpu\.cli\.convert_ckpt"):
        _convert(tmp_path / "orbax", tmp_path / "x.pth")
    cfg = dataclasses.replace(tdino.DinoConfig(arch="vit_test", patch_size=4, out_dim=8,
                                               global_crop_size=16), use_bn_in_head=True)
    CheckpointManager(str(tmp_path / "bn")).save(0, tdino.init_dino_train_state(cfg))
    with pytest.raises(ValueError, match="BN-in-head"):
        _convert(tmp_path / "bn", tmp_path / "x.pth", "--arch", "vit_test")
