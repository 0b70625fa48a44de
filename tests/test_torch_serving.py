"""Serving export (``ckpt/export.py``) and the profiling hooks
(``utils/profiling.py``) of the port.

An exported program is saved, loaded and called: its output must equal the
eager port model's on the same input (exact: on the CPU the ``dinomc_torch``
ops run the kernels' plain versions, the ops the eager path runs), and the
JAX package's ``seg_predict`` / ``cls_predict`` on the same weights to
tests/test_torch_upernet.py's and tests/test_torch_cls.py's bounds (1e-4 on
seg logits, 1e-5 on cls logits, f32). The graph must name the custom op of
each kernel the path reaches. ``export_fn`` round-trips a function within
1e-6. The profiling functions are checked on the CPU as
tests/test_aux_utils.py checks the JAX ones.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.models import upernet as jup
from dinomc_tpu.train import cls_trainer as jcls
from dinomc_tpu.train import seg_trainer as jseg
from dinomc_tpu_torch.ckpt import export as ex
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.models import swin as tsw
from dinomc_tpu_torch.models import upernet as tup
from dinomc_tpu_torch.ops.hopper import _build
from dinomc_tpu_torch.ops.hopper import window_attention as hw
from dinomc_tpu_torch.train import cls_trainer as tcls
from dinomc_tpu_torch.train import seg_trainer as tseg
from dinomc_tpu_torch.utils import profiling
from _torch_port import n, one_torch_thread, t  # noqa: F401


def _ops(program) -> set:
    """The ``dinomc_torch`` ops a loaded program's graph calls."""
    return {str(nd.target).split(".")[1] for nd in program.graph.nodes
            if str(nd.target).startswith("dinomc_torch.")}


def test_export_fn_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    w, b = t(rng.standard_normal((8, 4))), t(rng.standard_normal(4))
    size = ex.export_fn(lambda x: torch.tanh(x @ w) + b, (torch.zeros(3, 8),),
                        str(tmp_path / "fn.pt2"))
    assert size == os.path.getsize(tmp_path / "fn.pt2") > 0
    fn = ex.load_exported(str(tmp_path / "fn.pt2"))
    x = t(rng.standard_normal((3, 8)))
    np.testing.assert_allclose(n(fn(x)), n(torch.tanh(x @ w) + b), atol=1e-6, rtol=0)
    assert not _ops(fn)


# (arch, patch, size, the op its attention takes): 32 px is K1's route;
# 132 px at patch 4 is 1090 tokens, padded past 1024, K4's
SEG_CASES = [("vit_tiny", 8, 32, "attention_fwd"), ("vit_test", 4, 132, "long_attention_fwd")]


@pytest.mark.parametrize("arch,patch,size,op", SEG_CASES, ids=["k1", "k4"])
def test_export_seg_model(tmp_path, arch, patch, size, op):
    common = dict(num_classes=5, arch=arch, patch_size=patch, channels=32, aux_channels=16,
                  out_indices=(0, 1, 2, 2) if arch == "vit_test" else (3, 5, 7, 11))
    jcfg = jseg.SegConfig(model=jup.UPerNetConfig(**common, compute_dtype=jnp.float32))
    jstate = jseg.init_seg_train_state(jax.random.PRNGKey(0), jcfg)
    state = tseg.init_seg_train_state(tseg.SegConfig(model=tup.UPerNetConfig(
        **common, compute_dtype=torch.float32)))
    load_jax_params(state, jax.device_get(jstate))
    ex.export_seg_model(state.model, str(tmp_path / "seg.pt2"), image_size=size, batch=2)
    prog = ex.load_exported(str(tmp_path / "seg.pt2"))
    assert _ops(prog) == {op}
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    got = prog(t(x))
    assert torch.equal(got, tseg.seg_predict(state.model, t(x)))
    ref = np.asarray(jseg.seg_predict(jstate.params, jstate.bn_state, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(n(got), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch,op", [("vit_tiny", "attention_fwd"),
                                     ("swin_t", "window_attention_fwd")])
def test_export_classifier(tmp_path, monkeypatch, arch, op):
    """ViT-tiny at patch 16 and Swin-T (its widths, two blocks a stage, a
    shifted one in each, as tests/test_torch_cls.py runs it) at 224 px."""
    from dinomc_tpu.models import swin as jsw

    if arch == "swin_t":
        for mod in (jsw, tsw):
            monkeypatch.setattr(mod, "swin_t", lambda mod=mod, **kw: mod.SwinConfig(
                depths=(2, 2, 2, 2), **kw))
    common = dict(arch=arch, patch_size=16, num_classes=5, compute_dtype="float32")
    jcfg, tcfg = jcls.ClsConfig(**common), tcls.ClsConfig(**common)
    jstate = jcls.init_cls_train_state(jax.random.PRNGKey(0), jcfg)
    state = tcls.init_cls_train_state(tcfg)
    load_jax_params(state, jax.device_get(jstate))
    ex.export_classifier(state.model, tcfg, str(tmp_path / "cls.pt2"))
    prog = ex.load_exported(str(tmp_path / "cls.pt2"))
    assert _ops(prog) == {op}
    x = np.random.default_rng(2).standard_normal((1, 224, 224, 3)).astype(np.float32)
    got = prog(t(x))
    assert got.shape == (1, 5) and torch.equal(got, tcls.cls_predict(state.model, t(x), tcfg))
    ref = np.asarray(jcls.cls_predict(jstate.params, jstate.bn_state, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(n(got), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_the_fused_mlp_and_stacked_window_ops(tmp_path):
    """K11 (``mlp_impl='fused'``) and K9 (``variant='stacked'``) are in the
    graph of a function that reaches them, and the loaded program gives the
    eager outputs."""
    cfg = tcls.ClsConfig(arch="vit_test", patch_size=4, num_classes=3, compute_dtype="float32")
    model = tcls.init_cls_train_state(cfg).model
    model["backbone"].cfg = dataclasses.replace(model["backbone"].cfg, mlp_impl="fused")
    ex.export_classifier(model, cfg, str(tmp_path / "mlp.pt2"), image_size=16)
    prog = ex.load_exported(str(tmp_path / "mlp.pt2"))
    assert _ops(prog) == {"attention_fwd", "fused_mlp"}
    x = t(np.random.default_rng(3).standard_normal((1, 16, 16, 3)))
    assert torch.equal(prog(x), tcls.cls_predict(model, x, cfg))

    rng = np.random.default_rng(4)
    q, k, v = (t(rng.standard_normal((8, 49, 64))) for _ in range(3))
    bias = t(rng.standard_normal((2, 49, 49)))
    mask = t(np.where(rng.uniform(size=(4, 49, 49)) < 0.2, -100.0, 0.0))
    ex.export_fn(lambda q, k, v: hw.window_attention(q, k, v, bias, mask, 2, variant="stacked"),
                 (q, k, v), str(tmp_path / "win.pt2"))
    prog = ex.load_exported(str(tmp_path / "win.pt2"))
    assert _ops(prog) == {"window_attention_stacked_fwd"}
    assert torch.equal(prog(q, k, v), hw.window_attention_reference(q, k, v, bias, mask, 2))


def test_the_training_path_takes_no_custom_op():
    """Outside an export's trace the dispatchers call their autograd
    Functions: the routing is off and is restored after a trace."""
    assert not _build.ops_routed()
    with _build.route_ops():
        assert _build.ops_routed()
    assert not _build.ops_routed()


def test_profiling_step_timer_and_sync():
    x = torch.ones(8, 8)
    profiling.sync(x)  # must not raise
    profiling.sync({"a": [1, (x,)]})
    timer = profiling.StepTimer(sync_every=2)
    assert timer.step(x) is None
    ms = timer.step(x)
    assert ms is not None and ms >= 0 and timer.history == [ms]
    stats = profiling.device_memory_stats()
    assert stats == {} if not torch.cuda.is_available() else set(stats) == {"mb_in_use",
                                                                             "mb_limit"}


def test_profiling_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("test-region"):
            _ = torch.ones(4).sum()
    with open(tmp_path / "tr" / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "test-region" in names
    assert any(e.key == "test-region" for e in prof.key_averages())
