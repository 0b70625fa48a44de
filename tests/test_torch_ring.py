"""Sequence parallelism of the port: ring attention (``ops/ring_attention``,
``ops/attention.mha(impl='ring')``), ``models/vit.vit_forward_sp`` and the
UPerNet backbone over ``seq`` ranks, on gloo CPU process groups of 2 and 4
(tests/_torch_mp.py), against the JAX package.

Bounds are tests/test_sp.py's: ring attention and its q/k/v gradients
against JAX ``ring_attention`` under ``shard_map`` on as many virtual
devices, rtol/atol 1e-5, with every key real and with the last 40% masked
(``n_valid``); ``vit_forward_sp`` against JAX ``vit_forward_sp`` (CLS and
taps) 2e-5, also with the batch split over a data axis (world 4 = data 2 x
seq 2); its gradients rtol 5e-4, atol 5e-5 against the gradients of JAX's
unsharded ``vit_forward`` (what tests/test_sp.py holds JAX's own
sequence-parallel gradients to; it spares compiling JAX's ring backward
through a ViT); the UPerNet logits 0.05. The ViTs are tests/test_sp.py's
``vit_tiny`` at patch 16, 64 px (17 tokens: padded to 18 over 2 ranks, 20
over 4), in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dinomc_tpu.ckpt.torch_export import vit_state_dict
from dinomc_tpu.core.mesh import make_mesh
from dinomc_tpu.models import upernet as jup
from dinomc_tpu.models import vit as jvit
from dinomc_tpu.ops.ring_attention import ring_attention as jring
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.models import upernet as tup
from dinomc_tpu_torch.models import vit as tvit
from _torch_mp import start_ranks
from _torch_port import n, one_torch_thread  # noqa: F401

B, N, H, D = 2, 64, 3, 8
TAPS = (3, 7, 11)
GRADS = [f"blocks.{i}.attn.qkv.weight" for i in range(12)] + ["patch_embed.proj.weight"]


def _qkvw(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((B, N, H, D)).astype(np.float32) for k in "qkvw"}


def _n_valid(frac):
    return None if frac == 1.0 else int(N * frac)


def _jax_ring(world, arrays, n_valid):
    """JAX ring attention on ``world`` virtual devices, and the gradients
    of sum(out * w)."""
    mesh = make_mesh(jax.devices()[:world], data=1, seq=world, model=1)
    f = jax.shard_map(lambda q, k, v: jring(q, k, v, axis_name="seq", n_valid=n_valid),
                      mesh=mesh, in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
                      check_vma=False)
    q, k, v, w = (jnp.asarray(arrays[x]) for x in "qkvw")
    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w), argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _vit_cfgs():
    kw = dict(patch_size=16, img_size=64, drop_path_rate=0.0)
    return (jvit.vit_tiny(compute_dtype=jnp.float32, **kw),
            tvit.vit_tiny(compute_dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg = _vit_cfgs()
    params = jax.device_get(jvit.init_vit(jax.random.PRNGKey(0), jcfg))
    port = tvit.VisionTransformer(tcfg)
    load_jax_params(port, params)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (2, 64, 64, 3)), np.float32)

    ucfg_j = jup.UPerNetConfig(num_classes=6, arch="vit_tiny", patch_size=8,
                               compute_dtype=jnp.float32)
    ucfg_t = tup.UPerNetConfig(num_classes=6, arch="vit_tiny", patch_size=8,
                               compute_dtype=torch.float32)
    uparams, ustate = jax.device_get(jup.init_upernet(jax.random.PRNGKey(3), ucfg_j))
    umodel = tup.UPerNet(ucfg_t)
    load_jax_params(umodel, (uparams, ustate))
    ux = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (1, 64, 64, 3)), np.float32)

    vit_case = dict(kind="vit_sp", arch="vit_tiny", weights=port.state_dict(), x=x,
                    cfg={k: v for k, v in dataclasses.asdict(tcfg).items()
                         if k in ("patch_size", "img_size", "drop_path_rate", "compute_dtype")},
                    out_indices=TAPS, grad_names=GRADS)
    rings = {f"ring{frac}": dict(kind="ring", n_valid=_n_valid(frac), **_qkvw(7))
             for frac in (1.0, 0.6)}
    tmp = tmp_path_factory.mktemp("ring")
    groups = {
        2: start_ranks(2, dict(rings, vit=dict(vit_case, seq=2),
                               upernet=dict(kind="upernet_sp", seq=2, x=ux,
                                            cfg=dataclasses.asdict(ucfg_t),
                                            weights=umodel.state_dict())), tmp),
        4: start_ranks(4, dict(rings, vit=dict(vit_case, seq=2)), tmp),
    }

    refs = {}
    for world in (2, 4):
        for frac in (1.0, 0.6):
            refs[world, frac] = _jax_ring(world, _qkvw(7), _n_valid(frac))
    xj = jnp.asarray(x)
    for world, data in ((2, 1), (4, 2)):
        mesh = make_mesh(jax.devices()[:world], data=data, seq=2, model=1)
        axis = "data" if data > 1 else None
        refs["vit", world] = (
            np.asarray(jvit.vit_forward_sp(params, xj, jcfg, mesh, batch_axis=axis)),
            np.asarray(jvit.vit_forward_sp(params, xj, jcfg, mesh, out_indices=TAPS,
                                           batch_axis=axis)))
    g = jax.grad(lambda p: jnp.sum(jvit.vit_forward(p, xj, jcfg) ** 2))(params)
    refs["grads"] = vit_state_dict(jax.device_get(g))
    refs["upernet"] = np.asarray(
        jup.upernet_forward(uparams, ustate, jnp.asarray(ux), ucfg_j)[0])
    return refs, {w: grp.results() for w, grp in groups.items()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("frac", [1.0, 0.6])
def test_ring_attention_matches_jax(runs, world, frac):
    """Each rank's output and q/k/v gradient blocks, put together, against
    JAX's ring on ``world`` devices (the hop's backward sends the K/V
    gradients back around the ring)."""
    refs, results = runs
    out_ref, grads_ref = refs[world, frac]
    res = [r[f"ring{frac}"] for r in results[world]]
    cat = lambda key: np.concatenate([n(r[key]) for r in res], axis=1)  # noqa: E731
    np.testing.assert_allclose(cat("out"), out_ref, rtol=1e-5, atol=1e-5)
    for key, ref in zip(("dq", "dk", "dv"), grads_ref):
        np.testing.assert_allclose(cat(key), ref, rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_vit_forward_sp_matches_jax(runs, world):
    """The CLS output and the (3, 7, 11) taps on every rank, against JAX
    ``vit_forward_sp`` on as many devices: world 2 splits the tokens over 2
    ranks; world 4 also splits the batch of 2 over a data axis of 2."""
    refs, results = runs
    cls_ref, taps_ref = refs["vit", world]
    for r in results[world]:
        np.testing.assert_allclose(n(r["vit"]["cls"]), cls_ref, rtol=2e-5, atol=2e-5)
        assert tuple(r["vit"]["taps"].shape) == taps_ref.shape == (3, 2, 17, 192)
        np.testing.assert_allclose(n(r["vit"]["taps"]), taps_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_vit_forward_sp_grads_match_jax(runs, world):
    """Gradients of sum(cls ** 2) through the gathers and the ring (each
    rank's cover its token and batch blocks; summed over the ranks over the
    world size): every block's qkv weight and the patch embedding."""
    refs, results = runs
    for name in GRADS:
        np.testing.assert_allclose(n(results[world][0]["vit"]["grads"][name]),
                                   refs["grads"][name], rtol=5e-4, atol=5e-5, err_msg=name)


def test_upernet_seq_parallel_logits_match_jax(runs):
    """UPerNet eval logits with the ViT backbone over 2 seq ranks (65 tokens
    padded to 66) against JAX's single-program forward, as
    tests/test_sp.py::test_upernet_seq_parallel_backbone bounds them."""
    refs, results = runs
    for r in results[2]:
        out = n(r["upernet"]["logits"])
        assert out.shape == refs["upernet"].shape == (1, 64, 64, 6)
        np.testing.assert_allclose(out, refs["upernet"], rtol=0.05, atol=0.05)
