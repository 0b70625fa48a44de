"""The port's process-group helpers (``parallel/distributed.py``), its mesh
layout (``core/mesh.py``) and the rank-0 logging pieces, on the CPU: alone,
and over a gloo group of two processes (tests/_torch_mp.py). The layout and
the ZeRO placement rule are held to the JAX package's ``make_mesh`` and
``_fsdp_spec``; the fine-tune CLIs, whose data-parallel path is not ported,
refuse a torchrun launch of several processes.
"""

import builtins

import jax
import numpy as np
import pytest
import torch

from dinomc_tpu.core import mesh as jmesh
from dinomc_tpu_torch.core import mesh as tmesh
from dinomc_tpu_torch.parallel import distributed as pd
from dinomc_tpu_torch.utils.logging import MetricLogger
from _torch_mp import start_ranks
from _torch_port import one_torch_thread  # noqa: F401

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return start_ranks(2, {"host": {"kind": "host"}}, tmp_path_factory.mktemp("host")).results()


def test_init_is_a_no_op_without_torchrun_variables(monkeypatch):
    """No ``RANK`` / ``WORLD_SIZE``: no group, world 1, rank 0, and the mesh
    holds one rank with no group (its collectives are skipped)."""
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert pd.init_distributed_mode("cpu") is False
    assert not pd.is_initialized()
    assert (pd.get_world_size(), pd.get_rank(), pd.is_main_process()) == (1, 0, True)
    assert pd.reduce_dict({"a": 2.0}) == {"a": 2.0}
    mesh = tmesh.make_mesh(model=1)
    assert mesh.shape == {"data": 1, "seq": 1, "model": 1} and not mesh.active
    assert mesh.batch_shard(4) is None and mesh.group("data") is None
    with pytest.raises(ValueError, match="must divide the world size 1"):
        tmesh.make_mesh(model=2)
    x = torch.ones(3)
    assert pd.batch_mean(x) is x and pd.batch_count() == 1


def test_metric_logger_sync_is_a_no_op_alone():
    ml = MetricLogger()
    ml.update(loss=2.0)
    ml.update(loss=4.0)
    ml.synchronize_between_processes()
    assert (ml.meters["loss"].count, ml.meters["loss"].total) == (2, 6.0)


def test_reduce_dict_over_two_ranks(two_ranks):
    """Rank r holds a = 1 + r, b = 10 (r + 1): the sums and means on both."""
    for r in two_ranks:
        assert r["host"]["sum"] == {"a": 3.0, "b": 30.0}
        assert r["host"]["mean"] == {"a": 1.5, "b": 15.0}


def test_metric_logger_sync_sums_count_and_total(two_ranks):
    """Rank r logged r + 1 values r, r + 1, ...: after the sync both hold
    the count 3 and the total 0 + (1 + 2) = 3."""
    for r in two_ranks:
        assert (r["host"]["count"], r["host"]["total"]) == (3, 3.0)


def test_print_is_gated_to_rank_zero(two_ranks):
    """``setup_for_distributed``: rank 0 prints, rank 1 only with
    ``force=True``; ``destroy`` restores the builtin."""
    assert two_ranks[0]["host"]["printed"] == ["gated", "forced"]
    assert two_ranks[1]["host"]["printed"] == ["forced"]
    assert builtins.print is pd._ORIGINAL_PRINT


@pytest.mark.parametrize("shape", [(2, 1, 2), (2, 2, 1), (1, 2, 4), (2, 2, 2), (4, 1, 2)])
def test_rank_layout_is_the_jax_meshs(shape):
    """Rank (d * seq + s) * model + m is the device at (d, s, m) of JAX's
    ``make_mesh`` (its reshape of the device list): the groups along each
    axis are the JAX mesh's device rows along it."""
    world = int(np.prod(shape))
    jm = jmesh.make_mesh(jax.devices()[:world], *shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    ids = ids - ids.min()
    names = dict(shape=dict(zip(tmesh.AXES, shape)))
    for ax, axis in enumerate(tmesh.AXES):
        want = sorted(map(tuple, np.moveaxis(ids, ax, -1).reshape(-1, shape[ax]).tolist()))
        assert sorted(map(tuple, tmesh._axis_groups(names["shape"], axis))) == want, axis


@pytest.mark.parametrize("n_data", [1, 2, 4])
@pytest.mark.parametrize("shape", [(3, 384, 384), (1152, 384), (65536, 256), (2048,),
                                   (100, 163), (64, 64, 4), (12, 8, 8), (7,)])
def test_fsdp_spec_is_jaxs(n_data, shape):
    """The ZeRO rule: the largest dim divisible by the data size (ties to the
    last), whole under 2**14 elements or at data size 1, as JAX
    ``_fsdp_spec`` on a mesh of that data size."""
    jm = jmesh.make_mesh(jax.devices()[:n_data], data=n_data)
    spec = jmesh._fsdp_spec(jm, np.zeros(shape, np.float32))
    want = None
    for d, axis in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis == jmesh.DATA_AXIS:
            want = ("data", d)
    m = tmesh.Mesh({"data": n_data, "seq": 1, "model": 1}, {"data": 0, "seq": 0, "model": 0},
                   {}, False)
    assert tmesh.fsdp_spec(m, shape) == want


@pytest.mark.parametrize("cli", ["eurosat", "bigearthnet", "oscd"])
def test_finetune_clis_refuse_several_processes(cli, tmp_path, monkeypatch):
    """Under torchrun with WORLD_SIZE 2 the fine-tune CLIs would run as
    independent copies: they refuse, naming ROADMAP.md queue 1 #17, before
    they read any data."""
    import importlib

    mod = importlib.import_module(f"dinomc_tpu_torch.cli.{cli}")
    args = mod.get_args_parser().parse_args(["--device", "cpu", "--output_dir", str(tmp_path)])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md queue 1 #17"):
        mod.run(args)
