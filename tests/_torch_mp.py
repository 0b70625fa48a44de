"""Multi-process helpers of the port's distributed tests: a gloo process
group of ``world`` CPU processes, each running this file as a worker.

``start_ranks(world, cases, tmp_path)`` writes the cases (dicts with a
``kind`` and its inputs: numpy arrays, state dicts) to a directory and
starts one worker a rank with torchrun's environment variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``) and a ``file://`` rendezvous in that
directory; its ``results()`` waits, returns each rank's results, a dict
a case, and removes the directory, so a test computes its JAX references
while the ranks run and leaves no gigabytes behind. The workers
import neither JAX nor the JAX package; the tests hold their results
against the JAX package in the test process. One group runs several cases,
since bringing one up costs seconds. A worker that fails, or a group that
outlives ``timeout``, kills every rank and fails the test with the ranks'
output, so a rank stuck in a collective cannot hang the suite.
"""

import hashlib
import os
import shutil
import subprocess
import sys
import time
import uuid
import weakref

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class start_ranks:
    def __init__(self, world, cases, tmp_path, timeout=240):
        self.world = world
        self.dir = d = os.path.join(str(tmp_path), f"mp{world}_{uuid.uuid4().hex[:8]}")
        os.makedirs(d)
        torch.save(cases, os.path.join(d, "cases.pt"))
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), PYTHONPATH=REPO)
        self.procs, self.logs = [], []
        for r in range(world):
            self.logs.append(open(os.path.join(d, f"log{r}.txt"), "w"))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), d],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=self.logs[-1],
                stderr=subprocess.STDOUT, cwd=REPO))
        self.deadline = time.time() + timeout
        self.timeout = timeout
        # a test that fails before ``results`` leaves no rank running
        weakref.finalize(self, _kill, list(self.procs))

    def results(self):
        procs, d = self.procs, self.dir
        try:
            while True:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    break
                failed = any(c not in (None, 0) for c in codes)
                if failed or time.time() > self.deadline:
                    for p in procs:
                        p.kill()
                    for p in procs:
                        p.wait()
                    out = "\n".join(f"--- rank {r} (exit {procs[r].returncode}):\n"
                                    + open(os.path.join(d, f"log{r}.txt")).read()[-4000:]
                                    for r in range(self.world))
                    why = "a rank failed" if failed else f"timed out after {self.timeout} s"
                    raise AssertionError(f"{self.world}-rank group: {why}\n{out}")
                time.sleep(0.05)
        finally:
            for f in self.logs:
                f.close()
        out = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
               for r in range(self.world)]
        shutil.rmtree(d)
        return out


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def digest(t: torch.Tensor) -> str:
    """A tensor's exact bits, as a short string."""
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def rows(x, rank, world, axis=0):
    """Rank ``rank``'s block of ``world`` equal blocks of ``x`` along ``axis``."""
    n = x.shape[axis] // world
    return np.take(x, np.arange(rank * n, (rank + 1) * n), axis=axis)


# ---- worker cases -------------------------------------------------------------


def _dino(c):
    """DINO steps on this rank's rows of each step's global crops, on a
    ``data x model`` mesh, optionally ZeRO; with ``resume_at`` the state is
    checkpointed before that step and restored into a state from another
    seed (placed first, so the restore takes blocks). Every rank returns
    the digests of its final student, teacher and centre; rank 0 also the
    tensors (those named in ``keep``, or all)."""
    from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
    from dinomc_tpu_torch.core.mesh import make_mesh, shard_dino_state
    from dinomc_tpu_torch.parallel import distributed as pd
    from dinomc_tpu_torch.train import dino_trainer as tr

    world, rank = pd.get_world_size(), pd.get_rank()
    cfg = tr.DinoConfig(**c["cfg"])
    model = c.get("model", 1)
    mesh = make_mesh(data=world // model, model=model)

    def fresh(seed, weights=None):
        st = tr.init_dino_train_state(cfg, seed=seed)
        if weights is not None:
            st.student.load_state_dict(weights)
            st.teacher.load_state_dict(weights)
        return shard_dino_state(mesh, st, c.get("fsdp", False))

    state = fresh(0, c["weights"])
    sch = tr.DinoSchedules(**c["schedules"])
    out = {"losses": [], "placements": dict(state.placements),
           "moment_shapes": {n: tuple(t.shape) for n, t in state.opt_state["mu"].items()}}
    for i, crops in enumerate(c["crops"]):
        if c.get("resume_at") == i:
            CheckpointManager(c["ckpt_dir"]).save(state.step, state)
            state = fresh(42)
            assert CheckpointManager(c["ckpt_dir"]).restore(state)
        local = [torch.from_numpy(rows(x, rank, world, axis=x.ndim - 4)) for x in crops]
        m = tr.dino_train_step_accum(state, local[0], tuple(local[1:]), sch, cfg,
                                     accum=c.get("accum", 1))
        out["losses"].append(float(m["loss"]))
    sds = {"student": state.student.state_dict(), "teacher": state.teacher.state_dict()}
    out.update(step=state.step, center=state.center.clone(),
               digests={w: {k: digest(v) for k, v in sd.items()} for w, sd in sds.items()})
    if rank == 0:
        keep = c.get("keep")
        out.update({w: {k: v for k, v in sd.items() if keep is None or k in keep}
                    for w, sd in sds.items()})
    return out


def _ring(c):
    """Ring attention over this rank's token block of q, k, v, and the
    gradients of sum(out * w)."""
    from dinomc_tpu_torch.ops.attention import mha
    from dinomc_tpu_torch.parallel import distributed as pd

    world, rank = pd.get_world_size(), pd.get_rank()
    q, k, v = (torch.from_numpy(rows(c[x], rank, world, axis=1)).requires_grad_()
               for x in "qkv")
    out = mha(q, k, v, impl="ring", group=torch.distributed.group.WORLD, n_valid=c["n_valid"])
    (out * torch.from_numpy(rows(c["w"], rank, world, axis=1))).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _vit_sp(c):
    """``vit_forward_sp`` on a ``data x seq`` mesh: the CLS output, the taps
    at ``out_indices``, and the gradients of sum(cls ** 2) summed over the
    ranks over the world size (each rank's cover its blocks)."""
    from dinomc_tpu_torch.core.mesh import make_mesh
    from dinomc_tpu_torch.models.vit import VIT_FACTORIES, VisionTransformer, vit_forward_sp
    from dinomc_tpu_torch.parallel import distributed as pd

    seq = c["seq"]
    mesh = make_mesh(data=pd.get_world_size() // seq, seq=seq)
    cfg = VIT_FACTORIES[c["arch"]](**c["cfg"])
    vit = VisionTransformer(cfg)
    vit.load_state_dict(c["weights"])
    x = torch.from_numpy(c["x"])
    cls = vit_forward_sp(vit, x, mesh)
    names = c["grad_names"]
    params = dict(vit.named_parameters())
    grads = torch.autograd.grad(cls.square().sum(), [params[n] for n in names])
    grads = [pd.all_reduce_(g.clone()) / pd.get_world_size() for g in grads]
    with torch.no_grad():
        taps = vit_forward_sp(vit, x, mesh, out_indices=c["out_indices"])
    return {"cls": cls.detach(), "taps": taps, "grads": dict(zip(names, grads))}


def _upernet_sp(c):
    """UPerNet eval logits with the backbone sequence-parallel."""
    from dinomc_tpu_torch.core.mesh import make_mesh
    from dinomc_tpu_torch.models.upernet import UPerNet, UPerNetConfig
    from dinomc_tpu_torch.parallel import distributed as pd
    from dinomc_tpu_torch.train.seg_trainer import seg_predict

    mesh = make_mesh(data=pd.get_world_size() // c["seq"], seq=c["seq"])
    model = UPerNet(UPerNetConfig(**c["cfg"]))
    model.load_state_dict(c["weights"])
    return {"logits": seg_predict(model, torch.from_numpy(c["x"]), mesh)}


def _host(c):
    """``reduce_dict``, ``MetricLogger.synchronize_between_processes`` and
    the rank-0 ``print`` gate."""
    import builtins
    import io
    from contextlib import redirect_stdout

    from dinomc_tpu_torch.parallel import distributed as pd
    from dinomc_tpu_torch.utils.logging import MetricLogger

    rank = pd.get_rank()
    vals = {"a": 1.0 + rank, "b": 10.0 * (rank + 1)}
    ml = MetricLogger()
    for i in range(rank + 1):
        ml.update(loss=float(rank + i))
    ml.synchronize_between_processes()
    buf = io.StringIO()
    with redirect_stdout(buf):
        pd.setup_for_distributed()
        print("gated")
        print("forced", force=True)
        pd.destroy(keep_group=True)
    assert builtins.print is pd._ORIGINAL_PRINT
    return {"sum": pd.reduce_dict(vals, average=False), "mean": pd.reduce_dict(vals),
            "count": ml.meters["loss"].count, "total": ml.meters["loss"].total,
            "printed": buf.getvalue().split()}


CASES = {"dino": _dino, "ring": _ring, "vit_sp": _vit_sp, "upernet_sp": _upernet_sp,
         "host": _host}


def _worker(d):
    torch.set_num_threads(1)
    from dinomc_tpu_torch.parallel import distributed as pd

    assert pd.init_distributed_mode("cpu", init_method=f"file://{d}/rendezvous", timeout_s=120)
    try:
        cases = torch.load(os.path.join(d, "cases.pt"), weights_only=False)
        results = {name: CASES[c["kind"]](c) for name, c in cases.items()}
        path = os.path.join(d, f"rank{pd.get_rank()}.pt")
        torch.save(results, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        pd.destroy()


if __name__ == "__main__":
    _worker(sys.argv[1])
