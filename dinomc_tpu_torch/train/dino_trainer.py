"""DINO-MC training step for the ViTs, Swin-T, the ResNets and XCiT, in PyTorch.

Counterpart of ``dinomc_tpu/train/dino_trainer.py``; parity target the
reference ``train_one_epoch`` (``main_dino_mc.py:356-416``). One step:
teacher forward over the global crops (no grad), student forward over every
crop (ViT local size-buckets packed two to a sequence; Swin, XCiT and the
convnets one forward a bucket, so XCiT's LPI BatchNorm sees the JAX
package's batches: all globals in one call, each local size in one), the weight-normed head and the centred DINO loss, the
backward pass, per-tensor clipping, the last-layer freeze, the optimizer
(AdamW, SGD or LARS), the teacher EMA (which reads the *new* student) and
the centre update.

Where the JAX step returns a new state, this one updates ``DinoTrainState``
in place under ``torch.no_grad()``: the student parameters, the optimizer
state, the teacher (EMA), the centre and the step counter. The convnets'
BatchNorm running statistics are module buffers, moved in place by the
forwards that use them: the teacher runs its BatchNorm in train mode, as the
reference never calls ``.eval()``, and moves its own statistics once a step;
the student moves its own once a crop-size bucket, globals first, then the
local buckets in ascending size, the JAX package's order. The EMA covers
parameters only, never these buffers.
Matmuls run in ``compute_dtype`` with explicit casts; LayerNorm statistics,
the head's normalization, the logits, the loss and the centre stay f32, and
TF32 is switched off for f32 matmuls and convolutions
(``set_matmul_precision``).

``dino_train_step_accum`` takes one optimizer step from ``accum``
microbatches (rows ``a::accum`` each): the teacher under ``no_grad`` and the
student's forward and backward a microbatch at a time, each graph freed
before the next, the gradients summed and divided by ``accum``, every
microbatch's loss against the pre-step centre, one centre EMA from the mean
of the microbatches' teacher centres, then one ``_finish_step``.

Not ported yet: ``bucket_merge`` (ROADMAP.md queue 1 #7).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dinomc_tpu_torch.models.dino_head import DINOHead, DINOHeadConfig, dino_head_forward
from dinomc_tpu_torch.models.encoders import EncoderConfig
from dinomc_tpu_torch.objectives.dino import dino_loss
from dinomc_tpu_torch.ops.hopper.attention import MAX_FUSED_LEN, _pad_len
from dinomc_tpu_torch.train import optim


def set_matmul_precision() -> None:
    """Full f32 for f32 matmuls and convolutions (no TF32): the port's f32
    paths are held to the JAX package's f32 results."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    """Static training configuration; defaults follow the reference's
    argparse defaults (``main_dino_mc.py:46-151``)."""

    arch: str = "vit_small"
    patch_size: int = 8
    out_dim: int = 65536
    norm_last_layer: bool = True
    use_bn_in_head: bool = False
    drop_path_rate: float = 0.1
    student_temp: float = 0.1
    center_momentum: float = 0.9
    clip_grad: float = 3.0
    freeze_last_layer: int = 1
    optimizer: str = "adamw"
    niter_per_ep: int = 1
    global_crop_size: int = 224
    # ViT selective remat (models/vit.ViTConfig.remat_policy): every policy
    # computes the same numbers; it trades recompute against kept activations.
    remat_policy: str = "attn"
    # "bfloat16" is the training path; "float32" + gelu_approx=False is the
    # mode the parity tests hold against the JAX package and the reference.
    compute_dtype: str = "bfloat16"
    gelu_approx: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def encoder(self, student: bool) -> EncoderConfig:
        return EncoderConfig(
            arch=self.arch,
            patch_size=self.patch_size,
            img_size=self.global_crop_size,
            drop_path_rate=self.drop_path_rate if student else 0.0,
            remat_policy=self.remat_policy,
            compute_dtype=self.dtype,
            gelu_approx=self.gelu_approx,
        )

    def head_config(self) -> DINOHeadConfig:
        return DINOHeadConfig(
            in_dim=self.encoder(True).embed_dim,
            out_dim=self.out_dim,
            use_bn=self.use_bn_in_head,
            norm_last_layer=self.norm_last_layer,
            compute_dtype=self.dtype,
        )


@dataclasses.dataclass
class DinoSchedules:
    """Per-iteration host arrays (core/schedules.py), f32 like the JAX
    package's device copies."""

    lr: np.ndarray  # (total_iters,)
    wd: np.ndarray  # (total_iters,)
    teacher_momentum: np.ndarray  # (total_iters,)
    teacher_temp: np.ndarray  # (epochs,), indexed by epoch

    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, np.asarray(getattr(self, f.name), np.float32))


@dataclasses.dataclass
class DinoTrainState:
    """Train state, updated in place by ``dino_train_step``."""

    step: int
    student: nn.ModuleDict  # {'backbone', 'head'}
    teacher: nn.ModuleDict  # same layout, requires_grad False
    opt_state: Dict
    center: torch.Tensor  # (out_dim,) f32
    generator: torch.Generator  # DropPath draws, on the state's device


def init_dino_train_state(cfg: DinoConfig, seed: int = 0, device="cpu") -> DinoTrainState:
    """Student initialized on the CPU from ``seed`` (so every device starts
    from the same weights), moved to ``device``; the teacher is a copy
    (reference ``main_dino_mc.py:262-265``)."""
    opt_init, _ = optim.OPTIMIZERS[cfg.optimizer]
    set_matmul_precision()
    gen = torch.Generator().manual_seed(seed)
    student = nn.ModuleDict({
        "backbone": cfg.encoder(True).build(gen),
        "head": DINOHead(cfg.head_config(), gen),
    }).to(device)
    teacher = copy.deepcopy(student).requires_grad_(False)
    return DinoTrainState(
        step=0,
        student=student,
        teacher=teacher,
        opt_state=opt_init(dict(student.named_parameters())),
        center=torch.zeros(cfg.out_dim, dtype=torch.float32, device=device),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
    )


def _masks(cfg: DinoConfig, params: Dict[str, torch.Tensor]):
    """Weight-decay, last-layer and frozen-g masks over parameter names.
    ``weight_g`` is (out, 1), so ``wd_mask`` already puts it in the decayed
    group, as the reference's ``get_params_groups`` does."""
    wd_m = optim.wd_mask(params)
    last_layer_m = optim.path_mask(params, lambda n: "head.last_layer" in n)
    frozen_m = None
    if cfg.norm_last_layer:
        frozen_m = optim.path_mask(params, lambda n: n == "head.last_layer.weight_g")
    return wd_m, last_layer_m, frozen_m


def _plan_packing(work, enc: EncoderConfig):
    """Choose which local-crop size-buckets to pack pairwise.

    ``work``: list of (size, rows, crop-indices). Only buckets with equal
    row counts share a sequence, and the packed padded length must stay
    within ``MAX_FUSED_LEN``. Among maximal pairings, pick the one with the
    least padded attention work sum(pad(na + nb)^2) (large with small).
    Exhaustive search: at most 8 buckets. Returns (pairs, singles), the
    larger segment first in each pair."""
    if not enc.is_vit:
        return [], work
    ntok = lambda size: (size // enc.patch_size) ** 2 + 1  # noqa: E731

    by_rows: Dict[int, list] = {}
    for w in work:
        by_rows.setdefault(w[1].shape[0], []).append(w)

    pairs, singles = [], []
    for group in by_rows.values():
        best = None  # ((-n_pairs, padded_cost), pairs, singles)

        def rec(items, ps, sg, cost):
            nonlocal best
            if not items:
                key = (-len(ps), cost)
                if best is None or key < best[0]:
                    best = (key, list(ps), list(sg))
                return
            head, rest = items[0], items[1:]
            rec(rest, ps, sg + [head], cost + _pad_len(ntok(head[0])) ** 2)
            for j, other in enumerate(rest):
                na, nb = ntok(head[0]), ntok(other[0])
                if _pad_len(na + nb) <= MAX_FUSED_LEN:
                    big, small = (head, other) if na >= nb else (other, head)
                    ps.append((big, small))
                    rec(rest[:j] + rest[j + 1:], ps, sg, cost + _pad_len(na + nb) ** 2)
                    ps.pop()

        rec(group, [], [], 0)
        pairs.extend(best[1])
        singles.extend(best[2])
    return pairs, singles


def _forward_crops(
    model: nn.ModuleDict,
    global_crops: torch.Tensor,  # (G, B, S, S, 3)
    local_crops: Tuple[torch.Tensor, ...],  # each (B, s, s, 3)
    enc: EncoderConfig,
    train: bool,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Backbone per resolution bucket, local buckets packed in pairs into
    block-diagonal forwards where they fit (exact;
    ``models/vit.vit_forward_packed``), then one head pass. Returns
    (n_crops, B, K) logits in crop order."""
    G, B = global_crops.shape[:2]
    backbone, head = model["backbone"], model["head"]
    gx = global_crops.reshape((G * B,) + tuple(global_crops.shape[2:]))
    feats: List[torch.Tensor] = list(enc.apply(backbone, gx, train, generator).split(B))

    buckets: Dict[int, list] = {}
    for idx, lc in enumerate(local_crops):
        buckets.setdefault(lc.shape[1], []).append((idx, lc))
    work = [
        (size, torch.cat([lc for _, lc in items], dim=0), [i for i, _ in items])
        for size, items in sorted(buckets.items())
    ]
    local_feats: Dict[int, torch.Tensor] = {}

    def store(idxs, fb):
        for i, fi in zip(idxs, fb.split(B)):
            local_feats[i] = fi

    pairs, singles = _plan_packing(work, enc) if enc.supports_packing else ([], work)
    for (_, xa, ia), (_, xb, ib) in pairs:
        fa, fb = enc.apply_packed(backbone, xa, xb, train, generator)
        store(ia, fa)
        store(ib, fb)
    for _, xs, idxs in singles:
        store(idxs, enc.apply(backbone, xs, train, generator))
    feats.extend(local_feats[i] for i in range(len(local_crops)))

    logits = dino_head_forward(head, torch.cat(feats, dim=0))
    return logits.reshape(len(feats), B, -1)


def _loss_and_grads(state, global_crops, local_crops, teacher_temp, generator, cfg):
    """One teacher + student forward over a batch, the DINO loss against
    the state's centre, and the student's gradients (the graph is freed by
    ``autograd.grad``). Returns (loss, grads in ``named_parameters`` order,
    new centre, teacher logits)."""
    enc_s, enc_t = cfg.encoder(student=True), cfg.encoder(student=False)
    with torch.no_grad():
        teacher_logits = _forward_crops(state.teacher, global_crops, (), enc_t, enc_t.has_bn,
                                        None)
    student_logits = _forward_crops(state.student, global_crops, local_crops, enc_s, True, generator)
    loss, new_center = dino_loss(
        student_logits, teacher_logits, state.center, teacher_temp,
        cfg.student_temp, cfg.center_momentum,
    )
    grads = torch.autograd.grad(loss, list(state.student.parameters()))
    return loss.detach(), grads, new_center, teacher_logits


def dino_loss_and_grads(
    state: DinoTrainState,
    global_crops: torch.Tensor,
    local_crops: Tuple[torch.Tensor, ...],
    teacher_temp: float,
    generator: Optional[torch.Generator],
    cfg: DinoConfig,
):
    """Teacher + student multi-crop forwards, DINO loss, student grads.
    Returns (loss, {param name: grad}, new_center). Parameters, optimizer
    state and centre are left as they are; a convnet's forwards move the
    teacher's and the student's BatchNorm running statistics, as the JAX
    function's returned states do."""
    loss, grads, new_center, _ = _loss_and_grads(
        state, global_crops, local_crops, teacher_temp, generator, cfg)
    names = [n for n, _ in state.student.named_parameters()]
    return loss, dict(zip(names, grads)), new_center


def dino_train_step(
    state: DinoTrainState,
    global_crops: torch.Tensor,
    local_crops: Tuple[torch.Tensor, ...],
    schedules: DinoSchedules,
    cfg: DinoConfig,
) -> Dict:
    """One optimizer step; ``state`` is updated in place. Returns metrics
    (the loss stays a device tensor: reading it syncs the host)."""
    step = state.step
    epoch = step // cfg.niter_per_ep
    loss, grads, new_center = dino_loss_and_grads(
        state, global_crops, local_crops, float(schedules.teacher_temp[epoch]),
        state.generator, cfg,
    )
    return _finish_step(
        state, grads, loss, new_center, float(schedules.lr[step]),
        float(schedules.wd[step]), float(schedules.teacher_momentum[step]), epoch, cfg,
    )


def dino_train_step_accum(
    state: DinoTrainState,
    global_crops: torch.Tensor,  # (G, B, S, S, 3); B = accum * b
    local_crops: Tuple[torch.Tensor, ...],  # each (B, s, s, 3)
    schedules: DinoSchedules,
    cfg: DinoConfig,
    accum: int = 1,
) -> Dict:
    """Gradient accumulation: one optimizer step from ``accum`` microbatches
    of the same full-batch crops ``dino_train_step`` takes (JAX
    ``dino_train_step_accum``). Microbatch ``a`` takes rows ``a::accum``, the
    JAX package's strided split. Every microbatch's loss uses the pre-step
    centre; gradients are summed and divided by ``accum``, the loss
    averaged; the centre takes one EMA step from the mean of the
    microbatches' teacher centres; then clipping, the optimizer and the
    teacher EMA run once. Each microbatch's graph is freed before the next
    (``autograd.grad``), so the activations at the peak are one
    microbatch's. A convnet's BatchNorm statistics move a microbatch at a
    time (teacher, then student, microbatch by microbatch, as the JAX scan
    threads them); XCiT's LPI BatchNorm sees each microbatch as its batch;
    DropPath draws come from ``state.generator`` in microbatch order."""
    A = accum
    B = global_crops.shape[1]
    if B % A:
        raise ValueError(f"accum={A} must divide batch {B}")
    step = state.step
    epoch = step // cfg.niter_per_ep
    teacher_temp = float(schedules.teacher_temp[epoch])
    grads_acc = loss_acc = bc_acc = None
    for a in range(A):
        loss, grads, _, teacher_logits = _loss_and_grads(
            state, global_crops[:, a::A], tuple(x[a::A] for x in local_crops), teacher_temp,
            state.generator, cfg)
        bc = teacher_logits.reshape(-1, teacher_logits.shape[-1]).mean(dim=0)
        if grads_acc is None:
            grads_acc, loss_acc, bc_acc = list(grads), loss, bc
        else:
            for acc, g in zip(grads_acc, grads):
                acc.add_(g)
            loss_acc, bc_acc = loss_acc + loss, bc_acc + bc
        del loss, grads, teacher_logits
    inv_a = 1.0 / A
    if A > 1:
        for g in grads_acc:
            g.mul_(inv_a)
    names = [n for n, _ in state.student.named_parameters()]
    grads = dict(zip(names, grads_acc))
    m = cfg.center_momentum
    new_center = state.center * m + (bc_acc * inv_a) * (1.0 - m)
    return _finish_step(
        state, grads, loss_acc * inv_a, new_center, float(schedules.lr[step]),
        float(schedules.wd[step]), float(schedules.teacher_momentum[step]), epoch, cfg,
    )


@torch.no_grad()
def _finish_step(state, grads, loss, new_center, lr, wd, ema_m, epoch, cfg: DinoConfig):
    """Clip -> masked optimizer update -> EMA teacher -> centre and step,
    in place."""
    if cfg.clip_grad > 0:
        optim.clip_gradients_per_tensor(grads, cfg.clip_grad)
    params = dict(state.student.named_parameters())
    wd_m, last_layer_m, frozen_m = _masks(cfg, params)
    # The last layer is frozen entirely while epoch < freeze_last_layer
    # (reference sets .grad = None, skipping its wd too, utils/utils.py:157-162).
    frozen_now = float(epoch < cfg.freeze_last_layer)
    frozen = {
        n: max(frozen_m[n] if frozen_m else 0.0, last_layer_m[n] * frozen_now)
        for n in params
    }
    _, opt_update = optim.OPTIMIZERS[cfg.optimizer]
    opt_update(grads, state.opt_state, params, lr, wd, wd_m, frozen_mask=frozen)

    # EMA teacher from the updated student (main_dino_mc.py:403-406), over
    # parameters only: BatchNorm statistics come from the teacher's forwards
    for t, s in zip(state.teacher.parameters(), state.student.parameters()):
        t.mul_(ema_m).add_(s.float(), alpha=1.0 - ema_m)
    state.center = new_center
    state.step += 1
    return {"loss": loss, "lr": lr, "wd": wd, "teacher_momentum": ema_m}
