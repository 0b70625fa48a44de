"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU (conftest.py), the port on CPU tensors, where every kernel
wrapper runs its plain version. Tests of the CUDA kernels themselves take
the ``cuda_device`` fixture, which skips them on a machine without a card;
they run on the card with ``python -m pytest tests/test_torch_*.py -m cuda``.
"""

import os

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch CPU ops on one thread. The suite runs
    several worker processes at once, each with JAX's thread pools; torch's
    default of one thread per core on top of that oversubscribes the cores,
    and a CLI test then takes tens of times longer than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


def t(x, dtype=torch.float32) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x, copy=True)).to(dtype)


def n(x) -> np.ndarray:
    """torch tensor -> numpy."""
    return x.detach().cpu().float().numpy()


def assert_state_dicts_close(ours, ref, atol, what=""):
    """Same keys, values within ``atol`` (ours: torch tensors; ref: numpy)."""
    assert set(ours) == set(ref), f"{what}: key mismatch {set(ours) ^ set(ref)}"
    for k in sorted(ref):
        np.testing.assert_allclose(
            n(ours[k]), np.asarray(ref[k], np.float32), atol=atol, rtol=0,
            err_msg=f"{what}{k}",
        )


def write_seg_folder(root, n, size, spec, seed):
    """``n`` random RGB images and palette masks under root/{images,masks}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    palette = np.asarray(spec.palette, np.uint8)
    for i in range(n):
        img = rng.integers(0, 256, (size, size + 3, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", f"tile_{i}.png"))
        mask = palette[rng.integers(0, spec.num_classes, (size, size + 3))]
        Image.fromarray(mask).save(os.path.join(root, "masks", f"tile_{i}.png"))
