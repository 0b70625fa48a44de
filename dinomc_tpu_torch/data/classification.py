"""Classification datasets: EuroSAT (ImageFolder) and BigEarthNet-19.

Counterpart of ``dinomc_tpu/data/classification.py``, the port's own copy
(``tests/test_torch_copies.py`` and ``tests/test_torch_bigearthnet.py`` hold
it to the original):
  * EuroSAT: the torchvision ``ImageFolder`` layout (a subdirectory per
    class), decoded on the host with PIL and resized bicubic to
    ``image_size``, and the val transform's centre crop
    (``main_eurosat.py:57-98``). Crops, flips and the normalization of the
    train transform run on the device (``ops/augment``).
  * BigEarthNet-19 (``main_bigearthnet.py``), whose dataset module is absent
    from the reference's repo and was reconstructed in the JAX package from
    the public BigEarthNet-19 spec: patch folders with a
    ``*_labels_metadata.json`` of CLC-43 names, mapped to the 19-class
    nomenclature, and the LMDB serialization (``utils/data.py:88-117``),
    which needs the ``lmdb`` package. As in the original, a patch is read
    from one file: the first of its sorted B04/B03/B02 band files (B02,
    blue, where all three are there), decoded as RGB.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np


class ImageFolderDataset:
    """Class-per-subdir image dataset (torchvision ImageFolder layout)."""

    def __init__(self, root: str, image_size: int = 256):
        self.image_size = image_size
        self.classes = sorted(
            d.name for d in Path(root).iterdir() if d.is_dir()
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            for f in sorted((Path(root) / c).iterdir()):
                if f.suffix.lower() in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
                    self.samples.append((str(f), self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        from PIL import Image

        path, label = self.samples[i]
        img = Image.open(path).convert("RGB")
        if self.image_size:
            img = img.resize((self.image_size, self.image_size), Image.BICUBIC)
        return np.asarray(img, np.float32) / 255.0, label


def center_crop(images: np.ndarray, size: int) -> np.ndarray:
    """(B, H, W, C) -> centered (B, size, size, C) (val transform)."""
    H, W = images.shape[1:3]
    y0 = (H - size) // 2
    x0 = (W - size) // 2
    return images[:, y0 : y0 + size, x0 : x0 + size]


# ---------------------------------------------------------------------------
# BigEarthNet-19
# ---------------------------------------------------------------------------

# The 19-class nomenclature: {new_class: [CLC level-3 names]} (public
# BigEarthNet-19 spec; 10 of the original 43 classes are dropped).
BEN19_GROUPS: Dict[str, Sequence[str]] = {
    "Urban fabric": ["Continuous urban fabric", "Discontinuous urban fabric"],
    "Industrial or commercial units": ["Industrial or commercial units"],
    "Arable land": [
        "Non-irrigated arable land", "Permanently irrigated land", "Rice fields",
    ],
    "Permanent crops": [
        "Vineyards", "Fruit trees and berry plantations", "Olive groves",
        "Annual crops associated with permanent crops",
    ],
    "Pastures": ["Pastures"],
    "Complex cultivation patterns": ["Complex cultivation patterns"],
    "Land principally occupied by agriculture, with significant areas of natural vegetation": [
        "Land principally occupied by agriculture, with significant areas of natural vegetation"
    ],
    "Agro-forestry areas": ["Agro-forestry areas"],
    "Broad-leaved forest": ["Broad-leaved forest"],
    "Coniferous forest": ["Coniferous forest"],
    "Mixed forest": ["Mixed forest"],
    "Natural grassland and sparsely vegetated areas": [
        "Natural grassland", "Sparsely vegetated areas",
    ],
    "Moors, heathland and sclerophyllous vegetation": [
        "Moors and heathland", "Sclerophyllous vegetation",
    ],
    "Transitional woodland, shrub": ["Transitional woodland/shrub"],
    "Beaches, dunes, sands": ["Beaches, dunes, sands"],
    "Inland wetlands": ["Inland marshes", "Peatbogs"],
    "Coastal wetlands": ["Salt marshes", "Salines"],
    "Inland waters": ["Water courses", "Water bodies"],
    "Marine waters": ["Coastal lagoons", "Estuaries", "Sea and ocean"],
}

BEN19_CLASSES: Tuple[str, ...] = tuple(BEN19_GROUPS.keys())
_CLC_TO_19: Dict[str, int] = {
    clc: i for i, (_, group) in enumerate(BEN19_GROUPS.items()) for clc in group
}


def clc_labels_to_multihot(labels: Sequence[str]) -> np.ndarray:
    """CLC-43 label names -> 19-dim multi-hot (dropped classes ignored)."""
    y = np.zeros(len(BEN19_CLASSES), np.float32)
    for name in labels:
        idx = _CLC_TO_19.get(name)
        if idx is not None:
            y[idx] = 1.0
    return y


class BigEarthNetFolder:
    """BigEarthNet patch folders: each patch dir holds band tifs/pngs and a
    ``*_labels_metadata.json`` with a ``labels`` list."""

    def __init__(self, root: str, image_size: int = 120, bands: str = "rgb"):
        self.image_size = image_size
        self.bands = bands
        self.patches = sorted(
            str(d) for d in Path(root).iterdir() if d.is_dir()
        )

    def __len__(self) -> int:
        return len(self.patches)

    def _load_labels(self, patch_dir: str) -> np.ndarray:
        metas = list(Path(patch_dir).glob("*_labels_metadata.json"))
        if not metas:
            metas = list(Path(patch_dir).glob("*.json"))
        with open(metas[0]) as f:
            meta = json.load(f)
        return clc_labels_to_multihot(meta.get("labels", []))

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        from dinomc_tpu_torch.data.seco import read_image

        patch_dir = self.patches[i]
        # the first of the sorted B04/B03/B02 band files, else any image
        files = sorted(
            str(f)
            for f in Path(patch_dir).iterdir()
            if f.suffix.lower() in (".tif", ".tiff", ".png", ".jpg")
        )
        rgb = [f for f in files if any(b in f for b in ("B04", "B03", "B02"))]
        img = read_image((rgb or files)[0], size=self.image_size)
        return img, self._load_labels(patch_dir)


class LMDBDataset:
    """Pickled-sample LMDB dataset (reference ``LMDBDataset``,
    ``utils/data.py:88-117``); requires the lmdb package."""

    def __init__(self, lmdb_path: str):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("LMDBDataset requires the 'lmdb' package") from e
        self.env = lmdb.open(
            lmdb_path, readonly=True, lock=False, readahead=False, meminit=False
        )
        with self.env.begin() as txn:
            self.length = txn.stat()["entries"]

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int):
        with self.env.begin() as txn:
            data = txn.get(str(i).encode())
        return pickle.loads(data)


def make_lmdb(dataset, lmdb_path: str, map_size: int = 1 << 33) -> None:
    """Serialize a dataset into LMDB (reference ``make_lmdb`` parity)."""
    import lmdb

    env = lmdb.open(lmdb_path, map_size=map_size)
    with env.begin(write=True) as txn:
        for i in range(len(dataset)):
            txn.put(str(i).encode(), pickle.dumps(dataset[i]))
    env.sync()
    env.close()
