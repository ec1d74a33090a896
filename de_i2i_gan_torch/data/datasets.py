"""Datasets, a copy of ``de_i2i_gan_tpu/data/datasets.py``.

Mirrors the reference's defectGAN/datasets/:
  CodeBrimDataset (codebrim_dataset.py:10-56)  multilabel one-hot from JSON
      metadata, data_type in {defects, background, fusion}, bce classifier
  MTVecDataset   (mvtec_dataset.py:6-46)       one-hot per defect-type dir
      ('normal' first), cce classifier
  AFHQDataset    (afhq_dataset.py)             cat/dog/wild
  FaceDataset    (face_dataset.py)             unlabeled folder
  ConcatDataset  (concat_dataset.py)
  find_dataset_using_name (datasets/__init__.py:5-29) name registry

The reference imports a ``create_annos`` module that is missing from its repo
(codebrim_dataset.py:7); here ``create_codebrim_annotations`` builds the
metadata from an ``annotations.csv`` (filename,bit,bit,...) or, if absent,
assigns every file in background/ the background label and errors for
defects without metadata.

Items are (HWC float32 image in [-1,1], one-hot label float32, path).
``shard_for_process`` is this rank's contiguous slice of a dataset, for
data-parallel training with one process a device (``parallel/``).
"""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


class _FileDataset:
    clf_loss_type: str = "bce"

    def __init__(self, entries: List[Tuple[Path, Sequence[float]]],
                 transform: Optional[Callable] = None, seed: int = 123):
        self.data = sorted(entries, key=lambda e: str(e[0]))
        self.transform = transform
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int):
        from PIL import Image
        fn, label = self.data[index]
        img = Image.open(fn)
        if self.transform is not None:
            img = self.transform(img, self._rng)
        return img, np.asarray(label, np.float32), str(fn)


DATA_TYPES = ("defects", "background")


def create_codebrim_annotations(anno_dir: Path, data_root: Path,
                                label_nc: int = 6) -> None:
    """Functional stand-in for the reference's missing data.codebrim.create_annos."""
    anno_dir.mkdir(parents=True, exist_ok=True)
    csv_path = data_root / "annotations.csv"
    rows = {}
    if csv_path.exists():
        with csv_path.open() as f:
            for row in csv.reader(f):
                rows[row[0]] = [float(v) for v in row[1:]]
    for data_type in DATA_TYPES:
        out = {}
        for phase_dir in data_root.iterdir():
            d = phase_dir / data_type
            if not d.is_dir():
                continue
            for fn in d.iterdir():
                if fn.suffix != ".png":
                    continue
                if fn.name in rows:
                    out[fn.name] = rows[fn.name]
                elif data_type == "background":
                    lbl = [0.0] * label_nc
                    lbl[0] = 1.0
                    out[fn.name] = lbl
                else:
                    raise FileNotFoundError(
                        f"no annotation for defect image {fn.name}; provide "
                        f"{csv_path} or metadata jsons")
        (anno_dir / f"{data_type}.json").write_text(json.dumps(out))
    if not (anno_dir / "label2idx.json").exists():
        (anno_dir / "label2idx.json").write_text(json.dumps(
            {str(i): i for i in range(label_nc)}))


class CodeBrimDataset(_FileDataset):
    clf_loss_type = "bce"

    def __init__(self, data_dir: Path, dataset_name: str, phase: str,
                 data_type: str, transform=None, label_nc: int = 6,
                 seed: int = 123):
        assert data_type in (*DATA_TYPES, "fusion")
        assert phase in ("train", "val", "test")
        root = Path(data_dir) / dataset_name
        anno_dir = root / "metadata"
        types = DATA_TYPES if data_type == "fusion" else (data_type,)
        fn_label = {}
        for t in types:
            p = anno_dir / f"{t}.json"
            if not p.exists():
                create_codebrim_annotations(anno_dir, root, label_nc)
            fn_label.update(json.loads(p.read_text()))
        entries = []
        for t in types:
            d = root / phase / t
            for fn in d.iterdir():
                if fn.suffix == ".png":
                    entries.append((fn, fn_label[fn.name]))
        super().__init__(entries, transform, seed)
        self.label2idx = json.loads((anno_dir / "label2idx.json").read_text())


class MTVecDataset(_FileDataset):
    clf_loss_type = "cce"

    def __init__(self, data_dir: Path, dataset_name: str, phase: str,
                 data_type: str, transform=None,
                 dataset_data_type: Optional[str] = None, seed: int = 123):
        assert data_type in (*DATA_TYPES, "fusion")
        assert dataset_data_type is not None, \
            "dataset_data_type must be specified, e.g. pill, capsule"
        root = Path(data_dir) / dataset_name / dataset_data_type / phase
        labels = sorted((p.name for p in root.iterdir() if p.is_dir()),
                        key=lambda x: (x != "normal", x))
        eye = np.eye(len(labels), dtype=np.float32)
        self.label2idx = {lbl: eye[i].tolist() for i, lbl in enumerate(labels)}
        dirs = []
        if data_type in ("background", "fusion"):
            dirs.append(root / "normal")
        if data_type in ("defects", "fusion"):
            dirs += [root / l for l in labels if l != "normal"]
        entries = [(fn, self.label2idx[d.name])
                   for d in dirs for fn in d.iterdir() if fn.suffix == ".png"]
        super().__init__(entries, transform, seed)


class AFHQDataset(_FileDataset):
    clf_loss_type = "cce"
    LABEL2IDX = {"cat": 0, "dog": 1, "wild": 2}

    def __init__(self, data_dir: Path, dataset_name: str, phase: str,
                 transform=None, seed: int = 123):
        eye = np.eye(3, dtype=np.float32)
        entries = []
        for name, idx in self.LABEL2IDX.items():
            d = Path(data_dir) / dataset_name / phase / name
            entries += [(fn, eye[idx]) for fn in d.iterdir()
                        if fn.suffix in (".png", ".jpg")]
        super().__init__(entries, transform, seed)


class FaceDataset(_FileDataset):
    def __init__(self, data_dir: Path, dataset_name: str, phase: str,
                 transform=None, seed: int = 123):
        d = Path(data_dir) / dataset_name / phase
        entries = [(fn, [0.0]) for fn in d.iterdir() if fn.suffix == ".png"]
        super().__init__(entries, transform, seed)


class ConcatDataset:
    """Zip-style concat (concat_dataset.py)."""

    def __init__(self, *datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, i):
        return tuple(d[i] for d in self.datasets)


_REGISTRY = {
    "codebrim": CodeBrimDataset,
    "mtvec": MTVecDataset,
    "mvtec": MTVecDataset,
    "afhq": AFHQDataset,
    "face": FaceDataset,
}


def find_dataset_using_name(name: str):
    """Name -> dataset class (datasets/__init__.py:5-29); also resolves the
    synthetic test dataset."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name == "synthetic":
        from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset
        return SyntheticDefectDataset
    raise KeyError(f"dataset {name!r} not registered; have "
                   f"{sorted(_REGISTRY) + ['synthetic']}")


class _ShardView:
    """This process's contiguous slice of a map-style dataset (one shard a
    rank in data-parallel training)."""

    def __init__(self, dataset, sl: slice):
        self.dataset = dataset
        self.clf_loss_type = getattr(dataset, "clf_loss_type", "bce")
        self._indices = range(*sl.indices(len(dataset)))

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, index: int):
        return self.dataset[self._indices[index]]


def shard_for_process(dataset) -> "_ShardView":
    from de_i2i_gan_torch.parallel.distributed import process_shard
    return _ShardView(dataset, process_shard(len(dataset)))
