"""Datasets, loaders, the device feed and the SEAN embedding bank."""
from de_i2i_gan_torch.data.datasets import (
    AFHQDataset,
    CodeBrimDataset,
    ConcatDataset,
    FaceDataset,
    MTVecDataset,
    find_dataset_using_name,
)
from de_i2i_gan_torch.data.pipeline import (
    DataLoader, DualStreamLoader, InfiniteLoader, device_prefetch)
from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset

__all__ = [
    "AFHQDataset", "CodeBrimDataset", "ConcatDataset", "FaceDataset",
    "MTVecDataset", "find_dataset_using_name",
    "DataLoader", "InfiniteLoader", "DualStreamLoader", "device_prefetch",
    "SyntheticDefectDataset",
]
