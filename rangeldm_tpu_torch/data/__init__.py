"""LiDAR scans on disk -> range image batches and their conditions."""

from rangeldm_tpu_torch.data.datasets import (  # noqa: F401
    DatasetConfig, LoaderStallWarning, RangeImageDataset, RangeLoader,
    collate,
)
