"""Evaluation metrics of the generated range images."""

from rangeldm_tpu_torch.metrics.mae import (  # noqa: F401
    densification_mae, inpainting_mae, segmentation_accuracy,
    segmentation_iou,
)
