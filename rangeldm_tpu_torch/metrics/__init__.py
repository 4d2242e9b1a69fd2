"""Evaluation metrics of the generated range images: MMD, JSD and FRD of
unconditional samples, MAE and segmentation IoU/accuracy of conditional
ones, and the chamfer distance."""

from rangeldm_tpu_torch.metrics.chamfer import chamfer_distance  # noqa: F401
from rangeldm_tpu_torch.metrics.frd import compute_frd  # noqa: F401
from rangeldm_tpu_torch.metrics.histogram import (  # noqa: F401
    histogram_batch, kitti_histogram, nuscenes_histogram,
    point_cloud_to_histogram,
)
from rangeldm_tpu_torch.metrics.jsd import compute_jsd, jsd_2d  # noqa: F401
from rangeldm_tpu_torch.metrics.mae import (  # noqa: F401
    densification_mae, inpainting_mae, segmentation_accuracy,
    segmentation_iou,
)
from rangeldm_tpu_torch.metrics.mmd import compute_mmd  # noqa: F401
