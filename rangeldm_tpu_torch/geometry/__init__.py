from rangeldm_tpu_torch.geometry.sensors import (  # noqa: F401
    SensorSpec, get_spec, kitti360_spec, kitti360_vanilla_spec,
    nuscenes_spec, stf_spec,
)
from rangeldm_tpu_torch.geometry.projection import (  # noqa: F401
    decode_log_range, decode_range, encode_range, normalize, normalize_np,
    pad_points, process_miss_value, process_miss_value_np, project,
    project_np, range_image, range_image_np,
)
from rangeldm_tpu_torch.geometry.inverse import (  # noqa: F401
    to_point_cloud, to_point_cloud_masked,
)
from rangeldm_tpu_torch.geometry.voxelize import (  # noqa: F401
    splat_points_to_volumes, to_voxel,
)
