"""LiDAR sensor geometry: per-beam origin heights and inclination tables.

The tables are physical calibration constants: the KITTI-360 HDL-64E table
is the output of RangeLDM's Hough-voting beam-origin estimation
(ldm/kitti360_range_image.py:19-47) and the nuScenes HDL-32E table comes
from ldm/nuscenes_range_image.py:20-33; the SeeingThroughFog table from
vae/sgm/data/STF_range_image.py:19-47. The "vanilla" spec is LiDARGen-style
uniform zenith binning (+3..-25 degrees). Plain numpy, so the package can use
them without any other dependency.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Velodyne HDL-64E (KITTI-360): per-beam sensor-origin heights (meters).
# Values = Hough-voting estimates shipped by the reference
# (ldm/kitti360_range_image.py:19-32).
_KITTI360_HEIGHT = np.array(
    [0.20966667, 0.2092, 0.2078, 0.2078, 0.2078,
     0.20733333, 0.20593333, 0.20546667, 0.20593333, 0.20546667,
     0.20453333, 0.205, 0.2036, 0.20406667, 0.2036,
     0.20313333, 0.20266667, 0.20266667, 0.20173333, 0.2008,
     0.2008, 0.2008, 0.20033333, 0.1994, 0.20033333,
     0.19986667, 0.1994, 0.1994, 0.19893333, 0.19846667,
     0.19846667, 0.19846667, 0.12566667, 0.1252, 0.1252,
     0.12473333, 0.12473333, 0.1238, 0.12333333, 0.1238,
     0.12286667, 0.1224, 0.12286667, 0.12146667, 0.12146667,
     0.121, 0.12053333, 0.12053333, 0.12053333, 0.12006667,
     0.12006667, 0.1196, 0.11913333, 0.11866667, 0.1182,
     0.1182, 0.1182, 0.11773333, 0.11726667, 0.11726667,
     0.1168, 0.11633333, 0.11633333, 0.1154], dtype=np.float32)

# Per-beam zenith angles (radians), ldm/kitti360_range_image.py:33-47.
_KITTI360_ZENITH = np.array(
    [0.03373091, 0.02740409, 0.02276443, 0.01517224, 0.01004049,
     0.00308099, -0.00155868, -0.00788549, -0.01407172, -0.02103122,
     -0.02609267, -0.032068, -0.03853542, -0.04451074, -0.05020488,
     -0.0565317, -0.06180405, -0.06876355, -0.07361411, -0.08008152,
     -0.08577566, -0.09168069, -0.09793721, -0.10398284, -0.11052055,
     -0.11656618, -0.12219002, -0.12725147, -0.13407038, -0.14067839,
     -0.14510716, -0.15213696, -0.1575499, -0.16711043, -0.17568678,
     -0.18278688, -0.19129293, -0.20247031, -0.21146846, -0.21934183,
     -0.22763699, -0.23536977, -0.24528179, -0.25477201, -0.26510582,
     -0.27326038, -0.28232882, -0.28893683, -0.30004392, -0.30953414,
     -0.31993824, -0.32816311, -0.33723155, -0.34447224, -0.352908,
     -0.36282001, -0.37216965, -0.38292524, -0.39164219, -0.39895318,
     -0.40703745, -0.41835542, -0.42777535, -0.43621111], dtype=np.float32)

# Velodyne HDL-32E (nuScenes), ldm/nuscenes_range_image.py:20-33.
_NUSCENES_HEIGHT = np.array(
    [-0.00216031, -0.00098729, -0.00020528, 0.00174976, 0.0044868, -0.00294233,
     -0.00059629, -0.00020528, 0.00174976, -0.00294233, -0.0013783, 0.00018573,
     0.00253177, -0.00098729, 0.00018573, 0.00096774, -0.00411535, -0.0013783,
     0.00018573, 0.00018573, -0.00294233, -0.0013783, -0.00098729, -0.00020528,
     0.00018573, 0.00018573, 0.00018573, -0.00020528, 0.00018573, 0.00018573,
     0.00018573, 0.00018573], dtype=np.float32)

_NUSCENES_ZENITH = np.array(
    [1.86705767e-01, 1.63245357e-01, 1.39784946e-01, 1.16324536e-01,
     9.28641251e-02, 7.01857283e-02, 4.67253177e-02, 2.32649071e-02,
     -1.95503421e-04, -2.28739003e-02, -4.63343109e-02, -6.97947214e-02,
     -9.32551320e-02, -1.15933529e-01, -1.39393939e-01, -1.62854350e-01,
     -1.85532747e-01, -2.08993157e-01, -2.32453568e-01, -2.55913978e-01,
     -2.78592375e-01, -3.02052786e-01, -3.25513196e-01, -3.48973607e-01,
     -3.72434018e-01, -3.95894428e-01, -4.19354839e-01, -4.42033236e-01,
     -4.65493646e-01, -4.88954057e-01, -5.12414467e-01, -5.35874878e-01],
    dtype=np.float32)


# SeeingThroughFog 64-beam HDL64-S3 (vae/sgm/data/STF_range_image.py:19-47).
_STF_HEIGHT = np.array(
    [0.20428571, 0.20534247, 0.20551859, 0.20587084, 0.20587084,
     0.20604697, 0.20675147, 0.20745597, 0.20763209, 0.20710372,
     0.20727984, 0.2090411, 0.20956947, 0.20921722, 0.21080235,
     0.20992172, 0.21027397, 0.20921722, 0.21238748, 0.21273973,
     0.21414873, 0.21379648, 0.21520548, 0.21168297, 0.2153816,
     0.21749511, 0.22101761, 0.21432485, 0.22101761, 0.21626223,
     0.21714286, 0.21908023, 0.14510763, 0.1435225, 0.14845401,
     0.14827789, 0.14863014, 0.14933464, 0.14898239, 0.15303327,
     0.15320939, 0.15320939, 0.15514677, 0.15655577, 0.15426614,
     0.15690802, 0.15585127, 0.15902153, 0.15990215, 0.16131115,
     0.16078278, 0.16448141, 0.16395303, 0.16712329, 0.16694716,
     0.16958904, 0.17046967, 0.17293542, 0.17240705, 0.17434442,
     0.1741683, 0.17786693, 0.17857143, 0.18103718], dtype=np.float32)

_STF_ZENITH = np.array(
    [0.03336595, 0.02749511, 0.02162427, 0.01575342, 0.00890411,
     0.00401174, -0.0018591, -0.00870841, -0.01360078, -0.01947162,
     -0.02632094, -0.03219178, -0.03806262, -0.04295499, -0.04980431,
     -0.05469667, -0.06154599, -0.06741683, -0.07426614, -0.07915851,
     -0.08502935, -0.0909002, -0.09774951, -0.10264188, -0.10949119,
     -0.11634051, -0.12221135, -0.12612524, -0.13297456, -0.1388454,
     -0.14471624, -0.14863014, -0.15450098, -0.16428571, -0.1721135,
     -0.17994129, -0.18874755, -0.19951076, -0.20831703, -0.21908023,
     -0.22592955, -0.23473581, -0.24158513, -0.25430528, -0.26213307,
     -0.27191781, -0.27876712, -0.28757339, -0.29540117, -0.30812133,
     -0.31692759, -0.3276908, -0.3316047, -0.34334638, -0.35019569,
     -0.36193738, -0.37074364, -0.38150685, -0.38835616, -0.39618395,
     -0.40401174, -0.4167319, -0.42455969, -0.43434442], dtype=np.float32)


def _vanilla_tables(n_beams: int = 64,
                    fov_up_deg: float = 3.0,
                    fov_down_deg: float = -25.0):
    """LiDARGen-style uniform zenith bins (ldm/kitti360_range_image_vanilla.py:20-32).

    Beam i covers zenith bin i (top = +fov_up); origin height is 0 for all
    beams. The bin *centers* serve as the inclination table for inverse
    projection.
    """
    fov_up = fov_up_deg / 180.0 * np.pi
    fov_down = fov_down_deg / 180.0 * np.pi
    fov = abs(fov_up) + abs(fov_down)
    # pitch of row i (row 0 = top): uniform grid of centers
    centers = fov_up - (np.arange(n_beams, dtype=np.float32) + 0.5) / n_beams * fov
    zenith = centers.astype(np.float32)
    height = np.zeros(n_beams, dtype=np.float32)
    return height, zenith, fov_up, fov_down


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    """Geometry of one LiDAR sensor plus the range-image encoding
    parameters (ldm/dataset.py:135-157) as an immutable value object."""
    name: str
    n_beams: int
    width: int = 1024
    # 'kitti' = per-beam argmin over |incl - atan2(h - z, ||xy||)|
    # 'ring'  = row index from the per-point ring channel
    # 'uniform' = uniform zenith binning (vanilla / LiDARGen)
    row_mode: str = "kitti"
    range_fill: float = 100.0
    intensity_fill: float = 0.0
    mean: float = 20.0
    std: float = 40.0
    log: bool = False
    inverse: bool = False
    min_depth: float = 0.0
    fov_up: float = 0.0
    fov_down: float = 0.0
    # BEV voxelization grid (D, H, W) and its metric extent
    grid_sizes: tuple = (1, 1024, 1024)
    pc_range: tuple = (-25.6, -25.6, -3.0, 25.6, 25.6, 1.0)
    height: np.ndarray = dataclasses.field(default=None, compare=False,
                                           repr=False)
    zenith: np.ndarray = dataclasses.field(default=None, compare=False,
                                           repr=False)

    @property
    def incl(self) -> np.ndarray:
        """Inclination = -zenith (ldm/kitti360_range_image.py:48)."""
        return -self.zenith

    def replace(self, **kw) -> "SensorSpec":
        return dataclasses.replace(self, **kw)


def kitti360_spec(width: int = 1024, **kw) -> SensorSpec:
    return SensorSpec(name="kitti360", n_beams=64, width=width,
                      row_mode="kitti", height=_KITTI360_HEIGHT,
                      zenith=_KITTI360_ZENITH, **kw)


def nuscenes_spec(width: int = 1024, **kw) -> SensorSpec:
    kw.setdefault("mean", 50.0)
    kw.setdefault("std", 50.0)
    return SensorSpec(name="nuscenes", n_beams=32, width=width,
                      row_mode="ring", min_depth=2.0,
                      height=_NUSCENES_HEIGHT, zenith=_NUSCENES_ZENITH, **kw)


def kitti360_vanilla_spec(width: int = 1024, **kw) -> SensorSpec:
    height, zenith, fov_up, fov_down = _vanilla_tables()
    return SensorSpec(name="kitti360_vanilla", n_beams=64, width=width,
                      row_mode="uniform", fov_up=fov_up, fov_down=fov_down,
                      height=height, zenith=zenith, **kw)


def stf_spec(width: int = 1024, **kw) -> SensorSpec:
    """SeeingThroughFog 64-beam sensor: ring-indexed rows (63 - ring) with
    its own calibration tables (vae/sgm/data/STF_range_image.py:15-53)."""
    return SensorSpec(name="stf", n_beams=64, width=width, row_mode="ring",
                      height=_STF_HEIGHT, zenith=_STF_ZENITH, **kw)


SPECS = {
    "kitti360": kitti360_spec,
    "nuscenes": nuscenes_spec,
    "kitti360_vanilla": kitti360_vanilla_spec,
    "stf": stf_spec,
}


def get_spec(name: str, **kw) -> SensorSpec:
    if name not in SPECS:
        raise KeyError(f"unknown sensor {name!r}; available: {sorted(SPECS)}")
    return SPECS[name](**kw)
