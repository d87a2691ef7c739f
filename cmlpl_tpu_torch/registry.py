"""Dataset registry — the single source of truth for dataset constants.

The reference duplicates these constants in five places (``train.py:75-90``,
``trian_CPS.py``, ``trian_CCT.py``, ``tools/hyper_tools.py:250-276``,
``hsi_loader.py:8-17``) and hard-codes scene dims + palettes in
``tools/hyper_tools.py:58-205``.  Here one table covers all of it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Static description of one hyperspectral scene."""

    data_id: int
    name: str
    num_classes: int
    num_bands: int
    rows: int
    cols: int
    # .mat file names + dict keys (reference hyper_tools.py:250-276)
    cube_file: Optional[str]
    cube_key: Optional[str]
    gt_file: Optional[str]
    gt_key: Optional[str]
    # True for MATLAB v7.3 files that need h5py (Indian Pines,
    # hyper_tools.py:272 uses hdf5storage)
    hdf5: bool = False
    # RGB palette, shape (num_classes, 3) in [0, 1]
    palette: Optional[np.ndarray] = None

    @property
    def num_pixels(self) -> int:
        return self.rows * self.cols


# Palettes transcribed from the reference DrawResult tables
# (tools/hyper_tools.py:64-170).
_PAVIAU_PALETTE = np.array(
    [[216, 191, 216], [0, 255, 0], [0, 255, 255], [45, 138, 86],
     [255, 0, 255], [255, 165, 0], [159, 31, 239], [255, 0, 0],
     [255, 255, 0]], dtype=np.float64) / 255.0

_SALINAS_PALETTE = np.array(
    [[37, 58, 150], [47, 78, 161], [56, 87, 166], [56, 116, 186],
     [51, 181, 232], [112, 204, 216], [119, 201, 168], [148, 204, 120],
     [188, 215, 78], [238, 234, 63], [246, 187, 31], [244, 127, 33],
     [239, 71, 34], [238, 33, 35], [180, 31, 35], [123, 18, 20]],
    dtype=np.float64) / 255.0

_HOUSTON_PALETTE = np.array(
    [[0, 205, 0], [127, 255, 0], [46, 139, 87], [0, 139, 0],
     [160, 82, 45], [0, 255, 255], [255, 255, 255], [216, 191, 216],
     [255, 0, 0], [139, 0, 0], [0, 0, 0], [255, 255, 0],
     [238, 154, 0], [85, 26, 139], [255, 127, 80]],
    dtype=np.float64) / 255.0

_INDIAN_PALETTE = np.array(
    [[37, 58, 150], [47, 85, 151], [143, 170, 220], [157, 195, 230],
     [218, 227, 243], [208, 206, 206], [112, 204, 216], [51, 181, 232],
     [238, 234, 63], [255, 217, 102], [246, 187, 31], [244, 127, 33],
     [254, 140, 140], [238, 33, 35], [180, 31, 35], [123, 18, 20]],
    dtype=np.float64) / 255.0

# Synthetic scene for tests / benchmarks when the real cubes are absent.
_SYNTH_PALETTE = np.array(
    [[0, 255, 0], [255, 0, 0], [0, 0, 255], [0, 0, 0], [0, 255, 255],
     [255, 255, 0], [255, 0, 255], [128, 128, 128], [255, 165, 0]],
    dtype=np.float64) / 255.0


DATASETS: dict[int, DatasetSpec] = {
    1: DatasetSpec(1, "PaviaU", 9, 103, 610, 340,
                   "PaviaU.mat", "paviaU", "PaviaU_gt.mat", "paviaU_gt",
                   palette=_PAVIAU_PALETTE),
    2: DatasetSpec(2, "Salinas", 16, 204, 512, 217,
                   "salinas.mat", "HSI_original", "salinas_gt.mat", "Data_gt",
                   palette=_SALINAS_PALETTE),
    3: DatasetSpec(3, "Houston", 15, 144, 349, 1905,
                   "Houston.mat", "Houston", "Houston_gt.mat", "Houston_gt",
                   palette=_HOUSTON_PALETTE),
    4: DatasetSpec(4, "Indian_pines", 16, 200, 145, 145,
                   "indian_pines_corrected.mat", "indian_pines_corrected",
                   "indian_pines_gt.mat", "indian_pines_gt", hdf5=True,
                   palette=_INDIAN_PALETTE),
    # dataID 0: synthetic scene, shaped like a small PaviaU, generated on
    # the fly (no file on disk).  Used by tests and bench when real cubes
    # are unavailable.
    0: DatasetSpec(0, "Synthetic", 9, 103, 64, 48,
                   None, None, None, None, palette=_SYNTH_PALETTE),
}

_BY_NAME = {spec.name.lower(): spec for spec in DATASETS.values()}


def get_dataset(data_id) -> DatasetSpec:
    """Look up a dataset by numeric id or (case-insensitive) name.

    Accepts strings like "1" too, fixing the reference's
    ``--dataID type=str`` vs integer-compare bug (``train.py:357`` vs ``:75``).
    """
    if isinstance(data_id, DatasetSpec):
        return data_id
    if isinstance(data_id, str):
        if data_id.lower() in _BY_NAME:
            return _BY_NAME[data_id.lower()]
        data_id = int(data_id)
    return DATASETS[data_id]
