"""Record → image, the port of `load_image` in
`multiposenet_tpu/data/loader.py`, reading files through
`utils/image_io.py` instead of cv2. Batch assembly for training
(`make_batch`, `batch_iterator`) belongs to the training slice.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from multiposenet_tpu_torch.utils.image_io import read_image


def load_image(record: dict, image_dir: str | None) -> np.ndarray:
    """Record → uint8 RGB array. Synthetic records embed the image; COCO
    records reference a file under image_dir (JPEG, PNG or .npy here)."""
    if "image" in record:
        return record["image"]
    if image_dir is None:
        raise ValueError("record has no embedded image and image_dir unset")
    return read_image(Path(image_dir) / record["file_name"])
