from clip_assisted_data_labeling_tpu_torch.ui.backend import (
    HeadlessBackend,
    LabelBackend,
    OpenCVBackend,
)
from clip_assisted_data_labeling_tpu_torch.ui.sorting import re_order_images
