from gm3d_tpu_torch.masking.masks import (
    block_mask,
    geometric_mask,
    gm3d_num_mask,
    keep_ratio_schedule,
    random_mask,
)

__all__ = ["block_mask", "geometric_mask", "gm3d_num_mask", "keep_ratio_schedule",
           "random_mask"]
