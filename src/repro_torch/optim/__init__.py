from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, apply_mask, global_norm)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine_warmup, linear_warmup)
from repro_torch.optim.compression import (  # noqa: F401
    compress_int8, compress_tree, decompress_int8)
