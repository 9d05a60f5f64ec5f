from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, batch_for, class_data, make_batch, transition)
