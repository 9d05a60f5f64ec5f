from repro_torch.train.trainer import (  # noqa: F401
    TrainConfig, Trainer, build_train_step, init_opt_state)
