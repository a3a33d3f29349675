from vfmreg_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    create_train_state,
    make_train_step,
    shard_vit_params,
)
