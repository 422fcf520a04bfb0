from feta_tmlr_tpu_torch.train.metrics import accuracy_sbm
from feta_tmlr_tpu_torch.train.optim import (
    PlateauScheduler,
    make_optimizer,
    step_lr,
    warmup_inverse_sqrt,
)
from feta_tmlr_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    task_loss,
    task_metric,
)

__all__ = ["PlateauScheduler", "TrainConfig", "Trainer", "accuracy_sbm",
           "make_optimizer", "step_lr", "task_loss", "task_metric",
           "warmup_inverse_sqrt"]
