from feta_tmlr_tpu_torch.train.losses import LOSS, cross_entropy, hinge_loss
from feta_tmlr_tpu_torch.train.metrics import (
    accuracy_graph,
    accuracy_sbm,
    average_precision,
    binary_f1,
    mae,
    multitask_mean,
    roc_auc,
)
from feta_tmlr_tpu_torch.train.optim import (
    PlateauScheduler,
    make_optimizer,
    step_lr,
    warmup_inverse_sqrt,
)
from feta_tmlr_tpu_torch.train.trainer import (
    NonFiniteError,
    TrainConfig,
    Trainer,
    task_loss,
    task_metric,
)

__all__ = ["LOSS", "NonFiniteError", "PlateauScheduler", "TrainConfig", "Trainer",
           "accuracy_graph", "accuracy_sbm", "average_precision",
           "binary_f1", "cross_entropy", "hinge_loss", "mae",
           "make_optimizer", "multitask_mean", "roc_auc", "step_lr",
           "task_loss", "task_metric", "warmup_inverse_sqrt"]
