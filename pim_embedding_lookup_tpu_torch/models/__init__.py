"""Models over the embedding collections, and their training."""

from .dlrm import DLRM, bce_loss, interact_dot
from .quantize import quantize_dlrm_embeddings
from .train import (
    OptaxAdagrad,
    TrainReport,
    binary_accuracy,
    fit,
    make_eval_step,
    make_optimizer,
    make_train_step,
    roc_auc,
)

__all__ = [
    "quantize_dlrm_embeddings",
    "DLRM",
    "bce_loss",
    "interact_dot",
    "fit",
    "make_train_step",
    "make_eval_step",
    "make_optimizer",
    "binary_accuracy",
    "roc_auc",
    "TrainReport",
    "OptaxAdagrad",
]
