"""Tensor-adjacent substrate: activations, losses, updaters and
schedules, seeded init, DataSet / MultiDataSet and the normalizers,
generator threading, device placement and the device→host transfer
seam. Re-exports the JAX package's ``ops`` names."""

from .activations import get_activation, activation_names, register_activation
from .losses import get_loss, loss_names, compute_loss, register_loss
from .updaters import (Updater, make_updater, schedule_lr, normalize_gradient,
                       UPDATER_NAMES)
from .weight_init import init_weights
from .dataset import (DataSet, MultiDataSet, DataNormalizer,
                      NormalizerStandardize, NormalizerMinMaxScaler,
                      ImagePreProcessingScaler)
from . import rng

__all__ = [
    "get_activation", "activation_names", "register_activation",
    "get_loss", "loss_names", "compute_loss", "register_loss",
    "Updater", "make_updater", "schedule_lr", "normalize_gradient",
    "UPDATER_NAMES", "init_weights",
    "DataSet", "MultiDataSet", "DataNormalizer", "NormalizerStandardize",
    "NormalizerMinMaxScaler", "ImagePreProcessingScaler", "rng",
]
