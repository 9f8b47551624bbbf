"""Training substrate of the port (counterpart of ``repro.train``): the
loop, on one device or over a device mesh, and the DKPCA activation
probe."""

from .loop import StragglerMonitor, TrainConfig, build_train_step, train
from .probes import activation_probe

__all__ = ["StragglerMonitor", "TrainConfig", "activation_probe",
           "build_train_step", "train"]
