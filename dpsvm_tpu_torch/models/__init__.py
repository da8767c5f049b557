"""Model containers, serialization and the model families' trainers."""

from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.models.svr import SVRModel, train_svr
from dpsvm_tpu_torch.models.oneclass import OneClassModel, train_oneclass
from dpsvm_tpu_torch.models.nusvm import train_nusvc, train_nusvr
from dpsvm_tpu_torch.models.multiclass import (MulticlassSVM,
                                               accuracy_multiclass,
                                               predict_multiclass,
                                               train_multiclass)
from dpsvm_tpu_torch.models.precomputed import PrecomputedSVCModel

__all__ = ["SVMModel", "SVRModel", "train_svr", "OneClassModel",
           "train_oneclass", "train_nusvc", "train_nusvr", "MulticlassSVM",
           "train_multiclass", "predict_multiclass", "accuracy_multiclass",
           "PrecomputedSVCModel"]
