"""Object classification: libsvm models, per-class subspaces, linear and
kernel SVM training, and the corpus evaluation protocols."""
from mapping_private_tpu_torch.classify.libsvm import (
    SVMModel,
    load_libsvm_model,
    load_scale_params,
    scale_features,
    svm_decision_values,
    svm_predict_batch,
)
from mapping_private_tpu_torch.classify.linear import predict_linear, train_linear_svm
from mapping_private_tpu_torch.classify.subspace import (
    SubspaceClassifier,
    classify_subspace,
    train_subspaces,
)

__all__ = [
    "SVMModel",
    "load_libsvm_model",
    "load_scale_params",
    "scale_features",
    "svm_decision_values",
    "svm_predict_batch",
    "SubspaceClassifier",
    "train_subspaces",
    "classify_subspace",
    "train_linear_svm",
    "predict_linear",
]
