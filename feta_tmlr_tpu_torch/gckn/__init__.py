"""GCKN in PyTorch: path enumeration, path layers, k-means, the encoder and
the supervised network (the counterparts of the JAX package's `gckn/`)."""

from feta_tmlr_tpu_torch.gckn.pathenum import (
    enumerate_paths,
    enumerate_paths_py,
    enumerate_walks,
    enumerate_walks_py,
)
from feta_tmlr_tpu_torch.gckn.paths import PathBatch, build_path_batch
from feta_tmlr_tpu_torch.gckn.layer import PathLayerParams, path_layer_forward
from feta_tmlr_tpu_torch.gckn.linear import LinearClassifier
from feta_tmlr_tpu_torch.gckn.models import (
    GCKNFeature,
    GCKNSupervised,
    gckn_encode_as_pe,
)
from feta_tmlr_tpu_torch.gckn.path_kernel import (
    path_filter_response,
    path_kernel_gram,
    path_kernel_pair,
)

__all__ = [
    "path_kernel_gram",
    "path_kernel_pair",
    "path_filter_response",
    "enumerate_paths",
    "enumerate_paths_py",
    "enumerate_walks",
    "enumerate_walks_py",
    "PathBatch",
    "build_path_batch",
    "PathLayerParams",
    "path_layer_forward",
    "GCKNFeature",
    "GCKNSupervised",
    "gckn_encode_as_pe",
    "LinearClassifier",
]
