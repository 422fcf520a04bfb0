from feta_tmlr_tpu_torch.nn.feta import FeTAEncoder, FilterCoefficientHead
from feta_tmlr_tpu_torch.nn.layers import (
    AttnColStats,
    GraphiTEncoderLayer,
    MaskedBatchNorm,
)
from feta_tmlr_tpu_torch.nn.models import (
    ClassifierMLP,
    DiffGraphTransformerGenGCNSBM,
    coefficient_regularizer,
)

__all__ = ["AttnColStats", "ClassifierMLP", "DiffGraphTransformerGenGCNSBM",
           "FeTAEncoder", "FilterCoefficientHead", "GraphiTEncoderLayer",
           "MaskedBatchNorm", "coefficient_regularizer"]
