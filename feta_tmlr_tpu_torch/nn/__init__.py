from feta_tmlr_tpu_torch.nn.feta import FeTAEncoder, FilterCoefficientHead
from feta_tmlr_tpu_torch.nn.layers import (
    AttnColStats,
    GraphiTEncoderLayer,
    MaskedBatchNorm,
)
from feta_tmlr_tpu_torch.nn.models import (
    ClassifierMLP,
    DiffGraphTransformerGenGCN,
    DiffGraphTransformerGenGCNSBM,
    coefficient_regularizer,
)
from feta_tmlr_tpu_torch.nn.san import (
    FreqTransformer,
    LPETransformer,
    MLPReadout,
    SANAttention,
    SANCoeffHead,
    SANNodeSpectra,
    SANSpectraLayer,
    san_structure_laplacian,
    typed_edge_scores,
)

__all__ = ["AttnColStats", "ClassifierMLP", "DiffGraphTransformerGenGCN",
           "DiffGraphTransformerGenGCNSBM",
           "FeTAEncoder", "FilterCoefficientHead", "FreqTransformer",
           "GraphiTEncoderLayer", "LPETransformer", "MLPReadout",
           "MaskedBatchNorm", "SANAttention", "SANCoeffHead",
           "SANNodeSpectra", "SANSpectraLayer", "coefficient_regularizer",
           "san_structure_laplacian", "typed_edge_scores"]
