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
from feta_tmlr_tpu_torch.nn.ogb import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    DiffGraphTransformerGenGCNMolHiv,
    DiffGraphTransformerGenGCNMolPcba,
    DiffGraphTransformerGenGCNPCQM4M,
    OGBAtomEncoder,
    OGBBondEncoder,
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

__all__ = ["ATOM_FEATURE_DIMS", "AttnColStats", "BOND_FEATURE_DIMS",
           "ClassifierMLP", "DiffGraphTransformerGenGCN",
           "DiffGraphTransformerGenGCNMolHiv",
           "DiffGraphTransformerGenGCNMolPcba",
           "DiffGraphTransformerGenGCNPCQM4M",
           "DiffGraphTransformerGenGCNSBM", "OGBAtomEncoder",
           "OGBBondEncoder",
           "FeTAEncoder", "FilterCoefficientHead", "FreqTransformer",
           "GraphiTEncoderLayer", "LPETransformer", "MLPReadout",
           "MaskedBatchNorm", "SANAttention", "SANCoeffHead",
           "SANNodeSpectra", "SANSpectraLayer", "coefficient_regularizer",
           "san_structure_laplacian", "typed_edge_scores"]
