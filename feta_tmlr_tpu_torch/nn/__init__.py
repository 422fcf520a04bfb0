from feta_tmlr_tpu_torch.nn.feta import FeTAEncoder, FilterCoefficientHead
from feta_tmlr_tpu_torch.nn.gat import (
    DenseGATConv,
    GATFeTALayer,
    GATFeTANet,
    GATLayer,
    GATNet,
)
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
    EdgeLPETransformer,
    FreqTransformer,
    LPETransformer,
    MLPReadout,
    SANAttention,
    SANCoeffHead,
    SANNet,
    SANNodeSpectra,
    SANSpectraLayer,
    san_structure_laplacian,
    typed_edge_scores,
)

__all__ = ["ATOM_FEATURE_DIMS", "AttnColStats", "BOND_FEATURE_DIMS",
           "ClassifierMLP", "DenseGATConv", "DiffGraphTransformerGenGCN",
           "DiffGraphTransformerGenGCNMolHiv",
           "DiffGraphTransformerGenGCNMolPcba",
           "DiffGraphTransformerGenGCNPCQM4M",
           "DiffGraphTransformerGenGCNSBM", "OGBAtomEncoder",
           "OGBBondEncoder",
           "EdgeLPETransformer", "FeTAEncoder", "FilterCoefficientHead",
           "FreqTransformer", "GATFeTALayer", "GATFeTANet", "GATLayer",
           "GATNet", "GraphiTEncoderLayer", "LPETransformer", "MLPReadout",
           "MaskedBatchNorm", "SANAttention", "SANCoeffHead", "SANNet",
           "SANNodeSpectra", "SANSpectraLayer", "coefficient_regularizer",
           "san_structure_laplacian", "typed_edge_scores"]
