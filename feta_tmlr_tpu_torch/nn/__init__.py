from feta_tmlr_tpu_torch.nn.feta import FeTAEncoder, FilterCoefficientHead
from feta_tmlr_tpu_torch.nn.gat import (
    DenseGATConv,
    GATFeTALayer,
    GATFeTANet,
    GATLayer,
    GATNet,
)
from feta_tmlr_tpu_torch.nn.gnn import (
    DenseGCNConv,
    DenseGENGCN,
    DenseGINEPlus,
)
from feta_tmlr_tpu_torch.nn.gatedgcn import (
    GatedGCNLSPELayer,
    GatedGCNLSPENet,
    lapeig_loss,
)
from feta_tmlr_tpu_torch.nn.layers import (
    AttnColStats,
    GraphiTEncoderLayer,
    MaskedBatchNorm,
)
from feta_tmlr_tpu_torch.nn.lspe import (
    GraphiTSpectraLSPELayer,
    GraphiTSpectraNet,
    LSPEAttention,
)
from feta_tmlr_tpu_torch.nn.models import (
    ClassifierMLP,
    DiffGraphTransformer,
    DiffGraphTransformerGCN,
    DiffGraphTransformerGenGCN,
    DiffGraphTransformerGenGCNSBM,
    DiffGraphTransformerMolHiv,
    DiffGraphTransformerSBM,
    GraphTransformer,
    coefficient_regularizer,
    masked_max_pool,
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
from feta_tmlr_tpu_torch.nn.packed import (
    PackedDiffGraphTransformerGenGCN,
    PackedFeTAEncoder,
    PackedFilterCoefficientHead,
    membership,
    per_graph_mean,
)
from feta_tmlr_tpu_torch.nn.pna import (
    PNALSPELayer,
    PNALSPENet,
    PNATower,
    average_log_degree,
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
from feta_tmlr_tpu_torch.nn.san_lspe import SANGTLSPELayer, SANLSPENet

__all__ = ["ATOM_FEATURE_DIMS", "AttnColStats", "BOND_FEATURE_DIMS",
           "ClassifierMLP", "DenseGATConv", "DenseGCNConv", "DenseGENGCN",
           "DenseGINEPlus", "DiffGraphTransformer",
           "DiffGraphTransformerGCN", "DiffGraphTransformerGenGCN",
           "DiffGraphTransformerGenGCNMolHiv",
           "DiffGraphTransformerGenGCNMolPcba",
           "DiffGraphTransformerGenGCNPCQM4M",
           "DiffGraphTransformerGenGCNSBM", "DiffGraphTransformerMolHiv",
           "DiffGraphTransformerSBM", "GraphTransformer", "OGBAtomEncoder",
           "OGBBondEncoder",
           "EdgeLPETransformer", "FeTAEncoder", "FilterCoefficientHead",
           "FreqTransformer", "GATFeTALayer", "GATFeTANet", "GATLayer",
           "GATNet", "GatedGCNLSPELayer", "GatedGCNLSPENet",
           "GraphiTEncoderLayer", "GraphiTSpectraLSPELayer",
           "GraphiTSpectraNet", "LPETransformer", "LSPEAttention",
           "MLPReadout", "MaskedBatchNorm", "PNALSPELayer", "PNALSPENet",
           "PackedDiffGraphTransformerGenGCN", "PackedFeTAEncoder",
           "PackedFilterCoefficientHead",
           "PNATower", "SANAttention", "SANCoeffHead", "SANGTLSPELayer",
           "SANLSPENet", "SANNet", "SANNodeSpectra", "SANSpectraLayer",
           "average_log_degree", "coefficient_regularizer", "lapeig_loss",
           "masked_max_pool", "membership", "per_graph_mean",
           "san_structure_laplacian", "typed_edge_scores"]
