from feta_tmlr_tpu_torch.pe.cache import PECache
from feta_tmlr_tpu_torch.pe.encodings import (
    POSENCODINGS,
    AdjEncoding,
    DiffusionEncoding,
    FullEncoding,
    LapEncoding,
    PositionEncoding,
    PStepRWEncoding,
    graph_laplacian,
)
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp, laplace_decomp
from feta_tmlr_tpu_torch.pe.rwpe import apply_rwpe, rwpe

__all__ = ["AdjEncoding", "DiffusionEncoding", "FullEncoding",
           "LapEncoding", "PECache", "POSENCODINGS", "PStepRWEncoding",
           "PositionEncoding", "apply_laplace_decomp", "apply_rwpe",
           "graph_laplacian", "laplace_decomp", "rwpe"]
