from feta_tmlr_tpu_torch.pe.encodings import (
    DiffusionEncoding,
    LapEncoding,
    graph_laplacian,
)
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp, laplace_decomp

__all__ = ["DiffusionEncoding", "LapEncoding", "apply_laplace_decomp",
           "graph_laplacian", "laplace_decomp"]
