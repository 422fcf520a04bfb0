from feta_tmlr_tpu_torch.pe.encodings import (
    DiffusionEncoding,
    LapEncoding,
    graph_laplacian,
)

__all__ = ["DiffusionEncoding", "LapEncoding", "graph_laplacian"]
