from feta_tmlr_tpu_torch.data.batch import (
    Graph,
    GraphBatch,
    collate_graphs,
    pad_bucket,
)
from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset

__all__ = ["Graph", "GraphBatch", "collate_graphs", "pad_bucket",
           "sbm_like_dataset"]
