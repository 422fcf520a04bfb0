from feta_tmlr_tpu_torch.data.batch import (
    Graph,
    GraphBatch,
    collate_graphs,
    pad_bucket,
)
from feta_tmlr_tpu_torch.data.synthetic import (
    random_connected_graph,
    sbm_like_dataset,
    zinc_categorical_dataset,
)

__all__ = ["Graph", "GraphBatch", "collate_graphs", "pad_bucket",
           "random_connected_graph", "sbm_like_dataset",
           "zinc_categorical_dataset"]
