from feta_tmlr_tpu_torch.data.batch import (
    Graph,
    GraphBatch,
    collate_graphs,
    pad_bucket,
)
from feta_tmlr_tpu_torch.data.ogb_raw import (
    find_ogb_root,
    load_ogb,
    load_ogb_graphs,
    load_ogb_or_synthetic,
    load_ogb_split_idx,
)
from feta_tmlr_tpu_torch.data.synthetic import (
    ogb_like_dataset,
    random_connected_graph,
    sbm_like_dataset,
    zinc_categorical_dataset,
    zinc_like_dataset,
)

__all__ = ["Graph", "GraphBatch", "collate_graphs", "find_ogb_root",
           "load_ogb", "load_ogb_graphs", "load_ogb_or_synthetic",
           "load_ogb_split_idx", "ogb_like_dataset", "pad_bucket",
           "random_connected_graph", "sbm_like_dataset",
           "zinc_categorical_dataset", "zinc_like_dataset"]
