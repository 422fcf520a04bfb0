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
from feta_tmlr_tpu_torch.data.pack import pack_graphs
from feta_tmlr_tpu_torch.data.synthetic import (
    ogb_like_dataset,
    random_connected_graph,
    random_graph_dataset,
    sbm_like_dataset,
    zinc_categorical_dataset,
    zinc_like_dataset,
)
from feta_tmlr_tpu_torch.data.zinc import (
    find_zinc_dir,
    load_zinc,
    load_zinc_or_synthetic,
    load_zinc_split,
)

__all__ = ["Graph", "GraphBatch", "collate_graphs", "find_ogb_root",
           "load_ogb", "load_ogb_graphs", "load_ogb_or_synthetic",
           "load_ogb_split_idx", "ogb_like_dataset", "pack_graphs",
           "pad_bucket",
           "find_zinc_dir", "load_zinc", "load_zinc_or_synthetic",
           "load_zinc_split", "random_connected_graph",
           "random_graph_dataset", "sbm_like_dataset",
           "zinc_categorical_dataset", "zinc_like_dataset"]
