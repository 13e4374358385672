"""SchNet [arXiv:1706.08566; paper]: n_interactions=3 d_hidden=64 rbf=300
cutoff=10. Four graph regimes (cora-like / reddit-sampled / ogbn-products /
batched molecules)."""
from repro_torch.models.schnet import SchNetConfig

FAMILY = "gnn"
CONFIG = SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                      n_rbf=300, cutoff=10.0)

SHAPES = {
    "full_graph_sm": {
        "kind": "train", "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
        "n_classes": 7, "mode": "full"},
    "minibatch_lg": {
        "kind": "train", "n_nodes": 232965, "n_edges": 114615892,
        "d_feat": 602, "n_classes": 41, "mode": "sampled",
        "batch_nodes": 1024, "fanout": (15, 10)},
    "ogb_products": {
        "kind": "train", "n_nodes": 2449029, "n_edges": 61859140,
        "d_feat": 100, "n_classes": 47, "mode": "full"},
    "molecule": {
        "kind": "train", "n_nodes": 30, "n_edges": 64, "batch": 128,
        "mode": "molecule"},
}


def smoke_config() -> SchNetConfig:
    return CONFIG.scaled_down()
