"""graphsage-reddit [gnn]: n_layers=2 d_hidden=128 aggregator=mean
sample_sizes=25-10 [arXiv:1706.02216; paper] (port of
``repro/configs/graphsage_reddit.py``).

d_in varies per shape cell (cora 1433 / reddit 602 / ogb 100 / molecule
64); ``adjust`` swaps it in, and for minibatch_lg the cell's fanout.
minibatch_lg uses the CSR fanout sampler (data/graph.py). The paper's index
layer attaches to the output node embeddings (bench/gnn_index.py)."""
import torch

from repro_torch.configs import base
from repro_torch.models.gnn import GraphSAGEConfig


def make_config() -> GraphSAGEConfig:
    return GraphSAGEConfig(
        name="graphsage-reddit", d_in=602, d_hidden=128, num_layers=2,
        num_classes=41, aggregator="mean", sample_sizes=(25, 10),
        dtype=torch.float32, param_dtype=torch.float32,
    )


def make_smoke() -> GraphSAGEConfig:
    return GraphSAGEConfig(
        name="graphsage-smoke", d_in=32, d_hidden=16, num_layers=2,
        num_classes=7, aggregator="mean", sample_sizes=(5, 3),
        dtype=torch.float32, param_dtype=torch.float32,
    )


def adjust(cfg: GraphSAGEConfig, shape_name: str) -> GraphSAGEConfig:
    d_feat = base.GNN_SHAPES[shape_name].params["d_feat"]
    upd = {"d_in": d_feat}
    if shape_name == "minibatch_lg":
        upd["sample_sizes"] = base.GNN_SHAPES[shape_name].params["fanout"]
    return cfg._replace(**upd)


ARCH = base.ArchSpec(
    arch_id="graphsage-reddit", family="gnn", make_config=make_config,
    make_smoke=make_smoke, shapes=base.GNN_SHAPES, adjust=adjust,
    notes="segment-reduce message passing; CSR sampler for minibatch_lg.",
)
