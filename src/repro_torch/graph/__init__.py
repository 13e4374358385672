from repro_torch.graph.ir import Graph, GraphBuilder, Node, infer_shapes  # noqa: F401
