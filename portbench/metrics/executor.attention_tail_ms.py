"""Device ms per stage-2 call of the kernels the target-attention node
launches outside the gather_einsum and mari_matmul families, from the
profiled sub-window's replays named through the graphs' kernel maps;
prints the sub-window's device time by (span, node, op) on standard
error."""
from portbench import attribution


def read(run):
    return attribution.attention_tail_ms(run)
