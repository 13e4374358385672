"""Host ms per stage-1 call in its synchronise (``stage1.sync`` spans) in
the window: how long stage 1 waits for the stream, earlier groups' packs
included."""
from portbench import attribution


def read(run):
    return attribution.span_mean_ms(run, "stage1.sync")
