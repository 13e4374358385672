"""Host ms per stage-2 call copying its feeds into the graph's static
inputs (``stage2.copy_in`` spans: the restack and the host-to-device
copies enqueued) in the window."""
from portbench import attribution


def read(run):
    return attribution.span_mean_ms(run, "stage2.copy_in")
