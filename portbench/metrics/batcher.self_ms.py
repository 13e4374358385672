"""The batcher thread's own host ms per group in the window: its
``batcher.*`` spans (wait, linger, claim, resolve with the waiters'
callbacks) less the engine's spans inside them."""
from portbench import attribution


def read(run):
    return attribution.batcher_self_ms(run)
