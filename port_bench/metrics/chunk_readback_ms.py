"""chunk_readback_ms.<part>: mean host ms of reading a stream chunk's
scores to the host (the ``lidbox.serve.readback`` spans of
``StreamingClassifier``: the wait for the chunk's device work and the
copy) in the traced stretch. None where the program recorded none."""
from port_bench import spans


def read(run):
    return spans.mean_ms(run, "lidbox.serve.readback")
