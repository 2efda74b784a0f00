"""chunk_dispatch_ms.<part>: mean host ms of a stream chunk up to the read
of its scores (each ``lidbox.serve.chunk`` span of ``StreamingClassifier``
less its ``lidbox.serve.readback``: pinning, the program's signature,
input copy and replay) in the traced stretch. None where the program
recorded none."""
import collections

from port_bench import spans


def read(run):
    records = spans.stretch(run)
    chunks = spans.named(records, "lidbox.serve.chunk")
    if not chunks:
        return None
    readback = collections.Counter()
    for r in spans.named(records, "lidbox.serve.readback"):
        readback[r.parent] += spans.seconds(r)
    return 1e3 * sum(spans.seconds(c) - readback[c.id]
                     for c in chunks) / len(chunks)
