"""stage_ms.<part>: mean ms the staging thread took to stage one dispatch's
batches (stack, pack, pin, copy enqueued: the ``lidbox.feed.stage`` spans
of ``Trainer._staged``) in the traced stretch. None where the program
recorded none. Like ``step_dispatch_ms``, host time only while the card's
launch queue has room: the copy's enqueue waits for it."""
from port_bench import spans


def read(run):
    return spans.mean_ms(run, "lidbox.feed.stage")
