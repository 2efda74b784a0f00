"""feed_wait_share.<part>: percent of the traced stretch in which the card
waited for a feed to start: the training thread's first wait of each feed
(the ``lidbox.feed.wait`` span of ``Trainer._staged`` that carries
``first``), before that feed has queued any work on the card. The later
waits of a feed are left out: the card still runs the steps queued before
them. None where the program recorded none."""
from port_bench import spans


def read(run):
    waits = [r for r in spans.named(spans.stretch(run), "lidbox.feed.wait")
             if r.attrs.get("first")]
    if not waits:
        return None
    return 100.0 * sum(map(spans.seconds, waits)) / run.trace["window_s"]
