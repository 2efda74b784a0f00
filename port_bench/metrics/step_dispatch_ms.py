"""step_dispatch_ms.<part>: mean host ms of one train step's dispatch (the
``lidbox.step`` spans of ``graphs.StepProgram``: inputs into the graph's
buffers, the replay's launch) in the traced stretch. None where the
program recorded none. Host time only while the card's launch queue has
room: where it is full (the Bi-GRU's steps) the launch blocks, and the
span reads the card's pace instead."""
from port_bench import spans


def read(run):
    return spans.mean_ms(run, "lidbox.step")
