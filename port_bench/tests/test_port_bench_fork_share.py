"""``rnn_fork_share`` on made-up span records, beside the other readers of
the program's spans (``test_port_bench_spans.py``): 100 where every masked
two-direction recurrent layer run forked, the forked share of a mix of
replays, a capture and an eager run, and None where no such layer ran (a
program whose spans carry no counts, or no spans)."""
import pytest

from test_port_bench_spans import END, make_run, read, record


def graph_runs(*counts):
    """A graph span a (name, forked, serial), 10 ms apart in the
    stretch."""
    return [record(name, END + 0.01 * (i + 1), 0.001, kind="fused",
                   launches={}, rnn_forked=forked, rnn_serial=serial)
            for i, (name, forked, serial) in enumerate(counts)]


def test_all_forked(monkeypatch):
    run = make_run(graph_runs(*[("lidbox.graph.replay", 2, 0)] * 4),
                   monkeypatch)
    assert read("rnn_fork_share", run) == 100.0


def test_mixed(monkeypatch):
    records = graph_runs(("lidbox.graph.capture", 4, 0),
                         ("lidbox.graph.replay", 2, 0),
                         ("lidbox.graph.eager", 0, 2),
                         ("lidbox.graph.replay", 2, 0))
    # a span outside the graph runs carries no layer runs that count
    records.append(record("lidbox.step", END + 0.02, 0.001, rnn_serial=9))
    run = make_run(records, monkeypatch)
    assert read("rnn_fork_share", run) == pytest.approx(100 * 8 / 10)


def test_none_ran(monkeypatch):
    # the x-vector's replays, and a program that counts no layer runs
    plain = [record("lidbox.graph.replay", END + 0.01 * i, 0.001,
                    kind="fused", launches={"logmel_kernel": 1})
             for i in range(1, 4)]
    assert read("rnn_fork_share", make_run(plain, monkeypatch)) is None
    zero = graph_runs(*[("lidbox.graph.replay", 0, 0)] * 3)
    assert read("rnn_fork_share", make_run(zero, monkeypatch)) is None
    assert read("rnn_fork_share", make_run([], monkeypatch)) is None
