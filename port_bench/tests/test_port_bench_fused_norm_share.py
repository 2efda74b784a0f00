"""``fused_norm_share`` on made-up span records, beside the other readers
of the program's spans (``test_port_bench_spans.py``): 100 where every
TDNN tail ran fused, the fused share of a mix of replays, a capture and an
eager run, and None where no tail ran (a program whose spans carry no
counts, or no spans)."""
import pytest

from test_port_bench_spans import END, make_run, read, record


def graph_runs(*counts):
    """A graph span a (name, fused, composed), 10 ms apart in the
    stretch."""
    return [record(name, END + 0.01 * (i + 1), 0.001, kind="fused",
                   launches={}, norm_fused=fused, norm_composed=composed)
            for i, (name, fused, composed) in enumerate(counts)]


def test_all_fused(monkeypatch):
    run = make_run(graph_runs(*[("lidbox.graph.replay", 30, 0)] * 4),
                   monkeypatch)
    assert read("fused_norm_share", run) == 100.0


def test_mixed(monkeypatch):
    records = graph_runs(("lidbox.graph.capture", 60, 0),
                         ("lidbox.graph.replay", 30, 0),
                         ("lidbox.graph.eager", 0, 30),
                         ("lidbox.graph.replay", 30, 0))
    # a span outside the graph runs carries no tails that count
    records.append(record("lidbox.step", END + 0.02, 0.001,
                          norm_composed=9))
    run = make_run(records, monkeypatch)
    assert read("fused_norm_share", run) == pytest.approx(100 * 120 / 150)


def test_none_ran(monkeypatch):
    # the x-vector's replays, and a program that counts no tails
    plain = [record("lidbox.graph.replay", END + 0.01 * i, 0.001,
                    kind="fused", launches={"logmel_kernel": 1})
             for i in range(1, 4)]
    assert read("fused_norm_share", make_run(plain, monkeypatch)) is None
    zero = graph_runs(*[("lidbox.graph.replay", 0, 0)] * 3)
    assert read("fused_norm_share", make_run(zero, monkeypatch)) is None
    assert read("fused_norm_share", make_run([], monkeypatch)) is None
