"""One driver per kind of traffic: ``Cell(ctx)`` with ``setup``,
``window``, ``useful_flops``, ``release`` and ``check``."""
