"""Observability: the port's clock (``obs.clock``)."""
