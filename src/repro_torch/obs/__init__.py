"""Observability: the port's clock (``obs.clock``) and measured-vs-roofline
utilization (``obs.utilization``)."""
