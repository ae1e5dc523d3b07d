"""The device's idle share in the ingest cells (``measure.idle_pct``)."""
from portbench.measure import idle_pct as read  # noqa: F401
