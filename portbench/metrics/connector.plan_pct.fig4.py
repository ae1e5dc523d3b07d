"""The connector's planning share in the Fig. 4 query cells (``measure.plan_pct``)."""
from portbench.measure import plan_pct as read  # noqa: F401
