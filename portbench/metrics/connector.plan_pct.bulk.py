"""The connector's planning share in the bulk-read cells (``measure.plan_pct``)."""
from portbench.measure import plan_pct as read  # noqa: F401
