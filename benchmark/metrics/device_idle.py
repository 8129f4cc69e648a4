"""Share of the traced slice's wall time in which no device event ran (the
union of the event intervals); ``device_idle.frame`` and
``device_idle.init`` read it in the cells they list."""
from benchmark.harness.readings import idle_pct as read  # noqa: F401
