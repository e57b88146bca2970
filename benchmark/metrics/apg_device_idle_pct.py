"""``device_idle_pct`` over the APG cell's traced range: from the end of
the last forward step to the restarts after the update, the whole
backward."""

from benchmark.run import reader

read = reader("device_idle_pct")
