"""ES core of the port: score store, selection, schedules, engine."""
