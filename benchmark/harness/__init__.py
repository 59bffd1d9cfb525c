"""The harness: the run's context, the traffic generator, the drivers of
the cells' kinds, the trace reader and the yardstick's counts."""
