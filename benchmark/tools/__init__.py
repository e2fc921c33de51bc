"""Tools that set the benchmark's data once, on the card: the work count
of each configuration, the aquaplanet's finite days, and the readings the
limits of `correct` are set from."""
