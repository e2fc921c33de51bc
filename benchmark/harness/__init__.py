"""The benchmark's own machinery: cell lookup, the trace reduction, the
frozen work count and peaks, the initial states and the comparison."""
