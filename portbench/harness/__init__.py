"""The benchmark's generic machinery: finding a cell's files by name,
reading the device trace, building the result line. Nothing here knows a
configuration, a traffic mix or a metric."""
