"""The yardstick shared by every cell: finding a cell's parts by name, the
traffic and weight generators, the device trace, the table of peaks, the
operation counts and the comparison that decides ``correct``."""
