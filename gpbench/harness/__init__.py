"""The harness: files found by name (``spec``), the run of a cell
(``cell``), the drivers of the traffic mixes (``drivers/``), the trace, the
algorithm's work and the window's arithmetic."""
