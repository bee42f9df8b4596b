"""The harness: the benchmark as data (``spec``), the seed's draws
(``draws``), the program under test (``program``), one run of a cell
(``cell``), the traced stretch (``profile``), the bytes of a step
(``roofline``), what the per-layer readers share (``reading``) and the
modules a run may not hold (``guard``)."""
