"""Roofline analysis of the port on the H100 (``analysis.roofline``), the
perf-iteration tool (``analysis.perf``) and the dry-run report
(``analysis.report``)."""
