"""Sliding-window ACE — port of ``repro.window``: the device-resident epoch
ring (``ring``) and the drift-tracking drop-in for ``AceDataFilter``
(``filter.WindowedAceFilter``)."""
