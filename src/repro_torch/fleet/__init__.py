"""Multi-tenant ACE fleets — port of ``repro.fleet``: tenant-stacked
sketches with routed ops (``state``), per-tenant epoch rings with
presence-gated clocks (``window``) and the fleet drop-in for
``AceDataFilter`` (``filter.FleetDataFilter``)."""
