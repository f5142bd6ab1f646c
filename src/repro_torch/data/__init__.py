"""Data-side ACE: featurisation and the ``AceDataFilter`` (``pipeline``)."""
