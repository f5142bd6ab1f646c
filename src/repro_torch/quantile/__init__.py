"""Quantile-calibrated admission (``sketch``: the rate histogram behind
``threshold_mode="quantile"``) and frequency-moment drift statistics
(``moments``) — port of ``repro.quantile``."""
from repro_torch.quantile.moments import falpha_index  # noqa: F401
from repro_torch.quantile.sketch import (  # noqa: F401
    NUM_BINS, RATE_MIN, bin_edges, bin_index, calib_mask, hist_quantile,
    init_hist, merge_hists, observe_rates, observe_rates_fleet,
    quantile_threshold)
