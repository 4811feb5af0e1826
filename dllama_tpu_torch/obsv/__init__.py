"""Continuous performance observability: the server's memory of itself.

* :mod:`~dllama_tpu_torch.obsv.timeseries` — a fixed-memory ring-buffer
  store fed by a sampler thread that snapshots every counter, gauge and
  histogram percentile at a configurable cadence (``--ts-interval``);
  served as windowed JSON on ``GET /metrics/history``.
* :mod:`~dllama_tpu_torch.obsv.burnrate` — multi-window (short/long) SLO
  burn-rate evaluation for per-class TTFT/TPOT/error-rate against the
  ``--slo-classes`` targets, with hysteresis; the live picture is
  ``GET /alerts``.

Copies of the JAX package's modules of the same names; everything here is
stdlib-only.
"""

from dllama_tpu_torch.obsv.burnrate import BurnRateEngine  # noqa: F401
from dllama_tpu_torch.obsv.timeseries import Sampler, TimeSeriesStore  # noqa: F401
