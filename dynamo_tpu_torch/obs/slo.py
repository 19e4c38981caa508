"""The SLO plane's wire subject, copied from dynamo_tpu/obs/slo.py.

The frontends' SloPlane publishes each error-budget summary on
``slo_metrics.{namespace}`` with a ``burn`` map (window -> burn rate);
the worker (engine/worker.py _slo_loop) subscribes to it and feeds the
worst window into TorchEngine.set_slo_burn, where a sustained burn makes
prefill chunks yield budget to decode.  The plane itself (histograms,
goodput, burn windows) lives in the JAX frontend, which serves torch
workers unchanged.
"""

SLO_SUBJECT_PREFIX = "slo_metrics"
