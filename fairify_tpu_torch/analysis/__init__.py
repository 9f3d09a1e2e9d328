"""Post-verification analysis (port of ``fairify_tpu/analysis``): so far
the group fairness metrics, :mod:`fairify_tpu_torch.analysis.metrics`."""
