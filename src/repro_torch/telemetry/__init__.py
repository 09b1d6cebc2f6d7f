"""Per-member telemetry consumed by the control plane."""
