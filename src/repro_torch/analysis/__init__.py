"""Analytic work models and the roofline of the port (one NVIDIA H100)."""
