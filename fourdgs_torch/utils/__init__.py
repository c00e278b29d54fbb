"""Utilities (port of fourdgs/utils/): simplex noise, small helpers, the
per-stage profiling harness."""
