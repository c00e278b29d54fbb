"""Utilities (port of fourdgs/utils/): simplex noise and small helpers."""
