"""Plain references of what the benchmark's cells time, in plain PyTorch,
importing nothing of the program; `<reference>.limits.json` beside each
holds the limit of every number its comparison gives."""
