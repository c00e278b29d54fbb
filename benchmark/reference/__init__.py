"""Plain references of what the benchmark's cells time, in plain PyTorch,
importing nothing of the program; `limits.json` holds each compared
number's limit, by reference."""
