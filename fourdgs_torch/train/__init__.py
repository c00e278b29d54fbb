"""Fitting 4D splat scenes to images (port of fourdgs/train/): losses, the
fit loop with Adam and checkpoints (`trainer`), adaptive density control
(`densify`)."""
