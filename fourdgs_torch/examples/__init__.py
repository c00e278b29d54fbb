"""Example programs of the port (run with `python -m
fourdgs_torch.examples.<name>`): fit_motion, render_gallery,
render_cube_sweep."""
