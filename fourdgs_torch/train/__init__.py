"""Training losses of the port (fourdgs/train/). The reference's trainer
(`fit`) and densification wait for its render path, `render_splats4d`."""
