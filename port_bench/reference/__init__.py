"""The benchmark's plain reference: frozen copies of the port's eager map
update (``step.py``, from ``mapping/pipeline.py``) and of the modules it
runs (grid, transform, LiDAR model, row rasterizer, the Kalman and P^2
estimators, polar raycast with K1's and K4's plain twins, post-processing
chain), cut to what the benchmark's configurations use. The module
docstrings are the originals'; each module here imports only its siblings,
torch and numpy, never the port, so a later change to the port cannot move
the yardstick."""
