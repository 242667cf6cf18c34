"""The CALC2 loop-closure stack, inference side: the VSS descriptor
network (vss.py) and Flax's initial weights for it drawn without JAX
(flax_init.py), activation keypoints (keypoints.py), the ring-buffer
loop database with retrieval, geometric verification and temporal
consistency (loopclosure.py), and the online runner that fuses declared
loops into the filter (loop_runner.py)."""
