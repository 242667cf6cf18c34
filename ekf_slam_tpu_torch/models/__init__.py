"""The CALC2 stack: the VSS descriptor network (vss.py, eval and train
mode) and Flax's initial weights for it drawn without JAX (flax_init.py),
activation keypoints (keypoints.py), the ring-buffer loop database with
retrieval, geometric verification and temporal consistency
(loopclosure.py), the online runner that fuses declared loops into the
filter (loop_runner.py); and training and evaluation: augmentation
(augment.py), the losses (losses.py), the train step, loop and
checkpoints (train.py) and the PR evaluation (evaluate.py)."""
