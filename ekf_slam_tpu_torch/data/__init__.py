"""CALC2 training data: synthetic Voronoi scenes on a torch.Generator
(synthetic.py), the CALC class table (classes.py), npz record shards
(records.py) and the COCO-Stuff adapter (coco.py, coco_min.py; PIL is
imported only when they read a file)."""

from ekf_slam_tpu_torch.data.synthetic import (aliased_batches,
                                               class_weights,
                                               synthetic_batch)

__all__ = ["synthetic_batch", "class_weights", "aliased_batches"]
