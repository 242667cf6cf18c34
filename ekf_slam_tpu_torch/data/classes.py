"""CALC class taxonomy: COCO-Stuff supercategory -> 13 CALC classes.

A copy of ``ekf_slam_tpu/data/classes.py`` (the JAX package's file
uses no JAX; the port imports nothing of that package).

Fact tables reproducing the mapping of "CALC 2.0"/dataset/coco_classes.py
(92 COCO-stuff labels grouped into 13 scene-stable classes). The grouping
is semantic data, not code: each COCO-stuff id maps to the group its
supercategory belongs to; ids are offset by 92 in COCO-Stuff annotations
(gen_tfrecords.py:102 subtracts the offset before lookup).
"""

CALC_CLASS_NAMES = [
    "background", "building", "wall", "vegetation", "furniture", "ground",
    "floor", "ceiling", "sky", "object-other", "water", "structure-other",
    "other",
]
CALC_CLASSES = {n: i for i, n in enumerate(CALC_CLASS_NAMES)}
N_CALC_CLASSES = len(CALC_CLASS_NAMES)

# COCO-stuff label id (0..92, 0 = background, 92 = other) -> CALC group name.
_GROUPS = {
    "background": [0, 29],
    "object-other": [1, 2, 8, 9, 13, 14, 19, 21, 30, 39, 41, 42, 46, 47,
                     48, 52, 69, 71, 72, 76, 77, 90, 91],
    "vegetation": [3, 6, 28, 31, 38, 43, 51, 62, 78, 79],
    "structure-other": [4, 53, 70, 73, 75],
    "building": [5, 37, 60, 67],
    "furniture": [7, 10, 16, 17, 18, 32, 40, 50, 61, 65, 74, 89],
    "ceiling": [11, 12],
    "sky": [15, 66],
    "ground": [20, 33, 34, 35, 36, 44, 45, 49, 54, 56, 58, 59, 63, 68],
    "wall": [22, 55, 80, 81, 82, 83, 84, 85, 86],
    "floor": [23, 24, 25, 26, 27],
    "water": [57, 64, 87, 88],
    "other": [92],
}

COCO_TO_CALC = {}
for _name, _ids in _GROUPS.items():
    for _i in _ids:
        COCO_TO_CALC[_i] = CALC_CLASSES[_name]

assert len(COCO_TO_CALC) == 93, sorted(set(range(93)) - set(COCO_TO_CALC))


def coco_to_calc_lut():
    """(93,) int32 lookup table for vectorized relabeling."""
    import numpy as np
    lut = np.zeros(93, np.int32)
    for k, v in COCO_TO_CALC.items():
        lut[k] = v
    return lut
