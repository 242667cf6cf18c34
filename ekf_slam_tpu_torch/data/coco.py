"""COCO-Stuff adapter.

A copy of ``ekf_slam_tpu/data/coco.py`` (the JAX package's file
uses no JAX; the port imports nothing of that package).

The reference's dataset builder loads COCO-Stuff annotations through the
Matterport Mask-RCNN CocoDataset ("CALC 2.0"/dataset/coco.py:60-199 —
itself gated on an external `mrcnn` checkout, SURVEY.md §2.9) and converts
92 stuff classes to the 13 CALC classes (gen_tfrecords.py:102). This module
provides the same pipeline: iterate (image, calc-mask) pairs sized for
training, feeding data/records.py's `write_shards`. Annotations are read
through pycocotools when it is installed, otherwise through the bundled
pure-Python reader (data/coco_min.py — same index API, same RLE codecs;
polygon EDGE pixels may differ from pycocotools' rasterizer). The full
chain coco_pairs -> write_shards -> ShardReader -> train_step is
exercised against an in-test miniature COCO-Stuff fixture
(tests/test_coco_fixture.py).

Usage (with a COCO-Stuff download):

    from ekf_slam_tpu_torch.data.coco import coco_pairs
    from ekf_slam_tpu_torch.data.records import write_shards
    write_shards(out_dir, coco_pairs(ann_json, image_dir, size=(320, 320)))
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ekf_slam_tpu_torch.data.classes import coco_to_calc_lut


def _coco_backend():
    """pycocotools' COCO when installed (exact polygon rasterization),
    else the bundled pure-Python MiniCOCO (data/coco_min.py)."""
    try:
        from pycocotools.coco import COCO  # noqa: F401
        return COCO  # pragma: no cover - image has no pycocotools
    except ImportError:
        from ekf_slam_tpu_torch.data.coco_min import MiniCOCO
        return MiniCOCO


def coco_pairs(ann_json: str, image_dir: str,
               size: Tuple[int, int] = (320, 320),
               stuff_id_offset: int = 91,
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (image uint8 (H,W,3), calc-mask uint8 (H,W)) resized pairs.

    stuff_id_offset: COCO-Stuff category ids start at 92 in the stuff
    annotation files (gen_tfrecords.py:102 subtracts the same offset).
    """
    import os

    from PIL import Image

    COCO = _coco_backend()
    coco = COCO(ann_json)
    lut = coco_to_calc_lut()
    h_out, w_out = size
    for img_id in coco.getImgIds():
        info = coco.loadImgs(img_id)[0]
        path = os.path.join(image_dir, info["file_name"])
        if not os.path.exists(path):
            continue
        img = Image.open(path).convert("RGB")
        anns = coco.loadAnns(coco.getAnnIds(imgIds=img_id))
        mask = np.zeros((info["height"], info["width"]), np.uint8)
        for ann in anns:
            m = coco.annToMask(ann).astype(bool)
            cid = int(ann["category_id"]) - stuff_id_offset
            cid = int(np.clip(cid, 0, lut.shape[0] - 1))
            mask[m] = lut[cid]
        img = np.asarray(img.resize((w_out, h_out), Image.BILINEAR))
        mask_im = Image.fromarray(mask).resize((w_out, h_out), Image.NEAREST)
        yield img, np.asarray(mask_im)
