"""Minimal pure-Python COCO annotation reader (pycocotools fallback).

A copy of ``ekf_slam_tpu/data/coco_min.py`` (the JAX package's file
uses no JAX; the port imports nothing of that package).

The COCO-Stuff adapter (data/coco.py) mirrors the reference's dataset
builder, which reads COCO annotations through pycocotools
("CALC 2.0"/dataset/coco.py:60-199, gen_tfrecords.py:41-167).
pycocotools is a compiled extension that is not bundled in every image,
so this module implements the SUBSET the adapter actually touches as
plain Python over the annotation JSON:

  MiniCOCO(ann_json).getImgIds() / loadImgs / getAnnIds / loadAnns
  MiniCOCO.annToMask(ann) -> (H, W) uint8

`annToMask` handles the three COCO segmentation encodings:

  * polygon lists  — rasterized with PIL.ImageDraw. PIL's scanline fill
    can differ from pycocotools' rasterizer by a boundary pixel; exact
    parity on polygon EDGES is not guaranteed (interiors match).
  * uncompressed RLE — {"counts": [ints], "size": [h, w]}, column-major
    alternating background/foreground run lengths.
  * compressed RLE — {"counts": str|bytes}: the COCO mask-API string
    codec (LEB128-style 5-bit groups, +48 ASCII offset, counts delta-
    coded against cnts[i-2] from the third element on). `rle_encode` /
    `rle_decode` implement both directions; the round trip is pinned by
    tests/test_coco_fixture.py.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np


def rle_decode(s) -> List[int]:
    """COCO mask-API compressed-string -> run-length counts
    (maskApi.c rleFrString)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def rle_encode(cnts: Sequence[int]) -> str:
    """Run-length counts -> COCO mask-API compressed string
    (maskApi.c rleToString)."""
    out: List[str] = []
    for i, x in enumerate(cnts):
        x = int(x)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """Alternating background/foreground run lengths (COLUMN-major,
    starting with background) -> (h, w) uint8 mask."""
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major storage


def mask_to_counts(mask: np.ndarray) -> List[int]:
    """(h, w) mask -> column-major alternating run lengths (leading
    background run, possibly 0)."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    # run-length encode, forcing the first run to describe background
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    return [int(r) for r in runs]


def _polygons_to_mask(polys, h: int, w: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    im = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(im)
    for poly in polys:
        pts = [(float(poly[i]), float(poly[i + 1]))
               for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(im, np.uint8)


class MiniCOCO:
    """The pycocotools.coco.COCO subset data/coco.py uses."""

    def __init__(self, ann_json: str):
        with open(ann_json) as f:
            d = json.load(f)
        self.imgs: Dict[int, dict] = {im["id"]: im
                                      for im in d.get("images", [])}
        self.anns: Dict[int, dict] = {an["id"]: an
                                      for an in d.get("annotations", [])}
        self._by_img: Dict[int, List[int]] = {}
        for an in d.get("annotations", []):
            self._by_img.setdefault(an["image_id"], []).append(an["id"])

    def getImgIds(self) -> List[int]:
        return sorted(self.imgs)

    def loadImgs(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds) -> List[int]:
        if isinstance(imgIds, int):
            imgIds = [imgIds]
        out: List[int] = []
        for i in imgIds:
            out.extend(self._by_img.get(i, []))
        return sorted(out)

    def loadAnns(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def annToMask(self, ann: dict) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        h, w = int(img["height"]), int(img["width"])
        seg = ann["segmentation"]
        if isinstance(seg, list):                     # polygon(s)
            return _polygons_to_mask(seg, h, w)
        counts = seg["counts"]
        h, w = seg.get("size", (h, w))
        if isinstance(counts, (str, bytes)):          # compressed RLE
            counts = rle_decode(counts)
        return counts_to_mask(counts, int(h), int(w))
