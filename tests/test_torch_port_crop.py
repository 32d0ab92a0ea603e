"""INPUT.CROP in the port against cddmsl_tpu on the CPU: `RandomCrop`'s four
crop types draw JAX's windows from the same `np.random.RandomState`,
`build_augmentation` puts the crop first as JAX does, and the mappers
(instances with polygons and keypoints, Panoptic FPN's labels and segment
ids, the semantic segmentor's labels) give JAX's samples for the same
seed: the crop moves the boxes, polygons and keypoints by its corner, the
mapper clips the boxes to the window and drops the instances JAX's drops.
Everything exactly (numpy on both sides). No JAX program is compiled.
"""

import numpy as np
import pytest

from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data import transforms as jax_transforms
from cddmsl_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from cddmsl_tpu.data.dataset_mapper import DatasetMapper as JaxDatasetMapper
from cddmsl_tpu.data.dataset_mapper import PanopticDatasetMapper as JaxPanopticDatasetMapper
from cddmsl_tpu.data.dataset_mapper import SemSegDatasetMapper as JaxSemSegDatasetMapper
from cddmsl_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
from cddmsl_tpu.data.datasets.synthetic import register_synthetic_panoptic as jax_register_synthetic_panoptic
from cddmsl_tpu.data.datasets.synthetic import register_synthetic_semseg as jax_register_synthetic_semseg
from cddmsl_torch.config import check_supported, get_cfg
from cddmsl_torch.data import transforms
from cddmsl_torch.data.catalog import DatasetCatalog, MetadataCatalog
from cddmsl_torch.data.dataset_mapper import DatasetMapper, PanopticDatasetMapper, SemSegDatasetMapper
from cddmsl_torch.data.datasets.coco import load_coco_json
from cddmsl_torch.data.datasets.synthetic import (
    make_synthetic_coco, register_synthetic_panoptic, register_synthetic_semseg,
)

CROPS = {"relative": (0.5, 0.7), "relative_range": (0.3, 0.6), "absolute": (40, 60), "absolute_range": (30, 70)}


def _crop_opts(crop_type):
    return ["INPUT.CROP.ENABLED", "True", "INPUT.CROP.TYPE", crop_type, "INPUT.CROP.SIZE", repr(list(CROPS[crop_type]))]


@pytest.mark.parametrize("crop_type", list(CROPS))
def test_random_crop_draws_jax_windows(crop_type):
    """Windows of images of several shapes (some smaller than an absolute
    crop) from one state: the same corner and size, and the states after
    equal."""
    ours, theirs = transforms.RandomCrop(crop_type, CROPS[crop_type]), jax_transforms.RandomCrop(
        crop_type, CROPS[crop_type])
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    for h, w in ((96, 160), (33, 50), (120, 90), (64, 64)) * 3:
        img = np.zeros((h, w, 3), np.uint8)
        got, want = ours.get_transform(img, r1), theirs.get_transform(img, r2)
        assert (got.x0, got.y0, got.w, got.h) == (want.x0, want.y0, want.w, want.h)
        assert got.apply_image(img).shape == want.apply_image(img).shape
        assert r1.randint(1 << 30) == r2.randint(1 << 30)
    with pytest.raises(ValueError, match="RandomCrop type"):
        transforms.RandomCrop("centre", (0.5, 0.5))


def test_the_crop_comes_first_and_its_type_is_checked():
    """RandomCrop, then the resize, then the flip; an unknown
    INPUT.CROP.TYPE is refused naming the key."""
    cfg, ref = get_cfg(), jax_get_cfg()
    for c in (cfg, ref):
        c.merge_from_list(_crop_opts("relative_range"))
    got = [type(a).__name__ for a in transforms.build_augmentation(cfg, True)]
    assert got == [type(a).__name__ for a in jax_transforms.build_augmentation(ref, True)]
    assert got == ["RandomCrop", "ResizeShortestEdge", "RandomFlip"]
    assert [type(a).__name__ for a in transforms.build_augmentation(cfg, False)] == ["ResizeShortestEdge"]
    check_supported(cfg, world=1)
    cfg.merge_from_list(["INPUT.CROP.TYPE", "centre"])
    with pytest.raises(NotImplementedError, match=r"INPUT\.CROP\.TYPE"):
        check_supported(cfg, world=1)


@pytest.mark.parametrize("crop_type", list(CROPS))
def test_the_mapper_crops_boxes_polygons_and_keypoints_as_jax(tmp_path, crop_type):
    """The COCO fixture with polygons and keypoints through both mappers
    (crop, resize, flip): images, sizes, boxes, classes, polygon rings and
    keypoints equal; some instances fall outside their window and both
    mappers drop them."""
    json_path, img_root = make_synthetic_coco(str(tmp_path), n=6, seed=3, with_keypoints=True)
    cfg, ref = get_cfg(), jax_get_cfg()
    for c in (cfg, ref):
        c.merge_from_list(["MODEL.MASK_ON", "True", "MODEL.KEYPOINT_ON", "True",
                           "MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS", "3", "INPUT.MIN_SIZE_TRAIN", "(96, 120)",
                           "INPUT.MAX_SIZE_TRAIN", "200", "INPUT.RANDOM_FLIP", "horizontal",
                           "DATASETS.TRAIN", "('port_test_crop',)", *_crop_opts(crop_type)])
    for cat in (MetadataCatalog, JaxMetadataCatalog):
        cat.get("port_test_crop").set(keypoint_names=("kp_tl", "kp_center", "kp_br"), keypoint_flip_map=())
    try:
        dicts = load_coco_json(json_path, img_root, "port_test_crop")
        assert dicts == jax_load_coco_json(json_path, img_root, "port_test_crop")
        ours, theirs = DatasetMapper(cfg, True), JaxDatasetMapper(ref, True)
        r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
        dropped = 0
        for _ in range(3):
            for d in dicts:
                s, w = ours(d, r1), theirs(d, r2)
                for k in ("image", "hw", "orig_hw", "boxes", "classes", "keypoints"):
                    np.testing.assert_array_equal(s[k], w[k], err_msg=k)
                assert len(s["polygons"]) == len(w["polygons"]) == len(s["boxes"])
                for a, b in zip(s["polygons"], w["polygons"]):
                    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
                dropped += len(d["annotations"]) - len(s["boxes"])
        if crop_type in ("absolute", "absolute_range"):
            assert dropped > 0
    finally:
        MetadataCatalog.remove("port_test_crop")
        JaxMetadataCatalog._registry.pop("port_test_crop", None)


@pytest.fixture(scope="module")
def label_sets(tmp_path_factory):
    """The synthetic panoptic and stripes fixtures registered in both
    packages' catalogs, removed afterwards."""
    root = tmp_path_factory.mktemp("crop")
    register_synthetic_panoptic(str(root / "ours"), prefix="port_crop_panoptic")
    jax_register_synthetic_panoptic(str(root / "jax"), prefix="port_crop_panoptic")
    register_synthetic_semseg(str(root / "ours"), prefix="port_crop_semseg")
    jax_register_synthetic_semseg(str(root / "jax"), prefix="port_crop_semseg")
    yield root
    for name in ("port_crop_panoptic_train", "port_crop_panoptic_val", "port_crop_semseg_train",
                 "port_crop_semseg_val"):
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
        JaxDatasetCatalog._registry.pop(name, None)
        JaxMetadataCatalog._registry.pop(name, None)


@pytest.mark.parametrize("kind", ["panoptic", "semantic"])
def test_the_label_mappers_crop_as_jax(label_sets, kind):
    """Panoptic FPN's mapper (MASK_ON: boxes, classes, labels and bitmasks
    from the cropped segment ids) and the semantic segmentor's (labels)
    with an absolute-range crop: JAX's samples exactly."""
    arch, name, ours_cls, jax_cls = {
        "panoptic": ("PanopticFPN", "port_crop_panoptic_train", PanopticDatasetMapper, JaxPanopticDatasetMapper),
        "semantic": ("SemanticSegmentor", "port_crop_semseg_train", SemSegDatasetMapper, JaxSemSegDatasetMapper),
    }[kind]
    cfg, ref = get_cfg(), jax_get_cfg()
    for c in (cfg, ref):
        c.merge_from_list(["MODEL.META_ARCHITECTURE", arch, "MODEL.MASK_ON", str(kind == "panoptic"),
                           "DATASETS.TRAIN", f"('{name}',)", "INPUT.MIN_SIZE_TRAIN", "(96, 120)",
                           "INPUT.MAX_SIZE_TRAIN", "200", "INPUT.RANDOM_FLIP", "horizontal",
                           *_crop_opts("absolute_range")])
    swap = lambda v: v.replace(str(label_sets / "jax"), str(label_sets / "ours")) if isinstance(v, str) else v  # noqa: E731
    dicts = DatasetCatalog.get(name)
    assert dicts == [{k: swap(v) for k, v in d.items()} for d in JaxDatasetCatalog.get(name)]
    ours, theirs = ours_cls(cfg, True), jax_cls(ref, True)
    r1, r2 = np.random.RandomState(1), np.random.RandomState(1)
    for d in dicts:
        s, w = ours(d, r1), theirs(d, r2)
        assert set(s) == set(w)
        for k in ("image", "hw", "orig_hw", "boxes", "classes", "sem_seg"):
            np.testing.assert_array_equal(s[k], w[k], err_msg=k)
        for a, b in zip(s.get("bitmasks", ()), w.get("bitmasks", ())):
            np.testing.assert_array_equal(a, b)
