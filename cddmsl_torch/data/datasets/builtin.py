"""The dataset names of cddmsl_tpu/data/datasets/builtin.py `register_all`
(the reference's detectron2/data/datasets/builtin.py) that the port reads:

  * plain VOC:      voc_{2007,2012}_{train,val,trainval,test} (no 2012 test)
  * DG-paired VOC:  voc_{clipart,watercolor,comic}_{2007,2012}_{train,trainval},
                    VOC images paired with their dt_* translated twins
  * artistic tests: Clipart1k_{train,test}, Watercolor_{train,test},
                    Comic_{train,test} (the last four on the 6 classes they
                    annotate) and dt_Clipart_test
  * adverse weather: cityscapes_{train,val},
                    cityscapes_DG_{train,val} (clear images paired with their
                    leftImg8bit_foggy twins), cityscapes_foggy_{train,val}
                    (the clear images when leftImg8bit_foggy/<split> is
                    missing) and bdd_100k_val (COCO json, evaluator "coco")
  * COCO:           coco_2017_{train,val} and the open-vocabulary splits
                    coco_2017_ovd_{all,b,t}_{train,test} (COCO json of the
                    65 / 48 base / 17 novel classes)
  * LVIS:           lvis_{v1,v0.5}_{train,val} (LVIS json over the COCO
                    images, evaluator "lvis")
  * instance:       cityscapes_fine_instance_seg_{train,val} (the
                    Cityscapes boxes and classes with no masks, evaluator
                    "pascal_voc", as JAX registers them)

  * panoptic:       coco_2017_{train,val}_panoptic (COCO panoptic json and
                    PNGs, evaluator "coco_panoptic_seg") and
                    cityscapes_fine_panoptic_{train,val}
                    ("cityscapes_panoptic_seg")
  * semantic:       cityscapes_fine_sem_seg_{train,val} (labelTrainIds PNGs,
                    evaluator "sem_seg")

The dataset root is $DETECTRON2_DATASETS (default "./datasets"); nothing is read
from disk until a dataset is requested.
"""

import os

from .cityscapes import register_cityscapes, register_cityscapes_DG, register_cityscapes_semantic
from .cityscapes_panoptic import register_all_cityscapes_panoptic
from .coco import register_coco_instances
from .coco_panoptic import register_coco_panoptic
from .lvis import register_lvis_instances
from .voc import ARTISTIC_6_CLASSES, register_pascal_DG, register_pascal_voc

_REGISTERED = False


def register_all(root: str = None) -> None:
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")

    for year in (2007, 2012):
        for split in ("train", "val", "trainval", "test"):
            if year == 2012 and split == "test":
                continue
            register_pascal_voc(f"voc_{year}_{split}", os.path.join(root, f"VOC{year}"), split, year)

    for domain, dt_dir in (("clipart", "dt_clipart"), ("watercolor", "dt_watercolor"), ("comic", "dt_comic")):
        for year in (2007, 2012):
            for split in ("train", "trainval"):
                register_pascal_DG(
                    f"voc_{domain}_{year}_{split}", os.path.join(root, f"VOC{year}"), split, year, dt_dir
                )

    register_pascal_voc("Clipart1k_train", os.path.join(root, "clipart"), "train", 2007)
    register_pascal_voc("Clipart1k_test", os.path.join(root, "clipart"), "test", 2007)
    for name, folder in (("Watercolor", "watercolor"), ("Comic", "comic")):
        for split in ("train", "test"):
            register_pascal_voc(f"{name}_{split}", os.path.join(root, folder), split, 2007, ARTISTIC_6_CLASSES)
    register_pascal_voc("dt_Clipart_test", os.path.join(root, "dt_clipart", "VOC2007"), "test", 2007)

    city = os.path.join(root, "cityscapes")
    for split in ("train", "val"):
        img_dir = os.path.join(city, "leftImg8bit", split)
        gt_dir = os.path.join(city, "gtFine", split)
        foggy_dir = os.path.join(city, "leftImg8bit_foggy", split)
        register_cityscapes(f"cityscapes_{split}", img_dir, gt_dir)
        register_cityscapes_DG(f"cityscapes_DG_{split}", img_dir, gt_dir, foggy_dir)
        register_cityscapes(f"cityscapes_foggy_{split}", foggy_dir if os.path.isdir(foggy_dir) else img_dir, gt_dir)

    register_coco_instances(
        "bdd_100k_val",
        os.path.join(root, "bdd100k", "labels", "bdd100k_labels_images_det_coco_val.json"),
        os.path.join(root, "bdd100k", "images", "100k", "val"),
    )

    coco = os.path.join(root, "coco")
    for split in ("train", "val"):
        register_coco_instances(f"coco_2017_{split}", os.path.join(coco, "annotations", f"instances_{split}2017.json"),
                                os.path.join(coco, f"{split}2017"))
    for ovd_split, img_split in (("ovd_all_train", "train"), ("ovd_b_train", "train"), ("ovd_t_train", "train"),
                                 ("ovd_all_test", "val"), ("ovd_b_test", "val"), ("ovd_t_test", "val")):
        register_coco_instances(
            f"coco_2017_{ovd_split}",
            os.path.join(coco, "annotations", f"ovd_ins_{img_split}2017_{ovd_split.split('_')[1]}.json"),
            os.path.join(coco, f"{img_split}2017"),
        )
    for split in ("train", "val"):
        register_coco_panoptic(f"coco_2017_{split}_panoptic",
                               os.path.join(coco, "annotations", f"panoptic_{split}2017.json"),
                               os.path.join(coco, f"{split}2017"), os.path.join(coco, f"panoptic_{split}2017"))
    for version in ("v1", "v0.5"):
        for split in ("train", "val"):
            # LVIS images live in the COCO folders
            register_lvis_instances(f"lvis_{version}_{split}",
                                    os.path.join(root, "lvis", f"lvis_{version}_{split}.json"), coco)
    # detectron2's names of the instance sets: boxes and classes, no masks, VOC-scored (as in JAX)
    for split in ("train", "val"):
        register_cityscapes(f"cityscapes_fine_instance_seg_{split}", os.path.join(city, "leftImg8bit", split),
                            os.path.join(city, "gtFine", split))
    register_all_cityscapes_panoptic(root)
    for split in ("train", "val"):
        register_cityscapes_semantic(f"cityscapes_fine_sem_seg_{split}", os.path.join(city, "leftImg8bit", split),
                                     os.path.join(city, "gtFine", split))
