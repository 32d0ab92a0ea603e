"""The VOC-family dataset names of cddmsl_tpu/data/datasets/builtin.py
`register_all` (the reference's detectron2/data/datasets/builtin.py):

  * plain VOC:      voc_{2007,2012}_{train,val,trainval,test} (no 2012 test)
  * DG-paired VOC:  voc_{clipart,watercolor,comic}_{2007,2012}_{train,trainval},
                    VOC images paired with their dt_* translated twins
  * artistic tests: Clipart1k_{train,test}, Watercolor_{train,test},
                    Comic_{train,test} (the last four on the 6 classes they
                    annotate) and dt_Clipart_test

The Cityscapes, BDD, COCO and LVIS names of the JAX package are not ported.
The dataset root is $DETECTRON2_DATASETS (default "./datasets"); nothing is
read from disk until a dataset is requested.
"""

import os

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
